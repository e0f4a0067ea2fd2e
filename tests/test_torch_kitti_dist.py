"""Training and evaluation of KITTI's anchor family over several processes
(``--dist``) on the CPU: SECOND, PointPillar, SECOND-multihead,
SECOND-IoU, CenterPoint and Voxel R-CNN, two ranks spawned over gloo (``chip_smoke.run_ranks``; their
jobs are the JAX-free ``tests/dist_jobs.py``), each spawn bounded by its
process group's timeout and a join limit.

The semantics are the JAX package's dp mesh: W ranks of b scenes each
compute what one process computes on the W * b scenes (BN over the global
batch, the loss over it).

1. ``make_train_step`` over 2 ranks of one scene against the port's one
   process at B = 2 (``chip_smoke.dist_step_compare``, one spawn for the
   tiny models of ``chip_smoke.KITTI_DIST`` on a 16 x 16 m range, ``chip_smoke.kitti_step_case``):
   the first step's loss and every tb term within 1e-5, the ranks'
   parameters and BN buffers the same bits after two steps, every
   module's gradients within 2e-2 in norm.
2. Against the JAX package (one spawn): the BEV maps' BN over 2 ranks x 2
   scenes equals ``masked_batch_norm`` under a psum over 4 scenes sharded
   on 2 devices (outputs, running statistics and the input gradient,
   within 1e-5); AnchorHeadMulti's and SECONDHead's losses split over 2
   ranks of one scene equal the JAX package's two-scene losses (tb within
   1e-5, gradients within 2e-2 in norm).
3. The entry points on second.yaml (one spawn): the ``test`` CLI with
   ``--dist`` over a 5-frame KITTI tree (uneven shards) writes the one
   process's result.pkl and returns its official AP table; the ``train``
   CLI with ``--dist`` at b = 1 leaves the ranks' parameters the same
   bits; ``--dist`` without torchrun's environment raises.
4. ``collective_order``: with two ranks faked in one process, the training
   forward of each YAML issues its BN sync points 1..n, one a BN, and
   its backward -n..-1, the same on either rank (the four tests that held
   the ``--dist`` raise use it).
"""
import copy
import json
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import dist_jobs
from cagroup3d_tpu.core.norm import masked_batch_norm as jax_masked_bn
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu_torch.config import EasyDict
from cagroup3d_tpu_torch.core.module import flat_state
from cagroup3d_tpu_torch.models import build_network, load_config
from cagroup3d_tpu_torch.models.detectors.detector3d_template import \
    dataset_meta
from cagroup3d_tpu_torch.tools import test as test_cli
from cagroup3d_tpu_torch.tools import train as train_cli
from cagroup3d_tpu_torch.training.checkpoint import save_checkpoint
from cagroup3d_tpu_torch.utils import commu_utils
from cagroup3d_tpu_torch.utils.synthetic import write_kitti_tree
from chip_smoke import (DIST_CASES, KITTI_CFG, KITTI_DIST, dist_step_compare,
                        run_ranks)
from test_torch_kitti_zoo import (CFGS, _batch, _jax_ious, _rel, _rel_norm,
                                  bits)

torch.set_num_threads(1)
assert bits        # the key-bits fixture (autouse) of the zoo tests
TIMEOUT_S = 60


def _ranks(fn, args, tmp_path, world=2, during=None):
    out = run_ranks(fn, (*args, str(tmp_path)), world, timeout_s=TIMEOUT_S,
                    during=during)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)], out


# ---------------------------------------------------------------------------
# 1. the step: 2 ranks x 1 scene against one process x 2 scenes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_reports(tmp_path_factory):
    specs = [dict(base, device="cpu", B=2, seed=11, cpu_caps=True)
             for name, base in DIST_CASES if base["kind"] == "kitti"]
    reports = dist_step_compare(specs, str(tmp_path_factory.mktemp("kd")))
    return {s["name"]: r for s, r in zip(specs, reports)}


@pytest.mark.parametrize("name", KITTI_DIST)
def test_step_equals_one_process(name, step_reports):
    rep = step_reports[name]
    assert rep["loss_rel"] < 1e-5, rep["loss"]
    worst = max(rep["tb_rel"], key=rep["tb_rel"].get)
    assert rep["tb_rel"][worst] < 1e-5, (worst, rep["tb_rel"][worst])
    assert rep["ranks_same_bits"]
    mods = {"vfe.", "backbone_2d.", "dense_head."} if name == "pointpillar" \
        else {"backbone_3d.", "backbone_2d.", "dense_head."}
    if name in ("second_iou", "voxel_rcnn_car"):
        mods.add("roi_head.")
    assert set(rep["grads"]) == mods
    for pre, g in rep["grads"].items():
        assert g["floor_ok"] and g["vector_rel"] < 2e-2, (pre, g)
    assert all(max(la.values()) == 0 for la in rep["launches"])  # the CPU


# ---------------------------------------------------------------------------
# 2. against the JAX package
# ---------------------------------------------------------------------------

def _plain(cfg):
    return json.loads(json.dumps(cfg))


def _multihead_case(rs):
    """AnchorHeadMulti's two-scene loss inputs (seeded head outputs of the
    tiny SECOND-multihead's shapes, ``_batch``'s GT) and the JAX loss with
    its gradients and the assigner's IoU matrices, from one jit."""
    cfg = CFGS["second_multihead"]()
    jm = jbuild(copy.deepcopy(cfg), num_class=2)
    pm = build_network(EasyDict(_plain(cfg)), 2, device="cpu")
    PP, SS = flat_state(pm)
    with torch.no_grad():
        shapes = {k: tuple(v.shape) for k, v in pm.dense_head(
            PP, pm.backbone_2d(PP, SS, torch.zeros(2, 256, 8, 8)),
            S=SS).items()}
    outs = {k: (rs.randn(*s) * (2.0 if k.startswith("cls") else 0.3)
                ).astype(np.float32) for k, s in shapes.items()}
    b = _batch(0)
    args = [b["gt_boxes"][..., :7], b["gt_boxes"][..., 7].astype(np.int64),
            b["gt_valid"]]
    tables = [(h["anchors"], h["anchor_cls"]) for h in jm.dense_head.heads]
    boxes, labels, valid = (jnp.asarray(a) for a in args)
    labels = labels.astype(jnp.int32)

    def loss(fl):
        lo, tb = jm.dense_head.loss(fl, boxes, labels, valid)
        return lo, (tb, _jax_ious(tables, boxes, labels, valid))

    (_, (jtb, jious)), jg = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.value_and_grad(loss, has_aux=True))(
            {k: jnp.asarray(v) for k, v in outs.items()}))
    case = dict(cfg=_plain(cfg), n_cls=2, outs=outs, args=args,
                grad_keys=tuple(outs), ious=jious)
    return case, jtb, jg


def _roi_case(rs):
    """SECONDHead's two-scene loss inputs (IoU logits, soft labels with 5
    and 11 of 16 RoIs valid, so the global count differs from each
    scene's) and the JAX loss with its gradient."""
    cfg = CFGS["second_iou"]()
    R = 16
    lab = rs.rand(2, R).astype(np.float32)
    lab[0, 5:] = -1.0
    lab[1, 11:] = -1.0
    outs = dict(rcnn_iou=(rs.randn(2, R) * 2).astype(np.float32),
                rcnn_cls_labels=lab)
    jroi = jbuild(copy.deepcopy(cfg), num_class=2).roi_head
    (_, jtb), jg = jax.value_and_grad(lambda x: jroi.loss(dict(
        rcnn_iou=x, rcnn_cls_labels=jnp.asarray(lab))), has_aux=True)(
        jnp.asarray(outs["rcnn_iou"]))
    case = dict(cfg=_plain(cfg), n_cls=2, outs=outs,
                grad_keys=("rcnn_iou",))
    return case, jtb, {"rcnn_iou": np.asarray(jg)}


def test_bev_bn_and_split_losses_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    B, C, H, W = 4, 8, 6, 5
    bn = dict(x=rs.randn(B, C, H, W).astype(np.float32) * 2 + 1,
              weight=(rs.rand(C) + 0.5).astype(np.float32),
              bias=rs.randn(C).astype(np.float32),
              rm=rs.randn(C).astype(np.float32),
              rv=(rs.rand(C) + 0.5).astype(np.float32),
              cot=rs.randn(B, C, H, W).astype(np.float32))
    heads = {"dense_head": _multihead_case(rs), "roi_head": _roi_case(rs)}
    path = tmp_path / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(dict(bn=bn, losses={k: v[0] for k, v in heads.items()}),
                    f)
    ranks, _ = _ranks(dist_jobs.kitti_units_rank, (str(path),), tmp_path)

    def per_scene(x):
        rows = x.transpose(1, 2, 0).reshape(H * W, C)
        y, (rm, rv) = jax_masked_bn(
            rows, jnp.ones(H * W, bool), bn["weight"], bn["bias"], bn["rm"],
            bn["rv"], train=True, momentum=0.01, eps=1e-3,
            axis_name="scene")
        return y.reshape(H, W, C).transpose(2, 0, 1), rm, rv

    def loss(x):
        y, rm, rv = jax.vmap(per_scene, axis_name="scene")(x)
        return jnp.sum(y * bn["cot"]), (y, rm[0], rv[0])

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    dp = NamedSharding(mesh, PartitionSpec("dp"))
    with mesh:
        (_, (y, rm, rv)), gx = jax.jit(jax.value_and_grad(
            loss, has_aux=True), in_shardings=(dp,))(
            jax.device_put(jnp.asarray(bn["x"]), dp))
    assert _rel(torch.cat([r["bn"]["y"] for r in ranks]), y) < 1e-5
    assert _rel(torch.cat([r["bn"]["grad"] for r in ranks]), gx) < 1e-5
    for r in ranks:
        upd = r["bn"]["updates"]
        assert _rel(upd["bn.running_mean"], rm) < 1e-5
        assert _rel(upd["bn.running_var"], rv) < 1e-5
        assert torch.equal(upd["bn.running_var"],
                           ranks[0]["bn"]["updates"]["bn.running_var"])

    for head, (case, jtb, jg) in heads.items():
        assert set(ranks[0][head]["tb"]) == set(jtb), head
        for k in jtb:
            got = np.mean([r[head]["tb"][k] for r in ranks])
            assert _rel(got, jtb[k]) < 1e-5, (head, k, got, jtb[k])
        for k in case["grad_keys"]:      # the step divides the sum by W
            mine = np.concatenate([r[head]["grads"][k].numpy() / 2
                                   for r in ranks])
            assert np.abs(np.asarray(jg[k])).max() > 0, (head, k)
            assert _rel_norm(mine, jg[k]) < 2e-2, (head, k)


# ---------------------------------------------------------------------------
# 3. the CLIs on second.yaml
# ---------------------------------------------------------------------------

def test_cli_dist_on_kitti(tmp_path, monkeypatch):
    """A 5-frame tree (every frame in both splits): the ``test`` CLI over
    2 ranks (3 and 2 frames) against one process, then the ``train`` CLI
    over 2 ranks for one epoch at b = 1 (two steps a rank)."""
    root = tmp_path / "kitti"
    write_kitti_tree(root, 5, n_points=20_000, seed=4, n_objects=12,
                     n_train=5)
    cfg = dist_jobs.tiny_kitti_cfg("second", load_config(KITTI_CFG))
    names = list(cfg.CLASS_NAMES)
    model = build_network(cfg.MODEL, len(names), device="cpu",
                          dataset=dataset_meta(cfg.DATA_CONFIG, names))
    with torch.no_grad():            # the prior lifted: the model detects
        model.dense_head.get_parameter("conv_cls.bias").zero_()
    ckpt = str(tmp_path / "checkpoint_epoch_1.pkl")
    save_checkpoint(ckpt, model)
    test_argv = ["--cfg_file", KITTI_CFG, "--ckpt", ckpt]
    train_argv = ["--cfg_file", KITTI_CFG, "--batch_size", "1", "--epochs",
                  "1"]
    for d in ("one", "ranks"):
        (tmp_path / d).mkdir()

    def one_process():
        args, cfg = test_cli.parse_config(
            [*test_argv, "--device", "cpu", "--set",
             "DATA_CONFIG.DATA_PATH", str(root)])
        with monkeypatch.context() as m:
            m.chdir(tmp_path / "one")
            return test_cli.main(args, dist_jobs.tiny_kitti_cfg("second",
                                                                cfg))

    ranks, ref = _ranks(dist_jobs.kitti_cli_rank, (
        test_argv, train_argv, "second", str(root),
        str(tmp_path / "ranks")), tmp_path, during=one_process)
    (metrics,) = ref.values()
    assert "Car_3d/moderate_R40" in metrics
    assert ranks[0]["test"] == ref and ranks[1]["test"] == {}
    (one,), (two,) = ((tmp_path / d).rglob("result.pkl")
                      for d in ("one", "ranks"))
    with open(one, "rb") as f:
        annos = pickle.load(f)
    with open(two, "rb") as f:
        merged = pickle.load(f)
    assert len(annos) == 5 and sum(len(a["name"]) for a in annos) > 0
    assert [a["frame_id"] for a in merged] == [a["frame_id"] for a in annos]
    for a, b in zip(merged, annos):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    out = tmp_path / "ranks" / ranks[0]["train"]
    with open(out / "ckpt" / "checkpoint_epoch_1.pkl", "rb") as f:
        ck = pickle.load(f)
    assert (ck["epoch"], ck["it"]) == (1, 2)   # 5 frames, 2 ranks, b = 1
    st0, st1 = ranks[0]["state"], ranks[1]["state"]
    assert set(st0) == set(st1) and st0
    assert all(torch.equal(st0[k], st1[k]) for k in st0)
    assert any(not torch.equal(st0[k], v.cpu()) for k, v in
               model.state_dict().items() if k.endswith(".weight"))


def test_kitti_dist_without_torchrun_raises(monkeypatch):
    for k in commu_utils.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    args, cfg = train_cli.parse_config(["--cfg_file", KITTI_CFG, "--dist",
                                        "--device", "cpu"])
    with pytest.raises(RuntimeError, match="torchrun"):
        train_cli.main(args, cfg)


# ---------------------------------------------------------------------------
# 4. the sync points' order, two ranks faked in one process
# ---------------------------------------------------------------------------

def collective_order(model, batch, monkeypatch, rank):
    """The cross-rank sums that ``model.forward_train(batch)`` and its
    backward issue as rank ``rank`` of two ranks faked in this process:
    ``group_size`` is 2 wherever the step reads it and an all-reduce
    doubles its tensor (the sum of two ranks with this rank's inputs).
    Returns ([(k, element counts of the summed tensors)] in issue order,
    k < 0 for the backward's; the number issued by the forward; the
    loss)."""
    from cagroup3d_tpu_torch.core import norm
    from cagroup3d_tpu_torch.models.dense_heads import (anchor_head,
                                                        anchor_head_multi,
                                                        center_head)
    from cagroup3d_tpu_torch.models.detectors import second_net
    from cagroup3d_tpu_torch.models.roi_heads import pvrcnn_head, second_head
    for mod in (norm, second_net, second_head, pvrcnn_head, anchor_head,
                anchor_head_multi, center_head, commu_utils):
        monkeypatch.setattr(mod, "group_size", lambda group: 2)
    monkeypatch.setattr(second_net, "group_rank", lambda group: rank)
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, group=None: t.mul_(2))
    issued = []
    real = norm.RankSum.sum_checked

    def sum_checked(self, k, tensors):
        issued.append((k, tuple(t.numel() for t in tensors)))
        return real(self, k, tensors)

    monkeypatch.setattr(norm.RankSum, "sum_checked", sum_checked)
    loss, _, _ = model.forward_train(batch, torch.Generator().manual_seed(0),
                                     group=object())
    n = len(issued)
    loss.backward()
    return issued, n, loss


def check_collective_order(build, batch, monkeypatch):
    """Each BN of the model (one a ``running_mean`` buffer) issues one sync
    point in the forward, numbered 1..n in order, and the backward issues
    -n..-1 over the same tensors in reverse, identically as either rank;
    the loss is finite."""
    runs = []
    for rank in (0, 1):
        with monkeypatch.context() as m:
            model = build()
            runs.append(collective_order(model, batch, m, rank))
    (issued, n, loss), (issued1, _, _) = runs
    n_bn = sum(k.endswith(".running_mean") for k in model.state_dict())
    assert n == n_bn > 0
    assert [k for k, _ in issued] == list(range(1, n + 1)) + \
        list(range(-n, 0))
    assert [s for _, s in issued[n:]] == [s for _, s in issued[:n]][::-1]
    assert issued1 == issued
    assert torch.isfinite(loss)
