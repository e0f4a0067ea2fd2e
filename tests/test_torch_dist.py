"""Training and evaluation over several processes (``--dist``) on the CPU:
two ranks spawned over gloo (``chip_smoke.run_ranks``; the jobs they run
are in ``tests/dist_jobs.py``), each bounded by its process group's
timeout and a join timeout, so a hang fails the test in a minute.

The semantics are the JAX package's dp mesh: W ranks of b scenes each
compute what one process computes on the W * b scenes.

1. ``make_train_step`` over 2 ranks of one scene against the port's one
   process at B = 2 (``chip_smoke.dist_step_compare``), for CAGroup3D
   (ScanNet and SUN RGB-D) and RBGNet at tiny widths: the first step's
   loss and every tb term within 1e-5, the ranks' parameters and buffers
   the same bits after two steps, the head's and the RoI head's gradients
   within 2e-2 in relative norm.
2. Against the JAX package: train-mode BN over 2 ranks of 2 scenes equals
   ``masked_batch_norm`` under a psum over 4 scenes sharded on 2 devices
   (outputs, running statistics and the input gradient); the dense-head
   and RoI losses split over 2 ranks of one scene equal the JAX package's
   two-scene loss (tb within 1e-5, gradients within 2e-2).
3. The entry points: ``merge_results_dist`` equals the JAX package's; the
   ``test`` CLI with ``--dist`` over a 5-scene tree (uneven shards) gives
   the one-process result.pkl, in order, and the same mAP; the ``train``
   CLI with ``--dist`` over a 5-scene tree at b = 1 finishes (every rank
   takes two steps) with the ranks' parameters the same bits; ``--dist``
   without torchrun's environment raises.
"""
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import dist_jobs
from cagroup3d_tpu.config import EasyDict as JEasyDict
from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.core.norm import masked_batch_norm as jax_masked_bn
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu.utils import commu_utils as jcommu
from cagroup3d_tpu_torch.datasets import DataLoader
from cagroup3d_tpu_torch.models import load_config
from cagroup3d_tpu_torch.tools import test as test_cli
from cagroup3d_tpu_torch.tools import train as train_cli
from cagroup3d_tpu_torch.training.checkpoint import save_checkpoint
from cagroup3d_tpu_torch.utils import commu_utils
from cagroup3d_tpu_torch.utils.synthetic import write_indoor_tree
from chip_smoke import (CFGS, RBG_CFGS, build_model, dist_step_compare,
                        run_ranks)
from test_torch_train_stages import HEAD_FLOAT_OUTS, synthetic_batch, tiny_cfg

torch.set_num_threads(1)
TIMEOUT_S = 60
SCENE = dict(n_points=1000, n_objects=4, room=(3.0, 3.0, 2.5))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _ranks(fn, args, tmp_path, world=2):
    run_ranks(fn, (*args, str(tmp_path)), world, timeout_s=TIMEOUT_S)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# 1. the step: 2 ranks x 1 scene against one process x 2 scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scannet", "sunrgbd", "rbgnet"])
def test_step_equals_one_process(name, tmp_path):
    kind = "rbgnet" if name == "rbgnet" else "cagroup3d"
    cfg = RBG_CFGS["scannet"] if kind == "rbgnet" else CFGS[name]
    (rep,) = dist_step_compare([dict(kind=kind, cfg=cfg, tiny=True,
                                     cpu_caps=True, device="cpu", B=2,
                                     seed=11)], str(tmp_path))
    assert rep["loss_rel"] < 1e-5, rep["loss"]
    worst = max(rep["tb_rel"], key=rep["tb_rel"].get)
    assert rep["tb_rel"][worst] < 1e-5, (worst, rep["tb_rel"][worst])
    assert rep["ranks_same_bits"]
    heads = ("point_head.",) if kind == "rbgnet" else ("dense_head.",
                                                       "roi_head.")
    for pre in heads:
        g = rep["grads"][pre]
        assert g["floor_ok"] and g["vector_rel"] < 2e-2, (pre, g)


# ---------------------------------------------------------------------------
# 2. against the JAX package
# ---------------------------------------------------------------------------

def test_masked_batch_stats_matches_jax_psum(tmp_path):
    rs = np.random.RandomState(0)
    B, n, c = 4, 64, 8
    a = dict(x=rs.randn(B, n, c).astype(np.float32) * 2 + 1,
             mask=rs.rand(B, n) > 0.3,
             weight=(rs.rand(c) + 0.5).astype(np.float32),
             bias=rs.randn(c).astype(np.float32),
             rm=rs.randn(c).astype(np.float32),
             rv=(rs.rand(c) + 0.5).astype(np.float32),
             cot=rs.randn(B, n, c).astype(np.float32))
    ranks = _ranks(dist_jobs.bn_rank, (a,), tmp_path)

    def per_scene(x, m):
        return jax_masked_bn(x, m, a["weight"], a["bias"], a["rm"], a["rv"],
                             train=True, axis_name="scene")

    def loss(x):
        y, (rm, rv) = jax.vmap(per_scene, axis_name="scene")(
            x, jnp.asarray(a["mask"]))
        return jnp.sum(y * a["cot"]), (y, rm[0], rv[0])

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    dp = NamedSharding(mesh, PartitionSpec("dp"))
    with mesh:
        (_, (y, rm, rv)), gx = jax.jit(jax.value_and_grad(
            loss, has_aux=True), in_shardings=(dp,))(
            jax.device_put(jnp.asarray(a["x"]), dp))
    y_port = torch.cat([r["y"] for r in ranks])
    g_port = torch.cat([r["grad"] for r in ranks])
    assert _rel(y_port, y) < 1e-5
    assert _rel(g_port, gx) < 1e-5
    for r in ranks:
        assert _rel(r["updates"]["bn.running_mean"], rm) < 1e-5
        assert _rel(r["updates"]["bn.running_var"], rv) < 1e-5
        assert torch.equal(r["updates"]["bn.running_mean"],
                           ranks[0]["updates"]["bn.running_mean"])


@pytest.fixture(scope="module")
def jax_head_outputs():
    """The tiny JAX model's train-mode head outputs on two scenes (the
    setup of ``test_torch_train_stages.py``, semantic gate open), their
    loss inputs and the JAX package's two-scene loss with its gradients
    w.r.t. the float outputs."""
    cfg = tiny_cfg()
    jm = jbuild(JEasyDict(cfg), num_class=4)
    P, S = jax.jit(jm.init)(jax.random.PRNGKey(0))
    P = dict(P)
    P["dense_head.semantic_conv.bias"] = \
        P["dense_head.semantic_conv.bias"] * 0 + 5.0
    batch = synthetic_batch(np.random.RandomState(0))

    @jax.jit
    def head(points, pvalid):
        st, origin, pts = jm._voxelize_scene(points, pvalid)
        feat = jm.backbone_3d(P, S, JCtx(train=True), st)
        out = jax.vmap(lambda c, v, f: jm.dense_head.forward(
            P, S, JCtx(train=True, axis_name="scene"),
            feat.__class__(c, f, v, feat.stride), jnp.float32(0.15)),
            axis_name="scene")(feat.coords[None], feat.valid[None],
                               feat.feats[None])
        return {k: v[0] for k, v in out.items()}, origin, pts

    res = [head(jnp.asarray(batch["points"][b]),
                jnp.asarray(batch["points_valid"][b])) for b in range(2)]
    outs = {k: np.stack([np.asarray(r[0][k]) for r in res])
            for k in res[0][0]}
    origins = np.stack([np.asarray(r[1]) for r in res])
    gt = batch["gt_boxes"].copy()
    gt[..., :3] -= origins[:, None, :]
    args = [gt[..., :7], gt[..., 7].astype(np.int32), batch["gt_valid"],
            np.stack([np.asarray(r[2]) for r in res]), batch["points_valid"],
            batch["semantic_mask"], batch["instance_mask"]]
    fl = {k: jnp.asarray(v) for k, v in outs.items() if k in HEAD_FLOAT_OUTS}
    rest = {k: jnp.asarray(v) for k, v in outs.items()
            if k not in HEAD_FLOAT_OUTS}
    (_, jtb), jg = jax.jit(jax.value_and_grad(lambda fl: jm.dense_head.loss(
        {**rest, **fl}, *(jnp.asarray(x) for x in args), ins_cap=16),
        has_aux=True))(fl)
    return cfg, outs, args, jtb, jg


def _roi_inputs(rs):
    """Two scenes of RoI training outputs with 5 and 11 foreground rois of
    24 (the normalizer then differs between the scenes)."""
    R = 24
    rois = np.concatenate([rs.rand(2, R, 3) * 3, rs.rand(2, R, 3) * 0.5
                           + 0.3, np.zeros((2, R, 1))], -1)
    gt = rois + np.concatenate([rs.randn(2, R, 3) * 0.05,
                                rs.randn(2, R, 3) * 0.03,
                                np.zeros((2, R, 1))], -1)
    fg = np.zeros((2, R), np.int32)
    fg[0, :5] = 1
    fg[1, :11] = 1
    local = np.concatenate([gt[..., :3] - rois[..., :3], gt[..., 3:]], -1)
    return dict(rois=rois.astype(np.float32),
                gt_of_rois=local.astype(np.float32),
                gt_of_rois_src=gt.astype(np.float32),
                rcnn_reg=(rs.randn(2, R, 6) * 0.1).astype(np.float32),
                reg_valid_mask=fg)


@pytest.mark.parametrize("head", ["dense_head", "roi_head"])
def test_split_losses_match_jax(head, jax_head_outputs, tmp_path):
    cfg, outs, args, jtb, jg = jax_head_outputs
    if head == "roi_head":
        cfg = {**cfg, "ROI_HEAD": {**cfg["ROI_HEAD"], "USE_IOU_LOSS": True}}
        outs, args = _roi_inputs(np.random.RandomState(3)), []
        jroi = jbuild(JEasyDict(cfg), num_class=4).roi_head
        (_, jtb), jg = jax.value_and_grad(
            lambda reg: jroi.loss({**{k: jnp.asarray(v) for k, v in
                                      outs.items()}, "rcnn_reg": reg}),
            has_aux=True)(jnp.asarray(outs["rcnn_reg"]))
        jg, keys = {"rcnn_reg": jg}, ("rcnn_reg",)
    else:
        keys = HEAD_FLOAT_OUTS
    path = tmp_path / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(dict(outs=outs, args=args, grad_keys=keys), f)
    ranks = _ranks(dist_jobs.loss_rank, (cfg, 4, head, str(path)), tmp_path)
    assert set(ranks[0]["tb"]) == set(jtb)
    for k in jtb:
        assert _rel(np.mean([r["tb"][k] for r in ranks]), jtb[k]) < 1e-5, k
    for k in keys:             # the step divides the ranks' sum by W
        mine = np.concatenate([r["grads"][k].numpy() / 2 for r in ranks])
        assert np.abs(np.asarray(jg[k])).max() > 0, k
        assert _rel_norm(mine, jg[k]) < 2e-2, k


# ---------------------------------------------------------------------------
# 3. entry points
# ---------------------------------------------------------------------------

def test_merge_results_dist_equals_jax(monkeypatch):
    """Uneven shards (rank 0 holds one item more), cut to total_size."""
    gathered = [[{"frame_id": f"s{i}"} for i in range(r, 7, 3)]
                for r in range(3)]
    monkeypatch.setattr(commu_utils, "all_gather", lambda d, g=None: gathered)
    monkeypatch.setattr(jcommu, "all_gather", lambda d: gathered)
    for total in (None, 7, 5):
        mine = commu_utils.merge_results_dist(gathered[0], total_size=total)
        assert mine == jcommu.merge_results_dist(gathered[0],
                                                 total_size=total)
    assert [d["frame_id"] for d in mine] == [f"s{i}" for i in range(5)]


def test_loader_ranks_take_len_batches():
    """Training: with len(dataset) % W != 0 every rank yields len(loader)
    batches (rank 0 would hold one more); eval keeps every scene."""
    class Items:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return i

        def collate_batch(self, items):
            return items

    for train in (True, False):
        loaders = [DataLoader(Items(), 1, shuffle=train, rank=r, world_size=2,
                              drop_last=train) for r in range(2)]
        got = [list(ld) for ld in loaders]
        if train:
            assert [len(g) for g in got] == [len(ld) for ld in loaders] == \
                [2, 2]
        else:
            assert sorted(x for g in got for b in g for x in b) == \
                list(range(5))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_tree")
    names = load_config(CFGS["scannet"]).CLASS_NAMES
    write_indoor_tree(root, "scannet", names, 5, seed=6, **SCENE)
    return root


def _argv(which, *extra):
    return ["--cfg_file", CFGS["scannet"], "--batch_size", "1", *extra]


def test_test_cli_dist_merges_uneven_shards(tree, tmp_path, monkeypatch):
    cfg = dist_jobs.tiny_cli_cfg(load_config(CFGS["scannet"]), tree,
                                 SCENE["n_points"])
    model = build_model(cfg.MODEL, len(cfg.CLASS_NAMES), "cpu", seed=1)
    ckpt = str(tmp_path / "checkpoint_epoch_1.pkl")
    save_checkpoint(ckpt, model)
    argv = _argv("test", "--ckpt", ckpt)
    (tmp_path / "one").mkdir()
    (tmp_path / "two").mkdir()

    def one_process():
        args, cfg = test_cli.parse_config([*argv, "--device", "cpu"])
        dist_jobs.tiny_cli_cfg(cfg, tree, SCENE["n_points"], repeat=1)
        with monkeypatch.context() as m:
            m.chdir(tmp_path / "one")
            return test_cli.main(args, cfg)

    ref = run_ranks(dist_jobs.cli_rank, ("test", argv, str(tree),
                                         SCENE["n_points"],
                                         str(tmp_path / "two"), str(tmp_path)),
                    2, TIMEOUT_S, during=one_process)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert ranks[0]["ret"] == ref and ranks[1]["ret"] == {}
    (one,), (two,) = ((tmp_path / d).rglob("result.pkl")
                      for d in ("one", "two"))
    with open(one, "rb") as f:
        annos = pickle.load(f)
    with open(two, "rb") as f:
        merged = pickle.load(f)
    assert [a["frame_id"] for a in merged] == [a["frame_id"] for a in annos]
    assert len(annos) == 5 and sum(len(a["labels_3d"]) for a in annos) > 0
    for a, b in zip(merged, annos):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_cli_dist_uneven_tree(tree, tmp_path):
    ranks = _ranks(dist_jobs.cli_rank, (
        "train", _argv("train", "--epochs", "1"), str(tree),
        SCENE["n_points"], str(tmp_path)), tmp_path)
    out = tmp_path / ranks[0]["ret"]
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pkl"
    with open(ckpt, "rb") as f:
        ck = pickle.load(f)
    assert ck["epoch"] == 1 and ck["it"] == 2      # 5 scenes, 2 ranks, b = 1
    assert len(list(out.glob("log_train_*.txt"))) == 1
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 1
    st0, st1 = ranks[0]["state"], ranks[1]["state"]
    assert set(st0) == set(st1) and st0
    assert all(torch.equal(st0[k], st1[k]) for k in st0)


@pytest.mark.parametrize("which", ["train", "test"])
def test_dist_without_torchrun_raises(which, monkeypatch):
    for k in commu_utils.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    cli = train_cli if which == "train" else test_cli
    args, cfg = cli.parse_config([*_argv(which, "--ckpt", "x.pkl"),
                                  "--dist", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(args, cfg)
