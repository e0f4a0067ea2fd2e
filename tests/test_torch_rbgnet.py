"""PyTorch port vs the JAX package: the tiny RBGNet (``tests/test_rbgnet.py::
tiny_rbg_cfg`` widths, ``synthetic_batch`` scenes of 400 points) without
and with headings (``with_rot``), eval forward and training step.

A module-scoped fixture runs the JAX model of each configuration once,
jitted: its eval forward at batch 1 with the ray grouping on its own
inputs, and the value and gradient of its training loss at batch 2 with
the outputs, BN updates and targets.  The port runs on the same weights
(the port's seeded init, copied into the JAX model) and inputs.

The JAX functions close over the batch.  With the batch passed as a jit
argument instead, XLA's CPU compile of the JAX package's training
gradient puts the first SA level's parameter gradients about 3% away from
both the JAX package's own op-by-op (eager) gradient and the port's, which
agree within 5e-4; closed over, the jitted gradient equals the eager one
to that level.  XLA's algebraic simplifier makes the difference: with it
off (``XLA_FLAGS=--xla_disable_hlo_passes=algsimp``) the jit-argument
gradient agrees with the closed-over one within 3e-4.

Tolerances (f32 on both sides): FPS indices, gating masks (the argmax of
the intersection scores), labels, valid masks and integer targets exactly
equal; outputs within 1e-4 of their largest magnitude; the loss and each
loss term within 1e-4 relative; each parameter's gradient within 1e-3
relative in norm.  A parameter whose JAX gradient is below 1e-6 of the
largest (a conv bias feeding a training-mode BN, zero in exact
arithmetic) is held to that floor on both sides.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.core import pointnet2 as jpn2
from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu_torch.core.module import Ctx, flat_state
from cagroup3d_tpu_torch.models import build_network
from tests.test_detector import synthetic_batch
from tests.test_rbgnet import tiny_rbg_cfg

torch.set_num_threads(1)
TOL = 1e-4
RBG = "point_head.raybasedgrouping"


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(got - ref).max() <= tol * scale, \
        np.abs(got - ref).max() / scale


def _equal(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _loss_batch(b):
    return dict(points=b["points"][..., :3], points_valid=b["points_valid"],
                gt_boxes=b["gt_boxes"][..., :7],
                gt_labels=b["gt_boxes"][..., 7].astype(jnp.int32)
                if isinstance(b["gt_boxes"], jnp.ndarray)
                else b["gt_boxes"][..., 7].to(torch.int32),
                gt_valid=b["gt_valid"],
                semantic_mask=b.get("semantic_mask"),
                instance_mask=b.get("instance_mask"))


def _jax_functions(with_rot):
    """The JAX model of one configuration, its weights (the port's seeded
    init), and its eval and training reference functions (unjitted)."""
    cfg = tiny_rbg_cfg(with_rot=with_rot)
    jm = jbuild(cfg, num_class=4)
    head = jm.point_head
    pm = build_network(cfg, 4, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    P = {k: jnp.asarray(v.detach().numpy())
         for k, v in pm.named_parameters()}
    S = {k: jnp.asarray(v.numpy()) for k, v in pm.named_buffers()}
    b1 = synthetic_batch(np.random.RandomState(0), B=1, P=400)
    b2 = dict(synthetic_batch(np.random.RandomState(0), B=2, P=400))
    if with_rot:
        b2.pop("semantic_mask")
        b2.pop("instance_mask")

    def eval_ref(P):
        ctx = JCtx(train=False)
        pts, pv = b1["points"][0], b1["points_valid"][0]
        bb = jm.backbone_3d(P, S, ctx, pts[:, :3], pts[:, 3:6] / 255.0, pv)
        out = head.forward(P, S, ctx, bb)
        # the ray grouping's inputs, as the head's forward makes them
        vx, vf, _, vv = head.vote_module(
            P, S, ctx, bb["fp_xyz"], bb["fp_features"], bb["fp_valid"],
            prefix="point_head.vote_module")
        idx = jpn2.farthest_point_sample(
            bb["fp_xyz"], bb["fp_valid"], head.num_proposal) \
            if str(head.test_cfg.SAMPLE_MODE) == "seed" else None
        _, agg_feats, _, _ = head.vote_aggregation(
            P, S, ctx, "point_head.vote_aggregation", vx, vf, vv,
            sample_idx=idx)
        rbg_in = (bb["fp_xyz"], bb["fp_features"], bb["fp_valid"],
                  out["scale_pred"], out["aggregated_points"], pts[:, :3], pv,
                  agg_feats)
        rbg = head.rbg(P, S, ctx, RBG, *rbg_in)
        fps = jpn2.farthest_point_sample(pts[:, :3], pv,
                                         head.rbg.fps_num_sample)
        boxes = head.generate_predicted_boxes(out, pts[:, :3], pv,
                                              max_out=jm.max_out)
        return dict(bb=bb, out=out, rbg_in=rbg_in, rbg=rbg, fps=fps,
                    boxes=boxes, fe=jm.forward_eval(P, S, b1))

    def train_ref(P):
        def scene(points, pvalid):
            ctx, bb, out = jm._scene(P, S, True, points, pvalid, None)
            return bb, out, ctx.updates
        bbs, outs, upd = jax.vmap(scene, axis_name="scene")(
            b2["points"], b2["points_valid"])
        lb = _loss_batch(b2)
        loss, tb = head.loss(outs, bbs, lb, ins_cap=jm.ins_cap)
        sm, im = lb["semantic_mask"], lb["instance_mask"]
        if sm is None:
            sm = jnp.full(lb["points"].shape[:2], head.num_classes,
                          jnp.int32)
            im = jnp.zeros(lb["points"].shape[:2], jnp.int32)
        tg = jax.vmap(lambda o, *a: head._targets_single(
            o, *a, jm.ins_cap))(outs, lb["points"], lb["points_valid"], sm,
                                im, lb["gt_boxes"], lb["gt_labels"],
                                lb["gt_valid"])
        fps = jax.vmap(lambda p, v: jpn2.farthest_point_sample(
            p, v, head.fps_num_sample))(lb["points"], lb["points_valid"])
        return loss, dict(tb=tb, upd={k: v[0] for k, v in upd.items()},
                          outs=outs, tg=tg, fps=fps)

    floats, ints = _head_outputs(pm.point_head, b2)

    def loss_ref(floats):
        outs = dict(ints["outs"], **{k: v for k, v in floats.items()
                                     if not k.startswith("sa")})
        bbs = dict(fp_indices=ints["fp_indices"], sa_scores=[
            (floats[f"sa{i}"], idx) for i, idx in enumerate(ints["sa_idx"])])
        return head.loss(outs, bbs, _loss_batch(b2), ins_cap=jm.ins_cap)

    return dict(pm=pm, P=P, with_rot=with_rot, eval_ref=eval_ref,
                train_ref=jax.value_and_grad(train_ref, has_aux=True),
                loss_ref=jax.value_and_grad(loss_ref, has_aux=True),
                floats=floats, ints=ints,
                b1={k: _t(v) for k, v in b1.items()},
                b2={k: _t(v) for k, v in b2.items()})


def _head_outputs(head, b2):
    """Seeded head and backbone outputs of the training batch ``b2`` with
    the first three proposals of each scene 5 cm from its GT centres, so
    that proposals are positive and every loss term counts (the tiny
    model's own proposals are all negative on this batch).  Returns
    (float entries by name, the integer and mask entries)."""
    rng = np.random.RandomState(5)
    pts = np.asarray(b2["points"])[..., :3]
    gt = np.asarray(b2["gt_boxes"])
    B, Pn, Ns = pts.shape[0], head.num_proposal, 64
    nb, nf, R = head.sample_bin_num, head.fine_sample_bin_num, head.ray_num
    K, D = head.num_classes, head.num_dir_bins
    agg = rng.rand(B, Pn, 3) * 3.0
    agg[:, :3] = gt[:, :3, :3] + rng.randn(B, 3, 3) * 0.05
    seeds = pts[:, :Ns]
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    floats = dict(
        vote_points=f32(seeds + rng.randn(B, Ns, 3) * 0.1),
        aggregated_points=f32(agg),
        center=f32(agg + rng.randn(B, Pn, 3) * 0.05),
        scale_res_norm=f32(rng.randn(B, Pn) * 0.3),
        scale_pred=f32(np.exp(rng.randn(B, Pn) * 0.3)),
        dir_class=f32(rng.randn(B, Pn, D)),
        dir_res_norm=f32(rng.randn(B, Pn, D) * 0.3),
        size_res_norm=f32(rng.randn(B, Pn, 3) * 0.3 - 0.8),
        obj_scores=f32(rng.randn(B, Pn, 2)),
        sem_scores=f32(rng.randn(B, Pn, K)),
        fine_intersec_score=f32(rng.randn(B, Pn, nf * R, 2)),
        coarse_intersec_score=f32(rng.randn(B, Pn, nb * R, 2)),
        **{f"sa{i}": f32(rng.randn(B, n, 2))
           for i, n in enumerate((128, 64, 32))})
    ints = dict(
        outs=dict(seed_points=f32(seeds),
                  seed_valid=jnp.ones((B, Ns), bool)),
        fp_indices=jnp.asarray(np.tile(np.arange(Ns), (B, 1)), jnp.int32),
        sa_idx=[jnp.asarray(rng.randint(0, pts.shape[1], (B, n)), jnp.int32)
                for n in (128, 64, 32)])
    return floats, ints


def _arg(case, name):
    return case["floats"] if name == "loss_ref" else case["P"]


@pytest.fixture(scope="module")
def refs():
    """Both configurations' JAX references, each compiled in a thread as
    soon as it is traced (XLA compiles outside the GIL, so the compiles
    overlap the tracing that follows), the slow training gradients
    first."""
    cases = {w: _jax_functions(w) for w in (False, True)}
    jobs = [(c, name) for name in ("train_ref", "eval_ref", "loss_ref")
            for c in cases.values()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        compiling = [ex.submit(jax.jit(c[name]).lower(_arg(c, name)).compile)
                     for c, name in jobs]
        for (c, name), fn in zip(jobs, compiling):
            c[name] = fn.result()(_arg(c, name))
    for c in cases.values():
        c["ev"] = c.pop("eval_ref")
        (c["loss"], c["tr"]), c["grads"] = c.pop("train_ref")
        (c["pos_loss"], c["pos_tb"]), c["pos_grads"] = c.pop("loss_ref")
    return cases


@pytest.fixture(params=[False, True], ids=["no_rot", "with_rot"])
def ref(refs, request):
    return refs[request.param]


def _port(ref):
    return flat_state(ref["pm"])


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

def test_ray_based_grouping_matches_jax(ref):
    """The port's ray grouping on the JAX inputs: outputs, the gating masks
    of both branches and the FPS subsample of the scene."""
    P, S = _port(ref)
    rbg = ref["pm"].point_head.rbg
    inputs = [_t(x)[None] for x in ref["ev"]["rbg_in"]]
    with torch.no_grad():
        pooled, fine, coarse, fps = rbg(P, S, Ctx(), RBG, *inputs)
    rp, rf, rc = ref["ev"]["rbg"]
    _close(pooled[0], rp)
    _close(fine[0], rf)
    _close(coarse[0], rc)
    _equal(fps[0], ref["ev"]["fps"])
    for got, r in ((fine, rf), (coarse, rc)):
        _equal(got[0].argmax(-1), np.argmax(np.asarray(r), -1))
    assert coarse.shape[-2] == 5 * 18 and fine.shape[-2] == 3 * 18


def test_head_forward_matches_jax(ref):
    """The port's head on the JAX backbone outputs."""
    P, S = _port(ref)
    bb = {k: (_t(v)[None] if k != "sa_scores" else v)
          for k, v in ref["ev"]["bb"].items()}
    with torch.no_grad():
        out = ref["pm"].point_head(P, S, Ctx(), bb)
    rout = ref["ev"]["out"]
    assert set(rout) <= set(out)
    for k, r in rout.items():
        if np.asarray(r).dtype == bool:
            _equal(out[k][0], r)
        else:
            _close(out[k][0], r)
    _equal(out["ray_fps_idx"][0], ref["ev"]["fps"])


def test_generate_predicted_boxes_matches_jax(ref):
    """Decoding, the point-count filter, aligned NMS and the per-class
    proposals on the JAX head outputs."""
    out = {k: _t(v)[None] for k, v in ref["ev"]["out"].items()}
    b = ref["b1"]
    boxes, scores, labels, valid = \
        ref["pm"].point_head.generate_predicted_boxes(
            out, b["points"][..., :3], b["points_valid"],
            max_out=ref["pm"].max_out)
    rb, rs, rl, rv = ref["ev"]["boxes"]
    _close(boxes[0], rb)
    _close(scores[0], rs)
    _equal(labels[0], rl)
    _equal(valid[0], rv)
    assert valid.any()
    if ref["with_rot"]:
        assert (boxes[0, valid[0], 6] != 0).any()


def test_forward_eval_matches_jax(ref):
    """The whole eval forward, with the backbone's outputs on the way."""
    P, S = _port(ref)
    pm, b = ref["pm"], ref["b1"]
    with torch.no_grad():
        bb, _ = pm._forward(P, S, Ctx(), b["points"], b["points_valid"])
    rbb = ref["ev"]["bb"]
    _close(bb["fp_features"][0], rbb["fp_features"])
    for k in ("fp_xyz", "fp_valid", "fp_indices"):
        _equal(bb[k][0], rbb[k])
    for (s, i), (rs, ri) in zip(bb["sa_scores"], rbb["sa_scores"]):
        _close(s[0], rs)
        _equal(i[0], ri)
    got = pm.forward_eval({k: b[k] for k in ("points", "points_valid")})
    fe = ref["ev"]["fe"]
    assert set(got) == set(fe)
    assert got["pred_boxes"].shape == (1, 64, 7)
    _close(got["pred_boxes"], fe["pred_boxes"])
    _close(got["pred_scores"], fe["pred_scores"])
    _equal(got["pred_labels"], fe["pred_labels"])
    _equal(got["pred_valid"], fe["pred_valid"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_targets_match_jax(ref):
    """The port's targets on the JAX training outputs; the targets' FPS
    subsample of the scene, which the port takes from its forward, equals
    the JAX targets' own FPS call, and the port's forward's."""
    pm, b, tr = ref["pm"], ref["b2"], ref["tr"]
    outs = {k: _t(tr["outs"][k]) for k in ("aggregated_points",
                                           "scale_pred")}
    outs["ray_fps_idx"] = _t(tr["fps"])
    tg = pm.point_head.targets(outs, _loss_batch(b), pm.ins_cap)
    assert set(tg) == set(tr["tg"])
    for k, r in tr["tg"].items():
        if np.asarray(r).dtype.kind == "f":
            _close(tg[k], r)
        else:
            _equal(tg[k], r)
    assert int(tg["vote_m"].sum()) > 0
    P, S = _port(ref)
    with torch.no_grad():
        _, out = pm._forward(P, S, Ctx(train=True), b["points"],
                             b["points_valid"])
    _equal(out["ray_fps_idx"], tr["fps"])


def test_loss_matches_jax(ref):
    pm, tr = ref["pm"], ref["tr"]
    loss, tb, upd = pm.forward_train(ref["b2"], torch.Generator())
    assert abs(float(loss.detach()) - float(ref["loss"])) <= \
        TOL * abs(float(ref["loss"]))
    assert set(tb) == set(tr["tb"])
    for k, r in tr["tb"].items():
        got = float(tb[k].detach())
        assert abs(got - float(r)) <= TOL * max(abs(float(r)), 1e-6), k
    assert set(upd) == set(tr["upd"])
    for k, r in tr["upd"].items():
        _close(upd[k], r)


def test_gradients_match_jax(ref):
    pm = ref["pm"]
    pm.zero_grad()
    pm.forward_train(ref["b2"], torch.Generator())[0].backward()
    norms = {k: float(np.linalg.norm(np.asarray(v, np.float64)))
             for k, v in ref["grads"].items()}
    floor = 1e-6 * max(norms.values())
    errs = {}
    for k, p in pm.named_parameters():
        g = p.grad.double().numpy()
        if norms[k] < floor:
            assert np.linalg.norm(g) < floor, k
            continue
        errs[k] = np.linalg.norm(g - np.asarray(ref["grads"][k],
                                                np.float64)) / norms[k]
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-3, (worst, errs[worst])
    assert len(errs) > 0.75 * len(norms)
    assert pm.get_parameter("point_head.conv_reg.weight").grad.abs().sum() > 0


def test_loss_with_positive_proposals_matches_jax(ref):
    """The loss on seeded head outputs with positive proposals (every term
    non-zero but the 1-bin direction class): each term within 1e-4
    relative, and the gradient of every output within 1e-3 relative in
    norm (the targets' inputs, ``aggregated_points`` and ``scale_pred``,
    carry none in either package)."""
    from cagroup3d_tpu_torch.core.pointnet2 import farthest_point_sample
    pm, b = ref["pm"], ref["b2"]
    head = pm.point_head
    leaves = {k: _t(v).requires_grad_() for k, v in ref["floats"].items()}
    ints = ref["ints"]
    outs = dict({k: _t(v) for k, v in ints["outs"].items()},
                **{k: v for k, v in leaves.items() if not k.startswith("sa")})
    outs["ray_fps_idx"] = farthest_point_sample(
        b["points"][..., :3], b["points_valid"], head.fps_num_sample)
    bbs = dict(fp_indices=_t(ints["fp_indices"]), sa_scores=[
        (leaves[f"sa{i}"], _t(idx)) for i, idx in enumerate(ints["sa_idx"])])
    loss, tb = head.loss(outs, bbs, _loss_batch(b), ins_cap=pm.ins_cap)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref["pos_loss"])) <= \
        TOL * abs(float(ref["pos_loss"]))
    for k, r in ref["pos_tb"].items():
        got = float(tb[k].detach())
        assert abs(got - float(r)) <= TOL * max(abs(float(r)), 1e-6), k
    zero = {"dir_class_loss"} if not ref["with_rot"] else set()
    assert all(float(ref["pos_tb"][k]) > 0 for k in ref["pos_tb"]
               if k not in zero), ref["pos_tb"]
    for k, g in leaves.items():
        r = np.asarray(ref["pos_grads"][k], np.float64)
        if k in ("aggregated_points", "scale_pred"):
            assert g.grad is None and not r.any(), k
        elif not r.any():          # one direction bin: its CE is constant
            assert k == "dir_class" and not g.grad.any(), k
        else:
            err = np.linalg.norm(g.grad.double().numpy() - r) / \
                np.linalg.norm(r)
            assert err < 1e-3, (k, err)
