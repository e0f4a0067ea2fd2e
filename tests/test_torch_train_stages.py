"""PyTorch port vs the JAX package: the training step stage by stage, at
the tiny configuration of ``tests/test_detector.py`` (4 classes, 16
channels, semantic gate open so the assigner finds positives, dropout off,
capacities that never overflow so the random drop window does not matter).

Each stage gets the JAX package's inputs and the same cotangents, so a
discrete step (threshold, top-k, NMS, sampling) sees identical inputs:

1. the one- and two-scene head loss on the JAX head's outputs: targets
   exact, loss and tb entries within 1e-5, gradients w.r.t. the outputs
   within 2e-2;
2. the head's backward: per-parameter gradients and the input-feature
   gradient within 2e-2 in norm (bf16 conv gathers on both sides);
3. the backbone's backward, the same bars;
4. the RoI head's training forward with the JAX package's sampling draws:
   the sampled rois equal, the loss and the gradients of its parameters,
   of the backbone features and of the rois (through which the RoI loss
   reaches the one-stage head, as in the JAX package) within 2e-2.

The JAX side runs jitted.  Jitted XLA fuses the head's vote add
(coords * voxel + offset) into an FMA, which floors boundary points
differently from the port's (and JAX's eager) unfused arithmetic; the
voxel size here is a power of two, where the product is exact and both
round alike.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.config import EasyDict as JEasyDict
from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.core.sparse import SparseTensor as JST
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu_torch.config import EasyDict
from cagroup3d_tpu_torch.core.module import Ctx
from cagroup3d_tpu_torch.core.sparse import SparseTensor
from cagroup3d_tpu_torch.models import build_network

torch.set_num_threads(1)

TINY_CAPS = {1: 2048, 2: 1024, 4: 512, 8: 256, 16: 128, 32: 64,
             64: 32, 128: 16, 256: 8, 512: 8}
# a power-of-two voxel makes coords * voxel exact, so XLA's fused
# multiply-add of the vote (coords * voxel + offset) rounds as the unfused
# eager sum does, and the jitted JAX head floors the same points
VOXEL = 2.0 ** -6
HEAD_FLOAT_OUTS = ("semantic_scores", "voxel_offsets", "centernesses",
                   "bbox_preds", "cls_scores")


def tiny_cfg(n_classes=4):
    """tests/test_detector.py's tiny configuration (no yaw), with room in
    the class maps for every voxel of an open semantic gate and no RoI
    dropout."""
    return dict(
        NAME="CAGroup3D", VOXEL_SIZE=VOXEL, SEMANTIC_MIN_THR=0.05,
        SEMANTIC_ITER_VALUE=0.02, SEMANTIC_THR=0.15, INPUT_CAP=2048,
        INS_CAP=16,
        BACKBONE_3D=dict(NAME="BiResNet", IN_CHANNELS=3, OUT_CHANNELS=16,
                         PLANES=16, SPP_PLANES=16, CAPS=TINY_CAPS),
        DENSE_HEAD=dict(
            NAME="CAGroup3DHead", OUT_CHANNELS=16, SEMANTIC_THR=0.15,
            VOXEL_SIZE=VOXEL, N_CLASSES=n_classes, N_REG_OUTS=6,
            CLS_KERNEL=3, WITH_YAW=False, USE_SEM_SCORE=False,
            EXPAND_RATIO=3, FINE_CAP=2048, EXPAND_CAP=1024, MAX_ROIS=32,
            NMS_PER_CLS_CAP=32,
            ASSIGNER=dict(NAME="CAGroup3DAssigner", LIMIT=27, TOPK=18,
                          N_SCALES=4),
            LOSS_OFFSET=dict(NAME="SmoothL1Loss", BETA=0.04,
                             REDUCTION="sum", LOSS_WEIGHT=1.0),
            NMS_CONFIG=dict(SCORE_THR=0.01, NMS_PRE=128, IOU_THR=0.5)),
        ROI_HEAD=dict(
            NAME="CAGroup3DRoIHead", NUM_CLASSES=n_classes,
            MIDDLE_FEATURE_SOURCE=[3], GRID_SIZE=7, VOXEL_SIZE=VOXEL,
            COORD_KEY=2, MLPS=[[16, 32, 32]], CODE_SIZE=6,
            ENCODE_SINCOS=False, ROI_PER_IMAGE=16, ROI_FG_RATIO=0.9,
            REG_FG_THRESH=0.3, ROI_CONV_KERNEL=3, ENLARGE_RATIO=False,
            USE_IOU_LOSS=False, GRID_CAP=1024, MAX_OUT=32,
            NMS_PER_CLS_CAP=32, REG_FC=[32, 32], DP_RATIO=0.0,
            LOSS_WEIGHTS=dict(RCNN_CLS_WEIGHT=1.0, RCNN_REG_WEIGHT=1.0,
                              RCNN_IOU_WEIGHT=1.0, CODE_WEIGHT=[1.0] * 6)),
        POST_PROCESSING=dict(RECALL_THRESH_LIST=[0.25, 0.5],
                             EVAL_METRIC="scannet"))


def synthetic_batch(rng, B=2, P=1200, G=8, n_classes=4):
    """tests/test_detector.py's generator (real semantic/instance masks)."""
    pts = np.zeros((B, P, 6), np.float32)
    pvalid = np.zeros((B, P), bool)
    gt = np.zeros((B, G, 8), np.float32)
    gt_valid = np.zeros((B, G), bool)
    sem = np.full((B, P), n_classes, np.int32)
    ins = np.zeros((B, P), np.int32)
    for b in range(B):
        n = P - 100 * b
        n_obj = 3
        centers = rng.rand(n_obj, 3) * 2 + 0.5
        sizes = rng.rand(n_obj, 3) * 0.5 + 0.3
        per = n // (n_obj + 1)
        for i in range(n_obj):
            lo = i * per
            local = (rng.rand(per, 3) - 0.5) * sizes[i]
            pts[b, lo:lo + per, :3] = centers[i] + local
            sem[b, lo:lo + per] = i % n_classes
            ins[b, lo:lo + per] = i + 1
            gt[b, i, :3] = centers[i]
            gt[b, i, 3:6] = sizes[i]
            gt[b, i, 7] = i % n_classes
            gt_valid[b, i] = True
        pts[b, n_obj * per:n, :3] = rng.rand(n - n_obj * per, 3) * 3
        pts[b, :n, 3:6] = rng.rand(n, 3) * 255
        pvalid[b, :n] = True
    return dict(points=pts, points_valid=pvalid, gt_boxes=gt,
                gt_valid=gt_valid, semantic_mask=sem, instance_mask=ins)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _rel_norm(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _grads_close(pm, jgrads, prefix, tol=2e-2):
    """Every parameter gradient under ``prefix`` within ``tol`` in norm of
    the JAX package's.  A gradient that a following batch norm cancels
    (a BN bias feeding only a linear map and another BN: mathematically
    zero) is round-off on both sides; below 1e-4 of the group's largest
    gradient norm it must only stay at that floor.  Returns the number of
    gradients compared."""
    mine = {k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in pm.named_parameters() if k.startswith(prefix)}
    assert set(mine) == {k for k in jgrads if k.startswith(prefix)}
    norms = {k: float(np.linalg.norm(np.asarray(jgrads[k]))) for k in mine}
    floor = 1e-4 * max(norms.values())
    errs = {}
    for k, v in mine.items():
        if norms[k] < floor:
            assert float(v.norm()) < 10 * floor, k
        else:
            errs[k] = _rel_norm(v, jgrads[k])
    worst = max(errs, key=errs.get)
    assert errs[worst] < tol, (worst, errs[worst])
    return len(errs)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    jm = jbuild(JEasyDict(cfg), num_class=4)
    P, S = jax.jit(jm.init)(jax.random.PRNGKey(0))
    P = dict(P)
    P["dense_head.semantic_conv.bias"] = \
        P["dense_head.semantic_conv.bias"] * 0 + 5.0
    pm = build_network(EasyDict(cfg), 4, device="cpu")
    pm.load_jax_params({k: np.asarray(v) for k, v in P.items()},
                       {k: np.asarray(v) for k, v in S.items()})
    batch = synthetic_batch(np.random.RandomState(0))
    vox = [jm._voxelize_scene(jnp.asarray(batch["points"][b]),
                              jnp.asarray(batch["points_valid"][b]))
           for b in range(2)]
    return dict(jm=jm, P=P, S=S, pm=pm, batch=batch, vox=vox, cache={})


def _jax_backbone_vjp(setup, b, cut=None):
    """The JAX train-mode backbone of scene b up to ``cut`` and the VJP of
    a seeded cotangent: ((out, cot), (gradients of the backbone's
    parameters, of the input features)).  One jitted function a cut
    serves both scenes; tracing the backbone is most of this file's
    time, so the forward of every stage below is this one's."""
    key = ("bb", b, cut)
    if key not in setup["cache"]:
        fn = ("bb_fn", cut)
        if fn not in setup["cache"]:
            jm, P, S = setup["jm"], setup["P"], setup["S"]

            def f(bp, feats, st):
                out = jm.backbone_3d({**P, **bp}, S, JCtx(train=True),
                                     st.with_feats(feats), stop_after=cut)
                cot = jax.random.normal(jax.random.PRNGKey(5),
                                        out.feats.shape)
                return jnp.sum(out.feats * cot), (out, cot)

            setup["cache"][fn] = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))
        st = setup["vox"][b][0]
        bp = {k: v for k, v in setup["P"].items()
              if k.startswith("backbone_3d.")}
        (_, aux), grads = setup["cache"][fn](bp, st.feats, st)
        setup["cache"][key] = aux, grads
    return setup["cache"][key]


def _jax_backbone(setup, b):
    """JAX train-mode backbone output of scene b (jitted)."""
    return _jax_backbone_vjp(setup, b)[0][0]


def _jax_head(setup, b):
    """JAX train-mode head outputs of scene b and the gradients of
    sum(out * cot) w.r.t. the head params and the input features."""
    key = ("head", b)
    if key not in setup["cache"]:
        if "head_fn" not in setup["cache"]:
            setup["cache"]["head_fn"] = _jax_head_fn(setup)
        st = _jax_backbone(setup, b)
        hp = {k: v for k, v in setup["P"].items()
              if k.startswith("dense_head.")}
        setup["cache"][key] = setup["cache"]["head_fn"](
            hp, st.coords, st.valid, st.feats, _head_cot(b, st.cap))
    return setup["cache"][key]


def _jax_head_fn(setup):
    jm, P, S = setup["jm"], setup["P"], setup["S"]
    stride = _jax_backbone(setup, 0).stride

    def f(hp, coords, valid, feats, cot):
        # vmapped over a scene axis of one, as the JAX detector runs its
        # training forward (its folded class maps have no unbatched
        # reverse-mode rule); BN pools that one scene
        def one(coords, valid, feats):
            return jm.dense_head.forward(
                {**P, **hp}, S, JCtx(train=True, axis_name="scene"),
                JST(coords, feats, valid, stride), jnp.float32(0.15))

        out = jax.vmap(one, axis_name="scene")(coords[None], valid[None],
                                               feats[None])
        out = {k: v[0] for k, v in out.items()}
        return sum(jnp.sum(out[k] * cot[k]) for k in HEAD_FLOAT_OUTS), out

    g = jax.jit(jax.value_and_grad(f, argnums=(0, 3), has_aux=True))
    return lambda *a: (lambda r: (r[0][1], r[1]))(g(*a))


def _head_cot(b, n2, n_cls=4, cap=2048):
    rs = np.random.RandomState(100 + b)
    shapes = dict(semantic_scores=(n2, n_cls), voxel_offsets=(n2, 3),
                  centernesses=(n_cls, cap, 1), bbox_preds=(n_cls, cap, 6),
                  cls_scores=(n_cls, cap, n_cls))
    return {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}


def _jax_draws(rng, n_rois, n_roi):
    """The draws JAX's proposal ``sample(rng, ...)`` makes, as the port's
    ``draws`` input."""
    r1, r2, r3, r4 = jax.random.split(rng, 4)
    u = np.stack([np.asarray(jax.random.uniform(r, (n_rois,)))
                  for r in (r1, r2, r3)])
    rint = np.asarray(jax.random.randint(r4, (n_roi,), 0, 1 << 30))
    return _t(u), _t(rint).long()


def _port_st(jst, grad=False):
    f = _t(jst.feats).requires_grad_(grad)
    return SparseTensor(_t(jst.coords), f, _t(jst.valid), jst.stride)


# ------------------------------------------------------------------ stages
@pytest.mark.parametrize("n_scenes", [1, 2])
def test_head_loss_on_jax_outputs(setup, n_scenes):
    jm, pm, batch = setup["jm"], setup["pm"], setup["batch"]
    outs = [_jax_head(setup, b)[0] for b in range(n_scenes)]
    jouts = {k: jnp.stack([o[k] for o in outs]) for k in outs[0]}
    origins = np.stack([np.asarray(setup["vox"][b][1])
                        for b in range(n_scenes)])
    pts_norm = np.stack([np.asarray(setup["vox"][b][2])
                         for b in range(n_scenes)])
    gt = batch["gt_boxes"][:n_scenes].copy()
    gt[..., :3] -= origins[:, None, :]
    args = (gt[..., :7], gt[..., 7].astype(np.int32),
            batch["gt_valid"][:n_scenes], pts_norm,
            batch["points_valid"][:n_scenes],
            batch["semantic_mask"][:n_scenes],
            batch["instance_mask"][:n_scenes])
    fl = {k: v for k, v in jouts.items() if k in HEAD_FLOAT_OUTS}
    rest = {k: v for k, v in jouts.items() if k not in HEAD_FLOAT_OUTS}

    def jloss(fl):
        return jm.dense_head.loss({**rest, **fl}, *(jnp.asarray(a)
                                                   for a in args), ins_cap=16)

    (jl, jtb), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(fl)
    mine = {k: _t(v).requires_grad_(k in HEAD_FLOAT_OUTS)
            for k, v in jouts.items()}
    loss, tb = pm.dense_head.loss(mine, *(_t(a) for a in args), ins_cap=16)
    loss.backward()
    assert float(jtb["loss_bbox"]) > 0 and float(jtb["loss_vote"]) > 0
    assert set(tb) == set(jtb)
    for k in tb:
        assert _rel(tb[k], jtb[k]) < 1e-5, (k, float(tb[k]), float(jtb[k]))
    for k in HEAD_FLOAT_OUTS:
        assert _rel_norm(mine[k].grad, jg[k]) < 2e-2, k


def test_head_backward(setup):
    pm = setup["pm"]
    jout, (jgh, jgf) = _jax_head(setup, 0)
    st = _port_st(_jax_backbone(setup, 0), grad=True)
    P, S = dict(pm.named_parameters()), dict(pm.named_buffers())
    pm.zero_grad()
    ctx = Ctx(train=True)
    out = pm.dense_head(P, S, ctx, st, 0.15)
    for k in ("points_valid", "semantic_valid"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    for k in HEAD_FLOAT_OUTS:
        assert _rel(out[k], jout[k]) < 2e-2, k
    cot = _head_cot(0, st.cap)
    sum((out[k] * _t(cot[k])).sum() for k in HEAD_FLOAT_OUTS).backward()
    assert _grads_close(pm, jgh, "dense_head.") > 25
    assert _rel_norm(st.feats.grad, jgf) < 2e-2
    assert set(ctx.updates) == {k for k in S if k.startswith("dense_head.")}


@pytest.mark.parametrize("cut", ["layer2", None])
def test_backbone_backward(setup, cut):
    """Per-parameter gradients within 2e-2 through ``layer2``.  Below it
    the bar is on the whole gradient: both packages round every conv's
    cotangent to bf16, so f32 summation-order differences flip bf16 ulps
    (2^-9) from layer to layer, and train-mode BN over the few voxels of
    the deepest tiny-scene maps (one per DAPPM pyramid level) amplifies
    them; the full backbone's gradient stays within 0.25 in norm and at
    cosine >= 0.98 (measured 0.13 and 0.992)."""
    pm = setup["pm"]
    (ref, cot), (jgb, jgf) = _jax_backbone_vjp(setup, 0, cut)
    st = _port_st(setup["vox"][0][0], grad=True)
    pm.zero_grad()
    out = pm.backbone_3d(dict(pm.named_parameters()),
                         dict(pm.named_buffers()), Ctx(train=True), st,
                         stop_after=cut)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert _rel(out.feats, ref.feats) < 2e-2
    (out.feats * _t(cot)).sum().backward()
    if cut == "layer2":
        assert _grads_close(pm, jgb, "backbone_3d.") > 30
        assert _rel_norm(st.feats.grad, jgf) < 2e-2
        return
    names = [k for k, p in pm.named_parameters()
             if k.startswith("backbone_3d.")]
    assert all(pm.get_parameter(k).grad is not None for k in names)
    a = np.concatenate([pm.get_parameter(k).grad.numpy().ravel()
                        for k in names])
    b = np.concatenate([np.asarray(jgb[k]).ravel() for k in names])
    assert _rel_norm(a, b) < 0.25
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.98
    assert _rel_norm(st.feats.grad, jgf) < 0.25


def test_roi_head_train_and_loss(setup):
    """RoI training forward + loss with the JAX package's sampling draws;
    rois are the one-stage proposals plus jittered GT (foreground)."""
    jm, pm, P, S, batch = (setup[k] for k in ("jm", "pm", "P", "S",
                                               "batch"))
    jst = _jax_backbone(setup, 0)
    jrois, jsc, jlab, jval = jm.dense_head.get_bboxes(_jax_head(setup, 0)[0])
    origin = np.asarray(setup["vox"][0][1])
    gt = batch["gt_boxes"][0].copy()
    gt[:, :3] -= origin
    rs = np.random.RandomState(9)
    aug = gt[:, :7] + np.concatenate([rs.randn(8, 3) * 0.03,
                                      rs.randn(8, 3) * 0.02,
                                      np.zeros((8, 1))], -1)
    rois = np.concatenate([np.asarray(jrois), aug]).astype(np.float32)
    scores = np.concatenate([np.asarray(jsc), np.full(8, 0.99)]).astype(
        np.float32)
    labels = np.concatenate([np.asarray(jlab), gt[:, 7]]).astype(np.int32)
    valid = np.concatenate([np.asarray(jval), batch["gt_valid"][0]])
    glab = gt[:, 7].astype(np.int32)
    key = jax.random.PRNGKey(3)
    rp = {k: v for k, v in P.items() if k.startswith("roi_head.")}

    def jfn(rp, feats, rois):
        out = jm.roi_head.forward_train(
            {**P, **rp}, S, JCtx(train=True, rng=key), jst.with_feats(feats),
            rois, jnp.asarray(scores), jnp.asarray(labels),
            jnp.asarray(valid), jnp.asarray(gt[:, :7]), jnp.asarray(glab),
            jnp.asarray(batch["gt_valid"][0]))
        loss, tb = jm.roi_head.loss({k: v[None] for k, v in out.items()})
        return loss, out

    (jl, jout), (jgr, jgf, jgro) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True))(rp, jst.feats, rois)
    sub = jax.random.split(key)[1]             # JAX's ctx.next_rng()
    draws = _jax_draws(sub, rois.shape[0], 16)
    st = _port_st(jst, grad=True)
    rt = _t(rois).requires_grad_(True)
    pm.zero_grad()
    out = pm.roi_head.forward_train(
        dict(pm.named_parameters()), dict(pm.named_buffers()),
        Ctx(train=True), st, rt, _t(scores), _t(labels), _t(valid),
        _t(gt[:, :7]), _t(glab), _t(batch["gt_valid"][0]), draws=draws)
    np.testing.assert_array_equal(out["rois"].detach().numpy(),
                                  np.asarray(jout["rois"]))
    assert int(out["reg_valid_mask"].sum()) > 0
    loss, _ = pm.roi_head.loss({k: v[None] for k, v in out.items()})
    assert _rel(loss, jl) < 2e-2
    loss.backward()
    assert _grads_close(pm, jgr, "roi_head.") >= 10
    assert _rel_norm(st.feats.grad, jgf) < 2e-2
    assert float(np.abs(np.asarray(jgro)).max()) > 0
    assert _rel_norm(rt.grad, jgro) < 2e-2
