"""PyTorch port vs the JAX package: Voxel R-CNN's second stage -- the voxel
queries, the RoI grid pool from the sparse levels, the R-CNN trunk (heads,
box decode, the canonical target transform, the loss with its corner
term), the eval forward and the training step -- at the tiny widths of
``tests/test_voxelrcnn.py::voxelrcnn_cfg`` (GRID_SIZE 4, 16-channel pools
over ``x_conv2`` .. ``x_conv4``, 16 offsets of [-2, 2]^3 each), with the
port's seeded init loaded into both packages and inputs from numpy seeds.

The sparse half (MeanVFE, VoxelBackBone8x, HeightCompression) is
SECOND's, which ``test_torch_second.py`` holds; here the second stage runs
on seeded sparse levels (unique lattice coordinates inside each level's
extent, post-ReLU features, padding rows invalid) and seeded BEV maps, as
``test_torch_second_iou.py`` runs SECOND-IoU's.  Each stage is fed the
JAX output of the stage before where a discrete step follows (a grid
point's lattice floor, the radius test, the proposals, NMS): the port's
pool reads the JAX grid points (XLA's and torch's f32 sin and cos differ
in the last bit), the training step the JAX step's proposals, sampling
draws and assigner IoU matrices.  The JAX step stops the gradient at the
proposals, as the reference and the port do (the JAX package lets it flow
into the grid points and the corner loss's decode).  The JAX voxel size
goes into each jit as an argument: closed over, XLA multiplies by its
reciprocal where the port divides.  ``DP_RATIO`` is 0: the port's dropout
draws from a ``torch.Generator``.

Tolerances: offsets, voxel rows, masks, labels and NMS keep masks exact;
grid points within 1e-6 relative to the largest magnitude; pooled
features, head outputs and boxes within 1e-5; loss terms within 1e-5
relative (the training step's within 1e-4) and their gradients within
1e-5 in norm; the training step's BN updates within 1e-4
(``_updates_close``) and its gradients within 1e-3 in norm per module
(``_grads_close``), the sparse levels' too; the whole ``forward_eval``
(seeded class logits in both stages) with scores within 1e-6 and boxes
within 2e-2 of their largest magnitude (the sparse half's bf16 gathers);
two faked ranks against one process within 1e-5.
"""
import copy
import functools
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.core import hashing as jhash
from cagroup3d_tpu.core import pointnet2_stack as jps
from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.core.sparse import SparseTensor as JSparse
from cagroup3d_tpu_torch.core import hashing
from cagroup3d_tpu_torch.core import pointnet2_stack as ps
from cagroup3d_tpu_torch.core.module import Ctx, flat_state
from cagroup3d_tpu_torch.core.sparse import PAD_COORD, SparseTensor
from cagroup3d_tpu_torch.models.roi_heads import pvrcnn_head
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu_torch.models import build_network
from test_torch_kitti_zoo import (DEFAULT_BITS, _batch, _bev, _feed_ious,
                                  _grads_close, _jax_ious, _rel, _rel_norm,
                                  _scene_ctxs, _seeded_state, _t,
                                  _updates_close, bits, vrcnn_cfg)
from test_torch_train_units import _jax_draws

torch.set_num_threads(1)
assert bits        # the key-bits fixture (autouse) of the zoo tests
NAME = "voxel_rcnn_car"
# the tiny config's levels: (name, stride, extent, capacity, channels)
LEVELS = (("x_conv2", 2, (32, 32, 21), 2048, 32),
          ("x_conv3", 4, (16, 16, 11), 1024, 64),
          ("x_conv4", 8, (8, 8, 5), 512, 64))


@functools.lru_cache(maxsize=None)
def _model():
    """(JAX model, P, S, port model) of the tiny config at ``DP_RATIO`` 0:
    the port's seeded init in both (no JAX init to compile;
    ``test_torch_kitti_zoo_cli.py`` holds the names and shapes to the JAX
    init's) and BN statistics off their init."""
    cfg = vrcnn_cfg(0.0)
    prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jhash.set_key_bits(*DEFAULT_BITS)
    try:
        jm = jbuild(copy.deepcopy(cfg), num_class=2)
    finally:
        jhash.set_key_bits(*prev)
    pm = build_network(cfg, num_class=2, device="cpu")
    PP, SS = flat_state(pm)
    P = {k: v.detach().numpy().copy() for k, v in PP.items()}
    S = _seeded_state(SS)
    pm.load_jax_params(P, S)
    return jm, {k: jnp.asarray(v) for k, v in P.items()}, \
        {k: jnp.asarray(v) for k, v in S.items()}, pm


def _levels(seed, B=2, fill=0.5):
    """B scenes' seeded sparse levels {name: (coords i32[B, N, 3], feats
    f32[B, N, C], valid[B, N])}: a ``fill`` share of each capacity valid at
    distinct coordinates of the level's extent, the rest padding."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, _, ext, cap, ch in LEVELS:
        coords = np.full((B, cap, 3), int(PAD_COORD), np.int32)
        feats = np.zeros((B, cap, ch), np.float32)
        valid = np.zeros((B, cap), bool)
        n = min(int(cap * fill), int(np.prod(ext)) * 3 // 4)
        for b in range(B):
            rows = rs.permutation(cap)[:n]
            cells = rs.choice(int(np.prod(ext)), n, replace=False)
            coords[b, rows] = np.stack(np.unravel_index(cells, ext), -1)
            feats[b, rows] = np.abs(rs.randn(n, ch))
            valid[b, rows] = True
        out[name] = (coords, feats, valid)
    return out


def _strides():
    return {name: s for name, s, _, _, _ in LEVELS}


def _jmulti(levels, b=None):
    """The JAX head's ``multi`` of scene b (or of the vmapped scene)."""
    return {name: (JSparse(*(jnp.asarray(a if b is None else a[b])
                             for a in levels[name]), 1), s)
            for name, s, _, _, _ in LEVELS}


def _pmulti(levels, b, feats=None):
    return {name: SparseTensor(_t(levels[name][0][b]), _t(
        levels[name][1][b]) if feats is None else feats[name][b],
        _t(levels[name][2][b]), 1) for name, _, _, _, _ in LEVELS}


def _rois(seed, R, spread=1.0):
    """Seeded RoIs on the tiny 16 x 16 m range, some across its edge."""
    rs = np.random.RandomState(seed)
    return np.concatenate([rs.rand(R, 1) * 18 - 1, rs.rand(R, 1) * 18 - 9,
                           rs.rand(R, 1) * 2 - 2.5,
                           (rs.rand(R, 3) * 3 + 0.5) * spread,
                           rs.rand(R, 1) * 8 - 4], 1).astype(np.float32)


def _with_vs(head, vs, fn, *a):
    """fn(*a) with the JAX head's voxel size a traced argument."""
    saved, head.voxel_size = head.voxel_size, vs
    try:
        return fn(*a)
    finally:
        head.voxel_size = saved


# ------------------------------------------------------------ voxel query
@pytest.mark.parametrize("split", [(10, 10, 10), (11, 11, 8)],
                         ids=["default", "kitti"])
def test_voxel_query_matches_jax(split):
    """``nearest_offsets`` at several ranges and caps; ``voxel_query_offsets``
    and ``voxel_query`` on seeded voxels (some invalid) at each key split,
    with queries beside them, invalid ones, and ones whose coordinate plus
    offset leaves the packable range on each axis (negative past the
    margin, or past the field's width): exact, the out-of-range queries
    -1 at every offset."""
    for r, cap in ((1, 100), (2, 7), (2, 16), (4, 16), (3, 27)):
        np.testing.assert_array_equal(ps.nearest_offsets(r, cap),
                                      jps.nearest_offsets(r, cap))
    rs = np.random.RandomState(1)
    ext = (40, 36, 24)
    cells = rs.choice(int(np.prod(ext)), 3000, replace=False)
    coords = np.stack(np.unravel_index(cells, ext), -1).astype(np.int32)
    valid = rs.rand(3000) > 0.1
    q = coords[rs.randint(0, 3000, 600)] + rs.randint(-2, 3, (600, 3))
    far = np.array([[-11, 5, 5], [5, -40, 5], [5, 5, -11],
                    [1 << split[0], 5, 5], [5, (1 << split[1]) - 5, 5],
                    [5, 5, (1 << split[2]) - 5]], np.int32)
    q = np.concatenate([q, far]).astype(np.int32)
    qvalid = np.concatenate([rs.rand(600) > 0.1, np.ones(6, bool)])
    offs = ps.nearest_offsets(2, 16)
    prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jhash.set_key_bits(*split)
    try:
        want = [np.asarray(w) for w in jax.jit(lambda *a: (
            jps.voxel_query_offsets(*a, offs), jps.voxel_query(*a, 1)))(
            jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(q),
            jnp.asarray(qvalid))]
    finally:
        jhash.set_key_bits(*prev)
    with hashing.key_bits_scope(split):
        got = [ps.voxel_query_offsets(_t(coords), _t(valid), _t(q),
                                      _t(qvalid), offs),
               ps.voxel_query(_t(coords), _t(valid), _t(q), _t(qvalid), 1)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
        assert (w[-6:] == -1).all() and (w[:600][~qvalid[:600]] == -1).all()
        assert (w[:600] >= 0).any() and (w[:600][qvalid[:600]] == -1).any()


# ------------------------------------------------------------ grid pool
def _jax_pool(jm, P, S, train):
    head = jm.roi_head

    def pool(rois, levels, vs, ct):
        def scene(r, lv):
            ctx = JCtx(train=train, axis_name="scene" if train else None)
            grid = head.get_global_grid_points(r)
            out = head.roi_grid_pool_voxel(
                P, S, ctx, r, jnp.arange(r.shape[0]) % 7 != 3,
                _jmulti(lv), "roi_head")
            return out, grid, ctx.updates

        if not train:
            return _with_vs(head, vs, scene, rois[0],
                            {k: tuple(a[0] for a in v)
                             for k, v in levels.items()})

        def loss(feats):
            lv = {k: (v[0], feats[k], v[2]) for k, v in levels.items()}
            out, grid, upd = _with_vs(head, vs, lambda: jax.vmap(
                scene, axis_name="scene")(rois, lv))
            return jnp.sum(out * ct), (out, grid, {k: v[0] for k, v in
                                                   upd.items()})
        return jax.value_and_grad(loss, has_aux=True)(
            {k: v[1] for k, v in levels.items()})
    return pool


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_roi_grid_pool_voxel_matches_jax(train, monkeypatch):
    """The RoI grid pool on seeded sparse levels and 24 RoIs a scene (every
    seventh invalid, some across the range's edge), fed the JAX grid
    points: eval on one scene; training on two (every BN pooled over both
    scenes, against the JAX ``scene`` vmap) with the VJP of a seeded
    cotangent into the levels' features.  Pooled features within 1e-5,
    BN updates within 1e-5, the features' gradient within 1e-5 in norm;
    invalid RoIs give zero rows, valid ones do not."""
    jm, P, S, pm = _model()
    B = 2 if train else 1
    lv = _levels(2, B)
    rois = np.stack([_rois(3 + b, 24) for b in range(B)])
    rvalid = np.arange(24) % 7 != 3
    C = pm.roi_head.pool_out_channels * 64
    ct = np.random.RandomState(4).randn(B, 24, C).astype(np.float32)
    res = jax.jit(_jax_pool(jm, P, S, train))(
        jnp.asarray(rois), {k: tuple(jnp.asarray(a) for a in v)
                            for k, v in lv.items()},
        jnp.asarray(pm.voxel_size, jnp.float32), jnp.asarray(ct))
    if train:
        (_, (want, jgrid, jupd)), jgf = res
    else:
        want, jgrid, jupd = res
        want, jgrid = want[None], jgrid[None]
    grid = pm.roi_head.get_global_grid_points(_t(rois).reshape(-1, 7))
    assert _rel(grid.numpy(), np.asarray(jgrid).reshape(-1, 64, 3)) < 1e-6
    monkeypatch.setattr(pm.roi_head, "get_global_grid_points",
                        lambda r: _t(jgrid).reshape(-1, 64, 3))
    PP, SS = flat_state(pm)
    feats = {k: _t(v[1]).requires_grad_() for k, v in lv.items()}
    ctx = Ctx(train=train)
    got = pm.roi_head.roi_grid_pool_voxel(
        PP, SS, ctx, _t(rois), _t(np.broadcast_to(rvalid, (B, 24))),
        [_pmulti(lv, b, feats) for b in range(B)], _strides())
    want = np.asarray(want)
    assert _rel(got.detach().numpy(), want) < 1e-5
    assert (want.reshape(B, 24, -1)[:, ~rvalid] == 0).all()
    assert (np.abs(want.reshape(B, 24, -1)[:, rvalid]).max(-1) > 0).all()
    if train:
        _updates_close(ctx.updates, jupd, 1e-5)
        (got * _t(ct)).sum().backward()
        for k, f in feats.items():
            assert _rel_norm(f.grad.numpy(), jgf[k]) < 1e-5, k


# ------------------------------------------------------------ the trunk
def test_trunk_matches_jax():
    """On seeded inputs: the heads (eval BN) on 20 pooled RoIs, four of
    them invalid; the box decode; the RoI sampling with the JAX draws and
    the GT boxes in the RoIs' canonical frame (RoIs jittered about GT
    boxes, their headings over every quadrant, so the heading fold and the
    mod 2 pi both act); the loss with its corner term, some RoIs without a
    label or foreground, and its gradients into the head outputs."""
    jm, P, S, pm = _model()
    head, jhead = pm.roi_head, jm.roi_head
    PP, SS = flat_state(pm)
    rs = np.random.RandomState(5)
    pooled = np.abs(rs.randn(20, 64 * head.pool_out_channels)).astype(
        np.float32)
    valid = np.arange(20) % 5 != 2
    rois, reg = _rois(6, 40), (rs.randn(40, 7) * 0.3).astype(np.float32)
    G, R = 5, 48
    gt = _rois(7, G)
    glab = np.array([1, 2, 1, 1, 2], np.int32)
    src = rs.randint(0, G, R)
    rr = gt[src] + np.concatenate([rs.randn(R, 3) * 0.2,
                                   rs.randn(R, 3) * 0.05,
                                   rs.randn(R, 1) * 0.3 + np.pi *
                                   rs.randint(-2, 3, (R, 1))], 1).astype(
        np.float32)
    rr[:, 3:6] = np.abs(rr[:, 3:6]) + 0.05
    args = (rr, rs.rand(R).astype(np.float32), glab[src], rs.rand(R) < 0.9,
            gt, glab, np.arange(G) < 4)
    fwd = dict(rois=rr[None, :32],
               rcnn_cls=rs.randn(1, 32, 1).astype(np.float32),
               rcnn_reg=(rs.randn(1, 32, 7) * 0.3).astype(np.float32),
               rcnn_cls_labels=np.where(rs.rand(1, 32) < 0.2, -1.0,
                                        rs.rand(1, 32)).astype(np.float32),
               reg_valid_mask=(rs.rand(1, 32) < 0.6).astype(np.int32))
    diff = ("rcnn_cls", "rcnn_reg")
    key = jax.random.PRNGKey(8)

    def jref(x, v, rois, reg, args, fwd):
        """Every JAX reference of this test in one jit: the heads, the
        decode, the sampling, the loss on its targets and its VJP."""
        heads = jhead._heads(P, S, JCtx(), x, v, "roi_head")
        jt = jhead.sample_targets(JCtx(rng=key), *args)
        fwd = dict(fwd, gt_of_rois=jt["gt_of_rois_ct"][None],
                   gt_of_rois_src=jt["gt_of_rois"][None])
        (_, jtb), jg = jax.value_and_grad(lambda d: jhead.loss(dict(
            fwd, **d)), has_aux=True)({k: fwd[k] for k in diff})
        return heads, jhead.decode_boxes(rois, reg), jt, jtb, jg

    (jcls, jreg), jdec, jt, jtb, jg = jax.tree_util.tree_map(
        np.asarray, jax.jit(jref)(*jax.tree_util.tree_map(
            jnp.asarray, (pooled, valid, rois, reg, args, fwd))))
    with torch.no_grad():
        cls, reg_out = head._heads(PP, SS, Ctx(), _t(pooled), _t(valid))
    assert _rel(cls.numpy(), jcls) < 1e-5 and \
        _rel(reg_out.numpy(), jreg) < 1e-5
    np.testing.assert_allclose(head.decode_boxes(_t(rois), _t(reg)).numpy(),
                               jdec, rtol=1e-5, atol=1e-5)
    # sampling and the canonical transform
    _, sub = jax.random.split(key)
    t = head.sample_targets(None, *(_t(a) for a in args),
                            draws=_jax_draws(sub, R, 32))
    for k in ("rois", "gt_of_rois", "reg_valid_mask", "roi_labels"):
        np.testing.assert_array_equal(t[k].numpy(), jt[k], k)
    np.testing.assert_allclose(t["gt_of_rois_ct"].numpy(),
                               jt["gt_of_rois_ct"], rtol=1e-5, atol=1e-5)
    h = t["gt_of_rois_ct"][:, 6]
    assert float(h.abs().max()) <= np.pi / 2 and float(h.min()) < 0 < \
        float(h.max())
    # the loss
    fwd.update(gt_of_rois=jt["gt_of_rois_ct"][None],
               gt_of_rois_src=jt["gt_of_rois"][None])
    x = {k: _t(fwd[k]).requires_grad_() for k in diff}
    loss, tb = head.loss(dict({k: _t(v) for k, v in fwd.items()}, **x))
    loss.backward()
    assert set(tb) == set(jtb)
    for k in jtb:
        assert abs(float(tb[k]) - float(jtb[k])) <= \
            1e-5 * abs(float(jtb[k])), k
    assert float(tb["rcnn_loss_corner"]) > 0
    for k in diff:
        assert _rel_norm(x[k].grad.numpy(), jg[k]) < 1e-5, k


# ------------------------------------------------------------ eval
def _jprops(jm, out, train):
    boxes, scores = jm.dense_head.decoded_boxes(out)
    best = jnp.max(scores, axis=-1)
    labels = jnp.argmax(scores, axis=-1).astype(jnp.int32)
    return jm.roi_head.proposal_layer(boxes, best, labels,
                                      jnp.ones(best.shape[0], bool),
                                      train=train)


def test_forward_test_and_eval_match_jax():
    """``forward_test`` on seeded sparse levels and 32 seeded proposals
    (some invalid): boxes, scores, labels and valid mask against the JAX
    head's.  Then the whole ``forward_eval`` from the points (one scene),
    both packages' anchor heads and RoI heads handing on the same seeded
    class logits: valid masks and labels exact, scores within 1e-6, boxes
    within 2e-2 (the sparse half's bf16 gathers on both sides)."""
    jm, P, S, pm = _model()
    PP, SS = flat_state(pm)
    lv = _levels(9, 1)
    rois = _rois(10, 32, spread=0.6)
    labels = np.random.RandomState(11).randint(0, 2, 32).astype(np.int32)
    rvalid = np.arange(32) < 28
    b = _batch(4, B=1)
    jfwd, pfwd = jm.dense_head.forward, pm.dense_head.forward
    jheads, pheads = jm.roi_head._heads, pm.roi_head._heads
    rs = np.random.RandomState(12)
    A = pm.dense_head.anchors_np.shape[0]
    logits = (rs.randn(A, 2) * 2).astype(np.float32)
    rlog = (rs.randn(32, 1) * 2).astype(np.float32)

    def jforward(*a, **kw):
        return dict(jfwd(*a, **kw), cls_preds=jnp.asarray(logits))

    def pforward(*a, **kw):
        return dict(pfwd(*a, **kw), cls_preds=_t(logits))

    def jstages(vs, levels, r, lab, v, bt):
        head = jm.roi_head
        one = head.forward_test(P, S, JCtx(), r, jnp.ones(32), lab, v,
                                _jmulti(levels, 0), score_thresh=0.1,
                                nms_thresh=0.1, max_out=32)
        saved = jm.voxel_size
        jm.voxel_size = vs
        jm.dense_head.forward = jforward
        head._heads = lambda *a: (jnp.asarray(rlog), jheads(*a)[1])
        try:
            whole = jm.forward_eval(P, S, bt)
        finally:
            jm.voxel_size = saved
            jm.dense_head.forward = jfwd
            del head._heads
        return one, whole

    one, want = jax.jit(lambda vs, *a: _with_vs(
        jm.roi_head, vs, jstages, vs, *a))(
        jnp.asarray(pm.voxel_size, jnp.float32),
        {k: tuple(jnp.asarray(a) for a in v) for k, v in lv.items()},
        jnp.asarray(rois), jnp.asarray(labels), jnp.asarray(rvalid),
        {k: jnp.asarray(b[k]) for k in ("points", "points_valid")})
    with torch.no_grad():
        got = pm.roi_head.forward_test(
            PP, SS, Ctx(), _t(rois), _t(labels), _t(rvalid),
            _pmulti(lv, 0), _strides(), score_thresh=0.1, nms_thresh=0.1,
            max_out=32)
    for k, g in zip(("pred_boxes", "pred_scores", "pred_labels",
                     "pred_valid"), got):
        if k in ("pred_labels", "pred_valid"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(one[k]))
        else:
            assert _rel(g.numpy(), one[k]) < 1e-5, k
    assert 4 < int(got[3].sum()) < 28
    pm.dense_head.forward = pforward
    pm.roi_head._heads = lambda *a, **kw: (_t(rlog), pheads(*a, **kw)[1])
    try:
        whole = pm.forward_eval({k: _t(b[k]) for k in ("points",
                                                       "points_valid")})
    finally:
        del pm.dense_head.forward, pm.roi_head._heads
    assert whole["pred_boxes"].shape == (1, 32, 7)
    for k in ("pred_valid", "pred_labels"):
        np.testing.assert_array_equal(whole[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(whole["pred_scores"].numpy(),
                               np.asarray(want["pred_scores"]), rtol=1e-6,
                               atol=1e-6)
    assert int(whole["pred_valid"].sum()) > 5
    assert _rel(whole["pred_boxes"].numpy(), want["pred_boxes"]) < 2e-2


# ------------------------------------------------------------ training
def _jax_step(jm, P, S, bevs, levels, b):
    """The JAX training step from BEV maps and sparse levels on, the
    proposals' gradient stopped: ((loss, (tb, BN updates, proposals, the
    assigner's IoU matrices)), (gradients of P, of the levels' features))."""
    gt = jnp.asarray(b["gt_boxes"])
    boxes, labels = gt[..., :-1], gt[..., -1].astype(jnp.int32)
    gvalid = jnp.asarray(b["gt_valid"])
    head = jm.dense_head

    def step(P, feats, vs):
        def scene(bev, lv, bx, lab, v, r):
            ctx = JCtx(train=True, axis_name="scene", rng=r)
            bev2d = jm.backbone_2d(P, S, ctx, bev)
            out = head.forward(P, S, ctx, bev2d)
            props = jax.lax.stop_gradient(_jprops(jm, out, True))
            roi_out = jm.roi_head.forward_train(
                P, S, ctx, *props, bx, lab, v, _jmulti(lv))
            return out, ctx.updates, props, roi_out

        lv = {k: (jnp.asarray(v[0]), feats[k], jnp.asarray(v[2]))
              for k, v in levels.items()}
        outs, upd, props, roi = _with_vs(jm.roi_head, vs, lambda: jax.vmap(
            scene, axis_name="scene")(
            jnp.asarray(bevs), lv, boxes, labels, gvalid,
            jax.random.split(jax.random.PRNGKey(1), len(bevs))))
        loss, tb = head.loss(outs, boxes, labels, gvalid)
        loss_r, tb_r = jm.roi_head.loss(roi)
        tb.update(tb_r)
        return loss + loss_r, (tb, {k: v[0] for k, v in upd.items()}, props,
                               _jax_ious([(head.anchors_np,
                                           head.anchor_cls_np)], boxes,
                                         labels, gvalid))

    feats = {k: jnp.asarray(v[1]) for k, v in levels.items()}
    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.value_and_grad(
        step, argnums=(0, 1), has_aux=True))(
        P, feats, jnp.asarray(jm.voxel_size, jnp.float32)))


def test_training_step_matches_jax():
    """``train_heads`` (B = 2, DP_RATIO 0) on seeded BEV maps and sparse
    levels against the JAX step with the proposals' gradient stopped: the
    RPN and R-CNN loss terms within 1e-4, every BN update (the 2-D
    backbone's, the anchor head's and the RoI head's, pooled over both
    scenes) within 1e-4, and the gradients of the 2-D backbone, the anchor
    head, the RoI head and the sparse levels' features within 1e-3 in
    norm.  The port reads the JAX step's proposals, IoU matrices and
    sampling draws."""
    jm, P, S, pm = _model()
    b = _batch(0)
    bevs = _bev((2, 8, 8, 256))
    lv = _levels(13, 2)
    (_, (jtb, jupd, jprops, (jiou,))), (jg, jgf) = _jax_step(
        jm, P, S, bevs, lv, b)
    R = jprops[0].shape[1]
    draws = []
    for r in jax.random.split(jax.random.PRNGKey(1), 2):
        _, sub = jax.random.split(r)        # the scene ctx's next_rng()
        draws.append(_jax_draws(sub, R, 32))
    props = iter([tuple(_t(p[i]) for p in jprops) for i in range(2)])
    pm.proposals = lambda out, train: next(props)
    _feed_ious(pm.dense_head, jiou)
    pm.zero_grad()
    PP, SS = flat_state(pm)
    feats = {k: _t(v[1]).requires_grad_() for k, v in lv.items()}
    ctxs = _scene_ctxs(2)
    for i, c in enumerate(ctxs):
        c.multi_scale_3d = _pmulti(lv, i, feats)
    try:
        loss, tb, upd = pm.train_heads(PP, SS, ctxs,
                                       _t(bevs).permute(0, 3, 1, 2),
                                       {k: _t(v) for k, v in b.items()},
                                       roi_draws=draws)
    finally:
        del pm.proposals, pm.dense_head.match_iou
    loss.backward()
    assert set(tb) == set(jtb)
    for k in jtb:
        assert abs(float(tb[k]) - float(jtb[k])) <= \
            1e-4 * abs(float(jtb[k])) + 1e-7, k
    assert float(tb["rcnn_loss_reg"]) > 0 and \
        float(tb["rcnn_loss_corner"]) > 0
    _updates_close(upd, jupd)
    _grads_close(pm, jg, ("backbone_2d.", "dense_head.", "roi_head."))
    for k, f in feats.items():
        assert _rel_norm(f.grad.numpy(), jgf[k]) < 1e-3, k
        assert float(f.grad.abs().max()) > 0, k


# ------------------------------------------------------------ --dist
class _TwoRanks:
    """Two ranks faked by two threads of this process: ``global_sum``
    meets the other thread and returns both ranks' sum (in rank order)."""

    def __init__(self):
        self.barrier = threading.Barrier(2)
        self.slots = [None, None]

    def global_sum(self, t, group=None):
        self.slots[group] = t.detach().clone()
        self.barrier.wait()
        out = self.slots[0] + self.slots[1]
        self.barrier.wait()
        return out


@pytest.mark.parametrize("case", ["both", "one"])
def test_two_ranks_equal_one_process(case, monkeypatch):
    """The R-CNN loss over two faked ranks of one scene each (seeded head
    outputs and targets, 11 and 5 of 16 RoIs labelled; ``one``: no
    foreground RoI on rank 1) against one process over both scenes: the
    ranks' mean loss and tb terms within 1e-5, and each rank's gradients
    of its head outputs over W within 1e-5 in norm of the one
    process's."""
    _, _, _, pm = _model()
    head = pm.roi_head
    rs = np.random.RandomState(14)
    rois = np.stack([_rois(15 + i, 16) for i in range(2)])
    gt = rois + (rs.randn(2, 16, 7) * 0.1).astype(np.float32)
    lab = rs.rand(2, 16).astype(np.float32)
    lab[0, 11:] = lab[1, 5:] = -1.0
    fg = (rs.rand(2, 16) < 0.5).astype(np.int32)
    if case == "one":
        fg[1] = 0
    fwd = dict(rois=rois, gt_of_rois=(rs.randn(2, 16, 7) * 0.2).astype(
        np.float32), gt_of_rois_src=gt, rcnn_cls_labels=lab,
        reg_valid_mask=fg, rcnn_cls=rs.randn(2, 16, 1).astype(np.float32),
        rcnn_reg=(rs.randn(2, 16, 7) * 0.3).astype(np.float32))
    diff = ("rcnn_cls", "rcnn_reg")

    def run(sl, group=None):
        x = {k: _t(fwd[k][sl]).requires_grad_() for k in diff}
        loss, tb = head.loss(dict({k: _t(v[sl]) for k, v in fwd.items()},
                                  **x), group=group)
        loss.backward()
        return float(loss), {k: float(v) for k, v in tb.items()}, \
            {k: v.grad for k, v in x.items()}

    ref = run(slice(0, 2))
    fake = _TwoRanks()
    monkeypatch.setattr(pvrcnn_head, "group_size", lambda group: 2)
    monkeypatch.setattr(pvrcnn_head, "global_sum", fake.global_sum)
    ranks = [None, None]

    def rank(r):
        ranks[r] = run(slice(r, r + 1), group=r)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert all(r is not None for r in ranks)
    assert _rel(np.mean([r[0] for r in ranks]), ref[0]) < 1e-5
    for k, v in ref[1].items():
        assert _rel(np.mean([r[1][k] for r in ranks]), v) < 1e-5, k
    for k in diff:
        mine = torch.cat([r[2][k] / 2 for r in ranks])
        assert _rel_norm(mine.numpy(), ref[2][k].numpy()) < 1e-5, k
