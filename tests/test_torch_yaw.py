"""PyTorch port vs the JAX package: the SUN RGB-D yaw path.

The rotated geometry on random and degenerate box pairs (areas and IoUs
within 1e-5, no NaN; the rotated IoU loss's gradients within 1e-4 of
``jax.grad`` on pairs at least 1e-3 from a degenerate configuration and
finite on the rest), the rotated NMS keep masks, the sin/cos box codes,
the 3-vote targets, the RoI head's canonical transform and decode, then a
tiny yaw model (``WITH_YAW``, 8 regression outputs, ``CODE_SIZE`` 7 with
``ENCODE_SINCOS``, ``USE_IOU_LOSS``) stage by stage as in
``tests/test_torch_detector.py``: each stage gets the JAX package's
inputs.  Its training stages are in ``tests/test_torch_yaw_train.py``
(each file's JAX graphs take tens of seconds to trace and compile on the
CPU, so the two run on separate workers).

The JAX side runs jitted at a power-of-two voxel, where XLA's fused
multiply-adds round the votes as the unfused sums do (the head's class maps
then hold the same points).  The rotated RoI grid points floor into lattice
cells, and one ulp of sin / cos or of a fused multiply-add between the two
packages can move a point across a cell boundary: the tests count and
print such cells (``_grid_cells_apart``, the JAX grid from the JAX
package's own functions, jitted) and compare the rois they do not touch.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.config import EasyDict as JEasyDict
from cagroup3d_tpu.core import geometry as jgeo
from cagroup3d_tpu.core import nms as jnms
from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.core.sparse import SparseTensor as JST
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu.models.model_utils.cagroup_utils import \
    CAGroupResidualCoder as JCoder
from cagroup3d_tpu.utils import loss_utils as JL
from cagroup3d_tpu_torch.config import EasyDict
from cagroup3d_tpu_torch.core import geometry, nms
from cagroup3d_tpu_torch.core.module import Ctx
from cagroup3d_tpu_torch.models import build_network
from cagroup3d_tpu_torch.models.model_utils.cagroup_utils import \
    CAGroupResidualCoder
from cagroup3d_tpu_torch.utils import loss_utils as L
from cagroup3d_tpu_torch.utils.synthetic import synthetic_batch
from test_torch_train_stages import _rel, tiny_cfg

torch.set_num_threads(1)
N_CLS = 4


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- geometry
def _random_boxes(rs, n):
    return np.concatenate([rs.rand(n, 2) * 2 - 1, rs.rand(n, 1) * 0.5,
                           rs.rand(n, 3) * 1.8 + 0.2,
                           (rs.rand(n, 1) - 0.5) * 4 * np.pi],
                          1).astype(np.float32)


def _degenerate_pairs():
    """Identical, containing, edge-sharing, corner-touching, disjoint and
    coincident-footprint (90-degree-turned square) pairs, and the unit box
    the losses pad with."""
    def box(x, y, dx, dy, a, z=0.0, dz=1.0):
        return [x, y, z, dx, dy, dz, a]
    pairs = [
        (box(0, 0, 1, 1, 0), box(0, 0, 1, 1, 0)),
        (box(0.3, -0.2, 2, 1, 0.7), box(0.3, -0.2, 2, 1, 0.7)),
        (box(0, 0, 2, 2, 0.3), box(0, 0, 1, 1, 0.3)),
        (box(0, 0, 3, 3, 0), box(0.2, 0.1, 1, 0.5, 1.1)),
        (box(0, 0, 1, 1, 0), box(1, 0, 1, 1, 0)),
        (box(0, 0, 1, 1, 0), box(1, 1, 1, 1, 0)),
        (box(0, 0, 1, 1, 0), box(0.5, 0, 1, 1, 0)),
        (box(0, 0, 1, 1, 0), box(5, 5, 1, 1, 0.4)),
        (box(0, 0, 1, 1, 0), box(0, 0, 1, 1, np.pi / 2)),
        (box(0, 0, 1, 1, 0), box(0, 0, 1, 1, np.pi)),
        (box(0, 0, 2, 1, 0), box(0, 0, 1, 2, np.pi / 2)),
        (box(0, 0, 1, 1, 0, 0, 1), box(0, 0, 1, 1, 0, 1, 1)),
        (box(0, 0, 1, 1, 1, 1), box(0, 0, 1, 1, 1, 1)),
    ]
    a, b = (np.array(x, np.float32) for x in zip(*pairs))
    return a, b


def _pairs():
    rs = np.random.RandomState(0)
    a, b = _random_boxes(rs, 1200), _random_boxes(rs, 1200)
    # near-coincident pairs, as jittered GT proposals meet their GT
    near = a[:200] + np.concatenate(
        [rs.randn(200, 6) * 0.02, rs.randn(200, 1) * 0.05], 1)
    b = np.concatenate([b, near.astype(np.float32)])
    a = np.concatenate([a, a[:200]])
    da, db = _degenerate_pairs()
    return np.concatenate([a, da]), np.concatenate([b, db]), len(da)


def _jit(fn, *arrays):
    return np.asarray(jax.jit(fn)(*(jnp.asarray(x) for x in arrays)))


GEOMETRY = ["rotated_intersection_area", "iou_bev_rotated", "iou3d_rotated",
            "boxes_to_corners_3d", "_point_in_quad", "_seg_intersections"]
BEV5 = [0, 1, 3, 4, 6]


@functools.lru_cache(maxsize=None)
def _jax_geometry():
    """The JAX package's values of every function of GEOMETRY on the
    pairs, from one compiled call."""
    a, b, _ = _pairs()

    def all_fns(a, b):
        return dict(
            rotated_intersection_area=jgeo.rotated_intersection_area(
                a[:, BEV5], b[:, BEV5]),
            iou_bev_rotated=jgeo.iou_bev_rotated(a, b),
            iou3d_rotated=jgeo.iou3d_rotated(a, b),
            boxes_to_corners_3d=jgeo.boxes_to_corners_3d(a),
            _point_in_quad=jgeo._point_in_quad(
                jgeo.box2corners_bev(b[:, BEV5]), a[:, BEV5]),
            _seg_intersections=jgeo._seg_intersections(
                jgeo.box2corners_bev(a[:, BEV5]),
                jgeo.box2corners_bev(b[:, BEV5])))
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(all_fns)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", GEOMETRY)
def test_rotated_geometry(name):
    a, b, n_deg = _pairs()
    ref = _jax_geometry()[name]
    ca, cb = (geometry.box2corners_bev(_t(x[:, BEV5])) for x in (a, b))
    if name == "_point_in_quad":
        got = geometry._point_in_quad(cb, _t(a[:, BEV5])).numpy()
        np.testing.assert_array_equal(got, ref)
        return
    if name == "_seg_intersections":
        # an edge pair whose crossing lies within 1e-5 of an end of either
        # edge (touching or coincident edges) is decided by round-off
        pts, ok = geometry._seg_intersections(ca, cb)
        c_a, c_b = ca.double().numpy(), cb.double().numpy()
        p0, p1 = (np.repeat(c, 4, 1) for c in (c_a, np.roll(c_a, -1, 1)))
        q0, q1 = (np.tile(c, (1, 4, 1)) for c in (c_b, np.roll(c_b, -1, 1)))
        da, db, d = p1 - p0, q1 - q0, q0 - p0
        den = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
        sden = np.where(np.abs(den) > 1e-12, den, 1.0)
        t = (d[..., 0] * db[..., 1] - d[..., 1] * db[..., 0]) / sden
        u = (d[..., 0] * da[..., 1] - d[..., 1] * da[..., 0]) / sden
        edge = (np.abs(den) < 1e-6) | (np.minimum.reduce(
            [np.abs(t), np.abs(t - 1), np.abs(u), np.abs(u - 1)]) < 1e-5)
        apart = ok.numpy() != ref[1]
        print(f"edge pairs decided apart: {int(apart.sum())}, all within "
              f"1e-5 of an edge end: {bool(edge[apart].all())}")
        assert edge[apart].all()
        np.testing.assert_array_equal(ok.numpy()[~edge], ref[1][~edge])
        # the crossing of nearly parallel edges is ill-conditioned (its
        # round-off grows as 1 / |den|): compare the others
        both = ok.numpy() & ref[1] & (np.abs(den) > 1e-2)
        assert both.sum() > 1000
        np.testing.assert_allclose(pts.numpy()[both], ref[0][both], rtol=0,
                                   atol=1e-5)
        return
    if name == "boxes_to_corners_3d":
        got = geometry.boxes_to_corners_3d(_t(a)).numpy()
    elif name == "rotated_intersection_area":
        got = geometry.rotated_intersection_area(_t(a[:, BEV5]),
                                                 _t(b[:, BEV5])).numpy()
        assert (got[-n_deg:] > 0).sum() >= 8    # the overlapping ones
    else:
        got = getattr(geometry, name)(_t(a), _t(b)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if name == "iou_bev_rotated":
        # identical footprints (degenerate rows 0, 1, 8, 9, 11, 12) -> 1
        np.testing.assert_allclose(got[-n_deg:][[0, 1, 8, 9, 11, 12]], 1.0,
                                   atol=1e-5)


def _degeneracy_margin(a, b):
    """Smallest distance of a corner of either BEV rect to an edge line of
    the other: below it a comparison of the clipping may flip."""
    ca = geometry.box2corners_bev(_t(a[:, BEV5])).numpy()
    cb = geometry.box2corners_bev(_t(b[:, BEV5])).numpy()

    def corner_to_lines(c, q):
        p0, p1 = q, np.roll(q, -1, axis=1)
        e = p1 - p0
        e = e / np.linalg.norm(e, axis=-1, keepdims=True)
        d = c[:, :, None, :] - p0[:, None, :, :]
        return np.abs(e[:, None, :, 0] * d[..., 1] -
                      e[:, None, :, 1] * d[..., 0]).min((1, 2))
    return np.minimum(corner_to_lines(ca, cb), corner_to_lines(cb, ca))


def test_iou3d_loss_gradients():
    a, b, n_deg = _pairs()
    w = np.random.RandomState(1).rand(len(a)).astype(np.float32)

    def jfn(p, t):
        return JL.iou3d_loss(p, t, jnp.asarray(w), avg_factor=3.0,
                             with_yaw=True)

    jv, (jga, jgb) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    pa, pb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    pv = L.iou3d_loss(pa, pb, _t(w), avg_factor=3.0, with_yaw=True)
    pv.backward()
    assert abs(float(pv.detach()) - float(jv)) <= 1e-5 * abs(float(jv))
    assert torch.isfinite(pa.grad).all() and torch.isfinite(pb.grad).all()
    far = _degeneracy_margin(a, b) >= 1e-3
    print(f"pairs at least 1e-3 from a degenerate configuration: "
          f"{int(far.sum())} of {len(a)}")
    assert far.sum() > 1000
    for got, ref in ((pa.grad, jga), (pb.grad, jgb)):
        ref = np.asarray(ref)
        assert _rel(got.numpy()[far], ref[far]) < 1e-4
        assert np.isfinite(ref).all()


@functools.lru_cache(maxsize=None)
def _jax_nms(flip):
    """The JAX package's rotated multiclass NMS and one greedy pass,
    compiled once per ``flip`` (the head's NMS flips the heading; the RoI
    head's, without the flip, runs in ``test_tiny_yaw_eval_stages``)."""
    return (jax.jit(lambda a, b, c: jnms.multiclass_nms(
        a, b, c, 0.2, 0.3, rotated=True, per_cls_cap=32, out_cap=128,
        flip_heading_for_iou=flip)),
        jax.jit(lambda *a: jnms.greedy_nms(*a, 0.3, rotated=True)))


@pytest.mark.parametrize("seed,flip", [(0, True), (1, True), (2, True)])
def test_rotated_multiclass_nms(seed, flip):
    rs = np.random.RandomState(seed)
    P, C = 200, 4
    boxes = _random_boxes(rs, P)
    boxes[:, :2] *= 0.6                         # crowded: suppression
    scores = rs.rand(P, C).astype(np.float32)
    scores[:, 1] = np.round(scores[:, 1], 1)    # score ties
    valid = rs.rand(P) < 0.9
    got = nms.multiclass_nms(_t(boxes), _t(scores), _t(valid), 0.2, 0.3,
                             per_cls_cap=32, out_cap=128, rotated=True,
                             flip_heading_for_iou=flip)
    jmc, jgreedy = _jax_nms(flip)
    ref = jmc(*map(jnp.asarray, (boxes, scores, valid)))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert 0 < int(got[3].sum()) < 100         # candidates suppressed
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # the keep masks of one class's greedy pass
    order = np.argsort(-scores[:, 0], kind="stable")[:32]
    b0 = boxes[order]
    keep = nms.greedy_nms(_t(b0), _t(scores[order, 0]), _t(valid[order]),
                          0.3, rotated=True)
    jkeep = jgreedy(*map(jnp.asarray, (b0, scores[order, 0], valid[order])))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


# ------------------------------------------------------- codes and targets
def test_yaw_coder():
    rs = np.random.RandomState(3)
    boxes = _random_boxes(rs, 60)
    anchors = _random_boxes(rs, 60)
    anchors[:, :3] = 0
    coder, jcoder = CAGroupResidualCoder(7, True), JCoder(7, True)
    assert coder.code_size == jcoder.code_size == 8
    with pytest.raises(NotImplementedError, match="ENCODE_SINCOS"):
        CAGroupResidualCoder(7, False)
    enc = coder.encode(_t(boxes), _t(anchors))
    np.testing.assert_allclose(enc.numpy(), _jit(jcoder.encode, boxes,
                                                 anchors), rtol=1e-6,
                               atol=1e-6)
    codes = (rs.randn(60, 8) * 0.5).astype(np.float32)
    codes[:5] = 0.0                             # padded rows: atan2(0, 0)
    x = _t(codes).requires_grad_(True)
    dec = coder.decode(x, _t(anchors))
    cot = rs.randn(60, 7).astype(np.float32)
    jdec, (jg,) = jax.jit(lambda e, c: (lambda r: (r[0], r[1](c)))(
        jax.vjp(lambda e: jcoder.decode(e, jnp.asarray(anchors)), e)))(
        jnp.asarray(codes), jnp.asarray(cot))
    np.testing.assert_allclose(dec.detach().numpy(), np.asarray(jdec),
                               rtol=1e-6, atol=1e-6)
    dec.backward(_t(cot))
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def model():
    """The tiny yaw configuration in both packages with the same weights
    (the port's seeded init copied into the JAX package's flat dicts)."""
    cfg = yaw_cfg()
    pm = build_network(EasyDict(cfg), N_CLS,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    with torch.no_grad():
        pm.dense_head.semantic_conv.bias.fill_(5.0)
        pm.dense_head.cls_conv.bias.fill_(2.0)
    jm = jbuild(JEasyDict(cfg), num_class=N_CLS)
    P = {k: jnp.asarray(v.detach().numpy()) for k, v in pm.named_parameters()}
    S = {k: jnp.asarray(v.numpy()) for k, v in pm.named_buffers()}
    # the JAX package's own parameters have the same names and shapes
    # (``load_jax_params`` carries the yaw widths across by name)
    jP, jS = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in jP.items()} == \
        {k: v.shape for k, v in P.items()}
    assert {k: v.shape for k, v in jS.items()} == \
        {k: v.shape for k, v in S.items()}
    assert P["dense_head.offset_block.6.kernel"].shape[-1] == 9
    assert P["dense_head.feature_offset.0.kernel"].shape[-1] == 3 * 16
    assert P["roi_head.reg_pred_layer.bias"].shape == (8,)
    return dict(pm=pm, jm=jm, P=P, S=S, cache={})


def yaw_cfg():
    """The stage tests' tiny configuration on the yaw path: three votes,
    fcaf3d heading, rotated IoU losses, sin/cos RoI codes."""
    cfg = tiny_cfg(N_CLS)
    dh, rh = cfg["DENSE_HEAD"], cfg["ROI_HEAD"]
    dh.update(N_REG_OUTS=8, WITH_YAW=True, FINE_CAP=1024, EXPAND_CAP=512,
              MAX_ROIS=16, NMS_PER_CLS_CAP=16,
              LOSS_BBOX=dict(NAME="IoU3DLoss", WITH_YAW=True,
                             LOSS_WEIGHT=1.0))
    dh["LOSS_OFFSET"]["LOSS_WEIGHT"] = 0.2
    rh.update(CODE_SIZE=7, ENCODE_SINCOS=True, USE_IOU_LOSS=True,
              MAX_OUT=16, NMS_PER_CLS_CAP=16)
    rh["LOSS_WEIGHTS"].update(RCNN_REG_WEIGHT=0.5, CODE_WEIGHT=[1.0] * 8)
    return cfg


def test_vote_targets_yaw(model):
    rs = np.random.RandomState(4)
    G, N = 7, 400
    boxes = np.concatenate([rs.rand(G, 3) * 1.5, rs.rand(G, 3) + 0.4,
                            rs.rand(G, 1) * 2 * np.pi], 1).astype(np.float32)
    boxes[2] = boxes[1]                          # nested, duplicate boxes
    boxes[3, :3] = boxes[1, :3]
    gvalid = np.arange(G) != 5
    pts = (rs.rand(N, 3) * 2 - 0.2).astype(np.float32)
    pvalid = rs.rand(N) < 0.9
    vt, vm = model["pm"].dense_head._vote_targets_yaw(
        _t(pts), _t(pvalid), _t(boxes), _t(gvalid))
    jvt, jvm = jax.jit(model["jm"].dense_head._vote_targets_yaw)(
        *map(jnp.asarray, (pts, pvalid, boxes, gvalid)))
    np.testing.assert_array_equal(vm.numpy(), np.asarray(jvm))
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), atol=1e-6)
    assert vm.sum() > 50 and vt.shape == (N, 9)
    # some voxels lie in three boxes and fill all three slots
    assert bool((vt[:, 3:6] != vt[:, 6:9]).any(1).any())


def test_roi_canonical_targets_and_decode(model):
    """The RoI head's GT-to-roi transform (through the JAX package's own
    ``forward_train`` with its sampling, pooling and MLP stubbed) and its
    decode, with headings of both signs, past 2 pi and opposite the
    roi's."""
    rs = np.random.RandomState(5)
    R = 40
    rois = _random_boxes(rs, R)
    gt = _random_boxes(rs, R)
    gt[:10, 6] = rois[:10, 6] + np.pi + rs.randn(10) * 0.3   # opposite
    gt[10:14, 6] = rois[10:14, 6] + np.pi / 2                # boundary
    jroi = model["jm"].roi_head
    zeros = jnp.zeros((R, 8))
    stub = dict(rois=jnp.asarray(rois), gt_of_rois=jnp.asarray(gt),
                reg_valid_mask=jnp.ones(R, jnp.int32),
                roi_labels=jnp.zeros(R, jnp.int32),
                roi_scores=jnp.zeros(R))
    saved = dict(jroi.__dict__)
    jroi.proposal_target_layer = lambda *a, **k: stub
    jroi.roi_grid_pool = lambda *a, **k: zeros
    jroi.reg_branch = lambda *a, **k: zeros
    try:
        jout = jax.jit(lambda r: jroi.forward_train(
            {}, {}, JCtx(train=True, rng=jax.random.PRNGKey(0)), None, r,
            *([None] * 6)))(jnp.asarray(rois))
    finally:
        jroi.__dict__.clear()
        jroi.__dict__.update(saved)
    roi = model["pm"].roi_head
    got = roi.canonical_targets(_t(gt), _t(rois))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout["gt_of_rois"]),
                               rtol=1e-6, atol=2e-6)
    assert float(got[:, 6].abs().max()) <= np.pi / 2 + 1e-6
    codes = (rs.randn(R, 8) * 0.4).astype(np.float32)
    codes[:3] = 0.0
    dec = roi.decode_boxes(_t(rois), _t(codes))
    jdec = _jit(jroi.decode_boxes, rois, codes)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=1e-6,
                               atol=2e-6)


# ------------------------------------------------------- tiny yaw model
def _scene(seed):
    b = synthetic_batch(np.random.RandomState(seed), batch_size=1,
                        n_points=1200, point_cap=1200, room=(3.0, 3.0, 2.5),
                        n_objects=4, n_classes=N_CLS, yaw=True)
    return {k: v[0] for k, v in b.items()}


def _backbone(model, train):
    """The port's backbone output of a headed scene (the backbone is
    shared with ScanNet and held to the JAX package there), as both
    packages' sparse tensors."""
    key = ("bb", train)
    if key not in model["cache"]:
        pm, sc = model["pm"], _scene(0)
        with torch.no_grad():
            st, origin, pts = pm._voxelize_scene(
                _t(sc["points"]), _t(sc["points_valid"]), {})
            P, S = dict(pm.named_parameters()), dict(pm.named_buffers())
            out = pm.backbone_3d(P, S, Ctx(train=train), st)
        jst = JST(jnp.asarray(out.coords.numpy()),
                  jnp.asarray(out.feats.numpy()),
                  jnp.asarray(out.valid.numpy()), out.stride)
        model["cache"][key] = (out, jst, origin.numpy(), sc)
    return model["cache"][key]


def _grid_cells_apart(model, rois_pc):
    """Rotated RoI grid points that floor into different lattice cells in
    the two packages (the JAX grid from its own functions, jitted):
    (count, bool[R] rois touched)."""
    roi, jroi = model["pm"].roi_head, model["jm"].roi_head
    g3 = roi.grid_size ** 3
    cell = roi.voxel_size * roi.coord_key

    @jax.jit
    def jgrid(r):
        local = jgeo.rotate_points_along_z(jroi.get_dense_grid_points(r),
                                           r[:, 6])
        return jnp.floor((local + r[:, None, :3]) / cell)

    jlat = np.asarray(jgrid(jnp.asarray(rois_pc))).reshape(-1, 3)
    plat = roi.grid_lattice(_t(rois_pc)).numpy()
    apart = (jlat != plat).any(-1).reshape(-1, g3)
    return int(apart.sum()), apart.any(1)


def test_tiny_yaw_eval_stages(model):
    """Head, proposals, RoI head and the final boxes: each stage on the
    JAX package's output of the stage before."""
    pm, jm, P, S = (model[k] for k in ("pm", "jm", "P", "S"))
    st, jst, origin, sc = _backbone(model, train=False)
    thr = 0.05

    @jax.jit
    def jstages(P, feats):
        st_ = jst.with_feats(feats)
        out = jm.dense_head.forward(P, S, JCtx(train=False), st_,
                                    jnp.float32(thr))
        b, s, lab, v = jm.dense_head.get_bboxes(out)
        ref = jm.roi_head.forward_test(P, S, JCtx(train=False), st_, b, s,
                                       lab.astype(jnp.int32), v)
        dec = jm.roi_head.decode_boxes(b.at[:, 6].multiply(-1),
                                       ref["rcnn_reg"])
        return out, (b, s, lab, v), ref, dec

    jout, props, ref, jdec = jstages(P, jst.feats)
    with torch.no_grad():
        out = pm.dense_head(dict(pm.named_parameters()),
                            dict(pm.named_buffers()), Ctx(), st, thr)
    assert set(out) == set(jout)
    for k, v in out.items():
        r = np.asarray(jout[k])
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(v.numpy(), r, err_msg=k)
        else:
            assert _rel(v.numpy(), r) < 2e-2, k
    assert out["voxel_offsets"].shape[-1] == 9
    assert out["bbox_preds"].shape[-1] == 8

    head = {k: _t(v) for k, v in jout.items()}
    b, s, lab, v = pm.dense_head.get_bboxes(head)
    np.testing.assert_array_equal(v.numpy(), np.asarray(props[3]))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(props[2]))
    assert int(v.sum()) > 4
    np.testing.assert_allclose(b.numpy(), np.asarray(props[0]), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(props[1]), atol=1e-5)
    assert float(np.abs(np.asarray(props[0])[:, 6]).max()) > 0.1

    rois_pc = np.asarray(props[0]).copy()
    rois_pc[:, 6] *= -1
    n_apart, touched = _grid_cells_apart(model, rois_pc)
    print(f"RoI grid points in different lattice cells: {n_apart} "
          f"(rois touched: {int(touched.sum())} of {len(touched)})")
    with torch.no_grad():
        got = pm.roi_head(dict(pm.named_parameters()),
                          dict(pm.named_buffers()), Ctx(), st,
                          *(_t(x) for x in props))
    # every roi that no differing cell touches: its regression and its
    # decoded box (the roi's output before the final NMS)
    keep = ~touched & np.asarray(props[3])
    assert keep.sum() > 4
    assert _rel(got["rcnn_reg"].numpy()[keep],
                np.asarray(ref["rcnn_reg"])[keep]) < 2e-2
    dec = pm.roi_head.decode_boxes(_t(rois_pc), got["rcnn_reg"]).numpy()
    np.testing.assert_allclose(dec[keep], np.asarray(jdec)[keep], atol=1e-4)
    # the final NMS mixes the rois: its outputs when none is touched
    if n_apart == 0:
        for k in ("batch_pred_valid", "batch_cls_preds"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        for k in ("batch_box_preds", "batch_score_preds"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       atol=1e-4)
    assert int(got["batch_pred_valid"].sum()) > 0
    assert np.isfinite(got["batch_box_preds"].numpy()).all()
