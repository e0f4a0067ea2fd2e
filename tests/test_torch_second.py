"""PyTorch port vs the JAX package: SECOND (MeanVFE, VoxelBackBone8x,
HeightCompression, BaseBEVBackbone, AnchorHeadSingle) at tiny widths
(``tests/test_outdoor.py::second_cfg``), stage by stage on identical
parameters and inputs, at the default key bits and at KITTI's range and
voxel size, where the lattice packs at (11, 11, 8).

Each stage is fed the JAX output of the stage before, so a discrete step
(capacity, top-k, NMS) sees identical inputs; the JAX side runs eagerly.
Tolerances: coordinates, masks, labels and the NMS keep mask exact; VFE
means within 8 ulp of the column's running total (the JAX package takes
each voxel's sum as a difference of f32 prefix sums over all points, so
its error grows with the scene; the port sums each voxel's points alone);
sparse-conv features within 2e-2 of the reference's max magnitude (the
port's K1 rounds rows and weights to bf16 for the strided convs too, where
the JAX package's CPU ``scan_conv`` multiplies in f32; the submanifold
convs are bf16 on both sides); the f32 dense 2-D convs, head outputs and
decoded boxes within 1e-4 relative.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.core import hashing as jhash
from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.core.nms import greedy_nms as jgreedy
from cagroup3d_tpu.core.sparse_conv import scan_conv
from cagroup3d_tpu.core.voxelize import arrival_rank as jarrival
from cagroup3d_tpu.core.voxelize import spconv_reduce_lat as jreduce
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu.models.backbones_2d.base_bev_backbone import \
    _conv2d as jconv2d, _deconv2d as jdeconv2d
from cagroup3d_tpu_torch.core import hashing
from cagroup3d_tpu_torch.core.module import Ctx
from cagroup3d_tpu_torch.core.nms import greedy_nms, overlap_matrix
from cagroup3d_tpu_torch.core.sparse import SparseTensor
from cagroup3d_tpu_torch.core.voxelize import arrival_rank, spconv_reduce_lat
from cagroup3d_tpu_torch.models import build_network
from cagroup3d_tpu_torch.models.backbones_2d.base_bev_backbone import (
    conv2d_same, conv_transpose2d_same)
from cagroup3d_tpu_torch.models.backbones_3d.spconv_backbone import \
    spconv_down
from cagroup3d_tpu_torch.ops.sparse_conv import sources_sorted
from test_outdoor import outdoor_batch, second_cfg

torch.set_num_threads(1)

KITTI_RANGE = [0.0, -40.0, -3.0, 70.4, 40.0, 1.0]
KITTI_VOXEL = [0.05, 0.05, 0.1]
DEFAULT_BITS = (10, 10, 10)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _pst(jst):
    return SparseTensor(_t(jst.coords), _t(jst.feats), _t(jst.valid), 1)


def _same_st(p, j, tol):
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(p.coords.numpy(), np.asarray(j.coords))
    assert _rel(p.feats.numpy(), j.feats) < tol


@pytest.fixture
def bits():
    """Both packages' key bits at the defaults during the test and restored
    after it: another test file on this worker may have widened the JAX
    package's (its SECONDNet widens them for good)."""
    old = (jhash.XBITS, jhash.YBITS, jhash.ZBITS), hashing.key_bits()
    jhash.set_key_bits(*DEFAULT_BITS)
    hashing.set_key_bits(*DEFAULT_BITS)
    yield
    jhash.set_key_bits(*old[0])
    hashing.set_key_bits(*old[1])


def _cfg(kitti: bool):
    c = second_cfg()
    if kitti:
        c.POINT_CLOUD_RANGE = KITTI_RANGE
        c.VOXEL_SIZE = KITTI_VOXEL
    return c


@pytest.fixture(scope="module")
def models():
    """Per grid: the JAX model, params, state, the port model with the same
    parameters, and the JAX bits the JAX model packs at."""
    out = {}
    for kitti in (False, True):
        prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
        jhash.set_key_bits(*DEFAULT_BITS)
        jm = jbuild(_cfg(kitti), num_class=2)
        jbits = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
        jhash.set_key_bits(*prev)
        P, S = jax.jit(jm.init)(jax.random.PRNGKey(0))
        P = dict(P)
        # BN statistics off their init, so eval BN is not the identity
        rs = np.random.RandomState(1)
        S = {k: (np.abs(rs.randn(*np.shape(v))) + 0.5 if k.endswith("var")
                 else rs.randn(*np.shape(v)) * 0.1).astype(np.float32)
             for k, v in S.items()}
        pm = build_network(_cfg(kitti), num_class=2, device="cpu")
        pm.load_jax_params({k: np.asarray(v) for k, v in P.items()}, S)
        out[kitti] = (jm, P, {k: jnp.asarray(v) for k, v in S.items()}, pm,
                      jbits)
    return out


def _jax_at(bits_, fn, *a, **kw):
    prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jhash.set_key_bits(*bits_)
    try:
        return fn(*a, **kw)
    finally:
        jhash.set_key_bits(*prev)


@pytest.mark.parametrize("kitti", [False, True], ids=["default", "kitti"])
def test_second_stages(models, bits, kitti):
    jm, P, S, pm, jbits = models[kitti]
    assert pm.key_bits == jbits == ((11, 11, 8) if kitti else DEFAULT_BITS)
    assert list(pm.grid_size) == list(jm.grid_size)
    assert pm.final_grid() == tuple(int(e) for e in jm._final_grid())
    b = outdoor_batch(np.random.RandomState(0), B=1)
    pts, pv = np.array(b["points"][0]), np.array(b["points_valid"][0])
    pts[::7, 3] = pts[::7, 3] * 3           # intensities in the means
    PP = {k: v.detach() for k, v in pm.named_parameters()}
    SS = dict(pm.named_buffers())
    # the JAX stages jitted; the voxel size and range go in as arguments,
    # so the division that floors points into voxels stays an IEEE division
    # (closed over, XLA may multiply by the reciprocal, and the eager
    # semantics the port follows is the division's)
    jvfe = jax.jit(lambda p, v, vs, lo: jm.vfe(P, S, JCtx(), p, v, vs, lo,
                                               jm.input_cap))
    jbb_fn = jax.jit(lambda st: jm.backbone_3d(P, S, JCtx(), st))

    with hashing.key_bits_scope(pm.key_bits):
        # VFE (arrival-capped means), exact lattice
        jst = _jax_at(jbits, jvfe, jnp.asarray(pts), jnp.asarray(pv),
                      jnp.asarray(jm.voxel_size, jnp.float32),
                      jnp.asarray(jm.point_cloud_range, jnp.float32))
        st = pm.vfe(Ctx(), _t(pts), _t(pv), pm.voxel_size,
                    pm.point_cloud_range, pm.input_cap)
        np.testing.assert_array_equal(st.valid.numpy(), np.asarray(jst.valid))
        np.testing.assert_array_equal(st.coords.numpy(),
                                      np.asarray(jst.coords))
        total = np.abs(pts[pv]).sum(0)
        assert (np.abs(st.feats.numpy() - np.asarray(jst.feats))
                <= 8 * 2.0 ** -24 * total).all()
        assert sources_sorted(st.coords[None], st.valid[None])
        # backbone fed the JAX voxels: every level's lattice exact
        jbb = _jax_at(jbits, jbb_fn, jst)
        bb = pm.backbone_3d(PP, SS, Ctx(), _pst(jst))
        for k in ("x_conv1", "x_conv2", "x_conv3", "x_conv4"):
            _same_st(bb["multi_scale_3d_features"][k],
                     jbb["multi_scale_3d_features"][k], 2e-2)
        _same_st(bb["encoded_spconv_tensor"], jbb["encoded_spconv_tensor"],
                 2e-2)
        assert int(jbb["encoded_spconv_tensor"].valid.sum()) > 0
    jctx = JCtx(train=False)
    # HeightCompression, z-major channels, on the JAX level
    grid = jm._final_grid()
    jbev = jm.map_to_bev_module(P, S, jctx, jbb["encoded_spconv_tensor"],
                                grid)
    bev = pm.map_to_bev_module(_pst(jbb["encoded_spconv_tensor"]), grid)
    np.testing.assert_array_equal(bev.permute(1, 2, 0).numpy(),
                                  np.asarray(jbev))
    # 2-D backbone (SAME stride-2 convs, transposed-conv deblock)
    jbev2 = jm.backbone_2d(P, S, jctx, jbev)
    bev2 = pm.backbone_2d(PP, SS, _t(jbev).permute(2, 0, 1))
    assert _rel(bev2.permute(1, 2, 0).numpy(), jbev2) < 1e-4
    # head on the JAX map
    jout = jm.dense_head.forward(P, S, jctx, jbev2)
    out = pm.dense_head(PP, _t(jbev2).permute(2, 0, 1))
    for k in ("cls_preds", "box_preds", "dir_cls_preds"):
        assert _rel(out[k].numpy(), jout[k]) < 1e-4, k
    np.testing.assert_array_equal(pm.dense_head.anchors_np,
                                  jm.dense_head.anchors_np)
    # decode and NMS on the JAX head outputs, class prior lifted so the
    # candidates pass the score threshold
    jout = dict(jout, cls_preds=jout["cls_preds"] + 4.6)
    tout = {k: _t(v) for k, v in jout.items()}
    jboxes, jscores = jm.dense_head.decoded_boxes(jout)
    boxes, scores = pm.dense_head.decoded_boxes(tout)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-6, atol=1e-6)
    jres = jax.jit(jm.dense_head.generate_predicted_boxes)(jout)
    res = pm.dense_head.generate_predicted_boxes(tout)
    np.testing.assert_array_equal(res[3].numpy(), np.asarray(jres[3]))
    assert int(res[3].sum()) > 0
    np.testing.assert_array_equal(res[2].numpy(), np.asarray(jres[2]))
    np.testing.assert_allclose(res[0].numpy(), np.asarray(jres[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[1].numpy(), np.asarray(jres[1]),
                               rtol=1e-6, atol=1e-6)


def test_second_forward_eval(models, bits):
    """The whole eval forward at KITTI's grid, B = 2 with the same scene
    twice: finite, padded to MAX_OUT, the two scenes the same bits, the
    dropped voxels counted per scene, and the default bits back
    afterwards."""
    pm = models[True][3]
    b = outdoor_batch(np.random.RandomState(2), B=1)
    batch = {k: _t(b[k]).expand(2, *b[k].shape[1:])
             for k in ("points", "points_valid")}
    out = pm.forward_eval(batch)
    assert hashing.key_bits() == DEFAULT_BITS
    assert out["pred_boxes"].shape == (2, 64, 7)
    assert torch.isfinite(out["pred_boxes"]).all()
    assert out["overflow"].shape == (2,)
    for k, v in out.items():
        assert torch.equal(v[0], v[1]), k


def test_arrival_rank_and_reduce_lat(bits):
    """arrival_rank exact; spconv_reduce_lat's lattice exact (sorted,
    invalid last) for random inputs over (k, s, p) combos, with the
    top-edge clamp and without it, at both key splits."""
    rs = np.random.RandomState(3)
    lat = rs.randint(0, 6, (400, 3)).astype(np.int32)
    valid = rs.rand(400) > 0.2
    np.testing.assert_array_equal(
        arrival_rank(_t(lat), _t(valid)).numpy(),
        np.asarray(jarrival(jnp.asarray(lat), jnp.asarray(valid))))
    for split in (DEFAULT_BITS, (11, 11, 8)):
        # one jit per split: the packing reads the bits at trace time
        jfn = jax.jit(lambda *a, **kw: jreduce(*a, **kw),
                      static_argnums=(2, 3, 4, 5),
                      static_argnames=("in_extent",))
        for X, k, s, p in [(9, 3, 2, 1), (9, 2, 2, 0),
                           (9, (1, 1, 3), (1, 1, 2), 0),
                           (41, 3, 2, (1, 1, 0))]:
            if split == DEFAULT_BITS and X != 9:
                continue
            n = 40
            lat = rs.randint(0, X, (n, 3)).astype(np.int32)
            lat[0] = X - 1                               # the top edge
            ok = rs.rand(n) > 0.1
            for ext in ((X, X, X), None) if k == 3 else ((X, X, X),):
                jl, jv = _jax_at(split, jfn, jnp.asarray(lat),
                                 jnp.asarray(ok), k, s, p, 128,
                                 in_extent=ext)
                with hashing.key_bits_scope(split):
                    pl, pv = spconv_reduce_lat(_t(lat), _t(ok), k, s, p,
                                               128, in_extent=ext)
                    assert sources_sorted(pl[None], pv[None])
                np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
                np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("split", [DEFAULT_BITS, (11, 11, 8)])
def test_strided_conv_matches_scan_conv(bits, split):
    """The strided conv through K1's at-coords form (queries o*s - p + 1,
    centred offsets) against the JAX ``scan_conv`` (offsets 0..2 at
    o*s - p), for pads 1 and (1, 1, 0)."""
    rs = np.random.RandomState(4)
    X = (60, 50, 41)
    lat = np.unique(np.stack([rs.randint(0, e, 600) for e in X], -1), axis=0)
    lat[-1] = [e - 1 for e in X]
    n = len(lat)
    feats = rs.randn(n, 16).astype(np.float32)
    w = (rs.randn(27, 16, 32) * 0.1).astype(np.float32)
    for pad in (1, (1, 1, 0)):
        with hashing.key_bits_scope(split):
            from cagroup3d_tpu_torch.core.voxelize import unique_voxels
            st, _ = unique_voxels(_t(lat), _t(feats), torch.ones(n, dtype=
                                  torch.bool), 1024, mode="first")
            out = spconv_down({"c.kernel": _t(w)}, Ctx(), "c", st, pad, 512,
                              in_extent=X)
        pp = np.broadcast_to(np.asarray(pad), (3,))
        offs = np.array([[a, b, c] for a in range(3) for b in range(3)
                         for c in range(3)], np.int32)
        jf = _jax_at(split, scan_conv, jnp.asarray(st.coords.numpy()),
                     jnp.asarray(st.valid.numpy()),
                     jnp.asarray(st.feats.numpy()), 1,
                     jnp.asarray(out.coords.numpy() * 2 - pp),
                     jnp.asarray(out.valid.numpy()), offs, jnp.asarray(w))
        assert int(out.valid.sum()) > 0
        assert _rel(out.feats.numpy(), jf) < 2e-2


def test_bev_convs_same_padding_and_transpose():
    """SAME stride-2 convs on even and odd maps and the transposed conv
    (asymmetric kernels, k = 2 and 3) against jax.lax."""
    rs = np.random.RandomState(5)
    for H, W in ((10, 8), (9, 7)):
        x = rs.randn(H, W, 6).astype(np.float32)
        for k, s in ((3, 1), (3, 2), (1, 1)):
            w = rs.randn(k, k, 6, 5).astype(np.float32)
            got = conv2d_same(_t(x).permute(2, 0, 1), _t(w), s)
            ref = jconv2d(jnp.asarray(x), jnp.asarray(w), s)
            assert _rel(got.permute(1, 2, 0).numpy(), ref) < 1e-5
        for k, s in ((2, 2), (3, 2), (4, 2), (1, 1)):
            w = rs.randn(k, k, 6, 5).astype(np.float32)
            got = conv_transpose2d_same(_t(x).permute(2, 0, 1), _t(w), s)
            ref = jdeconv2d(jnp.asarray(x), jnp.asarray(w), s)
            assert got.shape[1:] == ref.shape[:2]
            assert _rel(got.permute(1, 2, 0).numpy(), ref) < 1e-5


def test_nms_blocks_and_keep():
    """The row-blocked overlap matrix equals the whole one bit for bit, and
    the rotated greedy keep mask equals the JAX package's on the same
    boxes."""
    rs = np.random.RandomState(6)
    n = 160
    boxes = np.concatenate([rs.rand(n, 2) * 12, rs.rand(n, 1),
                            rs.rand(n, 3) * 3 + 0.5,
                            rs.rand(n, 1) * 6 - 3], 1).astype(np.float32)
    scores = rs.rand(n).astype(np.float32)
    valid = rs.rand(n) > 0.1
    tb = _t(boxes)
    whole = overlap_matrix(tb, 0.01, True, block_pairs=n * n)
    for bp in (n, 7 * n + 3, 50 * n):
        assert torch.equal(overlap_matrix(tb, 0.01, True, block_pairs=bp),
                           whole)
    for thr in (0.01, 0.3):
        keep = greedy_nms(tb, _t(scores), _t(valid), thr, rotated=True)
        jkeep = jax.jit(jgreedy, static_argnums=(3, 4))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr,
            True)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


def test_params_match_jax_init_names_and_shapes(bits):
    """``build_network`` of the YAML's SECOND (KITTI dataset config) has the
    JAX init's parameter and state names and shapes (``jax.eval_shape``),
    and reads the range, voxel size and points per voxel from the dataset
    config."""
    from cagroup3d_tpu.config import cfg_from_yaml_file as jload
    from cagroup3d_tpu.config import EasyDict as JEasyDict
    from cagroup3d_tpu_torch.models import load_config
    from cagroup3d_tpu_torch.models.detectors.detector3d_template import \
        dataset_meta
    cfg = load_config("tools/cfgs/kitti_models/second.yaml")
    jcfg = jload("tools/cfgs/kitti_models/second.yaml", JEasyDict())
    pm = build_network(cfg.MODEL, 3, device="cpu",
                       dataset=dataset_meta(cfg.DATA_CONFIG,
                                            cfg.CLASS_NAMES))

    class _DS:
        point_cloud_range = np.asarray(jcfg.DATA_CONFIG.POINT_CLOUD_RANGE)
        dataset_cfg = jcfg.DATA_CONFIG
        class_names = jcfg.CLASS_NAMES

    prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jm = jbuild(jcfg.MODEL, 3, dataset=_DS())
    jhash.set_key_bits(*prev)
    jP, jS = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    mine_p = {k: tuple(v.shape) for k, v in pm.named_parameters()}
    mine_s = {k: tuple(v.shape) for k, v in pm.named_buffers()}
    assert mine_p == {k: tuple(v.shape) for k, v in jP.items()}
    assert mine_s == {k: tuple(v.shape) for k, v in jS.items()}
    assert pm.grid_size == [1408, 1600, 40] and pm.key_bits == (11, 11, 8)
    assert pm.vfe.max_points == jm.vfe.max_points == 5
    assert pm.backbone_3d.extents == {k: tuple(int(x) for x in v) for k, v
                                      in jm.backbone_3d.extents.items()}
    assert pm.final_grid() == (176, 200, 2)
    assert pm.dense_head.anchors_np.shape == (211200, 7)
    assert (pm.dense_head.nms_pre, pm.dense_head.max_out) == (1024, 512)
    assert math.isclose(pm.dense_head.score_thresh, 0.1)
    assert hashing.key_bits() == DEFAULT_BITS


def test_cagroup3d_after_second_keeps_default_bits(bits):
    """A CAGroup3D built (and run) after a SECOND in the same process packs
    keys at 10/10/10: the SECOND holds its bits and sets them only around
    its own forward."""
    import __graft_entry__
    from cagroup3d_tpu.utils.synthetic import synthetic_batch
    sm = build_network(_cfg(True), num_class=2, device="cpu")
    b = outdoor_batch(np.random.RandomState(0), B=1)
    sm.forward_eval({k: _t(b[k]) for k in ("points", "points_valid")})
    assert hashing.key_bits() == DEFAULT_BITS
    jm = __graft_entry__._build_model(tiny=True)
    cm = build_network(jm.model_cfg, num_class=18, device="cpu")
    assert hashing.key_bits() == DEFAULT_BITS
    sb = synthetic_batch(np.random.RandomState(0), batch_size=1,
                         n_points=500, point_cap=512, room=(3.0, 3.0, 2.5),
                         n_objects=2)
    out = cm.forward_eval({k: _t(sb[k]) for k in ("points",
                                                  "points_valid")})
    assert torch.isfinite(out["pred_boxes"]).all()
    assert hashing.key_bits() == DEFAULT_BITS
    assert hashing.key_extents() == (1024, 1024, 1024)
