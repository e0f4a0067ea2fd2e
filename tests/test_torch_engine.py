"""PyTorch port vs the JAX package: the sparse engine's eval pieces on the
same seeded inputs (hashing, voxelization, paired head maps, kernel maps,
gather-GEMMs, pooling, geometry, NMS, batch norm, box decoding).

Coordinates, masks, counts, inverse maps and neighbour tables are exact;
features are within 1e-2 of the reference's max magnitude (bf16 rows and
sums in another order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.core import geometry as jgeo
from cagroup3d_tpu.core import hashing as jhash
from cagroup3d_tpu.core import kernel_maps as jkm
from cagroup3d_tpu.core import nms as jnms
from cagroup3d_tpu.core import pooling as jpool
from cagroup3d_tpu.core import sparse_conv as jconv
from cagroup3d_tpu.core import voxelize as jvox
from cagroup3d_tpu.core.norm import masked_batch_norm as j_bn
from cagroup3d_tpu.core.sparse import SparseTensor as JST
from cagroup3d_tpu.models.model_utils.cagroup_utils import \
    CAGroupResidualCoder as JCoder
from cagroup3d_tpu_torch.core import geometry, hashing, kernel_maps, nms
from cagroup3d_tpu_torch.core import pooling, sparse_conv, voxelize
from cagroup3d_tpu_torch.core.norm import masked_batch_norm
from cagroup3d_tpu_torch.core.sparse import SparseTensor
from cagroup3d_tpu_torch.models.model_utils.cagroup_utils import \
    CAGroupResidualCoder

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jit(fn, *args):
    """Run a JAX reference jitted (one compile instead of one per op)."""
    return jax.jit(fn)(*args)


def _tables(seed, P=300, side=10, C=8, cap=256, stride=1):
    """A deduplicated (key-sorted) voxel table from the JAX voxelizer, as
    (jax SparseTensor, port SparseTensor)."""
    rs = np.random.RandomState(seed)
    lat = rs.randint(0, side, (P, 3)).astype(np.int32)
    feats = rs.randn(P, C).astype(np.float32)
    valid = rs.rand(P) < 0.9
    st, _ = _jit(lambda a, b, c: jvox.unique_voxels(a, b, c, cap), lat,
                 feats, valid)
    jst = JST(st.coords * stride, st.feats, st.valid, stride)
    return jst, SparseTensor(_t(jst.coords), _t(jst.feats), _t(jst.valid),
                             stride)


# ---------------------------------------------------------------- hashing
def test_pack_coords_and_index():
    rs = np.random.RandomState(0)
    lat = rs.randint(-12, 1030, (500, 3)).astype(np.int32)
    lat[:100] = rs.randint(0, 6, (100, 3))         # duplicates
    valid = rs.rand(500) < 0.8
    jk = jhash.pack_coords(jnp.asarray(lat), jnp.asarray(valid))
    _eq(hashing.pack_coords(_t(lat), _t(valid)), jk)
    sk, order = hashing.build_index(_t(lat), _t(valid))
    jsk, jorder = jhash.build_index(jnp.asarray(lat), jnp.asarray(valid))
    _eq(sk, jsk)
    _eq(order, jorder)
    q = rs.randint(-2, 8, (200, 3)).astype(np.int32)
    qv = rs.rand(200) < 0.9
    _eq(hashing.lookup(sk, order, _t(q), _t(qv)),
        jhash.lookup(jsk, jorder, jnp.asarray(q), jnp.asarray(qv),
                     method="searchsorted"))
    # lower_bound_pos on a lane-multiple table of sorted keys
    qk = jnp.asarray(rs.randint(0, 1 << 22, 64).astype(np.int32))
    _eq(hashing.lower_bound_pos(sk[:384].contiguous(), _t(qk)),
        jhash.lower_bound_pos(jsk[:384], qk))
    ok = sk.numpy() != hashing.INVALID_KEY
    _eq(hashing.unpack_keys(sk).numpy()[ok], lat[order.numpy()][ok])


def test_set_key_bits_round_trip():
    try:
        hashing.set_key_bits(11, 11, 8)
        jhash.set_key_bits(11, 11, 8)
        lat = np.random.RandomState(1).randint(0, 1500, (100, 3)).astype(
            np.int32)
        lat[:, 2] %= 200
        v = np.ones(100, bool)
        _eq(hashing.pack_coords(_t(lat), _t(v)),
            jhash.pack_coords(jnp.asarray(lat), jnp.asarray(v)))
        assert hashing.key_shifts() == jhash.key_shifts()
    finally:
        hashing.set_key_bits()
        jhash.set_key_bits()


# ---------------------------------------------------------- voxelization
@pytest.mark.parametrize("mode,cap", [("mean", 512), ("first", 512),
                                      ("mean", 64), ("first", 64)])
def test_unique_voxels(mode, cap):
    rs = np.random.RandomState(2)
    P = 700
    lat = rs.randint(0, 9, (P, 3)).astype(np.int32)
    feats = rs.randn(P, 5).astype(np.float32)
    valid = rs.rand(P) < 0.85
    stats = {}
    st, inv = voxelize.unique_voxels(_t(lat), _t(feats), _t(valid), cap,
                                     mode=mode, stats=stats)

    def ref(a, b, c):
        jstats = {}
        out = jvox.unique_voxels(a, b, c, cap, mode=mode, stats=jstats)
        return out, jstats

    (jst, jinv), jstats = _jit(ref, lat, feats, valid)
    _eq(st.coords, jst.coords)
    _eq(st.valid, jst.valid)
    _eq(inv, jinv)
    assert _rel(st.feats, jst.feats) < 1e-2
    assert int(stats["overflow/unique"]) == int(jstats["overflow/unique"])


def test_stride_reduce_coords():
    jst, st = _tables(3, P=400, side=16, cap=256, stride=2)
    out, inv = voxelize.stride_reduce_coords(st, 2, 128)
    jout, jinv = _jit(lambda t: jvox.stride_reduce_coords(t, 2, 128), jst)
    _eq(out.coords, jout.coords)
    _eq(out.valid, jout.valid)
    _eq(inv, jinv)
    assert out.stride == jout.stride == 4


@pytest.mark.parametrize("cap_fine,cap_coarse", [(64, 32), (512, 256)])
def test_paired_maps(cap_fine, cap_coarse):
    rs = np.random.RandomState(7)
    G, P, F = 3, 512, 16
    lat = rs.randint(-3, 14, (G, P, 3)).astype(np.int32)
    feats = rs.randn(P, F).astype(np.float32)
    sel = rs.rand(G, P) < 0.7
    sel[1] = False
    (fc, ff, fv), (cc, cf, cv), (of, oc) = \
        voxelize.unique_voxels_classes_paired(_t(lat), _t(feats), _t(sel),
                                              cap_fine, cap_coarse, 3)
    (jfc, jff, jfv), (jcc, jcf, jcv), (jof, joc) = \
        _jit(lambda a, b, c: jvox.unique_voxels_classes_paired(
            a, b, c, cap_fine, cap_coarse, 3, return_stats=True),
            lat, feats, sel)
    for a, b in ((fc, jfc), (fv, jfv), (cc, jcc), (cv, jcv), (of, jof),
                 (oc, joc)):
        _eq(a, b)
    assert _rel(ff, jff) < 1e-2
    assert _rel(cf, jcf) < 1e-2


def test_count_sorted_and_window():
    u = np.sort(np.random.RandomState(4).randint(0, 40, (2, 256)),
                axis=1).astype(np.int32)
    for strict in (True, False):
        _eq(voxelize._count_sorted(_t(u), 50, strict),
            jvox._count_sorted(jnp.asarray(u), 50, strict))
    _eq(voxelize._window_ranks(torch.tensor([5, 300]), 64),
        jvox._window_ranks(jnp.asarray([5, 300]), 64, None))


# ------------------------------------------------------------ kernel maps
@pytest.mark.parametrize("kind", ["conv_k3", "conv_k2", "transpose_k2",
                                  "grouped_k3", "grouped_k5"])
def test_neighbor_tables(kind):
    jst, st = _tables(5, P=300, side=12, cap=256, stride=2)
    tgt = np.asarray(jst.coords)
    tv = np.asarray(jst.valid)
    if kind.startswith("grouped"):
        k = int(kind[-1])
        got = kernel_maps.neighbor_table_grouped(st, _t(tgt), _t(tv), k)
        ref = _jit(lambda t, a, b: jkm.neighbor_table_grouped(t, a, b, k),
                   jst, tgt, tv)
    else:
        k = int(kind[-1])
        offs = (kernel_maps.conv_offsets(k, 2) if kind.startswith("conv")
                else kernel_maps.transpose_offsets(k, 1))
        _eq(offs, jkm.conv_offsets(k, 2) if kind.startswith("conv")
            else jkm.transpose_offsets(k, 1))
        got = kernel_maps.neighbor_table(st, _t(tgt), _t(tv), offs)
        ref = _jit(lambda t, a, b: jkm.neighbor_table(t, a, b, offs), jst,
                   tgt, tv)
    _eq(got, ref)


def test_gather_gemm():
    jst, st = _tables(6, P=300, side=10, C=16, cap=256)
    offs = kernel_maps.conv_offsets(3, 1)
    nbr = kernel_maps.neighbor_table(st, st.coords, st.valid, offs)
    w = np.random.RandomState(0).randn(27, 16, 8).astype(np.float32)
    b = np.random.RandomState(1).randn(8).astype(np.float32)
    got = sparse_conv.gather_gemm(st.masked_feats(), nbr, _t(w), _t(b))
    ref = _jit(lambda f, n, ww, bb: jconv.gather_gemm(
        f, n, ww, bb, compute_dtype=jnp.bfloat16), jst.masked_feats(),
        nbr.numpy(), w, b)
    assert _rel(got, ref) < 1e-2


def test_generative_up_classes():
    rs = np.random.RandomState(8)
    G, P, C = 2, 400, 8
    lat = rs.randint(0, 12, (G, P, 3)).astype(np.int32)
    feats = rs.randn(P, C).astype(np.float32)
    sel = rs.rand(G, P) < 0.8
    (fc, _, fv), (cc, cf, cv), _ = _jit(
        lambda a, b, c: jvox.unique_voxels_classes_paired(
            a, b, c, 256, 128, 3, return_stats=True), lat, feats, sel)
    w = rs.randn(G, 27, C, 6).astype(np.float32)
    got = sparse_conv.generative_up_classes(_t(cc * 3), _t(cv), _t(cf), 3,
                                            _t(fc), _t(fv), _t(w))
    ref = _jit(lambda *a: jconv.generative_up_classes(
        a[0], a[1], a[2], 3, a[3], a[4], a[5]), cc * 3, cv, cf, fc, fv, w)
    assert _rel(got, ref) < 1e-2
    assert (got.numpy()[~np.asarray(fv)] == 0).all()


# ---------------------------------------------------------------- pooling
@pytest.mark.parametrize("k,s", [(5, 2), (9, 4)])
def test_avg_pool(k, s):
    jst, st = _tables(9, P=500, side=20, C=6, cap=512, stride=2)
    out = pooling.avg_pool(st, k, s, 128)
    jout = _jit(lambda t: jpool.avg_pool(t, k, s, 128), jst)
    _eq(out.coords, jout.coords)
    _eq(out.valid, jout.valid)
    assert out.stride == jout.stride
    assert _rel(out.feats, jout.feats) < 1e-5


@pytest.mark.parametrize("k,s,out_cap", [(5, 2, 1024), (9, 4, 512),
                                         (17, 8, 256), (33, 16, 128)])
def test_avg_pool_dappm_shapes(k, s, out_cap):
    """The DAPPM pools at their largest tables (2048 source rows, the
    JAX package's membership matmul): values and the VJP w.r.t. the
    source features (the fixed-order segment sum is differentiable)."""
    jst, st = _tables(11, P=2600, side=48, C=16, cap=2048, stride=4)
    feats = st.feats.clone().requires_grad_(True)
    out = pooling.avg_pool(st.with_feats(feats), k, s, out_cap)
    jout, vjp = jax.vjp(lambda f: jpool.avg_pool(jst.with_feats(f), k, s,
                                                 out_cap).feats, jst.feats)
    _eq(out.coords, jpool.avg_pool(jst, k, s, out_cap).coords)
    assert int(out.valid.sum()) > out_cap // 8
    assert _rel(out.feats.detach(), jout) < 1e-5
    cot = np.random.RandomState(s).randn(*jout.shape).astype(np.float32)
    out.feats.backward(_t(cot))
    assert _rel(feats.grad, vjp(jnp.asarray(cot))[0]) < 1e-5


def test_interpolate_at():
    jst, st = _tables(10, P=400, side=10, C=6, cap=512, stride=4)
    rs = np.random.RandomState(11)
    q = (rs.rand(300, 3) * 40).astype(np.float32)
    qv = rs.rand(300) < 0.9
    got = pooling.interpolate_at(st, _t(q), _t(qv))
    ref = _jit(jpool.interpolate_at, jst, q, qv)
    assert _rel(got, ref) < 1e-5


# ------------------------------------------------------ geometry and NMS
def _boxes(rs, n):
    b = np.concatenate([rs.rand(n, 3) * 4, rs.rand(n, 3) * 1.5 + 0.1,
                        (rs.rand(n, 1) - 0.5) * 3], 1)
    return b.astype(np.float32)


def test_geometry():
    rs = np.random.RandomState(12)
    a, b = _boxes(rs, 40), _boxes(rs, 30)
    pts = rs.randn(5, 20, 4).astype(np.float32)
    ang = rs.randn(5).astype(np.float32)
    np.testing.assert_allclose(
        geometry.rotate_points_along_z(_t(pts), _t(ang)).numpy(),
        np.asarray(jgeo.rotate_points_along_z(jnp.asarray(pts),
                                              jnp.asarray(ang))), atol=1e-5)
    for mine, ref in ((geometry.iou_bev_aligned, jgeo.iou_bev_aligned),
                      (geometry.iou3d_aligned, jgeo.iou3d_aligned),
                      (geometry.z_overlap, jgeo._z_overlap)):
        np.testing.assert_allclose(
            geometry.pairwise(mine, _t(a), _t(b)).numpy(),
            np.asarray(jgeo.pairwise(ref, jnp.asarray(a), jnp.asarray(b))),
            atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_multiclass_nms(seed):
    rs = np.random.RandomState(seed)
    P, C = 200, 5
    boxes = _boxes(rs, P)
    boxes[:, 6] = 0
    scores = rs.rand(P, C).astype(np.float32)
    scores[:, 1] = np.round(scores[:, 1], 1)             # score ties
    valid = rs.rand(P) < 0.9
    got = nms.multiclass_nms(_t(boxes), _t(scores), _t(valid), 0.2, 0.3,
                             per_cls_cap=32, out_cap=48)
    ref = _jit(lambda a, b, c: jnms.multiclass_nms(
        a, b, c, 0.2, 0.3, rotated=False, per_cls_cap=32, out_cap=48),
        boxes, scores, valid)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), atol=1e-6)


# ------------------------------------------------- batch norm and coder
def test_masked_batch_norm_and_decode():
    rs = np.random.RandomState(13)
    x = rs.randn(50, 7).astype(np.float32)
    m = rs.rand(50) < 0.7
    w, b = rs.randn(7).astype(np.float32), rs.randn(7).astype(np.float32)
    rm, rv = rs.randn(7).astype(np.float32), rs.rand(7).astype(np.float32)
    got = masked_batch_norm(_t(x), _t(m), _t(w), _t(b), _t(rm), _t(rv))
    ref, _ = j_bn(jnp.asarray(x), jnp.asarray(m), w, b, rm, rv, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    enc = (rs.randn(20, 6) * 0.3).astype(np.float32)
    anchors = _boxes(rs, 20)[:, :6]
    np.testing.assert_allclose(
        CAGroupResidualCoder().decode(_t(enc), _t(anchors)).numpy(),
        np.asarray(JCoder().decode(jnp.asarray(enc), jnp.asarray(anchors))),
        rtol=1e-5, atol=1e-5)
