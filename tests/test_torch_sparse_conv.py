"""K1 (sparse conv, ops/sparse_conv.py) against the JAX package: the plain
version that CPU tensors take against the Pallas kernel in interpret mode
(``subm_conv_classes_mxu``, ``conv_at_coords_mxu``) and against the XLA
reference (``scan_conv_grouped(_classes)``), at G <= 3, N = 256, C <= 64,
k in {3, 5}.  Bar: relative error < 2e-2 (bf16 rows and weights, f32
sums), invalid query rows exactly zero.

The CUDA kernel is compared with this plain version in
``test_torch_cuda.py`` (on a GPU) and by ``chip_smoke.py`` at the main
path's shapes.
"""
import numpy as np
import jax
import pytest
import torch

from cagroup3d_tpu.core.sparse_conv import (scan_conv_grouped,
                                            scan_conv_grouped_classes)
from cagroup3d_tpu.core.voxelize import unique_voxels, unique_voxels_classes
from cagroup3d_tpu.ops.pallas_conv import (conv_at_coords_mxu,
                                           subm_conv_classes_mxu)
from cagroup3d_tpu_torch.ops.sparse_conv import sources_sorted, sparse_conv

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _classes(seed, G=3, P=600, C=64, cap=256, side=14):
    """Key-sorted per-class tables (the layout the Pallas kernel needs)."""
    rs = np.random.RandomState(seed)
    lat = rs.randint(0, side, (G, P, 3)).astype(np.int32)
    feats = rs.randn(G, P, C).astype(np.float32)
    valid = rs.rand(G, P) > 0.2
    return jax.jit(lambda a, b, c: unique_voxels_classes(
        a, b, c, cap, mode="mean"))(lat, feats, valid)


@pytest.mark.parametrize("k,w_groups,stride", [(3, 0, 1), (5, 0, 1),
                                               (3, 1, 2), (5, 1, 1)])
def test_subm_classes(k, w_groups, stride):
    fc, ff, fv = _classes(0)
    G, C = ff.shape[0], ff.shape[2]
    Gw = w_groups or G
    w = np.random.RandomState(1).randn(Gw, k ** 3, C, 32).astype(
        np.float32) * 0.1
    coords = fc * stride
    ref = jax.jit(lambda *a: subm_conv_classes_mxu(
        *a, k, stride, w_groups=w_groups))(coords, fv, ff, w)
    xla = jax.jit(lambda c, v, f, ww: scan_conv_grouped_classes(
        c, v, f, stride, k, ww, w_groups=w_groups))(coords, fv, ff, w)
    got = sparse_conv(_t(fc), _t(fv), _t(ff), _t(w), k)
    assert _rel(got, ref) < 2e-2
    assert _rel(got, xla) < 2e-2
    assert (got.numpy()[~np.asarray(fv)] == 0).all()


def _table(seed, P, side, cap, C):
    rs = np.random.RandomState(seed)
    lat = rs.randint(0, side, (P, 3)).astype(np.int32)
    feats = rs.randn(P, C).astype(np.float32)
    st, _ = jax.jit(lambda a, b, c: unique_voxels(a, b, c, cap))(
        lat, feats, rs.rand(P) < 0.9)
    return st


@pytest.mark.parametrize("k,stride,cin", [(3, 2, 64), (5, 2, 16),
                                          (5, 1, 3)])
def test_conv_at_coords(k, stride, cin):
    src = _table(2, 500, 12, 256, cin)
    qry = _table(3, 400, 12, 256, 1)             # sorted query lattice
    w = np.random.RandomState(4).randn(k ** 3, cin, 48).astype(
        np.float32) * 0.1
    scoords = src.coords * stride
    ref = jax.jit(lambda sc, sv, sf, qc, qv, ww: conv_at_coords_mxu(
        sc, sv, sf, stride, qc, qv, k, ww))(
        scoords, src.valid, src.feats, qry.coords, qry.valid, w)
    xla = jax.jit(lambda sc, sv, sf, qc, qv, ww: scan_conv_grouped(
        sc, sv, sf, stride, qc, qv, k, ww))(
        scoords, src.valid, src.feats, qry.coords * stride, qry.valid, w)
    got = sparse_conv(_t(src.coords)[None], _t(src.valid)[None],
                      _t(src.feats)[None], _t(w)[None], k,
                      _t(qry.coords)[None], _t(qry.valid)[None])[0]
    assert _rel(got, ref) < 2e-2
    assert _rel(got, xla) < 2e-2
    assert (got.numpy()[~np.asarray(qry.valid)] == 0).all()


def test_sorted_source_contract_and_empty_group():
    """Sources must be key-sorted with invalid rows last (the Pallas
    contract): ``unique_voxels`` tables are, a shuffled one is not.  An
    all-invalid group gives zero rows and leaves the other group as it
    was."""
    fc, ff, fv = _classes(5, G=2, P=300, C=16, side=9)
    assert sources_sorted(_t(fc), _t(fv))
    perm = np.random.RandomState(7).permutation(fc.shape[1])
    assert not sources_sorted(_t(fc)[:, perm], _t(fv)[:, perm])
    w = np.random.RandomState(6).randn(2, 27, 16, 8).astype(np.float32)
    base = sparse_conv(_t(fc), _t(fv), _t(ff), _t(w), 3)
    fv_empty = np.array(fv)
    fv_empty[1] = False
    got = sparse_conv(_t(fc), _t(fv_empty), _t(ff), _t(w), 3)
    assert sources_sorted(_t(fc), _t(fv_empty))
    assert (got.numpy()[1] == 0).all()
    np.testing.assert_array_equal(got.numpy()[0], base.numpy()[0])
