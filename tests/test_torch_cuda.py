"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports no JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.  Bars: K1 relative error < 2e-2
and per-row error < 1e-3 (``_row``) with invalid rows exactly zero; K2
counts exact, sums within the same two bars; K3 and K1's feature backward
within both bars of their plain versions (both sides round to bf16 and
sum in f32), K3 bit-identical across two runs, and the autograd
Function's gradients within 2e-2 of plain autograd through
``sparse_conv_plain`` (which does not round the cotangent to bf16).
"""
import pytest
import torch

from cagroup3d_tpu_torch.core.hashing import pack_coords
from cagroup3d_tpu_torch.core.voxelize import unique_voxels
from cagroup3d_tpu_torch.ops.segsum import segment_sums, segment_sums_plain
from cagroup3d_tpu_torch.ops.sparse_conv import (sparse_conv,
                                                 sparse_conv_dfeats,
                                                 sparse_conv_dfeats_plain,
                                                 sparse_conv_dw,
                                                 sparse_conv_dw_plain,
                                                 sparse_conv_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def _row(a, b):
    """Largest per-row error, each row's max |a - b| over its max |b|,
    floored at a tenth of the tensor's max |b|."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    den = torch.maximum(b.abs().amax(-1), 0.1 * b.abs().max().clamp_min(1e-12))
    return float(((a - b).abs().amax(-1) / den).max())


def _tables(seed, G, P, C, cap, side, dev):
    g = torch.Generator().manual_seed(seed)
    coords, valid, feats = [], [], []
    for _ in range(G):
        lat = torch.randint(0, side, (P, 3), generator=g, dtype=torch.int32)
        f = torch.randn(P, C, generator=g)
        st, _ = unique_voxels(lat, f, torch.rand(P, generator=g) < 0.8, cap)
        coords.append(st.coords)
        valid.append(st.valid)
        feats.append(st.feats)
    return (torch.stack(coords).to(dev), torch.stack(valid).to(dev),
            torch.stack(feats).to(dev))


@pytest.mark.parametrize("k,G,Gw,C,Cout,query", [
    (3, 1, 1, 3, 64, False), (3, 1, 1, 64, 128, True), (5, 3, 3, 64, 64, False),
    (9, 3, 1, 64, 64, False), (5, 1, 1, 64, 128, True), (3, 1, 1, 512, 512, False)])
def test_sparse_conv_kernel(dev, k, G, Gw, C, Cout, query):
    lat, valid, feats = _tables(k, G, 900, C, 512, 12, dev)
    w = torch.randn(Gw, k ** 3, C, Cout, device=dev) * 0.1
    q = _tables(k + 1, G, 700, 1, 384, 12, dev)[:2] if query else (None, None)
    before = sparse_conv.launches
    got = sparse_conv(lat, valid, feats, w, k, *q)
    torch.cuda.synchronize()
    assert sparse_conv.launches == before + 1
    ref = sparse_conv_plain(lat, valid, feats, w, k, *q)
    assert _rel(got, ref) < 2e-2
    assert _row(got, ref) < 1e-3
    rows = q[1] if query else valid
    assert bool((got[~rows] == 0).all())


@pytest.mark.parametrize("side,cap", [(12, 64), (5, 256), (40, 4096)])
def test_segment_sums_kernel(dev, side, cap):
    g = torch.Generator().manual_seed(side)
    G, P, F = 4, 8192, 64
    lat = torch.randint(0, side, (G, P, 3), generator=g, dtype=torch.int32)
    keys = pack_coords(lat, torch.rand(G, P, generator=g) < 0.8)
    sk, _ = torch.sort(keys, dim=1, stable=True)
    fs = torch.randn(G, P, F, generator=g).to(torch.bfloat16)
    args = (sk.to(dev).contiguous(), fs.to(dev).contiguous(), cap)
    before = segment_sums.launches
    sums, counts = segment_sums(*args)
    torch.cuda.synchronize()
    assert segment_sums.launches == before + 1
    rsums, rcounts = segment_sums_plain(*args)
    assert bool((counts == rcounts).all())
    assert _rel(sums, rsums) < 2e-2
    assert _row(sums, rsums) < 1e-3


# the main-path forms of K3 and K1's backward, at small sizes:
# (a) subm k3 3->64 and 512->512, (b) down k3 at coords, (c) k3 64->64,
# (d) per-class k9, (e) per-class k5, (f) RoI k5 at coords 64->128, and
# weight groups shared by several groups (Gw < G)
BWD_FORMS = [(3, 1, 1, 3, 64, False), (3, 1, 1, 512, 512, False),
             (3, 1, 1, 64, 128, True), (3, 1, 1, 64, 64, False),
             (9, 3, 3, 64, 64, False), (5, 3, 3, 64, 64, False),
             (5, 1, 1, 64, 128, True), (5, 3, 1, 32, 64, False)]


def _bwd_case(dev, k, G, Gw, C, Cout, query):
    lat, valid, feats = _tables(k, G, 900, C, 512, 12, dev)
    w = torch.randn(Gw, k ** 3, C, Cout, device=dev) * 0.1
    q = _tables(k + 1, G, 700, 1, 384, 12, dev)[:2] if query else (None, None)
    NQ = q[0].shape[1] if query else lat.shape[1]
    gout = torch.randn(G, NQ, Cout, device=dev)
    return lat, valid, feats, w, q, gout


@pytest.mark.parametrize("k,G,Gw,C,Cout,query", BWD_FORMS)
def test_sparse_conv_dw_kernel(dev, k, G, Gw, C, Cout, query):
    lat, valid, feats, w, q, gout = _bwd_case(dev, k, G, Gw, C, Cout, query)
    before = sparse_conv_dw.launches
    got = sparse_conv_dw(lat, valid, feats, gout, k, Gw, *q)
    torch.cuda.synchronize()
    assert sparse_conv_dw.launches == before + 1
    ref = sparse_conv_dw_plain(lat, valid, feats, gout, k, Gw, *q)
    assert got.shape == (Gw, k ** 3, C, Cout)
    assert _rel(got, ref) < 2e-2
    assert _row(got, ref) < 1e-3
    again = sparse_conv_dw(lat, valid, feats, gout, k, Gw, *q)
    assert torch.equal(got, again)          # fixed summation order


@pytest.mark.parametrize("k,G,Gw,C,Cout,query", BWD_FORMS)
def test_sparse_conv_dfeats_kernel(dev, k, G, Gw, C, Cout, query):
    lat, valid, feats, w, q, gout = _bwd_case(dev, k, G, Gw, C, Cout, query)
    got = sparse_conv_dfeats(lat, valid, w, k, gout, *q)
    ref = sparse_conv_dfeats_plain(lat, valid, w, k, gout, *q)
    assert got.shape == feats.shape
    assert _rel(got, ref) < 2e-2
    assert _row(got, ref) < 1e-3
    assert bool((got[~valid] == 0).all())


@pytest.mark.parametrize("k,G,Gw,C,Cout,query", BWD_FORMS)
def test_sparse_conv_autograd(dev, k, G, Gw, C, Cout, query):
    lat, valid, feats, w, q, gout = _bwd_case(dev, k, G, Gw, C, Cout, query)
    grads = []
    for fn in (sparse_conv, sparse_conv_plain):
        f = feats.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        (fn(lat, valid, f, ww, k, *q) * gout).sum().backward()
        grads.append((f.grad, ww.grad))
    (gf, gw), (rf, rw) = grads
    assert _rel(gf, rf) < 2e-2
    assert _rel(gw, rw) < 2e-2
