"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports no JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.  Bars: K1 relative error < 2e-2
and per-row error < 1e-3 (``_row``) with invalid rows exactly zero; K2
counts exact, sums within the same two bars; K3 and K1's feature backward
within both bars of their plain versions (both sides round to bf16 and
sum in f32), K1, K2 and K3 bit-identical across two calls, and the autograd
Function's gradients within 2e-2 of plain autograd through
``sparse_conv_plain`` (which does not round the cotangent to bf16).
"""
import pytest
import torch

from cagroup3d_tpu_torch.core.hashing import (INVALID_KEY, key_bits,
                                              key_bits_scope, pack_coords)
from cagroup3d_tpu_torch.core.voxelize import spconv_reduce_lat, unique_voxels
from cagroup3d_tpu_torch.ops.segsum import segment_sums, segment_sums_plain
from cagroup3d_tpu_torch.ops.sparse_conv import (sparse_conv,
                                                 sparse_conv_dfeats,
                                                 sparse_conv_dfeats_plain,
                                                 sparse_conv_dw,
                                                 sparse_conv_dw_plain,
                                                 sparse_conv_plain, k3_plan)

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


def _tables(seed, G, P, C, cap, side, dev, wrap=False, flat=False):
    g = torch.Generator().manual_seed(seed)
    coords, valid, feats = [], [], []
    for _ in range(G):
        lat = torch.randint(0, side, (P, 3), generator=g, dtype=torch.int32)
        if wrap:   # z at -8 (packed 0) and up to 1015 (packed 1023)
            z = lat[:, 2]
            lat[:, 2] = torch.where(z < side // 2, z - 8,
                                    1015 - (z - side // 2))
        if flat:   # one z plane: offsets with dz != 0 have no neighbour
            lat[:, 2] = 0
        f = torch.randn(P, C, generator=g)
        st, _ = unique_voxels(lat, f, torch.rand(P, generator=g) < 0.8, cap)
        coords.append(st.coords)
        valid.append(st.valid)
        feats.append(st.feats)
    return (torch.stack(coords).to(dev), torch.stack(valid).to(dev),
            torch.stack(feats).to(dev))


# K1 cases over the plans that ``k1_plan`` can choose: C and Cout over
# {3, 16, 64, 128, 256, 512}, K over {3, 5, 9}, (G, Gw) (1, 1), (3, 3),
# (3, 1) and (18, 18), conv at coords; small tables split the offsets,
# the large ones (cap >= 17000 or 18 x 1024 queries) do not and walk
# their column tiles (64 or 128 wide) with one map; NQ not a multiple of
# 64; the feature backward's transposed weights are the dfeats cases
# below; "empty": every query invalid; "far": queries above every source
# (the tiles' key windows hold
# sources, but every plane of every tile is empty); "wrap": lattice z at
# both ends of the key's z field, so a neighbour below z 0 would alias the
# top voxel of the previous y column.  The SUN RGB-D head adds Cout 192
# (three 64-column tiles, split offsets and, at 17000 rows, one map for
# all three) and 10 per-class groups.
K1_CASES = [
    (3, 1, 1, 3, 64, False, 512, ""), (3, 1, 1, 64, 128, True, 512, ""),
    (5, 3, 3, 64, 64, False, 512, ""), (9, 3, 1, 64, 64, False, 512, ""),
    (5, 1, 1, 64, 128, True, 512, ""), (3, 1, 1, 512, 512, False, 512, ""),
    (3, 1, 1, 16, 16, False, 512, ""), (3, 1, 1, 128, 256, True, 512, ""),
    (3, 1, 1, 256, 3, False, 512, ""), (5, 1, 1, 16, 512, False, 300, ""),
    (9, 2, 2, 64, 128, False, 512, ""), (9, 18, 18, 64, 64, False, 1024, ""),
    (5, 18, 18, 64, 64, False, 300, ""), (3, 1, 1, 64, 64, False, 17000, ""),
    (3, 1, 1, 64, 256, False, 17000, ""),
    (3, 1, 1, 3, 64, False, 17000, ""), (5, 1, 1, 64, 128, True, 17000, ""),
    (3, 1, 1, 64, 64, True, 512, "empty"), (5, 1, 1, 64, 64, True, 512, "far"),
    (3, 1, 1, 64, 64, False, 512, "wrap"),
    (5, 1, 1, 16, 64, False, 512, "wrap"),
    (3, 1, 1, 64, 192, False, 512, ""), (3, 1, 1, 64, 192, False, 17000, ""),
    (3, 1, 1, 192, 64, False, 512, ""), (9, 10, 10, 64, 64, False, 1024, ""),
    (5, 10, 10, 64, 64, False, 1024, "")]


# SECOND on KITTI packs keys at (11, 11, 8) bits over a 1408 x 1600 x 41
# lattice (the z field 256 wide, not 1024).  Its K1 forms: the submanifold
# convs (Cin 4 at the stem, padded to 16) and the strided convs at coords,
# queried at o*2 - p + 1 over spconv's output lattice; (C, Cout, pad,
# cap, kind), the tables in the extent's top corner, so that neighbours
# reach past its last voxel; "wrap": z at both ends of the 8-bit field.
KITTI_EXTENT = (1408, 1600, 41)
K1_KITTI_CASES = [(4, 16, None, 65536, ""), (16, 16, None, 65536, ""),
                  (32, 32, None, 32768, ""), (64, 64, None, 8192, ""),
                  (16, 32, 1, 65536, ""), (32, 64, 1, 32768, ""),
                  (64, 64, (1, 1, 0), 16384, ""), (16, 16, None, 4096, "wrap")]


def _kitti_case(dev, C, Cout, pad, cap, kind):
    """Source tables (and, with ``pad``, the strided conv's query table)
    built at (11, 11, 8) in the extent's top corner, and weights."""
    g = torch.Generator().manual_seed(cap + C)
    P = 2 * cap
    span = torch.tensor([120, 120, 41], dtype=torch.int32)
    lat = torch.tensor(KITTI_EXTENT, dtype=torch.int32) - 1 - \
        (torch.rand(P, 3, generator=g) * span).to(torch.int32)
    if kind == "wrap":       # packed z 0..7 and 248..255
        z = torch.randint(0, 16, (P,), generator=g, dtype=torch.int32)
        lat[:, 2] = torch.where(z < 8, z - 8, 232 + z)
    with key_bits_scope((11, 11, 8)):
        st, _ = unique_voxels(lat, torch.randn(P, C, generator=g),
                              torch.rand(P, generator=g) < 0.9, cap)
        lat, valid, feats = (t[None].to(dev) for t in
                             (st.coords, st.valid, st.feats))
        q = (None, None)
        if pad is not None:
            out, ok = spconv_reduce_lat(st.coords, st.valid, 3, 2, pad,
                                        cap // 2, in_extent=KITTI_EXTENT)
            p = torch.tensor(pad, dtype=torch.int32).expand(3)
            q = ((out * 2 - p + 1)[None].to(dev), ok[None].to(dev))
            assert int(ok.sum()) > 0
    w = torch.randn(1, 27, C, Cout, generator=g).to(dev) * 0.1
    return lat, valid, feats, w, q


@pytest.mark.parametrize("C,Cout,pad,cap,kind", K1_KITTI_CASES)
def test_sparse_conv_kernel_kitti_bits(dev, C, Cout, pad, cap, kind):
    lat, valid, feats, w, q = _kitti_case(dev, C, Cout, pad, cap, kind)
    with key_bits_scope((11, 11, 8)):
        before = sparse_conv.launches
        got = sparse_conv(lat, valid, feats, w, 3, *q)
        torch.cuda.synchronize()
        assert sparse_conv.launches == before + 1
        ref = sparse_conv_plain(lat, valid, feats, w, 3, *q)
        again = sparse_conv(lat, valid, feats, w, 3, *q)
    rows = valid if pad is None else q[1]
    assert bool((got[~rows] == 0).all())
    assert _rel(got, ref) < 2e-2
    assert _row(got, ref) < 1e-3
    assert torch.equal(got, again)


@pytest.mark.parametrize("C,Cout,pad,cap,kind", K1_KITTI_CASES)
def test_sparse_conv_backward_kitti_bits(dev, C, Cout, pad, cap, kind):
    """SECOND's training backward at (11, 11, 8): the forward inside the
    model's scope, ``backward()`` after it has closed (as the training
    step calls it): K1's feature backward and K3, one launch each, against
    their plain versions at those bits, and a second backward the same
    bits."""
    lat, valid, feats, w, q = _kitti_case(dev, C, Cout, pad, cap, kind)
    rows = valid if pad is None else q[1]
    gout = torch.randn(1, rows.shape[1], Cout, device=dev)
    grads = []
    for _ in range(2):
        f = feats.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        with key_bits_scope((11, 11, 8)):
            out = sparse_conv(lat, valid, f, ww, 3, *q)
        k1, k3 = sparse_conv.launches, sparse_conv_dw.launches
        (out * gout).sum().backward()
        torch.cuda.synchronize()
        assert (sparse_conv.launches, sparse_conv_dw.launches) == \
            (k1 + 1, k3 + 1)
        grads.append((f.grad, ww.grad))
    assert key_bits() == (10, 10, 10)
    g = torch.where(rows[..., None], gout, 0.0)
    with key_bits_scope((11, 11, 8)):
        rf = sparse_conv_dfeats_plain(lat, valid, w, 3, g, *q)
        rw = sparse_conv_dw_plain(lat, valid, feats, g, 3, 1, *q)
    (gf, gw), (gf2, gw2) = grads
    assert _rel(gf, rf) < 2e-2 and _row(gf, rf) < 1e-3
    assert _rel(gw, rw) < 2e-2 and _row(gw, rw) < 1e-3
    assert torch.equal(gf, gf2) and torch.equal(gw, gw2)
    assert bool((gf[~valid] == 0).all())


@pytest.mark.parametrize("k,G,Gw,C,Cout,query,cap,kind", K1_CASES)
def test_sparse_conv_kernel(dev, k, G, Gw, C, Cout, query, cap, kind):
    P, side = (900, 12) if cap <= 1024 else (30000, 40)
    lat, valid, feats = _tables(k, G, P, C, cap, side, dev, kind == "wrap")
    w = torch.randn(Gw, k ** 3, C, Cout, device=dev) * 0.1
    q = (None, None)
    if query:
        q = _tables(k + 1, G, 700 if cap <= 1024 else P, 1,
                    384 if cap <= 1024 else cap, side, dev)[:2]
        if kind == "empty":
            q = (q[0], torch.zeros_like(q[1]))
        elif kind == "far":                 # z beyond every source's reach
            q = (q[0] + torch.tensor([0, 0, side + 3], device=dev), q[1])
    before = sparse_conv.launches
    got = sparse_conv(lat, valid, feats, w, k, *q)
    torch.cuda.synchronize()
    assert sparse_conv.launches == before + 1
    ref = sparse_conv_plain(lat, valid, feats, w, k, *q)
    rows = q[1] if query else valid
    assert bool((got[~rows] == 0).all())
    if kind in ("empty", "far"):
        assert bool((got == 0).all()) and bool((ref == 0).all())
    else:
        assert _rel(got, ref) < 2e-2
        assert _row(got, ref) < 1e-3
    again = sparse_conv(lat, valid, feats, w, k, *q)
    assert torch.equal(got, again)          # no float atomics


def _segsum_case(case, dev):
    """(sorted keys, bf16 rows, cap) of a K2 case.  "rand": random
    lattices over ``side``; "runs": explicit run lengths, runs spanning
    two and three 1024-row tiles, P not a multiple of the tile, and an
    all-invalid group; "classes": the SUN RGB-D head's per-class maps, 10
    groups of 4 x 8192 rows (three votes and the voxel per row of the
    stride-2 map)."""
    kind, side, cap, F = case
    g = torch.Generator().manual_seed(side + cap + F)
    if kind in ("rand", "classes"):
        G, P = (4, 8192) if kind == "rand" else (10, 4 * 8192)
        lat = torch.randint(0, side, (G, P, 3), generator=g, dtype=torch.int32)
        keys = pack_coords(lat, torch.rand(G, P, generator=g) < 0.8)
        sk, _ = torch.sort(keys, dim=1, stable=True)
    else:
        P, lengths = 9000, [1500, 2600, 3, 3000, 1]   # 5 runs, then invalid
        sk = torch.full((3, P), INVALID_KEY, dtype=torch.int32)
        run = torch.repeat_interleave(torch.arange(5, dtype=torch.int32) * 7,
                                      torch.tensor(lengths))
        sk[0, :run.numel()] = run
        sk[2, :run.numel()] = run + 1
        G = 3                               # group 1: every row invalid
    fs = torch.randn(G, P, F, generator=g).to(torch.bfloat16)
    return sk.to(dev).contiguous(), fs.to(dev).contiguous(), cap


# (kind, side, cap, F): caps below, equal to and above the number of
# runs; F 16, 64, 256 (vector loads) and 20 (scalar loads)
K2_CASES = [("rand", 12, 64, 64), ("rand", 5, 256, 64), ("rand", 40, 4096, 64),
            ("rand", 12, 64, 16), ("rand", 40, 4096, 256),
            ("rand", 12, 300, 20), ("runs", 0, 3, 64), ("runs", 0, 5, 64),
            ("runs", 0, 8, 256), ("runs", 0, 5, 20),
            ("classes", 40, 4096, 64), ("classes", 20, 4096, 64)]


@pytest.mark.parametrize("case", K2_CASES)
def test_segment_sums_kernel(dev, case):
    args = _segsum_case(case, dev)
    before = segment_sums.launches
    sums, counts = segment_sums(*args)
    torch.cuda.synchronize()
    assert segment_sums.launches == before + 1
    rsums, rcounts = segment_sums_plain(*args)
    assert bool((counts == rcounts).all())
    assert _rel(sums, rsums) < 2e-2
    assert _row(sums, rsums) < 1e-3
    again = segment_sums(*args)
    assert torch.equal(sums, again[0]) and torch.equal(counts, again[1])


# the main-path forms of K3 and K1's backward, at small sizes:
# (a) subm k3 3->64 and 512->512, (b) down k3 at coords, (c) k3 64->64,
# (d) per-class k9, (e) per-class k5, (f) RoI k5 at coords 64->128, and
# weight groups shared by several groups (Gw < G); then K3's edges: "flat"
# (one z plane: offsets with no pair), "dead" (group 1 all invalid), "big"
# (17000 rows: a (group, offset) list spans several pair splits), C 20
# and 16 (not multiples of 64; 20 not of 16), Cout 128 and 512; the SUN
# RGB-D head's Cout 192 (a full and a half-full 128-column tile; "big":
# split pair lists) and 10 per-class groups.
BWD_FORMS = [(3, 1, 1, 3, 64, False, ""), (3, 1, 1, 512, 512, False, ""),
             (3, 1, 1, 64, 128, True, ""), (3, 1, 1, 64, 64, False, ""),
             (9, 3, 3, 64, 64, False, ""), (5, 3, 3, 64, 64, False, ""),
             (5, 1, 1, 64, 128, True, ""), (5, 3, 1, 32, 64, False, ""),
             (5, 1, 1, 64, 64, False, "flat"), (3, 3, 3, 64, 64, False, "dead"),
             (9, 3, 1, 16, 128, False, "dead"), (3, 1, 1, 64, 64, False, "big"),
             (3, 1, 1, 20, 64, False, ""), (3, 1, 1, 16, 512, True, ""),
             (3, 1, 1, 64, 192, False, ""), (3, 1, 1, 64, 192, False, "big"),
             (9, 10, 10, 64, 64, False, ""), (5, 10, 10, 64, 64, False, "")]


def _bwd_case(dev, k, G, Gw, C, Cout, query, kind):
    if kind == "big":
        lat, valid, feats = _tables(k, G, 30000, C, 17000, 40, dev)
    else:
        lat, valid, feats = _tables(k, G, 900, C, 512, 12, dev,
                                    flat=kind == "flat")
    if kind == "dead":
        valid[1] = False
    w = torch.randn(Gw, k ** 3, C, Cout, device=dev) * 0.1
    q = _tables(k + 1, G, 700, 1, 384, 12, dev)[:2] if query else (None, None)
    NQ = q[0].shape[1] if query else lat.shape[1]
    gout = torch.randn(G, NQ, Cout, device=dev)
    return lat, valid, feats, w, q, gout


@pytest.mark.parametrize("k,G,Gw,C,Cout,query,kind", BWD_FORMS)
def test_sparse_conv_dw_kernel(dev, k, G, Gw, C, Cout, query, kind):
    lat, valid, feats, w, q, gout = _bwd_case(dev, k, G, Gw, C, Cout, query,
                                              kind)
    NQ = gout.shape[1]
    if kind == "big":
        assert k3_plan(G, NQ, C, Cout, k).split > 1
    before = sparse_conv_dw.launches
    got = sparse_conv_dw(lat, valid, feats, gout, k, Gw, *q)
    torch.cuda.synchronize()
    assert sparse_conv_dw.launches == before + 1
    ref = sparse_conv_dw_plain(lat, valid, feats, gout, k, Gw, *q)
    assert got.shape == (Gw, k ** 3, C, Cout)
    assert _rel(got, ref) < 2e-2
    assert _row(got, ref) < 1e-3
    if kind == "flat":              # offsets with dz != 0 have no pair
        dz = torch.arange(k ** 3) % k != k // 2
        assert bool((got[:, dz] == 0).all()) and bool((ref[:, dz] == 0).all())
    again = sparse_conv_dw(lat, valid, feats, gout, k, Gw, *q)
    assert torch.equal(got, again)          # fixed summation order


@pytest.mark.parametrize("k,G,Gw,C,Cout,query,kind", BWD_FORMS)
def test_sparse_conv_dfeats_kernel(dev, k, G, Gw, C, Cout, query, kind):
    lat, valid, feats, w, q, gout = _bwd_case(dev, k, G, Gw, C, Cout, query,
                                              kind)
    got = sparse_conv_dfeats(lat, valid, w, k, gout, *q)
    ref = sparse_conv_dfeats_plain(lat, valid, w, k, gout, *q)
    assert got.shape == feats.shape
    assert _rel(got, ref) < 2e-2
    assert _row(got, ref) < 1e-3
    assert bool((got[~valid] == 0).all())


@pytest.mark.parametrize("k,G,Gw,C,Cout,query,kind", BWD_FORMS)
def test_sparse_conv_autograd(dev, k, G, Gw, C, Cout, query, kind):
    lat, valid, feats, w, q, gout = _bwd_case(dev, k, G, Gw, C, Cout, query,
                                              kind)
    grads = []
    for fn in (sparse_conv, sparse_conv_plain):
        f = feats.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        (fn(lat, valid, f, ww, k, *q) * gout).sum().backward()
        grads.append((f.grad, ww.grad))
    (gf, gw), (rf, rw) = grads
    assert _rel(gf, rf) < 2e-2
    assert _rel(gw, rw) < 2e-2


@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "deconv"])
def test_bev_conv_backward_bits_under_memory_pressure(dev, transposed):
    """The KITTI BEV convs' forward and backward (``conv2d_same``, or the
    stride-2 ``conv_transpose2d_same`` deblock) on a B = 4 map of SECOND's
    widths run off cuDNN: with all device memory free and with memory held
    back so that 12 GB stay free (cuDNN picks its algorithms by the free
    memory), the output and both gradients are the same bits."""
    from cagroup3d_tpu_torch.models.backbones_2d.base_bev_backbone import (
        conv2d_same, conv_transpose2d_same)
    g = torch.Generator().manual_seed(3)
    if transposed:
        x = torch.randn(4, 256, 100, 88, generator=g).to(dev)
        w = (torch.randn(2, 2, 256, 256, generator=g) * 0.05).to(dev)
        fn = lambda a, b: conv_transpose2d_same(a, b, 2)   # noqa: E731
    else:
        x = torch.randn(4, 256, 200, 176, generator=g).to(dev)
        w = (torch.randn(3, 3, 256, 128, generator=g) * 0.05).to(dev)
        fn = lambda a, b: conv2d_same(a, b, 1)   # noqa: E731
    runs = []
    for free_gb in (None, 12.0):
        torch.cuda.empty_cache()
        held = None
        if free_gb is not None:
            free = torch.cuda.mem_get_info(dev)[0]
            held = torch.empty(max(int(free - free_gb * 1e9), 0),
                               dtype=torch.uint8, device=dev)
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xs, ws)
        y.square().sum().backward()
        torch.cuda.synchronize()
        runs.append((y.detach(), xs.grad, ws.grad))
        del held
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_voxel_rcnn_pool_bits(dev):
    """Voxel R-CNN's voxel queries and RoI grid pool at voxel_rcnn_car.yaml's
    widths on KITTI's grid ((11, 11, 8) key bits): four scenes' sparse
    levels at the backbone's capacities (32768, 16384 and 8192 voxels of
    32, 64 and 64 channels) and 128 RoIs a scene, in training (every BN
    pooled over the scenes).  The voxel rows equal the CPU's on the same
    grid points, and two calls give the same bits in the pooled features,
    the BN updates and the gradients into the levels' features and the
    pool's weights (the gathers' backward feeds K1's)."""
    from cagroup3d_tpu_torch.core.module import Ctx, flat_state
    from cagroup3d_tpu_torch.core.pointnet2_stack import voxel_query_offsets
    from cagroup3d_tpu_torch.core.sparse import PAD_COORD, SparseTensor
    from cagroup3d_tpu_torch.models import load_config
    from cagroup3d_tpu_torch.models.roi_heads.voxelrcnn_head import \
        VoxelRCNNHead
    cfg = load_config("tools/cfgs/kitti_models/voxel_rcnn_car.yaml")
    head = VoxelRCNNHead(cfg.MODEL.ROI_HEAD, 1, backbone_channels={
        "x_conv2": 32, "x_conv3": 64, "x_conv4": 64},
        voxel_size=[0.05, 0.05, 0.1],
        point_cloud_range=[0, -40, -3, 70.4, 40, 1]).to(dev)
    g = torch.Generator().manual_seed(5)
    B, R = 4, 128
    levels = {"x_conv2": (2, (704, 800, 21), 32768, 32),
              "x_conv3": (4, (352, 400, 11), 16384, 64),
              "x_conv4": (8, (176, 200, 5), 8192, 64)}
    multis = [{} for _ in range(B)]
    feats = {}
    for name, (s, ext, cap, ch) in levels.items():
        # voxels in a 20 x 20 m patch at x 20-40 m, y -10-10 m
        lo = torch.tensor([int(20 / 0.05 / s), int(30 / 0.05 / s), 0])
        hi = torch.tensor([int(40 / 0.05 / s), int(50 / 0.05 / s), ext[2]])
        f = torch.randn(B, cap, ch, generator=g).abs()
        feats[name] = f
        for b in range(B):
            lat = lo + (torch.rand(2 * cap, 3, generator=g) *
                        (hi - lo)).to(torch.int32)
            lat = torch.unique(lat, dim=0)[:cap]
            lat = lat[torch.randperm(len(lat), generator=g)]
            coords = torch.full((cap, 3), PAD_COORD, dtype=torch.int32)
            coords[:len(lat)] = lat
            valid = torch.arange(cap) < len(lat)
            multis[b][name] = (coords, valid)
    strides = {k: v[0] for k, v in levels.items()}
    rois = torch.cat([torch.rand(B, R, 1, generator=g) * 20 + 20,
                      torch.rand(B, R, 1, generator=g) * 20 - 10,
                      torch.rand(B, R, 1, generator=g) * 2 - 2,
                      torch.rand(B, R, 3, generator=g) * 3 + 1,
                      torch.rand(B, R, 1, generator=g) * 6 - 3], -1).to(dev)
    cot = torch.randn(B, R, 216 * head.pool_out_channels, generator=g).to(dev)
    P, S = flat_state(head, "roi_head")
    runs = []
    with key_bits_scope((11, 11, 8)):
        grid = head.get_global_grid_points(rois.reshape(-1, 7))
        lvs = torch.tensor([0.05 * 4, 0.05 * 4, 0.1 * 4], device=dev)
        lo = torch.tensor([0.0, -40.0, -3.0], device=dev)
        lat = torch.floor((grid.reshape(B, -1, 3) - lo) / lvs).to(torch.int32)
        coords, valid = multis[0]["x_conv3"]
        offs = head.pools[1][0][0]
        rows = voxel_query_offsets(coords.to(dev), valid.to(dev), lat[0],
                                   torch.ones(lat.shape[1], dtype=torch.bool,
                                              device=dev), offs)
        want = voxel_query_offsets(coords, valid, lat[0].cpu(),
                                   torch.ones(lat.shape[1], dtype=torch.bool),
                                   offs)
        assert torch.equal(rows.cpu(), want)
        assert 0.05 < float((want >= 0).float().mean()) < 0.95
        for _ in range(2):
            head.zero_grad(set_to_none=True)
            fs = {k: v.to(dev).requires_grad_() for k, v in feats.items()}
            ms = [{k: SparseTensor(c.to(dev), fs[k][b], v.to(dev), 1)
                   for k, (c, v) in m.items()} for b, m in enumerate(multis)]
            ctx = Ctx(train=True)
            out = head.roi_grid_pool_voxel(
                P, S, ctx, rois, torch.ones(B, R, dtype=torch.bool,
                                            device=dev), ms, strides)
            (out * cot).sum().backward()
            torch.cuda.synchronize()
            runs.append([out.detach()] + [ctx.updates[k] for k in sorted(
                ctx.updates)] + [fs[k].grad for k in sorted(fs)] + [
                p.grad for _, p in sorted(head.named_parameters())
                if p.grad is not None])
    assert len(runs[0]) == len(runs[1]) > 30
    for a, b in zip(*runs):
        assert torch.equal(a, b)
