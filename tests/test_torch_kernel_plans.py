"""K1's and K3's plan tables (``ops/sparse_conv.k1_plan``, ``k3_plan``) at
the main path's shapes.

The kernel (``csrc/sparse_conv.cu::spconv_k1_gemm``) reads a plan as its
grid: blockIdx.x takes 64 queries, blockIdx.y a (column group, offset
split) pair, blockIdx.z the group; a column group walks ``col_inner``
column tiles of ``tn`` columns with one kernel map, a split takes
``per_split`` kernel offsets.  For every launch shape of the full-width
ScanNet model -- the 16 distinct shapes of the 39 K1 calls of the eval
forward and of a training step's forward, and the 15 of the 38 feature
backward calls (K1 on the transposed problem) -- the blocks must cover
each (query, column, offset) exactly once, and the offsets must split
wherever the grid would be under two waves of the card's SMs.  The
full-width SUN RGB-D model (the yaw path) adds its head's shapes: the
3-vote ``feature_offset`` k3 at Cout 192 (three 64-column tiles for K1, a
128-column and a half-full 128-column tile for K3) and the per-class k9 and
k5 convs at 10 classes.  SECOND on KITTI adds its sparse backbone's 7
distinct eval shapes (11 launches a scene, Cin 4 at the stem) and, in
training, 7 feature-backward shapes (the strided convs' at coords).

K3 (``spconv_k3_gemm``) reads its plan as a grid of (C tile x Cout tile,
pair split, group x offset): at the 16 distinct shapes of the 39 K3 calls
of a CAGroup3D training step, SUN RGB-D's head and SECOND's 8 (11 calls a
scene), the blocks of each (group, split) must cover each
(offset, C, Cout) element of dW once, each split of a pair list its pairs
once, the splits must fill two waves of the card's SMs
wherever the list lengths allow it, and the scratch stays under 0.5 GB.
Pure Python, a few milliseconds.
"""
import numpy as np
import pytest

from cagroup3d_tpu_torch.ops.sparse_conv import (K1_SMS, K1_TQ, K3_KP,
                                                 K3_TC, _k3_scratch,
                                                 k1_plan, k3_plan)

# (form, G, NQ, C, Cout, K) of the K1 launches; the source table's size
# does not enter the plan
FORWARD = [
    ("a", 1, 65536, 3, 64, 3), ("a", 1, 65536, 64, 64, 3),
    ("a", 1, 32768, 64, 64, 3), ("a", 1, 16384, 128, 128, 3),
    ("a", 1, 8192, 256, 256, 3), ("a", 1, 4096, 512, 512, 3),
    ("a", 1, 2048, 128, 128, 3),
    ("b", 1, 32768, 64, 64, 3), ("b", 1, 16384, 64, 128, 3),
    ("b", 1, 8192, 128, 256, 3), ("b", 1, 4096, 256, 512, 3),
    ("b", 1, 2048, 512, 512, 3),
    ("c", 1, 32768, 64, 64, 3), ("d", 18, 4096, 64, 64, 9),
    ("e", 18, 2048, 64, 64, 5), ("f", 1, 16384, 64, 128, 5)]
# the feature backward: K1 with C and Cout swapped and, at coords, the
# source lattice as the queries
FEATURE_BACKWARD = [
    ("a", 1, 2048, 128, 128, 3), ("a", 1, 16384, 128, 128, 3),
    ("a", 1, 4096, 512, 512, 3), ("a", 1, 8192, 256, 256, 3),
    ("a", 1, 32768, 64, 64, 3), ("a", 1, 65536, 64, 64, 3),
    ("b", 1, 4096, 512, 512, 3), ("b", 1, 8192, 512, 256, 3),
    ("b", 1, 16384, 256, 128, 3), ("b", 1, 32768, 128, 64, 3),
    ("b", 1, 65536, 64, 64, 3),
    ("c", 1, 32768, 64, 64, 3), ("d", 18, 4096, 64, 64, 9),
    ("e", 18, 2048, 64, 64, 5), ("f", 1, 32768, 128, 64, 5)]
# the SUN RGB-D head's K1 launches (the backbone and the RoI grid conv have
# ScanNet's shapes): forward, then the feature backward
SUNRGBD_FORWARD = [("c", 1, 32768, 64, 192, 3), ("d", 10, 4096, 64, 64, 9),
                   ("e", 10, 2048, 64, 64, 5)]
SUNRGBD_FEATURE_BACKWARD = [("c", 1, 32768, 192, 64, 3),
                            ("d", 10, 4096, 64, 64, 9),
                            ("e", 10, 2048, 64, 64, 5)]
# SECOND on KITTI (eval, key bits (11, 11, 8)): the 8 submanifold convs
# ("g": Cin 4 at the stem) and the 3 strided convs at coords ("h", queries
# at the output lattice's capacity) of VoxelBackBone8x, 7 distinct shapes
SECOND_FORWARD = [("g", 1, 65536, 4, 16, 3), ("g", 1, 65536, 16, 16, 3),
                  ("g", 1, 32768, 32, 32, 3), ("g", 1, 16384, 64, 64, 3),
                  ("g", 1, 8192, 64, 64, 3), ("h", 1, 32768, 16, 32, 3),
                  ("h", 1, 16384, 32, 64, 3)]
# SECOND's training step adds the feature backward of the 7 subm convs
# after the stem (the VFE's means take no gradient) and, at coords, of the
# 3 strided convs (the output lattice the source, the input lattice the
# queries)
SECOND_FEATURE_BACKWARD = [
    ("g", 1, 65536, 16, 16, 3), ("g", 1, 32768, 32, 32, 3),
    ("g", 1, 16384, 64, 64, 3), ("g", 1, 8192, 64, 64, 3),
    ("h", 1, 65536, 32, 16, 3), ("h", 1, 32768, 64, 32, 3),
    ("h", 1, 16384, 64, 64, 3)]
SHAPES = [("fwd",) + s for s in FORWARD + SUNRGBD_FORWARD +
          SECOND_FORWARD] + \
    [("bwd",) + s for s in FEATURE_BACKWARD + SUNRGBD_FEATURE_BACKWARD +
     SECOND_FEATURE_BACKWARD]
IDS = [f"{d}-{f}-G{G}-NQ{NQ}-{C}x{Cout}-k{K}"
       for d, f, G, NQ, C, Cout, K in SHAPES]


def _grid(plan, NQ, Cout):
    """The kernel's grid (x, y) for one group and its column groups."""
    ntiles = -(-Cout // plan.tn)
    col_groups = -(-ntiles // plan.col_inner)
    return -(-NQ // K1_TQ), col_groups * plan.split, col_groups


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k1_plan_covers_every_output_once(shape):
    _, _, G, NQ, C, Cout, K = shape
    plan = k1_plan(G, NQ, C, Cout, K)
    K3 = K ** 3
    gx, gy, _ = _grid(plan, NQ, Cout)
    # queries: blockIdx.x -> [64 x, 64 x + 64) cut at NQ
    q = np.zeros(NQ, np.int64)
    for x in range(gx):
        q[x * K1_TQ:min(NQ, (x + 1) * K1_TQ)] += 1
    assert (q == 1).all()
    # (columns, offsets): blockIdx.y -> column group y / split (col_inner
    # tiles of tn) and offset split y % split (per_split offsets)
    cover = np.zeros((Cout, K3), np.int64)
    for y in range(gy):
        cg, sp = divmod(y, plan.split)
        n0, n1 = cg * plan.col_inner * plan.tn, \
            min(Cout, (cg + 1) * plan.col_inner * plan.tn)
        o0, o1 = sp * plan.per_split, min(K3, (sp + 1) * plan.per_split)
        assert n0 < n1 and o0 < o1          # no block without work
        cover[n0:n1, o0:o1] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k1_plan_fills_the_card(shape):
    _, _, G, NQ, C, Cout, K = shape
    plan = k1_plan(G, NQ, C, Cout, K)
    assert plan.tn == (128 if Cout >= 256 else 64)
    gx, gy, col_groups = _grid(plan, NQ, Cout)
    unsplit = G * gx * col_groups
    waves = 2 * K1_SMS
    if unsplit < waves:
        # split, into at least two waves unless every offset has its own
        assert plan.split > 1
        assert G * gx * gy >= waves or plan.per_split == 1
    else:
        assert plan.split == 1
    # one map for several column tiles only where the query tiles alone
    # fill two waves
    assert plan.col_inner == 1 or G * gx >= waves
    assert gy <= 65535 and G <= 65535


# (form, G, N, NQ, C, Cout, K, Gw) of the K3 launches of a training step:
# (a) 7 submanifold k3 shapes, (b) 5 down k3 at coords (N = 2 NQ), (c) the
# head's feature_offset k3, (d) and (e) the per-class k9 and k5, (f) the RoI
# grid k5 at coords
K3_SHAPES = [
    ("a", 1, 65536, 65536, 3, 64, 3, 1), ("a", 1, 65536, 65536, 64, 64, 3, 1),
    ("a", 1, 32768, 32768, 64, 64, 3, 1),
    ("a", 1, 16384, 16384, 128, 128, 3, 1),
    ("a", 1, 8192, 8192, 256, 256, 3, 1), ("a", 1, 4096, 4096, 512, 512, 3, 1),
    ("a", 1, 2048, 2048, 128, 128, 3, 1),
    ("b", 1, 4096, 2048, 512, 512, 3, 1), ("b", 1, 8192, 4096, 256, 512, 3, 1),
    ("b", 1, 16384, 8192, 128, 256, 3, 1),
    ("b", 1, 32768, 16384, 64, 128, 3, 1),
    ("b", 1, 65536, 32768, 64, 64, 3, 1),
    ("c", 1, 32768, 32768, 64, 64, 3, 1),
    ("d", 18, 4096, 4096, 64, 64, 9, 18), ("e", 18, 2048, 2048, 64, 64, 5, 18),
    ("f", 1, 32768, 16384, 64, 128, 5, 1),
    # SUN RGB-D's head: feature_offset at Cout 192, 10 classes
    ("c", 1, 32768, 32768, 64, 192, 3, 1),
    ("d", 10, 4096, 4096, 64, 64, 9, 10), ("e", 10, 2048, 2048, 64, 64, 5, 10),
    # SECOND on KITTI: (g) its 8 submanifold k3 convs (Cin 4 at the stem),
    # (h) its 3 strided convs at coords
    ("g", 1, 65536, 65536, 4, 16, 3, 1), ("g", 1, 65536, 65536, 16, 16, 3, 1),
    ("g", 1, 32768, 32768, 32, 32, 3, 1), ("g", 1, 16384, 16384, 64, 64, 3, 1),
    ("g", 1, 8192, 8192, 64, 64, 3, 1), ("h", 1, 65536, 32768, 16, 32, 3, 1),
    ("h", 1, 32768, 16384, 32, 64, 3, 1), ("h", 1, 16384, 8192, 64, 64, 3, 1)]
K3_IDS = [f"{f}-G{G}-N{N}-NQ{NQ}-{C}x{Cout}-k{K}"
          for f, G, N, NQ, C, Cout, K, _ in K3_SHAPES]


def _k3_grid(plan, G, C, Cout, K):
    """The kernel's grid: (C tiles x Cout tiles, splits, groups x offsets)
    and the Cout tile count."""
    ntiles = -(-Cout // plan.tn)
    cp = -(-C // 16) * 16
    return (-(-cp // K3_TC) * ntiles, plan.split, G * K ** 3), ntiles


@pytest.mark.parametrize("shape", K3_SHAPES, ids=K3_IDS)
def test_k3_plan_covers_every_dw_element_once(shape):
    _, G, N, NQ, C, Cout, K, Gw = shape
    plan = k3_plan(G, NQ, C, Cout, K)
    (gx, gy, gz), ntiles = _k3_grid(plan, G, C, Cout, K)
    # blockIdx.x -> (C tile, Cout tile): each (c, n) of a dW slice once
    cover = np.zeros((C, Cout), np.int64)
    for x in range(gx):
        ct, nt = divmod(x, ntiles)
        c0, n0 = ct * K3_TC, nt * plan.tn
        assert c0 < C and n0 < Cout          # no block without output
        cover[c0:c0 + K3_TC, n0:n0 + plan.tn] += 1
    assert (cover == 1).all()
    # blockIdx.z -> (group, offset): each once; a weight group gathers its
    # G / Gw groups and every split, by the reduce unless written directly
    go = np.zeros((G, K ** 3), np.int64)
    for z in range(gz):
        go[divmod(z, K ** 3)] += 1
    assert (go == 1).all()
    per_weight = np.bincount(np.arange(G) % Gw, minlength=Gw) * gy
    assert (per_weight == G // Gw * plan.split).all()
    direct = plan.split == 1 and G == Gw
    _, total, _ = _k3_scratch(G, N, NQ, C, Cout, Gw, K, shape[0] in "bfh",
                              plan.split)
    partials = 4 * plan.split * G * K ** 3 * C * Cout
    assert direct or total >= partials
    assert total < 0.5e9                     # the worst case at k9: ~0.48 GB
    assert gy <= 65535 and gz <= 65535


def _pair_range(n, split, s):
    """[begin, end) of split ``s`` of a list of ``n`` pairs, as
    ``spconv_k3_gemm`` cuts it: ceil(n / split) pairs a split."""
    per = -(-n // split)
    begin = min(n, s * per)
    return begin, min(n, begin + per)


@pytest.mark.parametrize("shape", K3_SHAPES, ids=K3_IDS)
def test_k3_pair_splits_cover_each_pair_once(shape):
    _, G, N, NQ, C, Cout, K, _ = shape
    plan = k3_plan(G, NQ, C, Cout, K)
    # a (group, offset) list holds at most NQ pairs
    for n in sorted({0, 1, K3_KP - 1, K3_KP, K3_KP + 1, NQ // 3, NQ - 1, NQ}):
        seen = np.zeros(n, np.int64)
        for s in range(plan.split):
            b, e = _pair_range(n, plan.split, s)
            assert 0 <= b <= e <= n
            seen[b:e] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("shape", K3_SHAPES, ids=K3_IDS)
def test_k3_plan_fills_the_card(shape):
    _, G, N, NQ, C, Cout, K, _ = shape
    plan = k3_plan(G, NQ, C, Cout, K)
    assert plan.tn == (64 if Cout <= 64 else 128)
    (gx, gy, gz), _ = _k3_grid(plan, G, C, Cout, K)
    waves = 2 * K1_SMS
    if gx * gz >= waves:
        assert plan.split == 1
    else:
        # split, into at least two waves unless a split per K3_KP queries
        assert plan.split > 1
        assert gx * gy * gz >= waves or plan.split == -(-NQ // K3_KP)
