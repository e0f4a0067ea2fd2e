"""K1's plan table (``ops/sparse_conv.k1_plan``) at the main path's shapes.

The kernel (``csrc/sparse_conv.cu::spconv_k1_gemm``) reads a plan as its
grid: blockIdx.x takes 64 queries, blockIdx.y a (column group, offset
split) pair, blockIdx.z the group; a column group walks ``col_inner``
column tiles of ``tn`` columns with one kernel map, a split takes
``per_split`` kernel offsets.  For every launch shape of the full-width
ScanNet model -- the 16 distinct shapes of the 39 K1 calls of the eval
forward and of a training step's forward, and the 15 of the 38 feature
backward calls (K1 on the transposed problem) -- the blocks must cover
each (query, column, offset) exactly once, and the offsets must split
wherever the grid would be under two waves of the card's SMs.  Pure
Python, a few milliseconds.
"""
import numpy as np
import pytest

from cagroup3d_tpu_torch.ops.sparse_conv import K1_SMS, K1_TQ, k1_plan

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
SHAPES = [("fwd",) + s for s in FORWARD] + \
    [("bwd",) + s for s in FEATURE_BACKWARD]
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
