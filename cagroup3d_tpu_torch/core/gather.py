"""Masked row gathers.

Counterpart of ``cagroup3d_tpu/core/gather.py``.  The JAX helpers exist
to reach a fast TPU gather shape; here a gather is plain indexing, and the
one thing to keep is the JAX package's index discipline: indices are
clamped before the gather (CUDA would raise on an out-of-range index where
JAX clamps or fills) and masked after it.  ``segment_sum`` is the port's
float scatter-add: it adds in a fixed order where ``index_add_`` on CUDA
adds with atomics in whatever order the threads run.
"""
from __future__ import annotations

import torch

from .sparse import zero_invalid


def take1(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [N] gathered at idx [...] (clamped into range) -> [...]."""
    return a[idx.clamp(0, a.shape[0] - 1).long()]


def take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [N, C] row-gathered at idx [...] (clamped) -> [..., C]."""
    return a[idx.clamp(0, a.shape[0] - 1).long()]


def take_rows_masked(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a at idx, zero where idx < 0."""
    return zero_invalid(take_rows(a, idx), idx >= 0)


def segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int,
                rows=None) -> torch.Tensor:
    """Per-segment sums of the rows of values [P, F] (or, given ``rows``
    [Q], of the rows ``values[rows]``) by segment id ``seg`` [P or Q] in
    [0, n) -> [n, F].  Each segment adds its rows in row order (a stable
    sort by segment, then one sequential sum per segment), so a call gives
    the same bits every time on every device, and the CPU the same bits as
    ``index_add_``.  Differentiable."""
    seg = seg.long()
    order = torch.argsort(seg, stable=True)
    src = order if rows is None else rows.long()[order]
    lengths = torch.zeros(n, dtype=torch.long, device=seg.device)
    lengths.index_add_(0, seg, torch.ones_like(seg))      # integers: exact
    return torch.segment_reduce(values[src], "sum", lengths=lengths, axis=0,
                                unsafe=True)
