"""Masked row gathers.

Counterpart of ``cagroup3d_tpu/core/gather.py``.  The JAX helpers exist
to reach a fast TPU gather shape; here a gather is plain indexing, and the
one thing to keep is the JAX package's index discipline: indices are
clamped before the gather (CUDA would raise on an out-of-range index where
JAX clamps or fills) and masked after it.
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
