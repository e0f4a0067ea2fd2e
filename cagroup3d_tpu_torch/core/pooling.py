"""Sparse average pooling and lattice interpolation.

Counterpart of ``cagroup3d_tpu/core/pooling.py``:

* avg_pool: ME ``MinkowskiAvgPooling(kernel_size=k, stride=s)`` for the
  DAPPM pyramid with k == 2*s + 1, so each input voxel lies in the window
  of at most 3^3 output cells; the mean is over the inputs present, each
  cell's sum in a fixed order (``gather.segment_sum``; the JAX package's
  membership matmul fixes its order too).
* interpolate_at: ME ``features_at_coordinates``, trilinear on the source
  stride lattice; absent corners contribute zero without renormalization.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .gather import segment_sum, take_rows_masked
from .hashing import build_index, lookup
from .sparse import SparseTensor, zero_invalid
from .voxelize import floor_div, stride_reduce_coords

_DELTAS = np.array(list(itertools.product((-1, 0, 1), repeat=3)), np.int32)
_CORNERS = np.array(list(itertools.product((0, 1), repeat=3)), np.int32)


def avg_pool(src: SparseTensor, kernel_size: int, factor: int,
             out_cap: int) -> SparseTensor:
    """Strided average pooling with kernel == 2*factor + 1."""
    if kernel_size != 2 * factor + 1:
        raise ValueError(f"avg_pool needs kernel == 2*stride+1, got "
                         f"k={kernel_size}, s={factor}")
    out, _ = stride_reduce_coords(src, factor, out_cap)
    lattice = out.stride
    half = (kernel_size // 2) * src.stride
    sorted_keys, row_of_rank = build_index(floor_div(out.coords, lattice),
                                           out.valid)
    base = floor_div(src.coords, lattice)
    feats = src.masked_feats().to(torch.float32)
    dev = feats.device
    slots = []
    for d in _DELTAS:
        cand_lat = base + torch.as_tensor(d, device=dev)
        in_window = torch.all((src.coords - cand_lat * lattice).abs() <= half,
                              dim=-1)
        row = lookup(sorted_keys, row_of_rank, cand_lat, src.valid & in_window)
        slots.append(torch.where(row >= 0, row, torch.full_like(row, out.cap)))
    slot = torch.cat(slots).long()             # offset-major (offset, source)
    src_rows = torch.arange(src.cap, device=dev).repeat(len(_DELTAS))
    ssum = segment_sum(feats, slot, out.cap + 1, rows=src_rows)
    cnt = torch.zeros(out.cap + 1, dtype=torch.long, device=dev)
    cnt.index_add_(0, slot, torch.ones_like(slot))          # integers: exact
    mean = ssum[:out.cap] / cnt[:out.cap].clamp(min=1)[:, None]
    return SparseTensor(out.coords, zero_invalid(mean, out.valid), out.valid,
                        out.stride)


def interpolate_at(src: SparseTensor, query: torch.Tensor,
                   query_valid: torch.Tensor) -> torch.Tensor:
    """Trilinear features at float raw-unit coordinates query [Q, 3];
    corner rows are gathered in bf16 (as in the JAX package) and weighted
    in f32.  Returns [Q, C]."""
    sorted_keys, row_of_rank = build_index(floor_div(src.coords, src.stride),
                                           src.valid)
    p = query / src.stride
    c0 = torch.floor(p).to(torch.int32)
    frac = p - c0
    feats = src.masked_feats().to(torch.bfloat16)
    dev = query.device
    out = torch.zeros(query.shape[0], src.num_channels, dtype=torch.float32,
                      device=dev)
    for corner in _CORNERS:
        cc = torch.as_tensor(corner, device=dev)
        w = torch.prod(torch.where(cc[None, :] == 1, frac, 1.0 - frac), dim=-1)
        row = lookup(sorted_keys, row_of_rank, c0 + cc[None, :], query_valid)
        out += take_rows_masked(feats, row).to(torch.float32) * w[:, None]
    return zero_invalid(out, query_valid)
