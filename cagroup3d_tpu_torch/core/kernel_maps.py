"""Kernel-map construction: per-offset neighbour tables.

Counterpart of ``cagroup3d_tpu/core/kernel_maps.py``.  A neighbour table
``nbr[K, N_tgt]`` holds the source row at ``tgt + offset`` (-1 = absent),
found by binary search in the source's sorted packed keys.

Offset enumeration: ``itertools.product`` over x, y, z with z fastest; odd
kernels centred (-k//2..k//2), even kernels 0..k-1 (ME's convention).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .hashing import build_index, lookup
from .sparse import SparseTensor


def kernel_offsets(kernel_size: int, dilation: int = 1) -> np.ndarray:
    """Static [K^3, 3] integer offsets in lattice units (z fastest)."""
    if kernel_size % 2 == 1:
        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = range(0, kernel_size)
    offs = np.array(list(itertools.product(r, r, r)), dtype=np.int32)
    return offs * dilation


def conv_offsets(kernel_size: int, src_stride: int) -> np.ndarray:
    """Offsets for a (possibly strided) convolution: input-stride units."""
    return kernel_offsets(kernel_size) * src_stride


def transpose_offsets(kernel_size: int, out_stride: int) -> np.ndarray:
    """Offsets for a (generative) transposed conv, negated so that
    ``neighbor_table(src, tgt + off)`` finds the parent input voxel."""
    return -kernel_offsets(kernel_size) * out_stride


def neighbor_table(src: SparseTensor, tgt_coords: torch.Tensor,
                   tgt_valid: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """nbr i32[K, N_tgt]: source row at ``tgt + offset`` (raw units), -1
    when absent or when the target is not on the source stride lattice."""
    s = src.stride
    sorted_keys, row_of_rank = build_index(
        torch.div(src.coords, s, rounding_mode="floor"), src.valid)
    offs = torch.as_tensor(offsets, dtype=torch.int32,
                           device=tgt_coords.device)
    q = tgt_coords[None, :, :] + offs[:, None, :]                 # [K, N, 3]
    div_ok = torch.all(torch.remainder(q, s) == 0, dim=-1)
    q_lat = torch.div(q, s, rounding_mode="floor")
    return lookup(sorted_keys, row_of_rank, q_lat,
                  div_ok & tgt_valid[None, :]).to(torch.int32)


def neighbor_table_grouped(src: SparseTensor, tgt_coords: torch.Tensor,
                           tgt_valid: torch.Tensor, kernel_size: int
                           ) -> torch.Tensor:
    """nbr i32[K^3, N] for an odd kernel whose offsets are multiples of the
    source stride, targets floor-divided onto the source lattice (the JAX
    package's z-run window form; a binary search per offset costs the same
    here, so it is the per-offset table)."""
    s = src.stride
    base = torch.div(tgt_coords, s, rounding_mode="floor") * s
    return neighbor_table(src, base, tgt_valid,
                          conv_offsets(kernel_size, s))
