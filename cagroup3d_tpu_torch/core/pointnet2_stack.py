"""Voxel-hash neighbour queries of the pointnet2_stack op family.

Counterpart of the voxel-query part of ``cagroup3d_tpu/core/
pointnet2_stack.py`` (the reference's voxel_query_gpu.cu, used by Voxel
R-CNN's RoI grid pool).  A lattice offset addresses at most one voxel, so
"the voxels near a query" is a static list of offsets, each looked up in
the sorted-key index of the source voxels (``core/hashing.build_index`` /
``lookup``).  A query whose lattice coordinate plus offset falls outside
the packable range of the current key bits packs to ``INVALID_KEY`` and
comes back as -1, never as another voxel's row.  ``vector_pool``
(PV-RCNN++) is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from .hashing import build_index, lookup


def _cube(r: int) -> np.ndarray:
    """Every lattice offset of [-r, r]^3 in scan order (x-major, z
    fastest): i32[(2r + 1)^3, 3]."""
    a = np.arange(-r, r + 1)
    return np.stack(np.meshgrid(a, a, a, indexing="ij"),
                    -1).reshape(-1, 3).astype(np.int32)


def nearest_offsets(max_range: int, cap: int) -> np.ndarray:
    """The ``cap`` lattice offsets of [-r, r]^3 closest to the origin, ties
    in scan order (x-major, z fastest): i32[min(cap, (2r + 1)^3), 3].  The
    static counterpart of the reference's "first nsample found"."""
    offs = _cube(max_range)
    order = np.argsort((offs ** 2).sum(-1), kind="stable")
    return offs[order[:min(cap, len(offs))]]


def voxel_query_offsets(voxel_coords: torch.Tensor, voxel_valid: torch.Tensor,
                        queries_lat: torch.Tensor, qvalid: torch.Tensor,
                        offsets) -> torch.Tensor:
    """The voxel row at each query lattice coordinate queries_lat [M, 3]
    plus each offset [K, 3], among voxel_coords [N, 3] (lattice units,
    duplicate-free where valid): i64[M, K], -1 where absent, where the
    query is invalid or where the coordinate cannot be packed."""
    sorted_keys, row_of_rank = build_index(voxel_coords, voxel_valid)
    offs = torch.as_tensor(np.asarray(offsets), dtype=torch.int32,
                           device=queries_lat.device)
    q = queries_lat.to(torch.int32)[:, None, :] + offs[None, :, :]
    return lookup(sorted_keys, row_of_rank, q,
                  qvalid[:, None].expand(q.shape[:2]))


def voxel_query(voxel_coords: torch.Tensor, voxel_valid: torch.Tensor,
                queries_lat: torch.Tensor, qvalid: torch.Tensor,
                max_range: int = 1) -> torch.Tensor:
    """Every offset of [-max_range, max_range]^3, in scan order:
    i64[M, (2r + 1)^3] rows (-1 = absent)."""
    return voxel_query_offsets(voxel_coords, voxel_valid, queries_lat,
                               qvalid, _cube(max_range))
