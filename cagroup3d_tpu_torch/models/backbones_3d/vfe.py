"""Voxel feature encoder: MeanVFE.

Counterpart of ``MeanVFE`` in ``cagroup3d_tpu/models/backbones_3d/vfe.py``
(the reference's pcdet/models/backbones_3d/vfe/mean_vfe.py).  Points are
voxelized on the device (``unique_voxels``) and each voxel's feature is the
mean of its points' feature vectors, xyz included, so the backbone's input
channels equal ``num_point_features`` (4 on KITTI).  With
``max_points_per_voxel`` (the dataset's ``MAX_POINTS_PER_VOXEL``) only the
first points of a voxel in arrival order count, as spconv's voxelizer keeps
them (``core/voxelize.arrival_rank``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.module import Ctx
from ...core.sparse import SparseTensor
from ...core.voxelize import arrival_rank, unique_voxels


class MeanVFE(nn.Module):
    """Voxel feature = mean of its (capped) points' features; no
    parameters."""

    def __init__(self, model_cfg, num_point_features: int = 4,
                 max_points_per_voxel: Optional[int] = None):
        super().__init__()
        self.num_point_features = num_point_features
        self.max_points = max_points_per_voxel

    def forward(self, ctx: Ctx, points: torch.Tensor, pvalid: torch.Tensor,
                voxel_size, pc_range, cap: int) -> SparseTensor:
        """points [P, 3 + F] raw (x, y, z, intensity, ...) -> the stride-1
        voxel tensor in lattice units of ``voxel_size`` from ``pc_range``'s
        lower corner."""
        lo = torch.tensor(pc_range[:3], dtype=points.dtype,
                          device=points.device)
        vs = torch.tensor(voxel_size, dtype=points.dtype,
                          device=points.device)
        lat = torch.floor((points[:, :3] - lo) / vs).to(torch.int32)
        if self.max_points is not None:
            pvalid = pvalid & (arrival_rank(lat, pvalid) < self.max_points)
        st, _ = unique_voxels(lat, points[:, :self.num_point_features],
                              pvalid, cap, mode="mean", stats=ctx.stats,
                              stat_name="vfe")
        return st
