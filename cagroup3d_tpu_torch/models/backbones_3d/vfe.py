"""Voxel feature encoders: MeanVFE and PillarVFE.

Counterpart of ``MeanVFE`` in ``cagroup3d_tpu/models/backbones_3d/vfe.py``
(the reference's pcdet/models/backbones_3d/vfe/mean_vfe.py).  Points are
voxelized on the device (``unique_voxels``) and each voxel's feature is the
mean of its points' feature vectors, xyz included, so the backbone's input
channels equal ``num_point_features`` (4 on KITTI).  With
``max_points_per_voxel`` (the dataset's ``MAX_POINTS_PER_VOXEL``) only the
first points of a voxel in arrival order count, as spconv's voxelizer keeps
them (``core/voxelize.arrival_rank``).

``PillarVFE`` (the JAX package's ``PillarVFE``, the reference's
pillar_vfe.py) collapses z into one cell per pillar and decorates each
kept point with its offsets from its pillar's point mean and from the
pillar's centre, then one linear layer, BN (momentum 0.01, eps 1e-3) and
ReLU per ``NUM_FILTERS`` entry, and the per-pillar max.  The per-pillar
sums and counts are ``core/gather.segment_sum`` (fixed order, so two
calls give the same bits on the card) and the max a ``scatter_reduce``
``amax`` (exact in any order).  In training the BN takes the statistics
of every scene's kept points (``Ctx.sync``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.gather import segment_sum
from ...core.module import (Ctx, apply_bn, flat_state, init_bn, init_linear,
                            register_flat)
from ...core.sparse import SparseTensor
from ...core.voxelize import arrival_rank, unique_voxels


class MeanVFE(nn.Module):
    """Voxel feature = mean of its (capped) points' features; no
    parameters."""

    def __init__(self, model_cfg, num_point_features: int = 4,
                 max_points_per_voxel: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()           # no parameters: ``generator`` unused
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


class PillarVFE(nn.Module):
    """Parameters under the JAX package's names:
    ``pfn_layers.{i}.linear.weight`` [Cin, Cout] (no bias) and
    ``pfn_layers.{i}.norm.*``."""

    def __init__(self, model_cfg, num_point_features: int = 4,
                 max_points_per_voxel: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = model_cfg
        self.with_distance = bool(c.get("WITH_DISTANCE", False))
        self.use_absolute_xyz = bool(c.get("USE_ABSLOTE_XYZ",
                                           c.get("USE_ABSOLUTE_XYZ", True)))
        self.num_filters = [int(x) for x in c.NUM_FILTERS]
        self.n_in = num_point_features + 6 + int(self.with_distance) - \
            (0 if self.use_absolute_xyz else 3)
        self.num_point_features = self.num_filters[-1]
        self.max_points = max_points_per_voxel
        gen = generator or torch.Generator().manual_seed(0)
        P, S = {}, {}
        chans = [self.n_in] + self.num_filters
        for i in range(len(self.num_filters)):
            init_linear(P, gen, f"pfn_layers.{i}.linear", chans[i],
                        chans[i + 1], bias=False, init="xavier")
            init_bn(P, S, f"pfn_layers.{i}.norm", chans[i + 1])
        register_flat(self, P, S)

    def forward(self, ctx: Ctx, points: torch.Tensor, pvalid: torch.Tensor,
                voxel_size, pc_range, cap: int,
                prefix: str = "vfe") -> SparseTensor:
        """points [P, 3 + F] raw -> the pillars (coords (x, y, 0)) with
        their max-pooled point features; ``prefix`` names this module's
        parameters in the model (their BN updates go to ``ctx.updates``
        under it)."""
        P, S = flat_state(self, prefix)
        dt, dev = points.dtype, points.device
        lo = torch.tensor(pc_range[:3], dtype=dt, device=dev)
        vs = torch.tensor(voxel_size, dtype=dt, device=dev)
        xyz = points[:, :3]
        lat = torch.floor((xyz - lo) / vs).to(torch.int32)
        lat = torch.cat([lat[:, :2], torch.zeros_like(lat[:, 2:])], dim=-1)
        if self.max_points is not None:
            pvalid = pvalid & (arrival_rank(lat, pvalid) < self.max_points)
        st, inv = unique_voxels(lat, points[:, :1] * 0, pvalid, cap,
                                mode="mean", stats=ctx.stats,
                                stat_name="vfe")
        seg = torch.where(inv >= 0, inv, torch.full_like(inv, cap))
        cnt = segment_sum(pvalid.to(dt)[:, None], seg, cap + 1)[:, 0]
        xyz_sum = segment_sum(torch.where(pvalid[:, None], xyz,
                                          torch.zeros_like(xyz)), seg,
                              cap + 1)
        mean_xyz = xyz_sum / cnt.clamp(min=1.0)[:, None]
        f_cluster = xyz - mean_xyz[inv.clamp(0, cap - 1).long()]
        f_center = xyz - ((lat.to(dt) + 0.5) * vs + lo)
        parts = [xyz, points[:, 3:]] if self.use_absolute_xyz \
            else [points[:, 3:]]
        parts += [f_cluster, f_center]
        if self.with_distance:
            parts.append(torch.linalg.norm(xyz, dim=1, keepdim=True))
        x = torch.cat(parts, dim=-1)
        ok = pvalid & (inv >= 0)
        for i in range(len(self.num_filters)):
            pre = f"{prefix}.pfn_layers.{i}"
            x = apply_bn(P, S, ctx, pre + ".norm",
                         x @ P[pre + ".linear.weight"], ok, eps=1e-3,
                         momentum=0.01)
            x = torch.where(ok[:, None], torch.relu(x), torch.zeros_like(x))
        C = x.shape[-1]
        pooled = torch.full((cap + 1, C), -1e10, dtype=x.dtype,
                            device=dev).scatter_reduce(
            0, seg.long()[:, None].expand(-1, C),
            torch.where(ok[:, None], x, torch.full_like(x, -1e10)), "amax")
        pooled = torch.where(st.valid[:, None], pooled[:cap],
                             torch.zeros_like(pooled[:cap]))
        return SparseTensor(st.coords, pooled, st.valid, 1)
