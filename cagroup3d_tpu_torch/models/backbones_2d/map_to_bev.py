"""Sparse -> dense BEV: HeightCompression and PointPillarScatter.

Counterpart of ``HeightCompression`` in
``cagroup3d_tpu/models/backbones_2d/map_to_bev.py`` (the reference's
pcdet/models/backbones_2d/map_to_bev/height_compression.py): the final
sparse level is scattered into a dense [D, H, W, C] grid (its rows are
unique, so the scatter is exact) and z folded into channels.  The channel
order is the JAX package's, z-major (channel d * C + c), not the
reference's C-major; the map comes out channels-first, [D*C, H, W], for
the 2-D convs.  ``PointPillarScatter`` (the reference's
pointpillar_scatter.py) scatters the pillars of a one-cell-high lattice
into a dense [C, H, W] map.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.sparse import SparseTensor


def scatter_dense(st: SparseTensor, grid_dhw) -> torch.Tensor:
    """coords (x, y, z) lattice -> dense [D(z), H(y), W(x), C]; rows
    outside the grid or invalid are dropped."""
    D, H, W = grid_dhw
    C = st.num_channels
    x, y, z = st.coords.unbind(-1)
    ok = st.valid & (x >= 0) & (x < W) & (y >= 0) & (y < H) & \
        (z >= 0) & (z < D)
    flat = torch.where(ok, (z * H + y) * W + x,
                       torch.full_like(x, D * H * W)).long()
    dense = torch.zeros(D * H * W + 1, C, dtype=st.feats.dtype,
                        device=st.feats.device)
    # invalid rows all land on the dump row, sliced away
    dense[flat] = torch.where(ok[:, None], st.feats,
                              torch.zeros_like(st.feats))
    return dense[:-1].reshape(D, H, W, C)


class HeightCompression(nn.Module):
    def __init__(self, model_cfg):
        super().__init__()
        self.num_bev_features = int(model_cfg.NUM_BEV_FEATURES)

    def forward(self, st: SparseTensor, grid_xyz) -> torch.Tensor:
        """grid_xyz: (W, H, D) of the final sparse lattice -> the BEV map
        [D*C, H, W] (channel d * C + c)."""
        W, H, D = grid_xyz
        C = st.num_channels
        if D * C != self.num_bev_features:
            raise ValueError(f"BEV features {D} x {C} != "
                             f"{self.num_bev_features}")
        dense = scatter_dense(st, (D, H, W))               # [D, H, W, C]
        return dense.permute(0, 3, 1, 2).reshape(D * C, H, W)


class PointPillarScatter(nn.Module):
    def __init__(self, model_cfg):
        super().__init__()
        self.num_bev_features = int(model_cfg.NUM_BEV_FEATURES)

    def forward(self, st: SparseTensor, grid_xyz) -> torch.Tensor:
        """grid_xyz: (W, H, 1) of the pillar lattice -> [C, H, W]."""
        W, H, _ = grid_xyz
        return scatter_dense(st, (1, H, W))[0].permute(2, 0, 1)
