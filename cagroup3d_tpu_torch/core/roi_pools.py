"""Points in rotated boxes.

Counterpart of ``points_in_boxes`` in ``cagroup3d_tpu/core/roi_pools.py``
(the reference's roiaware_pool3d points-in-boxes test): a point is inside
a box (x, y, z centre, dx, dy, dz, heading) when its offset from the
centre, rotated into the box's frame, lies strictly within half of each
extent.  The RoI pooling ops of that module are not ported.
"""
from __future__ import annotations

import torch


def points_in_boxes(points: torch.Tensor, pvalid: torch.Tensor,
                    rois: torch.Tensor, rvalid: torch.Tensor) -> torch.Tensor:
    """points [N, 3], rois [R, 7] -> bool [R, N]: the valid point strictly
    inside the valid box."""
    rel = points[None, :, :] - rois[:, None, :3]
    c, s = torch.cos(-rois[:, 6])[:, None], torch.sin(-rois[:, 6])[:, None]
    local = torch.stack([rel[..., 0] * c - rel[..., 1] * s,
                         rel[..., 0] * s + rel[..., 1] * c, rel[..., 2]], -1)
    inside = (local.abs() < rois[:, None, 3:6] / 2).all(dim=-1)
    return inside & pvalid[None, :] & rvalid[:, None]
