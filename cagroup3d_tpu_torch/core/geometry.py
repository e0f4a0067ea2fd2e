"""Box geometry for the axis-aligned (ScanNet) path.

Counterpart of the parts of ``cagroup3d_tpu/core/geometry.py`` that the
ScanNet forward and training use: the z rotations, axis-aligned BEV IoU
(NMS) and the z-overlap / axis-aligned 3D IoU.  Box convention: (x, y, z,
dx, dy, dz, heading), heading rotating x toward y about +z (pcdet).
ScanNet boxes have heading 0, where the rotated 3D IoU of the proposal
target layer equals the axis-aligned one (``iou3d_rotated_zero_yaw``); the
polygon clipping of headed boxes belongs to the SUN RGB-D yaw path and is
not ported yet.
"""
from __future__ import annotations

import torch


def rotate_points_along_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """points [..., N, 3+C] rotated by angle [...] (pcdet semantics)."""
    cosa, sina = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    xr = x * cosa - y * sina
    yr = x * sina + y * cosa
    return torch.cat([xr[..., None], yr[..., None], points[..., 2:]], dim=-1)


def rotation_3d_in_axis(points: torch.Tensor, angles: torch.Tensor,
                        axis: int = 2) -> torch.Tensor:
    """points [N, M, 3] rotated by angles [N] about ``axis`` (the
    reference's cagroup_utils.rotation_3d_in_axis: points @ R)."""
    s, c = torch.sin(angles), torch.cos(angles)
    ones, zeros = torch.ones_like(c), torch.zeros_like(c)
    if axis == 1:
        rows = [[c, zeros, -s], [zeros, ones, zeros], [s, zeros, c]]
    elif axis in (2, -1):
        rows = [[c, -s, zeros], [s, c, zeros], [zeros, zeros, ones]]
    elif axis == 0:
        rows = [[zeros, c, -s], [zeros, s, c], [ones, zeros, zeros]]
    else:
        raise ValueError(axis)
    rot = torch.stack([torch.stack(r, -1) for r in rows], -2)   # [N, 3, 3]
    return torch.einsum("amj,ajk->amk", points, rot)


def iou_bev_aligned(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV IoU ignoring heading (CUDA iou_normal)."""
    lo = torch.maximum(a7[..., :2] - a7[..., 3:5] / 2,
                       b7[..., :2] - b7[..., 3:5] / 2)
    hi = torch.minimum(a7[..., :2] + a7[..., 3:5] / 2,
                       b7[..., :2] + b7[..., 3:5] / 2)
    wh = (hi - lo).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    sa = a7[..., 3] * a7[..., 4]
    sb = b7[..., 3] * b7[..., 4]
    return inter / (sa + sb - inter).clamp(min=1e-8)


def z_overlap(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    zmax = torch.minimum(a7[..., 2] + a7[..., 5] / 2, b7[..., 2] + b7[..., 5] / 2)
    zmin = torch.maximum(a7[..., 2] - a7[..., 5] / 2, b7[..., 2] - b7[..., 5] / 2)
    return (zmax - zmin).clamp(min=0.0)


def iou3d_aligned(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """Axis-aligned 3D IoU."""
    lo = torch.maximum(a7[..., :3] - a7[..., 3:6] / 2,
                       b7[..., :3] - b7[..., 3:6] / 2)
    hi = torch.minimum(a7[..., :3] + a7[..., 3:6] / 2,
                       b7[..., :3] + b7[..., 3:6] / 2)
    whd = (hi - lo).clamp(min=0.0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    va = torch.prod(a7[..., 3:6], dim=-1)
    vb = torch.prod(b7[..., 3:6], dim=-1)
    return inter / (va + vb - inter).clamp(min=1e-8)


def pairwise(fn, a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """[..., N, 7] x [..., M, 7] -> [..., N, M] for any IoU above."""
    return fn(a7[..., :, None, :], b7[..., None, :, :])


def iou3d_rotated_zero_yaw(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """The rotated 3D IoU (boxes_iou3d_gpu) of boxes whose headings are all
    zero, where it is the axis-aligned IoU.  Raises on a non-zero heading:
    rotated boxes need the polygon clipping of the SUN RGB-D slice."""
    if bool((a7[..., 6] != 0).any()) or bool((b7[..., 6] != 0).any()):
        raise NotImplementedError(
            "rotated 3D IoU of headed boxes (polygon clipping) comes with "
            "the SUN RGB-D yaw slice; ScanNet boxes have heading 0")
    return iou3d_aligned(a7, b7)
