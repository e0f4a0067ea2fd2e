"""FCOS-style target assigner for the CAGroup3D one-stage head.

Counterpart of ``cagroup3d_tpu/models/dense_heads/target_assigner/
cagroup3d_assigner.py``: per class, candidate points are matched to GT
boxes by (1) an inside-box test, (2) a top-k centerness filter per box
(TOPK=18), (3) a min-volume tie-break (ties to the lower box index).  The
class axis is a tensor axis over the stacked [n_cls, N, ...] point sets.

GT comes padded: boxes [G, 7], labels [G], gt_valid [G].
"""
from __future__ import annotations

import torch

from ....core.geometry import rotation_3d_in_axis

FLOAT_MAX = 1e8


def _bbox_targets(points, boxes7):
    """points [..., N, 3], boxes [G, 7] -> targets [..., N, G, 7]
    (dx_min, dx_max, dy_min, dy_max, dz_min, dz_max, yaw)."""
    lead = points.shape[:-2]
    pts = points.reshape(-1, 3)
    shift = pts[:, None, :] - boxes7[None, :, :3]                 # [M, G, 3]
    local = rotation_3d_in_axis(shift.transpose(0, 1), -boxes7[:, 6],
                                axis=2).transpose(0, 1)          # [M, G, 3]
    centers = boxes7[None, :, :3] + local
    half = boxes7[None, :, 3:6] / 2
    d_min = centers - (boxes7[None, :, :3] - half)
    d_max = (boxes7[None, :, :3] + half) - centers
    t = torch.stack([d_min[..., 0], d_max[..., 0], d_min[..., 1],
                     d_max[..., 1], d_min[..., 2], d_max[..., 2],
                     boxes7[None, :, 6].expand_as(d_min[..., 0])], dim=-1)
    return t.reshape(*lead, points.shape[-2], boxes7.shape[0], 7)


def compute_centerness(bbox_targets):
    x = bbox_targets[..., 0:2]
    y = bbox_targets[..., 2:4]
    z = bbox_targets[..., 4:6]
    c = (x.amin(-1) / x.amax(-1).clamp(min=1e-12) *
         y.amin(-1) / y.amax(-1).clamp(min=1e-12) *
         z.amin(-1) / z.amax(-1).clamp(min=1e-12))
    return torch.sqrt(c.clamp(min=0.0))


def find_points_in_boxes(points, points_valid, boxes7, boxes_valid):
    """bool [N, G]: point strictly inside the box."""
    t = _bbox_targets(points, boxes7)
    inside = t[..., :6].amin(-1) > 0
    return inside & points_valid[:, None] & boxes_valid[None, :]


class CAGroup3DAssigner:
    def __init__(self, cfg):
        self.limit = cfg.LIMIT
        self.topk = cfg.TOPK
        self.n_scales = cfg.N_SCALES

    def assign(self, points, points_valid, gt_boxes, gt_labels, gt_valid):
        """points [n_cls, N, 3] (+valid) against the scene's padded GT.

        Returns (centerness_targets [n_cls, N], bbox_targets
        [n_cls, N, 7], labels i32[n_cls, N]; label -1 = background)."""
        n_cls, N = points.shape[:2]
        cls_id = torch.arange(n_cls, device=points.device)
        sel = gt_valid[None, :] & (gt_labels[None, :] == cls_id[:, None])
        t = _bbox_targets(points, gt_boxes)                   # [n, N, G, 7]
        inside = (t[..., :6].amin(-1) > 0) & sel[:, None, :] & \
            points_valid[..., None]
        center = compute_centerness(t)
        center = torch.where(inside, center, torch.full_like(center, -1.0))
        k = min(self.topk + 1, N)
        top = torch.topk(center.transpose(1, 2), k, dim=-1).values[..., -1]
        inside_top = center > top[:, None, :]

        volumes = gt_boxes[:, 3:6].prod(-1)
        vol = volumes[None, None, :].expand_as(center)
        vol = torch.where(inside & inside_top, vol,
                          torch.full_like(vol, FLOAT_MAX))
        min_vol, min_idx = vol.amin(-1), vol.argmin(-1)   # ties: lower box
        labels = torch.where((min_vol < FLOAT_MAX) & points_valid,
                             gt_labels[min_idx],
                             torch.full_like(min_idx, -1)).to(torch.int32)
        bt = torch.gather(t, 2, min_idx[..., None, None].expand(
            -1, -1, 1, 7))[:, :, 0]
        ct = compute_centerness(bt)
        gt_t = gt_boxes[min_idx]
        has_cls = sel.any(1)[:, None]
        ct = torch.where(has_cls & (labels >= 0), ct, torch.zeros_like(ct))
        gt_t = torch.where(has_cls[..., None], gt_t, torch.zeros_like(gt_t))
        return ct, gt_t, labels

    @staticmethod
    def assign_semantic(points, points_valid, gt_boxes, gt_labels, gt_valid,
                        n_classes):
        """Per-voxel semantic and instance labels.  Returns (labels
        i32[N] with -1 background, ins_labels i32[N] with 0 background)."""
        inside = find_points_in_boxes(points, points_valid, gt_boxes,
                                      gt_valid)
        volumes = gt_boxes[:, 3:6].prod(-1)
        vol = torch.where(inside, volumes[None, :].expand_as(inside).to(
            gt_boxes.dtype), torch.full(inside.shape, FLOAT_MAX,
                                        dtype=gt_boxes.dtype,
                                        device=gt_boxes.device))
        min_vol, min_idx = vol.amin(-1), vol.argmin(-1)   # ties: lower box
        labels = torch.where(min_vol < FLOAT_MAX, gt_labels[min_idx],
                             torch.full_like(min_idx, -1)).to(torch.int32)
        bk = inside.any(1)
        ins = (min_idx.to(torch.int32) + 1) * bk.to(torch.int32)
        return labels, ins
