"""RBGNet utilities: ray generation, angle <-> class coding, the box coder
and axis-aligned 3D NMS.

Counterpart of ``cagroup3d_tpu/models/model_utils/rbgnet_utils.py``
(reference rbg_head.py generate_ray and aligned_3d_nms,
box_coder_utils.py RBGBBoxCoder).  ``aligned_3d_nms`` runs its greedy pass
on the device, batched over leading axes, with no host sync inside.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def generate_ray(ray_num: int) -> np.ndarray:
    """Quasi-uniform unit ray directions: rings of constant azimuthal angle
    with 4 * (n - |a|) (or 1) polar samples each."""
    n = int(math.ceil(np.sqrt((ray_num - 2) / 4)))
    azim_step = 0.5 * np.pi / n
    azim = 0.0
    rays = []
    for a in range(-n, n + 1):
        polar = 0.0
        size = (n - abs(a)) * 4 or 1
        step = 2 * math.pi / size
        for _ in range(size):
            polar += step
            r = np.sin(azim)
            rays.append([np.cos(polar) * r, np.sin(polar) * r, np.cos(azim)])
        azim += azim_step
    return np.array(rays)


def angle2class(angle: torch.Tensor, num_dir_bins: int):
    """Continuous angle -> (bin class, residual), mmdet3d convention; the
    angle modulo 2 pi with the divisor's sign, as JAX's ``%``."""
    angle = torch.remainder(angle, 2 * math.pi)
    width = 2 * math.pi / num_dir_bins
    shifted = angle + width / 2
    cls = torch.remainder(torch.floor(shifted / width).to(torch.int32),
                          num_dir_bins)
    res = shifted - (cls.to(angle.dtype) * width + width / 2)
    return cls, res


def class2angle(cls: torch.Tensor, res: torch.Tensor, num_dir_bins: int,
                limit_period: bool = True):
    width = 2 * math.pi / num_dir_bins
    angle = cls.to(res.dtype) * width + res
    if limit_period:
        angle = torch.where(angle > math.pi, angle - 2 * math.pi, angle)
    return angle


class RBGBBoxCoder:
    """Target encoding and direction decoding of the ray-based head."""

    def __init__(self, ray_num, num_dir_bins, num_sizes, with_rot=True):
        self.ray_num = ray_num
        self.num_dir_bins = num_dir_bins
        self.num_sizes = num_sizes
        self.with_rot = with_rot

    def encode(self, gt_boxes7: torch.Tensor, gt_labels: torch.Tensor):
        size = gt_boxes7[..., 3:6]
        scale = torch.linalg.vector_norm(size, dim=-1, keepdim=True)
        if self.with_rot:
            dir_cls, dir_res = angle2class(gt_boxes7[..., 6],
                                           self.num_dir_bins)
            dir_t = gt_boxes7[..., 6]
        else:
            dir_cls = torch.zeros_like(gt_labels)
            dir_res = torch.zeros_like(gt_boxes7[..., 6])
            dir_t = torch.zeros_like(gt_boxes7[..., 6])
        return dict(center=gt_boxes7[..., :3], size_half=size / 2,
                    dir_class=dir_cls, dir_res=dir_res, dir=dir_t,
                    size_class=gt_labels, size=size, scale_class=gt_labels,
                    scale=scale)

    def decode_dir(self, dir_cls_logits: torch.Tensor,
                   dir_res_norm: torch.Tensor):
        """[..., num_dir_bins] logits and normalized residuals -> angles."""
        cls = dir_cls_logits.argmax(-1)
        res = torch.gather(dir_res_norm * (math.pi / self.num_dir_bins), -1,
                           cls[..., None])[..., 0]
        return class2angle(cls, res, self.num_dir_bins)


def aligned_3d_nms(boxes6: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, valid: torch.Tensor,
                   thresh: float) -> torch.Tensor:
    """Greedy class-aware NMS over corner-format axis-aligned boxes
    (x1 y1 z1 x2 y2 z2) [..., n, 6] in stable descending score order.
    Returns the bool keep mask [..., n] in the input order."""
    n = boxes6.shape[-2]
    s = torch.where(valid, scores, torch.full_like(scores, -1e10))
    order = torch.argsort(-s, dim=-1, stable=True)
    b = torch.gather(boxes6, -2, order[..., None].expand_as(boxes6))
    cl = torch.gather(classes, -1, order)
    v = torch.gather(valid, -1, order)
    lo = torch.maximum(b[..., :, None, :3], b[..., None, :, :3])
    hi = torch.minimum(b[..., :, None, 3:6], b[..., None, :, 3:6])
    whd = torch.clamp(hi - lo, min=0.0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    ext = torch.clamp(b[..., 3:6] - b[..., :3], min=0.0)
    vol = ext[..., 0] * ext[..., 1] * ext[..., 2]
    iou = inter / torch.clamp(vol[..., :, None] + vol[..., None, :] - inter,
                              min=1e-9)
    iou = iou * (cl[..., :, None] == cl[..., None, :])
    over = iou > thresh
    keep = torch.zeros_like(v)
    suppressed = torch.zeros_like(v)
    for i in range(n):
        k = v[..., i] & ~suppressed[..., i]
        keep[..., i] = k
        suppressed |= k[..., None] & over[..., i, :]
    return torch.zeros_like(keep).scatter_(-1, order, keep)
