"""mmdet-style losses (reference pcdet/utils/loss_utils.py, iou3d_loss.py).

Counterpart of ``cagroup3d_tpu/utils/loss_utils.py`` for CAGroup3D.  Static shapes: callers pass element weights/masks instead
of boolean indexing, and ``avg_factor`` is an explicit normalizer.  Ignored
labels are -1, which maps to an all-zero one-hot (pure background in the
focal loss, the reference's ``target[target < 0] = num_classes``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.geometry import iou3d_aligned, iou3d_rotated

_EPS = float(torch.finfo(torch.float32).eps)


def _reduce(loss, avg_factor, loss_weight=1.0):
    s = loss.sum()
    if avg_factor is not None:
        return loss_weight * s / (avg_factor + _EPS)
    return loss_weight * s / loss.numel()


def _bce_logits(pred, target):
    return pred.clamp(min=0) - pred * target + torch.log1p(
        torch.exp(-pred.abs()))


def sigmoid_focal_loss(pred, target_onehot, weight=None, gamma=2.0,
                       alpha=0.25, avg_factor=None):
    """pred [N, C] logits; target_onehot [N, C] in {0, 1}."""
    p = torch.sigmoid(pred)
    t = target_onehot
    pt = (1 - p) * t + p * (1 - t)
    focal_w = (alpha * t + (1 - alpha) * (1 - t)) * pt ** gamma
    loss = _bce_logits(pred, t) * focal_w
    if weight is not None:
        if weight.dim() < loss.dim():
            weight = weight[..., None]
        loss = loss * weight
    return _reduce(loss, avg_factor)


def focal_loss_with_labels(pred, labels, weight=None, gamma=2.0, alpha=0.25,
                           avg_factor=None, loss_weight=1.0):
    """labels i64/i32[N] in [-1, C); -1 == background (all-zero one-hot)."""
    C = pred.shape[-1]
    lab = torch.where(labels < 0, torch.full_like(labels, C), labels)
    oh = F.one_hot(lab.long(), C + 1)[..., :C].to(pred.dtype)
    return loss_weight * sigmoid_focal_loss(pred, oh, weight, gamma, alpha,
                                            avg_factor)


def binary_cross_entropy(pred, target, weight=None, avg_factor=None,
                         loss_weight=1.0):
    """Sigmoid BCE with logits (CrossEntropy use_sigmoid=True path)."""
    loss = _bce_logits(pred, target)
    if weight is not None:
        while weight.dim() < loss.dim():
            weight = weight[..., None]
        loss = loss * weight
    return _reduce(loss, avg_factor, loss_weight)


def smooth_l1(pred, target, weight=None, beta=1.0, reduction="mean",
              avg_factor=None, loss_weight=1.0):
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss_weight * loss
    if avg_factor is not None or reduction != "sum":
        return _reduce(loss, avg_factor, loss_weight)
    return loss_weight * loss.sum()


def weighted_smooth_l1(pred, target, weights=None, beta=1.0 / 9.0,
                       code_weights=None):
    """pcdet WeightedSmoothL1Loss: elementwise, no reduction; nan targets
    ignored."""
    target = torch.where(torch.isnan(target), pred, target)
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)[None, :]
    n = diff.abs()
    if beta < 1e-5:
        loss = n
    else:
        loss = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def iou3d_loss(pred7, target7, weight=None, avg_factor=None, with_yaw=True,
               loss_weight=1.0):
    """1 - IoU3D over pred/target [N, 6|7]: rotated (cal_iou_3d,
    differentiable through the polygon clipping) with ``with_yaw``, else
    axis-aligned (AxisAlignedBboxOverlaps3D); weight [N]."""
    iou_fn = iou3d_rotated if with_yaw else iou3d_aligned
    loss = 1.0 - iou_fn(pred7, target7)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, avg_factor, loss_weight)
