"""mmdet-style losses (reference pcdet/utils/loss_utils.py, iou3d_loss.py).

Counterpart of ``cagroup3d_tpu/utils/loss_utils.py`` for CAGroup3D,
RBGNet and KITTI's detectors.  Static shapes: callers pass element
weights/masks instead of boolean indexing, and ``avg_factor`` is an
explicit normalizer.  Ignored
labels are -1, which maps to an all-zero one-hot (pure background in the
focal loss, the reference's ``target[target < 0] = num_classes``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.geometry import _max0, iou3d_aligned, iou3d_rotated

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


def weighted_l1(pred, target, weights=None, code_weights=None):
    """pcdet WeightedL1Loss: elementwise |diff| with code and anchor
    weights, no reduction; nan targets ignored."""
    return weighted_smooth_l1(pred, target, weights, beta=0.0,
                              code_weights=code_weights)


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


def cross_entropy_with_logits(logits, labels, class_weight=None):
    """Per-element softmax cross entropy (torch CrossEntropyLoss with
    reduction='none' and optional per-class weights, RBGNet's objectness,
    sample and intersection losses).  logits [..., K], labels [...] ->
    [...]; labels are clipped into [0, K)."""
    logp = torch.log_softmax(logits, -1)
    lab = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    if class_weight is not None:
        w = torch.as_tensor(class_weight, dtype=logits.dtype,
                            device=logits.device)
        nll = nll * w[lab]
    return nll


def axis_aligned_iou_corners(corners_a, corners_b):
    """IoU of corner-format axis-aligned boxes [..., 6] (x1 y1 z1 x2 y2
    z2)."""
    lo = torch.maximum(corners_a[..., :3], corners_b[..., :3])
    hi = torch.minimum(corners_a[..., 3:6], corners_b[..., 3:6])
    whd = _max0(hi - lo)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    ea = _max0(corners_a[..., 3:6] - corners_a[..., :3])
    eb = _max0(corners_b[..., 3:6] - corners_b[..., :3])
    va = ea[..., 0] * ea[..., 1] * ea[..., 2]
    vb = eb[..., 0] * eb[..., 1] * eb[..., 2]
    return inter / torch.maximum(va + vb - inter,
                                 torch.full_like(inter, 1e-9))


def axis_aligned_iou_loss(corners_pred, corners_tgt, weight=None):
    """AxisAlignedIoULoss with reduction 'sum': the sum of
    weight * (1 - IoU) over corner-format boxes."""
    loss = 1.0 - axis_aligned_iou_corners(corners_pred, corners_tgt)
    if weight is not None:
        loss = loss * weight
    return loss.sum()


def focal_loss_centernet(pred, gt, mask=None, n_pos=None):
    """CornerNet / CenterNet's penalty-reduced focal loss of the heatmap
    ``pred`` in (0, 1) against the gaussian heatmap ``gt``: the positive
    and negative terms over the positives' count, or the negative term
    alone when there is no positive.  ``n_pos`` replaces the count (and the
    test on it) with one taken over more than these maps, such as the
    ranks' global count."""
    eps = 1e-6
    pred = torch.minimum(torch.maximum(pred, pred.new_tensor(eps)),
                         pred.new_tensor(1.0 - eps))
    pos = (gt >= 1.0).to(pred.dtype)
    neg = (gt < 1.0).to(pred.dtype)
    neg_w = torch.pow(1.0 - gt, 4)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, 2) * pos
    neg_loss = torch.log(1.0 - pred) * torch.pow(pred, 2) * neg_w * neg
    if mask is not None:
        pos_loss = pos_loss * mask
        neg_loss = neg_loss * mask
    if n_pos is None:
        n_pos = pos.sum()
    return torch.where(n_pos > 0,
                       -(pos_loss.sum() + neg_loss.sum()) /
                       n_pos.clamp(min=1.0), -neg_loss.sum())
