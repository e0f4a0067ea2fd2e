"""RoI sampling for second-stage training.

Counterpart of ``cagroup3d_tpu/models/roi_heads/target_assigner/
cagroup_proposal_target_layer.py`` (reference subsample_rois): per scene,
proposals are IoU-matched to same-class GT, then ROI_PER_IMAGE rois are
sampled: up to fg_ratio of them foreground (IoU >= 0.3, in random order),
the rest background split 80/20 hard (0.1 <= IoU < 0.3) / easy (< 0.1)
with replacement.  Data-dependent counts become slot masks.

The random draws are inputs of ``sample`` (three uniform rows that order
the fg/hard/easy sets, and ``roi_per_image`` integers for the draws with
replacement), so tests hand both packages the same numbers; ``__call__``
draws them from the scene's generator.
"""
from __future__ import annotations

from typing import Dict

import torch

from ....core.geometry import iou3d_rotated, pairwise

RINT_HIGH = 1 << 30


def _rand_perm_order(u, mask):
    """Indices ordered: rows with mask first (in the random order of u),
    the rest after."""
    return torch.argsort(torch.where(mask, u, u + 2.0), stable=True)


class ProposalTargetLayer:
    def __init__(self, roi_per_image=128, fg_ratio=0.5, reg_fg_thresh=0.3,
                 cls_fg_thresh=0.55, cls_bg_thresh=0.15, cls_bg_thresh_l0=0.1,
                 hard_bg_ratio=0.8):
        self.roi_per_image = roi_per_image
        self.fg_ratio = fg_ratio
        self.reg_fg_thresh = reg_fg_thresh
        self.cls_fg_thresh = cls_fg_thresh
        self.cls_bg_thresh = cls_bg_thresh
        self.cls_bg_thresh_l0 = cls_bg_thresh_l0
        self.hard_bg_ratio = hard_bg_ratio

    def max_iou_with_same_class(self, rois, roi_labels, roi_valid, gt_boxes,
                                gt_labels, gt_valid):
        with torch.no_grad():
            iou = pairwise(iou3d_rotated, rois[:, :7],
                           gt_boxes[:, :7])
        same = roi_labels[:, None] == gt_labels[None, :]
        iou = torch.where(same & gt_valid[None, :] & roi_valid[:, None], iou,
                          torch.full_like(iou, -1.0))
        max_ov = iou.amax(1).clamp(min=0.0)
        asg = iou.argmax(1)
        return max_ov, asg

    def draws(self, generator: torch.Generator, n_rois: int):
        """(uniforms f32[3, n_rois], rint i64[roi_per_image]) on the CPU."""
        u = torch.rand(3, n_rois, generator=generator)
        rint = torch.randint(0, RINT_HIGH, (self.roi_per_image,),
                             generator=generator)
        return u, rint

    def sample(self, max_overlaps, roi_valid, u, rint):
        """i64[roi_per_image] sampled roi indices given the draws ``u``
        [3, R] (fg, hard, easy orders) and ``rint`` [roi_per_image]."""
        dev = max_overlaps.device
        u, rint = u.to(dev), rint.to(dev)
        n_roi = self.roi_per_image
        fg_thresh = min(self.reg_fg_thresh, self.cls_fg_thresh)
        fg_mask = (max_overlaps >= fg_thresh) & roi_valid
        easy_mask = (max_overlaps < self.cls_bg_thresh_l0) & roi_valid
        hard_mask = ((max_overlaps < self.reg_fg_thresh) &
                     (max_overlaps >= self.cls_bg_thresh_l0)) & roi_valid
        n_fg, n_hard, n_easy = fg_mask.sum(), hard_mask.sum(), easy_mask.sum()
        fg_sorted = _rand_perm_order(u[0], fg_mask)
        hard_sorted = _rand_perm_order(u[1], hard_mask)
        easy_sorted = _rand_perm_order(u[2], easy_mask)

        fg_cap = int(round(self.fg_ratio * n_roi))
        has_bg = (n_hard + n_easy) > 0
        fg_take = torch.where(has_bg, n_fg.clamp(max=fg_cap),
                              torch.full_like(n_fg, n_roi))
        fg_take = torch.minimum(fg_take, n_fg.clamp(min=0))

        slots = torch.arange(n_roi, device=dev)
        is_fg_slot = slots < fg_take
        n_bg = n_roi - fg_take
        hard_num = torch.minimum(
            torch.floor(n_bg * self.hard_bg_ratio).long(), n_hard)
        hard_num = torch.where(n_easy > 0, hard_num,
                               torch.where(n_hard > 0, n_bg,
                                           torch.zeros_like(n_bg)))
        is_hard_slot = (slots - fg_take) < hard_num

        R = fg_sorted.shape[0]
        fg_idx_norep = fg_sorted[slots.clamp(0, R - 1)]
        fg_idx_rep = fg_sorted[rint % n_fg.clamp(min=1)]
        fg_idx = torch.where(n_fg >= fg_take, fg_idx_norep, fg_idx_rep)
        hard_idx = hard_sorted[rint % n_hard.clamp(min=1)]
        easy_idx = easy_sorted[rint % n_easy.clamp(min=1)]
        bg_idx = torch.where(is_hard_slot & (n_hard > 0), hard_idx,
                             torch.where(n_easy > 0, easy_idx, hard_idx))
        return torch.where(is_fg_slot, fg_idx, bg_idx)

    def __call__(self, generator, rois, roi_scores, roi_labels, roi_valid,
                 gt_boxes, gt_labels, gt_valid, draws=None,
                 flip_gt_heading: bool = True) -> Dict[str, torch.Tensor]:
        """Per scene.  rois [R, 7] (pcdet heading); gt_boxes [G, 7] in the
        mmdet3d heading, flipped here as in the reference (CAGroup3D), or
        with ``flip_gt_heading=False`` already in the pcdet heading (the
        outdoor models' KITTI boxes).  ``draws`` overrides the generator's
        (see ``sample``)."""
        gt_pc = torch.cat([gt_boxes[:, :6], -gt_boxes[:, 6:7]], dim=-1) \
            if flip_gt_heading else gt_boxes
        max_ov, asg = self.max_iou_with_same_class(
            rois, roi_labels, roi_valid, gt_pc, gt_labels, gt_valid)
        u, rint = draws if draws is not None else \
            self.draws(generator, rois.shape[0])
        sel = self.sample(max_ov, roi_valid, u, rint)

        s_ious = max_ov[sel]
        reg_valid = (s_ious > self.reg_fg_thresh).to(torch.int32)
        fgm = s_ious > self.cls_fg_thresh
        bgm = s_ious < self.cls_bg_thresh
        interval = ~fgm & ~bgm
        cls_labels = torch.where(
            interval, (s_ious - self.cls_bg_thresh) /
            (self.cls_fg_thresh - self.cls_bg_thresh), fgm.to(s_ious.dtype))
        return dict(rois=rois[sel], gt_of_rois=gt_pc[asg[sel]],
                    gt_label_of_rois=gt_labels[asg[sel]],
                    gt_iou_of_rois=s_ious, roi_scores=roi_scores[sel],
                    roi_labels=roi_labels[sel], reg_valid_mask=reg_valid,
                    rcnn_cls_labels=cls_labels, sampled=sel)
