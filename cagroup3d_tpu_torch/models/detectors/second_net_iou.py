"""SECOND-IoU: SECOND's one-stage pipeline and a SECONDHead that re-scores
its proposals with a predicted IoU.

Counterpart of ``cagroup3d_tpu/models/detectors/second_net_iou.py`` (the
reference's second_net_iou.py).  The proposals are the anchor head's
decoded boxes (``AnchorHeadSingle.decoded_boxes``) through the RoI head's
proposal layer.  Eval fuses the predicted IoU with the proposal's class
score by ``POST_PROCESSING.NMS_CONFIG.SCORE_TYPE`` (``iou``, ``cls``,
``weighted_iou_cls``, ``num_pts_iou_cls``, ``score_by_class``), runs a
class-agnostic rotated NMS over the proposals above ``SCORE_THRESH`` and
returns the best ``NMS_POST_MAXSIZE`` of them (at most the proposals'
count); the boxes are the proposals themselves.

Training runs SECOND's forward (``SECONDNet.train_maps``: the sparse
halves in scene threads inside the model's bits, the BEV maps as one
batch), then per scene the training proposals (``NMS_CONFIG.TRAIN``: the
top 9000 anchors, NMS at 0.8, 512 kept), the RoI sampling and the IoU
branch over the batch, and adds the RPN loss and the RCNN IoU loss.  As in
the reference (its proposal layer and target assignment run under
``torch.no_grad``), no gradient flows into the proposals or the IoU
targets; the JAX package lets it flow through both.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...core import nms as nms_mod
from ...core.module import Ctx
from ...core.roi_pools import points_in_boxes
from .second_net import SECONDNet, batch_sync


class SECONDNetIoU(SECONDNet):
    @torch.no_grad()
    def proposals(self, out: Dict, train: bool):
        """One scene's proposals from its head outputs: (rois [M, 7],
        scores [M] (the best class's sigmoid), labels [M] (0-based), valid
        [M])."""
        boxes, scores = self.dense_head.decoded_boxes(out)
        best = scores.max(dim=-1).values
        labels = torch.argmax(scores, dim=-1).to(torch.int32)
        return self.roi_head.proposal_layer(
            boxes, best, labels, torch.ones_like(best, dtype=torch.bool),
            train=train)

    def train_heads(self, P, S, ctxs, bev: torch.Tensor, batch: Dict,
                    roi_draws=None, group=None):
        """``SECONDNet.train_heads`` and the second stage: per scene the
        training proposals and the RoI sampling (``roi_draws`` [B]
        overrides each scene's draws; else each scene's stream, drawn by
        its global index), the IoU branch over the batch (BN over the
        ranks' RoIs too, dropout from each scene's stream), and the RPN
        loss plus the RCNN IoU loss (its RoI count global)."""
        updates = dict(ctxs[0].updates)
        sync = batch_sync(ctxs)
        bev2d = self.backbone_2d(P, S, bev, updates=updates, sync=sync)
        outs = self.dense_head(P, bev2d, S=S, updates=updates, sync=sync)
        gt_boxes = batch["gt_boxes"][..., :7]
        gt_labels = batch["gt_boxes"][..., 7].to(torch.int32)
        gt_valid = batch["gt_valid"]
        props = [self.proposals({k: v[i] for k, v in outs.items()}, True)
                 for i in range(len(ctxs))]
        rctx = Ctx(train=True, sync=sync)
        roi_out = self.roi_head.forward_train(
            P, S, rctx, ctxs, props, gt_boxes, gt_labels, gt_valid, bev2d,
            self.point_cloud_range, self.voxel_size, draws=roi_draws)
        updates.update(rctx.updates)
        loss_rpn, tb = self.dense_head.loss(outs, gt_boxes,
                                            gt_labels.to(torch.int64),
                                            gt_valid, group=group)
        loss_rcnn, tb_r = self.roi_head.loss(roi_out, group=group)
        tb.update(tb_r)
        return loss_rpn + loss_rcnn, tb, updates

    def fused_scores(self, iou_s, cls_s, labels, boxes, points, pvalid):
        """The proposals' scores by ``SCORE_TYPE`` (second_net_iou.py's
        cal_scores_by_npoints / set_nms_score_by_class)."""
        nc = self.model_cfg.get("POST_PROCESSING", {}).get("NMS_CONFIG", {})
        stype = str(nc.get("SCORE_TYPE", "iou") or "iou")
        if stype == "iou":
            return iou_s
        if stype == "cls":
            return cls_s
        if stype == "weighted_iou_cls":
            w = nc.SCORE_WEIGHTS
            return float(w.iou) * iou_s + float(w.cls) * cls_s
        if stype == "num_pts_iou_cls":
            c_thr, i_thr = float(nc.SCORE_THRESH.cls), \
                float(nc.SCORE_THRESH.iou)
            inside = points_in_boxes(points[:, :3], pvalid, boxes,
                                     torch.ones(boxes.shape[0],
                                                dtype=torch.bool,
                                                device=boxes.device))
            npts = inside.sum(1).to(iou_s.dtype)
            alpha = ((npts - c_thr) / (i_thr - c_thr)).clamp(0.0, 1.0)
            return (1 - alpha) * cls_s + alpha * iou_s
        if stype == "score_by_class":
            by = nc.SCORE_BY_CLASS
            use_iou = torch.tensor(
                [1.0 if str(by.get(c, "iou")) == "iou" else 0.0
                 for c in self.class_names], dtype=iou_s.dtype,
                device=iou_s.device)
            pick = use_iou[labels.long().clamp(0, len(self.class_names) - 1)]
            return pick * iou_s + (1 - pick) * cls_s
        raise NotImplementedError(f"SCORE_TYPE {stype!r}")

    def predict(self, P, S, ctx: Ctx, out: Dict, bev2d, points, pvalid):
        """One scene: proposals, their IoU, the fused scores, the NMS."""
        pp = self.model_cfg.get("POST_PROCESSING", {})
        nc = pp.get("NMS_CONFIG", {})
        rois, roi_scores, roi_labels, roi_valid = self.proposals(out, False)
        iou_s = torch.sigmoid(self.roi_head.forward_test(
            P, S, ctx, rois, roi_valid, bev2d, self.point_cloud_range,
            self.voxel_size))
        fused = self.fused_scores(iou_s, roi_scores, roi_labels, rois,
                                  points, pvalid)
        neg = torch.full_like(fused, -1.0)
        v = roi_valid & (fused > float(pp.get("SCORE_THRESH", 0.1)))
        keep = nms_mod.greedy_nms(rois, torch.where(v, fused, neg), v,
                                  float(nc.get("NMS_THRESH", 0.1)),
                                  rotated=True)
        v = v & keep
        m = min(int(nc.get("NMS_POST_MAXSIZE", 128)), rois.shape[0])
        so, oid = nms_mod.topk_stable(torch.where(v, fused, neg), m)
        return rois[oid], so, roi_labels[oid].to(torch.int32), v[oid]
