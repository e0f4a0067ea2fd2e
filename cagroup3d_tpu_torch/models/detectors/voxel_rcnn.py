"""Voxel R-CNN: SECOND's one-stage pipeline, then a VoxelRCNNHead that
refines its proposals from the sparse backbone's volumes.

Counterpart of ``cagroup3d_tpu/models/detectors/voxel_rcnn.py`` (the
reference's voxel_rcnn.py).  The proposals are SECOND-IoU's: the anchor
head's decoded boxes through the RoI head's proposal layer
(``SECONDNetIoU.proposals``; ``NMS_CONFIG.TEST`` in eval, ``TRAIN`` in
training).  Each scene's sparse backbone hands its levels
(``multi_scale_3d_features``) to the RoI head through the scene's
``Ctx`` (``ctx.multi_scale_3d``), in autograd during training, so the
RoI head's gradient reaches the sparse convs' backward.

Eval refines each scene's proposals (``VoxelRCNNHead.forward_test``) with
``POST_PROCESSING``'s ``SCORE_THRESH``, ``NMS_CONFIG.NMS_THRESH`` and
``NMS_POST_MAXSIZE``.  Training is ``SECONDNetIoU.train_heads`` with this
head: per scene the training proposals and the RoI sampling, the pool and
the trunk over the batch inside the model's key bits (the voxel queries
pack keys), the RPN loss plus the R-CNN loss (its counts global under
``--dist``).  As in the reference, no gradient flows into the proposals or
their targets; the JAX package lets it flow into the grid points and the
corner loss's decode.
"""
from __future__ import annotations

from typing import Dict

from ...core.module import Ctx
from .detector3d_template import ROI_HEADS, _registry
from .second_net_iou import SECONDNetIoU


class VoxelRCNN(SECONDNetIoU):
    def build_roi_head(self, gen):
        """The RoI head with the sparse backbone's channels, the voxel size
        and the range it pools from."""
        c = self.model_cfg.ROI_HEAD
        return _registry(ROI_HEADS, "ROI_HEAD", c.NAME)(
            c, num_class=self.num_class,
            backbone_channels=self.backbone_3d.backbone_channels,
            voxel_size=self.voxel_size,
            point_cloud_range=self.point_cloud_range, generator=gen)

    def sparse_backbone(self, P, S, ctx: Ctx, st):
        bb = self.backbone_3d(P, S, ctx, st)
        ctx.multi_scale_3d = bb["multi_scale_3d_features"]
        return bb["encoded_spconv_tensor"]

    def roi_train(self, P, S, rctx: Ctx, ctxs, props, gt_boxes, gt_labels,
                  gt_valid, bev2d, roi_draws):
        with self.bits_scope():
            return self.roi_head.forward_train(
                P, S, rctx, ctxs, props, gt_boxes, gt_labels, gt_valid,
                [c.multi_scale_3d for c in ctxs],
                self.backbone_3d.multi_scale_3d_strides, draws=roi_draws)

    def predict(self, P, S, ctx: Ctx, out: Dict, bev2d, points, pvalid):
        """One scene: its test proposals refined by the RoI head from the
        scene's sparse levels (``ctx.multi_scale_3d``)."""
        pp = self.model_cfg.get("POST_PROCESSING", {})
        nc = pp.get("NMS_CONFIG", {})
        rois, _, roi_labels, roi_valid = self.proposals(out, False)
        return self.roi_head.forward_test(
            P, S, ctx, rois, roi_labels, roi_valid, ctx.multi_scale_3d,
            self.backbone_3d.multi_scale_3d_strides,
            score_thresh=float(pp.get("SCORE_THRESH", 0.1)),
            nms_thresh=float(nc.get("NMS_THRESH", 0.1)),
            max_out=int(nc.get("NMS_POST_MAXSIZE", 128)))
