"""SECONDHead: the IoU-scoring second stage of SECOND-IoU over the dense
BEV map, and its rotated BEV sampler.

Counterpart of ``cagroup3d_tpu/models/roi_heads/second_head.py`` (the
reference's second_head.py).  Each RoI is pooled as a G x G bilinear
sample of the 2-D backbone's map over the box's rotated footprint
(``sample_bev_rotated``: the grid endpoint-inclusive across the box, as
the reference's ``align_corners`` affine grid), then shared FC layers and
IoU FC layers (each linear, masked BN over the valid RoIs, ReLU; dropout
``DP_RATIO`` after every shared layer but the last) and one output, the
RoI's predicted IoU logit.  At test time the boxes are the proposals,
re-scored by the detector.

Training samples ``ROI_PER_IMAGE`` RoIs a scene with the proposal target
layer, the GT boxes already in the pcdet heading (``flip_gt_heading=
False``), and regresses their IoU with the matched GT (``IOU_LOSS``:
``BinaryCrossEntropy``, ``L2`` or ``smoothL1``), averaged over the RoIs of
the batch.  The B scenes' RoIs go through the FC layers as one [B, R, F]
stack, BN pooling their statistics as the JAX package's ``scene`` axis
does; dropout draws from each scene's own generator (``Ctx.rand``), so
its masks are not the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ...core.module import (Ctx, Params, apply_bn, dropout, init_bn,
                            init_linear, register_flat)
from ...utils import loss_utils as L
from ...utils.commu_utils import global_sum, group_size
from .pvrcnn_head import PVRCNNHead
from .target_assigner.cagroup_proposal_target_layer import \
    ProposalTargetLayer


def sample_bev_rotated(bev: torch.Tensor, rois: torch.Tensor, grid_size: int,
                       bev_origin, bev_cell) -> torch.Tensor:
    """Bilinear samples of bev [C, H, W] (H along y, W along x) on a
    rotated G x G grid per RoI: rois [R, 7] metric boxes, ``bev_origin``
    the metric (x, y) of cell (0, 0)'s corner, ``bev_cell`` a cell's
    metric size; taps outside the map read 0.  Returns [R, G*G*C] (grid
    point major, channel minor)."""
    C, H, W = bev.shape
    R, g = rois.shape[0], grid_size
    rows = bev.permute(1, 2, 0).reshape(H * W, C)
    lin = torch.linspace(-0.5, 0.5, g, dtype=rois.dtype, device=rois.device)
    uu, vv = torch.meshgrid(lin, lin, indexing="ij")
    local = torch.stack([uu, vv], -1).reshape(1, g * g, 2)
    pts = local * rois[:, None, 3:5]
    ca, sa = torch.cos(rois[:, 6])[:, None], torch.sin(rois[:, 6])[:, None]
    x = pts[..., 0] * ca - pts[..., 1] * sa + rois[:, None, 0]
    y = pts[..., 0] * sa + pts[..., 1] * ca + rois[:, None, 1]
    fx = (x - bev_origin[0]) / bev_cell[0] - 0.5
    fy = (y - bev_origin[1]) / bev_cell[1] - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0).reshape(-1, 1), (fy - y0).reshape(-1, 1)
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)

    def tap(yi, xi):
        ok = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).reshape(-1, 1)
        flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        f = rows[flat.reshape(-1)]
        return torch.where(ok, f, torch.zeros_like(f))

    out = (tap(y0, x0) * (1 - wx) * (1 - wy) + tap(y0, x0 + 1) * wx *
           (1 - wy) + tap(y0 + 1, x0) * (1 - wx) * wy +
           tap(y0 + 1, x0 + 1) * wx * wy)
    return out.reshape(R, g * g * C)


class SECONDHead(PVRCNNHead):
    """Parameters under the JAX package's names:
    ``shared_fc_layer.{i}.weight`` [Cin, Cout] (no bias) and ``.bn.*``,
    ``iou_layers.{i}.weight`` and ``.bn.*``, ``iou_layers.out.weight``
    [C, 1] and ``.bias``."""

    def __init__(self, model_cfg, num_class: int = 1,
                 input_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(model_cfg)
        c = model_cfg
        self.num_class = 1 if c.get("CLASS_AGNOSTIC", True) else num_class
        gp = c.ROI_GRID_POOL
        self.grid_size = int(gp.GRID_SIZE)
        self.in_ch = int(gp.get("IN_CHANNEL", input_channels or 512))
        self.downsample = int(gp.get("DOWNSAMPLE_RATIO", 8))
        self.shared_fc = [int(x) for x in c.SHARED_FC]
        self.iou_fc = [int(x) for x in c.IOU_FC]
        self.dp_ratio = float(c.get("DP_RATIO", 0.3))
        tc = c.TARGET_CONFIG
        self.proposal_target_layer = ProposalTargetLayer(
            roi_per_image=int(tc.get("ROI_PER_IMAGE", 128)),
            fg_ratio=float(tc.get("FG_RATIO", 0.5)),
            reg_fg_thresh=float(tc.get("REG_FG_THRESH", 0.55)),
            cls_fg_thresh=float(tc.get("CLS_FG_THRESH", 0.75)),
            cls_bg_thresh=float(tc.get("CLS_BG_THRESH", 0.25)),
            cls_bg_thresh_l0=float(tc.get("CLS_BG_THRESH_LO", 0.1)),
            hard_bg_ratio=float(tc.get("HARD_BG_RATIO", 0.8)))
        lc = c.LOSS_CONFIG
        self.iou_loss = str(lc.get("IOU_LOSS", "BinaryCrossEntropy"))
        if self.iou_loss not in ("BinaryCrossEntropy", "L2", "smoothL1"):
            raise NotImplementedError(f"IOU_LOSS {self.iou_loss!r}")
        self.w_iou = float(lc.LOSS_WEIGHTS.get("rcnn_iou_weight", 1.0))
        gen = generator or torch.Generator().manual_seed(0)
        P, S = {}, {}
        cin = self.in_ch * self.grid_size * self.grid_size
        for i, cout in enumerate(self.shared_fc):
            init_linear(P, gen, f"shared_fc_layer.{i}", cin, cout,
                        bias=False, init="xavier")
            init_bn(P, S, f"shared_fc_layer.{i}.bn", cout)
            cin = cout
        for i, cout in enumerate(self.iou_fc):
            init_linear(P, gen, f"iou_layers.{i}", cin, cout, bias=False,
                        init="xavier")
            init_bn(P, S, f"iou_layers.{i}.bn", cout)
            cin = cout
        init_linear(P, gen, "iou_layers.out", cin, 1, bias=True,
                    init="normal")
        register_flat(self, P, S)

    def pool(self, bev2d: torch.Tensor, rois: torch.Tensor,
             roi_valid: torch.Tensor, point_cloud_range, voxel_size):
        """One scene's RoIs sampled from its map bev2d [C, H, W] (stride
        ``DOWNSAMPLE_RATIO`` voxels) -> [R, G*G*C], 0 for invalid RoIs."""
        cell = (voxel_size[0] * self.downsample,
                voxel_size[1] * self.downsample)
        pooled = sample_bev_rotated(bev2d, rois, self.grid_size,
                                    (point_cloud_range[0],
                                     point_cloud_range[1]), cell)
        return torch.where(roi_valid[:, None], pooled,
                           torch.zeros_like(pooled))

    def iou_branch(self, P: Params, S: Params, ctx: Ctx,
                   pooled: torch.Tensor, valid: torch.Tensor,
                   scene_ctxs: Optional[List[Ctx]] = None,
                   prefix: str = "roi_head") -> torch.Tensor:
        """pooled [R, F] (or [B, R, F] with ``scene_ctxs``, whose BN pools
        the B scenes and whose dropout draws from each scene's ctx) ->
        IoU logits [R] (or [B, R]).  BN updates go to ``ctx.updates``."""
        batched = scene_ctxs is not None
        x = pooled
        n = len(self.shared_fc)
        for i in range(n):
            pre = f"{prefix}.shared_fc_layer.{i}"
            x = apply_bn(P, S, ctx, pre + ".bn", x @ P[pre + ".weight"], valid,
                         scene_axis=batched)
            x = torch.where(valid[..., None], torch.relu(x),
                            torch.zeros_like(x))
            if i != n - 1 and self.dp_ratio > 0:
                x = torch.stack([dropout(c, xi, self.dp_ratio) for c, xi in
                                 zip(scene_ctxs, x)]) if batched else \
                    dropout(ctx, x, self.dp_ratio)
        for i in range(len(self.iou_fc)):
            pre = f"{prefix}.iou_layers.{i}"
            x = apply_bn(P, S, ctx, pre + ".bn", x @ P[pre + ".weight"], valid,
                         scene_axis=batched)
            x = torch.where(valid[..., None], torch.relu(x),
                            torch.zeros_like(x))
        out = x @ P[f"{prefix}.iou_layers.out.weight"] + \
            P[f"{prefix}.iou_layers.out.bias"]
        return out[..., 0]

    def forward_train(self, P: Params, S: Params, ctx: Ctx,
                      scene_ctxs: List[Ctx], proposals, gt_boxes, gt_labels,
                      gt_valid, bev2d: torch.Tensor, point_cloud_range,
                      voxel_size, draws=None, prefix: str = "roi_head"):
        """The batch's training forward: per scene its proposals (rois,
        scores, labels, valid) sampled against its GTs (``draws`` [B] of
        the target layer's draws, else each scene's generator), pooled from
        bev2d [B, C, H, W], then the IoU branch over the B scenes.  Returns
        ``rcnn_iou`` and ``rcnn_cls_labels`` [B, ROI_PER_IMAGE]."""
        pooled, labels = [], []
        for i, (rois, scores, labs, valid) in enumerate(proposals):
            with torch.no_grad():
                tgt = self.proposal_target_layer(
                    scene_ctxs[i].generator, rois, scores, labs, valid,
                    gt_boxes[i], gt_labels[i], gt_valid[i],
                    draws=None if draws is None else draws[i],
                    flip_gt_heading=False)
            s_valid = torch.ones(tgt["rois"].shape[0], dtype=torch.bool,
                                 device=rois.device)
            pooled.append(self.pool(bev2d[i], tgt["rois"], s_valid,
                                    point_cloud_range, voxel_size))
            labels.append(tgt["rcnn_cls_labels"])
        pooled = torch.stack(pooled)
        valid = torch.ones(pooled.shape[:2], dtype=torch.bool,
                           device=pooled.device)
        return dict(rcnn_iou=self.iou_branch(P, S, ctx, pooled, valid,
                                             scene_ctxs, prefix),
                    rcnn_cls_labels=torch.stack(labels))

    def forward_test(self, P: Params, S: Params, ctx: Ctx, rois, roi_valid,
                     bev2d: torch.Tensor, point_cloud_range, voxel_size,
                     prefix: str = "roi_head") -> torch.Tensor:
        """One scene's IoU logits [R] for its proposals."""
        pooled = self.pool(bev2d, rois, roi_valid, point_cloud_range,
                           voxel_size)
        return self.iou_branch(P, S, ctx, pooled, roi_valid, prefix=prefix)

    def loss(self, fwd: Dict[str, torch.Tensor], group=None):
        """The IoU regression loss over every RoI of the batch: (loss, tb
        with ``rcnn_loss_iou`` and ``rcnn_loss``).  With a process
        ``group`` of W ranks the RoI count is the global one and each
        rank's loss is its share times W, so that the ranks' mean is the
        loss over every rank's RoIs (``parallel/mesh.global_terms``)."""
        iou = fwd["rcnn_iou"].reshape(-1)
        lab = fwd["rcnn_cls_labels"].reshape(-1)
        ok = (lab >= 0).to(iou.dtype)
        t = lab.clamp(min=0.0)
        if self.iou_loss == "BinaryCrossEntropy":
            e = iou.clamp(min=0) - iou * t + torch.log1p(torch.exp(-iou.abs()))
        elif self.iou_loss == "L2":
            e = (iou - t) ** 2
        else:
            e = L.smooth_l1(iou, t, beta=1.0 / 9.0, reduction="none")
        n_ok = global_sum(ok.sum(), group).clamp(min=1.0)
        li = (e * ok).sum() / n_ok * (self.w_iou * group_size(group))
        return li, dict(rcnn_loss_iou=li, rcnn_loss=li)
