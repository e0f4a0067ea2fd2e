"""CAGroup3D two-stage RoI head: sparse RoI grid pooling + MLP, and its
training half.

Counterpart of ``cagroup3d_tpu/models/roi_heads/cagroup_roi_head.py``.  Per
roi a GRID_SIZE^3 grid of points is deduplicated on the backbone's stride-2
lattice, convolved at those query coordinates (k5 conv-at-coords on the
backbone voxels, kernel K1), scattered back per roi and centre-pooled with
one dense [G^3*C -> C] contraction, then refined by a Linear+BN+ReLU MLP
(with dropout in training), decoded and per-class NMS'd (eval), or
regressed against sampled GT targets (training).  With ``CODE_SIZE`` 7
(SUN RGB-D) the grid turns with each roi's heading, the GT is carried into
the roi's frame (rotated, with an opposite heading flipped), the heading is
coded as (cos, sin) with ``ENCODE_SINCOS``, decoded boxes are turned back,
the final NMS is rotated and ``USE_IOU_LOSS`` adds a rotated IoU loss.
Headings modulo 2 pi use ``torch.remainder``, the sign convention of the
reference's ``%`` (``torch.fmod`` has the other).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.gather import take_rows_masked
from ...core.geometry import rotate_points_along_z
from ...core.module import (Ctx, Params, apply_bn, apply_linear, dropout,
                            init_bn, init_conv, init_linear, register_flat)
from ...core.nms import multiclass_nms
from ...core.norm import elu, relu
from ...core.sparse import SparseTensor, zero_invalid
from ...core.sparse_conv import scan_conv_grouped
from ...core.voxelize import unique_voxels
from ...utils import loss_utils as L
from ...utils.commu_utils import global_sum, group_size
from ..model_utils.cagroup_utils import CAGroupResidualCoder
from .target_assigner.cagroup_proposal_target_layer import ProposalTargetLayer


class CAGroup3DRoIHead(nn.Module):
    def __init__(self, model_cfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = model_cfg
        self.num_class = c.NUM_CLASSES
        self.code_size = c.CODE_SIZE
        self.grid_size = c.GRID_SIZE
        self.voxel_size = c.VOXEL_SIZE
        self.coord_key = c.COORD_KEY
        self.mlps = c.MLPS
        self.enlarge_ratio = c.get("ENLARGE_RATIO", False)
        self.reg_fc = c.get("REG_FC", [256, 256])
        self.test_score_thr = c.get("TEST_SCORE_THR", 0.01)
        self.test_iou_thr = c.get("TEST_IOU_THR", 0.5)
        self.roi_conv_kernel = c.get("ROI_CONV_KERNEL", 5)
        self.grid_cap = int(c.get("GRID_CAP", 16384))
        self.nms_per_cls_cap = int(c.get("NMS_PER_CLS_CAP", 128))
        self.max_out = int(c.get("MAX_OUT", 128))
        self.dp_ratio = c.get("DP_RATIO", 0.3)
        self.loss_weight = c.LOSS_WEIGHTS
        self.code_weights = c.LOSS_WEIGHTS.CODE_WEIGHT
        self.use_iou_loss = bool(c.get("USE_IOU_LOSS", False))
        self.proposal_target_layer = ProposalTargetLayer(
            roi_per_image=c.get("ROI_PER_IMAGE", 128),
            fg_ratio=c.get("ROI_FG_RATIO", 0.9),
            reg_fg_thresh=c.get("REG_FG_THRESH", 0.3))
        self.box_coder = CAGroupResidualCoder(
            self.code_size, bool(c.get("ENCODE_SINCOS", False)))
        P, S = self._init(generator or torch.Generator().manual_seed(0))
        register_flat(self, P, S)

    def _init(self, gen: torch.Generator):
        P: Params = {}
        S: Params = {}
        mlp = self.mlps[0]
        pl = "roi_grid_pool_layers.0"
        init_conv(P, gen, pl + ".grid_conv", self.roi_conv_kernel, mlp[0],
                  mlp[1], init="normal")
        init_bn(P, S, pl + ".grid_bn", mlp[1])
        init_conv(P, gen, pl + ".pooling_conv", self.grid_size, mlp[1],
                  mlp[2], init="normal")
        init_bn(P, S, pl + ".pooling_bn", mlp[2])
        cin = sum(m[-1] for m in self.mlps)
        idx = 0
        for k, cout in enumerate(self.reg_fc):
            init_linear(P, gen, f"reg_fc_layers.{idx}", cin, cout, bias=False,
                        init="xavier")
            init_bn(P, S, f"reg_fc_layers.{idx + 1}", cout)
            idx += 4 if k != len(self.reg_fc) - 1 else 3
            cin = cout
        init_linear(P, gen, "reg_pred_layer", cin, self.box_coder.code_size,
                    bias=True, init="normal")
        return P, S

    # ------------------------------------------------------------------
    def get_dense_grid_points(self, rois: torch.Tensor) -> torch.Tensor:
        """[R, 7] -> local grid points [R, G^3, 3]."""
        g = self.grid_size
        idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                                   indexing="ij"), -1).reshape(-1, 3)
        idx = torch.as_tensor(idx, dtype=torch.float32, device=rois.device)
        size = rois[:, None, 3:6]
        return (idx[None] + 0.5) / g * size - size / 2

    def pcdet_rois(self, rois):
        """One-stage rois (mmdet3d heading) in the pcdet frame the RoI
        stage pools and decodes in: heading negated, sizes enlarged."""
        rois_pc = torch.cat([rois[:, :6], -rois[:, 6:7]], dim=-1)
        if self.enlarge_ratio:
            rois_pc = torch.cat([rois_pc[:, :3],
                                 rois_pc[:, 3:6] * self.enlarge_ratio,
                                 rois_pc[:, 6:]], dim=-1)
        return rois_pc

    def grid_lattice(self, rois):
        """rois [R, 7] (pcdet heading) -> the lattice cells of their grid
        points [R * G^3, 3] (rotated by the heading with yaw)."""
        R, g3 = rois.shape[0], self.grid_size ** 3
        local = self.get_dense_grid_points(rois)                  # [R, G3, 3]
        if self.code_size > 6:
            local = rotate_points_along_z(local, rois[:, 6])
        pts = (local + rois[:, None, :3]).reshape(R * g3, 3)
        cell = self.voxel_size * self.coord_key
        return torch.floor(pts / cell).to(torch.int32)

    def roi_grid_pool(self, P, S, ctx: Ctx, st: SparseTensor, rois,
                      roi_valid, prefix: str):
        """rois [R, 7] (pcdet heading) -> pooled [R, C_out]."""
        pl = prefix + ".roi_grid_pool_layers.0"
        R = rois.shape[0]
        g3 = self.grid_size ** 3
        lat = self.grid_lattice(rois)
        pvalid = roi_valid.repeat_interleave(g3)
        ded, inv = unique_voxels(lat, torch.zeros(R * g3, 1, device=lat.device),
                                 pvalid, self.grid_cap, mode="first",
                                 stats=ctx.stats, stat_name="roi_grid")
        # conv of the backbone voxels at the deduplicated grid (kernel K1)
        f = scan_conv_grouped(st.coords, st.valid, st.feats, st.stride,
                              ded.coords * self.coord_key, ded.valid,
                              self.roi_conv_kernel,
                              P[pl + ".grid_conv.kernel"])
        f = apply_bn(P, S, ctx, pl + ".grid_bn", f, ded.valid)
        f = zero_invalid(elu(f), ded.valid)
        # back to per-roi grids; dropped grid points get zero features
        grid_feats = take_rows_masked(f, inv).reshape(R, g3, -1)
        pooled = torch.einsum("rgc,gcd->rd", grid_feats,
                              P[pl + ".pooling_conv.kernel"])
        pooled = apply_bn(P, S, ctx, pl + ".pooling_bn", pooled, roi_valid)
        return zero_invalid(pooled, roi_valid)

    def reg_branch(self, P, S, ctx: Ctx, feats, valid, prefix: str):
        x, idx = feats, 0
        for k in range(len(self.reg_fc)):
            x = apply_linear(P, f"{prefix}.reg_fc_layers.{idx}", x)
            x = apply_bn(P, S, ctx, f"{prefix}.reg_fc_layers.{idx + 1}", x,
                         valid)
            x = zero_invalid(relu(x), valid)
            if k != len(self.reg_fc) - 1:
                if self.dp_ratio > 0:
                    x = dropout(ctx, x, self.dp_ratio)
                idx += 4
            else:
                idx += 3
        return apply_linear(P, prefix + ".reg_pred_layer", x)

    def forward_train(self, P, S, ctx: Ctx, st: SparseTensor, rois,
                      roi_scores, roi_labels, roi_valid, gt_boxes, gt_labels,
                      gt_valid, prefix: str = "roi_head", draws=None):
        """One scene, training: sample targets, then pool and regress.  The
        rois (one-stage NMS output, mmdet3d heading) keep their gradient,
        as in the JAX package: the regression targets are relative to
        them.  ``draws`` overrides the proposal sampling's random draws."""
        rois_pc = self.pcdet_rois(rois)
        tgt = self.proposal_target_layer(
            ctx.generator, rois_pc, roi_scores, roi_labels, roi_valid,
            gt_boxes, gt_labels, gt_valid, draws=draws)
        s_rois = tgt["rois"]
        s_valid = torch.ones(s_rois.shape[0], dtype=torch.bool,
                             device=s_rois.device)
        gt_ct = self.canonical_targets(tgt["gt_of_rois"], s_rois)
        pooled = self.roi_grid_pool(P, S, ctx, st, s_rois, s_valid, prefix)
        rcnn_reg = self.reg_branch(P, S, ctx, pooled, s_valid, prefix)
        return dict(rcnn_reg=rcnn_reg, rois=s_rois, gt_of_rois=gt_ct,
                    gt_of_rois_src=tgt["gt_of_rois"],
                    reg_valid_mask=tgt["reg_valid_mask"],
                    roi_labels=tgt["roi_labels"],
                    roi_scores=tgt["roi_scores"], sampled=tgt["sampled"])

    def canonical_targets(self, gt, rois):
        """The GT of each sampled roi in the roi's frame (assign_targets):
        centre relative to the roi, heading relative to the roi's; with
        yaw the centre turned by minus the roi's heading and a heading
        pointing backwards flipped by pi into [-pi/2, pi/2]."""
        two_pi = 2 * np.pi
        roi_ry = torch.remainder(rois[:, 6], two_pi)
        gt_ct = torch.cat([gt[:, 0:3] - rois[:, 0:3], gt[:, 3:6],
                           (torch.remainder(gt[:, 6], two_pi) -
                            roi_ry)[:, None]], dim=-1)
        if self.code_size == 6:
            return gt_ct
        gt_ct = rotate_points_along_z(gt_ct[:, None, :], -roi_ry)[:, 0, :]
        heading = torch.remainder(gt_ct[:, 6], two_pi)
        opposite = (heading > np.pi * 0.5) & (heading < np.pi * 1.5)
        heading = torch.where(opposite,
                              torch.remainder(heading + np.pi, two_pi),
                              heading)
        heading = torch.where(heading > np.pi, heading - two_pi, heading)
        heading = heading.clamp(-np.pi / 2, np.pi / 2)
        return torch.cat([gt_ct[:, :6], heading[:, None]], dim=-1)

    def loss(self, fwd, group=None):
        """Second-stage loss over B scenes (leading scene axis): weighted
        smooth-L1 of the residual codes of the foreground rois, and with
        ``USE_IOU_LOSS`` 1 - IoU of their decoded boxes with the GT.  Both
        are sums over the batch's foreground rois over their count; with a
        process ``group`` of W ranks the count is the global one and each
        rank's sum is scaled by W, so the mean of the ranks' losses (the
        step averages their gradients) is the W*B-scene loss."""
        code = self.code_size
        rois = fwd["rois"].reshape(-1, fwd["rois"].shape[-1])
        gt_ct = fwd["gt_of_rois"].reshape(-1, fwd["gt_of_rois"].shape[-1])
        reg = fwd["rcnn_reg"].reshape(-1, fwd["rcnn_reg"].shape[-1])
        fg = fwd["reg_valid_mask"].reshape(-1) > 0
        anchors = torch.cat([torch.zeros_like(rois[:, 0:3]), rois[:, 3:code]],
                            dim=-1)
        if code > 6:
            anchors = torch.cat([anchors[:, :6],
                                 torch.zeros_like(anchors[:, 6:7])], dim=-1)
        targets = self.box_coder.encode(gt_ct[:, :code], anchors)
        elt = L.weighted_smooth_l1(reg, targets,
                                   code_weights=self.code_weights)
        fg_sum = global_sum(fg.float().sum(), group).clamp(min=1.0)
        ranks = float(group_size(group))
        loss_reg = (elt * fg[:, None]).sum() / fg_sum * ranks
        w = float(self.loss_weight.RCNN_REG_WEIGHT)
        loss_reg = loss_reg * w
        tb = dict(rcnn_loss_reg=loss_reg)
        total = loss_reg if w > 0 else torch.zeros((), device=reg.device)
        if self.use_iou_loss:
            dec = self.decode_boxes(rois, reg)
            gt_src = fwd["gt_of_rois_src"].reshape(-1, 7)
            # rows that are not foreground go to the unit box: the clipping
            # of degenerate boxes has no finite gradient
            safe = torch.tensor([0, 0, 0, 1, 1, 1, 0.0], device=reg.device)
            decs = torch.where(fg[:, None], dec, safe)
            gts = torch.where(fg[:, None], gt_src, safe)
            liou = L.iou3d_loss(decs, gts, weight=fg.float(),
                                avg_factor=fg_sum, with_yaw=code > 6) * ranks
            liou = liou * float(self.loss_weight.RCNN_IOU_WEIGHT)
            tb["rcnn_loss_iou"] = liou
            total = total + liou
        tb["loss_two_stage"] = total
        return total, tb

    def forward(self, P, S, ctx: Ctx, st: SparseTensor, rois, roi_scores,
                roi_labels, roi_valid, prefix: str = "roi_head"):
        """One scene, eval: pool and regress every roi, decode, per-class
        NMS (forward_test of the JAX package)."""
        rois_pc = self.pcdet_rois(rois)
        pooled = self.roi_grid_pool(P, S, ctx, st, rois_pc, roi_valid, prefix)
        rcnn_reg = self.reg_branch(P, S, ctx, pooled, roi_valid, prefix)
        boxes = self.decode_boxes(rois_pc, rcnn_reg)
        onehot = nn.functional.one_hot(roi_labels.long(), self.num_class)
        scores = roi_scores[:, None] * onehot.to(roi_scores.dtype)
        b, s, l, v = multiclass_nms(
            boxes, scores, roi_valid & (rois_pc.abs().sum(-1) > 0),
            score_thr=self.test_score_thr, iou_thr=self.test_iou_thr,
            per_cls_cap=self.nms_per_cls_cap, out_cap=self.max_out,
            rotated=self.code_size > 6, flip_heading_for_iou=False)
        # back to the mmdet3d heading; the axis-aligned boxes have none
        b = torch.cat([b[:, :6], -b[:, 6:7] if self.code_size > 6 else
                       torch.zeros_like(b[:, 6:7])], dim=-1)
        return dict(batch_box_preds=b, batch_score_preds=s,
                    batch_cls_preds=l, batch_pred_valid=v, rcnn_reg=rcnn_reg)

    def decode_boxes(self, rois_pc, rcnn_reg):
        """Residual decode in the roi's frame (generate_predicted_boxes),
        turned back by the roi's heading with yaw, then moved to the roi's
        centre; axis-aligned boxes get heading 0."""
        code = self.code_size
        local = torch.cat([torch.zeros_like(rois_pc[:, 0:3]),
                           rois_pc[:, 3:code]], dim=-1)
        dec = self.box_coder.decode(rcnn_reg, local)
        if code > 6:
            dec = rotate_points_along_z(dec[:, None, :], rois_pc[:, 6])[:, 0]
        dec = torch.cat([dec[:, 0:3] + rois_pc[:, 0:3], dec[:, 3:]], dim=-1)
        if code == 6:
            dec = torch.cat([dec, torch.zeros_like(dec[:, :1])], dim=-1)
        return dec
