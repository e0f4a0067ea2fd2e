"""The shared second stage of the outdoor two-stage heads: the proposal
layer and the R-CNN trunk.

Counterpart of the parts of ``PVRCNNHead`` in
``cagroup3d_tpu/models/roi_heads/pvrcnn_head.py`` that ``SECONDHead`` and
``VoxelRCNNHead`` inherit (the reference's roi_head_template.py and
pvrcnn_head.py):

- ``proposal_layer``: the top ``NMS_PRE_MAXSIZE`` anchors by their best
  class score, a class-agnostic rotated greedy NMS at ``NMS_THRESH``, and
  the top ``NMS_POST_MAXSIZE`` of what it keeps, padded, from the
  ``NMS_CONFIG`` of the phase (``TRAIN`` or ``TEST``).  The overlap matrix
  is built in row blocks (``core/nms.overlap_matrix``), never whole: at
  the training setting, 9000 candidates, it has 81M pairs.
- the trunk (``init_trunk``): the RoIs' G^3 grid points
  (``get_global_grid_points``), shared FC layers and the class and box
  branches over the pooled RoI features (``_heads``: each layer linear,
  masked BN over the valid RoIs, ReLU; dropout ``DP_RATIO`` after every
  shared layer but the last), the RoI sampling with the GT boxes moved
  into each RoI's canonical frame (``sample_targets``), the box decode
  (``decode_boxes``) and the loss (BCE on the IoU-interpolated labels,
  smooth-L1 on the encoded residuals and the corner loss; ``loss``).

As in the reference, the proposals and the target assignment take no
gradient (``torch.no_grad``).  PV-RCNN's keypoint grid pooling is not
ported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...core import nms as nms_mod
from ...core.geometry import rotate_points_along_z
from ...core.module import Ctx, Params, apply_bn, dropout, init_bn, \
    init_linear
from ...utils import loss_utils as L
from ...utils.commu_utils import global_sum, group_size
from ..dense_heads.anchor_head import ResidualCoder
from .target_assigner.cagroup_proposal_target_layer import \
    ProposalTargetLayer

TWO_PI = 2 * math.pi


class PVRCNNHead(nn.Module):
    def __init__(self, model_cfg):
        super().__init__()
        self.nms_cfg = model_cfg.NMS_CONFIG

    @torch.no_grad()
    def proposal_layer(self, boxes: torch.Tensor, scores: torch.Tensor,
                       labels: torch.Tensor, valid: torch.Tensor,
                       train: bool):
        """One scene: boxes [A, 7] (decoded anchors), scores [A] (the
        best class's sigmoid), labels [A], valid [A] -> (rois [M, 7],
        roi_scores [M], roi_labels [M], roi_valid [M]) with M =
        min(NMS_POST_MAXSIZE, NMS_PRE_MAXSIZE, A), best first; ties go to
        the lower index, as ``jax.lax.top_k``'s do.  No gradient flows
        into the proposals (the reference's ``torch.no_grad``)."""
        nc = self.nms_cfg["TRAIN" if train else "TEST"]
        k = min(int(nc["NMS_PRE_MAXSIZE"]), boxes.shape[0])
        neg = torch.full_like(scores, -1.0)
        s, ids = nms_mod.topk_stable(torch.where(valid, scores, neg), k)
        b, lab = boxes[ids], labels[ids]
        v = s > -0.5
        keep = nms_mod.greedy_nms(b, torch.where(v, s, torch.full_like(
            s, -1.0)), v, float(nc["NMS_THRESH"]), rotated=True)
        v = v & keep
        m = min(int(nc["NMS_POST_MAXSIZE"]), k)
        so, oid = nms_mod.topk_stable(torch.where(v, s, torch.full_like(
            s, -1.0)), m)
        return b[oid], so, lab[oid], v[oid]

    # ------------------------------------------------------------ trunk
    def init_trunk(self, P: Params, S: Params, gen: torch.Generator,
                   num_class: int, cin: int) -> None:
        """Reads the trunk's config (the FC widths, ``DP_RATIO``, the target
        and loss configs) and adds its parameters under the JAX package's
        names: ``shared_fc_layer.{i}.weight`` [Cin, Cout] (no bias) and
        ``.bn.*``, ``{cls,reg}_layers.{i}.weight`` and ``.bn.*``,
        ``{cls,reg}_layers.out.weight`` and ``.bias``."""
        c = self.cfg
        self.num_class = 1 if c.get("CLASS_AGNOSTIC", True) else num_class
        self.shared_fc = [int(x) for x in c.SHARED_FC]
        self.cls_fc = [int(x) for x in c.CLS_FC]
        self.reg_fc = [int(x) for x in c.REG_FC]
        self.dp_ratio = float(c.get("DP_RATIO", 0.3))
        self.coder = ResidualCoder(7)
        tc = c.TARGET_CONFIG
        self.proposal_target_layer = ProposalTargetLayer(
            roi_per_image=int(tc.get("ROI_PER_IMAGE", 128)),
            fg_ratio=float(tc.get("FG_RATIO", 0.5)),
            reg_fg_thresh=float(tc.get("REG_FG_THRESH", 0.55)),
            cls_fg_thresh=float(tc.get("CLS_FG_THRESH", 0.75)),
            cls_bg_thresh=float(tc.get("CLS_BG_THRESH", 0.25)),
            cls_bg_thresh_l0=float(tc.get("CLS_BG_THRESH_LO", 0.1)),
            hard_bg_ratio=float(tc.get("HARD_BG_RATIO", 0.8)))
        lw = c.LOSS_CONFIG.LOSS_WEIGHTS
        self.w_cls = float(lw["rcnn_cls_weight"])
        self.w_reg = float(lw["rcnn_reg_weight"])
        self.w_corner = float(lw.get("rcnn_corner_weight", 1.0))
        self.code_weights = [float(x) for x in lw["code_weights"]]
        self.corner_loss = bool(
            c.LOSS_CONFIG.get("CORNER_LOSS_REGULARIZATION", True))
        for i, cout in enumerate(self.shared_fc):
            init_linear(P, gen, f"shared_fc_layer.{i}", cin, cout,
                        bias=False, init="kaiming")
            init_bn(P, S, f"shared_fc_layer.{i}.bn", cout)
            cin = cout
        for name, fcs, nout in (("cls", self.cls_fc, self.num_class),
                                ("reg", self.reg_fc,
                                 self.coder.code_size * self.num_class)):
            ci = self.shared_fc[-1]
            for i, cout in enumerate(fcs):
                init_linear(P, gen, f"{name}_layers.{i}", ci, cout,
                            bias=False, init="kaiming")
                init_bn(P, S, f"{name}_layers.{i}.bn", cout)
                ci = cout
            init_linear(P, gen, f"{name}_layers.out", ci, nout, bias=True,
                        init="normal")

    def get_global_grid_points(self, rois: torch.Tensor) -> torch.Tensor:
        """rois [R, 7] -> the cell centres of each RoI's G x G x G grid,
        rotated with it, [R, G^3, 3] (x-major, z fastest)."""
        g = self.grid_size
        idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                                   indexing="ij"), -1).reshape(-1, 3)
        idx = torch.as_tensor(idx, dtype=rois.dtype, device=rois.device)
        size = rois[:, None, 3:6]
        local = (idx[None] + 0.5) / g * size - size / 2
        return rotate_points_along_z(local, rois[:, 6]) + rois[:, None, :3]

    def _heads(self, P: Params, S: Params, ctx: Ctx, pooled: torch.Tensor,
               valid: torch.Tensor, scene_ctxs: Optional[List[Ctx]] = None,
               prefix: str = "roi_head"):
        """pooled [R, F] (or [B, R, F] with ``scene_ctxs``, whose BN pools
        the B scenes and whose dropout draws from each scene's ctx) ->
        (class logits [..., R, num_class], box residuals [..., R, 7 *
        num_class]).  BN updates go to ``ctx.updates``."""
        batched = scene_ctxs is not None

        def fc_bn_relu(x, pre):
            x = apply_bn(P, S, ctx, pre + ".bn", x @ P[pre + ".weight"],
                         valid, scene_axis=batched)
            return torch.where(valid[..., None], torch.relu(x),
                               torch.zeros_like(x))

        x = pooled
        n = len(self.shared_fc)
        for i in range(n):
            x = fc_bn_relu(x, f"{prefix}.shared_fc_layer.{i}")
            if i != n - 1 and self.dp_ratio > 0:
                x = torch.stack([dropout(c, xi, self.dp_ratio) for c, xi in
                                 zip(scene_ctxs, x)]) if batched else \
                    dropout(ctx, x, self.dp_ratio)
        outs = []
        for name, fcs in (("cls", self.cls_fc), ("reg", self.reg_fc)):
            y = x
            for i in range(len(fcs)):
                y = fc_bn_relu(y, f"{prefix}.{name}_layers.{i}")
            outs.append(y @ P[f"{prefix}.{name}_layers.out.weight"] +
                        P[f"{prefix}.{name}_layers.out.bias"])
        return outs[0], outs[1]

    @torch.no_grad()
    def sample_targets(self, generator, rois, roi_scores, roi_labels,
                       roi_valid, gt_boxes, gt_labels, gt_valid,
                       draws=None) -> Dict[str, torch.Tensor]:
        """One scene's RoI sampling (the GT boxes in the pcdet heading) and
        each sampled RoI's GT box in the RoI's canonical frame,
        ``gt_of_rois_ct``: moved to the RoI's centre, turned by minus its
        heading (taken mod 2 pi), the heading folded into [-pi/2, pi/2]
        (the reference's assign_targets).  ``%`` is floor-mod here
        (``torch.remainder``), as ``jnp``'s is."""
        tgt = self.proposal_target_layer(
            generator, rois, roi_scores, roi_labels, roi_valid, gt_boxes,
            gt_labels, gt_valid, draws=draws, flip_gt_heading=False)
        s_rois, gt = tgt["rois"], tgt["gt_of_rois"]
        roi_ry = torch.remainder(s_rois[:, 6], TWO_PI)
        gt_ct = torch.cat([gt[:, 0:3] - s_rois[:, 0:3], gt[:, 3:6],
                           gt[:, 6:7] - roi_ry[:, None], gt[:, 7:]], -1)
        gt_ct = rotate_points_along_z(gt_ct[:, None, :], -roi_ry)[:, 0, :]
        heading = torch.remainder(gt_ct[:, 6], TWO_PI)
        opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
        heading = torch.where(opposite, torch.remainder(heading + math.pi,
                                                        TWO_PI), heading)
        heading = torch.where(heading > math.pi, heading - TWO_PI, heading)
        heading = heading.clamp(-math.pi / 2, math.pi / 2)
        tgt["gt_of_rois_ct"] = torch.cat([gt_ct[:, :6], heading[:, None],
                                          gt_ct[:, 7:]], -1)
        return tgt

    def decode_boxes(self, rois: torch.Tensor,
                     rcnn_reg: torch.Tensor) -> torch.Tensor:
        """Boxes [..., 7] from the residuals rcnn_reg [..., 7] against the
        RoIs [..., 7] (the reference's generate_predicted_boxes): decoded
        in the RoI's frame, turned by its heading, moved to its centre."""
        local = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:7]],
                          -1)
        dec = self.coder.decode(rcnn_reg, local)
        shape = dec.shape
        dec = rotate_points_along_z(dec.reshape(-1, 1, 7),
                                    rois[..., 6].reshape(-1))[:, 0, :]
        dec = dec.reshape(shape)
        return torch.cat([dec[..., 0:3] + rois[..., 0:3], dec[..., 3:]], -1)

    def loss(self, fwd: Dict[str, torch.Tensor], group=None):
        """The R-CNN loss over every sampled RoI of the batch (leading
        scene axis): BCE (with logits) on the IoU-interpolated labels over
        the RoIs with a label, smooth-L1 on the encoded residuals of the
        foreground RoIs and, with ``CORNER_LOSS_REGULARIZATION``, the corner
        loss of their decoded boxes, each over its count.  Returns (loss,
        tb with ``rcnn_loss_cls``, ``rcnn_loss_reg``, ``rcnn_loss_corner``
        and ``rcnn_loss``).  With a process ``group`` of W ranks both
        counts are the global ones and each rank's terms are multiplied by
        W, so that the ranks' mean is the loss over every rank's RoIs
        (``parallel/mesh.global_terms``)."""
        W = group_size(group)
        rois = fwd["rois"].reshape(-1, fwd["rois"].shape[-1])
        gt_ct = fwd["gt_of_rois"].reshape(-1, fwd["gt_of_rois"].shape[-1])
        gt_src = fwd["gt_of_rois_src"].reshape(
            -1, fwd["gt_of_rois_src"].shape[-1])
        reg = fwd["rcnn_reg"].reshape(-1, fwd["rcnn_reg"].shape[-1])
        cls = fwd["rcnn_cls"].reshape(-1)
        cls_lab = fwd["rcnn_cls_labels"].reshape(-1)
        fg = fwd["reg_valid_mask"].reshape(-1) > 0
        fgf = fg.to(reg.dtype)

        cls_valid = (cls_lab >= 0).to(cls.dtype)
        t = cls_lab.clamp(min=0.0)
        bce = torch.relu(cls) - cls * t + torch.log1p(torch.exp(-cls.abs()))
        n_valid = global_sum(cls_valid.sum(), group).clamp(min=1.0)
        loss_cls = (bce * cls_valid).sum() / n_valid * (self.w_cls * W)

        anchors = torch.cat([torch.zeros_like(rois[:, 0:3]), rois[:, 3:6],
                             torch.zeros_like(rois[:, 6:7])], -1)
        targets = self.coder.encode(gt_ct[:, :7], anchors)
        elt = L.weighted_smooth_l1(reg, targets,
                                   code_weights=self.code_weights)
        fg_sum = global_sum(fgf.sum(), group).clamp(min=1.0)
        loss_reg = (elt * fgf[:, None]).sum() / fg_sum * (self.w_reg * W)
        tb = dict(rcnn_loss_cls=loss_cls, rcnn_loss_reg=loss_reg)
        total = loss_cls + loss_reg
        if self.corner_loss:
            dec = self.decode_boxes(rois, reg)
            safe = dec.new_tensor([0, 0, 0, 1, 1, 1, 0.0])
            decs = torch.where(fg[:, None], dec, safe)
            gts = torch.where(fg[:, None], gt_src[:, :7], safe)
            lc = L.get_corner_loss_lidar(decs, gts)
            loss_corner = (lc * fgf).sum() / fg_sum * (self.w_corner * W)
            tb["rcnn_loss_corner"] = loss_corner
            total = total + loss_corner
        tb["rcnn_loss"] = total
        return total, tb
