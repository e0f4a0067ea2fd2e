"""Anchor-free BEV head: CenterHead, its heatmap targets, loss and peak
decode.

Counterpart of ``cagroup3d_tpu/models/dense_heads/center_head.py`` (the
reference's pcdet/models/dense_heads/center_head.py): a shared 3x3 conv
with BN and ReLU, then per class group of ``CLASS_NAMES_EACH_HEAD`` one
separate head per ``HEAD_DICT`` entry and ``hm``, each ``num_conv - 1``
3x3 convs with BN and ReLU and one biased 3x3 conv (``hm``'s bias -2.19).
The 3x3 convs and their BN (momentum 0.01, eps 1e-3; in training over all
B * H * W positions, and over the ranks' maps with a ``sync``) are
``base_bev_backbone``'s.  The outputs are one flat dict of channels-first
maps, ``{name}_{g}`` for head ``name`` of group g.

Training draws each group's dense gaussian heatmap over the objects of its
classes (``centernet_utils.draw_gaussians_dense``, about the map cell the
center floors to, the radius from ``gaussian_radius`` truncated and at
least ``MIN_RADIUS``) and the regression target at the cell the center
truncates to: the center's offset in the cell, z, the log of the sizes and
(cos, sin) of the heading.  The loss per group is the penalty-reduced focal
loss of the clipped sigmoid heatmap over the positives' count, plus the L1
of the gathered regression maps over the valid objects, weighted per code.
Prediction takes the top ``MAX_OBJ_PER_SAMPLE`` peaks of each group's
heatmap, decodes them (``atan2(sin, cos)`` for the heading), keeps those
inside ``POST_CENTER_LIMIT_RANGE`` above ``SCORE_THRESH``, then runs a
class-agnostic rotated greedy NMS over the top ``NMS_PRE_MAXSIZE`` and
returns the best ``NMS_POST_MAXSIZE``.

With a process ``group`` of W ranks (``--dist``) the loss's two batch-wide
normalizers, the heatmap's positive count (and with it the no-positive
case) and the L1's object count, are global sums over the ranks, and each
rank's loss is W times its own terms over them: the ranks' mean is the
loss of one process over all W * B scenes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from ...core import nms as nms_mod
from ...core.gather import take_rows
from ...core.module import Params, init_bn, register_flat
from ...utils import loss_utils as L
from ...utils.commu_utils import global_sum, group_size
from ..backbones_2d.base_bev_backbone import bn2d, conv2d_same
from ..model_utils.centernet_utils import (draw_gaussians_dense,
                                           gaussian_radius, topk_peaks)


class CenterHead(nn.Module):
    """Parameters under the JAX package's names: ``shared_conv.weight``
    (HWIO) and ``shared_conv.bn.*``; per group g and head ``name``
    ``heads.{g}.{name}.{k}.weight`` and ``.bn.*`` for its middle convs and
    ``heads.{g}.{name}.out.weight`` / ``.bias``."""

    READS_VOXEL_SIZE = True

    def __init__(self, model_cfg, num_class: int, class_names=None,
                 grid_size=None, point_cloud_range=None, voxel_size=None,
                 input_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, post_cfg=None):
        super().__init__()
        c = model_cfg
        self.class_names = list(class_names)
        self.grid_size = [int(g) for g in grid_size]
        self.pc_range = [float(x) for x in point_cloud_range]
        self.voxel_size = [float(v) for v in c.get(
            "VOXEL_SIZE", voxel_size or [0.05, 0.05, 0.1])]
        self.in_ch = int(c.get("IN_CHANNELS", input_channels or 256))
        self.shared_ch = int(c.SHARED_CONV_CHANNEL)
        self.num_hm_conv = int(c.get("NUM_HM_CONV", 2))
        ta = c.TARGET_ASSIGNER_CONFIG
        self.fmap_stride = int(ta.FEATURE_MAP_STRIDE)
        self.gaussian_overlap = float(ta.get("GAUSSIAN_OVERLAP", 0.1))
        self.min_radius = int(ta.get("MIN_RADIUS", 2))
        self.head_order = list(c.SEPARATE_HEAD_CFG.HEAD_ORDER)
        self.head_dict = {k: dict(v) for k, v in
                          dict(c.SEPARATE_HEAD_CFG.HEAD_DICT).items()}
        self.code_size = sum(int(self.head_dict[h]["out_channels"])
                             for h in self.head_order)
        self.groups: List[List[str]] = [
            [x for x in names if x in self.class_names]
            for names in c.CLASS_NAMES_EACH_HEAD]
        self.group_class_ids = [
            [self.class_names.index(x) for x in g] for g in self.groups]
        lw = c.LOSS_CONFIG.LOSS_WEIGHTS
        self.w_cls = float(lw["cls_weight"])
        self.w_loc = float(lw["loc_weight"])
        self.code_weights = [float(x) for x in lw["code_weights"]]
        pp = c.POST_PROCESSING
        self.score_thresh = float(pp.get("SCORE_THRESH", 0.1))
        self.post_range = [float(x) for x in pp.POST_CENTER_LIMIT_RANGE]
        self.max_obj = int(pp.get("MAX_OBJ_PER_SAMPLE", 500))
        nc = pp.get("NMS_CONFIG", {}) or {}
        self.nms_pre = int(nc.get("NMS_PRE_MAXSIZE", 1000))
        self.nms_post = int(nc.get("NMS_POST_MAXSIZE", 83))
        self.nms_thresh = float(nc.get("NMS_THRESH", 0.2))
        self.fmap_hw = (self.grid_size[1] // self.fmap_stride,
                        self.grid_size[0] // self.fmap_stride)
        P, S = self._init(generator or torch.Generator().manual_seed(0))
        register_flat(self, P, S)

    def group_heads(self, gi: int):
        """Group gi's heads in the JAX package's order, (name, out
        channels, convs): ``HEAD_DICT``'s, then ``hm``."""
        heads = [(h, int(v["out_channels"]), int(v["num_conv"]))
                 for h, v in self.head_dict.items()]
        return heads + [("hm", len(self.groups[gi]), self.num_hm_conv)]

    def _init(self, gen: torch.Generator):
        P: Params = {}
        S: Params = {}

        def conv(path, cin, cout):
            P[path + ".weight"] = torch.randn(3, 3, cin, cout, generator=gen) \
                * math.sqrt(2.0 / (9 * cout))

        conv("shared_conv", self.in_ch, self.shared_ch)
        init_bn(P, S, "shared_conv.bn", self.shared_ch)
        for gi in range(len(self.groups)):
            for name, cout, n_conv in self.group_heads(gi):
                for k in range(n_conv - 1):
                    path = f"heads.{gi}.{name}.{k}"
                    conv(path, self.shared_ch, self.shared_ch)
                    init_bn(P, S, path + ".bn", self.shared_ch)
                conv(f"heads.{gi}.{name}.out", self.shared_ch, cout)
                P[f"heads.{gi}.{name}.out.bias"] = torch.full(
                    (cout,), -2.19 if name == "hm" else 0.0)
        return P, S

    def forward(self, P: Params, bev: torch.Tensor,
                prefix: str = "dense_head", S: Optional[Params] = None,
                updates: Optional[Params] = None, sync=None) -> Dict:
        """bev [C, H, W] (or [B, C, H, W]) -> ``{name}_{g}`` maps
        [(B,) c, H, W].  ``S``: the BN running statistics; in training
        ``updates`` receives the BN running-stat updates, and a ``sync``
        pools the BN statistics over the ranks (``bn2d``)."""
        x = conv2d_same(bev, P[prefix + ".shared_conv.weight"])
        x = torch.relu(bn2d(P, S, prefix + ".shared_conv.bn", x, updates,
                            sync))
        out: Dict = {}
        for gi in range(len(self.groups)):
            for name, _, n_conv in self.group_heads(gi):
                y = x
                for k in range(n_conv - 1):
                    path = f"{prefix}.heads.{gi}.{name}.{k}"
                    y = torch.relu(bn2d(P, S, path + ".bn", conv2d_same(
                        y, P[path + ".weight"]), updates, sync))
                path = f"{prefix}.heads.{gi}.{name}.out"
                out[f"{name}_{gi}"] = conv2d_same(y, P[path + ".weight"]) + \
                    P[path + ".bias"][:, None, None]
        return out

    # ------------------------------------------------------------------
    def assign_targets_single(self, gt_boxes: torch.Tensor,
                              gt_labels: torch.Tensor,
                              gt_valid: torch.Tensor) -> List[Dict]:
        """One scene's targets per group (GT boxes [G, 7+], 0-based labels
        [G], valid [G]): ``heatmap`` [C_g, H, W], ``target`` [G, code],
        ``inds`` [G] (the flat map cell y * W + x) and ``mask`` [G] (the
        group's valid objects with positive sizes)."""
        Hf, Wf = self.fmap_hw
        dev = gt_boxes.device
        # tensors, not Python floats: a CUDA division by a Python scalar
        # multiplies by its reciprocal, which floors other cells
        vs = torch.tensor(self.voxel_size[:2], device=dev)
        pc = torch.tensor(self.pc_range[:2], device=dev)
        out = []
        for cls_ids in self.group_class_ids:
            ids = torch.tensor(cls_ids, device=dev)
            in_group = gt_labels[:, None] == ids[None, :]       # [G, C_g]
            local_cls = torch.argmax(in_group.to(torch.int32), dim=1)
            gvalid = in_group.any(dim=1) & gt_valid
            cx = (gt_boxes[:, 0] - pc[0]) / vs[0] / self.fmap_stride
            cy = (gt_boxes[:, 1] - pc[1]) / vs[1] / self.fmap_stride
            cx = cx.clamp(0.0, Wf - 0.5)
            cy = cy.clamp(0.0, Hf - 0.5)
            dxf = gt_boxes[:, 3] / vs[0] / self.fmap_stride
            dyf = gt_boxes[:, 4] / vs[1] / self.fmap_stride
            gvalid = gvalid & (dxf > 0) & (dyf > 0)
            radius = gaussian_radius(dyf, dxf, self.gaussian_overlap).to(
                torch.int32).clamp(min=self.min_radius)
            hm = draw_gaussians_dense(torch.stack([cx, cy], -1), radius,
                                      local_cls, gvalid, len(cls_ids),
                                      (Hf, Wf))
            cxi = cx.to(torch.int32)
            cyi = cy.to(torch.int32)
            tgt = torch.cat([
                (cx - cxi)[:, None], (cy - cyi)[:, None], gt_boxes[:, 2:3],
                torch.log(gt_boxes[:, 3:6].clamp(min=1e-6)),
                torch.cos(gt_boxes[:, 6:7]), torch.sin(gt_boxes[:, 6:7])],
                dim=-1)
            if self.code_size > 8:
                tgt = torch.cat([tgt, tgt.new_zeros(
                    tgt.shape[0], self.code_size - 8)], dim=-1)
            out.append(dict(heatmap=hm, target=tgt, inds=cyi * Wf + cxi,
                            mask=gvalid))
        return out

    def loss(self, outs: Dict, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor, group=None):
        """The batch's loss (maps [B, c, H, W], GT boxes [B, G, 7+],
        0-based labels [B, G], valid [B, G]): (loss, tb) with
        ``hm_loss_head_{g}``, ``loc_loss_head_{g}`` and their sum
        ``rpn_loss``.  With a process ``group`` of W ranks the positives and
        the objects that normalize the terms are counted over every rank
        and the terms multiplied by W (the module docstring)."""
        tgts = [self.assign_targets_single(b, lab, v)
                for b, lab, v in zip(gt_boxes, gt_labels, gt_valid)]
        W = group_size(group)
        total = 0.0
        tb = {}
        for gi in range(len(self.groups)):
            hm_t, target, inds, mask = (
                torch.stack([t[gi][k] for t in tgts])
                for k in ("heatmap", "target", "inds", "mask"))
            logits = outs[f"hm_{gi}"]
            hm_pred = torch.minimum(torch.maximum(
                torch.sigmoid(logits), logits.new_tensor(1e-4)),
                logits.new_tensor(1 - 1e-4))
            n_pos = global_sum((hm_t >= 1.0).sum().to(hm_pred.dtype), group)
            hm_loss = L.focal_loss_centernet(hm_pred, hm_t, n_pos=n_pos) * \
                (self.w_cls * W)
            pred = torch.cat([outs[f"{h}_{gi}"] for h in self.head_order],
                             dim=1)                          # [B, code, H, W]
            # rows by indexing: its backward adds duplicates in a fixed
            # order, where ``torch.gather``'s adds with CUDA atomics
            picked = torch.stack([take_rows(f, i) for f, i in zip(
                pred.flatten(2).transpose(1, 2), inds)])     # [B, G, code]
            m = mask.to(pred.dtype)[..., None]
            diff = (picked - target).abs() * m
            num = global_sum(m.sum(), group).clamp(min=1e-4)
            per_code = diff.sum(dim=(0, 1)) / num
            cw = torch.tensor(self.code_weights[:per_code.shape[0]],
                              dtype=per_code.dtype, device=per_code.device)
            loc_loss = (per_code * cw).sum() * (self.w_loc * W)
            total = total + hm_loss + loc_loss
            tb[f"hm_loss_head_{gi}"] = hm_loss
            tb[f"loc_loss_head_{gi}"] = loc_loss
        tb["rpn_loss"] = total
        return total, tb

    # ------------------------------------------------------------------
    def _decode_groups(self, outs: Dict):
        """One scene's top-k peaks of every group, decoded: (boxes [M, 7],
        scores [M], labels i32[M] (0-based), valid [M])."""
        Hf, Wf = self.fmap_hw
        K = min(self.max_obj, Hf * Wf)
        all_boxes, all_scores, all_labels, all_valid = [], [], [], []
        for gi, cls_ids in enumerate(self.group_class_ids):
            hm = torch.sigmoid(outs[f"hm_{gi}"])
            dev = hm.device
            scores, local_cls, pix, ys, xs = topk_peaks(hm, K)
            pix = pix.long()

            def take(name):
                return outs[f"{name}_{gi}"].flatten(1)[:, pix].T  # [K, c]

            center, center_z, rot = take("center"), take("center_z"), \
                take("rot")
            dim = torch.exp(take("dim"))
            angle = torch.atan2(rot[:, 1:2], rot[:, 0:1])
            xs = (xs[:, None] + center[:, 0:1]) * self.fmap_stride * \
                self.voxel_size[0] + self.pc_range[0]
            ys = (ys[:, None] + center[:, 1:2]) * self.fmap_stride * \
                self.voxel_size[1] + self.pc_range[1]
            boxes = torch.cat([xs, ys, center_z, dim, angle], dim=-1)
            pr = torch.tensor(self.post_range, device=dev)
            ok = (boxes[:, :3] >= pr[:3]).all(dim=1) & \
                (boxes[:, :3] <= pr[3:]).all(dim=1) & \
                (scores > self.score_thresh)
            labels = torch.tensor(cls_ids, dtype=torch.int32,
                                  device=dev)[local_cls.long()]
            all_boxes.append(boxes)
            all_scores.append(scores)
            all_labels.append(labels)
            all_valid.append(ok)
        return (torch.cat(all_boxes), torch.cat(all_scores),
                torch.cat(all_labels), torch.cat(all_valid))

    def decoded_boxes(self, outs: Dict):
        """Every group's decoded peaks, no NMS: (boxes [M, 7], class scores
        [M, len(class_names)], the peak's score in its class's column and 0
        elsewhere or where it is not valid)."""
        boxes, scores, labels, valid = self._decode_groups(outs)
        full = scores.new_zeros(boxes.shape[0], len(self.class_names))
        full[torch.arange(boxes.shape[0], device=boxes.device),
             labels.long()] = torch.where(valid, scores,
                                          torch.zeros_like(scores))
        return boxes, full

    def generate_predicted_boxes(self, outs: Dict):
        """One scene: the valid peaks' top ``NMS_PRE_MAXSIZE``, rotated
        greedy NMS, the best ``NMS_POST_MAXSIZE``: (boxes [M, 7], scores
        [M] (-1 where not valid), labels i32[M], valid [M]), best first."""
        boxes, scores, labels, valid = self._decode_groups(outs)
        neg = torch.full_like(scores, -1.0)
        k = min(self.nms_pre, boxes.shape[0])
        s, ids = nms_mod.topk_stable(torch.where(valid, scores, neg), k)
        b, lab, v = boxes[ids], labels[ids], s > -0.5
        neg = neg[:k]
        keep = nms_mod.greedy_nms(b, torch.where(v, s, neg), v,
                                  self.nms_thresh, rotated=True)
        v = v & keep
        so, oid = nms_mod.topk_stable(torch.where(v, s, neg),
                                      min(self.nms_post, k))
        return b[oid], so, lab[oid], v[oid]
