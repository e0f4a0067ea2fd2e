"""Multi-head anchor BEV head: AnchorHeadMulti.

Counterpart of ``cagroup3d_tpu/models/dense_heads/anchor_head_multi.py``
(the reference's anchor_head_multi.py): a shared 3x3 conv with BN and
ReLU, then one sub-head per class group of ``RPN_HEAD_CFGS``.  A sub-head
has a class branch and a box branch, 1x1 convs on the shared map, or with
``SEPARATE_REG_CONFIG`` a stack of 3x3 convs (BN, ReLU) per branch and one
per regression component of ``REG_LIST``; with a direction classifier, a
1x1 direction conv.  Each sub-head's predictions are anchor-major: flat
row a * H * W + y * W + x for per-location anchor a (its classes' anchors
in class order), as the reference lays them out with ``USE_MULTIHEAD``.

Training assigns each sub-head's anchors to the GTs of its classes with
``AnchorTargets.assign_targets`` (per-class IoU matching is head-local, so
this equals one global pass), normalizes by the positives over all heads,
and sums per head a focal class loss over the head's own class columns
(positives and negatives weighted ``pos_cls_weight`` / ``neg_cls_weight``),
an L1 box loss on the sin-difference of the heading and a direction-bin
cross entropy.  Prediction decodes every head, corrects headings by the
direction bin, scatters each head's class scores into the global class
axis and runs the per-class rotated NMS (``core/nms.multiclass_nms``) with
the model's ``POST_PROCESSING.NMS_CONFIG``.  The 3x3 convs and their BN
(momentum 0.01, eps 1e-3; in training over all B * H * W positions) are
``base_bev_backbone``'s.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...core import nms as nms_mod
from ...core.module import Params, init_bn, register_flat
from ...utils import loss_utils as L
from ...utils.commu_utils import group_size
from ..backbones_2d.base_bev_backbone import bn2d, conv2d_same
from .anchor_head import (AnchorTargets, ResidualCoder, generate_anchors,
                          limit_period)


class HeadAnchors(AnchorTargets):
    """One sub-head's anchors (anchor-major), their classes (global ids)
    and match thresholds."""

    def __init__(self, anchors, anchor_cls, matched, unmatched, coder):
        self.anchors_np = anchors
        self.anchor_cls_np = anchor_cls
        self.matched_thr_np = matched
        self.unmatched_thr_np = unmatched
        self.coder = coder
        self._consts: Dict = {}


def _anchor_major(y: torch.Tensor, A: int, K: int) -> torch.Tensor:
    """[..., H*W, A*K] (location-major) -> [..., A*H*W, K]."""
    lead, hw = y.shape[:-2], y.shape[-2]
    return y.reshape(*lead, hw, A, K).transpose(-3, -2).reshape(
        *lead, A * hw, K)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[..., C, H, W] -> [..., H*W, C]."""
    return x.movedim(-3, -1).reshape(*x.shape[:-3], -1, x.shape[-3])


class AnchorHeadMulti(nn.Module):
    """Parameters under the JAX package's names: ``shared_conv.weight``
    (HWIO) and ``shared_conv.bn.*``; per head ``head{i}.cls.*`` and
    ``head{i}.box.*`` (1x1: [Cin, A*K] and bias), or per branch
    ``head{i}.{name}.m{k}.*`` and ``.out.*`` (3x3), and ``head{i}.dir.*``."""

    def __init__(self, model_cfg, num_class: int, class_names=None,
                 grid_size=None, point_cloud_range=None,
                 input_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, post_cfg=None):
        super().__init__()
        c = model_cfg
        self.num_class = num_class
        cfgs = {a["class_name"]: dict(a) for a in c.ANCHOR_GENERATOR_CONFIG}
        self.class_names = list(class_names or list(cfgs))
        self.in_ch = int(c.get("IN_CHANNELS", input_channels or 512))
        self.shared_ch = int(c.get("SHARED_CONV_NUM_FILTER", 64))
        tac = c.get("TARGET_ASSIGNER_CONFIG", {}) or {}
        bc = dict(tac.get("BOX_CODER_CONFIG",
                          c.get("BOX_CODER_CONFIG", {})) or {})
        self.coder = ResidualCoder(int(bc.get("code_size", 7)),
                                   bool(bc.get("encode_angle_by_sincos",
                                               False)))
        src = c.get("SEPARATE_REG_CONFIG", None)
        self.separate_reg = src is not None
        self.reg_list: List[Tuple[str, int]] = []
        self.n_middle, self.mid_ch = 0, 0
        if self.separate_reg:
            for spec in src.REG_LIST:
                name, ch = str(spec).split(":")
                self.reg_list.append((name, int(ch)))
            if sum(ch for _, ch in self.reg_list) != self.coder.code_size:
                raise ValueError(f"REG_LIST {self.reg_list} does not add up "
                                 f"to the code size {self.coder.code_size}")
            self.n_middle = int(src.get("NUM_MIDDLE_CONV", 1))
            self.mid_ch = int(src.get("NUM_MIDDLE_FILTER", 64))
        self.use_dir = bool(c.get("USE_DIRECTION_CLASSIFIER", False))
        self.dir_offset = float(c.get("DIR_OFFSET", 0.78539))
        self.dir_limit_offset = float(c.get("DIR_LIMIT_OFFSET", 0.0))
        self.num_dir_bins = int(c.get("NUM_DIR_BINS", 2))

        self.heads: List[dict] = []
        for hc in c.RPN_HEAD_CFGS:
            names = list(hc["HEAD_CLS_NAME"])
            grids = generate_anchors([cfgs[n] for n in names],
                                     list(grid_size), list(point_cloud_range))
            if len({g.shape[:2] for g in grids}) != 1:
                raise ValueError("a head's classes must share a stride")
            anchors, acls, mt, ut = [], [], [], []
            for n, g in zip(names, grids):
                # [ny, nx, a_cls, 7] -> [a_cls, ny, nx, 7]: anchor-major
                anchors.append(np.transpose(g, (2, 0, 1, 3)).reshape(-1, 7))
                cnt = g.shape[0] * g.shape[1] * g.shape[2]
                acls += [self.class_names.index(n)] * cnt
                mt += [float(cfgs[n]["matched_threshold"])] * cnt
                ut += [float(cfgs[n]["unmatched_threshold"])] * cnt
            anc = np.concatenate(anchors, 0).astype(np.float32)
            if self.coder.box_dim > 7:             # zero-velocity anchors
                anc = np.concatenate([anc, np.zeros(
                    (len(anc), self.coder.box_dim - 7), np.float32)], 1)
            self.heads.append(dict(
                names=names,
                class_ids=[self.class_names.index(n) for n in names],
                n_anchors_per_loc=sum(g.shape[2] for g in grids),
                targets=HeadAnchors(anc, np.asarray(acls, np.int32),
                                    np.asarray(mt, np.float32),
                                    np.asarray(ut, np.float32), self.coder)))

        lw = c.LOSS_CONFIG.LOSS_WEIGHTS
        self.w_cls = float(lw["cls_weight"])
        self.w_loc = float(lw["loc_weight"])
        self.w_pos = float(lw.get("pos_cls_weight", 1.0))
        self.w_neg = float(lw.get("neg_cls_weight", 1.0))
        self.w_dir = float(lw.get("dir_weight", 0.2))
        self.code_weights = [float(x) for x in lw["code_weights"]]
        pp = post_cfg or {}
        nc = pp.get("NMS_CONFIG", c.get("NMS_CONFIG", {})) or {}
        self.score_thresh = float(pp.get("SCORE_THRESH",
                                         c.get("SCORE_THRESH", 0.1)))
        self.max_out = int(c.get("MAX_OUT", 512))
        self.nms_pre = int(nc.get("NMS_PRE_MAXSIZE", 1024))
        self.nms_post = int(nc.get("NMS_POST_MAXSIZE", self.max_out))
        self.nms_thresh = float(nc.get("NMS_THRESH", 0.2))
        P, S = self._init(generator or torch.Generator().manual_seed(0))
        register_flat(self, P, S)

    def _init(self, gen: torch.Generator):
        P: Params = {}
        S: Params = {}

        def conv(path, k, cin, cout):
            P[path + ".weight"] = torch.randn(k, k, cin, cout, generator=gen) \
                * math.sqrt(2.0 / (k * k * cout))

        def branch(path, cout, bias_init=0.0):
            cin = self.shared_ch
            for k in range(self.n_middle):
                conv(f"{path}.m{k}", 3, cin, self.mid_ch)
                init_bn(P, S, f"{path}.m{k}.bn", self.mid_ch)
                cin = self.mid_ch
            conv(f"{path}.out", 3, cin, cout)
            P[f"{path}.out.bias"] = torch.full((cout,), bias_init)

        def conv1x1(path, cout, bias_init=0.0, scale=0.01):
            P[f"{path}.weight"] = torch.randn(self.shared_ch, cout,
                                              generator=gen) * scale
            P[f"{path}.bias"] = torch.full((cout,), bias_init)

        conv("shared_conv", 3, self.in_ch, self.shared_ch)
        init_bn(P, S, "shared_conv.bn", self.shared_ch)
        prior = -math.log((1 - 0.01) / 0.01)
        for hi, h in enumerate(self.heads):
            A, K = h["n_anchors_per_loc"], len(h["names"])
            if self.separate_reg:
                branch(f"head{hi}.cls", A * K, prior)
                for name, ch in self.reg_list:
                    branch(f"head{hi}.{name}", A * ch)
            else:
                conv1x1(f"head{hi}.cls", A * K, prior)
                conv1x1(f"head{hi}.box", A * self.coder.code_size,
                        scale=0.001)
            if self.use_dir:
                conv1x1(f"head{hi}.dir", A * self.num_dir_bins)
        return P, S

    def _branch(self, P, S, path, x, updates, sync):
        for k in range(self.n_middle):
            x = torch.relu(bn2d(P, S, f"{path}.m{k}.bn",
                                conv2d_same(x, P[f"{path}.m{k}.weight"]),
                                updates, sync))
        y = conv2d_same(x, P[f"{path}.out.weight"])
        return _rows(y) + P[f"{path}.out.bias"]

    def forward(self, P: Params, bev: torch.Tensor,
                prefix: str = "dense_head", S: Optional[Params] = None,
                updates: Optional[Params] = None, sync=None) -> Dict:
        """bev [C, H, W] (or [B, C, H, W]) -> per head ``cls_preds_{i}``
        [(B,) A_i*H*W, K_i], ``box_preds_{i}`` and ``dir_preds_{i}``.
        ``S``: the model's buffers (the BN running statistics); in
        training ``updates`` receives the BN running-stat updates, and a
        ``sync`` pools the BN statistics over the ranks (``bn2d``)."""
        x = conv2d_same(bev, P[prefix + ".shared_conv.weight"])
        x = torch.relu(bn2d(P, S, prefix + ".shared_conv.bn", x, updates,
                            sync))
        flat = _rows(x)
        out: Dict = {}
        for hi, h in enumerate(self.heads):
            A, K = h["n_anchors_per_loc"], len(h["names"])
            pre = f"{prefix}.head{hi}"
            if self.separate_reg:
                out[f"cls_preds_{hi}"] = _anchor_major(
                    self._branch(P, S, pre + ".cls", x, updates, sync), A, K)
                out[f"box_preds_{hi}"] = torch.cat([_anchor_major(
                    self._branch(P, S, f"{pre}.{name}", x, updates, sync), A,
                    ch)
                    for name, ch in self.reg_list], dim=-1)
            else:
                out[f"cls_preds_{hi}"] = _anchor_major(
                    flat @ P[pre + ".cls.weight"] + P[pre + ".cls.bias"],
                    A, K)
                out[f"box_preds_{hi}"] = _anchor_major(
                    flat @ P[pre + ".box.weight"] + P[pre + ".box.bias"],
                    A, self.coder.code_size)
            if self.use_dir:
                out[f"dir_preds_{hi}"] = _anchor_major(
                    flat @ P[pre + ".dir.weight"] + P[pre + ".dir.bias"],
                    A, self.num_dir_bins)
        return out

    # ------------------------------------------------------------------
    def loss(self, outs: Dict, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor, group=None):
        """The batch's loss (outs with a leading scene axis, GT boxes
        [B, G, box_dim], labels [B, G], valid [B, G]): (loss, tb) with
        ``rpn_loss_cls``, ``rpn_loss_loc``, ``rpn_loss_dir`` and their sum
        ``rpn_loss``; the positives that normalize a scene are counted over
        every head.  With a process ``group`` each rank's loss is its share
        of the global one, as in ``AnchorHeadSingle.loss``."""
        per_head = []
        for h in self.heads:
            t = [h["targets"].assign_targets(b, l, v)
                 for b, l, v in zip(gt_boxes, gt_labels, gt_valid)]
            per_head.append(tuple(torch.stack(x) for x in zip(*t)))
        B, W = gt_boxes.shape[0], group_size(group)
        pos_norm = sum(w.sum(1) for _, _, w in per_head).clamp(
            min=1.0)[:, None]                                  # [B, 1]
        cls_total = loc_total = dir_total = 0.0
        for hi, (h, (labels, tgt, reg_w)) in enumerate(zip(self.heads,
                                                           per_head)):
            cls_w = torch.where(labels > 0, self.w_pos, torch.where(
                labels == 0, self.w_neg, 0.0)) / pos_norm
            cids = torch.tensor(h["class_ids"], device=labels.device)
            onehot = ((labels[..., None] - 1) == cids).to(
                outs[f"cls_preds_{hi}"].dtype)
            cls_total = cls_total + L.sigmoid_focal_loss(
                outs[f"cls_preds_{hi}"], onehot, weight=cls_w) / (B * W) * \
                self.w_cls
            bp, bt = outs[f"box_preds_{hi}"], tgt
            if not self.coder.sincos:
                sin_p = torch.sin(bp[..., 6:7]) * torch.cos(bt[..., 6:7])
                sin_t = torch.cos(bp[..., 6:7]) * torch.sin(bt[..., 6:7])
                bp = torch.cat([bp[..., :6], sin_p, bp[..., 7:]], dim=-1)
                bt = torch.cat([bt[..., :6], sin_t, bt[..., 7:]], dim=-1)
            loc = L.weighted_l1(bp, bt, weights=reg_w / pos_norm,
                                code_weights=self.code_weights)
            loc_total = loc_total + loc.sum() / B * self.w_loc
            if self.use_dir and f"dir_preds_{hi}" in outs:
                a6 = h["targets"].anchors(tgt.device)[None, :, 6]
                rot_gt = a6 if self.coder.sincos else tgt[..., 6] + a6
                offs = limit_period(rot_gt - self.dir_offset, 0, 2 * math.pi)
                dir_t = (offs / (2 * math.pi / self.num_dir_bins)).to(
                    torch.int32).clamp(0, self.num_dir_bins - 1)
                dl = L.cross_entropy_with_logits(outs[f"dir_preds_{hi}"],
                                                 dir_t)
                dir_total = dir_total + (dl * reg_w / pos_norm).sum() / B * \
                    self.w_dir
        total = cls_total + loc_total + dir_total
        tb = dict(rpn_loss_cls=cls_total, rpn_loss_loc=loc_total,
                  rpn_loss=total)
        if self.use_dir:
            tb["rpn_loss_dir"] = dir_total
        return total, tb

    # ------------------------------------------------------------------
    def decoded_boxes(self, outs: Dict):
        """Every head's anchors decoded and direction-corrected, no NMS:
        (boxes [A, box_dim], scores [A, num_class]) over the heads in
        order, each head's sigmoid scores in its classes' columns, 0 in
        the others."""
        all_boxes, all_scores = [], []
        for hi, h in enumerate(self.heads):
            bp = outs[f"box_preds_{hi}"]
            boxes = self.coder.decode(bp, h["targets"].anchors(bp.device))
            if self.use_dir and f"dir_preds_{hi}" in outs:
                dir_lab = torch.argmax(outs[f"dir_preds_{hi}"], dim=-1)
                period = 2 * math.pi / self.num_dir_bins
                rot = limit_period(boxes[..., 6] - self.dir_offset,
                                   self.dir_limit_offset, period)
                boxes = torch.cat([boxes[..., :6], (
                    rot + self.dir_offset + period *
                    dir_lab.to(rot.dtype))[..., None], boxes[..., 7:]],
                    dim=-1)
            sc = torch.sigmoid(outs[f"cls_preds_{hi}"])
            full = sc.new_zeros(sc.shape[0], self.num_class)
            full[:, h["class_ids"]] = sc
            all_boxes.append(boxes)
            all_scores.append(full)
        return torch.cat(all_boxes, 0), torch.cat(all_scores, 0)

    def generate_predicted_boxes(self, outs: Dict):
        """One scene: per-class rotated NMS over every head's decoded
        anchors (the top ``NMS_PRE_MAXSIZE`` of each class above the score
        threshold): (boxes [M, box_dim], scores [M], labels i32[M], valid
        [M]) with M = ``NMS_POST_MAXSIZE``, best first."""
        boxes, scores = self.decoded_boxes(outs)
        b, s, lab, ok = nms_mod.multiclass_nms(
            boxes, scores, torch.ones(boxes.shape[0], dtype=torch.bool,
                                      device=boxes.device),
            self.score_thresh, self.nms_thresh, rotated=True,
            per_cls_cap=min(self.nms_pre, boxes.shape[0]),
            out_cap=self.nms_post, flip_heading_for_iou=False)
        return b, s, lab.to(torch.int32), ok
