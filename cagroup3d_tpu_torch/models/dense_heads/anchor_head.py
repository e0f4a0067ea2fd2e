"""Anchor-based BEV head: AnchorHeadSingle, its anchors, box coder, target
assigner and loss.

Counterpart of ``cagroup3d_tpu/models/dense_heads/anchor_head.py`` (the
reference's anchor_head_template.py, anchor_head_single.py,
anchor_generator.py and box_coder_utils.ResidualCoder): 1x1 convs on the
BEV map give per-anchor class logits, box codes and direction-bin logits;
anchors are a fixed [A, 7] array in the layout [y][x][per-location anchor]
(the classes' grids concatenated along the per-location axis), so that
flat row i of the predictions is anchor i.  ``generate_predicted_boxes``
decodes, corrects headings by the direction bin and runs class-agnostic
rotated NMS.  As in the JAX package the NMS settings come from the head's
own ``NMS_CONFIG`` (else the top 1024 candidates, score 0.1, IoU 0.01) and
the output count from ``MAX_OUT`` (512).

Training (``assign_targets``, ``loss``) is the JAX package's
AxisAlignedTargetAssigner and anchor loss: per-class rotated-BEV IoU
matching with each class's matched / unmatched thresholds, a force match
of each valid GT's best anchor, ``ResidualCoder`` targets, then a focal
class loss, a smooth-L1 box loss on the sin-difference of the heading and
a direction-bin cross entropy, each normalized per scene by its positive
count.  The IoU matrix holds -1 off each anchor's class and for invalid
GTs, as in the JAX package; of the rest only the pairs whose BEV
circumscribed circles meet are computed (in blocks of ``BLOCK_PAIRS``),
every other pair's IoU is exactly 0, so the matrix is the JAX package's
without its 211,200 x 64 rotated clippings a KITTI scene.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...core import nms as nms_mod
from ...core.geometry import rotated_intersection_area
from ...core.module import Params, register_flat
from ...utils import loss_utils as L
from ...utils.commu_utils import group_size

BLOCK_PAIRS = 1 << 20       # rotated IoU pairs a block of the assigner


def bev_iou_pairs(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU of paired boxes [N, 7] x [N, 7] -> [N]: the JAX
    ``bev_iou``'s arithmetic (area floor 1e-6)."""
    inter = rotated_intersection_area(a7[:, [0, 1, 3, 4, 6]],
                                      b7[:, [0, 1, 3, 4, 6]])
    area_a = a7[:, 3] * a7[:, 4]
    area_b = b7[:, 3] * b7[:, 4]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def _bev_radius(b7: torch.Tensor) -> torch.Tensor:
    """Radius of each box's circumscribed circle in BEV."""
    return 0.5 * torch.sqrt(b7[:, 3] ** 2 + b7[:, 4] ** 2)


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = math.pi) -> torch.Tensor:
    return val - torch.floor(val / period + offset) * period


class ResidualCoder:
    """box_coder_utils.ResidualCoder: code_size > 7 appends plain residual
    extras after the angle terms; ``encode_angle_by_sincos`` codes the
    heading as (cos, sin) differences."""

    def __init__(self, code_size: int = 7,
                 encode_angle_by_sincos: bool = False):
        self.box_dim = code_size
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.sincos = encode_angle_by_sincos
        self.n_extra = code_size - 7

    def encode(self, boxes: torch.Tensor, anchors: torch.Tensor):
        anchors = torch.cat([anchors[..., :3], anchors[..., 3:6].clamp(
            min=1e-5), anchors[..., 6:]], dim=-1)
        boxes = torch.cat([boxes[..., :3], boxes[..., 3:6].clamp(min=1e-5),
                           boxes[..., 6:]], dim=-1)
        diag = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
        cols = [(boxes[..., 0] - anchors[..., 0]) / diag,
                (boxes[..., 1] - anchors[..., 1]) / diag,
                (boxes[..., 2] - anchors[..., 2]) / anchors[..., 5]]
        cols += [torch.log(boxes[..., i] / anchors[..., i]) for i in (3, 4, 5)]
        if self.sincos:
            cols += [torch.cos(boxes[..., 6]) - torch.cos(anchors[..., 6]),
                     torch.sin(boxes[..., 6]) - torch.sin(anchors[..., 6])]
        else:
            cols.append(boxes[..., 6] - anchors[..., 6])
        cols += [boxes[..., 7 + i] - anchors[..., 7 + i]
                 for i in range(self.n_extra)]
        return torch.stack(cols, dim=-1)

    def decode(self, enc: torch.Tensor, anchors: torch.Tensor):
        diag = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
        cols = [enc[..., 0] * diag + anchors[..., 0],
                enc[..., 1] * diag + anchors[..., 1],
                enc[..., 2] * anchors[..., 5] + anchors[..., 2]]
        cols += [torch.exp(enc[..., i]) * anchors[..., i] for i in (3, 4, 5)]
        if self.sincos:
            cols.append(torch.atan2(enc[..., 7] + torch.sin(anchors[..., 6]),
                                    enc[..., 6] + torch.cos(anchors[..., 6])))
        else:
            cols.append(enc[..., 6] + anchors[..., 6])
        na = 8 if self.sincos else 7
        cols += [enc[..., na + i] + anchors[..., 7 + i]
                 for i in range(self.n_extra)]
        return torch.stack(cols, dim=-1)


def generate_anchors(cfgs: List[dict], grid_size, pc_range):
    """anchor_generator.py: per class a grid [ny, nx, a_cls, 7] (numpy f32),
    y the slower spatial axis, per location (height, size, rotation)."""
    out = []
    for c in cfgs:
        stride = int(c["feature_map_stride"])
        nx, ny = grid_size[0] // stride, grid_size[1] // stride
        sizes = np.asarray(c["anchor_sizes"], np.float32)
        rots = np.asarray(c["anchor_rotations"], np.float32)
        heights = np.asarray(c["anchor_bottom_heights"], np.float32)
        if c.get("align_center", False):
            xs = (pc_range[3] - pc_range[0]) / nx
            ys = (pc_range[4] - pc_range[1]) / ny
            x0, y0 = xs / 2, ys / 2
        else:
            xs = (pc_range[3] - pc_range[0]) / max(nx - 1, 1)
            ys = (pc_range[4] - pc_range[1]) / max(ny - 1, 1)
            x0, y0 = 0.0, 0.0
        xc = pc_range[0] + x0 + np.arange(nx) * xs
        yc = pc_range[1] + y0 + np.arange(ny) * ys
        g = np.zeros((ny, nx, len(heights), len(sizes), len(rots), 7),
                     np.float32)
        g[..., 0] = xc[None, :, None, None, None]
        g[..., 1] = yc[:, None, None, None, None]
        g[..., 2] = heights[None, None, :, None, None] + \
            sizes[None, None, None, :, 2] / 2
        g[..., 3:6] = sizes[None, None, None, :, None]
        g[..., 6] = rots[None, None, None, None, :]
        out.append(g.reshape(ny, nx, -1, 7))
    return out


class AnchorTargets:
    """The anchors of a head and their target assigner.  A subclass sets
    ``anchors_np`` [A, box_dim], ``anchor_cls_np`` (each anchor's class),
    ``matched_thr_np`` / ``unmatched_thr_np`` (its class's thresholds),
    ``coder`` and an empty ``_consts``; the arrays go to a device once
    (no buffers: the parameter and state names stay the JAX package's)."""

    def _const(self, name: str, device) -> torch.Tensor:
        key = (name, torch.device(device))
        if key not in self._consts:
            self._consts[key] = torch.from_numpy(getattr(self, name)).to(
                device)
        return self._consts[key]

    def anchors(self, device) -> torch.Tensor:
        return self._const("anchors_np", device)

    def match_iou(self, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  gt_valid: torch.Tensor) -> torch.Tensor:
        """[A, G] rotated BEV IoU of every anchor with every GT of its own
        class, -1 elsewhere (other classes, invalid GTs): the JAX
        assigner's matrix.  Only the pairs whose BEV circumscribed circles
        meet are clipped; every other same-class pair is 0."""
        dev = gt_boxes.device
        anchors = self.anchors(dev)
        same = (self._const("anchor_cls_np", dev)[:, None] ==
                gt_labels[None, :]) & gt_valid[None, :]
        iou = torch.where(same, 0.0, -1.0)
        reach = _bev_radius(anchors)[:, None] + \
            _bev_radius(gt_boxes)[None, :] + 1e-3
        d2 = (anchors[:, None, 0] - gt_boxes[None, :, 0]) ** 2 + \
            (anchors[:, None, 1] - gt_boxes[None, :, 1]) ** 2
        ai, gi = torch.nonzero(same & (d2 <= reach * reach), as_tuple=True)
        for i in range(0, ai.numel(), BLOCK_PAIRS):
            a, g = ai[i:i + BLOCK_PAIRS], gi[i:i + BLOCK_PAIRS]
            iou[a, g] = bev_iou_pairs(anchors[a, :7], gt_boxes[g, :7])
        return iou

    @torch.no_grad()
    def assign_targets(self, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                       gt_valid: torch.Tensor):
        """One scene: (labels i64[A] (-1 ignore, 0 background, 1..K the
        class), regression targets [A, code], regression weights [A]).
        Each anchor takes the label and box of its own best GT (the first
        on ties); a valid GT's best anchor (the first on ties) is positive
        when that IoU is above 0; where several GTs force one anchor, the
        last of them decides, as the JAX package's scatter does."""
        dev = gt_boxes.device
        anchors = self.anchors(dev)
        iou = self.match_iou(gt_boxes, gt_labels, gt_valid)
        best_iou = iou.max(dim=1).values
        best_gt = torch.argmax(iou, dim=1)
        gt_best_iou = iou.max(dim=0).values
        gt_best_anchor = torch.argmax(iou, dim=0)
        G = gt_boxes.shape[0]
        last = torch.full((anchors.shape[0],), -1, dtype=torch.long,
                          device=dev).scatter_reduce(
            0, gt_best_anchor, torch.arange(G, device=dev), "amax")
        force = gt_valid & (gt_best_iou > 0)
        forced = (last >= 0) & force[last.clamp(min=0)]
        pos = (best_iou >= self._const("matched_thr_np", dev)) | forced
        neg = best_iou < self._const("unmatched_thr_np", dev)
        labels = torch.where(pos, gt_labels[best_gt].long() + 1,
                             torch.where(neg, 0, -1))
        tgt = self.coder.encode(gt_boxes[best_gt], anchors)
        tgt = torch.where(pos[:, None], tgt, 0.0)
        return labels, tgt, pos.to(torch.float32)


class AnchorHeadSingle(AnchorTargets, nn.Module):
    """Parameters under the JAX package's names: ``conv_cls.weight``
    [Cin, A*K] and ``.bias``, ``conv_box.*``, ``conv_dir_cls.*`` (A anchors
    a location, K classes)."""

    def __init__(self, model_cfg, num_class: int, class_names=None,
                 grid_size=None, point_cloud_range=None,
                 input_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, post_cfg=None):
        # post_cfg (the model's POST_PROCESSING) is not read: as in the JAX
        # package, this head's NMS takes its own NMS_CONFIG
        super().__init__()
        c = model_cfg
        self.num_class = num_class
        self.anchor_cfgs = [dict(a) for a in c.ANCHOR_GENERATOR_CONFIG]
        self.class_names = list(class_names or [a["class_name"] for a in
                                                self.anchor_cfgs])
        self.in_ch = int(c.get("IN_CHANNELS", input_channels or 256))
        self.use_dir = bool(c.get("USE_DIRECTION_CLASSIFIER", False))
        self.dir_offset = float(c.get("DIR_OFFSET", 0.78539))
        self.dir_limit_offset = float(c.get("DIR_LIMIT_OFFSET", 0.0))
        self.num_dir_bins = int(c.get("NUM_DIR_BINS", 2))
        bc = dict(c.get("BOX_CODER_CONFIG", {}) or {})
        self.coder = ResidualCoder(int(bc.get("code_size", 7)),
                                   bool(bc.get("encode_angle_by_sincos",
                                               False)))
        grids = generate_anchors(self.anchor_cfgs, list(grid_size),
                                 list(point_cloud_range))
        if len({g.shape[:2] for g in grids}) != 1:
            raise ValueError("anchor classes must share a feature_map_stride")
        anchors = np.concatenate(grids, axis=2).reshape(-1, 7)
        if self.coder.box_dim > 7:                 # zero-velocity anchors
            anchors = np.concatenate([anchors, np.zeros(
                (len(anchors), self.coder.box_dim - 7), np.float32)], axis=1)
        self.anchors_np = anchors                  # [A, box_dim]
        # per location the anchors' class and match thresholds, tiled
        ny, nx = grids[0].shape[:2]
        cls_ids, mt, ut = [], [], []
        for i, (a, g) in enumerate(zip(self.anchor_cfgs, grids)):
            cls_ids += [i] * g.shape[2]
            mt += [float(a["matched_threshold"])] * g.shape[2]
            ut += [float(a["unmatched_threshold"])] * g.shape[2]
        self.anchor_cls_np = np.tile(np.asarray(cls_ids, np.int32), ny * nx)
        self.matched_thr_np = np.tile(np.asarray(mt, np.float32), ny * nx)
        self.unmatched_thr_np = np.tile(np.asarray(ut, np.float32), ny * nx)
        self._consts: Dict = {}                    # per device (no buffers:
        # the parameter and state names stay the JAX package's)
        self.n_anchors_per_loc = sum(
            len(a["anchor_sizes"]) * len(a["anchor_rotations"]) *
            len(a["anchor_bottom_heights"]) for a in self.anchor_cfgs)
        nc = c.get("NMS_CONFIG", None)
        self.nms_pre = int(nc.get("NMS_PRE_MAXSIZE", 4096)) if nc else 1024
        self.score_thresh = float(nc.get("SCORE_THRESH", 0.1)) if nc else 0.1
        self.nms_thresh = float(nc.get("NMS_THRESH", 0.01)) if nc else 0.01
        self.max_out = int(c.get("MAX_OUT", 512))
        lw = c.LOSS_CONFIG.LOSS_WEIGHTS
        self.w_cls = float(lw["cls_weight"])
        self.w_loc = float(lw["loc_weight"])
        self.w_dir = float(lw.get("dir_weight", 0.2))
        self.code_weights = [float(x) for x in lw["code_weights"]]
        P = self._init(generator or torch.Generator().manual_seed(0))
        register_flat(self, P, {})

    def _init(self, gen: torch.Generator) -> Params:
        A, C = self.n_anchors_per_loc, self.in_ch
        P = {"conv_cls.weight": torch.randn(C, A * self.num_class,
                                            generator=gen) * 0.01,
             "conv_cls.bias": torch.full((A * self.num_class,),
                                         -math.log((1 - 0.01) / 0.01)),
             "conv_box.weight": torch.randn(C, A * self.coder.code_size,
                                            generator=gen) * 0.001,
             "conv_box.bias": torch.zeros(A * self.coder.code_size)}
        if self.use_dir:
            P["conv_dir_cls.weight"] = torch.randn(
                C, A * self.num_dir_bins, generator=gen) * 0.01
            P["conv_dir_cls.bias"] = torch.zeros(A * self.num_dir_bins)
        return P

    def forward(self, P: Params, bev: torch.Tensor,
                prefix: str = "dense_head", S: Optional[Params] = None,
                updates: Optional[Params] = None, sync=None) -> Dict:
        """bev [C, H, W] (or [B, C, H, W]) -> flat per-anchor predictions
        (row = anchor; [B, A, .] for a batch).  The head has no BN, so
        ``S``, ``updates`` and ``sync`` (``AnchorHeadMulti``'s) go
        unused."""
        lead = bev.shape[:-3]
        flat = bev.movedim(-3, -1).reshape(*lead, -1, bev.shape[-3])

        def conv(name, width):
            y = flat @ P[f"{prefix}.{name}.weight"] + \
                P[f"{prefix}.{name}.bias"]
            return y.reshape(*lead, -1, width)

        out = dict(cls_preds=conv("conv_cls", self.num_class),
                   box_preds=conv("conv_box", self.coder.code_size))
        if self.use_dir:
            out["dir_cls_preds"] = conv("conv_dir_cls", self.num_dir_bins)
        return out

    def loss(self, outs: Dict, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor, group=None):
        """The batch's anchor loss (outs [B, A, .], GT boxes [B, G, 7],
        labels [B, G], valid [B, G]): (loss, tb) with the terms
        ``rpn_loss_cls``, ``rpn_loss_loc``, ``rpn_loss_dir`` and their sum
        ``rpn_loss``.  The class loss is the JAX package's: the focal sum
        weighted by 1 / positives per scene, over the element count, over
        B.  With a process ``group`` of W ranks each rank's loss is its
        share of the loss over all W * B scenes (the ranks' mean is that
        loss, ``parallel/mesh.global_terms``): the box and direction terms
        are means over the scenes already, and the class term's element
        count and B are the global ones, so it is also divided by W."""
        targets = [self.assign_targets(b, l, v)
                   for b, l, v in zip(gt_boxes, gt_labels, gt_valid)]
        labels, tgt, reg_w = (torch.stack(t) for t in zip(*targets))
        B, K = labels.shape[0], self.num_class
        pos_norm = reg_w.sum(1, keepdim=True).clamp(min=1.0)
        cls_w = (labels >= 0).to(torch.float32) / pos_norm
        onehot = torch.nn.functional.one_hot(labels.clamp(0, K), K + 1)[
            ..., 1:].to(outs["cls_preds"].dtype)
        cls_loss = L.sigmoid_focal_loss(outs["cls_preds"], onehot,
                                        weight=cls_w) / (
            B * group_size(group)) * self.w_cls
        # sin-difference heading (anchor_head_template.py:117-131)
        bp, bt = outs["box_preds"], tgt
        if not self.coder.sincos:
            sin_p = torch.sin(bp[..., 6:7]) * torch.cos(bt[..., 6:7])
            sin_t = torch.cos(bp[..., 6:7]) * torch.sin(bt[..., 6:7])
            bp = torch.cat([bp[..., :6], sin_p, bp[..., 7:]], dim=-1)
            bt = torch.cat([bt[..., :6], sin_t, bt[..., 7:]], dim=-1)
        loc = L.weighted_smooth_l1(bp, bt, weights=reg_w / pos_norm,
                                   code_weights=self.code_weights)
        loc_loss = loc.sum() / B * self.w_loc
        total = cls_loss + loc_loss
        tb = dict(rpn_loss_cls=cls_loss, rpn_loss_loc=loc_loss)
        if self.use_dir and "dir_cls_preds" in outs:
            a6 = self.anchors(tgt.device)[None, :, 6]
            rot_gt = a6 if self.coder.sincos else tgt[..., 6] + a6
            offs = limit_period(rot_gt - self.dir_offset, 0, 2 * math.pi)
            dir_t = (offs / (2 * math.pi / self.num_dir_bins)).to(
                torch.int32).clamp(0, self.num_dir_bins - 1)
            dl = L.cross_entropy_with_logits(outs["dir_cls_preds"], dir_t)
            dir_loss = (dl * reg_w / pos_norm).sum() / B * self.w_dir
            total = total + dir_loss
            tb["rpn_loss_dir"] = dir_loss
        tb["rpn_loss"] = total
        return total, tb

    def decoded_boxes(self, outs: Dict):
        """Decode and direction-correct every anchor's box, no NMS:
        (boxes [A, 7], class scores [A, K])."""
        boxes = self.coder.decode(outs["box_preds"],
                                  self.anchors(outs["box_preds"].device))
        scores = torch.sigmoid(outs["cls_preds"])
        if self.use_dir and "dir_cls_preds" in outs:
            dir_lab = torch.argmax(outs["dir_cls_preds"], dim=-1)
            period = 2 * math.pi / self.num_dir_bins
            rot = limit_period(boxes[..., 6] - self.dir_offset,
                               self.dir_limit_offset, period)
            boxes = torch.cat([boxes[..., :6],
                               (rot + self.dir_offset + period *
                                dir_lab.to(rot.dtype))[..., None],
                               boxes[..., 7:]], dim=-1)
        return boxes, scores

    def generate_predicted_boxes(self, outs: Dict):
        """Decode + direction correction + class-agnostic rotated NMS over
        the top ``nms_pre`` anchors: (boxes [M, 7], scores [M], labels
        i32[M], valid [M]) with M = min(max_out, nms_pre), best first."""
        boxes, scores = self.decoded_boxes(outs)
        best = scores.max(dim=-1).values
        label = torch.argmax(scores, dim=-1).to(torch.int32)   # first on ties
        k = min(self.nms_pre, boxes.shape[0])
        ssel, ids = nms_mod.topk_stable(best, k)
        bsel, lsel = boxes[ids], label[ids]
        valid = ssel > self.score_thresh
        keep = nms_mod.greedy_nms(bsel, torch.where(
            valid, ssel, torch.full_like(ssel, -1.0)), valid,
            self.nms_thresh, rotated=True)
        valid = valid & keep
        m = min(self.max_out, k)
        _, oid = nms_mod.topk_stable(torch.where(
            valid, ssel, torch.full_like(ssel, -1.0)), m)
        return bsel[oid], ssel[oid], lsel[oid], valid[oid]
