"""Anchor-based BEV head: AnchorHeadSingle (eval), its anchors and box
coder.

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
the output count from ``MAX_OUT`` (512).  The target assigner and the loss
belong to training.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...core import nms as nms_mod
from ...core.module import Params, register_flat


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


class AnchorHeadSingle(nn.Module):
    """Parameters under the JAX package's names: ``conv_cls.weight``
    [Cin, A*K] and ``.bias``, ``conv_box.*``, ``conv_dir_cls.*`` (A anchors
    a location, K classes)."""

    def __init__(self, model_cfg, num_class: int, class_names=None,
                 grid_size=None, point_cloud_range=None,
                 input_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
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
        self._anchors: Dict = {}                   # per device (no buffer:
        # the parameter and state names stay the JAX package's)
        self.n_anchors_per_loc = sum(
            len(a["anchor_sizes"]) * len(a["anchor_rotations"]) *
            len(a["anchor_bottom_heights"]) for a in self.anchor_cfgs)
        nc = c.get("NMS_CONFIG", None)
        self.nms_pre = int(nc.get("NMS_PRE_MAXSIZE", 4096)) if nc else 1024
        self.score_thresh = float(nc.get("SCORE_THRESH", 0.1)) if nc else 0.1
        self.nms_thresh = float(nc.get("NMS_THRESH", 0.01)) if nc else 0.01
        self.max_out = int(c.get("MAX_OUT", 512))
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
                prefix: str = "dense_head") -> Dict:
        """bev [C, H, W] -> flat per-anchor predictions (row = anchor)."""
        flat = bev.permute(1, 2, 0).reshape(-1, bev.shape[0])   # [H*W, C]

        def conv(name, width):
            y = flat @ P[f"{prefix}.{name}.weight"] + \
                P[f"{prefix}.{name}.bias"]
            return y.reshape(-1, width)

        out = dict(cls_preds=conv("conv_cls", self.num_class),
                   box_preds=conv("conv_box", self.coder.code_size))
        if self.use_dir:
            out["dir_cls_preds"] = conv("conv_dir_cls", self.num_dir_bins)
        return out

    def anchors(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._anchors:
            self._anchors[device] = torch.from_numpy(self.anchors_np).to(
                device)
        return self._anchors[device]

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
