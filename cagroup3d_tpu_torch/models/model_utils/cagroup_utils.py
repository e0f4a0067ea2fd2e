"""CAGroup3D model utilities: residual box coding and bias init.

Counterpart of ``cagroup3d_tpu/models/model_utils/cagroup_utils.py``.
"""
from __future__ import annotations

import math

import torch


def bias_init_with_prob(prior_prob: float) -> float:
    return float(-math.log((1 - prior_prob) / prior_prob))


class CAGroupResidualCoder:
    """Residual box code relative to rois: xyz normalized by the anchor's
    BEV diagonal / dz, log-ratio sizes, and for ``code_size`` 7 with
    ``encode_angle_by_sincos`` the heading as (cos, sin) of the box's own
    heading (code size 8).  The JAX package's heading delta (code size 7
    without sin/cos), which no configuration uses, is not ported."""

    def __init__(self, code_size: int = 6,
                 encode_angle_by_sincos: bool = False):
        if code_size > 6 and not encode_angle_by_sincos:
            raise NotImplementedError("a heading code is ported as (cos, "
                                      "sin) only (ENCODE_SINCOS: True)")
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes: torch.Tensor, anchors: torch.Tensor):
        anchors = torch.cat([anchors[..., :3],
                             anchors[..., 3:6].clamp(min=1e-5),
                             anchors[..., 6:]], dim=-1)
        boxes = torch.cat([boxes[..., :3], boxes[..., 3:6].clamp(min=1e-5),
                           boxes[..., 6:]], dim=-1)
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
        dxg, dyg, dzg = boxes[..., 3], boxes[..., 4], boxes[..., 5]
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        out = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
               torch.log(dxg / dxa), torch.log(dyg / dya),
               torch.log(dzg / dza)]
        if self.code_size > 6:
            out += [torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])]
        return torch.stack(out, dim=-1)

    def decode(self, encodings: torch.Tensor, anchors: torch.Tensor):
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        xt, yt, zt = encodings[..., 0], encodings[..., 1], encodings[..., 2]
        dxt, dyt, dzt = encodings[..., 3], encodings[..., 4], encodings[..., 5]
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        out = [xt * diag + xa, yt * diag + ya, zt * dza + za,
               torch.exp(dxt) * dxa, torch.exp(dyt) * dya,
               torch.exp(dzt) * dza]
        if self.code_size > 6:
            sint, cost = encodings[..., 7], encodings[..., 6]
            # a zero row (padding) would give atan2(0, 0): NaN cotangents
            cost = torch.where((sint.abs() + cost.abs()) < 1e-8,
                               torch.full_like(cost, 1e-8), cost)
            out += [torch.atan2(sint, cost) + anchors[..., 6]]
        return torch.stack(out, dim=-1)
