"""CAGroup3D model utilities: residual box coding and bias init.

Counterpart of ``cagroup3d_tpu/models/model_utils/cagroup_utils.py``.
"""
from __future__ import annotations

import math

import torch


def bias_init_with_prob(prior_prob: float) -> float:
    return float(-math.log((1 - prior_prob) / prior_prob))


class CAGroupResidualCoder:
    """Residual box code relative to rois, axis-aligned (code size 6): xyz
    normalized by the anchor's BEV diagonal / dz, log-ratio sizes.  The
    yaw codes belong to the SUN RGB-D path, not ported yet."""

    code_size = 6

    @staticmethod
    def encode(boxes: torch.Tensor, anchors: torch.Tensor):
        anchors = torch.cat([anchors[..., :3],
                             anchors[..., 3:6].clamp(min=1e-5)], dim=-1)
        boxes = torch.cat([boxes[..., :3], boxes[..., 3:6].clamp(min=1e-5)],
                          dim=-1)
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
        dxg, dyg, dzg = boxes[..., 3], boxes[..., 4], boxes[..., 5]
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([(xg - xa) / diag, (yg - ya) / diag,
                            (zg - za) / dza, torch.log(dxg / dxa),
                            torch.log(dyg / dya), torch.log(dzg / dza)],
                           dim=-1)

    @staticmethod
    def decode(encodings: torch.Tensor, anchors: torch.Tensor):
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        xt, yt, zt = encodings[..., 0], encodings[..., 1], encodings[..., 2]
        dxt, dyt, dzt = encodings[..., 3], encodings[..., 4], encodings[..., 5]
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([xt * diag + xa, yt * diag + ya, zt * dza + za,
                            torch.exp(dxt) * dxa, torch.exp(dyt) * dya,
                            torch.exp(dzt) * dza], dim=-1)
