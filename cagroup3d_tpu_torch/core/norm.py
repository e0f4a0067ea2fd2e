"""Masked batch norm (eval) and activations over valid voxels.

Counterpart of ``cagroup3d_tpu/core/norm.py``: ME.MinkowskiBatchNorm over
the voxel axis, normalizing with the running statistics; invalid rows
stay zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .sparse import zero_invalid


def masked_batch_norm(x: torch.Tensor, mask: torch.Tensor, weight, bias,
                      running_mean, running_var,
                      eps: float = 1e-5) -> torch.Tensor:
    y = (x - running_mean) * torch.rsqrt(running_var + eps) * weight + bias
    return zero_invalid(y, mask)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)
