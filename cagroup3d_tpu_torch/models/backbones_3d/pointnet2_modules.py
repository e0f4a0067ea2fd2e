"""PointNet++ set-abstraction and feature-propagation modules.

Counterpart of ``cagroup3d_tpu/models/backbones_3d/pointnet2_modules.py``
(``SAModule``, ``FPModule``; RBGNet does not use the multi-scale
``SAModuleMSG``), over the batched ops of ``core/pointnet2.py``: inputs
carry a leading scene axis.  Parameters are filled into flat dicts under
the JAX package's names; the enclosing module registers them.

Batch norm in a shared MLP normalizes the rows of every scene at once,
which in training pools the statistics over the step's scenes, as the JAX
package's ``psum`` over its scene axis does.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ...core import pointnet2 as pn2
from ...core.module import Ctx, Params, apply_bn, init_bn, init_linear


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: a tie at 0 splits the gradient in half."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def bn_rows(P: Params, S: Params, ctx: Ctx, path: str, x: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Masked BN of x [B, ..., C] over all its rows (mask [B, ...]), the
    scenes' sums added in scene order."""
    shape = x.shape
    y = apply_bn(P, S, ctx, path, x.reshape(shape[0], -1, shape[-1]),
                 mask.reshape(shape[0], -1), scene_axis=True)
    return y.reshape(shape)


def masked_relu(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], relu(x),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def init_shared_mlp(P: Params, S: Params, gen: torch.Generator, path: str,
                    channels: List[int]) -> None:
    """Conv2d-k1 + BN + ReLU stack == per-point Linear + BN + ReLU."""
    for i in range(len(channels) - 1):
        init_linear(P, gen, f"{path}.{i}.conv", channels[i], channels[i + 1],
                    bias=False, init="xavier")
        init_bn(P, S, f"{path}.{i}.bn", channels[i + 1])


def apply_shared_mlp(P: Params, S: Params, ctx: Ctx, path: str,
                     x: torch.Tensor, mask: torch.Tensor,
                     n_layers: int) -> torch.Tensor:
    """x [..., C]; mask broadcastable to x[..., 0]."""
    m = torch.broadcast_to(mask, x.shape[:-1])
    for i in range(n_layers):
        x = x @ P[f"{path}.{i}.conv.weight"]
        x = masked_relu(bn_rows(P, S, ctx, f"{path}.{i}.bn", x, m), m)
    return x


class SAModule:
    """Set abstraction: centers (FPS unless ``sample_idx`` is given),
    ball-query grouping, shared MLP, max-pool (PointnetSAModule)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 mlp: List[int], use_xyz: bool = True):
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.mlp = ([mlp[0] + 3] if use_xyz else [mlp[0]]) + list(mlp[1:])
        self.use_xyz = use_xyz

    def init(self, P: Params, S: Params, gen: torch.Generator,
             path: str) -> None:
        init_shared_mlp(P, S, gen, path + ".mlps.0", self.mlp)

    def __call__(self, P, S, ctx: Ctx, path: str, xyz, feats, valid,
                 sample_idx: Optional[torch.Tensor] = None):
        """xyz [B, N, 3], feats [B, N, C] or None, valid [B, N].  Returns
        (new_xyz [B, M, 3], new_feats [B, M, C'], new_valid [B, M],
        sample_idx [B, M])."""
        if sample_idx is None:
            sample_idx = pn2.farthest_point_sample(xyz, valid, self.npoint)
        new_xyz = pn2.gather_rows(xyz, sample_idx)
        new_valid = pn2.gather1(valid, sample_idx)
        grouped, _, _ = pn2.query_and_group(
            self.radius, self.nsample, xyz, valid, new_xyz, new_valid,
            feats=feats, use_xyz=self.use_xyz)
        h = apply_shared_mlp(P, S, ctx, path + ".mlps.0", grouped,
                             new_valid[..., None], len(self.mlp) - 1)
        # amax: tied maxima share the gradient, as jnp.max's do
        new_feats = torch.where(new_valid[..., None], h.amax(-2),
                                torch.zeros((), dtype=h.dtype,
                                            device=h.device))
        return new_xyz, new_feats, new_valid, sample_idx


class FPModule:
    """Feature propagation: three-NN inverse-distance interpolation of the
    coarse features onto the fine points, then a shared MLP."""

    def __init__(self, mlp: List[int]):
        self.mlp = list(mlp)

    def init(self, P: Params, S: Params, gen: torch.Generator,
             path: str) -> None:
        init_shared_mlp(P, S, gen, path + ".mlp", self.mlp)

    def __call__(self, P, S, ctx: Ctx, path: str, fine_xyz, fine_feats,
                 fine_valid, coarse_xyz, coarse_feats, coarse_valid):
        dist, idx = pn2.three_nn(fine_xyz, fine_valid, coarse_xyz,
                                 coarse_valid)
        x = pn2.three_interpolate(coarse_feats, idx, dist)
        if fine_feats is not None:
            x = torch.cat([x, fine_feats], -1)
        x = apply_shared_mlp(P, S, ctx, path + ".mlp", x, fine_valid,
                             len(self.mlp) - 1)
        return torch.where(fine_valid[..., None], x,
                           torch.zeros((), dtype=x.dtype, device=x.device))
