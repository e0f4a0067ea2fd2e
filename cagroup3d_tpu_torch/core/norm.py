"""Masked batch norm and activations over valid voxels.

Counterpart of ``cagroup3d_tpu/core/norm.py``: ME.MinkowskiBatchNorm over
the voxel (row) axis; invalid rows stay zero.  Eval normalizes with the
running statistics.  Training (``masked_batch_stats``) takes the batch
statistics of the valid rows: biased variance in the normalizer, unbiased
variance in the running buffer, momentum 0.1, as torch's BatchNorm does.

The JAX package vmaps the scenes of a step with ``axis_name="scene"`` and
``psum``s the sufficient statistics (count, sum, sum of squares) over that
axis, so BN pools all scenes of a step (SyncBN semantics).  The port runs
the scenes of a step as lock-step threads, one per scene; they meet at
every train-mode BN through a ``SceneSync`` and sum the B scenes'
statistics in scene order, so the result does not depend on thread timing
and stays differentiable across scenes.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.nn.functional as F

from .sparse import zero_invalid


class SceneSync:
    """Meeting point of the B scene threads of one training step.

    ``allreduce(i, tensors)`` is called by scene i with its tuple of
    tensors; every scene gets back the element-wise sums over the B
    scenes, added in scene order.  A failing scene ``abort()``s the
    barrier, so the others raise instead of waiting forever."""

    def __init__(self, n_scenes: int):
        self.n = n_scenes
        self._barrier = threading.Barrier(n_scenes)
        self._slots = [None] * n_scenes

    def allreduce(self, i: int, tensors):
        self._slots[i] = tuple(tensors)
        self._barrier.wait()
        out = self._slots[0]
        for s in self._slots[1:]:
            out = tuple(a + b for a, b in zip(out, s))
        # nobody may overwrite a slot before every scene has summed them
        self._barrier.wait()
        return out

    def abort(self) -> None:
        self._barrier.abort()


def masked_batch_norm(x: torch.Tensor, mask: torch.Tensor, weight, bias,
                      running_mean, running_var, eps: float = 1e-5,
                      stats=None) -> torch.Tensor:
    """Normalize x [..., N, C] over its valid rows mask [..., N] with
    ``stats`` = (mean, var) (training) or the running statistics (eval);
    every statistic broadcasts against x."""
    mean, var = (running_mean, running_var) if stats is None else stats
    y = (x - mean) * torch.rsqrt(var + eps) * weight + bias
    return zero_invalid(y, mask)


def masked_batch_stats(x: torch.Tensor, mask: torch.Tensor, running_mean,
                       running_var, momentum: float = 0.1,
                       sync: Optional[SceneSync] = None, scene: int = 0):
    """Training statistics of the valid rows of x [..., N, C]: returns
    ((mean, biased var), (new running_mean, new running_var)), each shaped
    [..., 1, C]; with ``sync`` the counts and sums are pooled over the
    step's scenes first.  The running buffers come back detached."""
    m = mask.to(x.dtype)[..., None]
    cnt = m.sum(-2, keepdim=True)
    s = (x * m).sum(-2, keepdim=True)
    ss = (x * x * m).sum(-2, keepdim=True)
    if sync is not None:
        cnt, s, ss = sync.allreduce(scene, (cnt, s, ss))
    cnt = cnt.clamp(min=1.0)
    mean = s / cnt
    var = (ss / cnt - mean * mean).clamp(min=0.0)
    with torch.no_grad():
        unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
        new_rm = (1 - momentum) * running_mean + momentum * mean
        new_rv = (1 - momentum) * running_var + momentum * unbiased
    return (mean, var), (new_rm, new_rv)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)
