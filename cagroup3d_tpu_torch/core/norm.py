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

Across W processes (one per card, ``--dist``) the sync adds one step: the
thread of scene 0 sums the rank's scenes and then the ranks' sums through
``RankSum``, one differentiable all-reduce per BN sync point, so BN pools
all W * b scenes of the step, as the JAX package's mesh-sharded scene
axis does.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..utils.commu_utils import group_size
from .sparse import zero_invalid


class RankSum:
    """The cross-rank sum of a training step's BN statistics over the ranks
    of a process group: ``rank_sum(tensors)`` returns their element-wise
    sums over the ranks, differentiably (the backward sums the cotangents
    over the ranks too).

    Collectives pair up by the order the ranks issue them in, not by name.
    The forward issues them in the model's BN order, the same on every
    rank.  The backward runs on autograd's engine, whose order among
    independent branches (BiResNet's two branches, the DAPPM pools, the
    per-class head nets) no rank shares with another.  So every sync
    point takes the previous one's ``token`` as an input and gives the
    next token out: sync point k's backward can only run after k + 1's,
    and every rank issues the backward sums in the reverse order of the
    forward.  ``attach(loss)`` ties the last token to the loss so the
    backward reaches every sync point.  Each collective also carries its
    point's number k (-k in the backward) and raises if the ranks' numbers
    disagree; the process group's timeout turns any hang into an error."""

    def __init__(self, group):
        self.group = group
        self.world = group_size(group)
        self.count = 0
        self.token: Optional[torch.Tensor] = None
        self.aborted = False

    def __call__(self, tensors):
        if self.aborted:
            raise RuntimeError("the step's cross-rank sync was aborted")
        self.count += 1
        if self.token is None:
            self.token = torch.zeros((), device=tensors[0].device,
                                     requires_grad=True)
        out = _RankSumFn.apply(self, self.count, self.token, *tensors)
        self.token = out[0]
        return out[1:]

    def sum_checked(self, k: int, tensors):
        """One all-reduce of ``tensors`` (flat, in f64) with the sync
        point's number k beside them."""
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]
                         + [torch.tensor([k, k * k], dtype=torch.float64,
                                         device=tensors[0].device)])
        dist.all_reduce(flat, group=self.group)
        tag = flat[-2:].tolist()
        if tag != [self.world * k, self.world * k * k]:
            raise RuntimeError(
                f"BN sync point {k} met another point on another rank "
                f"(sums of the numbers {tag}): the ranks' models issue "
                f"their BN statistics in different orders")
        vals = flat[:-2].split([t.numel() for t in tensors])
        return tuple(v.view(t.shape).to(t.dtype)
                     for v, t in zip(vals, tensors))

    def attach(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss`` with the step's chain of sync points tied to it (the
        same value)."""
        if self.token is None or not loss.requires_grad:
            return loss
        return _Attach.apply(loss, self.token)

    def abort(self) -> None:
        self.aborted = True


class _RankSumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rank_sum, k, token, *tensors):
        ctx.rank_sum, ctx.k = rank_sum, k
        return (token.detach().clone(),) + rank_sum.sum_checked(k, tensors)

    @staticmethod
    def backward(ctx, g_token, *grads):
        return (None, None, g_token) + ctx.rank_sum.sum_checked(-ctx.k, grads)


class _Attach(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loss, token):
        return loss.detach().clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), dtype=g.dtype, device=g.device)


class SceneSync:
    """Meeting point of the B scene threads of one training step.

    ``allreduce(i, tensors)`` is called by scene i with its tuple of
    tensors; every scene gets back the element-wise sums over the B
    scenes, added in scene order, and, with a ``group`` of W > 1 ranks,
    over the ranks' sums (``RankSum``; the thread of scene 0 issues it).
    A failing scene ``abort()``s the barrier, so the others raise instead
    of waiting forever, and the cross-rank sum, so this rank issues no
    further collective.  ``attach(loss)``: see ``RankSum.attach``.
    ``ranks`` shares another sync's cross-rank sum (``batch_sync``)."""

    def __init__(self, n_scenes: int, group=None,
                 ranks: Optional[RankSum] = None):
        self.n = n_scenes
        self._barrier = threading.Barrier(n_scenes)
        self._slots = [None] * n_scenes
        self._out = None
        self.ranks = ranks if ranks is not None else \
            RankSum(group) if group_size(group) > 1 else None

    def batch_sync(self) -> Optional["SceneSync"]:
        """For the stages that the calling thread runs over the whole batch
        after the scene threads (their BN sums already taken over the B
        scenes): a one-scene sync on this step's cross-rank sum, which
        numbers its sync points on from the scene threads' ones; None
        without ranks (nothing is left to pool)."""
        return None if self.ranks is None else SceneSync(1, ranks=self.ranks)

    def allreduce(self, i: int, tensors):
        self._slots[i] = tuple(tensors)
        self._barrier.wait()
        if i == 0:
            try:
                out = self._slots[0]
                for s in self._slots[1:]:
                    out = tuple(a + b for a, b in zip(out, s))
                self._out = out if self.ranks is None else self.ranks(out)
            except BaseException:
                self.abort()
                raise
        # scene 0 has summed the slots and written the result; nobody may
        # overwrite either before every scene has passed here
        self._barrier.wait()
        return self._out

    def attach(self, loss: torch.Tensor) -> torch.Tensor:
        return loss if self.ranks is None else self.ranks.attach(loss)

    def abort(self) -> None:
        self._barrier.abort()
        if self.ranks is not None:
            self.ranks.abort()


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
                       sync: Optional[SceneSync] = None, scene: int = 0,
                       scene_axis: bool = False):
    """Training statistics of the valid rows of x [..., N, C]: returns
    ((mean, biased var), (new running_mean, new running_var)), each shaped
    [..., 1, C]; with ``scene_axis`` x is [B, N, C] and its B scenes'
    counts and sums, each taken over one scene's [N, C] (a reduction's
    order may depend on its tensor's shape on the card), are added in
    scene order, so that W ranks of one scene add what one process of W
    scenes adds; with ``sync`` they are pooled over the step's scenes
    (and ranks) next.  The running buffers come back detached."""
    m = mask.to(x.dtype)[..., None]
    if scene_axis:      # each scene summed at its own shape, as a rank does
        per = [_sums(xi, mi) for xi, mi in zip(x, m)]
        cnt, s, ss = (sum(t[1:], t[0]) for t in zip(*per))
    else:
        cnt, s, ss = _sums(x, m)
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


def _sums(x: torch.Tensor, m: torch.Tensor):
    """(count, sum, sum of squares) of the rows of x [..., N, C] where the
    0/1 weights m [..., N, 1] are 1."""
    return (m.sum(-2, keepdim=True), (x * m).sum(-2, keepdim=True),
            (x * x * m).sum(-2, keepdim=True))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)
