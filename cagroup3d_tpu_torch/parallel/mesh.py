"""The training step, on one card or on several (one process per card).

Counterpart of ``cagroup3d_tpu/parallel/mesh.py::make_train_step``: one
step is the B-scene training forward, the one- and two-stage losses,
``loss.backward()``, the global-norm clip and the optimizer update, then
the BN running-stat update.

The JAX package shards the batch over a 1-D ``dp`` mesh; with a process
``group`` of W ranks (``--dist``: one process per card) the step computes
what one process computes on the W * b scenes: rank r holds the global
scenes r*b .. r*b + b - 1 and their random streams, BN statistics and the
losses' normalizers are pooled over the ranks inside ``forward_train``,
and between ``backward()`` and the update one flat all-reduce averages the
gradients over the ranks.  Every rank then applies the same update to the
same parameters, so they stay equal; they are broadcast from rank 0 once,
when the step is built.  The model's ``forward_train`` is called directly,
not through ``DistributedDataParallel``, whose hooks would not see it.

The NaN guard (``nan_guard``, or the environment's ``CAGROUP_NAN_GUARD=1``;
the JAX package's checkify guard) checks the loss, every tb term and
every gradient after the backward and raises on the first non-finite one,
by name, before the update touches the parameters.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..utils.commu_utils import (average_grads, broadcast_tensors,
                                 global_sum, group_size)


def make_train_step(model, optimizer, generator: Optional[torch.Generator]
                    = None, device=None, group=None,
                    nan_guard: Optional[bool] = None):
    """Returns step(batch, cur_epoch=0.0, roi_draws=None) -> (loss, tb):
    one optimizer step of ``model`` (moved to ``device``, the GPU unless
    the caller passes another one) on ``batch`` (tensors on the model's
    device, see ``CAGroup3D.forward_train``; this rank's scenes with a
    ``group``).  ``generator`` (seed 0 when None) seeds each step's
    per-scene random streams; every rank passes the same one.  The loss
    and the tb entries come back as tensors, before the update; with a
    ``group`` they are the global ones (the ranks' mean; the overflow
    counters the ranks' sum)."""
    device = torch.device("cuda") if device is None else device
    model.to(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    buffers = dict(model.named_buffers())
    params = [p for p in model.parameters() if p.requires_grad]
    ranks = group_size(group)
    kw = {"group": group} if ranks > 1 else {}
    broadcast_tensors(list(model.parameters()) + list(buffers.values()),
                      src=0, group=group)
    if nan_guard is None:
        nan_guard = os.environ.get("CAGROUP_NAN_GUARD") == "1"

    def step(batch: Dict[str, torch.Tensor], cur_epoch: float = 0.0,
             roi_draws=None):
        optimizer.zero_grad()
        loss, tb, updates = model.forward_train(batch, gen, cur_epoch,
                                                roi_draws=roi_draws, **kw)
        loss.backward()
        loss, tb = loss.detach(), {k: v.detach() for k, v in tb.items()}
        if ranks > 1:
            average_grads(params, group)
            loss, tb = global_terms(loss, tb, group)
        if nan_guard:
            check_finite(loss, tb, model)
        optimizer.step()
        with torch.no_grad():
            for k, v in updates.items():
                buffers[k].copy_(v)
        return loss, tb

    return step


def global_terms(loss, tb, group):
    """The step's loss and tb over every rank's scenes: the mean of the
    ranks' terms (each rank's loss is its share of the global one, see the
    heads' ``loss``), the sum of their ``overflow/*`` counters."""
    keys = sorted(tb)
    vals = torch.stack([loss.float()] + [tb[k].float() for k in keys])
    summed = global_sum(vals, group)
    ranks = group_size(group)
    out = {k: summed[i + 1] if k.startswith("overflow/") else
           summed[i + 1] / ranks for i, k in enumerate(keys)}
    return summed[0] / ranks, out


def check_finite(loss, tb, model) -> None:
    """Raise on the first non-finite value among the loss, the tb terms and
    the parameters' gradients, naming it."""
    named = [("loss", loss)] + [(f"tb {k}", v) for k, v in tb.items()] + \
        [(f"gradient of {k}", p.grad) for k, p in model.named_parameters()
         if p.grad is not None]
    finite = torch.stack([torch.isfinite(v).all() for _, v in named])
    for (name, v), ok in zip(named, finite.tolist()):
        if not ok:
            raise FloatingPointError(
                f"non-finite {name} (nan guard): "
                f"{int((~torch.isfinite(v)).sum())} of {v.numel()} "
                f"values are nan or inf")
