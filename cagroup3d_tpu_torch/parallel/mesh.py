"""The training step on one card.

Counterpart of ``cagroup3d_tpu/parallel/mesh.py::make_train_step``: one
step is the B-scene training forward, the one- and two-stage losses,
``loss.backward()``, the global-norm clip and the optimizer update, then
the BN running-stat update.  The JAX package shards the batch over a
device mesh; data parallelism over several cards (DDP) comes with a later
slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def make_train_step(model, optimizer, generator: Optional[torch.Generator]
                    = None, device=None):
    """Returns step(batch, cur_epoch=0.0, roi_draws=None) -> (loss, tb):
    one optimizer step of ``model`` (moved to ``device``, the GPU unless
    the caller passes another one) on ``batch`` (tensors on the model's
    device, see ``CAGroup3D.forward_train``).  ``generator`` (seed 0 when
    None) seeds each step's per-scene random streams.  The loss and the tb
    entries come back as tensors, before the update."""
    device = torch.device("cuda") if device is None else device
    model.to(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    buffers = dict(model.named_buffers())

    def step(batch: Dict[str, torch.Tensor], cur_epoch: float = 0.0,
             roi_draws=None):
        optimizer.zero_grad()
        loss, tb, updates = model.forward_train(batch, gen, cur_epoch,
                                                roi_draws=roi_draws)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            for k, v in updates.items():
                buffers[k].copy_(v)
        return loss.detach(), {k: v.detach() for k, v in tb.items()}

    return step
