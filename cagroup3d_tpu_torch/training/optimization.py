"""Optimizer and LR schedule (reference tools/train_utils/optimization/).

Counterpart of ``cagroup3d_tpu/training/optimization.py``, matching its
optax chains step for step: adamW / adam / sgd with LambdaLR-style step
decay at ``DECAY_STEP_LIST`` epochs x ``LR_DECAY`` (floored at
``LR_CLIP``), the optional cosine warm-up, and global-norm gradient
clipping by ``clip / max(norm, clip)`` (optax's ``clip_by_global_norm``;
torch's ``clip_grad_norm_`` divides by ``norm + 1e-6`` instead).

optax's adamw decays the weights decoupled from the gradient and reads
the schedule at its update count, which is 0 at the first update;
``Optimizer.step`` sets the learning rate from ``schedule(t)`` with t the
number of updates taken before this one.  ``torch.optim.AdamW`` with
betas (0.9, 0.999) and eps 1e-8 is optax.adamw; optax's adam and sgd take
no weight decay, so neither does the port's.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List

import torch


def build_lr_schedule(opt_cfg, steps_per_epoch: int,
                      total_epochs: int = 0) -> Callable[[int], float]:
    """lr(step) for the step-decay optimizers (adamW, adam, sgd)."""
    if opt_cfg.OPTIMIZER == "adam_onecycle":
        raise NotImplementedError(
            "adam_onecycle (outdoor configs) comes with the outdoor slice")
    base_lr = float(opt_cfg.LR)
    decay_steps: List[int] = [int(e) * steps_per_epoch
                              for e in opt_cfg.get("DECAY_STEP_LIST", [])]
    decay = float(opt_cfg.get("LR_DECAY", 0.1))
    lr_clip = float(opt_cfg.get("LR_CLIP", 1e-7))
    warmup = bool(opt_cfg.get("LR_WARMUP", False))
    warmup_steps = max(int(opt_cfg.get("WARMUP_EPOCH", 1)) * steps_per_epoch,
                       1)
    eta_min = base_lr / float(opt_cfg.get("DIV_FACTOR", 10.0))

    def schedule(step: int) -> float:
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        factor = f32(1.0)
        for ds in decay_steps:
            if step >= ds:
                factor = factor * decay
        lr = torch.maximum(base_lr * factor, f32(lr_clip))
        if warmup and step < warmup_steps:
            # CosineWarmupLR: cosine ramp eta_min -> lr over WARMUP_EPOCH
            p = (f32(step) / f32(warmup_steps)).clamp(0.0, 1.0)
            lr = eta_min + (lr - eta_min) * (1.0 - torch.cos(math.pi * p)) / 2
        return float(lr)

    return schedule


def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float):
    """Scale the gradients in place by max_norm / max(norm, max_norm);
    returns the global norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = max_norm / torch.maximum(norm, torch.tensor(max_norm,
                                                        device=norm.device))
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """A torch optimizer driven like the JAX package's optax chain:
    ``step()`` clips (``GRAD_NORM_CLIP``), sets the learning rate from the
    schedule at the number of updates taken so far, and updates."""

    def __init__(self, params, opt_cfg, steps_per_epoch: int,
                 total_epochs: int = 0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = build_lr_schedule(opt_cfg, steps_per_epoch,
                                          total_epochs)
        self.clip = float(opt_cfg.get("GRAD_NORM_CLIP", 0.0))
        name = opt_cfg.OPTIMIZER
        lr0 = self.schedule(0)
        if name in ("adamW", "adamw"):
            self.opt = torch.optim.AdamW(
                self.params, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=float(opt_cfg.get("WEIGHT_DECAY", 0.0)))
        elif name == "adam":
            self.opt = torch.optim.Adam(self.params, lr=lr0,
                                        betas=(0.9, 0.999), eps=1e-8)
        elif name == "sgd":
            self.opt = torch.optim.SGD(
                self.params, lr=lr0,
                momentum=float(opt_cfg.get("MOMENTUM", 0.9)))
        else:
            raise NotImplementedError(name)
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip > 0:
            clip_by_global_norm(self.params, self.clip)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return dict(opt=self.opt.state_dict(), count=self.count)

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd["opt"])
        self.count = int(sd["count"])


def build_optimizer(model: torch.nn.Module, opt_cfg, steps_per_epoch: int,
                    total_epochs: int = 0):
    """(optimizer, schedule) for the model's parameters."""
    opt = Optimizer(model.parameters(), opt_cfg, steps_per_epoch,
                    total_epochs)
    return opt, opt.schedule
