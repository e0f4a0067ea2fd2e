"""Optimizer and LR schedule (reference tools/train_utils/optimization/).

Counterpart of ``cagroup3d_tpu/training/optimization.py``, matching its
optax chains step for step: adamW / adam / sgd with LambdaLR-style step
decay at ``DECAY_STEP_LIST`` epochs x ``LR_DECAY`` (floored at
``LR_CLIP``), the optional cosine warm-up, adam_onecycle, and global-norm
gradient clipping by ``clip / max(norm, clip)`` (optax's
``clip_by_global_norm``; torch's ``clip_grad_norm_`` divides by
``norm + 1e-6`` instead).

adam_onecycle (the outdoor configs; fastai's OneCycle) is the JAX
package's chain clip -> ``add_decayed_weights(WEIGHT_DECAY)`` ->
``scale_by_adam(b1=mom(t), b2=0.99)`` -> ``lr(t)``: the weight decay is
added to the gradient before Adam's moments (coupled L2, which is
``torch.optim.Adam(weight_decay=wd)``, not AdamW), and both the learning
rate and beta1 follow the OneCycle schedules over NUM_EPOCHS x
steps_per_epoch updates, Adam's bias correction taken at the current
beta1 (as optax's ``inject_hyperparams`` and torch's Adam both do).

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


def _annealing_cos(start: float, end: float, pct: torch.Tensor):
    """learning_schedules_fastai.py:55-59, in f32 as the JAX package."""
    return end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1.0)


def onecycle_schedules(opt_cfg, total_steps: int):
    """(lr(step), mom(step)) of fastai's OneCycle: the learning rate a
    cosine from LR / DIV_FACTOR up to LR over the first PCT_START of the
    steps, then down to LR / DIV_FACTOR / 1e4; the momentum MOMS[0] ->
    MOMS[1] and back over the same phases.  f32 arithmetic, as the JAX
    schedules; floats out."""
    lr_max = float(opt_cfg.LR)
    moms = [float(m) for m in opt_cfg.get("MOMS", [0.95, 0.85])]
    div = float(opt_cfg.get("DIV_FACTOR", 10.0))
    a1 = int(total_steps * float(opt_cfg.get("PCT_START", 0.4)))
    a2 = max(total_steps - a1, 1)
    low_lr = lr_max / div

    def phases(step: int, up, down) -> float:
        t = torch.tensor(step, dtype=torch.int32)
        p1 = (t / max(a1, 1)).clamp(0.0, 1.0)
        p2 = ((t - a1) / a2).clamp(0.0, 1.0)
        return float(_annealing_cos(*up, p1) if step < a1
                     else _annealing_cos(*down, p2))

    def lr_fn(step: int) -> float:
        return phases(step, (low_lr, lr_max), (lr_max, low_lr / 1e4))

    def mom_fn(step: int) -> float:
        return phases(step, (moms[0], moms[1]), (moms[1], moms[0]))

    return lr_fn, mom_fn


def build_lr_schedule(opt_cfg, steps_per_epoch: int,
                      total_epochs: int = 0) -> Callable[[int], float]:
    """lr(step): adam_onecycle's over ``total_epochs`` x steps_per_epoch
    steps, else the step-decay schedule (adamW, adam, sgd)."""
    if opt_cfg.OPTIMIZER == "adam_onecycle":
        total = max(int(total_epochs) * steps_per_epoch, 1)
        return onecycle_schedules(opt_cfg, total)[0]
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
    ``step()`` clips (``GRAD_NORM_CLIP``), sets the learning rate (and
    adam_onecycle's beta1) from the schedules at the number of updates
    taken so far, and updates."""

    def __init__(self, params, opt_cfg, steps_per_epoch: int,
                 total_epochs: int = 0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = build_lr_schedule(opt_cfg, steps_per_epoch,
                                          total_epochs)
        self.momentum = None
        self.clip = float(opt_cfg.get("GRAD_NORM_CLIP", 0.0))
        name = opt_cfg.OPTIMIZER
        lr0 = self.schedule(0)
        if name == "adam_onecycle":
            total = max(int(total_epochs) * steps_per_epoch, 1)
            self.momentum = onecycle_schedules(opt_cfg, total)[1]
            self.opt = torch.optim.Adam(
                self.params, lr=lr0, betas=(self.momentum(0), 0.99),
                eps=1e-8, weight_decay=float(opt_cfg.get("WEIGHT_DECAY",
                                                         0.0)))
        elif name in ("adamW", "adamw"):
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
            if self.momentum is not None:
                group["betas"] = (self.momentum(self.count),
                                  group["betas"][1])
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
