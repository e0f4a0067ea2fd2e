"""Parameters under the JAX package's flat names, forward context, init.

Counterpart of ``cagroup3d_tpu/core/module.py``.  The JAX package keeps a
model's parameters in flat ``{path: array}`` dicts named after the
reference's torch ``state_dict`` (``backbone_3d.layer1.0.conv1.kernel``).
Here they live in an ``nn.Module`` tree whose ``named_parameters()`` /
``named_buffers()`` give exactly those names (batch-norm running
statistics are buffers), and the forward code reads them as flat dicts
``P`` / ``S``, as the JAX code does.  Parameters are trainable; the
eval entry points run under ``torch.no_grad()``.  Initializers take an
explicit ``torch.Generator``; they draw other numbers than ``jax.random``
for the same seed.
"""
from __future__ import annotations

import math
import pickle
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .norm import SceneSync, masked_batch_norm, masked_batch_stats

Params = Dict[str, torch.Tensor]


class Ctx:
    """Per-forward context of one scene: the train flag, the scene's random
    stream (an explicit CPU ``torch.Generator``: its draws do not depend on
    the device the model runs on), the BN running-stat ``updates`` of a
    training forward, the step's ``SceneSync`` (BN statistics pooled over
    the scenes of a step, and over the ranks' scenes with ``--dist``)
    with this scene's index, the training
    ``drop_offset`` of the capacity windows, capacity-overflow counters and
    a cache of coordinate reductions keyed by the identity of the reduced
    coords."""

    def __init__(self, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 sync: Optional[SceneSync] = None, scene: int = 0):
        self.train = train
        self.generator = generator
        self.sync = sync
        self.scene = scene
        self.drop_offset: Optional[int] = None
        self.updates: Params = {}
        self.stats: Params = {}
        self.cache: dict = {}

    def rand(self, *shape) -> torch.Tensor:
        """Uniform [0, 1) draws on the CPU from the scene's stream."""
        if self.generator is None:
            raise ValueError("Ctx needs a generator for stochastic ops")
        return torch.rand(*shape, generator=self.generator)

    def randn(self, *shape) -> torch.Tensor:
        if self.generator is None:
            raise ValueError("Ctx needs a generator for stochastic ops")
        return torch.randn(*shape, generator=self.generator)

    def randint(self, high: int, *shape) -> torch.Tensor:
        if self.generator is None:
            raise ValueError("Ctx needs a generator for stochastic ops")
        return torch.randint(0, high, shape, generator=self.generator)


# ---------------------------------------------------------------------------
# flat-name registration
# ---------------------------------------------------------------------------

def register_flat(root: nn.Module, params: Params, buffers: Params) -> None:
    """Register each ``a.b.c`` entry as parameter/buffer ``c`` of the
    (created on demand) submodule ``a.b`` of ``root``."""
    for table, is_buffer in ((params, False), (buffers, True)):
        for name, t in table.items():
            *path, leaf = name.split(".")
            mod = root
            for p in path:
                child = mod._modules.get(p)
                if child is None:
                    child = nn.Module()
                    mod.add_module(p, child)
                mod = child
            if is_buffer:
                mod.register_buffer(leaf, t)
            else:
                mod.register_parameter(leaf, nn.Parameter(t))


def flat_state(module: nn.Module, prefix: str = ""):
    """(P, S): the module's parameters and buffers by flat name."""
    pre = prefix + "." if prefix else ""
    P = {pre + n: p for n, p in module.named_parameters()}
    S = {pre + n: b for n, b in module.named_buffers()}
    return P, S


def load_jax_params(model: nn.Module, P, S: Optional[Params] = None) -> None:
    """Copy the JAX package's flat param/state dicts (numpy arrays by name)
    into ``model``; ``P`` may instead be the path of a pickled checkpoint
    written by either package's ``save_checkpoint``.  Raises on a missing
    or extra name or a shape mismatch."""
    if isinstance(P, (str, bytes)) or hasattr(P, "__fspath__"):
        with open(P, "rb") as f:
            ckpt = pickle.load(f)
        P, S = ckpt["params"], ckpt["state"]
    mine_p, mine_s = flat_state(model)
    for name, mine, theirs in (("params", mine_p, P), ("state", mine_s, S)):
        missing = sorted(set(mine) - set(theirs))
        extra = sorted(set(theirs) - set(mine))
        if missing or extra:
            raise KeyError(f"{name}: missing {missing[:8]}, extra "
                           f"{extra[:8]}")
        for k, t in mine.items():
            src = np.asarray(theirs[k])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {src.shape} != "
                                 f"{tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.array(src)))


# ---------------------------------------------------------------------------
# initializers (the reference's torch/ME init choices)
# ---------------------------------------------------------------------------

def kaiming_conv(gen: torch.Generator, k3: int, cin: int, cout: int):
    """ME.utils.kaiming_normal_(mode='fan_out', nonlinearity='relu'):
    std = sqrt(2 / (k3 * cout))."""
    return torch.randn(k3, cin, cout, generator=gen) * math.sqrt(
        2.0 / (k3 * cout))


def normal_conv(gen: torch.Generator, k3: int, cin: int, cout: int,
                std: float = 0.01):
    return torch.randn(k3, cin, cout, generator=gen) * std


def me_default_conv(gen: torch.Generator, k3: int, cin: int, cout: int):
    """ME MinkowskiConvolution default: uniform(+-sqrt(1 / (k3 * cin)))."""
    bound = math.sqrt(1.0 / (k3 * cin))
    return (torch.rand(k3, cin, cout, generator=gen) * 2 - 1) * bound


def init_conv(P: Params, gen: torch.Generator, path: str, k: int, cin: int,
              cout: int, bias: bool = False, init: str = "me") -> None:
    fn = {"kaiming": kaiming_conv, "normal": normal_conv,
          "me": me_default_conv}[init]
    P[path + ".kernel"] = fn(gen, k ** 3, cin, cout)
    if bias:
        P[path + ".bias"] = torch.zeros(cout)


def init_bn(P: Params, S: Params, path: str, c: int) -> None:
    P[path + ".weight"] = torch.ones(c)
    P[path + ".bias"] = torch.zeros(c)
    S[path + ".running_mean"] = torch.zeros(c)
    S[path + ".running_var"] = torch.ones(c)


def init_linear(P: Params, gen: torch.Generator, path: str, cin: int,
                cout: int, bias: bool = True, init: str = "xavier") -> None:
    if init == "xavier":
        w = torch.randn(cin, cout, generator=gen) * math.sqrt(
            2.0 / (cin + cout))
    elif init == "normal":
        w = torch.randn(cin, cout, generator=gen) * 0.001
    else:
        bound = math.sqrt(1.0 / cin)
        w = (torch.rand(cin, cout, generator=gen) * 2 - 1) * bound
    P[path + ".weight"] = w
    if bias:
        P[path + ".bias"] = torch.zeros(cout)


# ---------------------------------------------------------------------------
# apply helpers
# ---------------------------------------------------------------------------

def apply_bn(P: Params, S: Params, ctx: Ctx, path: str, x: torch.Tensor,
             mask: torch.Tensor, eps: float = 1e-5, momentum: float = 0.1,
             scene_axis: bool = False) -> torch.Tensor:
    """Masked BN of x [..., N, C] under ``path``.  Per-class stacks pass
    x [n_cls, N, C] with [n_cls, C] parameters (each class its own
    statistics); ``scene_axis``: x [B, N, C] holds B scenes whose rows
    share the statistics (``masked_batch_stats``).  Training records the
    new running stats in ``ctx.updates``."""
    w, b = P[path + ".weight"], P[path + ".bias"]
    rm, rv = S[path + ".running_mean"], S[path + ".running_var"]
    if w.dim() == 2:                      # per-class [n_cls, C] stacks
        w, b, rm, rv = (t[:, None] for t in (w, b, rm, rv))
    stats = None
    if ctx.train:
        stats, (nrm, nrv) = masked_batch_stats(
            x, mask, rm, rv, momentum=momentum, sync=ctx.sync,
            scene=ctx.scene, scene_axis=scene_axis)
        shape = S[path + ".running_mean"].shape
        ctx.updates[path + ".running_mean"] = nrm.reshape(shape)
        ctx.updates[path + ".running_var"] = nrv.reshape(shape)
    return masked_batch_norm(x, mask, w, b, rm, rv, eps=eps, stats=stats)


def apply_linear(P: Params, path: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ P[path + ".weight"]
    b = P.get(path + ".bias")
    return y + b if b is not None else y


def dropout(ctx: Ctx, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout in training: keep each element with probability
    1 - rate (a uniform draw below it, as ``jax.random.bernoulli`` does)
    and scale the kept ones by 1 / (1 - rate)."""
    if not ctx.train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = (ctx.rand(*x.shape) < keep).to(x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
