"""Parameters under the JAX package's flat names, eval context, init.

Counterpart of ``cagroup3d_tpu/core/module.py``.  The JAX package keeps a
model's parameters in flat ``{path: array}`` dicts named after the
reference's torch ``state_dict`` (``backbone_3d.layer1.0.conv1.kernel``).
Here they live in an ``nn.Module`` tree whose ``named_parameters()`` /
``named_buffers()`` give exactly those names (batch-norm running
statistics are buffers), and the forward code reads them as flat dicts
``P`` / ``S``, as the JAX code does.  Initializers take an explicit
``torch.Generator``; they draw other numbers than ``jax.random`` for the
same seed.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from .norm import masked_batch_norm

Params = Dict[str, torch.Tensor]


class Ctx:
    """Per-forward context (eval): capacity-overflow counters and a cache of
    coordinate reductions keyed by the identity of the reduced coords."""

    def __init__(self):
        self.stats: Params = {}
        self.cache: dict = {}


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
                mod.register_parameter(leaf, nn.Parameter(
                    t, requires_grad=False))


def flat_state(module: nn.Module, prefix: str = ""):
    """(P, S): the module's parameters and buffers by flat name."""
    pre = prefix + "." if prefix else ""
    P = {pre + n: p for n, p in module.named_parameters()}
    S = {pre + n: b for n, b in module.named_buffers()}
    return P, S


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
# apply helpers (eval)
# ---------------------------------------------------------------------------

def apply_bn(P: Params, S: Params, ctx: Ctx, path: str, x: torch.Tensor,
             mask: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return masked_batch_norm(x, mask, P[path + ".weight"],
                             P[path + ".bias"], S[path + ".running_mean"],
                             S[path + ".running_var"], eps=eps)


def apply_linear(P: Params, path: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ P[path + ".weight"]
    b = P.get(path + ".bias")
    return y + b if b is not None else y
