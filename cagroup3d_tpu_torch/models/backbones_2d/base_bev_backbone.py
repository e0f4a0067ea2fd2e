"""Dense BEV backbone: BaseBEVBackbone.

Counterpart of ``cagroup3d_tpu/models/backbones_2d/base_bev_backbone.py``
(the reference's pcdet/models/backbones_2d/base_bev_backbone.py): per level
a conv (stride ``LAYER_STRIDES``) and ``LAYER_NUMS`` more convs, each with
BN (eps 1e-3) and ReLU, then an upsampling deblock per level and a channel
concat.  The JAX package computes these with XLA's dense convolutions
outside any Pallas kernel; here they are ``F.conv2d`` /
``F.conv_transpose2d`` convolutions in channels-first layout on the JAX
package's HWIO weights (``blocks.{i}.{j}.weight``, ``deblocks.{i}.weight``),
forward and backward with cuDNN off (``_Conv2d``), with its padding:
- ``"SAME"`` pads (total // 2, total - total // 2) with total =
  max((out - 1) * s + k - in, 0): a stride-2 k3 conv on an even map pads
  (0, 1), where ``padding=1`` would shift the map by a pixel;
- ``jax.lax.conv_transpose`` without ``transpose_kernel`` is a conv of the
  s-dilated input padded by (pad_a, pad_b) with the kernel as given, which
  is ``F.conv_transpose2d`` with the kernel flipped in space and stored
  [Cin, Cout, kh, kw], cropped by k - 1 - pad_a at the start.

In training the B scenes' maps go through as one [B, C, H, W] batch; each
BN (momentum 0.01) normalizes with the statistics of all B * H * W
positions, which is what the JAX package's per-scene sums pooled over its
``scene`` axis give, and records its running-stat update; with ``--dist``
the statistics are pooled over the ranks' scenes too (``bn2d``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.module import Params, init_bn, register_flat


def _same_pads(n: int, k: int, s: int):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _batched(fn):
    """Run ``fn`` on [B, C, H, W]; a [C, H, W] map goes in as B = 1."""
    def run(x, *a):
        return fn(x, *a) if x.dim() == 4 else fn(x[None], *a)[0]
    return run


@contextlib.contextmanager
def _without_cudnn():
    """cuDNN off inside the block: the 2-D convs run on PyTorch's im2col +
    GEMM path, not on cuDNN, whose choice of algorithm depends on the free
    device memory (with about 20 GB free it takes an FFT algorithm with
    17.6 GB of workspace, with less another one) and, when it benchmarks,
    on timings, so two calls on one input could give other bits."""
    cudnn = torch.backends.cudnn
    saved = cudnn.enabled
    cudnn.enabled = False
    try:
        yield
    finally:
        cudnn.enabled = saved


class _Conv2d(torch.autograd.Function):
    """An unpadded, unbiased 2-D conv (``transposed``: a transposed one with
    ``output_padding``) whose forward and backward both run inside
    ``_without_cudnn``.  Autograd picks the backward's backend when
    ``backward()`` runs, after a block around the forward has closed, so
    the backward opens the block itself."""

    @staticmethod
    def forward(ctx, x, w, stride: int, transposed: bool,
                output_padding: int):
        ctx.save_for_backward(x, w)
        ctx.conf = ([stride] * 2, [0, 0], [1, 1], transposed,
                    [output_padding] * 2, 1)
        with _without_cudnn():
            return torch.ops.aten.convolution(x, w, None, *ctx.conf)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _without_cudnn():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, *ctx.conf,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


@_batched
def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """``lax.conv_general_dilated(x, w, (s, s), "SAME")`` on x [C, H, W]
    (or [B, C, H, W]) with w HWIO [k, k, Cin, Cout] -> [Cout, H', W']."""
    k = w.shape[0]
    (t, b), (l, r) = (_same_pads(n, k, stride) for n in x.shape[-2:])
    x = F.pad(x, (l, r, t, b))
    return _Conv2d.apply(x, w.permute(3, 2, 0, 1), stride, False, 0)


def _transpose_pads(k: int, s: int):
    """jax.lax's ``_conv_transpose_padding`` for "SAME"."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


@_batched
def conv_transpose2d_same(x: torch.Tensor, w: torch.Tensor, stride: int):
    """``lax.conv_transpose(x, w, (s, s), "SAME")`` (no
    ``transpose_kernel``) on x [C, H, W] (or [B, C, H, W]) with w HWIO ->
    [Cout, sH, sW]:
    the full transposed conv (padding (k - 1, k - 1) of the dilated input)
    cropped to JAX's padding."""
    k = w.shape[0]
    pad_a, pad_b = _transpose_pads(k, stride)
    extra = max(0, pad_b - (k - 1))
    if pad_a > k - 1 or extra >= stride:
        raise ValueError(f"no conv_transpose2d form for k={k}, s={stride}")
    wt = w.flip(0, 1).permute(2, 3, 0, 1)                 # [Cin, Cout, k, k]
    y = _Conv2d.apply(x, wt, stride, True, extra)
    lo = k - 1 - pad_a
    H, W = ((n - 1) * stride + 1 + pad_a + pad_b - k + 1
            for n in x.shape[-2:])
    return y[..., lo:lo + H, lo:lo + W]


def bn2d(P: Params, S: Params, path: str, x: torch.Tensor,
         updates: Optional[Params] = None, sync=None) -> torch.Tensor:
    """BN of x [C, H, W] (eps 1e-3), ``core/norm.masked_batch_norm``'s
    arithmetic: with the running statistics, or with ``updates`` (training,
    x [B, C, H, W]) with the batch statistics of all B * H * W positions,
    recording the new running statistics there (momentum 0.01; biased
    variance in the normalizer, unbiased in the buffer).  Each scene's sums
    are taken over its own [C, H, W] and added in scene order, so that W
    ranks of one scene add what one process of W scenes adds; with a
    ``sync`` (``SceneSync.batch_sync``) the count and sums are then pooled
    over the ranks, as the JAX package's psum over its sharded scene axis
    pools them."""
    momentum = 0.01
    mean, var = S[path + ".running_mean"], S[path + ".running_var"]
    if updates is not None:
        per = [(xi.sum((1, 2)), (xi * xi).sum((1, 2))) for xi in x]
        s, ss = (sum(t[1:], t[0]) for t in zip(*per))
        cnt = torch.tensor(float(x.shape[0] * x.shape[2] * x.shape[3]),
                           dtype=x.dtype, device=x.device)
        if sync is not None:
            cnt, s, ss = sync.allreduce(0, (cnt, s, ss))
        bmean = s / cnt
        bvar = (ss / cnt - bmean * bmean).clamp(min=0.0)
        with torch.no_grad():
            updates[path + ".running_mean"] = \
                (1 - momentum) * mean + momentum * bmean
            updates[path + ".running_var"] = \
                (1 - momentum) * var + momentum * bvar * cnt / \
                (cnt - 1.0).clamp(min=1.0)
        mean, var = bmean, bvar
    w, b = P[path + ".weight"], P[path + ".bias"]
    y = (x - mean[:, None, None]) * torch.rsqrt(var + 1e-3)[:, None, None]
    return y * w[:, None, None] + b[:, None, None]


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = model_cfg
        self.layer_nums = [int(x) for x in c.get("LAYER_NUMS", [])]
        self.strides = [int(x) for x in c.get("LAYER_STRIDES", [])]
        self.filters = [int(x) for x in c.get("NUM_FILTERS", [])]
        self.up_strides = [int(x) for x in c.get("UPSAMPLE_STRIDES", [])]
        self.up_filters = [int(x) for x in c.get("NUM_UPSAMPLE_FILTERS", [])]
        self.in_ch = int(c.get("IN_CHANNELS", input_channels))
        self.num_bev_features = sum(self.up_filters) if self.up_filters \
            else self.filters[-1]
        P, S = self._init(generator or torch.Generator().manual_seed(0))
        register_flat(self, P, S)

    def _init(self, gen: torch.Generator):
        P: Params = {}
        S: Params = {}

        def conv(path, k, cin, cout):
            P[path + ".weight"] = torch.randn(k, k, cin, cout, generator=gen) \
                * math.sqrt(2.0 / (k * k * cout))
            init_bn(P, S, path + ".bn", cout)

        cin = self.in_ch
        for li, (n, f) in enumerate(zip(self.layer_nums, self.filters)):
            for j in range(n + 1):
                conv(f"blocks.{li}.{j}", 3, cin if j == 0 else f, f)
            cin = f
        for li, (us, uf) in enumerate(zip(self.up_strides, self.up_filters)):
            conv(f"deblocks.{li}", us if us > 1 else 3, self.filters[li], uf)
        return P, S

    def forward(self, P: Params, S: Params, bev: torch.Tensor,
                prefix: str = "backbone_2d",
                updates: Optional[Params] = None, sync=None) -> torch.Tensor:
        """bev [C, H, W] (eval) -> [sum(up_filters), H', W']; in training
        (``updates``, the running-stat updates) bev [B, C, H, W] ->
        [B, sum(up_filters), H', W'], BN pooled over the ranks with a
        ``sync`` (``bn2d``)."""
        ups = []
        x = bev
        for li, n in enumerate(self.layer_nums):
            for j in range(n + 1):
                p = f"{prefix}.blocks.{li}.{j}"
                x = conv2d_same(x, P[p + ".weight"],
                                self.strides[li] if j == 0 else 1)
                x = torch.relu(bn2d(P, S, p + ".bn", x, updates, sync))
            if li < len(self.up_strides):
                p, us = f"{prefix}.deblocks.{li}", self.up_strides[li]
                u = conv_transpose2d_same(x, P[p + ".weight"], us) if us > 1 \
                    else conv2d_same(x, P[p + ".weight"])
                ups.append(torch.relu(bn2d(P, S, p + ".bn", u, updates,
                                           sync)))
        if len(ups) > 1:
            return torch.cat(ups, dim=-3)
        return ups[0] if ups else x
