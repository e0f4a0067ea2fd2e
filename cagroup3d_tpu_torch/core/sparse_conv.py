"""Sparse convolution execution: plain gather-GEMMs.

Counterpart of ``cagroup3d_tpu/core/sparse_conv.py``.  ``gather_gemm``
runs a conv from a precomputed neighbour table; the ``scan_conv_grouped*``
forms are convs over key-indexed tables and go through kernel K1
(``ops/sparse_conv.py``, differentiable: its backward is K1 and K3), whose
plain versions run on CPU tensors; ``generative_up_classes`` is the head's
exact-tiling transposed conv.  Autograd differentiates the plain forms.  Weights are ``[K^3, Cin, Cout]`` in ``kernel_offsets`` order; feature
rows and weights are rounded to bf16 and accumulated in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.sparse_conv import sparse_conv
from .gather import take_rows_masked
from .hashing import INVALID_KEY, pack_coords
from .sparse import bf16_round, zero_invalid
from .voxelize import floor_div


def gather_gemm(feats: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[n] = sum_k feats[nbr[k, n]] @ w[k] (missing neighbours skipped).

    feats [N_src, Cin]; nbr i32[K, N_out]; w [K, Cin, Cout] -> f32."""
    f16 = bf16_round(feats)
    w16 = bf16_round(w)
    out = torch.zeros(nbr.shape[1], w.shape[-1], dtype=torch.float32,
                      device=feats.device)
    for k in range(nbr.shape[0]):
        out += take_rows_masked(f16, nbr[k]) @ w16[k]
    if bias is not None:
        out = out + bias
    return out


def scan_conv_grouped(src_coords, src_valid, src_feats, src_stride: int,
                      tgt_coords, tgt_valid, kernel_size: int,
                      w: torch.Tensor, bias: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Odd-kernel conv of one source table evaluated at target coords
    (raw units, floor-divided onto the source lattice).  [N_tgt, Cout]."""
    s = src_stride
    out = sparse_conv(floor_div(src_coords, s)[None], src_valid[None],
                      src_feats[None], w[None], kernel_size,
                      floor_div(tgt_coords, s)[None], tgt_valid[None])[0]
    if bias is not None:
        out = out + bias
    return zero_invalid(out, tgt_valid)


def scan_conv_grouped_classes(coords, valid, feats, stride: int,
                              kernel_size: int, w: torch.Tensor) -> torch.Tensor:
    """Per-group submanifold conv: coords i32[G, N, 3], valid [G, N],
    feats [G, N, C], w [Gw, K^3, Cin, Cout] (group g uses w[g % Gw]).
    Returns f32[G, N, Cout]."""
    out = sparse_conv(floor_div(coords, stride), valid, feats, w,
                      kernel_size)
    return zero_invalid(out, valid)


def generative_up_classes(src_coords, src_valid, src_feats, factor: int,
                          tgt_coords, tgt_valid, w: torch.Tensor
                          ) -> torch.Tensor:
    """Generative transposed conv with kernel_size == stride == factor:
    every target voxel has exactly one (parent, kernel-offset) pair, so it
    is one parent lookup, one row gather and a per-row weight choice.

    src_coords i32[G, M, 3] in raw target units (parent lattice =
    coords / factor); tgt_* [G, N, ...]; w [G, K^3, Cin, Cout] in
    transpose_offsets order.  Returns f32[G, N, Cout]."""
    G, M, Cin = src_feats.shape
    K3 = w.shape[1]
    k = factor
    if k ** 3 != K3:
        raise ValueError(f"kernel {K3} does not tile factor {factor}")
    h = k // 2
    r = torch.remainder(tgt_coords, k)
    o = torch.remainder(-r, k)
    o = torch.where(o > h, o - k, o)
    digits = -o + h
    j_idx = (digits[..., 0] * k + digits[..., 1]) * k + digits[..., 2]
    parent = floor_div(tgt_coords + o, k)

    keys = pack_coords(floor_div(src_coords, k), src_valid)
    sk, order = torch.sort(keys, dim=1, stable=True)
    qk = pack_coords(parent, tgt_valid)
    pos = torch.searchsorted(sk, qk).clamp(max=M - 1)
    hit = (torch.gather(sk, 1, pos) == qk) & (qk != INVALID_KEY)
    row = torch.gather(order, 1, pos)
    feats = bf16_round(zero_invalid(src_feats, src_valid))
    fpar = torch.gather(feats, 1, row[..., None].expand(-1, -1, Cin))
    fpar = zero_invalid(fpar, hit)
    wq = bf16_round(w)
    acc = torch.zeros(G, tgt_coords.shape[1], w.shape[-1],
                      dtype=torch.float32, device=src_feats.device)
    for j in range(K3):
        sel = (j_idx == j) & hit
        acc += torch.bmm(zero_invalid(fpar, sel), wq[:, j])
    return zero_invalid(acc, tgt_valid)
