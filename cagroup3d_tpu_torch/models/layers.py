"""Model-facing layer helpers over the sparse engine.

Counterpart of ``cagroup3d_tpu/models/layers.py``: convs, batch norm and
activations addressed by flat parameter path.  Every odd-kernel (k >= 3)
submanifold, strided and at-coords conv runs kernel K1
(``ops/sparse_conv.py``) in eval and in training (its backward runs K1 and
K3); 1x1 convs are matmuls; the remaining forms go
through neighbour tables and ``gather_gemm``.  Stride reductions are cached
per forward by the identity of the reduced coords, so parallel reductions
of one coordinate set (biresnet ``layer3`` vs ``down3``) give the same
tensor and residual adds stay row-aligned.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.gather import take_rows_masked
from ..core.kernel_maps import (conv_offsets, neighbor_table,
                                neighbor_table_grouped, transpose_offsets)
from ..core.module import Ctx, Params, apply_bn
from ..core.norm import elu, relu
from ..core.sparse import SparseTensor, bf16_round, zero_invalid
from ..core.sparse_conv import (gather_gemm, scan_conv_grouped,
                               scan_conv_grouped_classes)
from ..core.voxelize import floor_div, stride_reduce_coords


def reduce_coords(ctx: Ctx, st: SparseTensor, factor: int, cap: int):
    key = ("reduce", id(st.coords), factor, cap)
    if key not in ctx.cache:
        # the reduced coords are pinned in the entry so their id stays unique
        out, _ = stride_reduce_coords(st, factor, cap, stats=ctx.stats,
                                      stat_name=f"stride{st.stride * factor}")
        ctx.cache[key] = (st.coords, out)
    return ctx.cache[key][1]


def subm(P: Params, ctx: Ctx, path: str, st: SparseTensor,
         k: int) -> SparseTensor:
    b = P.get(path + ".bias")
    if k == 1:  # 1x1 conv == plain matmul, no kernel map needed
        f = st.masked_feats() @ P[path + ".kernel"][0]
        if b is not None:
            f = f + b
        return st.with_feats(zero_invalid(f, st.valid))
    f = scan_conv_grouped_classes(st.coords[None], st.valid[None],
                                  st.feats[None], st.stride, k,
                                  P[path + ".kernel"][None])[0]
    if b is not None:
        f = zero_invalid(f + b, st.valid)
    return st.with_feats(f)


def down(P: Params, ctx: Ctx, path: str, st: SparseTensor, k: int,
         factor: int, cap: int) -> SparseTensor:
    """Strided conv: evaluated at the (cached) stride-reduced coords."""
    out = reduce_coords(ctx, st, factor, cap)
    return conv_at(P, ctx, path, st, out.coords, out.valid, k,
                   out_stride=out.stride)


def conv_at(P: Params, ctx: Ctx, path: str, src: SparseTensor,
            tgt_coords, tgt_valid, k: int,
            out_stride: Optional[int] = None) -> SparseTensor:
    w, b = P[path + ".kernel"], P.get(path + ".bias")
    if k % 2 == 1 and k >= 3:
        f = scan_conv_grouped(src.coords, src.valid, src.feats, src.stride,
                              tgt_coords, tgt_valid, k, w, b)
    else:
        if k % 2 == 1:
            nbr = neighbor_table_grouped(src, tgt_coords, tgt_valid, k)
        else:
            nbr = neighbor_table(src, tgt_coords, tgt_valid,
                                 conv_offsets(k, src.stride))
        f = zero_invalid(gather_gemm(src.masked_feats(), nbr, w, b),
                         tgt_valid)
    s = out_stride if out_stride is not None else src.stride
    return SparseTensor(tgt_coords, f, tgt_valid, s)


def _up_single_parent(P: Params, path: str, src: SparseTensor, tgt_coords,
                      tgt_valid, k: int, out_stride: int) -> SparseTensor:
    """Exact-tiling transposed conv (k == up_factor): every target voxel
    has exactly one parent, so one lookup and one row gather, then the
    weight of the target's position in the parent cell."""
    w = P[path + ".kernel"]                                    # [k^3, Cin, Cout]
    S = src.stride
    rem = torch.remainder(tgt_coords, S)
    parent = tgt_coords - rem
    ko = floor_div(rem, out_stride)                            # [N, 3] in [0, k)
    idx = neighbor_table(src, parent, tgt_valid, np.zeros((1, 3), np.int32))[0]
    f = take_rows_masked(src.masked_feats().to(torch.bfloat16), idx).to(
        torch.float32)
    w16 = bf16_round(w)
    # kernel_offsets order for even k: 0..k-1 per axis, x-major z-fastest
    oid = (ko[:, 0] * k + ko[:, 1]) * k + ko[:, 2]
    out = torch.zeros(tgt_coords.shape[0], w.shape[-1], dtype=torch.float32,
                      device=f.device)
    for o in range(k ** 3):
        out += zero_invalid(f, oid == o) @ w16[o]
    b = P.get(path + ".bias")
    if b is not None:
        out = out + b
    return SparseTensor(tgt_coords, zero_invalid(out, tgt_valid), tgt_valid,
                        out_stride)


def up(P: Params, ctx: Ctx, path: str, src: SparseTensor, tgt_coords,
       tgt_valid, k: int, up_factor: int) -> SparseTensor:
    if src.stride % up_factor != 0:
        raise ValueError(f"stride {src.stride} not divisible by {up_factor}")
    out_stride = src.stride // up_factor
    if k == up_factor:
        return _up_single_parent(P, path, src, tgt_coords, tgt_valid, k,
                                 out_stride)
    nbr = neighbor_table(src, tgt_coords, tgt_valid,
                         transpose_offsets(k, out_stride))
    f = gather_gemm(src.masked_feats(), nbr, P[path + ".kernel"],
                    P.get(path + ".bias"))
    return SparseTensor(tgt_coords, zero_invalid(f, tgt_valid), tgt_valid,
                        out_stride)


def bn(P: Params, S: Params, ctx: Ctx, path: str,
       st: SparseTensor) -> SparseTensor:
    return st.with_feats(apply_bn(P, S, ctx, path, st.feats, st.valid))


def act(st: SparseTensor, kind: str = "relu") -> SparseTensor:
    fn = relu if kind == "relu" else elu
    return st.with_feats(zero_invalid(fn(st.feats), st.valid))
