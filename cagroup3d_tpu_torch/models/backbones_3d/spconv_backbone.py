"""VoxelBackBone8x: the spconv-style sparse backbone of SECOND (eval).

Counterpart of ``VoxelBackBone8x`` in
``cagroup3d_tpu/models/backbones_3d/spconv_backbone.py`` (the reference's
pcdet/models/backbones_3d/spconv_backbone.py:70): a submanifold stem, three
stages of a stride-2 SparseConv3d and two submanifold convs, and the
z-compressing ``conv_out``.  Every level keeps coordinates in its own
lattice units (stride 1), so the anisotropic strides are first-class.

Routing:
- the 8 k3 submanifold convs run kernel K1 through ``layers.subm``;
- the 3 strided convs (k3, s2, spconv output lattice from
  ``core/voxelize.spconv_reduce_lat``) run K1's conv-at-coords form: the
  JAX package sums offsets j in 0..2 per axis at targets o*s - p + j, which
  is K1's centred stencil -1..1 at the query o*s - p + 1, with the same
  weight order (x-major, z fastest);
- ``conv_out``, kernel (1, 1, 3), is not a cube: a plain f32 lookup,
  gather and matmul per offset, as the JAX package computes it outside any
  Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...core.gather import take_rows_masked
from ...core.kernel_maps import neighbor_table
from ...core.module import Ctx, Params, apply_bn, init_bn, init_conv, \
    kaiming_conv, register_flat
from ...core.norm import relu
from ...core.sparse import SparseTensor, zero_invalid
from ...core.voxelize import spconv_reduce_lat, triple
from ...ops.sparse_conv import sparse_conv
from ..layers import subm

DEFAULT_CAPS = {1: 65536, 2: 32768, 4: 16384, 8: 8192}


def down_extent(ext, k, s, p):
    """Dense output extent of a strided conv: (X + 2p - k) // s + 1."""
    return tuple((e + 2 * q - w) // t + 1 for e, w, t, q in
                 zip(ext, triple(k), triple(s), triple(p)))


def spconv_down(P: Params, ctx: Ctx, path: str, st: SparseTensor, pad,
                cap: int, in_extent=None) -> SparseTensor:
    """Strided SparseConv3d (k3, s2, padding ``pad``) with spconv
    coordinate semantics, through K1's conv-at-coords form."""
    p = torch.tensor(triple(pad), dtype=torch.int32, device=st.coords.device)
    out_lat, out_valid = spconv_reduce_lat(
        st.coords, st.valid, 3, 2, pad, cap, stats=ctx.stats,
        stat_name=f"spconv/{path}", in_extent=in_extent)
    qry = out_lat * 2 - p + 1           # the centre of o*s - p + [0, 3)
    f = sparse_conv(st.coords[None], st.valid[None], st.feats[None],
                    P[path + ".kernel"][None], 3, qry[None],
                    out_valid[None])[0]
    return SparseTensor(out_lat, zero_invalid(f, out_valid), out_valid, 1)


def offset_conv(src: SparseTensor, tgt_lat: torch.Tensor,
                tgt_valid: torch.Tensor, offsets: np.ndarray,
                w: torch.Tensor) -> torch.Tensor:
    """out[q] = sum_j feats[row(tgt_lat[q] + offsets[j])] @ w[j] in f32
    (missing neighbours add nothing); the JAX ``scan_conv`` at stride 1."""
    nbr = neighbor_table(src, tgt_lat, tgt_valid, offsets)
    feats = src.masked_feats()
    out = sum(take_rows_masked(feats, nbr[j]) @ w[j]
              for j in range(len(offsets)))
    return zero_invalid(out, tgt_valid)


class VoxelBackBone8x(nn.Module):
    """Parameters under the JAX package's names: ``conv_input.0.kernel``
    [27, Cin, 16], ``conv{2,3,4}.{0,1,2}.0.kernel``, ``conv_out.0.kernel``
    [3, 64, 128] and the BN ``*.1`` entries."""

    def __init__(self, model_cfg, input_channels: int = 4, grid_size=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_ch = int(model_cfg.get("IN_CHANNELS", input_channels))
        self.caps = dict(DEFAULT_CAPS)
        caps = model_cfg.get("CAPS", None)
        if caps:
            self.caps.update({int(k): int(v) for k, v in dict(caps).items()})
        self.num_point_features = 128
        # spconv's sparse_shape adds 1 to z (spconv_backbone.py:75); the
        # extents, in (x, y, z), bound each level's lattice
        self.extents = None
        self.final_extent = None
        if grid_size is not None:
            gx, gy, gz = (int(g) for g in grid_size)
            e1 = (gx, gy, gz + 1)
            e2 = down_extent(e1, 3, 2, 1)
            e3 = down_extent(e2, 3, 2, 1)
            e4 = down_extent(e3, 3, 2, (1, 1, 0))
            self.final_extent = down_extent(e4, (1, 1, 3), (1, 1, 2), 0)
            self.extents = {1: e1, 2: e2, 4: e3, 8: e4}
        P, S = self._init(generator or torch.Generator().manual_seed(0))
        register_flat(self, P, S)

    def _init(self, gen: torch.Generator):
        P: Params = {}
        S: Params = {}
        chans = [("conv_input", self.in_ch, 16), ("conv1.0", 16, 16),
                 ("conv2.0", 16, 32), ("conv2.1", 32, 32), ("conv2.2", 32, 32),
                 ("conv3.0", 32, 64), ("conv3.1", 64, 64), ("conv3.2", 64, 64),
                 ("conv4.0", 64, 64), ("conv4.1", 64, 64), ("conv4.2", 64, 64)]
        for path, cin, cout in chans:
            init_conv(P, gen, path + ".0", 3, cin, cout, init="kaiming")
            init_bn(P, S, path + ".1", cout)
        P["conv_out.0.kernel"] = kaiming_conv(gen, 3, 64, 128)
        init_bn(P, S, "conv_out.1", 128)
        return P, S

    @staticmethod
    def _bn_relu(P, S, ctx, path, st: SparseTensor) -> SparseTensor:
        f = apply_bn(P, S, ctx, path, st.feats, st.valid, eps=1e-3,
                     momentum=0.01)
        return st.with_feats(zero_invalid(relu(f), st.valid))

    def forward(self, P: Params, S: Params, ctx: Ctx, st: SparseTensor,
                prefix: str = "backbone_3d") -> Dict:
        """st: the stride-1 voxel tensor.  Returns the final z-compressed
        level and the per-level tensors, as the JAX package does."""
        pre, caps, ext = prefix, self.caps, self.extents or {}
        x = self._bn_relu(P, S, ctx, pre + ".conv_input.1",
                          subm(P, ctx, pre + ".conv_input.0", st, 3))
        x1 = self._bn_relu(P, S, ctx, pre + ".conv1.0.1",
                           subm(P, ctx, pre + ".conv1.0.0", x, 3))

        def stage(xin, path, cap, pad, in_ext):
            y = spconv_down(P, ctx, f"{pre}.{path}.0.0", xin, pad, cap,
                            in_extent=in_ext)
            y = self._bn_relu(P, S, ctx, f"{pre}.{path}.0.1", y)
            for i in (1, 2):
                y = self._bn_relu(P, S, ctx, f"{pre}.{path}.{i}.1",
                                  subm(P, ctx, f"{pre}.{path}.{i}.0", y, 3))
            return y

        x2 = stage(x1, "conv2", caps[2], 1, ext.get(1))
        x3 = stage(x2, "conv3", caps[4], 1, ext.get(2))
        # the reference's padding (0, 1, 1) is in spconv's (z, y, x) order
        x4 = stage(x3, "conv4", caps[8], (1, 1, 0), ext.get(4))
        # conv_out: kernel (3, 1, 1), stride (2, 1, 1) in (z, y, x)
        out_lat, out_valid = spconv_reduce_lat(
            x4.coords, x4.valid, (1, 1, 3), (1, 1, 2), 0, caps[8],
            stats=ctx.stats, stat_name="spconv/out", in_extent=ext.get(8))
        tgt = out_lat * torch.tensor([1, 1, 2], dtype=torch.int32,
                                     device=out_lat.device)
        f = offset_conv(x4, tgt, out_valid,
                        np.array([(0, 0, a) for a in range(3)], np.int32),
                        P[pre + ".conv_out.0.kernel"])
        out = self._bn_relu(P, S, ctx, pre + ".conv_out.1",
                            SparseTensor(out_lat, f, out_valid, 1))
        return dict(encoded_spconv_tensor=out,
                    encoded_spconv_tensor_stride=8,
                    multi_scale_3d_features=dict(x_conv1=x1, x_conv2=x2,
                                                 x_conv3=x3, x_conv4=x4))
