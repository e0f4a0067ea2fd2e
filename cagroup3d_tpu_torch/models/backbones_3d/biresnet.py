"""BiResNet: bilateral fully-sparse 3D backbone with a DAPPM neck (eval).

Counterpart of ``cagroup3d_tpu/models/backbones_3d/biresnet.py``: a
low-resolution ResNet branch (strides 2..64 of the input lattice) and a
high-resolution branch held at stride 4, fused by 1x1 compression convs +
trilinear features-at-coordinates and strided ``down`` convs, a DAPPM
average-pooling pyramid on the deepest map, and a transposed-conv output
head decoded at the stride-2 coordinate map.  Parameter paths are the JAX
package's (``layer1.0.conv1.kernel``, ``spp.scale1.3.kernel``, ...).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.module import Ctx, Params, init_bn, init_conv, register_flat
from ...core.pooling import avg_pool, interpolate_at
from ...core.sparse import SparseTensor
from ..layers import act, bn, down, subm, up

DEFAULT_CAPS = {1: 65536, 2: 32768, 4: 16384, 8: 8192, 16: 4096, 32: 2048,
                64: 1024, 128: 512, 256: 256, 512: 128}


class BiResNet(nn.Module):
    def __init__(self, model_cfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = model_cfg.get("IN_CHANNELS", 3)
        self.out_channels = model_cfg.get("OUT_CHANNELS", 64)
        self.layers = model_cfg.get("LAYERS", [2, 2, 2, 2])
        self.planes = model_cfg.get("PLANES", 64)
        self.spp_planes = model_cfg.get("SPP_PLANES", 128)
        self.caps = dict(DEFAULT_CAPS)
        caps = model_cfg.get("CAPS", None)
        if caps:
            self.caps.update({int(k): int(v) for k, v in dict(caps).items()})
        P, S = self._init(generator or torch.Generator().manual_seed(0))
        register_flat(self, P, S)

    # ------------------------------------------------------------------
    def _init_basic_block(self, P, S, gen, p, cin, cout, stride):
        init_conv(P, gen, p + ".conv1", 3, cin, cout, init="kaiming")
        init_bn(P, S, p + ".norm1", cout)
        init_conv(P, gen, p + ".conv2", 3, cout, cout, init="kaiming")
        init_bn(P, S, p + ".norm2", cout)
        if stride != 1 or cin != cout:
            init_conv(P, gen, p + ".downsample.0", 1, cin, cout, init="kaiming")
            init_bn(P, S, p + ".downsample.1", cout)

    def _init_bottleneck(self, P, S, gen, p, cin, planes, stride):
        cout = planes * 2
        init_conv(P, gen, p + ".conv1", 1, cin, planes, init="kaiming")
        init_bn(P, S, p + ".norm1", planes)
        init_conv(P, gen, p + ".conv2", 3, planes, planes, init="kaiming")
        init_bn(P, S, p + ".norm2", planes)
        init_conv(P, gen, p + ".conv3", 1, planes, cout, init="kaiming")
        init_bn(P, S, p + ".norm3", cout)
        if stride != 1 or cin != cout:
            init_conv(P, gen, p + ".downsample.0", 1, cin, cout, init="kaiming")
            init_bn(P, S, p + ".downsample.1", cout)

    def _init_layer(self, P, S, gen, p, cin, cout, blocks, stride):
        self._init_basic_block(P, S, gen, p + ".0", cin, cout, stride)
        for i in range(1, blocks):
            self._init_basic_block(P, S, gen, f"{p}.{i}", cout, cout, 1)

    def _init(self, gen: torch.Generator):
        P: Params = {}
        S: Params = {}
        pl, hr, spp = self.planes, self.planes * 2, self.spp_planes
        init_conv(P, gen, "conv1.0", 3, self.in_channels, pl, init="kaiming")
        init_bn(P, S, "conv1.1", pl)
        init_conv(P, gen, "conv1.3", 3, pl, pl, init="kaiming")
        init_bn(P, S, "conv1.4", pl)
        self._init_layer(P, S, gen, "layer1", pl, pl, self.layers[0], 2)
        self._init_layer(P, S, gen, "layer2", pl, pl * 2, self.layers[1], 2)
        self._init_layer(P, S, gen, "layer3", pl * 2, pl * 4, self.layers[2], 2)
        self._init_layer(P, S, gen, "layer4", pl * 4, pl * 8, self.layers[3], 2)
        init_conv(P, gen, "compression3.0", 1, pl * 4, hr, init="kaiming")
        init_bn(P, S, "compression3.1", hr)
        init_conv(P, gen, "compression4.0", 1, pl * 8, hr, init="kaiming")
        init_bn(P, S, "compression4.1", hr)
        init_conv(P, gen, "down3.0", 3, hr, pl * 4, init="kaiming")
        init_bn(P, S, "down3.1", pl * 4)
        init_conv(P, gen, "down4.0", 3, hr, pl * 4, init="kaiming")
        init_bn(P, S, "down4.1", pl * 4)
        init_conv(P, gen, "down4.3", 3, pl * 4, pl * 8, init="kaiming")
        init_bn(P, S, "down4.4", pl * 8)
        self._init_layer(P, S, gen, "layer3_", pl * 2, hr, 2, 1)
        self._init_layer(P, S, gen, "layer4_", hr, hr, 2, 1)
        self._init_bottleneck(P, S, gen, "layer5_.0", hr, hr, 1)
        self._init_bottleneck(P, S, gen, "layer5.0", pl * 8, pl * 8, 2)
        cin = pl * 16                                   # DAPPM input
        init_bn(P, S, "spp.scale0.0", cin)
        init_conv(P, gen, "spp.scale0.2", 1, cin, spp, init="kaiming")
        for i in range(1, 5):
            init_bn(P, S, f"spp.scale{i}.1", cin)
            init_conv(P, gen, f"spp.scale{i}.3", 1, cin, spp, init="kaiming")
            init_bn(P, S, f"spp.process{i}.0", spp)
            init_conv(P, gen, f"spp.process{i}.2", 3, spp, spp, init="kaiming")
        init_bn(P, S, "spp.compression.0", spp * 5)
        init_conv(P, gen, "spp.compression.2", 1, spp * 5, pl * 4,
                  init="kaiming")
        init_bn(P, S, "spp.shortcut.0", cin)
        init_conv(P, gen, "spp.shortcut.2", 1, cin, pl * 4, init="kaiming")
        init_conv(P, gen, "out.0", 2, pl * 4, pl * 4, init="kaiming")
        init_bn(P, S, "out.1", pl * 4)
        init_conv(P, gen, "out.3", 1, pl * 4, self.out_channels, init="kaiming")
        init_bn(P, S, "out.4", self.out_channels)
        return P, S

    # ------------------------------------------------------------------
    def _basic_block(self, P, S, ctx, p, x: SparseTensor, stride, cap,
                     no_relu) -> SparseTensor:
        if stride == 1:
            out = subm(P, ctx, p + ".conv1", x, 3)
        else:
            out = down(P, ctx, p + ".conv1", x, 3, stride, cap)
        out = act(bn(P, S, ctx, p + ".norm1", out))
        out = bn(P, S, ctx, p + ".norm2", subm(P, ctx, p + ".conv2", out, 3))
        out = out.with_feats(out.feats + self._residual(P, S, ctx, p, x,
                                                        stride, cap).feats)
        return out if no_relu else act(out)

    def _residual(self, P, S, ctx, p, x, stride, cap) -> SparseTensor:
        if (p + ".downsample.0.kernel") not in P:
            return x
        if stride == 1:
            res = subm(P, ctx, p + ".downsample.0", x, 1)
        else:
            res = down(P, ctx, p + ".downsample.0", x, 1, stride, cap)
        return bn(P, S, ctx, p + ".downsample.1", res)

    def _bottleneck(self, P, S, ctx, p, x: SparseTensor, stride,
                    cap) -> SparseTensor:
        out = act(bn(P, S, ctx, p + ".norm1", subm(P, ctx, p + ".conv1", x, 1)))
        if stride == 1:
            out = subm(P, ctx, p + ".conv2", out, 3)
        else:
            out = down(P, ctx, p + ".conv2", out, 3, stride, cap)
        out = act(bn(P, S, ctx, p + ".norm2", out))
        out = bn(P, S, ctx, p + ".norm3", subm(P, ctx, p + ".conv3", out, 1))
        res = self._residual(P, S, ctx, p, x, stride, cap)
        return out.with_feats(out.feats + res.feats)

    def _layer(self, P, S, ctx, p, x, blocks, stride, cap):
        x = self._basic_block(P, S, ctx, p + ".0", x, stride, cap,
                              no_relu=False)
        for i in range(1, blocks):
            x = self._basic_block(P, S, ctx, f"{p}.{i}", x, 1, cap,
                                  no_relu=(i == blocks - 1))
        return x

    def _bn_relu_conv(self, P, S, ctx, bn_path, conv_path, x, k):
        return subm(P, ctx, conv_path, act(bn(P, S, ctx, bn_path, x)), k)

    def _dappm(self, P, S, ctx, pre, x: SparseTensor) -> SparseTensor:
        xs = [self._bn_relu_conv(P, S, ctx, pre + ".scale0.0",
                                 pre + ".scale0.2", x, 1)]
        qcoords = x.coords.to(torch.float32)
        for i, (k, s) in enumerate([(5, 2), (9, 4), (17, 8), (33, 16)],
                                   start=1):
            pooled = avg_pool(x, k, s, self.caps.get(x.stride * s, 128))
            y = self._bn_relu_conv(P, S, ctx, f"{pre}.scale{i}.1",
                                   f"{pre}.scale{i}.3", pooled, 1)
            feat = interpolate_at(y, qcoords, x.valid)
            merged = x.with_feats(feat + xs[i - 1].feats)
            xs.append(self._bn_relu_conv(P, S, ctx, f"{pre}.process{i}.0",
                                         f"{pre}.process{i}.2", merged, 3))
        cat = x.with_feats(torch.cat([t.feats for t in xs], dim=-1))
        out = self._bn_relu_conv(P, S, ctx, pre + ".compression.0",
                                 pre + ".compression.2", cat, 1)
        sc = self._bn_relu_conv(P, S, ctx, pre + ".shortcut.0",
                                pre + ".shortcut.2", x, 1)
        return out.with_feats(out.feats + sc.feats)

    def forward(self, P: Params, S: Params, ctx: Ctx, st: SparseTensor,
              prefix: str = "backbone_3d", stop_after: Optional[str] = None):
        """``stop_after`` cuts as in the JAX package: "stem", "layer1",
        "layer2", "fuse3", "fuse4", "layer5", "spp" return the live tensors
        at that point (both bilateral branches where both are live)."""
        pre, caps, nblk, base = prefix, self.caps, self.layers, st.stride
        x = act(bn(P, S, ctx, pre + ".conv1.1",
                   subm(P, ctx, pre + ".conv1.0", st, 3)))
        x = act(bn(P, S, ctx, pre + ".conv1.4",
                   subm(P, ctx, pre + ".conv1.3", x, 3)))
        if stop_after == "stem":
            return x
        l1 = self._layer(P, S, ctx, pre + ".layer1", x, nblk[0], 2,
                         caps[base * 2])
        if stop_after == "layer1":
            return l1
        l2 = self._layer(P, S, ctx, pre + ".layer2", act(l1), nblk[1], 2,
                         caps[base * 4])
        if stop_after == "layer2":
            return l2
        l3 = self._layer(P, S, ctx, pre + ".layer3", act(l2), nblk[2], 2,
                         caps[base * 8])
        x_ = self._layer(P, S, ctx, pre + ".layer3_", act(l2), 2, 1,
                         caps[base * 4])
        d3 = bn(P, S, ctx, pre + ".down3.1",
                down(P, ctx, pre + ".down3.0", act(x_), 3, 2, caps[base * 8]))
        xm = l3.with_feats(l3.feats + d3.feats)  # same coord set (cached reduce)
        c3 = bn(P, S, ctx, pre + ".compression3.1",
                subm(P, ctx, pre + ".compression3.0", act(l3), 1))
        x_ = x_.with_feats(x_.feats + interpolate_at(
            c3, x_.coords.to(torch.float32), x_.valid))
        if stop_after == "fuse3":
            return xm, x_
        l4 = self._layer(P, S, ctx, pre + ".layer4", act(xm), nblk[3], 2,
                         caps[base * 16])
        x_ = self._layer(P, S, ctx, pre + ".layer4_", act(x_), 2, 1,
                         caps[base * 4])
        d4 = bn(P, S, ctx, pre + ".down4.1",
                down(P, ctx, pre + ".down4.0", act(x_), 3, 2, caps[base * 8]))
        d4 = bn(P, S, ctx, pre + ".down4.4",
                down(P, ctx, pre + ".down4.3", act(d4), 3, 2, caps[base * 16]))
        xm = l4.with_feats(l4.feats + d4.feats)
        c4 = bn(P, S, ctx, pre + ".compression4.1",
                subm(P, ctx, pre + ".compression4.0", act(l4), 1))
        x_ = x_.with_feats(x_.feats + interpolate_at(
            c4, x_.coords.to(torch.float32), x_.valid))
        if stop_after == "fuse4":
            return xm, x_
        x_ = self._bottleneck(P, S, ctx, pre + ".layer5_.0", act(x_), 1,
                              caps[base * 4])
        l5 = self._bottleneck(P, S, ctx, pre + ".layer5.0", act(xm), 2,
                              caps[base * 32])
        if stop_after == "layer5":
            return l5, x_
        sppo = self._dappm(P, S, ctx, pre + ".spp", l5)
        x_ = x_.with_feats(x_.feats + interpolate_at(
            sppo, x_.coords.to(torch.float32), x_.valid))
        if stop_after == "spp":
            return x_
        # out head: transpose k2 s2 decoded at the stride-2 map (layer1 coords)
        y = up(P, ctx, pre + ".out.0", x_, l1.coords, l1.valid, 2, 2)
        y = act(bn(P, S, ctx, pre + ".out.1", y))
        y = subm(P, ctx, pre + ".out.3", y, 1)
        return act(bn(P, S, ctx, pre + ".out.4", y))
