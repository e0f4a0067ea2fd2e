"""PointNet2 backbone with foreground-biased sampling (RBGNet).

Counterpart of ``cagroup3d_tpu/models/backbones_3d/
pointnet2_fbs_backbone.py`` (the reference's PointNet2_FBS_SSG): four
set-abstraction levels; level 0 samples by plain FPS, each later level
scores its points with a 2-channel foreground MLP, takes the TOPK highest
margins as its foreground set and FPS-samples FG_NSAMPLE centers from it
and the rest from the complement; then feature-propagation levels.  Every
input and output carries a leading scene axis.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ...core import pointnet2 as pn2
from ...core.module import Ctx, init_linear, register_flat
from ...core.nms import topk_stable
from .pointnet2_modules import (FPModule, SAModule, apply_shared_mlp,
                                init_shared_mlp)


class PointNet2FBSBackbone(nn.Module):
    """The config surface mirrors the reference's SA_CONFIG / FP_MLPS;
    parameters are registered under the JAX package's names below
    ``backbone_3d``."""

    def __init__(self, model_cfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = model_cfg
        sa = c.SA_CONFIG
        n = len(sa.NPOINTS)
        self.npoints: List[int] = [int(x) for x in sa.NPOINTS]
        self.radii = [float(x) for x in sa.RADIUS]
        self.nsamples = [int(x) for x in sa.NSAMPLE]
        self.mlps = [list(m) for m in sa.MLPS]
        self.fbs_mlps_cfg = [list(m) for m in sa.get("FBS_MLPS",
                                                     [[-1, -1]] * n)]
        self.topk = [int(x) for x in sa.get("TOPK", [-1] * n)]
        self.fg_nsample = [int(x) for x in sa.get("FG_NSAMPLE", [-1] * n)]
        self.fp_mlps = [list(m) for m in c.get("FP_MLPS", [])]
        self.in_channels = int(c.get("IN_CHANNELS", 3))

        self.sa_modules, self.sa_out = [], []
        ch = self.in_channels
        for i in range(n):
            self.sa_modules.append(SAModule(
                self.npoints[i], self.radii[i], self.nsamples[i],
                [ch] + self.mlps[i]))
            self.sa_out.append(self.mlps[i][-1])
            ch = self.mlps[i][-1]
        self.fp_modules = []
        skip = [self.in_channels] + self.sa_out
        src = skip[-1]
        for k, m in enumerate(self.fp_mlps):
            self.fp_modules.append(FPModule([src + skip[-2 - k]] + m))
            src = m[-1]
        self.num_point_features = self.fp_mlps[0][-1] if self.fp_mlps \
            else self.sa_out[-1]
        P, S = {}, {}
        gen = generator or torch.Generator().manual_seed(0)
        for i, m in enumerate(self.sa_modules):
            m.init(P, S, gen, f"SA_modules.{i}")
            if self._fbs_use(i):
                chans = [self.sa_out[i - 1]] + self.fbs_mlps_cfg[i]
                path = f"SA_modules.{i}.fbs_mlps.0"
                init_shared_mlp(P, S, gen, path, chans)
                init_linear(P, gen, f"{path}.{len(chans) - 1}", chans[-1], 2,
                            bias=True, init="uniform")
        for i, m in enumerate(self.fp_modules):
            m.init(P, S, gen, f"FP_modules.{i}")
        register_flat(self, P, S)

    def _fbs_use(self, i: int) -> bool:
        return i != 0 and self.topk[i] > 0

    def _fbs_sample(self, P, S, ctx, path, xyz, feats, valid, level):
        """2-channel foreground scores -> the TOPK-margin foreground mask
        -> FPS of FG_NSAMPLE centers over it and of the rest over its
        complement.  Returns (idx i64[B, npoint], scores [B, N, 2])."""
        n_layers = len(self.fbs_mlps_cfg[level])
        h = apply_shared_mlp(P, S, ctx, path, feats, valid, n_layers)
        scores = h @ P[f"{path}.{n_layers}.weight"] + \
            P[f"{path}.{n_layers}.bias"]
        sm = torch.softmax(scores, -1)
        margin = torch.where(valid, sm[..., 1] - sm[..., 0],
                             torch.full_like(sm[..., 0], -1e10))
        fg_n, npoint = self.fg_nsample[level], self.npoints[level]
        # lax.top_k: ties to the lower index
        _, top_idx = topk_stable(margin.detach(), self.topk[level])
        fg_mask = torch.zeros_like(valid).scatter_(
            1, top_idx, torch.ones_like(top_idx, dtype=torch.bool)) & valid
        idx = pn2.farthest_point_sample(xyz, fg_mask, fg_n)
        if npoint > fg_n:
            idx = torch.cat([idx, pn2.farthest_point_sample(
                xyz, valid & ~fg_mask, npoint - fg_n)], 1)
        return idx, scores

    def forward(self, P, S, ctx: Ctx, xyz, feats, valid,
                prefix: str = "backbone_3d"):
        """xyz [B, N, 3], feats [B, N, C] (rgb) or None, valid [B, N].
        Returns dict(fp_xyz, fp_features, fp_valid, fp_indices, sa_scores
        [per FBS level: (scores [B, N_i, 2], indices of its points into
        the input points)], points_cat, points_valid)."""
        xs, fs, vs = [xyz], [feats], [valid]
        idxs = [torch.arange(xyz.shape[1], device=xyz.device)
                .expand(xyz.shape[0], -1)]
        sa_scores = []
        for i, m in enumerate(self.sa_modules):
            if self._fbs_use(i):
                idx, score = self._fbs_sample(
                    P, S, ctx, f"{prefix}.SA_modules.{i}.fbs_mlps.0",
                    xs[-1], fs[-1], vs[-1], i)
                sa_scores.append((score, idxs[-1]))
            else:
                idx = pn2.farthest_point_sample(xs[-1], vs[-1],
                                                self.npoints[i])
            nx, nf, nv, _ = m(P, S, ctx, f"{prefix}.SA_modules.{i}",
                              xs[-1], fs[-1], vs[-1], sample_idx=idx)
            xs.append(nx)
            fs.append(nf)
            vs.append(nv)
            idxs.append(pn2.gather1(idxs[-1], idx))
        fp_x, fp_f, fp_v, fp_i = xs[-1], fs[-1], vs[-1], idxs[-1]
        for i, m in enumerate(self.fp_modules):
            fine = -2 - i
            fp_f = m(P, S, ctx, f"{prefix}.FP_modules.{i}", xs[fine],
                     fs[fine], vs[fine], fp_x, fp_f, fp_v)
            fp_x, fp_v, fp_i = xs[fine], vs[fine], idxs[fine]
        return dict(fp_xyz=fp_x, fp_features=fp_f, fp_valid=fp_v,
                    fp_indices=fp_i, sa_scores=sa_scores, points_cat=xyz,
                    points_valid=valid)
