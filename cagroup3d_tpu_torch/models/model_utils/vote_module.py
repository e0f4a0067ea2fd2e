"""VoteModule: votes (offsets and residual features) from seed points, and
the Chamfer distance of its vote loss.

Counterpart of ``cagroup3d_tpu/models/model_utils/vote_module.py``, with a
leading scene axis on every input.
"""
from __future__ import annotations

import torch

from ...core.module import Ctx, Params, init_bn, init_linear
from ...core.pointnet2 import sq_dist
from ..backbones_3d.pointnet2_modules import bn_rows, masked_relu


def chamfer_distance(src, src_valid, dst, dst_valid):
    """Two-sided masked squared Chamfer distance over [..., N, 3] and
    [..., M, 3]: (loss_src [..., N], loss_dst [..., M])."""
    big = torch.full((), 1e10, dtype=src.dtype, device=src.device)
    d2 = sq_dist(src, dst)
    d2 = torch.where(dst_valid[..., None, :], d2, big)
    d2 = torch.where(src_valid[..., :, None], d2, big)
    # amin: tied minima share the gradient, as jnp.min's do
    src_min = torch.where(dst_valid[..., None, :], d2, big).amin(-1)
    dst_min = torch.where(src_valid[..., :, None], d2, big).amin(-2)
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    return (torch.where(src_valid, src_min, zero),
            torch.where(dst_valid, dst_min, zero))


class VoteModule:
    def __init__(self, model_cfg):
        c = model_cfg
        self.in_channels = c["IN_CHANNELS"]
        self.vote_per_seed = c.get("VOTE_PER_SEED", 1)
        self.gt_per_seed = c.get("GT_PER_SEED", 3)
        self.conv_channels = list(c.get("CONV_CHANNELS", (16, 16)))
        self.norm_feats = c.get("NORM_FEATS", True)
        self.with_res_feat = c.get("WITH_RES_FEAT", True)
        self.vote_xyz_range = c.get("VOTE_XYZ_RANGE", None)
        self.loss_dst_weight = c.get("VOTE_LOSS", {}).get("LOSS_DST_WEIGHT",
                                                          10.0)

    def init(self, P: Params, S: Params, gen: torch.Generator,
             prefix: str) -> None:
        chans = [self.in_channels] + self.conv_channels
        for i in range(len(chans) - 1):
            init_linear(P, gen, f"{prefix}.vote_conv.{i}.conv", chans[i],
                        chans[i + 1], bias=True, init="uniform")
            init_bn(P, S, f"{prefix}.vote_conv.{i}.bn", chans[i + 1])
        out_ch = (3 + self.in_channels if self.with_res_feat else 3) * \
            self.vote_per_seed
        init_linear(P, gen, f"{prefix}.conv_out", chans[-1], out_ch,
                    bias=True, init="uniform")

    def __call__(self, P, S, ctx: Ctx, seed_xyz, seed_feats, seed_valid,
                 prefix: str = "vote_module"):
        """seed_xyz [B, N, 3], seed_feats [B, N, C] -> (vote_xyz
        [B, N*V, 3], vote_feats [B, N*V, C], offsets [B, N*V, 3],
        vote_valid [B, N*V])."""
        x = seed_feats
        for i in range(len(self.conv_channels)):
            x = x @ P[f"{prefix}.vote_conv.{i}.conv.weight"] + \
                P[f"{prefix}.vote_conv.{i}.conv.bias"]
            x = masked_relu(bn_rows(P, S, ctx, f"{prefix}.vote_conv.{i}.bn",
                                    x, seed_valid), seed_valid)
        votes = x @ P[f"{prefix}.conv_out.weight"] + \
            P[f"{prefix}.conv_out.bias"]
        B, N = seed_xyz.shape[:2]
        V = self.vote_per_seed
        votes = votes.reshape(B, N, V, -1)
        offset = votes[..., :3]
        if self.vote_xyz_range is not None:
            r = torch.as_tensor(self.vote_xyz_range, dtype=offset.dtype,
                                device=offset.device)
            offset = torch.maximum(torch.minimum(offset, r), -r)
        vote_xyz = (seed_xyz[:, :, None, :] + offset).reshape(B, N * V, 3)
        if self.with_res_feat:
            vote_feats = (seed_feats[:, :, None, :] + votes[..., 3:]) \
                .reshape(B, N * V, -1)
            if self.norm_feats:
                norm = torch.linalg.vector_norm(vote_feats, dim=-1,
                                                keepdim=True)
                vote_feats = vote_feats / torch.clamp(norm, min=1e-8)
        else:
            vote_feats = seed_feats.repeat_interleave(V, dim=1)
        vote_valid = seed_valid.repeat_interleave(V, dim=1)
        vote_feats = torch.where(vote_valid[..., None], vote_feats,
                                 torch.zeros((), dtype=vote_feats.dtype,
                                             device=vote_feats.device))
        return vote_xyz, vote_feats, offset.reshape(B, N * V, 3), vote_valid

    def get_loss(self, seed_xyz, vote_xyz, seed_valid, vote_target_mask,
                 vote_targets):
        """Per scene [B]: the squared distance of each vote to the nearest
        of its seed's ``gt_per_seed`` targets, weighted over the masked
        seeds (vote_module.py get_loss)."""
        B, N = seed_xyz.shape[:2]
        weight = (vote_target_mask & seed_valid).to(seed_xyz.dtype)
        weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1.0)
        vt = seed_xyz[:, :, None, :] + vote_targets.reshape(
            B, N, self.gt_per_seed, 3)
        vx = vote_xyz.reshape(B, N, self.vote_per_seed, 3)
        dmin = sq_dist(vx, vt).amin(-1)                       # [B, N, V]
        return (dmin.sum(-1) * weight).sum(-1) * self.loss_dst_weight
