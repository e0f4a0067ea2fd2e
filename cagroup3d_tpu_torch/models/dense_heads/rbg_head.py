"""RBGNet head: vote -> aggregate -> ray-based grouping -> predict.

Counterpart of ``cagroup3d_tpu/models/dense_heads/rbg_head.py`` (reference
rbg_head.py RBGHead, RayBasedGrouping): per proposal, quasi-uniform rays
scaled by a predicted scale; coarse bins along each ray are tested for
surface hits (a ball query against an FPS subsample of the scene), an
intersection classifier gates the per-bin features, fine bins are
resampled by inverse CDF from the gated coarse hits, and the gated bin
and ray features are reduced into one vector per proposal that conditions
the box regression.

Every tensor carries a leading scene axis; batch norm normalizes the rows
of all scenes at once (pooled statistics in training, as the JAX
package's ``psum`` over its scene axis).  The forward returns the indices
of its FPS subsample of the scene (``ray_fps_idx``): the targets' subsample
is the same call on the same points, and reuses them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core import pointnet2 as pn2
from ...core.module import Ctx, init_bn, init_linear, register_flat
from ...core.nms import topk_stable
from ...utils import loss_utils as L
from ...utils.commu_utils import global_sum, group_size
from ..backbones_3d.pointnet2_modules import (SAModule, bn_rows, masked_relu,
                                              relu)
from ..model_utils.rbgnet_utils import (RBGBBoxCoder, aligned_3d_nms,
                                        generate_ray)
from ..model_utils.vote_module import VoteModule, chamfer_distance
from .target_assigner.cagroup3d_assigner import find_points_in_boxes

INSIDE_CHUNK = 16384      # points per chunk of the boxes' point counts


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)


def _init_mlp(P, S, gen, path, channels: List[int], bias=True):
    """BasicBlock1D stack (conv + BN + ReLU on every layer), the
    reference's rbgnet_utils.MLP: {path}.mlp.layer{i}.conv / .bn."""
    for i in range(len(channels) - 1):
        init_linear(P, gen, f"{path}.mlp.layer{i}.conv", channels[i],
                    channels[i + 1], bias=bias, init="kaiming")
        init_bn(P, S, f"{path}.mlp.layer{i}.bn", channels[i + 1])


def _apply_mlp(P, S, ctx, path, x, mask, n_layers):
    """x [..., C]; mask [...] (None: every row)."""
    mask = _ones(x) if mask is None else mask
    for i in range(n_layers):
        x = x @ P[f"{path}.mlp.layer{i}.conv.weight"]
        b = P.get(f"{path}.mlp.layer{i}.conv.bias")
        if b is not None:
            x = x + b
        x = masked_relu(bn_rows(P, S, ctx, f"{path}.mlp.layer{i}.bn", x,
                                mask), mask)
    return x


def _any_within(queries, points, pvalid, radius, point_group=None,
                query_group=None):
    """bool[B, Q]: any valid point within ``radius`` of each query; with
    group ids only points of the query's group count (the reference's
    ball_query(r, 1) against per-instance point lists)."""
    B, Q = queries.shape[:2]
    out = []
    step = pn2.query_chunk(B, Q, points.shape[1])
    for s in range(0, Q, step):
        ok = pvalid[:, None, :]
        if query_group is not None:
            ok = ok & (point_group[:, None, :] ==
                       query_group[:, s:s + step, None])
        hit = pn2.sq_dist(queries[:, s:s + step], points) < radius ** 2
        out.append((hit & ok).any(-1))
    return torch.cat(out, 1)


class RayBasedGrouping:
    def __init__(self, cfg):
        self.ray_num = int(cfg.RAY_NUM)
        self.seed_feat_dim = int(cfg.SEED_FEAT_DIM)
        self.sample_bin_num = int(cfg.SAMPLE_BIN_NUM)
        self.sa_radius = float(cfg.SA_RADIUS)
        self.scale_ratio = float(cfg.SCALE_RATIO)
        self.fps_num_sample = int(cfg.FPS_NUM_SAMPLE)
        self.sa_num_sample = int(cfg.SA_NUM_SAMPLE)
        self.fine_sample_bin_num = int(cfg.FINE_SAMPLE_BIN_NUM)
        self.fine_sa_radius = float(cfg.FINE_SA_RADIUS)
        self.fine_sa_num_sample = int(cfg.FINE_SA_NUM_SAMPLE)
        self.reduce = self.seed_feat_dim // 4
        self.half = self.reduce // 2
        self.rays = torch.from_numpy(
            generate_ray(self.ray_num).astype(np.float32))       # [R, 3]
        nb, nf = self.sample_bin_num, self.fine_sample_bin_num
        # coarse bins at b / nb for b = nb..1; fine-sample quantiles
        self.coarse_fr = torch.tensor([b / nb for b in range(nb, 0, -1)],
                                      dtype=torch.float32)
        self.u = torch.from_numpy(np.linspace(1e-4, 1.0 - 1e-5, nf)
                                  .astype(np.float32))

    def init(self, P, S, gen, pre):
        d, h, half = self.seed_feat_dim, self.seed_feat_dim // 2, self.half
        _init_mlp(P, S, gen, f"{pre}.seed_feat_reduce", [d, h, self.reduce])
        for name in ("fine_seed_aggregation", "coarse_seed_aggregation"):
            init_linear(P, gen, f"{pre}.{name}.mlps.0.0.conv",
                        self.reduce + 3, half, bias=False, init="kaiming")
            init_bn(P, S, f"{pre}.{name}.mlps.0.0.bn", half)
        for name in ("fine", "coarse"):
            _init_mlp(P, S, gen, f"{pre}.{name}_intersection_module",
                      [half + h, half, 2])
        _init_mlp(P, S, gen, f"{pre}.fine_bin_reduce_dim",
                  [self.fine_sample_bin_num * half, half])
        _init_mlp(P, S, gen, f"{pre}.fine_ray_reduce_dim",
                  [self.ray_num * half, d, h])
        _init_mlp(P, S, gen, f"{pre}.coarse_bin_reduce_dim",
                  [self.sample_bin_num * half, half])
        _init_mlp(P, S, gen, f"{pre}.coarse_ray_reduce_dim",
                  [self.ray_num * half, d, h])
        _init_mlp(P, S, gen, f"{pre}.fuse_layer", [d, d, h])

    # ------------------------------------------------------------------
    def _ray_vectors(self, scale_pred):
        rays = self.rays.to(scale_pred.device)
        return rays * scale_pred[..., None, None]               # [B, P, R, 3]

    def coarse_positions(self, centers, scale_pred):
        """[B, P, nb, R, 3]: bins at b / nb along each scaled ray for
        b = nb..1 (descending)."""
        fr = self.coarse_fr.to(centers.device) * self.scale_ratio
        rel = self._ray_vectors(scale_pred)[:, :, None] * \
            fr[:, None, None]
        return centers[:, :, None, None, :] + rel

    def fine_fractions(self, coarse_hits):
        """Inverse-CDF resampling of fine bin fractions from the gated
        coarse hits: coarse_hits [B, P, nb, R] (0/1) -> [B, P, nf, R].
        The search (right side) is written as a count, with the
        reference's clip of the bin index."""
        nb = self.sample_bin_num
        dev = coarse_hits.device
        w = coarse_hits.transpose(-1, -2) + 1e-5                # [B, P, R, nb]
        pdf = w / w.sum(-1, keepdim=True)
        cdf = torch.cumsum(pdf, -1)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
        u = self.u.to(dev)
        inds = (cdf[..., None, :] <= u[:, None]).sum(-1)        # [B, P, R, nf]
        below = torch.clamp(inds - 1, min=0)
        above = torch.clamp(inds, max=nb)
        bins = torch.tensor(list(range(nb, 0, -1)) + [0], device=dev)
        centers = torch.tensor([b / nb for b in range(1, nb + 1)],
                               dtype=torch.float32, device=dev)
        c_above = centers[bins[above].clamp(0, nb - 1)]
        hi = c_above + self.sa_radius
        lo = c_above - self.sa_radius
        cdf_b = torch.gather(cdf, -1, below)
        cdf_a = torch.gather(cdf, -1, above)
        denom = cdf_a - cdf_b
        denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
        t = (u - cdf_b) / denom
        return (hi - t * (hi - lo)).transpose(-1, -2)

    def fine_positions(self, centers, scale_pred, fine_frac):
        rel = self._ray_vectors(scale_pred)[:, :, None] * \
            (self.scale_ratio * fine_frac)[..., None]           # [B,P,nf,R,3]
        return centers[:, :, None, None, :] + rel

    def _zero_query_sa(self, P, S, ctx, path, pos, tgt_xyz, tgt_feats,
                       tgt_valid, radius, nsample):
        """ZeroQueryAndGroup, one conv block and a max-pool; zero where the
        ball found nothing.  pos [B, M, 3] -> ([B, M, half], found)."""
        grouped, _, found = pn2.query_and_group(
            radius, nsample, tgt_xyz, tgt_valid, pos, _ones(pos),
            feats=tgt_feats, use_xyz=True, zero_query=True)
        h = grouped @ P[f"{path}.mlps.0.0.conv.weight"]
        m = found[..., None].expand(h.shape[:-1])
        h = relu(bn_rows(P, S, ctx, f"{path}.mlps.0.0.bn", h, m))
        out = torch.where(found[..., None], h.amax(-2),
                          torch.zeros((), dtype=h.dtype, device=h.device))
        return out, found

    def _branch(self, P, S, ctx, pre, name, positions, tgt_xyz, tgt_feats,
                tgt_valid, agg_feats, radius, nsample):
        """One grouping branch: zero-query SA, intersection classifier,
        gating, bin and ray reduction.  positions [B, P, nb, R, 3].
        Returns (ray_feats [B, P, h], scores [B, P, nb*R, 2], gated hits
        [B, P, nb, R], ball found [B, P, nb, R])."""
        B, Pn, nb, R, _ = positions.shape
        half = self.half
        feats, found = self._zero_query_sa(
            P, S, ctx, f"{pre}.{name}_seed_aggregation",
            positions.reshape(B, -1, 3), tgt_xyz, tgt_feats, tgt_valid,
            radius, nsample)                               # [B, PnR, half]
        agg_rep = agg_feats[:, :, None, :].expand(
            B, Pn, nb * R, agg_feats.shape[-1]).reshape(B, Pn * nb * R, -1)
        scores = _apply_mlp(P, S, ctx, f"{pre}.{name}_intersection_module",
                            torch.cat([agg_rep, feats], -1), None, 2)
        mask = scores.argmax(-1)
        gated = torch.where(mask[..., None] == 1, feats,
                            torch.zeros((), dtype=feats.dtype,
                                        device=feats.device))
        # bin reduce: channels in (c, bin) order, as the reference reshapes
        v = gated.reshape(B, Pn, nb, R, half).permute(0, 1, 3, 4, 2) \
            .reshape(B, Pn * R, half * nb)
        v = _apply_mlp(P, S, ctx, f"{pre}.{name}_bin_reduce_dim", v, None, 1)
        # ray reduce: channels in (c, ray) order
        v = v.reshape(B, Pn, R, half).transpose(2, 3).reshape(B, Pn,
                                                              half * R)
        v = _apply_mlp(P, S, ctx, f"{pre}.{name}_ray_reduce_dim", v, None, 2)
        return (v, scores.reshape(B, Pn, nb * R, 2),
                mask.reshape(B, Pn, nb, R).to(v.dtype),
                found.reshape(B, Pn, nb, R))

    def __call__(self, P, S, ctx, pre, seed_xyz, seed_feats, seed_valid,
                 scale_pred, centers, points, points_valid, agg_feats):
        """Returns (pooled [B, P, h], fine_scores [B, P, nf*R, 2],
        coarse_scores [B, P, nb*R, 2], fps_idx [B, T])."""
        # FPS subsample of the raw scene, seed features interpolated on it
        t_idx = pn2.farthest_point_sample(points, points_valid,
                                          self.fps_num_sample)
        tgt_xyz = pn2.gather_rows(points, t_idx)
        tgt_valid = pn2.gather1(points_valid, t_idx)
        dist, idx3 = pn2.three_nn(tgt_xyz, tgt_valid, seed_xyz, seed_valid)
        interp = _apply_mlp(P, S, ctx, f"{pre}.seed_feat_reduce",
                            pn2.three_interpolate(seed_feats, idx3, dist),
                            tgt_valid, 2)                        # [B, T, 64]

        coarse_pos = self.coarse_positions(centers, scale_pred)
        coarse_feats, coarse_scores, coarse_hits, data_hits = self._branch(
            P, S, ctx, pre, "coarse", coarse_pos, tgt_xyz, interp,
            tgt_valid, agg_feats, self.sa_radius, self.sa_num_sample)
        # fine bins resampled from the data hits gated by the classifier;
        # the data hits (a valid subsample point within SA_RADIUS) are the
        # coarse ball query's ``found``: the same test on the same points
        gated_hits = data_hits.to(coarse_hits.dtype) * coarse_hits
        fine_pos = self.fine_positions(centers, scale_pred,
                                       self.fine_fractions(gated_hits))
        fine_feats, fine_scores, _, _ = self._branch(
            P, S, ctx, pre, "fine", fine_pos, tgt_xyz, interp, tgt_valid,
            agg_feats, self.fine_sa_radius, self.fine_sa_num_sample)
        pooled = _apply_mlp(P, S, ctx, f"{pre}.fuse_layer",
                            torch.cat([fine_feats, coarse_feats], -1), None,
                            2)
        return pooled, fine_scores, coarse_scores, t_idx


class RBGHead(nn.Module):
    """Parameters under the JAX package's names below ``point_head``
    (``voter`` and ``aggregator`` are the JAX head's ``vote_module`` and
    ``vote_aggregation``, whose names the parameters' submodules take)."""

    def __init__(self, model_cfg, num_class: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = model_cfg
        self.num_classes = int(c.get("NUM_CLASSES", num_class))
        self.ray_num = int(c.RAY_NUM)
        self.num_proposal = int(c.VOTE_AGGREGATION_CFG.NUM_POINTS)
        self.gt_per_seed = int(c.VOTE_MODULE_CFG.GT_PER_SEED)
        self.fps_num_sample = int(c.FPS_NUM_SAMPLE)
        self.threshold = float(c.THRESHOLD)
        self.sample_bin_num = int(c.SAMPLE_BIN_NUM)
        self.fine_threshold = float(c.FINE_THRESHOLD)
        self.fine_sample_bin_num = int(c.FINE_SAMPLE_BIN_NUM)
        self.num_dir_bins = int(c.BOX_CODER.NUM_DIR_BINS)
        self.with_rot = bool(c.BOX_CODER.WITH_ROT)
        self.coder = RBGBBoxCoder(self.ray_num, self.num_dir_bins,
                                  int(c.BOX_CODER.NUM_SIZE), self.with_rot)
        self.voter = VoteModule(c.VOTE_MODULE_CFG)
        self.rbg = RayBasedGrouping(c.RAY_BASED_GROUP)
        self.lw = dict(c.LOSS_CONFIG.LOSS_WEIGHTS)
        self.train_cfg = c.TRAIN
        self.test_cfg = c.TEST
        agg = c.VOTE_AGGREGATION_CFG
        self.aggregator = SAModule(
            int(agg.NUM_POINTS), float(agg.RADIUS), int(agg.NUM_SAMPLE),
            list(agg.MLP_CHANNELS), use_xyz=bool(agg.get("USE_XYZ", True)))
        self.pred_in = int(c.PRED_LAYER_CFG.IN_CHANNELS)
        self.pred_shared = list(c.PRED_LAYER_CFG.SHARED_CONV_CHANNELS)
        gen = generator or torch.Generator().manual_seed(0)
        P, S = {}, {}
        self.voter.init(P, S, gen, "vote_module")
        self.aggregator.init(P, S, gen, "vote_aggregation")
        _init_mlp(P, S, gen, "scale_prediction",
                  [self.pred_in] + self.pred_shared)
        init_linear(P, gen, "scale_prediction.mlp.conv_scale",
                    self.pred_shared[-1], 1, bias=True, init="uniform")
        _init_mlp(P, S, gen, "fuse_feat", [2 * self.pred_in, self.pred_in])
        self.rbg.init(P, S, gen, "raybasedgrouping")
        _init_mlp(P, S, gen, "share_pred", [self.pred_in] + self.pred_shared)
        init_linear(P, gen, "conv_cls", self.pred_shared[-1],
                    self.num_classes + 2, bias=True, init="uniform")
        init_linear(P, gen, "conv_reg", self.pred_shared[-1],
                    3 + self.num_dir_bins * 2 + 3, bias=True, init="uniform")
        register_flat(self, P, S)

    # ------------------------------------------------------------------
    def forward(self, P, S, ctx: Ctx, bb: Dict,
                prefix: str = "point_head") -> Dict:
        """bb: the backbone's outputs.  Returns the head's outputs, each
        with a leading scene axis."""
        pre = prefix
        seed_xyz, seed_feats = bb["fp_xyz"], bb["fp_features"]
        seed_valid = bb["fp_valid"]
        vote_xyz, vote_feats, vote_offset, vote_valid = self.voter(
            P, S, ctx, seed_xyz, seed_feats, seed_valid,
            prefix=f"{pre}.vote_module")
        # aggregation: 'vote' = FPS on the votes; 'seed' = FPS on the seeds,
        # centers their votes (one vote a seed: the same indices)
        mode = str(self.train_cfg.SAMPLE_MODE if ctx.train
                   else self.test_cfg.SAMPLE_MODE)
        idx = pn2.farthest_point_sample(seed_xyz, seed_valid,
                                        self.num_proposal) \
            if mode == "seed" else None
        agg_xyz, agg_feats, _, _ = self.aggregator(
            P, S, ctx, f"{pre}.vote_aggregation", vote_xyz, vote_feats,
            vote_valid, sample_idx=idx)

        h = _apply_mlp(P, S, ctx, f"{pre}.scale_prediction", agg_feats, None,
                       len(self.pred_shared))
        scale_res_norm = h @ P[f"{pre}.scale_prediction.mlp.conv_scale."
                               "weight"] + \
            P[f"{pre}.scale_prediction.mlp.conv_scale.bias"]
        scale_pred = torch.exp(scale_res_norm)[..., 0]           # [B, P]

        pooled, fine_scores, coarse_scores, fps_idx = self.rbg(
            P, S, ctx, f"{pre}.raybasedgrouping", seed_xyz, seed_feats,
            seed_valid, scale_pred, agg_xyz, bb["points_cat"],
            bb["points_valid"], agg_feats)

        fused = _apply_mlp(P, S, ctx, f"{pre}.fuse_feat",
                           torch.cat([agg_feats, pooled], -1), None, 1)
        ph = _apply_mlp(P, S, ctx, f"{pre}.share_pred", fused, None,
                        len(self.pred_shared))
        cls_pred = ph @ P[f"{pre}.conv_cls.weight"] + P[f"{pre}.conv_cls.bias"]
        reg_pred = ph @ P[f"{pre}.conv_reg.weight"] + P[f"{pre}.conv_reg.bias"]
        nb = self.num_dir_bins
        return dict(
            seed_points=seed_xyz, seed_valid=seed_valid,
            vote_points=vote_xyz, vote_offset=vote_offset,
            aggregated_points=agg_xyz,
            scale_res_norm=scale_res_norm[..., 0], scale_pred=scale_pred,
            center=agg_xyz + reg_pred[..., 0:3],
            dir_class=reg_pred[..., 3:3 + nb],
            dir_res_norm=reg_pred[..., 3 + nb:3 + 2 * nb],
            size_res_norm=reg_pred[..., 3 + 2 * nb:6 + 2 * nb],
            obj_scores=cls_pred[..., :2], sem_scores=cls_pred[..., 2:],
            fine_intersec_score=fine_scores,
            coarse_intersec_score=coarse_scores,
            ray_fps_idx=fps_idx)

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    def generate_predicted_boxes(self, out: Dict, points, points_valid,
                                 max_out: int = 0):
        """Decode boxes, drop those holding at most 5 points, aligned 3D
        NMS, per-class proposals.  Returns (boxes [B, M, 7], scores
        [B, M], labels i32[B, M], valid [B, M]); M = min(max_out, K * P)
        with PER_CLASS_PROPOSAL, else P."""
        B, Pn = out["center"].shape[:2]
        K = self.num_classes
        dev = out["center"].device
        obj = torch.softmax(out["obj_scores"], -1)[..., 1]
        sem = torch.softmax(out["sem_scores"], -1)
        size = torch.exp(out["size_res_norm"])
        yaw = self.coder.decode_dir(out["dir_class"], out["dir_res_norm"]) \
            if self.with_rot else torch.zeros(B, Pn, device=dev)
        boxes = torch.cat([out["center"], size, yaw[..., None]], -1)

        ones = torch.ones(Pn, dtype=torch.bool, device=dev)
        counts = torch.zeros(B, Pn, dtype=torch.int64, device=dev)
        for b in range(B):
            for s in range(0, points.shape[1], INSIDE_CHUNK):
                counts[b] += find_points_in_boxes(
                    points[b, s:s + INSIDE_CHUNK],
                    points_valid[b, s:s + INSIDE_CHUNK], boxes[b], ones).sum(0)
        nonempty = counts > 5

        # axis-aligned bound of the (possibly rotated) box
        c, s = torch.abs(torch.cos(yaw)), torch.abs(torch.sin(yaw))
        ex = (c * size[..., 0] + s * size[..., 1]) / 2
        ey = (s * size[..., 0] + c * size[..., 1]) / 2
        half_z = size[..., 2] / 2
        corners = torch.stack([boxes[..., 0] - ex, boxes[..., 1] - ey,
                               boxes[..., 2] - half_z, boxes[..., 0] + ex,
                               boxes[..., 1] + ey, boxes[..., 2] + half_z], -1)
        cls_id = sem.argmax(-1).to(torch.int32)
        keep = aligned_3d_nms(corners, obj, cls_id, nonempty,
                              float(self.test_cfg.NMS_THR))
        selected = keep & (obj > float(self.test_cfg.SCORE_THR))

        if not bool(self.test_cfg.get("PER_CLASS_PROPOSAL", True)):
            return boxes, obj, cls_id, selected
        boxes_t = boxes.repeat(1, K, 1)
        scores_t = (obj[:, None, :] * sem.transpose(1, 2)).reshape(B, K * Pn)
        labels_t = torch.arange(K, dtype=torch.int32, device=dev) \
            .repeat_interleave(Pn).expand(B, -1)
        valid_t = selected.repeat(1, K)
        if max_out and max_out < K * Pn:
            srt = torch.where(valid_t, scores_t, torch.full_like(scores_t,
                                                                 -1.0))
            _, ids = topk_stable(srt, max_out)
            return (torch.gather(boxes_t, 1, ids[..., None].expand(-1, -1, 7)),
                    torch.gather(scores_t, 1, ids),
                    torch.gather(labels_t, 1, ids),
                    torch.gather(valid_t, 1, ids))
        return boxes_t, scores_t, labels_t, valid_t

    # ------------------------------------------------------------------
    # targets and loss
    # ------------------------------------------------------------------
    def _targets_single(self, out, points, points_valid, sem_mask, ins_mask,
                        gt_boxes, gt_labels, gt_valid, ins_cap: int):
        """One scene's targets (``out`` sliced to the scene); gt_boxes
        [G, 7] in the mmdet3d convention."""
        Pn = self.num_proposal
        N = points.shape[0]
        dev = points.device
        centers_gt = gt_boxes[:, :3]
        agg = out["aggregated_points"]
        zero = torch.zeros((), device=dev)

        if self.with_rot:
            # vote targets: the centers of the first gt_per_seed boxes
            # holding each point (later slots repeat the first)
            inside = find_points_in_boxes(points, points_valid, gt_boxes,
                                          gt_valid)              # [N, G]
            rank = torch.cumsum(inside.to(torch.int32), 1)
            votes, first = [], None
            for j in range(self.gt_per_seed):
                sel_j = inside & (rank == j + 1)
                vj = centers_gt[sel_j.to(torch.uint8).argmax(1)] - points
                has_j = sel_j.any(1)[:, None]
                if j == 0:
                    first = vj
                    votes.append(torch.where(has_j, vj, zero))
                else:
                    votes.append(torch.where(has_j, vj, first))
            vote_t = torch.cat(votes, -1)
            vote_m = inside.any(1) & points_valid
            pt_ins = torch.where(inside.any(1),
                                 inside.to(torch.uint8).argmax(1),
                                 torch.full((N,), -1, device=dev))
        else:
            # vote targets: the center of each point's instance box
            ins = ins_mask.long().clamp(0, ins_cap - 1)
            ins_ok = points_valid & (ins_mask >= 0) & (ins_mask < ins_cap) \
                & (sem_mask < self.num_classes)
            seg = torch.where(ins_ok, ins, torch.full_like(ins, ins_cap))
            seg3 = seg[:, None].expand(N, 3)
            big = 1e9
            def seg_reduce(fill, how):
                vals = torch.where(ins_ok[:, None], points,
                                   torch.full_like(points, fill))
                return points.new_full((ins_cap + 1, 3), fill).scatter_reduce(
                    0, seg3, vals, how)[:ins_cap]
            pmin, pmax = seg_reduce(big, "amin"), seg_reduce(-big, "amax")
            icenter = 0.5 * (pmin + pmax)
            vote_m = ins_ok
            vote_t = torch.where(vote_m[:, None], icenter[ins] - points,
                                 zero).repeat(1, self.gt_per_seed)
            # instance -> nearest GT center, for the ray targets
            d = pn2.sq_dist(points, centers_gt)
            d = torch.where(gt_valid[None, :] & ins_ok[:, None], d,
                            torch.full_like(d, big))
            pt_ins = torch.where(ins_ok, d.argmin(1),
                                 torch.full((N,), -1, device=dev))

        # proposal -> GT by nearest center
        d2 = pn2.sq_dist(agg, centers_gt)
        d2 = torch.where(gt_valid[None, :], d2, torch.full_like(d2, 1e10))
        assignment = d2.argmin(1)
        euclid = torch.sqrt(d2.amin(1) + 1e-6)
        pos_thr = float(self.train_cfg.POS_DISTANCE_THR)
        neg_thr = float(self.train_cfg.NEG_DISTANCE_THR)
        obj_mask = ((euclid < pos_thr) | (euclid > neg_thr)).float()
        a_box = gt_boxes[assignment]
        a_center = a_box[:, :3]
        a_half = a_box[:, 3:6] / 2
        canonical = agg - a_center
        if self.with_rot:
            ang = -a_box[:, 6]
            ca, sa = torch.cos(ang), torch.sin(ang)
            canonical = torch.stack(
                [canonical[:, 0] * ca - canonical[:, 1] * sa,
                 canonical[:, 0] * sa + canonical[:, 1] * ca,
                 canonical[:, 2]], -1)
        dist6 = torch.cat([a_half - canonical, a_half + canonical], -1)
        obj_t = ((euclid < pos_thr) & (dist6 >= 0.0).all(-1)).long()

        enc = self.coder.encode(gt_boxes, gt_labels)
        # ray hit targets against the instance points of the assigned GT
        # among the FPS subsample: the forward's (the same FPS call)
        t_idx = out["ray_fps_idx"]
        s_xyz, s_valid, s_ins = points[t_idx], points_valid[t_idx], \
            pt_ins[t_idx]
        scale_pred = out["scale_pred"].detach()
        rbg = self.rbg
        nb, nf, R = self.sample_bin_num, self.fine_sample_bin_num, \
            self.ray_num

        def hits(pos, n_bins, thr):
            flat = pos.reshape(1, -1, 3)
            qgrp = assignment.repeat_interleave(n_bins * R)[None]
            obj_hit = _any_within(flat, s_xyz[None],
                                  (s_valid & (s_ins >= 0))[None], thr,
                                  point_group=s_ins[None], query_group=qgrp)
            valid_hit = _any_within(flat, s_xyz[None], s_valid[None], thr)
            return obj_hit[0].reshape(Pn, n_bins * R), \
                valid_hit[0].reshape(Pn, n_bins * R)

        coarse_pos = rbg.coarse_positions(agg[None], scale_pred[None])
        coarse_t, coarse_v = hits(coarse_pos, nb, self.threshold)
        # fine positions derived as in the forward, from the data hits
        fine_frac = rbg.fine_fractions(
            coarse_v.reshape(1, Pn, nb, R).float())
        fine_t, fine_v = hits(
            rbg.fine_positions(agg[None], scale_pred[None], fine_frac), nf,
            self.fine_threshold)
        return dict(
            vote_t=vote_t, vote_m=vote_m, obj_t=obj_t, obj_mask=obj_mask,
            dir_cls_t=enc["dir_class"][assignment],
            dir_res_t=enc["dir_res"][assignment] / (np.pi / self.num_dir_bins),
            sem_t=gt_labels[assignment], size_t=enc["size"][assignment],
            scale_t=enc["scale"][assignment, 0], a_center=a_center,
            coarse_t=coarse_t.long(), coarse_v=coarse_v.long(),
            fine_t=fine_t.long(), fine_v=fine_v.long())

    def targets(self, outs: Dict, batch: Dict, ins_cap: int) -> Dict:
        """Every scene's targets, stacked [B, ...], without gradient."""
        B = batch["gt_boxes"].shape[0]
        sem_mask, ins_mask = batch.get("semantic_mask"), \
            batch.get("instance_mask")
        if sem_mask is None:
            shape = batch["points"].shape[:2]
            dev = batch["points"].device
            sem_mask = torch.full(shape, self.num_classes, dtype=torch.int32,
                                  device=dev)
            ins_mask = torch.zeros(shape, dtype=torch.int32, device=dev)
        keys = ("aggregated_points", "scale_pred", "ray_fps_idx")
        with torch.no_grad():
            per = [self._targets_single(
                {k: outs[k][b] for k in keys}, batch["points"][b],
                batch["points_valid"][b], sem_mask[b], ins_mask[b],
                batch["gt_boxes"][b], batch["gt_labels"][b],
                batch["gt_valid"][b], ins_cap) for b in range(B)]
        return {k: torch.stack([t[k] for t in per]) for k in per[0]}

    def loss(self, outs: Dict, bbs: Dict, batch: Dict, ins_cap: int = 128,
             group=None):
        """Batched loss.  outs: the head's outputs; bbs: the backbone's;
        batch: points [B, N, 3], points_valid, gt_boxes [B, G, 7],
        gt_labels, gt_valid, semantic_mask / instance_mask or None.

        Most terms are weighted sums over the batch with weights that sum
        to 1 over it; with a process ``group`` of W ranks the weights'
        normalizer is the global one and each rank's weights are scaled by
        W, so the mean of the ranks' losses (the step averages their
        gradients) is the W*B-scene loss.  The vote and sampling terms are
        means over equal-sized scenes, which that average already makes
        global."""
        gt_boxes, gt_valid = batch["gt_boxes"], batch["gt_valid"]
        sem_mask = batch.get("semantic_mask")
        tg = self.targets(outs, batch, ins_cap)
        lw = self.lw
        eps = 1e-6
        ranks = float(group_size(group))

        def batch_weights(w):
            return w * ranks / (global_sum(w.sum(), group) + eps)

        obj_t = tg["obj_t"]
        obj_w = batch_weights(tg["obj_mask"])
        box_w = batch_weights(obj_t.float())

        # vote loss: targets on raw points, gathered at the seed indices
        idx = bbs["fp_indices"]
        vote_loss = self.voter.get_loss(
            outs["seed_points"], outs["vote_points"], outs["seed_valid"],
            pn2.gather1(tg["vote_m"], idx),
            pn2.gather_rows(tg["vote_t"], idx)).mean()

        obj_loss = (L.cross_entropy_with_logits(
            outs["obj_scores"], obj_t, class_weight=[0.2, 0.8]) * obj_w).sum()

        # center chamfer, both directions, x10 each
        s2t, t2s = chamfer_distance(
            outs["center"], torch.ones_like(obj_t, dtype=torch.bool),
            gt_boxes[..., :3], gt_valid)
        gt_w = batch_weights(gt_valid.float())
        center_loss = 10.0 * (s2t * box_w).sum() + 10.0 * (t2s * gt_w).sum()

        dir_cls_loss = (L.cross_entropy_with_logits(
            outs["dir_class"], tg["dir_cls_t"]) * box_w).sum()
        onehot = F.one_hot(tg["dir_cls_t"].long(), self.num_dir_bins).float()
        dir_res_pred = (outs["dir_res_norm"] * onehot).sum(-1)
        dir_res_loss = (L.smooth_l1(dir_res_pred, tg["dir_res_t"],
                                    beta=1.0 / 25.0, reduction="none")
                        * box_w).sum()

        # size / scale: smooth-l1 on the exp'd residuals, beta 1/16
        size_pred = torch.exp(outs["size_res_norm"])
        size_loss = (L.smooth_l1(size_pred, tg["size_t"], beta=1.0 / 16.0,
                                 reduction="none") * box_w[..., None]).sum()
        scale_loss = (L.smooth_l1(torch.exp(outs["scale_res_norm"]),
                                  tg["scale_t"], beta=1.0 / 16.0,
                                  reduction="none") * box_w).sum()
        sem_loss = (L.cross_entropy_with_logits(
            outs["sem_scores"], tg["sem_t"]) * box_w).sum()

        def intersec(scores, t, v):
            w = batch_weights((obj_t[..., None] * v).float())
            return (L.cross_entropy_with_logits(
                scores, t, class_weight=[0.5, 0.5]) * w).sum()
        fine_il = intersec(outs["fine_intersec_score"], tg["fine_t"],
                           tg["fine_v"])
        coarse_il = intersec(outs["coarse_intersec_score"], tg["coarse_t"],
                             tg["coarse_v"])

        # IoU loss on axis-aligned corners
        c_pred = torch.cat([outs["center"] - size_pred / 2,
                            outs["center"] + size_pred / 2], -1)
        c_tgt = torch.cat([tg["a_center"] - tg["size_t"] / 2,
                           tg["a_center"] + tg["size_t"] / 2], -1)
        iou_loss = L.axis_aligned_iou_loss(c_pred, c_tgt, weight=box_w)

        # foreground sample losses of the FBS levels: a plain mean over
        # each level's points and the scenes
        if sem_mask is None:
            fg = torch.zeros(batch["points"].shape[:2], dtype=torch.int64,
                             device=obj_t.device)
        else:
            fg = (sem_mask < self.num_classes).long()
        sample_losses = []
        for score, sidx in bbs["sa_scores"]:
            w = torch.ones(sidx.shape[-1], device=score.device)
            w = w / w.sum()
            sample_losses.append((L.cross_entropy_with_logits(
                score, pn2.gather1(fg, sidx), class_weight=[0.2, 0.8])
                * w).sum(-1).mean())

        total = (vote_loss
                 + lw["scale_loss_weight"] * scale_loss
                 + lw["obj_loss_weight"] * obj_loss
                 + sem_loss + center_loss
                 + lw["dir_class_loss_weight"] * dir_cls_loss
                 + lw["dir_res_loss_weight"] * dir_res_loss
                 + lw["size_loss_weight"] * size_loss
                 + lw["intersection_loss_weight"] * (fine_il + coarse_il)
                 + lw["iou_loss_weight"] * iou_loss)
        tb = dict(vote_loss=vote_loss, scale_res_loss=scale_loss,
                  objectness_loss=obj_loss, semantic_loss=sem_loss,
                  center_loss=center_loss, dir_class_loss=dir_cls_loss,
                  dir_res_loss=dir_res_loss, size_res_loss=size_loss,
                  fine_intersec_loss=fine_il, coarse_intersec_loss=coarse_il,
                  iou_loss=iou_loss)
        for i, sl in enumerate(sample_losses):
            total = total + lw["sample_loss_weight"] * sl
            tb[f"sample_loss_{i}"] = sl
        tb["loss_all"] = total
        return total, tb
