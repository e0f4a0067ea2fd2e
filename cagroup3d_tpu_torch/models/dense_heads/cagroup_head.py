"""CAGroup3D one-stage head: semantic + vote + class-aware grouping, and
its training loss.

Counterpart of ``cagroup3d_tpu/models/dense_heads/cagroup_head.py``: the
axis-aligned ScanNet head and the SUN RGB-D yaw head (``WITH_YAW``: three
votes per voxel, each with its own 64 features, heading boxes in the
fcaf3d parametrization, rotated NMS and IoU loss, 3-vote targets from the
containing GT boxes).  The class axis is a tensor axis: the
per-class fine and expand maps are built together from one sort (kernel K2
inside ``unique_voxels_classes_paired`` in eval, the differentiable
``index_add_`` path in training), the per-class k9 / k5 convs are one
grouped K1 launch each, and the generative k3s3 up-conv, the 1x1 fuse and
the shared prediction heads run batched over [n_cls, CAP, ...].
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...core.module import (Ctx, Params, apply_bn, init_bn, init_conv,
                            me_default_conv, normal_conv, register_flat)
from ...core.nms import multiclass_nms, topk_stable
from ...core.norm import elu
from ...core.sparse import SparseTensor, zero_invalid
from ...core.sparse_conv import (generative_up_classes,
                                 scan_conv_grouped_classes)
from ...core.voxelize import unique_voxels_classes_paired
from ..layers import act, bn, subm
from ...utils import loss_utils as L
from ...utils.commu_utils import global_mean
from ..model_utils.cagroup_utils import bias_init_with_prob
from .target_assigner.cagroup3d_assigner import (CAGroup3DAssigner,
                                                 find_points_in_boxes)

# Per-class anisotropic voxel sizes (reference cagroup_head.py:75-106).
SCANNET_VOXELS = [
    [0.2309, 0.2435, 0.2777], [0.5631, 0.5528, 0.3579],
    [0.1840, 0.1845, 0.2155], [0.4187, 0.4536, 0.2503],
    [0.2938, 0.3203, 0.1899], [0.1595, 0.1787, 0.5250],
    [0.2887, 0.2174, 0.3445], [0.2497, 0.3147, 0.5063],
    [0.0634, 0.1262, 0.1612], [0.4332, 0.5691, 0.0810],
    [0.3088, 0.4212, 0.2627], [0.4130, 0.1966, 0.5044],
    [0.1995, 0.2133, 0.3897], [0.1260, 0.1137, 0.5254],
    [0.1781, 0.1774, 0.2218], [0.1526, 0.1520, 0.0904],
    [0.3453, 0.3164, 0.1491], [0.1426, 0.1477, 0.1741]]
SUNRGBD_VOXELS = [
    [0.6343, 0.4861, 0.2782], [0.2373, 0.3839, 0.2155],
    [0.2771, 0.5602, 0.2536], [0.1776, 0.1659, 0.2482],
    [0.2097, 0.1363, 0.2269], [0.2086, 0.4039, 0.2209],
    [0.1586, 0.3008, 0.3519], [0.1502, 0.1896, 0.2050],
    [0.1214, 0.3213, 0.5067], [0.2298, 0.4195, 0.1418]]


def _bn_elu(P, S, ctx: Ctx, path: str, x, mask):
    """Per-class batch norm (each class its own statistics) and ELU over
    stacked [n_cls, N, C] maps; invalid rows zero."""
    return zero_invalid(elu(apply_bn(P, S, ctx, path, x, mask)), mask)


class CAGroup3DHead(nn.Module):
    def __init__(self, model_cfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = model_cfg
        if c.EXPAND_RATIO != 3:
            raise NotImplementedError("the generative up-conv is ported for "
                                      "EXPAND_RATIO 3 (both datasets' YAMLs)")
        self.n_classes = c.N_CLASSES
        self.out_channels = c.OUT_CHANNELS
        self.n_reg_outs = c.N_REG_OUTS
        self.voxel_size = c.VOXEL_SIZE
        self.expand = c.EXPAND_RATIO
        self.cls_kernel = c.CLS_KERNEL
        self.with_yaw = bool(c.WITH_YAW)
        self.gt_per_seed = 3 if self.with_yaw else 1     # votes per voxel
        self.nms_cfg = c.get("NMS_CONFIG", None)
        if self.n_classes == 18:
            vox = SCANNET_VOXELS
        elif self.n_classes == 10:
            vox = SUNRGBD_VOXELS
        else:   # other class counts (tests): the ScanNet table, cycled
            vox = [SCANNET_VOXELS[i % len(SCANNET_VOXELS)]
                   for i in range(self.n_classes)]
        self.voxel_size_list = np.clip(np.array(vox) / 2.0, 0.04, 1.0)
        self.fine_cap = int(c.get("FINE_CAP", 4096))
        self.expand_cap = int(c.get("EXPAND_CAP", 2048))
        self.max_rois = int(c.get("MAX_ROIS", 256))
        self.nms_per_cls_cap = int(c.get("NMS_PER_CLS_CAP", 256))
        self.assigner = CAGroup3DAssigner(c.ASSIGNER)
        self.loss_cfg = c
        P, S = self._init(generator or torch.Generator().manual_seed(0))
        register_flat(self, P, S)

    def _init(self, gen: torch.Generator):
        P: Params = {}
        S: Params = {}
        C, n_cls = self.out_channels, self.n_classes
        init_conv(P, gen, "offset_block.0", 1, C, C)
        init_bn(P, S, "offset_block.1", C)
        init_conv(P, gen, "offset_block.3", 1, C, C)
        init_bn(P, S, "offset_block.4", C)
        init_conv(P, gen, "offset_block.6", 1, C, 3 * self.gt_per_seed)
        init_conv(P, gen, "feature_offset.0", 3, C, C * self.gt_per_seed)
        init_bn(P, S, "feature_offset.1", C * self.gt_per_seed)
        P["semantic_conv.kernel"] = normal_conv(gen, 1, C, n_cls)
        P["semantic_conv.bias"] = torch.full((n_cls,),
                                             bias_init_with_prob(0.01))
        P["centerness_conv.kernel"] = normal_conv(gen, 1, C, 1)
        P["reg_conv.kernel"] = normal_conv(gen, 1, C, self.n_reg_outs)
        P["cls_conv.kernel"] = normal_conv(gen, 1, C, n_cls)
        P["cls_conv.bias"] = torch.full((n_cls,), bias_init_with_prob(0.01))
        P["scales.scale"] = torch.ones(n_cls)
        k3 = self.cls_kernel ** 3
        P["cls_individual_out.0.kernel"] = torch.stack(
            [normal_conv(gen, k3, C, C) for _ in range(n_cls)])
        P["cls_individual_expand_out.0.kernel"] = torch.stack(
            [me_default_conv(gen, 125, C, C) for _ in range(n_cls)])
        P["cls_individual_up.0.kernel"] = torch.stack(
            [me_default_conv(gen, 27, C, C) for _ in range(n_cls)])
        P["cls_individual_fuse.0.kernel"] = torch.stack(
            [me_default_conv(gen, 1, 2 * C, C) for _ in range(n_cls)])
        for name in ["cls_individual_out.1", "cls_individual_expand_out.1",
                     "cls_individual_up.1.0", "cls_individual_fuse.1"]:
            P[f"{name}.weight"] = torch.ones(n_cls, C)
            P[f"{name}.bias"] = torch.zeros(n_cls, C)
            S[f"{name}.running_mean"] = torch.zeros(n_cls, C)
            S[f"{name}.running_var"] = torch.ones(n_cls, C)
        return P, S

    # ------------------------------------------------------------------
    def forward(self, P: Params, S: Params, ctx: Ctx, st: SparseTensor,
                semantic_threshold: float, prefix: str = "dense_head",
                stop_after: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """st: backbone output (stride 2), one scene.  ``stop_after``
        cuts as in the JAX package: "sem_offsets" | "maps" | "cls_convs" |
        "up_fuse" return partial dicts.  In training (``ctx.train``) BN
        takes batch statistics and the class maps keep the cyclic
        ``ctx.drop_offset`` window; the votes move the points without
        carrying a gradient back into the offsets (the vote loss trains
        them)."""
        pre, v = prefix, self.voxel_size
        N2 = st.cap
        dev = st.feats.device

        sem = subm(P, ctx, pre + ".semantic_conv", st, 1).feats   # [N2, n_cls]
        x = act(bn(P, S, ctx, pre + ".offset_block.1",
                   subm(P, ctx, pre + ".offset_block.0", st, 1)), "elu")
        x = act(bn(P, S, ctx, pre + ".offset_block.4",
                   subm(P, ctx, pre + ".offset_block.3", x, 1)), "elu")
        voxel_offsets = subm(P, ctx, pre + ".offset_block.6", x, 1).feats
        offset_feats = act(bn(P, S, ctx, pre + ".feature_offset.1",
                              subm(P, ctx, pre + ".feature_offset.0", st, 3)),
                           "elu").feats

        # scene bounds (reference cagroup_head.py:209-211)
        coords = st.coords.to(torch.float32)
        big = torch.tensor(1e9, device=dev)
        cvalid = st.valid[:, None]
        cmax = torch.where(cvalid, coords, -big).amax(0)
        cmin = torch.where(cvalid, coords, big).amin(0)
        max_bound = (cmax + st.stride) * v
        min_bound = (cmin - st.stride) * v
        pts_metric = coords * v                                       # [N2, 3]
        nv, C = self.gt_per_seed, self.out_channels
        voted = torch.clamp(
            pts_metric[:, None, :] +
            voxel_offsets.detach().reshape(N2, nv, 3),
            min_bound, max_bound)                                   # [N2, nv, 3]

        # class selection, plus the first valid voxel so no class map is empty
        sel = torch.sigmoid(sem) > semantic_threshold              # [N2, n_cls]
        sel[torch.argmax(st.valid.to(torch.int32))] = True
        sel = sel & st.valid[:, None]

        # the fused per-class point set: every vote (with its own slice of
        # the offset features), then the voxels themselves
        pts_all = torch.cat([voted.reshape(N2 * nv, 3), pts_metric], dim=0)
        feats_all = torch.cat([offset_feats.reshape(N2 * nv, C), st.feats],
                              dim=0)
        sel_all = torch.cat([sel.repeat_interleave(nv, dim=0), sel],
                            dim=0)                          # [(nv+1)N2, n_cls]
        if stop_after == "sem_offsets":
            return dict(semantic_scores=sem, voxel_offsets=voxel_offsets,
                        offset_feats=offset_feats, voted=voted, sel=sel)

        vox_sizes = torch.as_tensor(self.voxel_size_list, dtype=torch.float32,
                                    device=dev)
        lat_f = torch.floor(pts_all[None] / vox_sizes[:, None, :]).to(
            torch.int32)
        (fc, ff, fv), (cc, cf, cv), (of_f, of_c) = \
            unique_voxels_classes_paired(lat_f, feats_all, sel_all.T.contiguous(),
                                         self.fine_cap, self.expand_cap,
                                         self.expand, train=ctx.train,
                                         drop_offset=ctx.drop_offset)
        ctx.stats["overflow/head_fine"] = of_f.sum()
        ctx.stats["overflow/head_expand"] = of_c.sum()
        if stop_after == "maps":
            return dict(semantic_scores=sem, fine_feats=ff, coarse_feats=cf,
                        fine_valid=fv, coarse_valid=cv)

        f_out = scan_conv_grouped_classes(
            fc, fv, ff, 1, self.cls_kernel,
            P[pre + ".cls_individual_out.0.kernel"])
        f_out = _bn_elu(P, S, ctx, pre + ".cls_individual_out.1", f_out, fv)
        e_out = scan_conv_grouped_classes(
            cc, cv, cf, 1, 5, P[pre + ".cls_individual_expand_out.0.kernel"])
        e_out = _bn_elu(P, S, ctx, pre + ".cls_individual_expand_out.1", e_out, cv)
        if stop_after == "cls_convs":
            return dict(semantic_scores=sem, f_out=f_out, e_out=e_out)

        # generative transpose k3 s3 decoded at the fine coords
        up_out = generative_up_classes(
            cc * self.expand, cv, e_out, self.expand, fc, fv,
            P[pre + ".cls_individual_up.0.kernel"])
        up_out = _bn_elu(P, S, ctx, pre + ".cls_individual_up.1.0", up_out, fv)
        fused = torch.cat([up_out, f_out], dim=-1)
        w_fuse = P[pre + ".cls_individual_fuse.0.kernel"][:, 0]  # [n_cls, 2C, C]
        fused = torch.bmm(fused, w_fuse)
        fused = _bn_elu(P, S, ctx, pre + ".cls_individual_fuse.1", fused, fv)
        if stop_after == "up_fuse":
            return dict(semantic_scores=sem, fused=fused)

        centerness = fused @ P[pre + ".centerness_conv.kernel"][0]
        reg = fused @ P[pre + ".reg_conv.kernel"][0]
        cls_score = fused @ P[pre + ".cls_conv.kernel"][0] + \
            P[pre + ".cls_conv.bias"]
        scales = P[pre + ".scales.scale"][:, None, None]
        reg_dist = torch.exp(torch.clamp(reg[..., :6] * scales, -10.0, 10.0))
        bbox_pred = torch.cat([reg_dist, reg[..., 6:]], dim=-1)
        points = fc.to(torch.float32) * vox_sizes[:, None, :]
        return dict(semantic_scores=sem, semantic_valid=st.valid,
                    semantic_points=pts_metric, voxel_offsets=voxel_offsets,
                    centernesses=centerness, bbox_preds=bbox_pred,
                    cls_scores=cls_score, points=points, points_valid=fv)

    # ------------------------------------------------------------------
    @staticmethod
    def bbox_pred_to_bbox(points, bbox_pred):
        """Boxes from distances to the six faces: axis-aligned [..., 6], or
        with the two yaw channels of the yaw head [..., 7] in the fcaf3d
        parametrization (sin 2a ln q, cos 2a ln q: heading a, BEV size
        ratio q)."""
        x = points[..., 0] + (bbox_pred[..., 1] - bbox_pred[..., 0]) / 2
        y = points[..., 1] + (bbox_pred[..., 3] - bbox_pred[..., 2]) / 2
        z = points[..., 2] + (bbox_pred[..., 5] - bbox_pred[..., 4]) / 2
        if bbox_pred.shape[-1] == 6:
            return torch.stack([x, y, z,
                                bbox_pred[..., 0] + bbox_pred[..., 1],
                                bbox_pred[..., 2] + bbox_pred[..., 3],
                                bbox_pred[..., 4] + bbox_pred[..., 5]], dim=-1)
        # exactly-zero (padded) rows: sqrt and atan2 at (0, 0) give NaN
        # cotangents even under a zero loss weight
        s6, c7 = bbox_pred[..., 6], bbox_pred[..., 7]
        c7 = torch.where((s6.abs() + c7.abs()) < 1e-8,
                         torch.full_like(c7, 1e-8), c7)
        scale = (bbox_pred[..., 0] + bbox_pred[..., 1] +
                 bbox_pred[..., 2] + bbox_pred[..., 3])
        q = torch.exp(torch.sqrt(s6 ** 2 + c7 ** 2 + 1e-12))
        alpha = 0.5 * torch.atan2(s6, c7)
        return torch.stack([x, y, z, scale / (1 + q), scale / (1 + q) * q,
                            bbox_pred[..., 5] + bbox_pred[..., 4], alpha],
                           dim=-1)

    def get_bboxes(self, out: Dict[str, torch.Tensor]):
        """One scene: flatten the class maps, NMS_PRE top-k, decode,
        per-class NMS.  Returns padded (boxes [R, 7], scores [R],
        labels [R], valid [R])."""
        centerness = out["centernesses"].reshape(-1, 1)
        bbox_pred = out["bbox_preds"].reshape(-1, out["bbox_preds"].shape[-1])
        cls_score = out["cls_scores"].reshape(-1, self.n_classes)
        points = out["points"].reshape(-1, 3)
        valid = out["points_valid"].reshape(-1)

        scores = torch.sigmoid(cls_score) * torch.sigmoid(centerness)
        max_scores = torch.where(valid[:, None], scores,
                                 torch.full_like(scores, -1.0)).amax(1)
        k = min(int(self.nms_cfg.NMS_PRE), scores.shape[0])
        _, ids = topk_stable(torch.where(valid, max_scores,
                                         torch.full_like(max_scores, -1e10)), k)
        boxes = self.bbox_pred_to_bbox(points[ids], bbox_pred[ids])
        if boxes.shape[-1] == 6:
            boxes = torch.cat([boxes, torch.zeros_like(boxes[..., :1])],
                              dim=-1)
        return multiclass_nms(boxes, scores[ids], valid[ids],
                              score_thr=float(self.nms_cfg.SCORE_THR),
                              iou_thr=float(self.nms_cfg.IOU_THR),
                              per_cls_cap=self.nms_per_cls_cap,
                              out_cap=self.max_rois, rotated=self.with_yaw)

    # ------------------------------------------------------------------
    # loss (reference cagroup_head.py:322-555)
    # ------------------------------------------------------------------
    def _vote_targets_scannet(self, voxel_points, voxel_valid, scene_points,
                              scene_valid, sem_mask, ins_mask, gt_boxes,
                              gt_valid, ins_cap: int):
        """Instance-centre vote targets: each stride-2 voxel votes for the
        GT centre matched to the instance of its nearest raw scene point.
        Returns (offset targets [N, 3], mask [N])."""
        dev = voxel_points.device
        big = 1e9
        ins = ins_mask.clamp(0, ins_cap - 1).long()
        ins_ok = scene_valid & (ins_mask < ins_cap) & (ins_mask >= 0)
        seg = torch.where(ins_ok, ins, torch.full_like(ins, ins_cap))
        seg3 = seg[:, None].expand(-1, 3)
        pmin = torch.full((ins_cap + 1, 3), big, device=dev).scatter_reduce(
            0, seg3, torch.where(ins_ok[:, None], scene_points,
                                 torch.full_like(scene_points, big)),
            "amin")[:ins_cap]
        pmax = torch.full((ins_cap + 1, 3), -big, device=dev).scatter_reduce(
            0, seg3, torch.where(ins_ok[:, None], scene_points,
                                 torch.full_like(scene_points, -big)),
            "amax")[:ins_cap]
        cnt = torch.zeros(ins_cap + 1, dtype=torch.int32, device=dev
                          ).index_add(0, seg, ins_ok.to(torch.int32))[:ins_cap]
        center = 0.5 * (pmin + pmax)
        # semantic of the instance: the min over its points (instances are
        # semantically uniform)
        nc1 = self.n_classes + 1
        isem = torch.full((ins_cap + 1,), nc1, dtype=torch.int32,
                          device=dev).scatter_reduce(
            0, seg, torch.where(ins_ok, sem_mask.to(torch.int32),
                                torch.full_like(sem_mask, nc1,
                                                dtype=torch.int32)),
            "amin")[:ins_cap]
        ins_valid = (cnt > 0) & (isem < self.n_classes) & gt_valid.any()
        d = ((center[:, None, :] - gt_boxes[None, :, :3]) ** 2).sum(-1)
        d = torch.where(gt_valid[None, :], d, torch.full_like(d, big))
        match = d.argmin(1)
        ins_center = torch.where(ins_valid[:, None], gt_boxes[match, :3],
                                 torch.full_like(center, -10000.0))
        nn_idx = nearest_point_index(voxel_points, voxel_valid, scene_points,
                                     scene_valid)
        vox_ins = ins_mask[nn_idx].clamp(0, ins_cap - 1).long()
        offset_t = ins_center[vox_ins] - voxel_points
        offset_m = (offset_t > -100.0).all(-1) & voxel_valid
        offset_t = torch.where(offset_t < -100.0, torch.zeros_like(offset_t),
                               offset_t)
        return offset_t, offset_m

    def _vote_targets_yaw(self, voxel_points, voxel_valid, gt_boxes,
                          gt_valid):
        """SUN RGB-D 3-vote targets: the centres of the first three GT
        boxes (in index order) that contain the voxel, as offsets; an
        unfilled slot repeats the first.  Returns (targets [N, 9], mask
        [N]: inside some box)."""
        inside = find_points_in_boxes(voxel_points, voxel_valid, gt_boxes,
                                      gt_valid)                     # [N, G]
        rank = torch.cumsum(inside.to(torch.int32), dim=1)
        votes, first = [], None
        for j in range(self.gt_per_seed):
            sel_j = inside & (rank == j + 1)
            has_j = sel_j.any(1)[:, None]
            vote_j = gt_boxes[sel_j.to(torch.uint8).argmax(1), :3] - \
                voxel_points
            if j == 0:
                first = vote_j
                votes.append(torch.where(has_j, vote_j,
                                         torch.zeros_like(vote_j)))
            else:
                votes.append(torch.where(has_j, vote_j, first))
        mask = inside.any(1) & voxel_valid
        vt = torch.cat(votes, dim=-1)
        return torch.where(mask[:, None], vt, torch.zeros_like(vt)), mask

    def loss(self, outs: Dict[str, torch.Tensor], gt_boxes, gt_labels,
             gt_valid, scene_points, scene_valid, sem_mask=None,
             ins_mask=None, ins_cap: int = 128, group=None):
        """Loss over B scenes; every input has a leading scene axis.

        outs: head outputs stacked over scenes; gt_boxes [B, G, 7] in the
        scenes' frames, gt_labels i32[B, G], gt_valid [B, G];
        scene_points [B, P, 3] raw points (same frames), sem/ins masks
        i32[B, P].  Per-scene losses are averaged over the scenes, with
        normalizers that average per-scene counts over the scenes (the
        reference's reduce_mean); with a process ``group`` the normalizers
        average over every rank's scenes, and the mean over this rank's
        scenes becomes the global one when the step averages the ranks'
        gradients.  Returns (loss, tb_dict)."""
        c = self.loss_cfg
        off_cfg = c.get("LOSS_OFFSET", None)
        beta = float(off_cfg.BETA) if off_cfg else 0.04

        def _lw(key):
            sub = c.get(key, None)
            return float(sub.get("LOSS_WEIGHT", 1.0)) if sub else 1.0

        w_vote, w_bbox, w_cls, w_sem, w_cen = (
            _lw(k) for k in ("LOSS_OFFSET", "LOSS_BBOX", "LOSS_CLS",
                             "LOSS_SEM", "LOSS_CENTERNESS"))
        B = gt_boxes.shape[0]
        if sem_mask is None:
            sem_mask = torch.zeros(scene_points.shape[:2], dtype=torch.int32,
                                   device=scene_points.device)
            ins_mask = torch.zeros_like(sem_mask)
        with torch.no_grad():
            tgts = []
            for b in range(B):
                sem_labels, _ = self.assigner.assign_semantic(
                    outs["semantic_points"][b], outs["semantic_valid"][b],
                    gt_boxes[b], gt_labels[b], gt_valid[b], self.n_classes)
                ct, bt, lab = self.assigner.assign(
                    outs["points"][b], outs["points_valid"][b], gt_boxes[b],
                    gt_labels[b], gt_valid[b])
                if self.with_yaw:
                    vt, vm = self._vote_targets_yaw(
                        outs["semantic_points"][b],
                        outs["semantic_valid"][b], gt_boxes[b], gt_valid[b])
                else:
                    vt, vm = self._vote_targets_scannet(
                        outs["semantic_points"][b],
                        outs["semantic_valid"][b], scene_points[b],
                        scene_valid[b], sem_mask[b], ins_mask[b],
                        gt_boxes[b], gt_valid[b], ins_cap)
                tgts.append((sem_labels, ct, bt, lab, vt, vm))
            sem_labels, ctgt, btgt, labels, vtgt, vmask = (
                torch.stack(t) for t in zip(*tgts))

        sem_valid = outs["semantic_valid"]                        # [B, N2]
        pts_valid = outs["points_valid"].reshape(B, -1)           # [B, M]
        pos = (labels.reshape(B, -1) >= 0) & pts_valid
        sem_n_pos = global_mean(((sem_labels >= 0) & sem_valid).sum(1)
                                .float(), group).clamp(min=1.0)
        n_pos = global_mean(pos.sum(1).float(), group).clamp(min=1.0)
        cdenorm = global_mean(torch.where(
            pos, ctgt.reshape(B, -1), torch.zeros_like(pos, dtype=ctgt.dtype)
        ).sum(1), group).clamp(min=1e-6)
        safe = torch.tensor([0, 0, 0, 1, 1, 1, 0.0], device=gt_boxes.device)
        parts = []
        for b in range(B):
            semv = sem_valid[b]
            pv = outs["points_valid"][b].reshape(-1)
            labf = labels[b].reshape(-1)
            posm = (labf >= 0) & pv
            l_sem = L.focal_loss_with_labels(
                outs["semantic_scores"][b], sem_labels[b],
                weight=semv.float(), avg_factor=sem_n_pos)
            l_cls = L.focal_loss_with_labels(
                outs["cls_scores"][b].reshape(-1, self.n_classes), labf,
                weight=pv.float(), avg_factor=n_pos)
            ctf = ctgt[b].reshape(-1)
            l_cen = L.binary_cross_entropy(
                outs["centernesses"][b].reshape(-1), ctf,
                weight=posm.float(), avg_factor=n_pos)
            bp = outs["bbox_preds"][b]
            decoded = self.bbox_pred_to_bbox(outs["points"][b].reshape(-1, 3),
                                             bp.reshape(-1, bp.shape[-1]))
            safe_dec = torch.where(posm[:, None], decoded,
                                   safe[:decoded.shape[-1]])
            safe_tgt = torch.where(posm[:, None], btgt[b].reshape(-1, 7), safe)
            l_bbox = L.iou3d_loss(safe_dec, safe_tgt,
                                  weight=torch.where(posm, ctf,
                                                     torch.zeros_like(ctf)),
                                  avg_factor=cdenorm, with_yaw=self.with_yaw)
            vo, vm = outs["voxel_offsets"][b], vmask[b].float()
            if self.with_yaw:
                # absolute vote positions, normalized by the voted voxels
                wv = (vm / (vm.sum() + 1e-6))[:, None]
                base = outs["semantic_points"][b].repeat(1, self.gt_per_seed)
                l_vote = L.smooth_l1(base + vo, base + vtgt[b],
                                     weight=wv * semv[:, None], beta=beta,
                                     reduction="sum")
            else:
                n_real = semv.float().sum().clamp(min=1.0)
                wv = (vm / n_real + 1e-6)[:, None]
                l_vote = L.smooth_l1(vo, vtgt[b], weight=wv * semv[:, None],
                                     beta=beta, reduction="sum")
            parts.append(torch.stack([w_sem * l_sem, w_cls * l_cls,
                                      w_cen * l_cen, w_bbox * l_bbox,
                                      w_vote * l_vote]))
        l_sem, l_cls, l_cen, l_bbox, l_vote = torch.stack(parts).mean(0)
        total = l_sem + l_cls + l_cen + l_bbox + l_vote
        tb = dict(loss_sem=l_sem, loss_cls=l_cls, loss_centerness=l_cen,
                  loss_bbox=l_bbox, loss_vote=l_vote, one_stage_loss=total)
        return total, tb


def nearest_point_index(queries, qvalid, points, pvalid, chunk: int = 4096):
    """argmin_j ||q_i - p_j||^2 over the valid points, ties to the lower
    index, in chunks of points to bound memory (the reference's knn op
    with k=1).  Squared distances are summed over x, y, z in that order,
    not through |a|^2 + |b|^2 - 2ab, which would move the ties."""
    best_d = torch.full((queries.shape[0],), float("inf"),
                        device=queries.device)
    best_i = torch.zeros(queries.shape[0], dtype=torch.long,
                         device=queries.device)
    for b in range(0, points.shape[0], chunk):
        d = ((queries[:, None, :] - points[None, b:b + chunk]) ** 2).sum(-1)
        d = torch.where(pvalid[None, b:b + chunk], d,
                        torch.full_like(d, float("inf")))
        cd, ci = d.amin(1), d.argmin(1)
        upd = cd < best_d
        best_d = torch.where(upd, cd, best_d)
        best_i = torch.where(upd, ci + b, best_i)
    return best_i
