"""CAGroup3D one-stage head: semantic + vote + class-aware grouping (eval).

Counterpart of ``cagroup3d_tpu/models/dense_heads/cagroup_head.py`` for
the axis-aligned (ScanNet) path.  The class axis is a tensor axis: the
per-class fine and expand maps are built together from one sort (kernel K2
inside ``unique_voxels_classes_paired``), the per-class k9 / k5 convs are
one grouped K1 launch each, and the generative k3s3 up-conv, the 1x1 fuse
and the shared prediction heads run batched over [n_cls, CAP, ...].
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...core.module import (Ctx, Params, init_bn, init_conv, me_default_conv,
                            normal_conv, register_flat)
from ...core.nms import multiclass_nms, topk_stable
from ...core.norm import elu, masked_batch_norm
from ...core.sparse import SparseTensor, zero_invalid
from ...core.sparse_conv import (generative_up_classes,
                                 scan_conv_grouped_classes)
from ...core.voxelize import unique_voxels_classes_paired
from ..layers import act, bn, subm
from ..model_utils.cagroup_utils import bias_init_with_prob

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


def _bn_elu(P, S, path: str, x, mask):
    """Per-class batch norm (each class its own statistics) and ELU over
    stacked [n_cls, N, C] maps; invalid rows zero."""
    y = masked_batch_norm(x, mask, P[path + ".weight"][:, None],
                          P[path + ".bias"][:, None],
                          S[path + ".running_mean"][:, None],
                          S[path + ".running_var"][:, None])
    return zero_invalid(elu(y), mask)


class CAGroup3DHead(nn.Module):
    def __init__(self, model_cfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = model_cfg
        if c.WITH_YAW:
            raise NotImplementedError("the yaw (SUN RGB-D) head is not ported")
        if c.EXPAND_RATIO != 3 or c.N_CLASSES == 10:
            raise NotImplementedError("only the ScanNet head (EXPAND_RATIO 3,"
                                      " ScanNet voxel table) is ported")
        self.n_classes = c.N_CLASSES
        self.out_channels = c.OUT_CHANNELS
        self.n_reg_outs = c.N_REG_OUTS
        self.voxel_size = c.VOXEL_SIZE
        self.expand = c.EXPAND_RATIO
        self.cls_kernel = c.CLS_KERNEL
        self.nms_cfg = c.get("NMS_CONFIG", None)
        vox = [SCANNET_VOXELS[i % len(SCANNET_VOXELS)]
               for i in range(self.n_classes)]
        self.voxel_size_list = np.clip(np.array(vox) / 2.0, 0.04, 1.0)
        self.fine_cap = int(c.get("FINE_CAP", 4096))
        self.expand_cap = int(c.get("EXPAND_CAP", 2048))
        self.max_rois = int(c.get("MAX_ROIS", 256))
        self.nms_per_cls_cap = int(c.get("NMS_PER_CLS_CAP", 256))
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
        init_conv(P, gen, "offset_block.6", 1, C, 3)
        init_conv(P, gen, "feature_offset.0", 3, C, C)
        init_bn(P, S, "feature_offset.1", C)
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
        "up_fuse" return partial dicts."""
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
        voted = torch.clamp(pts_metric[:, None, :] + voxel_offsets[:, None, :],
                            min_bound, max_bound)                   # [N2, 1, 3]

        # class selection, plus the first valid voxel so no class map is empty
        sel = torch.sigmoid(sem) > semantic_threshold              # [N2, n_cls]
        sel[torch.argmax(st.valid.to(torch.int32))] = True
        sel = sel & st.valid[:, None]

        pts_all = torch.cat([voted.reshape(N2, 3), pts_metric], dim=0)
        feats_all = torch.cat([offset_feats, st.feats], dim=0)
        sel_all = torch.cat([sel, sel], dim=0)                      # [2N2, n_cls]
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
                                         self.expand)
        ctx.stats["overflow/head_fine"] = of_f.sum()
        ctx.stats["overflow/head_expand"] = of_c.sum()
        if stop_after == "maps":
            return dict(semantic_scores=sem, fine_feats=ff, coarse_feats=cf,
                        fine_valid=fv, coarse_valid=cv)

        f_out = scan_conv_grouped_classes(
            fc, fv, ff, 1, self.cls_kernel,
            P[pre + ".cls_individual_out.0.kernel"])
        f_out = _bn_elu(P, S, pre + ".cls_individual_out.1", f_out, fv)
        e_out = scan_conv_grouped_classes(
            cc, cv, cf, 1, 5, P[pre + ".cls_individual_expand_out.0.kernel"])
        e_out = _bn_elu(P, S, pre + ".cls_individual_expand_out.1", e_out, cv)
        if stop_after == "cls_convs":
            return dict(semantic_scores=sem, f_out=f_out, e_out=e_out)

        # generative transpose k3 s3 decoded at the fine coords
        up_out = generative_up_classes(
            cc * self.expand, cv, e_out, self.expand, fc, fv,
            P[pre + ".cls_individual_up.0.kernel"])
        up_out = _bn_elu(P, S, pre + ".cls_individual_up.1.0", up_out, fv)
        fused = torch.cat([up_out, f_out], dim=-1)
        w_fuse = P[pre + ".cls_individual_fuse.0.kernel"][:, 0]  # [n_cls, 2C, C]
        fused = torch.bmm(fused, w_fuse)
        fused = _bn_elu(P, S, pre + ".cls_individual_fuse.1", fused, fv)
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
        """Axis-aligned boxes [..., 6] from distances to the six faces."""
        x = points[..., 0] + (bbox_pred[..., 1] - bbox_pred[..., 0]) / 2
        y = points[..., 1] + (bbox_pred[..., 3] - bbox_pred[..., 2]) / 2
        z = points[..., 2] + (bbox_pred[..., 5] - bbox_pred[..., 4]) / 2
        return torch.stack([x, y, z,
                            bbox_pred[..., 0] + bbox_pred[..., 1],
                            bbox_pred[..., 2] + bbox_pred[..., 3],
                            bbox_pred[..., 4] + bbox_pred[..., 5]], dim=-1)

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
        boxes = torch.cat([boxes, torch.zeros_like(boxes[..., :1])], dim=-1)
        return multiclass_nms(boxes, scores[ids], valid[ids],
                              score_thr=float(self.nms_cfg.SCORE_THR),
                              iou_thr=float(self.nms_cfg.IOU_THR),
                              per_cls_cap=self.nms_per_cls_cap,
                              out_cap=self.max_rois)
