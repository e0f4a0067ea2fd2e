"""CAGroup3D detector, eval: voxelization -> BiResNet -> one-stage head ->
RoI head.

Counterpart of ``cagroup3d_tpu/models/detectors/cagroup3d.py``
(``forward_eval``).  Per scene the voxel lattice is shifted so its minimum
coordinate is 0 (keeps coordinates packable), and predicted boxes are
shifted back into the input frame at the end.
"""
from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...core.module import Ctx, flat_state
from ...core.voxelize import unique_voxels
from ..backbones_3d.biresnet import BiResNet
from ..dense_heads.cagroup_head import CAGroup3DHead
from ..roi_heads.cagroup_roi_head import CAGroup3DRoIHead


class CAGroup3D(nn.Module):
    def __init__(self, model_cfg, num_class: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.backbone_3d = BiResNet(model_cfg.BACKBONE_3D, gen)
        self.dense_head = CAGroup3DHead(model_cfg.DENSE_HEAD, gen)
        self.roi_head = CAGroup3DRoIHead(model_cfg.ROI_HEAD, gen)
        self.voxel_size = model_cfg.VOXEL_SIZE
        self.semantic_min_threshold = model_cfg.SEMANTIC_MIN_THR
        self.semantic_iter_value = model_cfg.SEMANTIC_ITER_VALUE
        self.semantic_value = model_cfg.SEMANTIC_THR
        self.input_cap = int(model_cfg.get("INPUT_CAP",
                                           self.backbone_3d.caps[1]))

    def semantic_threshold(self, cur_epoch: float) -> float:
        thr = max(self.semantic_value - cur_epoch * self.semantic_iter_value,
                  self.semantic_min_threshold)
        return float(np.float32(thr))  # the JAX package holds it in f32

    def load_jax_params(self, P, S: Optional[Dict] = None) -> None:
        """Copy the JAX package's flat param/state dicts (numpy arrays by
        name) into this model; ``P`` may instead be the path of a pickled
        checkpoint written by the JAX package's ``save_checkpoint``.
        Raises on a missing or extra name or a shape mismatch."""
        if isinstance(P, (str, bytes)) or hasattr(P, "__fspath__"):
            with open(P, "rb") as f:
                ckpt = pickle.load(f)
            P, S = ckpt["params"], ckpt["state"]
        mine_p, mine_s = flat_state(self)
        for name, mine, theirs in (("params", mine_p, P), ("state", mine_s, S)):
            missing = sorted(set(mine) - set(theirs))
            extra = sorted(set(theirs) - set(mine))
            if missing or extra:
                raise KeyError(f"{name}: missing {missing[:8]}, extra "
                               f"{extra[:8]}")
            for k, t in mine.items():
                src = np.asarray(theirs[k])
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"{k}: shape {src.shape} != "
                                     f"{tuple(t.shape)}")
                with torch.no_grad():
                    t.copy_(torch.from_numpy(np.array(src)))

    # ------------------------------------------------------------------
    def _voxelize_scene(self, points, valid, stats):
        """points [P, 6] (xyz, rgb 0..255) -> (SparseTensor stride 1,
        origin [3], points in the shifted frame [P, 3])."""
        v = self.voxel_size
        xyz = points[:, :3]
        rgb = points[:, 3:6] / 255.0
        lat = torch.floor(xyz / v).to(torch.int32)
        big = 1 << 20
        min_lat = torch.where(valid[:, None], lat,
                              torch.full_like(lat, big)).amin(0)
        min_lat = torch.where(min_lat == big, torch.zeros_like(min_lat),
                              min_lat)
        lat = lat - min_lat[None, :]
        origin = min_lat.to(torch.float32) * v
        st, _ = unique_voxels(lat, rgb, valid, self.input_cap, mode="first",
                              stats=stats, stat_name="input")
        return st, origin, xyz - origin[None, :]

    def _forward_scene(self, P, S, points, pvalid, sem_thr):
        """One scene up to the one-stage proposals."""
        ctx = Ctx()
        st, origin, pts_norm = self._voxelize_scene(points, pvalid, ctx.stats)
        feat = self.backbone_3d(P, S, ctx, st)
        head_out = self.dense_head(P, S, ctx, feat, sem_thr)
        props = self.dense_head.get_bboxes(head_out)
        return ctx, st, origin, pts_norm, feat, head_out, props

    @torch.no_grad()
    def forward_eval(self, batch: Dict, cur_epoch=None) -> Dict:
        """batch: points [B, P, 6], points_valid [B, P] on the model's
        device.  Returns padded predictions with a leading scene axis
        (boxes in the input frame, mmdet3d heading convention)."""
        P, S = flat_state(self)
        sem_thr = self.semantic_threshold(
            cur_epoch if cur_epoch is not None else 1000.0)
        outs = []
        for points, pvalid in zip(batch["points"], batch["points_valid"]):
            ctx, st, origin, _, feat, _, props = self._forward_scene(
                P, S, points, pvalid, sem_thr)
            rois, roi_scores, roi_labels, roi_valid = props
            out = self.roi_head(P, S, ctx, feat, rois, roi_scores, roi_labels,
                                roi_valid)
            boxes = out["batch_box_preds"].clone()
            boxes[:, :3] += origin[None, :]
            overflow = sum(v.sum() for v in ctx.stats.values())
            outs.append(dict(pred_boxes=boxes,
                             pred_scores=out["batch_score_preds"],
                             pred_labels=out["batch_cls_preds"],
                             pred_valid=out["batch_pred_valid"],
                             overflow=overflow))
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
