"""RBGNet detector: PointNet2-FBS backbone + ray-based-grouping head.

Counterpart of ``cagroup3d_tpu/models/detectors/rbgnet.py`` (reference
pcdet/models/detectors/rbgnet.py): two modules, ``backbone_3d`` and
``point_head``; the loss is the head's.  The JAX package vmaps one scene's
forward over the batch; here the whole batch runs at once with a leading
scene axis, and training-mode batch norm pools every valid row of the B
scenes, as its ``psum`` over the scene axis does; given a process group
of W ranks (``--dist``), BN pools every rank's rows and the loss's
normalizers are global (``parallel/mesh.make_train_step``).  The model has
no random draws, so the training step's generator is not used.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ...core.module import Ctx, flat_state, load_jax_params
from ...core.norm import SceneSync
from ...utils.commu_utils import group_size
from ..backbones_3d.pointnet2_fbs_backbone import PointNet2FBSBackbone
from ..dense_heads.rbg_head import RBGHead


class RBGNet(nn.Module):
    def __init__(self, model_cfg, num_class: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.backbone_3d = PointNet2FBSBackbone(model_cfg.BACKBONE_3D, gen)
        self.point_head = RBGHead(model_cfg.POINT_HEAD, num_class, gen)
        self.ins_cap = int(model_cfg.get("INS_CAP", 128))
        self.max_out = int(model_cfg.get("MAX_OUT", 1024))

    def load_jax_params(self, P, S: Optional[Dict] = None) -> None:
        """``core.module.load_jax_params`` into this model."""
        load_jax_params(self, P, S)

    def _forward(self, P, S, ctx: Ctx, points, pvalid):
        """points [B, N, 6] (xyz, rgb 0..255) -> (backbone outputs, head
        outputs)."""
        bb = self.backbone_3d(P, S, ctx, points[..., :3],
                              points[..., 3:6] / 255.0, pvalid)
        return bb, self.point_head(P, S, ctx, bb)

    def forward_train(self, batch: Dict, generator: Optional[torch.Generator]
                      = None, cur_epoch: float = 0.0,
                      roi_draws: Optional[List] = None, group=None):
        """One training forward over the B scenes of ``batch`` (points
        [B, N, 6], points_valid, gt_boxes [B, G, 8] with the label last,
        gt_valid, and the ScanNet semantic/instance masks when present).
        ``generator`` and ``roi_draws`` are accepted for the training
        step's signature; RBGNet draws nothing.  ``group``: this rank's
        process group (BN and the loss's normalizers span its ranks).
        Returns (loss, tb_dict, running-stat updates)."""
        P, S = flat_state(self)
        sync = SceneSync(1, group) if group_size(group) > 1 else None
        ctx = Ctx(train=True, sync=sync)
        bb, out = self._forward(P, S, ctx, batch["points"],
                                batch["points_valid"])
        loss_batch = dict(
            points=batch["points"][..., :3],
            points_valid=batch["points_valid"],
            gt_boxes=batch["gt_boxes"][..., :7],
            gt_labels=batch["gt_boxes"][..., 7].to(torch.int32),
            gt_valid=batch["gt_valid"],
            semantic_mask=batch.get("semantic_mask"),
            instance_mask=batch.get("instance_mask"))
        loss, tb = self.point_head.loss(out, bb, loss_batch,
                                        ins_cap=self.ins_cap, group=group)
        if sync is not None:
            loss = sync.attach(loss)
        return loss, tb, ctx.updates

    @torch.no_grad()
    def forward_eval(self, batch: Dict, cur_epoch=None) -> Dict:
        """batch: points [B, N, 6], points_valid [B, N] on the model's
        device.  Returns padded predictions with a leading scene axis
        (pred_boxes [B, M, 7] in the input frame, pred_scores, pred_labels,
        pred_valid)."""
        P, S = flat_state(self)
        points, pvalid = batch["points"], batch["points_valid"]
        _, out = self._forward(P, S, Ctx(), points, pvalid)
        boxes, scores, labels, valid = \
            self.point_head.generate_predicted_boxes(
                out, points[..., :3], pvalid, max_out=self.max_out)
        return dict(pred_boxes=boxes, pred_scores=scores, pred_labels=labels,
                    pred_valid=valid)
