"""SECOND: MeanVFE -> VoxelBackBone8x -> HeightCompression ->
BaseBEVBackbone -> AnchorHeadSingle.

Counterpart of ``SECONDNet`` in ``cagroup3d_tpu/models/detectors/
second_net.py`` (the reference's pcdet/models/detectors/second_net.py).
The point-cloud range and voxel size come from ``MODEL`` or else from the
dataset config, and so does the VFE's point cap per voxel (the template).
The lattice's key bits are widened exactly as the JAX package widens its
global bits for this grid (KITTI: (11, 11, 8)), but the model keeps them
and sets them only around its own forward (``hashing.key_bits_scope``),
so another model built after it in the same process still packs keys at
the defaults.  ``forward_eval`` runs the batch's scenes one after another.

``forward_train`` runs each scene's sparse half (VFE, sparse backbone,
BEV map) in a thread of its own, the threads meeting at every BN through a
``SceneSync`` (BN pools the B scenes, as the JAX package's ``scene``
vmap axis does), then the B maps as one batch through the 2-D backbone
(BN over all B * H * W positions) and the head, and the anchor loss over
the batch.  The sparse convs' backward packs its keys at the bits of its
forward (``ops/sparse_conv._SparseConvFn``), so ``loss.backward()`` may run
after the scope has closed.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ...core.hashing import key_bits_scope
from ...core.module import Ctx, flat_state
from ...core.norm import SceneSync
from ...ops import build
from ...utils.commu_utils import group_size
from .cagroup3d import run_scenes
from .detector3d_template import Detector3DTemplate, key_bits_for


class SECONDNet(Detector3DTemplate):
    READS_DATASET = True

    def __init__(self, model_cfg, num_class: int,
                 generator: Optional[torch.Generator] = None, dataset=None):
        super().__init__(model_cfg, num_class, dataset)
        self.point_cloud_range, self.voxel_size, self.grid_size = \
            self.resolve_grid()
        self.key_bits = key_bits_for(self.grid_size)
        self.input_cap = int(model_cfg.get("INPUT_CAP", 65536))
        if self.class_names is None:
            self.class_names = [a["class_name"] for a in
                                model_cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG]
        self.build_networks(generator or torch.Generator().manual_seed(0))

    def final_grid(self):
        """(W, H, D) of the final sparse level that HeightCompression
        folds (KITTI: (176, 200, 2))."""
        return tuple(int(e) for e in self.backbone_3d.final_extent)

    def forward_scene(self, P, S, ctx: Ctx, points, pvalid) -> Dict:
        """One scene's head outputs (flat per-anchor predictions)."""
        return self.dense_head(P, self.backbone_2d(
            P, S, self.bev_map(P, S, ctx, points, pvalid)))

    def bev_map(self, P, S, ctx: Ctx, points, pvalid) -> torch.Tensor:
        """One scene's dense BEV map [D*C, H, W]; keys pack at the model's
        bits only inside ``key_bits_scope``."""
        st = self.vfe(ctx, points, pvalid, self.voxel_size,
                      self.point_cloud_range, self.input_cap)
        bb = self.backbone_3d(P, S, ctx, st)
        return self.map_to_bev_module(bb["encoded_spconv_tensor"],
                                      self.final_grid())

    def forward_train(self, batch: Dict, generator: torch.Generator,
                      cur_epoch: float = 0.0, roi_draws=None, group=None):
        """One training forward over the B scenes of ``batch`` (points
        [B, P, 3 + F], points_valid, gt_boxes [B, G, 8] with the label
        last, gt_valid).  SECOND draws no random numbers in its forward, so
        ``generator`` and ``roi_draws`` (``make_train_step``'s signature)
        go unused.  Returns (loss, tb_dict, running-stat updates): the tb
        terms of the anchor loss, ``loss_all`` and each capacity counter
        summed over the scenes."""
        if group_size(group) > 1:
            raise NotImplementedError(
                "SECOND with --dist: its BN statistics are not pooled over "
                "ranks yet (train SECOND on one card)")
        P, S = flat_state(self)
        B = batch["points"].shape[0]
        sync = SceneSync(B) if B > 1 else None
        if batch["points"].is_cuda:
            build.load("sparse_conv")     # build before the scene threads
        ctxs = [Ctx(train=True, sync=sync, scene=i) for i in range(B)]

        def scene(i):
            return self.bev_map(P, S, ctxs[i], batch["points"][i],
                                batch["points_valid"][i])

        # the scene threads pack at the bits this thread has set
        with key_bits_scope(self.key_bits):
            bevs = run_scenes(scene, B, sync)
        updates = dict(ctxs[0].updates)
        bev2d = self.backbone_2d(P, S, torch.stack(bevs), updates=updates)
        outs = self.dense_head(P, bev2d)
        loss, tb = self.dense_head.loss(
            outs, batch["gt_boxes"][..., :7],
            batch["gt_boxes"][..., 7].to(torch.int64), batch["gt_valid"])
        for k in ctxs[0].stats:
            tb[k] = sum(c.stats[k] for c in ctxs).float()
        tb["loss_all"] = loss
        return loss, tb, updates

    @torch.no_grad()
    def forward_eval(self, batch: Dict, cur_epoch=None) -> Dict:
        """batch: points [B, P, 3 + F] (lidar frame), points_valid [B, P] on
        the model's device.  Returns padded predictions with a leading
        scene axis: pred_boxes [B, M, 7], pred_scores, pred_labels (i32),
        pred_valid, and each scene's dropped-voxel count (overflow)."""
        P, S = flat_state(self)
        outs = []
        with key_bits_scope(self.key_bits):
            for points, pvalid in zip(batch["points"], batch["points_valid"]):
                ctx = Ctx()
                out = self.forward_scene(P, S, ctx, points, pvalid)
                boxes, scores, labels, valid = \
                    self.dense_head.generate_predicted_boxes(out)
                overflow = sum(v.sum() for v in ctx.stats.values())
                outs.append(dict(pred_boxes=boxes, pred_scores=scores,
                                 pred_labels=labels, pred_valid=valid,
                                 overflow=overflow))
        return {k: torch.stack([torch.as_tensor(o[k]) for o in outs])
                for k in outs[0]}
