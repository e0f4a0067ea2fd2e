"""CAGroup3D detector: voxelization -> BiResNet -> one-stage head -> RoI
head, with the training loss.

Counterpart of ``cagroup3d_tpu/models/detectors/cagroup3d.py``
(``forward_eval``, ``forward_train``).  Per scene the voxel lattice is
shifted so its minimum coordinate is 0 (keeps coordinates packable); GT
and raw points are shifted into that frame for the losses, and predicted
boxes are shifted back into the input frame at the end.

``forward_train`` runs the B scenes of a step in lock-step threads, one per
scene (as ``torch.nn.parallel.parallel_apply`` runs replicas), meeting at
every train-mode BN through a ``SceneSync`` so that BN pools all scenes, as
the JAX package's ``psum`` over its scene axis does; one scene runs in the
calling thread.  The losses are computed in the calling thread on the
stacked per-scene outputs, so one ``backward()`` carries the gradients
across scenes.  Given a process group of W ranks (``--dist``), rank r's b
scenes are the global scenes r*b .. r*b + b - 1 of a W*b-scene step: they
draw the same random streams, BN pools all W*b scenes and the losses'
normalizers are global (``parallel/mesh.make_train_step``).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...core.module import Ctx, flat_state, load_jax_params
from ...core.norm import SceneSync
from ...core.voxelize import unique_voxels
from ...ops import build
from ...utils.commu_utils import group_rank, group_size
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
        self.ins_cap = int(model_cfg.get("INS_CAP", 128))
        # GT-as-proposal augmentation (off by default; not in the reference)
        self.roi_gt_aug = float(model_cfg.get("ROI_GT_AUG", 0.0))

    def semantic_threshold(self, cur_epoch: float) -> float:
        thr = max(self.semantic_value - cur_epoch * self.semantic_iter_value,
                  self.semantic_min_threshold)
        return float(np.float32(thr))  # the JAX package holds it in f32

    def load_jax_params(self, P, S: Optional[Dict] = None) -> None:
        """``core.module.load_jax_params`` into this model."""
        load_jax_params(self, P, S)

    # ------------------------------------------------------------------
    def _voxelize_scene(self, points, valid, stats, drop_offset=None):
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
                              stats=stats, stat_name="input",
                              drop_offset=drop_offset)
        return st, origin, xyz - origin[None, :]

    def _forward_scene(self, P, S, points, pvalid, sem_thr):
        """One scene up to the one-stage proposals."""
        ctx = Ctx()
        st, origin, pts_norm = self._voxelize_scene(points, pvalid, ctx.stats)
        feat = self.backbone_3d(P, S, ctx, st)
        head_out = self.dense_head(P, S, ctx, feat, sem_thr)
        props = self.dense_head.get_bboxes(head_out)
        return ctx, st, origin, pts_norm, feat, head_out, props

    def _train_scene(self, P, S, ctx: Ctx, points, pvalid, boxes, labels,
                     bvalid, sem_thr, roi_draws=None):
        """One scene of a training step up to the RoI head's outputs."""
        ctx.drop_offset = int(ctx.randint(1 << 30))
        st, origin, pts_norm = self._voxelize_scene(
            points, pvalid, ctx.stats, drop_offset=ctx.drop_offset)
        feat = self.backbone_3d(P, S, ctx, st)
        head_out = self.dense_head(P, S, ctx, feat, sem_thr)
        rois, roi_scores, roi_labels, roi_valid = \
            self.dense_head.get_bboxes(head_out)
        boxes_n = torch.cat([boxes[:, :3] - origin[None, :], boxes[:, 3:]],
                            dim=-1)
        if self.roi_gt_aug > 0:
            # jittered GT as extra proposals (mmdet3d heading, like the
            # one-stage rois)
            a = self.roi_gt_aug
            dev = boxes_n.device
            jc = ctx.randn(*boxes_n[:, :3].shape).to(dev) * a * boxes_n[:, 3:6]
            js = 1.0 + ctx.randn(*boxes_n[:, 3:6].shape).to(dev) * a * 0.5
            aug = torch.cat([boxes_n[:, :3] + jc,
                             (boxes_n[:, 3:6] * js).clamp(min=1e-3),
                             -boxes_n[:, 6:7]], dim=-1)
            rois = torch.cat([rois, aug], dim=0)
            roi_scores = torch.cat([roi_scores, torch.where(
                bvalid, 0.99, 0.0).to(roi_scores.dtype)], dim=0)
            roi_labels = torch.cat([roi_labels, labels.to(roi_labels.dtype)])
            roi_valid = torch.cat([roi_valid, bvalid], dim=0)
        roi_out = self.roi_head.forward_train(
            P, S, ctx, feat, rois, roi_scores, roi_labels, roi_valid, boxes_n,
            labels, bvalid, draws=roi_draws)
        return head_out, roi_out, origin, pts_norm

    def forward_train(self, batch: Dict, generator: torch.Generator,
                      cur_epoch: float = 0.0, roi_draws: Optional[List] = None,
                      group=None):
        """One training forward over the B scenes of ``batch`` (points
        [B, P, 6], points_valid, gt_boxes [B, G, 8] with the label last,
        gt_valid, and the semantic/instance masks of the ScanNet vote
        loss).  ``generator`` seeds one random stream per scene (drop
        offsets, RoI sampling, dropout); ``roi_draws`` overrides each
        scene's RoI sampling draws.  With a process ``group`` of W ranks
        the batch is this rank's block of a W*B-scene step (the module
        docstring).  Returns (loss, tb_dict, running-stat updates); the
        updates are scene 0's, which equal every scene's because BN pools
        the scenes."""
        P, S = flat_state(self)
        sem_thr = self.semantic_threshold(cur_epoch)
        B = batch["points"].shape[0]
        W, r = group_size(group), group_rank(group)
        seeds = torch.randint(0, 1 << 62, (W * B,), generator=generator)[
            r * B:(r + 1) * B].tolist()
        sync = SceneSync(B, group) if B > 1 or W > 1 else None
        if batch["points"].is_cuda:
            build.load("sparse_conv")     # build before the scene threads
        ctxs = [Ctx(train=True, generator=torch.Generator().manual_seed(sd),
                    sync=sync, scene=i) for i, sd in enumerate(seeds)]
        gt_boxes = batch["gt_boxes"][..., :7]
        gt_labels = batch["gt_boxes"][..., 7].to(torch.int32)
        gt_valid = batch["gt_valid"]

        def scene(i):
            return self._train_scene(
                P, S, ctxs[i], batch["points"][i], batch["points_valid"][i],
                gt_boxes[i], gt_labels[i], gt_valid[i], sem_thr,
                None if roi_draws is None else roi_draws[i])

        results = run_scenes(scene, B, sync)
        head_outs = {k: torch.stack([r[0][k] for r in results])
                     for k in results[0][0]}
        roi_outs = {k: torch.stack([r[1][k] for r in results])
                    for k in results[0][1]}
        origins = torch.stack([r[2] for r in results])
        pts_norm = torch.stack([r[3] for r in results])
        gt_boxes_n = torch.cat([gt_boxes[..., :3] - origins[:, None, :],
                                gt_boxes[..., 3:]], dim=-1)
        loss_one, tb = self.dense_head.loss(
            head_outs, gt_boxes_n, gt_labels, gt_valid, pts_norm,
            batch["points_valid"], batch.get("semantic_mask"),
            batch.get("instance_mask"), ins_cap=self.ins_cap, group=group)
        loss_two, tb2 = self.roi_head.loss(roi_outs, group=group)
        tb.update(tb2)
        loss = loss_one + loss_two
        tb["loss_all"] = loss
        if sync is not None:
            loss = sync.attach(loss)
        # capacity-overflow counters (dropped voxels), summed over scenes
        for k in ctxs[0].stats:
            tb[k] = sum(c.stats[k] for c in ctxs).float()
        return loss, tb, ctxs[0].updates

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


def run_scenes(fn, n: int, sync: Optional[SceneSync]):
    """[fn(0), ..., fn(n - 1)]: scene 0 in the calling thread when n == 1,
    else one thread per scene.  A failing scene aborts ``sync`` (the other
    scenes stop waiting, and this rank issues no further cross-rank sum),
    and the first error is re-raised here."""
    if n == 1:
        try:
            return [fn(0)]
        except BaseException:
            if sync is not None:
                sync.abort()
            raise
    results: list = [None] * n
    errors: list = []
    grad = torch.is_grad_enabled()

    def work(i):
        try:
            with torch.set_grad_enabled(grad):
                results[i] = fn(i)
        except BaseException as e:   # re-raised in the calling thread
            errors.append((i, e))
            sync.abort()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        i, e = min(errors, key=lambda x: isinstance(
            x[1], threading.BrokenBarrierError))
        raise RuntimeError(f"scene {i} of the training step failed") from e
    return results
