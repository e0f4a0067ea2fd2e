"""SECOND: MeanVFE -> VoxelBackBone8x -> HeightCompression ->
BaseBEVBackbone -> AnchorHeadSingle (or AnchorHeadMulti, SECOND-multihead;
CenterHead, CenterPoint), and PointPillar: PillarVFE ->
PointPillarScatter -> BaseBEVBackbone -> AnchorHeadSingle, with no sparse
backbone.

Counterpart of ``SECONDNet`` and ``PointPillar`` in
``cagroup3d_tpu/models/detectors/second_net.py`` (the reference's
pcdet/models/detectors/second_net.py and pointpillar.py).
The point-cloud range and voxel size come from ``MODEL`` or else from the
dataset config, and so does the VFE's point cap per voxel (the template).
The lattice's key bits are widened exactly as the JAX package widens its
global bits for this grid (KITTI: (11, 11, 8)), but the model keeps them
and sets them only around its own forward (``hashing.key_bits_scope``),
so another model built after it in the same process still packs keys at
the defaults; a lattice that fits the defaults (PointPillar's pillars)
opens no scope.  ``forward_eval`` runs the batch's scenes one after another.

``forward_train`` runs each scene's sparse half (VFE, sparse backbone,
BEV map) in a thread of its own, the threads meeting at every BN through a
``SceneSync`` (BN pools the B scenes, as the JAX package's ``scene``
vmap axis does), then the B maps as one batch through the 2-D backbone
(BN over all B * H * W positions) and the head, and the anchor loss over
the batch.  The sparse convs' backward packs its keys at the bits of its
forward (``ops/sparse_conv._SparseConvFn``), so ``loss.backward()`` may run
after the scope has closed.

Given a process group of W ranks (``--dist``), rank r's b scenes are the
global scenes r*b .. r*b + b - 1 of a W*b-scene step, as in
``CAGroup3D.forward_train``: they draw the global scenes' random streams;
every BN (the sparse half's, the BEV maps' and the heads') pools all W*b
scenes through the step's one chain of numbered cross-rank sums
(``core/norm.RankSum``: the scene threads' sync points, then the batched
stages' through ``SceneSync.batch_sync``); each rank's loss is its share
of the global loss, so that the ranks' mean is that loss
(``parallel/mesh.global_terms``): the anchor losses' box and direction
terms are per-scene means, their class term, over the batch's element
count as in the JAX package, is divided by W too, SECOND-IoU's RoI
count is a global sum, and so are CenterHead's positive and object
counts.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ...core.hashing import key_bits_scope
from ...core.module import Ctx, flat_state
from ...core.norm import SceneSync
from ...ops import build
from ...utils.commu_utils import group_rank, group_size
from .cagroup3d import run_scenes
from .detector3d_template import (DEFAULT_KEY_BITS, Detector3DTemplate,
                                  key_bits_for)


def batch_sync(ctxs):
    """The sync of the stages that run over the whole batch after the scene
    threads of ``ctxs`` (``SceneSync.batch_sync``), or None."""
    sync = ctxs[0].sync
    return None if sync is None else sync.batch_sync()


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
            dh = model_cfg.DENSE_HEAD
            if dh.get("ANCHOR_GENERATOR_CONFIG") is not None:
                self.class_names = [a["class_name"] for a in
                                    dh.ANCHOR_GENERATOR_CONFIG]
            else:       # CenterHead: the classes of the head groups
                self.class_names = [c for g in dh.CLASS_NAMES_EACH_HEAD
                                    for c in g]
        self.build_networks(generator or torch.Generator().manual_seed(0))

    def bits_scope(self):
        """The model's key bits around its forward: a ``key_bits_scope``,
        or no scope at the default bits."""
        if tuple(self.key_bits) == DEFAULT_KEY_BITS:
            return contextlib.nullcontext()
        return key_bits_scope(self.key_bits)

    def final_grid(self):
        """(W, H, D) of the final lattice that the BEV map folds (KITTI's
        SECOND: (176, 200, 2); pillars: (W, H, 1) of the grid)."""
        if self.model_cfg.MAP_TO_BEV.NAME == "PointPillarScatter":
            return (self.grid_size[0], self.grid_size[1], 1)
        return tuple(int(e) for e in self.backbone_3d.final_extent)

    def forward_scene(self, P, S, ctx: Ctx, points, pvalid):
        """One scene's (head outputs, 2-D backbone map [C, H, W])."""
        bev2d = self.backbone_2d(P, S, self.bev_map(P, S, ctx, points,
                                                    pvalid))
        return self.dense_head(P, bev2d, S=S), bev2d

    def bev_map(self, P, S, ctx: Ctx, points, pvalid) -> torch.Tensor:
        """One scene's dense BEV map [C', H, W]; keys pack at the model's
        bits only inside ``bits_scope``."""
        st = self.vfe(ctx, points, pvalid, self.voxel_size,
                      self.point_cloud_range, self.input_cap)
        if self.backbone_3d is not None:
            st = self.backbone_3d(P, S, ctx, st)["encoded_spconv_tensor"]
        return self.map_to_bev_module(st, self.final_grid())

    def train_maps(self, batch: Dict, generator: torch.Generator,
                   group=None):
        """The batch's sparse halves (VFE, sparse backbone, BEV map), each
        scene in a thread of its own inside the model's bits, BN pooled
        over the scenes (and the ranks of ``group``).  Returns (P, S, the
        scenes' ``Ctx`` (each with a generator seeded from ``generator``
        by its global index, and the step's ``SceneSync``), the BEV maps
        [B, C, H, W])."""
        P, S = flat_state(self)
        B = batch["points"].shape[0]
        W, r = group_size(group), group_rank(group)
        sync = SceneSync(B, group) if B > 1 or W > 1 else None
        if batch["points"].is_cuda and self.backbone_3d is not None:
            build.load("sparse_conv")     # build before the scene threads
        seeds = torch.randint(0, 1 << 62, (W * B,), generator=generator)[
            r * B:(r + 1) * B].tolist()
        ctxs = [Ctx(train=True, generator=torch.Generator().manual_seed(sd),
                    sync=sync, scene=i) for i, sd in enumerate(seeds)]

        def scene(i):
            return self.bev_map(P, S, ctxs[i], batch["points"][i],
                                batch["points_valid"][i])

        # the scene threads pack at the bits this thread has set
        with self.bits_scope():
            bevs = run_scenes(scene, B, sync)
        return P, S, ctxs, torch.stack(bevs)

    def train_heads(self, P, S, ctxs, bev: torch.Tensor, batch: Dict,
                    roi_draws=None, group=None):
        """The training forward from the BEV maps bev [B, C, H, W] on: the
        2-D backbone and the head over the batch (BN over all B * H * W
        positions, and over the ranks' maps through the batch sync of
        ``ctxs[0].sync``) and the loss.  Returns (loss, tb, the running-stat
        updates of every BN, the sparse half's from ``ctxs[0]``)."""
        updates = dict(ctxs[0].updates)
        sync = batch_sync(ctxs)
        bev2d = self.backbone_2d(P, S, bev, updates=updates, sync=sync)
        outs = self.dense_head(P, bev2d, S=S, updates=updates, sync=sync)
        loss, tb = self.dense_head.loss(
            outs, batch["gt_boxes"][..., :7],
            batch["gt_boxes"][..., 7].to(torch.int64), batch["gt_valid"],
            group=group)
        return loss, tb, updates

    def forward_train(self, batch: Dict, generator: torch.Generator,
                      cur_epoch: float = 0.0, roi_draws=None, group=None):
        """One training forward over the B scenes of ``batch`` (points
        [B, P, 3 + F], points_valid, gt_boxes [B, G, 8] with the label
        last, gt_valid): ``train_maps``, then ``train_heads``.
        ``roi_draws`` overrides the RoI sampling's draws of a model with an
        RoI head (SECOND and PointPillar draw no random numbers).  Returns
        (loss, tb_dict, running-stat updates): the loss terms, ``loss_all``
        and each capacity counter summed over the scenes.  With a process
        ``group`` the batch is this rank's block of the step (the module
        docstring)."""
        P, S, ctxs, bev = self.train_maps(batch, generator, group)
        loss, tb, updates = self.train_heads(P, S, ctxs, bev, batch,
                                             roi_draws, group)
        for k in ctxs[0].stats:
            tb[k] = sum(c.stats[k] for c in ctxs).float()
        tb["loss_all"] = loss
        if ctxs[0].sync is not None:
            loss = ctxs[0].sync.attach(loss)
        return loss, tb, updates

    def predict(self, P, S, ctx: Ctx, out: Dict, bev2d, points, pvalid):
        """One scene's (boxes, scores, labels i32, valid) from its head
        outputs."""
        return self.dense_head.generate_predicted_boxes(out)

    @torch.no_grad()
    def forward_eval(self, batch: Dict, cur_epoch=None) -> Dict:
        """batch: points [B, P, 3 + F] (lidar frame), points_valid [B, P] on
        the model's device.  Returns padded predictions with a leading
        scene axis: pred_boxes [B, M, 7], pred_scores, pred_labels (i32),
        pred_valid, and each scene's dropped-voxel count (overflow)."""
        P, S = flat_state(self)
        outs = []
        with self.bits_scope():
            for points, pvalid in zip(batch["points"], batch["points_valid"]):
                ctx = Ctx()
                out, bev2d = self.forward_scene(P, S, ctx, points, pvalid)
                boxes, scores, labels, valid = self.predict(
                    P, S, ctx, out, bev2d, points, pvalid)
                overflow = sum(v.sum() for v in ctx.stats.values())
                outs.append(dict(pred_boxes=boxes, pred_scores=scores,
                                 pred_labels=labels, pred_valid=valid,
                                 overflow=overflow))
        return {k: torch.stack([torch.as_tensor(o[k]) for o in outs])
                for k in outs[0]}


class PointPillar(SECONDNet):
    """pointpillar.py: SECONDNet's pipeline with PillarVFE and
    PointPillarScatter in place of the sparse half."""
