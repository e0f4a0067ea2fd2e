"""VoxelRCNNHead: RoI-grid pooling straight from the sparse backbone's
volumes through voxel-hash neighbour queries, then the R-CNN trunk.

Counterpart of ``cagroup3d_tpu/models/roi_heads/voxelrcnn_head.py`` (the
reference's voxelrcnn_head.py and voxel_pool_modules.py
NeighborVoxelSAModuleMSG).  Each RoI's G^3 grid points are pooled from
every source of ``FEATURES_SOURCE`` (``x_conv2`` .. ``x_conv4``: the sparse
tensors of the backbone's levels, lattice units, stride 2 .. 8 voxels).
Per source and group, as in the JAX package:

- ``mlps_in``: a 1x1 linear and BN over the source's valid voxels;
- the voxel query: the grid point's lattice coordinate, ``floor((p -
  range_min) / (voxel_size * stride))`` by an IEEE division (not a
  reciprocal), plus each of the ``NSAMPLE`` lattice offsets of
  ``[-r, r]^3`` nearest the origin (``core/pointnet2_stack``), looked up
  in the source's sorted keys at the model's key bits; a neighbour counts
  when it exists and its voxel centre lies within ``POOL_RADIUS``;
- ``mlps_pos``: a linear and BN of the neighbour's offset from the grid
  point, over the counted neighbours;
- ``relu(feature + position)``, uncounted neighbours at -1e9, the max over
  the neighbours (``amax``: a tie splits the gradient, as ``jnp.max``
  does), clamped at -1e8, and 0 for a grid point with no neighbour;
- ``mlps_out``: a linear, BN over the valid grid points, ReLU.

The sources' outputs are concatenated per grid point and flattened per
RoI into the trunk of ``PVRCNNHead``.  The gathers go through
``core/gather.take_rows``, whose backward adds in a fixed order.

Training pools the B scenes' RoIs as one [B, ...] stack: every BN pools
its rows over the scenes (and, through the step's batch sync, the ranks),
as the JAX package's ``scene`` vmap axis does; the sources keep each
scene's capacity, so they stack too.  The RoIs and their targets take no
gradient (the reference's ``torch.no_grad``); the JAX package lets it
flow into the grid points.  Dropout draws from each scene's generator, so
its masks are not the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ...core import nms as nms_mod
from ...core.gather import take_rows
from ...core.module import (Ctx, Params, apply_bn, init_bn, init_linear,
                            register_flat)
from ...core.pointnet2_stack import nearest_offsets, voxel_query_offsets
from ...core.sparse import SparseTensor
from .pvrcnn_head import PVRCNNHead


class VoxelRCNNHead(PVRCNNHead):
    """Parameters under the JAX package's names:
    ``roi_grid_pool_layers.{k}.mlps_{in,pos,out}.{g}.weight`` (no bias)
    and ``.bn.*`` for source k and group g, then the trunk's
    (``PVRCNNHead.init_trunk``)."""

    def __init__(self, model_cfg, num_class: int = 1,
                 input_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 backbone_channels=None, voxel_size=None,
                 point_cloud_range=None):
        super().__init__(model_cfg)
        self.cfg = c = model_cfg
        gp = c.ROI_GRID_POOL
        self.grid_size = int(gp.GRID_SIZE)
        self.sources = list(gp.FEATURES_SOURCE)
        self.voxel_size = [float(v) for v in (voxel_size or [0.05] * 3)]
        self.pc_range = [float(v) for v in
                         (point_cloud_range or [0, -40, -3, 70.4, 40, 1])]
        backbone_channels = backbone_channels or {}
        self.pools = []      # per source: [(offsets, radius, mlp)] a group
        c_out = 0
        for src in self.sources:
            lc = gp.POOL_LAYERS[src]
            groups = []
            for gi in range(len(lc.MLPS)):
                cin = int(backbone_channels.get(
                    src, lc.get("INPUT_CHANNELS", 16)))
                mlp = [cin] + [int(x) for x in lc.MLPS[gi]]
                groups.append((nearest_offsets(int(lc.QUERY_RANGES[gi][0]),
                                               int(lc.NSAMPLE[gi])),
                               float(lc.POOL_RADIUS[gi]), mlp))
                c_out += mlp[-1]
            self.pools.append(groups)
        self.pool_out_channels = c_out
        gen = generator or torch.Generator().manual_seed(0)
        P, S = {}, {}
        for k, groups in enumerate(self.pools):
            for gi, (_, _, mlp) in enumerate(groups):
                base = f"roi_grid_pool_layers.{k}"
                for name, cin, cout in (("mlps_in", mlp[0], mlp[1]),
                                        ("mlps_pos", 3, mlp[1]),
                                        ("mlps_out", mlp[1], mlp[2])):
                    init_linear(P, gen, f"{base}.{name}.{gi}", cin, cout,
                                bias=False, init="kaiming")
                    init_bn(P, S, f"{base}.{name}.{gi}.bn", cout)
        self.init_trunk(P, S, gen, num_class,
                        self.grid_size ** 3 * self.pool_out_channels)
        register_flat(self, P, S)

    def roi_grid_pool_voxel(self, P: Params, S: Params, ctx: Ctx,
                            rois: torch.Tensor, roi_valid: torch.Tensor,
                            multis: List[Dict[str, SparseTensor]],
                            strides: Dict[str, int],
                            prefix: str = "roi_head") -> torch.Tensor:
        """rois [B, R, 7], roi_valid [B, R], ``multis`` the B scenes'
        sparse levels by name, ``strides`` each level's stride in voxels
        -> pooled [B, R, G^3 * pool_out_channels].  Keys pack at the
        caller's bits.  In training every BN pools the B scenes."""
        B, R = rois.shape[:2]
        g3 = self.grid_size ** 3
        M = R * g3
        dev = rois.device
        grid = self.get_global_grid_points(rois.reshape(B * R, 7)).reshape(
            B, M, 3)
        gvalid = roi_valid[:, :, None].expand(B, R, g3).reshape(B, M)
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=dev)
        lo = torch.tensor(self.pc_range[:3], dtype=torch.float32, device=dev)
        scene = torch.arange(B, device=dev)[:, None, None]
        outs = []
        for k, src in enumerate(self.sources):
            sts = [m[src] for m in multis]
            N = sts[0].cap
            coords = torch.stack([st.coords for st in sts])
            valid = torch.stack([st.valid for st in sts])
            feats = torch.stack([st.masked_feats() for st in sts])
            lvs = vs * strides[src]
            centers = (lo + (coords.to(torch.float32) + 0.5) * lvs).reshape(
                B * N, 3)
            lat = torch.floor((grid - lo) / lvs).to(torch.int32)
            base = f"{prefix}.roi_grid_pool_layers.{k}"
            for gi, (offs, radius, _) in enumerate(self.pools[k]):
                K = offs.shape[0]
                fin = apply_bn(P, S, ctx, f"{base}.mlps_in.{gi}.bn",
                               feats @ P[f"{base}.mlps_in.{gi}.weight"],
                               valid, scene_axis=True)
                rows = torch.stack([voxel_query_offsets(
                    coords[b], valid[b], lat[b], gvalid[b], offs)
                    for b in range(B)])                      # [B, M, K]
                flat = (rows.clamp(min=0) + scene * N).reshape(B, M * K)
                rel = take_rows(centers, flat).reshape(B, M, K, 3) - \
                    grid[:, :, None, :]
                ok = (rows >= 0) & ((rel ** 2).sum(-1) < radius * radius)
                okf = ok.reshape(B, M * K)
                pos = apply_bn(P, S, ctx, f"{base}.mlps_pos.{gi}.bn",
                               rel.reshape(B, M * K, 3) @
                               P[f"{base}.mlps_pos.{gi}.weight"], okf,
                               scene_axis=True)
                g = take_rows(fin.reshape(B * N, -1), flat)
                h = torch.relu(g + pos)
                h = torch.where(okf[..., None], h, torch.full_like(h, -1e9))
                h = h.reshape(B, M, K, -1).amax(dim=2)
                h = torch.where(ok.any(-1)[..., None],
                                torch.clamp(h, min=-1e8), torch.zeros_like(h))
                o = apply_bn(P, S, ctx, f"{base}.mlps_out.{gi}.bn",
                             h @ P[f"{base}.mlps_out.{gi}.weight"], gvalid,
                             scene_axis=True)
                outs.append(torch.where(gvalid[..., None], torch.relu(o),
                                        torch.zeros_like(o)))
        return torch.cat(outs, -1).reshape(B, R, g3 * self.pool_out_channels)

    def forward_train(self, P: Params, S: Params, ctx: Ctx,
                      scene_ctxs: List[Ctx], proposals, gt_boxes, gt_labels,
                      gt_valid, multis, strides, draws=None,
                      prefix: str = "roi_head") -> Dict[str, torch.Tensor]:
        """The batch's training forward: per scene its proposals (rois,
        scores, labels, valid) sampled against its GTs (``draws`` [B] of
        the target layer's draws, else each scene's generator), then the
        pool and the trunk over the B scenes.  Returns the loss's inputs,
        each [B, ROI_PER_IMAGE, ...]."""
        tgts = [self.sample_targets(
            scene_ctxs[i].generator, *props, gt_boxes[i], gt_labels[i],
            gt_valid[i], draws=None if draws is None else draws[i])
            for i, props in enumerate(proposals)]
        rois = torch.stack([t["rois"] for t in tgts])
        valid = torch.ones(rois.shape[:2], dtype=torch.bool,
                           device=rois.device)
        pooled = self.roi_grid_pool_voxel(P, S, ctx, rois, valid, multis,
                                          strides, prefix)
        rcnn_cls, rcnn_reg = self._heads(P, S, ctx, pooled, valid,
                                         scene_ctxs, prefix)
        out = dict(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg, rois=rois)
        for key, name in (("gt_of_rois", "gt_of_rois_ct"),
                          ("gt_of_rois_src", "gt_of_rois"),
                          ("reg_valid_mask", "reg_valid_mask"),
                          ("rcnn_cls_labels", "rcnn_cls_labels"),
                          ("roi_labels", "roi_labels")):
            out[key] = torch.stack([t[name] for t in tgts])
        return out

    def forward_test(self, P: Params, S: Params, ctx: Ctx, rois, roi_labels,
                     roi_valid, multi: Dict[str, SparseTensor], strides,
                     score_thresh: float = 0.1, nms_thresh: float = 0.1,
                     max_out: int = 128, prefix: str = "roi_head"):
        """One scene: its proposals (rois [R, 7], labels, valid) refined
        from its sparse levels ``multi``, scored by the class branch's
        sigmoid, those above ``score_thresh`` through a rotated NMS at
        ``nms_thresh``, the best min(max_out, R) kept: (boxes, scores,
        labels i32, valid)."""
        pooled = self.roi_grid_pool_voxel(P, S, ctx, rois[None],
                                          roi_valid[None], [multi], strides,
                                          prefix)[0]
        rcnn_cls, rcnn_reg = self._heads(P, S, ctx, pooled, roi_valid,
                                         prefix=prefix)
        boxes = self.decode_boxes(rois, rcnn_reg)
        scores = torch.sigmoid(rcnn_cls[:, 0])
        neg = torch.full_like(scores, -1.0)
        v = roi_valid & (scores > score_thresh)
        keep = nms_mod.greedy_nms(boxes, torch.where(v, scores, neg), v,
                                  nms_thresh, rotated=True)
        v = v & keep
        so, oid = nms_mod.topk_stable(torch.where(v, scores, neg),
                                      min(max_out, boxes.shape[0]))
        return boxes[oid], so, roi_labels[oid].to(torch.int32), v[oid]
