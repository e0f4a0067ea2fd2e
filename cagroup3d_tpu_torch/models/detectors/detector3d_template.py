"""Detector template for the outdoor voxel detectors: the module slots,
built from their registries by config ``NAME``, and what a model reads
from its dataset's config.

Counterpart of ``cagroup3d_tpu/models/detectors/detector3d_template.py``
(the reference's pcdet/models/detectors/detector3d_template.py) for the
slots the port has: ``vfe``, ``backbone_3d`` (None without a
``BACKBONE_3D``, as in PointPillar), ``map_to_bev_module``,
``backbone_2d``, ``dense_head`` and, with a ``ROI_HEAD``, ``roi_head``.
Channel counts flow from slot to slot, as pcdet's ``model_info_dict``
passes them.  Each slot is an ``nn.Module`` whose
parameters carry the JAX package's flat names under the slot's prefix.
A name the port does not have yet raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
import types
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.hashing import _MARGIN
from ...core.module import load_jax_params
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev import HeightCompression, PointPillarScatter
from ..backbones_3d.spconv_backbone import VoxelBackBone8x
from ..backbones_3d.vfe import MeanVFE, PillarVFE
from ..dense_heads.anchor_head import AnchorHeadSingle
from ..dense_heads.anchor_head_multi import AnchorHeadMulti
from ..dense_heads.center_head import CenterHead
from ..roi_heads.second_head import SECONDHead
from ..roi_heads.voxelrcnn_head import VoxelRCNNHead

VFES = {"MeanVFE": MeanVFE, "PillarVFE": PillarVFE}
BACKBONES_3D = {"VoxelBackBone8x": VoxelBackBone8x}
MAPS_TO_BEV = {"HeightCompression": HeightCompression,
               "PointPillarScatter": PointPillarScatter}
BACKBONES_2D = {"BaseBEVBackbone": BaseBEVBackbone}
DENSE_HEADS = {"AnchorHeadSingle": AnchorHeadSingle,
               "AnchorHeadMulti": AnchorHeadMulti, "CenterHead": CenterHead}
ROI_HEADS = {"SECONDHead": SECONDHead, "VoxelRCNNHead": VoxelRCNNHead}
DEFAULT_KEY_BITS = (10, 10, 10)
VOXEL_PROCESSORS = ("transform_points_to_voxels",
                    "transform_points_to_voxels_placeholder",
                    "calculate_grid_size")


def dataset_meta(data_cfg, class_names=None):
    """What a detector reads of a dataset (``point_cloud_range``,
    ``dataset_cfg``, ``class_names``), from its ``DATA_CONFIG`` alone."""
    return types.SimpleNamespace(
        dataset_cfg=data_cfg, class_names=class_names,
        point_cloud_range=np.array(data_cfg.POINT_CLOUD_RANGE, np.float32))


def _registry(table: dict, kind: str, name: str):
    if name not in table:
        raise NotImplementedError(f"{kind} {name!r} is not ported yet "
                                  f"({', '.join(table)})")
    return table[name]


def key_bits_for(grid_size, cur=DEFAULT_KEY_BITS):
    """Per-axis key bits a lattice of ``grid_size`` needs, widened from
    ``cur`` as the JAX package's ``SECONDNet`` widens the global bits; if
    that exceeds 30 bits, z shrinks to what the grid needs (KITTI's
    1408 x 1600 x 40 gives (11, 11, 8))."""
    need = [math.ceil(math.log2(g + 2 * _MARGIN)) for g in grid_size]
    bits = [max(n, c) for n, c in zip(need, cur)]
    if tuple(bits) != tuple(cur) and sum(bits) > 30:
        bits[2] = max(need[2], 30 - bits[0] - bits[1])
    return tuple(bits)


class Detector3DTemplate(nn.Module):
    def __init__(self, model_cfg, num_class: int, dataset=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.dataset = dataset
        self.class_names = getattr(dataset, "class_names", None)

    def _cfg(self, key):
        return self.model_cfg.get(key, None)

    def resolve_grid(self):
        """(point_cloud_range, voxel_size, grid_size): the model config's,
        else the dataset's (its voxelizing DATA_PROCESSOR's voxel size)."""
        pcr = self._cfg("POINT_CLOUD_RANGE")
        if pcr is None and self.dataset is not None:
            pcr = list(self.dataset.point_cloud_range)
        vs = self._cfg("VOXEL_SIZE")
        if vs is None and self.dataset is not None:
            for proc in self.dataset.dataset_cfg.get("DATA_PROCESSOR", []):
                if proc.get("NAME") in VOXEL_PROCESSORS:
                    vs = list(proc["VOXEL_SIZE"])
        if pcr is None or vs is None:
            raise ValueError("the point-cloud range and voxel size come from "
                             "MODEL or from the dataset config; neither has "
                             "them")
        pcr = [float(x) for x in pcr]
        vs = [float(x) for x in vs]
        grid = [int(round((pcr[3 + i] - pcr[i]) / vs[i])) for i in range(3)]
        return pcr, vs, grid

    def max_points_per_voxel(self) -> Optional[int]:
        """The dataset's MAX_POINTS_PER_VOXEL (static VFEs average only
        those first points of a voxel); None without a dataset."""
        if self.dataset is None:
            return None
        for proc in self.dataset.dataset_cfg.get("DATA_PROCESSOR", []):
            if proc.get("NAME") == "transform_points_to_voxels":
                return int(proc.get("MAX_POINTS_PER_VOXEL", 0)) or None
        return None

    def build_networks(self, gen: torch.Generator) -> None:
        c = self.model_cfg
        vfe_cfg = c.VFE
        self.vfe = _registry(VFES, "VFE", vfe_cfg.NAME)(
            vfe_cfg, num_point_features=int(vfe_cfg.get(
                "NUM_POINT_FEATURES", 4)),
            max_points_per_voxel=self.max_points_per_voxel(), generator=gen)
        self.backbone_3d = None
        if c.get("BACKBONE_3D", None) is not None:
            self.backbone_3d = _registry(
                BACKBONES_3D, "BACKBONE_3D", c.BACKBONE_3D.NAME)(
                c.BACKBONE_3D, input_channels=self.vfe.num_point_features,
                grid_size=self.grid_size, generator=gen)
        self.map_to_bev_module = _registry(
            MAPS_TO_BEV, "MAP_TO_BEV", c.MAP_TO_BEV.NAME)(c.MAP_TO_BEV)
        self.backbone_2d = _registry(
            BACKBONES_2D, "BACKBONE_2D", c.BACKBONE_2D.NAME)(
            c.BACKBONE_2D,
            input_channels=self.map_to_bev_module.num_bev_features,
            generator=gen)
        head = _registry(DENSE_HEADS, "DENSE_HEAD", c.DENSE_HEAD.NAME)
        kw = {"voxel_size": self.voxel_size} if getattr(
            head, "READS_VOXEL_SIZE", False) else {}
        self.dense_head = head(
            c.DENSE_HEAD, num_class=self.num_class,
            class_names=self.class_names, grid_size=self.grid_size,
            point_cloud_range=self.point_cloud_range,
            input_channels=self.backbone_2d.num_bev_features, generator=gen,
            post_cfg=c.get("POST_PROCESSING", None), **kw)
        if c.get("ROI_HEAD", None) is not None:
            self.roi_head = self.build_roi_head(gen)

    def build_roi_head(self, gen):
        """The RoI head of ``MODEL.ROI_HEAD`` over the 2-D backbone's map."""
        c = self.model_cfg.ROI_HEAD
        return _registry(ROI_HEADS, "ROI_HEAD", c.NAME)(
            c, num_class=self.num_class,
            input_channels=self.backbone_2d.num_bev_features, generator=gen)

    def load_jax_params(self, P, S=None) -> None:
        """``core.module.load_jax_params`` into this model."""
        load_jax_params(self, P, S)
