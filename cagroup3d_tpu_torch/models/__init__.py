"""Model builders (pcdet surface): ``build_network`` and the YAML loader."""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..config import EasyDict, cfg_from_yaml_file
from .detectors.cagroup3d import CAGroup3D
from .detectors.centerpoint import CenterPoint
from .detectors.rbgnet import RBGNet
from .detectors.second_net import PointPillar, SECONDNet
from .detectors.second_net_iou import SECONDNetIoU

DETECTORS = {"CAGroup3D": CAGroup3D, "RBGNet": RBGNet,
             "SECONDNet": SECONDNet, "PointPillar": PointPillar,
             "SECONDNetIoU": SECONDNetIoU, "CenterPoint": CenterPoint}


def load_model_config(cfg_path: str):
    """(model_cfg, class_names) of a repository YAML (``_BASE_CONFIG_``
    includes resolved)."""
    cfg = cfg_from_yaml_file(cfg_path, EasyDict())
    return cfg.MODEL, list(cfg.CLASS_NAMES)


def load_config(cfg_path: str) -> EasyDict:
    """The whole YAML (``MODEL``, ``OPTIMIZATION``, ``CLASS_NAMES``, ...)."""
    return cfg_from_yaml_file(cfg_path, EasyDict())


def build_network(model_cfg, num_class: int,
                  generator: Optional[torch.Generator] = None,
                  device=None, dataset=None
                  ) -> Union[CAGroup3D, RBGNet, SECONDNet]:
    """Build the detector named by ``model_cfg.NAME`` (CAGroup3D, RBGNet,
    SECONDNet, PointPillar, SECONDNetIoU or CenterPoint) with a seeded init
    (``generator``; seed 0 when None) on
    ``device`` (the GPU unless the caller passes another device; there is
    no CPU fallback).  ``dataset`` (a dataset, or
    ``detectors.detector3d_template.dataset_meta`` of its config) gives the
    outdoor detectors what they read of the data: the point-cloud range,
    the voxel size and the VFE's points per voxel."""
    if model_cfg.NAME not in DETECTORS:
        raise NotImplementedError(f"{model_cfg.NAME} is not ported yet")
    device = torch.device("cuda") if device is None else device
    cls = DETECTORS[model_cfg.NAME]
    kw = {"dataset": dataset} if getattr(cls, "READS_DATASET", False) else {}
    return cls(model_cfg, num_class, generator, **kw).to(device)
