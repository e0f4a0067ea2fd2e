"""Model builders (pcdet surface): ``build_network`` and the YAML loader."""
from __future__ import annotations

from typing import Optional

import torch

from .detectors.cagroup3d import CAGroup3D


def load_model_config(cfg_path: str):
    """(model_cfg, class_names) of a repository YAML, through the JAX
    package's config loader (``_BASE_CONFIG_`` includes resolved)."""
    from cagroup3d_tpu.config import EasyDict, cfg_from_yaml_file
    cfg = cfg_from_yaml_file(cfg_path, EasyDict())
    return cfg.MODEL, list(cfg.CLASS_NAMES)


def build_network(model_cfg, num_class: int,
                  generator: Optional[torch.Generator] = None,
                  device="cpu") -> CAGroup3D:
    """Build the detector named by ``model_cfg.NAME`` with a seeded init
    (``generator``; seed 0 when None) on ``device``."""
    if model_cfg.NAME != "CAGroup3D":
        raise NotImplementedError(f"{model_cfg.NAME} is not ported yet")
    return CAGroup3D(model_cfg, num_class, generator).to(device)
