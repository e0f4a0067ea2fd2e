"""Synthetic ScanNet-style scenes as model inputs on a device.

Wraps the JAX package's numpy generator (``cagroup3d_tpu.utils.synthetic``,
which imports no JAX) so both packages see the same points for a seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cagroup3d_tpu.utils.synthetic import synthetic_batch


def synthetic_request(seed: int, device, n_points: int = 100_000,
                      **kw) -> Dict[str, torch.Tensor]:
    """One scene as a ``forward_eval`` batch: points f32[1, n_points, 6]
    (xyz, rgb 0..255) and points_valid bool[1, n_points] on ``device``.
    Extra keywords (``room``, ``n_objects``) go to ``synthetic_batch``."""
    b = synthetic_batch(np.random.RandomState(seed), batch_size=1,
                        n_points=n_points, point_cap=n_points, **kw)
    return {k: torch.from_numpy(b[k]).to(device)
            for k in ("points", "points_valid")}
