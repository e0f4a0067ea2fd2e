"""Logger, seeding and process info for the CLIs: the port's own copies of
``create_logger``, ``set_random_seed`` and ``get_dist_info`` from
``cagroup3d_tpu/utils/common_utils.py`` (the reference's
pcdet/utils/common_utils.py)."""
from __future__ import annotations

import logging
import random

import numpy as np
import torch

from .commu_utils import get_rank, get_world_size


def create_logger(log_file=None, rank: int = 0):
    """A logger that writes to the console and, when given, ``log_file``:
    at INFO on rank 0, errors only on the other ranks."""
    logger = logging.getLogger("cagroup3d_tpu_torch")
    logger.setLevel(logging.INFO if rank == 0 else logging.ERROR)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    console = logging.StreamHandler()
    console.setFormatter(formatter)
    logger.addHandler(console)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def set_random_seed(seed: int) -> None:
    """Seed ``random`` and numpy's global generator, as the JAX package
    does (the augmentor draws from them, so its draws equal the JAX
    package's), and torch's default generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_dist_info():
    """(rank, world size) of this process (0, 1 without ``--dist``)."""
    return get_rank(), get_world_size()
