"""Logger for the CLIs: the port's own copy of ``create_logger`` from
``cagroup3d_tpu/utils/common_utils.py`` (the reference's
pcdet/utils/common_utils.py)."""
from __future__ import annotations

import logging


def create_logger(log_file=None):
    """A logger at INFO that writes to the console and, when given,
    ``log_file``."""
    logger = logging.getLogger("cagroup3d_tpu_torch")
    logger.setLevel(logging.INFO)
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
