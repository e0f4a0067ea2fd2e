"""Training loop (rebuild of the reference's tools/train_utils/
train_utils.py): epoch loop with per-iteration timing meters, logging,
checkpoint save/prune and auto-resume.

Counterpart of ``cagroup3d_tpu/training/train_loop.py``.  One optimizer
step per batch (``parallel/mesh.make_train_step``); the model runs on the
GPU unless the caller passes another device.  With a process ``group``
(``--dist``) every rank must take the same number of steps an epoch (a
rank with one batch more would enter a collective alone: the rank-sharded
loader gives each rank ``len(loader)`` training batches), and only rank 0
writes the checkpoints and ``metrics.jsonl``; the others wait for each
save at a barrier.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import make_train_step
from ..utils.commu_utils import barrier, group_rank
from ..utils.metrics import LogBuffer, MetricsWriter
from .checkpoint import (latest_checkpoint, load_checkpoint,
                         prune_checkpoints, restore, save_checkpoint)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = self.avg = 0.0

    def update(self, v, n=1):
        self.val = v
        self.sum += v * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def _to_device(batch_np, device):
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch_np.items() if k != "frame_id"}


def train_model(model, optimizer, train_loader, total_epochs: int,
                ckpt_dir: str, logger, start_epoch: int = 0,
                start_it: int = 0, max_ckpt_save_num: int = 5,
                log_interval: int = 50, generator=None,
                metrics_path: Optional[str] = None, device=None, group=None):
    """Train ``model`` with ``optimizer`` (``training.optimization.
    Optimizer``) over ``train_loader`` (iterable of numpy batch dicts with
    ``set_epoch``; this rank's shard with a process ``group``); one
    checkpoint per epoch.  Returns the iteration count."""
    device = torch.device("cuda") if device is None else device
    step = make_train_step(model, optimizer, generator, device=device,
                           group=group)
    rank0 = group_rank(group) == 0
    it = start_it
    metrics = MetricsWriter(metrics_path if rank0 else None)
    log_buffer = LogBuffer()
    for epoch in range(start_epoch, total_epochs):
        train_loader.set_epoch(epoch)
        data_meter, batch_meter = AverageMeter(), AverageMeter()
        t_end = time.time()
        for batch_np in train_loader:
            data_time = time.time() - t_end
            loss, tb = step(_to_device(batch_np, device), float(epoch))
            it += 1
            batch_time = time.time() - t_end
            t_end = time.time()
            data_meter.update(data_time)
            batch_meter.update(batch_time)
            if it % log_interval == 0 or it == 1:
                loss_v = float(loss)                  # host sync point
                lr = optimizer.schedule(it)
                tb_s = {k: round(float(v), 4) for k, v in tb.items()}
                log_buffer.update(tb_s)
                log_buffer.average(log_interval)
                metrics.write(it, dict(loss=loss_v, lr=lr, **tb_s),
                              prefix="train/")
                logger.info(
                    f"epoch {epoch} it {it} loss {loss_v:.4f} lr {lr:.2e} "
                    f"d_time {data_meter.avg:.3f} b_time {batch_meter.avg:.3f} "
                    f"{log_buffer.output}")
        path = os.path.join(ckpt_dir, f"checkpoint_epoch_{epoch + 1}.pkl")
        if rank0:
            os.makedirs(ckpt_dir, exist_ok=True)
            save_checkpoint(path, model, optimizer, epoch + 1, it)
            prune_checkpoints(ckpt_dir, keep=max_ckpt_save_num)
            logger.info(f"saved {path}")
        barrier(group)
    metrics.close()
    return it


def auto_resume(ckpt_dir: str, model, optimizer, logger):
    """Restore the newest checkpoint of ``ckpt_dir`` into model and
    optimizer; returns (start_epoch, start_it), (0, 0) when there is
    none."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return 0, 0
    ckpt = load_checkpoint(path)
    logger.info(f"auto-resuming from {path} (epoch {ckpt['epoch']})")
    restore(model, optimizer, ckpt)
    return ckpt["epoch"], ckpt["it"]
