"""Datasets, their loader and evaluators (the pcdet surface).

The port's own copy of ``cagroup3d_tpu/datasets/__init__.py`` for the two
indoor datasets and KITTI (eval): ``DataLoader`` (rank slicing, shuffling
by ``seed + epoch``, a prefetch thread) and ``build_dataloader``.  The loader yields
the same padded numpy batches as the JAX package's; what the model reads
is moved to its device by the caller (``training/eval_utils.py``).
"""
from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator

import numpy as np

from .dataset import DatasetTemplate
from .kitti_dataset import KittiDataset
from .scannet_dataset import ScannetDataset
from .sunrgbd_dataset import SunrgbdDataset

PREFETCH = 2   # batches the loader's thread collates ahead
DATASETS = {"ScannetDataset": ScannetDataset,
            "SunrgbdDataset": SunrgbdDataset,
            "KittiDataset": KittiDataset}

__all__ = ["DataLoader", "DatasetTemplate", "KittiDataset", "ScannetDataset",
           "SunrgbdDataset", "build_dataloader"]


class DataLoader:
    """Batched, optionally shuffled, rank-sharded loader with prefetch.

    A background thread collates up to PREFETCH batches ahead.  An
    error in it is raised in the consumer, and a consumer that stops early
    stops the thread."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 rank=0, world_size=1, drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.world_size
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        idx = idx[self.rank::self.world_size]   # rank sharding
        # training: every rank len(self) batches (with len(dataset) % W
        # != 0 the first ranks hold one scene more, and a rank with an
        # extra batch would enter the step's collectives alone); eval
        # keeps every scene
        nb = len(self) if self.drop_last \
            else -(-len(idx) // self.batch_size)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(nb)]

    def __iter__(self) -> Iterator[dict]:
        batches = self._indices()
        q: queue_mod.Queue = queue_mod.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        done = object()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue_mod.Full:
                    continue

        def worker():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    items = [self.dataset[int(i)] for i in b]
                    put(self.dataset.collate_batch(items))
                put(done)
            except BaseException as e:   # re-raised in the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None,
                     seed=None, logger=None, training=True, rank=0,
                     world_size=1):
    """(dataset, loader, sampler): the sampler is the loader itself (rank
    slicing stands in for DistributedSampler)."""
    name = dataset_cfg.DATASET
    if name not in DATASETS:
        raise NotImplementedError(f"DATASET {name!r} is not ported "
                                  f"({', '.join(DATASETS)})")
    dataset = DATASETS[name](
        dataset_cfg=dataset_cfg, class_names=class_names,
        root_path=root_path, training=training, logger=logger)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=training,
                        seed=seed or 0, rank=rank, world_size=world_size,
                        drop_last=training)
    return dataset, loader, loader
