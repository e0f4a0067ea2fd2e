"""Evaluation CLI: one checkpoint, or every checkpoint of a directory as it
appears (``--eval_all``), over a dataset's val split on one card or, with
``--dist`` under torchrun, one process per card (each rank runs its shard
of the scenes; rank 0 merges them in the dataset's order and evaluates).

Counterpart of the JAX package's ``tools/test.py`` (the reference's
tools/test.py), with the same flags and ``--device`` (default ``cuda``; a
missing card is an error).  Run from the repository root:

    python -m cagroup3d_tpu_torch.tools.test \\
        --cfg_file tools/cfgs/scannet_models/CAGroup3D.yaml \\
        --ckpt output/.../checkpoint_epoch_10.pkl \\
        --set DATA_CONFIG.DATA_PATH ../data/scannet

It reads checkpoints written by either package (pickled flat numpy dicts
under the same names), prints the dataset's evaluation (indoor: the
per-class AP/AR table and mAP@0.25/0.50; KITTI, e.g. ``--cfg_file
tools/cfgs/kitti_models/second.yaml``: the official R11/R40 table), and
writes ``result.pkl`` under ``output/<cfg group>/<cfg name>/
<extra_tag>/eval/``.  On N cards:

    torchrun --standalone --nproc_per_node N -m \\
        cagroup3d_tpu_torch.tools.test --dist --cfg_file ... --ckpt ...

``--dist`` outside torchrun is an error.
"""
from __future__ import annotations

import argparse
import datetime
import glob
import os
import re
import time
from pathlib import Path

import torch

from ..config import EasyDict, cfg_from_list, cfg_from_yaml_file
from ..datasets import build_dataloader
from ..models import build_network
from ..training.checkpoint import load_checkpoint
from ..training.eval_utils import eval_one_epoch
from ..utils.commu_utils import all_gather, init_dist
from ..utils.common_utils import create_logger


def parse_config(argv=None):
    """(args, cfg) from the command line (``argv``; ``sys.argv[1:]`` when
    None): the YAML with its ``--set KEY.PATH value`` overrides."""
    parser = argparse.ArgumentParser(description="arg parser")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--dist", action="store_true", default=False,
                        help="one process per card, under torchrun")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--eval_all", action="store_true", default=False)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--max_waiting_mins", type=int, default=30)
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the model (tests pass cpu)")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = cfg_from_yaml_file(args.cfg_file, EasyDict())
    cfg.TAG = Path(args.cfg_file).stem
    cfg.EXP_GROUP_PATH = "/".join(args.cfg_file.split("/")[1:-1])
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def _epoch(path) -> int:
    return int(re.findall(r"epoch_(\d+)", str(path))[-1])


def eval_ckpt(cfg, ckpt_path, model, dataset, loader, logger, result_dir,
              epoch_id, dist=False):
    ck = load_checkpoint(ckpt_path)
    model.load_jax_params(ck["params"], ck["state"])
    logger.info(f"loaded {ckpt_path} (epoch {ck.get('epoch')})")
    return eval_one_epoch(model, dataset, loader, epoch_id, logger,
                          result_dir=result_dir, class_names=cfg.CLASS_NAMES,
                          dist=dist)


def main(args, cfg):
    """Evaluate ``args.ckpt``, or with ``args.eval_all`` every
    ``checkpoint_epoch_*.pkl`` of the checkpoint directory past
    ``start_epoch`` in epoch order, waiting up to ``max_waiting_mins``
    for new ones.  Returns {checkpoint path: evaluation dict} (with
    ``--dist``, {} on every rank but 0)."""
    device = torch.device(args.device)
    rank, world = 0, 1
    if args.dist:
        rank, world, local = init_dist(device.type)
        if device.type == "cuda":
            device = torch.device("cuda", local)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port evaluates on the card "
                           "(--device cpu is for tests)")
    if not args.eval_all and args.ckpt is None:
        raise ValueError("--ckpt is required without --eval_all")

    output_dir = Path("output") / cfg.EXP_GROUP_PATH / cfg.TAG / \
        args.extra_tag
    eval_dir = output_dir / "eval"
    eval_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(
        eval_dir / f"log_eval_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt"
        if rank == 0 else None, rank=rank)

    dataset, loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
        batch_size=args.batch_size or 1, logger=logger, training=False,
        rank=rank, world_size=world)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=device,
                          dataset=dataset)
    model.eval()

    results = {}
    if not args.eval_all:
        results[args.ckpt] = eval_ckpt(
            cfg, args.ckpt, model, dataset, loader, logger, eval_dir,
            epoch_id=cfg.OPTIMIZATION.NUM_EPOCHS, dist=args.dist)
        return results if rank == 0 else {}
    ckpt_dir = Path(args.ckpt_dir or (output_dir / "ckpt"))
    wait_start = time.time()
    while True:
        todo = sorted((c for c in glob.glob(str(
            ckpt_dir / "checkpoint_epoch_*.pkl")) if c not in results and
            _epoch(c) > args.start_epoch), key=_epoch)
        stop = not todo and \
            time.time() - wait_start >= args.max_waiting_mins * 60
        if args.dist:        # rank 0's view, so the ranks evaluate alike
            todo, stop = all_gather((todo, stop))[0]
        if stop:
            break
        if not todo:
            time.sleep(30)
            continue
        for c in todo:
            epoch_id = _epoch(c)
            results[c] = eval_ckpt(cfg, c, model, dataset, loader, logger,
                                   eval_dir / f"epoch_{epoch_id}", epoch_id,
                                   dist=args.dist)
        wait_start = time.time()
    return results if rank == 0 else {}


if __name__ == "__main__":
    try:
        main(*parse_config())
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
