"""Training CLI: the YAML's model, optimizer and loader on one card or, with
``--dist``, one process per card; one checkpoint per epoch, auto-resume
from the newest one.

Counterpart of the JAX package's ``tools/train.py`` (the reference's
tools/train.py), with its flags (but ``--steps_per_dispatch``, a TPU
workaround) and ``--device`` (default ``cuda``; a missing card is an
error).  Run from the repository root:

    python -m cagroup3d_tpu_torch.tools.train \\
        --cfg_file tools/cfgs/scannet_models/CAGroup3D.yaml \\
        --set DATA_CONFIG.DATA_PATH ../data/scannet

(SECOND on KITTI: ``--cfg_file tools/cfgs/kitti_models/second.yaml`` on a
tree with its infos and gt database, ``tools/create_infos``; one card.)

and on N cards of one host (each rank takes BATCH_SIZE_PER_GPU scenes a
step; together they take the step one process would take on N times as
many):

    torchrun --standalone --nproc_per_node N -m \\
        cagroup3d_tpu_torch.tools.train --dist --cfg_file ...

``--dist`` outside torchrun is an error.  ``CAGROUP_NAN_GUARD=1`` raises
on the first non-finite loss term or gradient, by name.

It writes ``output/<cfg group>/<cfg name>/<extra_tag>/``: ``ckpt/
checkpoint_epoch_<n>.pkl`` (flat numpy dicts that both packages'
``load_checkpoint`` read, with ``epoch`` and ``it``), a ``log_train_*.txt``
and ``metrics.jsonl`` (rank 0 writes them), and with ``--profile_dir`` a
``torch.profiler`` trace of the run there (rank 0's).  A second call with
more ``--epochs`` resumes from the newest checkpoint in ``ckpt/``.  Seeds
are fixed at 0.
"""
from __future__ import annotations

import argparse
import datetime
from pathlib import Path

import torch

from ..config import EasyDict, cfg_from_list, cfg_from_yaml_file
from ..datasets import build_dataloader
from ..models import build_network
from ..training.optimization import build_optimizer
from ..training.train_loop import auto_resume, train_model
from ..utils.commu_utils import init_dist
from ..utils.common_utils import create_logger, set_random_seed
from ..utils.metrics import profile_ctx


def parse_config(argv=None):
    """(args, cfg) from the command line (``argv``; ``sys.argv[1:]`` when
    None): the YAML with its ``--set KEY.PATH value`` overrides."""
    parser = argparse.ArgumentParser(description="arg parser")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="start from these weights (either package's "
                             "checkpoint)")
    parser.add_argument("--max_ckpt_save_num", type=int, default=5)
    parser.add_argument("--dist", action="store_true", default=False,
                        help="one process per card, under torchrun")
    parser.add_argument("--workers", type=int, default=4,
                        help="accepted for the reference's command lines: "
                             "the loader collates in one thread, so the "
                             "augmentor's draws keep their order")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace here (rank 0)")
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


def main(args, cfg):
    """Train ``cfg``'s model on its dataset's train split to ``args.epochs``
    (the YAML's NUM_EPOCHS when None), resuming from the newest checkpoint
    of the output's ``ckpt/``.  Returns the output directory."""
    device = torch.device(args.device)
    rank, world, group = 0, 1, None
    if args.dist:
        rank, world, local = init_dist(device.type)
        group = torch.distributed.group.WORLD
        if device.type == "cuda":
            device = torch.device("cuda", local)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port trains on the card "
                           "(--device cpu is for tests)")
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS

    output_dir = Path("output") / cfg.EXP_GROUP_PATH / cfg.TAG / \
        args.extra_tag
    ckpt_dir = output_dir / "ckpt"
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(
        output_dir / f"log_train_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt"
        if rank == 0 else None, rank=rank)
    logger.info(f"device: {device}, batch_size: {batch_size} a rank, "
                f"ranks: {world}")

    set_random_seed(0)
    dataset, train_loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
        batch_size=batch_size, logger=logger, training=True, rank=rank,
        world_size=world)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=device,
                          dataset=dataset)
    if args.ckpt is not None:
        model.load_jax_params(args.ckpt)
        logger.info(f"loaded {args.ckpt}")

    optimizer, _ = build_optimizer(model, cfg.OPTIMIZATION,
                                   max(len(train_loader), 1),
                                   total_epochs=epochs)
    start_epoch, start_it = auto_resume(str(ckpt_dir), model, optimizer,
                                        logger)

    logger.info("**********************Start training**********************")
    with profile_ctx(args.profile_dir if rank == 0 else None, device):
        train_model(model, optimizer, train_loader, epochs, str(ckpt_dir),
                    logger, start_epoch=start_epoch, start_it=start_it,
                    max_ckpt_save_num=args.max_ckpt_save_num,
                    generator=torch.Generator().manual_seed(0),
                    metrics_path=str(output_dir / "metrics.jsonl"),
                    device=device, group=group)
    logger.info("**********************End training**********************")
    return output_dir


if __name__ == "__main__":
    try:
        main(*parse_config())
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
