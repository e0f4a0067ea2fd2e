"""Cross-process communication for training and evaluation on several cards.

Counterpart of ``cagroup3d_tpu/utils/commu_utils.py`` (the reference's
pcdet/utils/commu_utils.py) over ``torch.distributed``: one process per
card, started by torchrun, which describes the group in the environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``).  NCCL joins the ranks on the card, gloo on the CPU (the
tests).  Every collective pairs up by the order the ranks issue it in,
so the callers issue them in an order every rank shares.

The training step's functions (``group_size``, ``global_sum``,
``global_mean``, ``broadcast_tensors``, ``average_grads``, ``barrier``)
treat ``group=None`` as one process and communicate with nobody; the
host-side ones (``all_gather``, ``reduce_dict``, ``average_reduce_value``,
``merge_results_dist``) read the default group then, as ``get_rank`` /
``get_world_size`` do (0 / 1 before ``init_dist``).
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# a rank that waits this long in a collective raises instead of hanging
TIMEOUT_S = 600.0
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def group_size(group) -> int:
    """Ranks of ``group``; 1 for ``None`` (one process)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def init_dist(device_type: str = "cuda", timeout_s: float = TIMEOUT_S):
    """Join the process group that torchrun's environment describes: NCCL
    for ``cuda`` (this rank on card ``LOCAL_RANK``), gloo for ``cpu``;
    a collective that waits ``timeout_s`` raises.  Returns (rank,
    world_size, local_rank).  Without torchrun's environment it raises:
    ``--dist`` never falls back to one process."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--dist needs torchrun's environment ({', '.join(missing)} "
            f"unset): launch with torchrun --nproc_per_node N -m "
            f"cagroup3d_tpu_torch.tools.<train|test> --dist ...")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card "
                               "(--device cpu is for tests)")
        torch.cuda.set_device(local)
    if not _initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", init_method="env://",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world, local


def barrier(group=None) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)


def global_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The element-wise sum of ``t`` over the ranks of ``group`` (``t``
    itself for one process); not differentiable, for loss normalizers."""
    if group_size(group) == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def global_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of the per-scene values x [b] over the W * b scenes of the
    step's ranks (``x.mean()`` for one process)."""
    w = group_size(group)
    if w == 1:
        return x.mean()
    return global_sum(x.sum(), group) / (w * x.shape[0])


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0,
                      group=None) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, one
    collective per dtype."""
    if group_size(group) == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=src, group=group)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))


def average_grads(params: Sequence[torch.Tensor], group=None) -> None:
    """Replace every gradient by its mean over the ranks, in one
    collective over a flat buffer.  A parameter without a gradient on a
    rank counts as zero there, and keeps none only where no rank has one
    (the optimizer then skips it on every rank)."""
    w = group_size(group)
    if w == 1:
        return
    params = list(params)
    dev = params[0].device
    has = torch.tensor([float(p.grad is not None) for p in params],
                       device=dev)
    flat = torch.cat([(p.grad if p.grad is not None else
                       torch.zeros_like(p)).reshape(-1).float()
                      for p in params] + [has])
    dist.all_reduce(flat, group=group)
    flat[:-len(params)] /= w
    vals = flat[:-len(params)].split([p.numel() for p in params])
    for p, v, n in zip(params, vals, flat[-len(params):].tolist()):
        p.grad = v.view_as(p).to(p.dtype) if n > 0 else None


def all_gather(data: Any, group=None) -> List[Any]:
    """The picklable ``data`` of every rank, in rank order."""
    w = group_size(group) if group is not None else get_world_size()
    if w == 1:
        return [data]
    out: List[Any] = [None] * w
    dist.all_gather_object(out, data, group=group)
    return out


def reduce_dict(d: Dict[str, float], average: bool = True,
                group=None) -> Dict[str, float]:
    """Per key of any rank, the mean (or with ``average=False`` the sum) of
    the ranks' scalars, a rank without the key counting 0."""
    gathered = all_gather({k: float(v) for k, v in d.items()}, group)
    keys = sorted({k for g in gathered for k in g})
    red = {k: sum(g.get(k, 0.0) for g in gathered) for k in keys}
    return {k: v / len(gathered) for k, v in red.items()} if average \
        else red


def average_reduce_value(value: float, group=None) -> float:
    """The mean of a python scalar over the ranks."""
    return reduce_dict({"v": value}, group=group)["v"]


def merge_results_dist(results: List[Any], total_size: Optional[int] = None,
                       group=None) -> List[Any]:
    """Every rank's result list merged in the rank-sharded loader's order
    (rank r held items r, r + W, ...): interleaved by rank, then cut to
    ``total_size``."""
    gathered = all_gather(results, group)
    merged: List[Any] = []
    for i in range(max(len(g) for g in gathered)):
        for g in gathered:
            if i < len(g):
                merged.append(g[i])
    if total_size is not None:
        merged = merged[:total_size]
    return merged
