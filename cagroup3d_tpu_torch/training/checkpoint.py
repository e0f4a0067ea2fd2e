"""Checkpoint save/load: pickles of flat numpy dicts.

Counterpart of ``cagroup3d_tpu/training/checkpoint.py``.  ``params`` and
``state`` are the same flat ``{name: numpy array}`` dicts the JAX package
writes, so each package loads the other's weights (``CAGroup3D.
load_jax_params`` reads them).  ``opt_state`` here is the torch
optimizer's ``state_dict`` with its tensors as numpy arrays: it does not
load optax state, and the JAX package does not load it.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Optional

import numpy as np
import torch


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return tree


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    epoch: int = 0, it: int = 0) -> None:
    """Write model parameters/buffers (flat numpy dicts under the JAX
    package's names) and the optimizer's state, atomically."""
    ckpt = dict(params=_to_numpy(dict(model.named_parameters())),
                state=_to_numpy(dict(model.named_buffers())),
                opt_state=_to_numpy(optimizer.state_dict())
                if optimizer is not None else None,
                epoch=epoch, it=it, version="cagroup3d_tpu_torch+0.1.0")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(ckpt, f, protocol=4)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def restore(model, optimizer, ckpt: dict) -> None:
    """Load a checkpoint dict into the model (JAX-package pickles too) and,
    when it holds the port's optimizer state, into the optimizer."""
    model.load_jax_params(ckpt["params"], ckpt["state"])
    if optimizer is not None and ckpt.get("opt_state") is not None:
        sd = _to_torch(ckpt["opt_state"])
        optimizer.load_state_dict(sd)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    cands = glob.glob(os.path.join(ckpt_dir, "checkpoint_epoch_*.pkl"))
    if not cands:
        return None
    cands.sort(key=os.path.getmtime)
    return cands[-1]


def prune_checkpoints(ckpt_dir: str, keep: int = 5) -> None:
    cands = glob.glob(os.path.join(ckpt_dir, "checkpoint_epoch_*.pkl"))
    cands.sort(key=os.path.getmtime)
    for p in cands[:-keep] if keep > 0 else []:
        try:
            os.remove(p)
        except OSError:
            pass
