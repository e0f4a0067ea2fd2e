"""Observability: a rolling ``LogBuffer``, a JSONL ``MetricsWriter`` and a
profiler context.

Counterpart of ``cagroup3d_tpu/utils/metrics.py`` (the reference's
tensorboardX + LogBuffer): scalars go to a line-delimited JSON file and a
rolling average buffer drives console logging; ``profile_ctx`` writes a
``torch.profiler`` trace where the JAX package writes a jax.profiler one.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class LogBuffer:
    """Rolling averages of scalar outputs (reference log_buffer.py)."""

    def __init__(self):
        self.val_history = defaultdict(list)
        self.n_history = defaultdict(list)
        self.output = {}
        self.ready = False

    def update(self, vars: Dict[str, float], count: int = 1):
        for k, v in vars.items():
            self.val_history[k].append(float(v))
            self.n_history[k].append(count)

    def average(self, n: int = 0):
        for k in self.val_history:
            vals = self.val_history[k][-n:] if n > 0 else self.val_history[k]
            cnts = self.n_history[k][-n:] if n > 0 else self.n_history[k]
            tot = sum(cnts)
            self.output[k] = sum(v * c for v, c in zip(vals, cnts)) / max(
                tot, 1)
        self.ready = True

    def clear(self):
        self.val_history.clear()
        self.n_history.clear()
        self.output.clear()
        self.ready = False


class MetricsWriter:
    """Append-only JSONL scalar log (tensorboard stand-in)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = open(path, "a") if path else None

    def write(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        if self._f is None:
            return
        rec = {"step": step, "ts": time.time()}
        rec.update({(prefix + k): float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


@contextlib.contextmanager
def profile_ctx(trace_dir: Optional[str], device=None):
    """``torch.profiler`` over the wrapped region (the host, and the card's
    kernels when ``device`` is a CUDA device), written to
    ``trace_dir/trace.json`` (Chrome trace format); nothing when
    ``trace_dir`` is None."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
