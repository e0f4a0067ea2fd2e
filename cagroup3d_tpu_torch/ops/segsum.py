"""K2: sorted-run segment sums (the dense head's per-class fine maps).

Replaces the TPU kernel ``cagroup3d_tpu/ops/pallas_segsum.py::_segsum_kernel``
(launched by ``sorted_segment_sums``).  Per group, over key-sorted rows:
the f32 sums of the bf16 feature rows and the row count of each run of
equal keys, for the first ``cap`` runs in key order; rows with
``INVALID_KEY`` (sorted last) are ignored.

The CUDA kernel is ``csrc/segsum.cu`` (a head-count pass and a
per-run reduce pass over row tiles; no float atomics, so two calls give
the same bits); ``segment_sums_plain`` is its plain PyTorch version, used
for CPU tensors and as the reference on the card.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.hashing import INVALID_KEY
from . import build


def segment_sums_plain(sk: torch.Tensor, feats_s: torch.Tensor, cap: int):
    """sk i32[G, P] sorted keys, feats_s [G, P, F] -> (sums f32[G, cap, F],
    counts i32[G, cap]).  Run detection without a sort, then index_add_."""
    G, P = sk.shape
    F = feats_s.shape[-1]
    dev = sk.device
    head = torch.ones_like(sk, dtype=torch.bool)
    head[:, 1:] = sk[:, 1:] != sk[:, :-1]
    ok = sk != INVALID_KEY
    uid = torch.cumsum((head & ok).to(torch.int32), 1, dtype=torch.int32) - 1
    keep = ok & (uid < cap)
    base = (torch.arange(G, device=dev, dtype=torch.int32) * (cap + 1))[:, None]
    seg = (torch.where(keep, uid, torch.full_like(uid, cap)) + base
           ).reshape(-1).long()
    sums = torch.zeros(G * (cap + 1), F, dtype=torch.float32, device=dev)
    sums.index_add_(0, seg, feats_s.reshape(-1, F).to(torch.float32))
    cnt = torch.zeros(G * (cap + 1), dtype=torch.int32, device=dev)
    cnt.index_add_(0, seg, keep.reshape(-1).to(torch.int32))
    return (sums.reshape(G, cap + 1, F)[:, :cap],
            cnt.reshape(G, cap + 1)[:, :cap])


_MAX_F = 256


def k2_plan(G: int, P: int) -> dict:
    """K2's launch shape: rows per block and blocks per pass (from the
    built kernel)."""
    tile = build.load("segsum").segsum_tile_rows()
    return {"tile_rows": tile, "blocks_per_pass": G * -(-P // tile)}


def segment_sums(sk: torch.Tensor, feats_s: torch.Tensor, cap: int):
    """Per-group segment sums/counts over key-sorted rows (see module
    docstring).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if sk.device.type == "cpu":
        return segment_sums_plain(sk, feats_s, cap)
    if sk.device.type != "cuda":
        raise ValueError(f"segment_sums: no kernel for device {sk.device}")
    G, P = sk.shape
    F = feats_s.shape[-1]
    if sk.dtype != torch.int32 or feats_s.dtype != torch.bfloat16:
        raise TypeError(f"segment_sums wants i32 keys and bf16 rows, got "
                        f"{sk.dtype} / {feats_s.dtype}")
    if feats_s.shape[:2] != (G, P) or feats_s.device != sk.device:
        raise ValueError(f"shape/device mismatch: {tuple(sk.shape)} vs "
                         f"{tuple(feats_s.shape)}")
    if not (sk.is_contiguous() and feats_s.is_contiguous()):
        raise ValueError("segment_sums needs contiguous inputs")
    if not 0 < F <= _MAX_F or cap <= 0 or P == 0:
        raise ValueError(f"unsupported F={F} or cap={cap}")
    lib = build.load("segsum")
    scratch = lib.segsum_scratch
    scratch.argtypes = [ctypes.c_int] * 2
    scratch.restype = ctypes.c_longlong
    fn = lib.segsum_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every run < cap is written by the kernel, zeros included
    sums = torch.empty(G, cap, F, dtype=torch.float32, device=sk.device)
    counts = torch.empty(G, cap, dtype=torch.int32, device=sk.device)
    heads = torch.empty(scratch(G, P), dtype=torch.int32, device=sk.device)
    stream = torch.cuda.current_stream(sk.device).cuda_stream
    err = fn(sk.data_ptr(), feats_s.data_ptr(), sums.data_ptr(),
             counts.data_ptr(), heads.data_ptr(), G, P, F, cap, stream)
    build.check(err, "segsum")
    segment_sums.launches += 1
    return sums, counts


segment_sums.launches = 0
