"""Reading per-scene point files into fixed-shape batches: the host C++
library ``csrc/dataio.cpp`` through ctypes, or numpy where it cannot be
built.

Counterpart of ``cagroup3d_tpu/datasets/native_io.py`` with its API
(``available()``, ``load_batch``) and semantics: up to the cap a scene's
rows are copied exactly, above it a draw of distinct rows (a partial
Fisher-Yates shuffle a scene in the library, ``RandomState.choice`` in
numpy: the two paths draw other rows), and a file that cannot be read
raises ``IOError``.  The library is the port's copy of the JAX package's,
built at first use by ``ops/build.load_host`` into ``.kernel_build/``
(nothing is written into ``csrc/``).  Which path the process takes is
decided once, logged once and returned by ``io_path()``: "native", or
"numpy" with the reason (``fallback_reason()``), so a caller that needs
the library can fail instead of running on numpy unnoticed.

``read_points(path, cap)`` reads a scene's first ``cap`` rows (the
library's ``load_bin_f32``; the ``demo`` CLI's ``.bin`` scenes).
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..ops import build

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_state = {"decided": False, "lib": None, "reason": None}

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_STRS = ctypes.POINTER(ctypes.c_char_p)


def _load():
    """The bound library, or None (numpy) once building or loading it has
    failed; decided and logged on the first call."""
    with _lock:
        if _state["decided"]:
            return _state["lib"]
        _state["decided"] = True
        try:
            lib = build.load_host("dataio")
            lib.load_bin_f32.restype = ctypes.c_long
            lib.load_bin_f32.argtypes = [ctypes.c_char_p, _F32P,
                                         ctypes.c_long, ctypes.c_long]
            lib.load_batch.restype = ctypes.c_long
            lib.load_batch.argtypes = [_STRS, _STRS, _STRS, ctypes.c_long,
                                       ctypes.c_long, _F32P, _U8P, _I32P,
                                       _I32P, ctypes.c_uint64]
            _state["lib"] = lib
            _log.info("native_io: reading point files with the C++ "
                      "library (csrc/dataio.cpp)")
        except (RuntimeError, OSError) as e:
            _state["reason"] = str(e).splitlines()[0] if str(e) else repr(e)
            _log.warning(f"native_io: the C++ library is unavailable "
                         f"({_state['reason']}); reading with numpy")
        return _state["lib"]


def available() -> bool:
    """Whether the C++ library is built and loaded (builds it on the first
    call)."""
    return _load() is not None


def io_path() -> str:
    """"native" (the C++ library) or "numpy": the path every read of this
    process takes."""
    return "native" if available() else "numpy"


def fallback_reason() -> Optional[str]:
    """Why the library could not be used (None on the native path)."""
    _load()
    return _state["reason"]


def read_points(path: str, cap: int) -> Tuple[np.ndarray, int]:
    """The first ``cap`` rows of the float32 file ``path`` of 6 columns,
    zero-padded: ([cap, 6] float32, rows read).  A file whose size is not
    a whole number of rows raises ``ValueError``, as numpy's reshape does;
    one that cannot be read raises ``IOError``."""
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise IOError(f"cannot read {path}: {e}") from e
    if size % (4 * 6):
        raise ValueError(f"{path}: {size} bytes are not whole rows of 6 "
                         f"float32")
    out = np.zeros((cap, 6), np.float32)
    lib = _load()
    if lib is None:
        pts = np.fromfile(path, np.float32, count=cap * 6).reshape(-1, 6)
        out[:len(pts)] = pts
        return out, len(pts)
    n = lib.load_bin_f32(path.encode(), out.ctypes.data_as(_F32P), cap, 6)
    if n < 0:
        raise IOError(f"native load_bin_f32 could not read {path}")
    return out, int(n)


def load_batch(point_paths: List[str], point_cap: int,
               ins_paths: Optional[List[str]] = None,
               sem_paths: Optional[List[str]] = None,
               seed: int = 0):
    """Read, subsample and pad B scenes.  Returns (points [B, P, 6] f32,
    valid [B, P] bool, ins i32[B, P] or None, sem i32[B, P] or None)."""
    lib = _load()
    B = len(point_paths)
    points = np.zeros((B, point_cap, 6), np.float32)
    valid = np.zeros((B, point_cap), np.uint8)
    ins = np.zeros((B, point_cap), np.int32) if ins_paths else None
    sem = np.zeros((B, point_cap), np.int32) if sem_paths else None
    if lib is None:
        return _load_batch_numpy(point_paths, point_cap, ins_paths,
                                 sem_paths, seed, points, valid, ins, sem)

    def carr(paths):
        if paths is None:
            return None
        return (ctypes.c_char_p * B)(*[p.encode() for p in paths])

    ok = lib.load_batch(
        carr(point_paths), carr(ins_paths), carr(sem_paths), B, point_cap,
        points.ctypes.data_as(_F32P), valid.ctypes.data_as(_U8P),
        ins.ctypes.data_as(_I32P) if ins is not None else None,
        sem.ctypes.data_as(_I32P) if sem is not None else None, seed)
    if ok != B:
        raise IOError(f"native load_batch read {ok}/{B} scenes")
    return points, valid.astype(bool), ins, sem


def _load_batch_numpy(point_paths, point_cap, ins_paths, sem_paths, seed,
                      points, valid, ins, sem):
    """``load_batch`` on a host without the library (the JAX module's
    numpy path)."""
    rng = np.random.RandomState(seed)
    for b, p in enumerate(point_paths):
        pts = np.fromfile(p, np.float32).reshape(-1, 6)
        n = len(pts)
        ins_b = np.fromfile(ins_paths[b], np.int64).astype(np.int32) \
            if ins_paths else None
        sem_b = np.fromfile(sem_paths[b], np.int64).astype(np.int32) \
            if sem_paths else None
        if n > point_cap:
            ch = rng.choice(n, point_cap, replace=False)
            pts = pts[ch]
            ins_b = ins_b[ch] if ins_b is not None else None
            sem_b = sem_b[ch] if sem_b is not None else None
            n = point_cap
        points[b, :n] = pts
        valid[b, :n] = 1
        if ins_b is not None:
            ins[b, :n] = ins_b[:n]
        if sem_b is not None:
            sem[b, :n] = sem_b[:n]
    return points, valid.astype(bool), ins, sem
