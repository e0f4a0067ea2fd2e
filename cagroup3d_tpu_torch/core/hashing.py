"""Coordinate key packing and sorted-array lookup.

Counterpart of ``cagroup3d_tpu/core/hashing.py``.  A 3-D lattice coordinate
packs into one int32 key (10 bits per axis after a ``_MARGIN`` shift, z the
least significant field); a coordinate set is indexed by sorting its keys
once, and "which row holds coordinate q?" is a binary search
(``torch.searchsorted``).  Invalid or out-of-range coordinates get
``INVALID_KEY``, which sorts after every packable key.

The bits are module-global, as in the JAX package.  A model whose lattice
needs other bits (SECOND on KITTI: (11, 11, 8)) holds them itself and
sets them only around its own forward with ``key_bits_scope``, so a
model built after it in the same process still packs at the defaults.
"""
from __future__ import annotations

import contextlib
import threading

import torch

XBITS, YBITS, ZBITS = 10, 10, 10
# slack for coordinates that go slightly negative (the dense head clamps
# votes to min_bound - stride)
_MARGIN = 8
INVALID_KEY = (1 << 30) + 1


def set_key_bits(x: int = 10, y: int = 10, z: int = 10) -> None:
    """Reconfigure per-axis key bits (before building a model)."""
    global XBITS, YBITS, ZBITS
    if not (x + y + z <= 30 and z >= 5):
        raise ValueError(f"bad key bits {(x, y, z)}")
    XBITS, YBITS, ZBITS = x, y, z


def key_bits():
    return (XBITS, YBITS, ZBITS)


_scope_lock = threading.RLock()


@contextlib.contextmanager
def key_bits_scope(bits):
    """Pack keys at ``bits`` (x, y, z) inside the block and restore the
    previous bits on exit.  The lock keeps another thread from packing at
    these bits meanwhile (the training step's scene threads run one model,
    so they share its bits)."""
    with _scope_lock:
        old = key_bits()
        set_key_bits(*bits)
        try:
            yield
        finally:
            set_key_bits(*old)


def key_shifts():
    return (YBITS + ZBITS, ZBITS)


def key_extents():
    return (1 << XBITS, 1 << YBITS, 1 << ZBITS)


def pack_coords(lat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Pack lattice coords i32[..., 3] into sortable int32 keys [...]."""
    shifted = lat.to(torch.int32) + _MARGIN
    ex, ey, ez = key_extents()
    sx, sy = key_shifts()
    x, y, z = shifted[..., 0], shifted[..., 1], shifted[..., 2]
    in_range = ((x >= 0) & (x < ex) & (y >= 0) & (y < ey) &
                (z >= 0) & (z < ez))
    key = (x << sx) | (y << sy) | z
    return torch.where(valid & in_range, key,
                       torch.full_like(key, INVALID_KEY))


def unpack_keys(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_coords for valid keys: i32[...] -> i32[..., 3]."""
    (ex, ey, ez), (sx, sy) = key_extents(), key_shifts()
    return torch.stack([(keys >> sx) & (ex - 1), (keys >> sy) & (ey - 1),
                        keys & (ez - 1)], dim=-1) - _MARGIN


def build_index(lat: torch.Tensor, valid: torch.Tensor):
    """(sorted_keys i32[..., N], row_of_rank i64[..., N]) over the last
    axis: keys ascending (stable, so equal keys keep row order), invalid
    rows last as INVALID_KEY."""
    keys = pack_coords(lat, valid)
    return torch.sort(keys, dim=-1, stable=True)


def lookup_keys(sorted_keys: torch.Tensor, row_of_rank: torch.Tensor,
                qk: torch.Tensor) -> torch.Tensor:
    """Row holding each query key (-1 when absent); 1-D tables."""
    pos = torch.searchsorted(sorted_keys, qk.reshape(-1))
    pos = pos.clamp(max=sorted_keys.shape[0] - 1)
    hit = (sorted_keys[pos] == qk.reshape(-1)) & (qk.reshape(-1) != INVALID_KEY)
    row = torch.where(hit, row_of_rank[pos], torch.full_like(pos, -1))
    return row.reshape(qk.shape)


def lower_bound_pos(sorted_keys: torch.Tensor, qk: torch.Tensor) -> torch.Tensor:
    """Index of the last key <= qk (-1 if none)."""
    return torch.searchsorted(sorted_keys, qk, right=True) - 1


def lookup(sorted_keys: torch.Tensor, row_of_rank: torch.Tensor,
           query_lat: torch.Tensor, query_valid: torch.Tensor) -> torch.Tensor:
    """Row index of each query coordinate i32[..., 3] in an index built by
    build_index over a duplicate-free coordinate set; -1 when absent."""
    return lookup_keys(sorted_keys, row_of_rank,
                       pack_coords(query_lat, query_valid))
