"""K1: sparse convolution over key-indexed voxel tables.

Replaces the TPU kernel ``cagroup3d_tpu/ops/pallas_conv.py::_conv_kernel``
(``_pallas_forward``, reached through ``subm_conv_classes_mxu``,
``subm_conv_mxu`` and ``conv_at_coords_mxu``).  Per group g and query q:

    out[g, q] = sum_{o in K^3} feats[g, row(lat(q) + o)] @ w[g % Gw, o]

with o over ``kernel_offsets(K)`` (x-major, z fastest; odd K), rows looked
up by packed key among the group's valid source rows, missing neighbours
adding nothing and invalid queries giving zero rows.  Features and weights
are rounded to bf16 and accumulated in f32, as on the TPU.

Source contract, the Pallas kernel's: each group's source rows are sorted
by packed key with invalid rows last, so a key's rank is its row.  Every
source table of the main path comes out of ``unique_voxels`` or the
head's segment-sum maps in that order (``sources_sorted`` checks it).
Queries may come in any order.

The CUDA kernel is ``csrc/sparse_conv.cu``; ``sparse_conv_plain`` is its
plain PyTorch version, used for CPU tensors and as the reference on the
card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.hashing import INVALID_KEY, key_extents, key_shifts, pack_coords
from ..core.kernel_maps import kernel_offsets
from ..core.sparse import bf16_round, zero_invalid
from . import build


def sparse_conv_plain(src_lat: torch.Tensor, src_valid: torch.Tensor,
                      src_feats: torch.Tensor, w: torch.Tensor,
                      kernel_size: int, qry_lat: Optional[torch.Tensor] = None,
                      qry_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: per offset, a binary search in the sorted source
    keys, a masked row gather and a batched matmul accumulated into the
    output (never [K^3, N, C])."""
    G, N, C = src_feats.shape
    if qry_lat is None:
        qry_lat, qry_valid = src_lat, src_valid
    NQ = qry_lat.shape[1]
    Gw, _, _, Cout = w.shape
    dev = src_feats.device
    sk = pack_coords(src_lat, src_valid)                           # [G, N]
    feats = bf16_round(zero_invalid(src_feats, src_valid))
    wg = bf16_round(w)[torch.arange(G, device=dev) % Gw]          # [G, K3, C, O]
    out = torch.zeros(G, NQ, Cout, dtype=torch.float32, device=dev)
    offs = torch.as_tensor(kernel_offsets(kernel_size), device=dev)
    for o in range(offs.shape[0]):
        qk = pack_coords(qry_lat + offs[o], qry_valid)             # [G, NQ]
        pos = torch.searchsorted(sk, qk).clamp(max=N - 1)
        hit = (torch.gather(sk, 1, pos) == qk) & (qk != INVALID_KEY)
        f = torch.gather(feats, 1, pos[..., None].expand(-1, -1, C))
        out += torch.bmm(zero_invalid(f, hit), wg[:, o])
    return out


def sources_sorted(src_lat: torch.Tensor, src_valid: torch.Tensor) -> bool:
    """Whether every group's packed source keys ascend (the contract)."""
    sk = pack_coords(src_lat, src_valid)
    return bool((sk[:, 1:] >= sk[:, :-1]).all())


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != device or not t.is_contiguous():
        raise ValueError(f"sparse_conv: {name} must be a contiguous {dtype} "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def sparse_conv(src_lat: torch.Tensor, src_valid: torch.Tensor,
                src_feats: torch.Tensor, w: torch.Tensor, kernel_size: int,
                qry_lat: Optional[torch.Tensor] = None,
                qry_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 (see module docstring).

    src_lat i32[G, N, 3] source lattice coords (already divided by the
    source stride), key-sorted with invalid rows last; src_valid
    bool[G, N]; src_feats [G, N, C]; w [Gw, K^3, C, Cout] with Gw dividing G; qry_lat/qry_valid
    [G, NQ, 3]/[G, NQ] query lattice coords, or None for the submanifold
    form (queries = sources).  Returns f32[G, NQ, Cout].

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if src_feats.device.type == "cpu":
        return sparse_conv_plain(src_lat, src_valid, src_feats, w,
                                 kernel_size, qry_lat, qry_valid)
    dev = src_feats.device
    if dev.type != "cuda":
        raise ValueError(f"sparse_conv: no kernel for device {dev}")
    K = kernel_size
    G, N, C = src_feats.shape
    Gw, K3, Cw, Cout = w.shape
    if K % 2 == 0 or K > 9 or K3 != K ** 3 or Cw != C or G % Gw != 0:
        raise ValueError(f"sparse_conv: unsupported K={K}, w {tuple(w.shape)}"
                         f" for feats {tuple(src_feats.shape)}")
    sk = pack_coords(src_lat, src_valid).contiguous()
    qk = sk if qry_lat is None else pack_coords(qry_lat, qry_valid).contiguous()
    NQ = qk.shape[1]
    feats = zero_invalid(src_feats, src_valid).to(torch.bfloat16).contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    _check(sk, "source keys", torch.int32, (G, N), dev)
    _check(qk, "query keys", torch.int32, (G, NQ), dev)
    _check(feats, "feats", torch.bfloat16, (G, N, C), dev)
    _check(wb, "weights", torch.bfloat16, (Gw, K3, C, Cout), dev)
    out = torch.empty(G, NQ, Cout, dtype=torch.float32, device=dev)
    lib = build.load("sparse_conv")
    fn = lib.sparse_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    (ex, ey, ez), (sx, sy) = key_extents(), key_shifts()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(sk.data_ptr(), qk.data_ptr(), feats.data_ptr(), wb.data_ptr(),
             out.data_ptr(), G, N, NQ, C, Cout, Gw, K, sx, sy, ex, ey, ez,
             stream)
    build.check(err, "sparse_conv")
    sparse_conv.launches += 1
    return out


sparse_conv.launches = 0
