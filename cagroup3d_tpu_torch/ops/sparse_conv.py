"""K1: sparse convolution over key-indexed voxel tables, its backward, and
K3: the weight gradient.

K1 replaces the TPU kernel ``cagroup3d_tpu/ops/pallas_conv.py::_conv_kernel``
(``_pallas_forward``, reached through ``subm_conv_classes_mxu``,
``subm_conv_mxu`` and ``conv_at_coords_mxu``).  Per group g and query q:

    out[g, q] = sum_{o in K^3} feats[g, row(lat(q) + o)] @ w[g % Gw, o]

with o over ``kernel_offsets(K)`` (x-major, z fastest; odd K), rows looked
up by packed key among the group's valid source rows, missing neighbours
adding nothing and invalid queries giving zero rows.  Features and weights
are rounded to bf16 and accumulated in f32, as on the TPU.

K3 replaces ``pallas_conv.py::_dw_kernel`` (``_pallas_dw``, the dW half of
the custom VJPs of ``subm_conv_classes_mxu`` and ``conv_at_coords_mxu``):

    dw[gw, o] = sum_{g % Gw == gw} sum_q feats[g, row(lat(q) + o)]^T gout[g, q]

``sparse_conv`` is differentiable (``torch.autograd.Function``): its
forward is K1; the feature gradient is K1 again with offset-reversed,
transposed weights (``w_rev_t``) on the bf16-rounded cotangent, with the
tables swapped for the conv-at-coords form (source = the query table,
queries = the source lattice); the weight gradient is K3.

Source contract, the Pallas kernel's: each group's source rows are sorted
by packed key with invalid rows last, so a key's rank is its row.  Every
source table of the main path comes out of ``unique_voxels`` or the
head's segment-sum maps in that order (``sources_sorted`` checks it), and
so does every query table of the conv-at-coords form, which is the source
of its feature gradient.  Queries may otherwise come in any order.

The CUDA kernels are in ``csrc/sparse_conv.cu`` (K1: an operand-prep
pass, the map-and-gather-GEMM pass with the plan of ``k1_plan``, and a
reduce pass over offset splits; K3: an operand-prep pass, the map built
once per call as one pair list per (group, offset), and a pipelined
tensor-core GEMM over dense pair chunks with the plan of ``k3_plan``,
then a reduce pass over splits and shared weight groups; no float
atomics, so two calls give the same bits); ``sparse_conv_plain`` and
``sparse_conv_dw_plain`` are their plain PyTorch versions, used for CPU
tensors and as the reference on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from ..core.hashing import (_MARGIN as MARGIN, INVALID_KEY, key_bits,
                            key_bits_scope, key_extents, key_shifts,
                            pack_coords)
from ..core.kernel_maps import kernel_offsets
from ..core.sparse import bf16_round, zero_invalid
from . import build

_count_lock = threading.Lock()


def w_rev_t(w: torch.Tensor) -> torch.Tensor:
    """Reverse the offset axis (offset negation under the symmetric
    x-major stencil order) and swap Cin/Cout: [..., K^3, Cin, Cout] ->
    [..., K^3, Cout, Cin], the weights of the feature backward."""
    return w.flip(-3).transpose(-1, -2)


def _hits(src_lat, src_valid, qry_lat, qry_valid, off):
    """(row, hit) per query for one offset: binary search of the shifted
    query key in the group's sorted source keys."""
    sk = pack_coords(src_lat, src_valid)                           # [G, N]
    qk = pack_coords(qry_lat + off, qry_valid)                     # [G, NQ]
    pos = torch.searchsorted(sk, qk).clamp(max=sk.shape[1] - 1)
    hit = (torch.gather(sk, 1, pos) == qk) & (qk != INVALID_KEY)
    return pos, hit


def sparse_conv_plain(src_lat: torch.Tensor, src_valid: torch.Tensor,
                      src_feats: torch.Tensor, w: torch.Tensor,
                      kernel_size: int, qry_lat: Optional[torch.Tensor] = None,
                      qry_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1: per offset, a binary search in the sorted
    source keys, a masked row gather and a batched matmul accumulated into
    the output (never [K^3, N, C])."""
    G, N, C = src_feats.shape
    if qry_lat is None:
        qry_lat, qry_valid = src_lat, src_valid
    NQ = qry_lat.shape[1]
    Gw, _, _, Cout = w.shape
    dev = src_feats.device
    feats = bf16_round(zero_invalid(src_feats, src_valid))
    wg = bf16_round(w)[torch.arange(G, device=dev) % Gw]          # [G, K3, C, O]
    out = torch.zeros(G, NQ, Cout, dtype=torch.float32, device=dev)
    offs = torch.as_tensor(kernel_offsets(kernel_size), device=dev)
    for o in range(offs.shape[0]):
        pos, hit = _hits(src_lat, src_valid, qry_lat, qry_valid, offs[o])
        f = torch.gather(feats, 1, pos[..., None].expand(-1, -1, C))
        out += torch.bmm(zero_invalid(f, hit), wg[:, o])
    return out


def sparse_conv_dw_plain(src_lat: torch.Tensor, src_valid: torch.Tensor,
                         src_feats: torch.Tensor, gout: torch.Tensor,
                         kernel_size: int, w_groups: int,
                         qry_lat: Optional[torch.Tensor] = None,
                         qry_valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of K3: per offset, the same binary search and masked
    gather as ``sparse_conv_plain`` and a batched ``feats^T @ gout``
    (never [K^3, N, C]); groups that share weights are summed.  Features
    and the cotangent are rounded to bf16, products summed in f32.
    Returns f32[w_groups, K^3, C, Cout]."""
    G, N, C = src_feats.shape
    if qry_lat is None:
        qry_lat, qry_valid = src_lat, src_valid
    Cout = gout.shape[-1]
    dev = src_feats.device
    feats = bf16_round(zero_invalid(src_feats, src_valid))
    g16 = bf16_round(zero_invalid(gout, qry_valid))
    offs = torch.as_tensor(kernel_offsets(kernel_size), device=dev)
    dw = torch.zeros(G, offs.shape[0], C, Cout, dtype=torch.float32,
                     device=dev)
    for o in range(offs.shape[0]):
        pos, hit = _hits(src_lat, src_valid, qry_lat, qry_valid, offs[o])
        f = zero_invalid(torch.gather(feats, 1,
                                      pos[..., None].expand(-1, -1, C)), hit)
        dw[:, o] = torch.bmm(f.transpose(1, 2), g16)
    return dw.reshape(G // w_groups, w_groups, *dw.shape[1:]).sum(0)


def sources_sorted(src_lat: torch.Tensor, src_valid: torch.Tensor) -> bool:
    """Whether every group's packed source keys ascend (the contract)."""
    sk = pack_coords(src_lat, src_valid)
    return bool((sk[:, 1:] >= sk[:, :-1]).all())


# K1's plan table.  A block owns K1_TQ queries of one group, ``col_inner``
# column tiles of ``tn`` columns that it walks with one kernel map, and a
# range of ``per_split`` kernel offsets; the ``split`` offset ranges of a
# query tile are summed in order by a reduce pass.
K1_TQ, K1_SMS = 64, 132          # 132 SMs: H100 SXM


class K1Plan(NamedTuple):
    tn: int
    col_inner: int
    split: int
    per_split: int


@functools.lru_cache(maxsize=None)
def k1_plan(G: int, NQ: int, C: int, Cout: int, K: int) -> K1Plan:
    """K1's tile shape and split for one launch, filling the card first:
    128-column tiles from Cout 256 up, 64 below; a block walks every column
    tile of its query tile with one map when the query tiles alone fill two
    waves of the card's SMs, else each column tile is a block of its own (a
    map costs a few µs a block, an idle SM more); the offsets split over
    blocks when the grid would still be under two waves.  C does not change
    the plan (the kernel steps over 64-channel chunks)."""
    K3 = K ** 3
    tn = 128 if Cout >= 256 else 64
    ntiles = -(-Cout // tn)
    qblocks = G * -(-NQ // K1_TQ)
    col_inner = ntiles if qblocks >= 2 * K1_SMS else 1
    blocks = qblocks * -(-ntiles // col_inner)
    split = 1
    if 0 < blocks < 2 * K1_SMS:
        split = min(K3, -(-2 * K1_SMS // blocks))
    per_split = -(-K3 // split)
    return K1Plan(tn, col_inner, -(-K3 // per_split), per_split)


@functools.lru_cache(maxsize=None)
def _k1_launcher():
    fn = build.load("sparse_conv").spconv_k1_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 18 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _k1_scratch(G, N, NQ, C, Cout, Gw, K, has_query, split):
    """Byte offsets (256-aligned) of K1's scratch -- source keys, query
    keys, bf16 rows [G, N, Cp], bf16 weights [Gw, K^3, Cp x Coutp] and the
    f32 split partials -- and the total."""
    Cp, Coutp = -(-C // 16) * 16, -(-Cout // 8) * 8
    sizes = (4 * G * N, 4 * G * NQ if has_query else 0, 2 * G * N * Cp,
             2 * Gw * K ** 3 * Cp * Coutp,
             4 * split * G * NQ * Cout if split > 1 else 0)
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 256) * 256
    return offsets, total


def _launch_k1(src_lat, src_valid, src_feats, w, K, qry_lat, qry_valid,
               rev=False):
    """K1 on CUDA tensors (see module docstring); f32[G, NQ, Cout].  With
    ``rev`` it runs with ``w_rev_t(w)``, read in place by the kernel."""
    dev = src_feats.device
    if dev.type != "cuda":
        raise ValueError(f"sparse_conv: no kernel for device {dev}")
    G, N, C = src_feats.shape
    Gw, K3, R, S = w.shape
    Cout, Cw = (R, S) if rev else (S, R)
    NQ = N if qry_lat is None else qry_lat.shape[1]
    if K3 != K ** 3 or Cw != C or K % 2 == 0 or K > 9 or G % Gw != 0 or \
            N >= 1 << 22 or \
            tuple(src_lat.shape) != (G, N, 3) or \
            tuple(src_valid.shape) != (G, N) or (qry_lat is not None and (
                tuple(qry_lat.shape) != (G, NQ, 3) or
                tuple(qry_valid.shape) != (G, NQ))):
        raise ValueError(f"sparse_conv: w {tuple(w.shape)} does not fit K={K}"
                         f", feats {tuple(src_feats.shape)} and the tables")
    tensors = [src_lat.to(torch.int32).contiguous(),
               src_valid.to(torch.bool).contiguous(),
               src_feats.float().contiguous()]
    if qry_lat is not None:
        tensors += [qry_lat.to(torch.int32).contiguous(),
                    qry_valid.to(torch.bool).contiguous()]
    tensors.append(w.float().contiguous())
    if any(t.device != dev for t in tensors):
        raise ValueError("sparse_conv: every input must be on one device")
    ptrs = [t.data_ptr() for t in tensors]
    if qry_lat is None:
        ptrs[3:3] = [None, None]
    plan = k1_plan(G, NQ, C, Cout, K)
    offsets, total = _k1_scratch(G, N, NQ, C, Cout, Gw, K,
                                 qry_lat is not None, plan.split)
    scratch = torch.empty(total, dtype=torch.uint8, device=dev)
    out = torch.empty(G, NQ, Cout, dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    (ex, ey, ez), (sx, sy) = key_extents(), key_shifts()
    err = _k1_launcher()(
        *ptrs, *(base + o for o in offsets), out.data_ptr(), G, N, NQ, C,
        Cout, Gw, K, int(rev), *plan, MARGIN, sx, sy, ex, ey, ez,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "sparse_conv")
    with _count_lock:
        sparse_conv.launches += 1
    return out


def _conv(src_lat, src_valid, src_feats, w, K, qry_lat=None, qry_valid=None,
          rev=False):
    """K1 forward (``rev``: with ``w_rev_t(w)``): the plain version for CPU
    tensors, the kernel on CUDA."""
    if src_feats.device.type == "cpu":
        return sparse_conv_plain(src_lat, src_valid, src_feats,
                                 w_rev_t(w) if rev else w, K, qry_lat,
                                 qry_valid)
    return _launch_k1(src_lat, src_valid, src_feats, w, K, qry_lat,
                      qry_valid, rev)


def sparse_conv_dfeats(src_lat, src_valid, w, kernel_size: int, gout,
                       qry_lat=None, qry_valid=None) -> torch.Tensor:
    """Feature gradient of ``sparse_conv`` given the (masked) output
    cotangent gout [G, NQ, Cout]: K1 with ``w_rev_t(w)``; for the
    conv-at-coords form the query table is the source and the source
    lattice the queries.  Returns f32[G, N, C]."""
    if qry_lat is None:
        return _conv(src_lat, src_valid, gout, w, kernel_size, rev=True)
    return _conv(qry_lat, qry_valid, gout, w, kernel_size, src_lat,
                 src_valid, rev=True)


def sparse_conv_dfeats_plain(src_lat, src_valid, w, kernel_size: int, gout,
                             qry_lat=None, qry_valid=None) -> torch.Tensor:
    """Plain version of ``sparse_conv_dfeats`` (``sparse_conv_plain``)."""
    wt = w_rev_t(w)
    if qry_lat is None:
        return sparse_conv_plain(src_lat, src_valid, gout, wt, kernel_size)
    return sparse_conv_plain(qry_lat, qry_valid, gout, wt, kernel_size,
                             src_lat, src_valid)


# K3's plan table.  A block owns one (group, offset, 64-row C tile,
# ``tn``-column Cout tile) of dW and split ``s`` of the (group, offset) pair
# list, whose n pairs the kernel cuts ceil(n / split) a split.
K3_TC, K3_KP = 64, 64            # dW rows per block, pairs per pipeline step


class K3Plan(NamedTuple):
    tn: int
    split: int


@functools.lru_cache(maxsize=None)
def k3_plan(G: int, NQ: int, C: int, Cout: int, K: int) -> K3Plan:
    """K3's tile width and pair split for one launch: 64-column tiles up to
    Cout 64, 128 above; where the dW tiles alone would be under two waves
    of the card's SMs, each (group, offset) list is split over blocks (at
    most one split per ``K3_KP`` queries, since a list holds at most NQ
    pairs) and the partial tiles summed in order."""
    tn = 64 if Cout <= 64 else 128
    tiles = G * K ** 3 * -(-C // K3_TC) * -(-Cout // tn)
    split = 1
    if 0 < tiles < 2 * K1_SMS:
        split = max(1, min(-(-2 * K1_SMS // tiles), -(-NQ // K3_KP)))
    return K3Plan(tn, split)


def _k3_scratch(G, N, NQ, C, Cout, Gw, K, has_query, split):
    """Byte offsets (256-aligned) of K3's scratch -- source keys, query
    keys, bf16 feats [G, N, Cp], bf16 cotangent [G, NQ, Coutp], the map:
    the tiles' entries [G, T, K^2, 64], the counts [G, K^3, T] (then each
    tile's place in its list), the list lengths [G, K^3] and the pair lists
    [G, K^3, NQ] of (row, query), and the f32 partials [split, G, K^3, C,
    Cout] unless the gemm writes dW directly -- the total, and the map's
    share of it."""
    Cp, Coutp = -(-C // 16) * 16, -(-Cout // 8) * 8
    K3, T = K ** 3, -(-NQ // K1_TQ)
    direct = split == 1 and G == Gw
    sizes = (4 * G * N, 4 * G * NQ if has_query else 0, 2 * G * N * Cp,
             2 * G * NQ * Coutp, 4 * G * T * K * K * K1_TQ, 4 * G * K3 * T,
             4 * G * K3, 8 * G * K3 * NQ,
             0 if direct else 4 * split * G * K3 * C * Cout)
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 256) * 256
    return offsets, total, sum(-(-n // 256) * 256 for n in sizes[4:8])


@functools.lru_cache(maxsize=None)
def _k3_launcher():
    fn = build.load("sparse_conv").spconv_k3_launch
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 15 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sparse_conv_dw(src_lat: torch.Tensor, src_valid: torch.Tensor,
                   src_feats: torch.Tensor, gout: torch.Tensor,
                   kernel_size: int, w_groups: int,
                   qry_lat: Optional[torch.Tensor] = None,
                   qry_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 (see module docstring): gout [G, NQ, Cout] is the output
    cotangent; w_groups (Gw) divides G.  Returns f32[Gw, K^3, C, Cout].
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if src_feats.device.type == "cpu":
        return sparse_conv_dw_plain(src_lat, src_valid, src_feats, gout,
                                    kernel_size, w_groups, qry_lat, qry_valid)
    K, Gw = kernel_size, w_groups
    dev = src_feats.device
    if dev.type != "cuda":
        raise ValueError(f"sparse_conv_dw: no kernel for device {dev}")
    G, N, C = src_feats.shape
    NQ = N if qry_lat is None else qry_lat.shape[1]
    Cout = gout.shape[-1]
    if K % 2 == 0 or K > 9 or Gw <= 0 or G % Gw != 0 or N >= 1 << 22 or \
            G * K ** 3 > 65535 or tuple(gout.shape) != (G, NQ, Cout) or \
            tuple(src_lat.shape) != (G, N, 3) or \
            tuple(src_valid.shape) != (G, N) or (qry_lat is not None and (
                tuple(qry_lat.shape) != (G, NQ, 3) or
                tuple(qry_valid.shape) != (G, NQ))):
        raise ValueError(f"sparse_conv_dw: gout {tuple(gout.shape)} does not "
                         f"fit K={K}, {Gw} weight groups, feats "
                         f"{tuple(src_feats.shape)} and the tables")
    tensors = [src_lat.to(torch.int32).contiguous(),
               src_valid.to(torch.bool).contiguous(),
               src_feats.float().contiguous()]
    if qry_lat is not None:
        tensors += [qry_lat.to(torch.int32).contiguous(),
                    qry_valid.to(torch.bool).contiguous()]
    tensors.append(gout.float().contiguous())
    if any(t.device != dev for t in tensors):
        raise ValueError("sparse_conv_dw: every input must be on one device")
    ptrs = [t.data_ptr() for t in tensors]
    if qry_lat is None:
        ptrs[3:3] = [None, None]
    plan = k3_plan(G, NQ, C, Cout, K)
    offsets, total, _ = _k3_scratch(G, N, NQ, C, Cout, Gw, K,
                                    qry_lat is not None, plan.split)
    scratch = torch.empty(total, dtype=torch.uint8, device=dev)
    out = torch.empty(Gw, K ** 3, C, Cout, dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    (ex, ey, ez), (sx, sy) = key_extents(), key_shifts()
    err = _k3_launcher()(
        *ptrs, *(base + o for o in offsets), out.data_ptr(), G, N, NQ, C,
        Cout, Gw, K, *plan, MARGIN, sx, sy, ex, ey, ez,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "sparse_conv_dw")
    with _count_lock:
        sparse_conv_dw.launches += 1
    return out


class _SparseConvFn(torch.autograd.Function):
    """K1 forward; K1 feature backward and K3 weight backward.

    The backward packs keys at the bits its forward packed them at: it
    runs inside ``loss.backward()``, often after the model's
    ``key_bits_scope`` has closed (SECOND on KITTI packs at (11, 11, 8)
    and the defaults are 10/10/10)."""

    @staticmethod
    def forward(ctx, src_lat, src_valid, src_feats, w, kernel_size,
                qry_lat, qry_valid):
        ctx.kernel_size = kernel_size
        ctx.bits = key_bits()
        ctx.save_for_backward(src_lat, src_valid, src_feats, w, qry_lat,
                              qry_valid)
        return _conv(src_lat, src_valid, src_feats, w, kernel_size, qry_lat,
                     qry_valid)

    @staticmethod
    def backward(ctx, gout):
        src_lat, src_valid, src_feats, w, qry_lat, qry_valid = \
            ctx.saved_tensors
        K = ctx.kernel_size
        gout = zero_invalid(gout, src_valid if qry_lat is None else qry_valid)
        dfeats = dw = None
        # a caller that holds the scope at these bits already (a backward
        # inside the model's forward scope) must not wait on its lock
        with (contextlib.nullcontext() if key_bits() == ctx.bits
              else key_bits_scope(ctx.bits)):
            if ctx.needs_input_grad[2]:
                dfeats = sparse_conv_dfeats(src_lat, src_valid, w, K, gout,
                                            qry_lat, qry_valid
                                            ).to(src_feats.dtype)
            if ctx.needs_input_grad[3]:
                dw = sparse_conv_dw(src_lat, src_valid, src_feats, gout, K,
                                    w.shape[0], qry_lat, qry_valid
                                    ).to(w.dtype)
        return None, None, dfeats, dw, None, None, None


def sparse_conv(src_lat: torch.Tensor, src_valid: torch.Tensor,
                src_feats: torch.Tensor, w: torch.Tensor, kernel_size: int,
                qry_lat: Optional[torch.Tensor] = None,
                qry_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1, differentiable in ``src_feats`` and ``w`` (see module docstring).

    src_lat i32[G, N, 3] source lattice coords (already divided by the
    source stride), key-sorted with invalid rows last; src_valid
    bool[G, N]; src_feats [G, N, C]; w [Gw, K^3, C, Cout] with Gw dividing
    G; qry_lat/qry_valid [G, NQ, 3]/[G, NQ] query lattice coords, or None
    for the submanifold form (queries = sources).  Returns f32[G, NQ, Cout].

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (``sparse_conv.launches`` counts K1 launches, the feature backward's
    included; ``sparse_conv_dw.launches`` counts K3's).
    """
    if not (torch.is_grad_enabled() and
            (src_feats.requires_grad or w.requires_grad)):
        return _conv(src_lat, src_valid, src_feats, w, kernel_size, qry_lat,
                     qry_valid)        # nothing to differentiate
    return _SparseConvFn.apply(src_lat, src_valid, src_feats, w,
                               kernel_size, qry_lat, qry_valid)


sparse_conv.launches = 0
sparse_conv_dw.launches = 0
