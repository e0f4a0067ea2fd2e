"""Quantization + deduplication (voxelization) with static capacity.

Counterpart of ``cagroup3d_tpu/core/voxelize.py``: pack coords to int32
keys, one stable sort, head-flag unique, reduce features per voxel.  Under
capacity overflow eval keeps the voxels with the ``cap`` smallest keys (the
identity window); training passes a ``drop_offset`` and keeps a cyclic
window of ``cap`` consecutive key ranks starting at ``drop_offset mod n``
(still key-sorted, wrapping around), so the dropped region moves every
step.  Packing, windows and tie-breaking match the JAX package exactly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.segsum import segment_sums
from .gather import segment_sum, take1, take_rows
from .hashing import INVALID_KEY, pack_coords, unpack_keys
from .sparse import PAD_COORD, SparseTensor, zero_invalid


def floor_div(a: torch.Tensor, b) -> torch.Tensor:
    """jnp.floor_divide for integer tensors (rounds toward -inf)."""
    return torch.div(a, b, rounding_mode="floor")


def _heads(sk: torch.Tensor) -> torch.Tensor:
    """Run-head flags over the last axis of sorted keys."""
    first = torch.ones_like(sk[..., :1], dtype=torch.bool)
    return torch.cat([first, sk[..., 1:] != sk[..., :-1]], dim=-1)


def _count_sorted(u: torch.Tensor, m, strict: bool) -> torch.Tensor:
    """Per group, #entries of the sorted i32[G, P] ``u`` that are < q
    (strict) or <= q for queries q = 0..m-1 (or an explicit i32[G, m])."""
    if isinstance(m, int):
        q = torch.arange(m, dtype=u.dtype, device=u.device)
        q = q[None].expand(u.shape[0], m).contiguous()
    else:
        q = m.to(u.dtype).contiguous()
    return torch.searchsorted(u.contiguous(), q, right=not strict).to(
        torch.int32)


def _window_ranks(n_unique: torch.Tensor, cap: int,
                  drop_offset: Optional[int] = None) -> torch.Tensor:
    """Voxel ranks kept under capacity overflow: the cyclic window
    [o, o + cap) mod n of the key-rank order with o = drop_offset mod n,
    emitted in ascending rank (slots s < wrap hold ranks s, the rest
    ranks s + o - wrap); no overflow or no drop_offset (eval) gives the
    identity window.  n_unique i32[G] or scalar; returns i32[G, cap]."""
    n = n_unique.reshape(-1, 1).to(torch.int32)
    s = torch.arange(cap, dtype=torch.int32, device=n.device)[None]
    if drop_offset is None:
        return s.expand(n.shape[0], cap)
    o, wrap = _window_params(n, cap, drop_offset)
    return torch.where(s < wrap, s, s + o - wrap)


def _window_params(n: torch.Tensor, cap: int, drop_offset: int):
    """(o, wrap) of the cyclic window for unique counts n (any shape)."""
    over = n > cap
    o = torch.where(over, torch.remainder(torch.full_like(n, drop_offset),
                                          n.clamp(min=1)),
                    torch.zeros_like(n))
    wrap = torch.where(over, (o + cap - n).clamp(min=0), torch.zeros_like(n))
    return o, wrap


def _window_slots(uid: torch.Tensor, ok: torch.Tensor, n_unique, cap: int,
                  drop_offset: Optional[int]):
    """Inverse of ``_window_ranks`` per sorted row: (slot, kept) for rank
    ``uid`` [..., P] of groups with ``n_unique`` [...] voxels."""
    if drop_offset is None:
        return uid, ok & (uid < cap)
    o, wrap = _window_params(n_unique.reshape(uid.shape[:-1] + (1,))
                             .to(torch.int32), cap, drop_offset)
    slot = torch.where(uid < wrap, uid, uid - o + wrap)
    kept = ok & ((uid < wrap) | (uid >= o)) & (slot < cap) & (slot >= 0)
    return slot, kept


def arrival_rank(lat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-point rank within its voxel in arrival (row) order: the i-th
    valid point landing in a voxel gets rank i, as spconv's voxelizer fills
    a voxel with the first MAX_POINTS_PER_VOXEL points of the array.
    Invalid rows get 2^30.  lat i32[P, 3], valid bool[P] -> i32[P]."""
    keys = pack_coords(lat, valid)
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=lat.device)
    sk, order = torch.sort(keys, stable=True)
    start = torch.cummax(torch.where(_heads(sk), idx, torch.zeros_like(idx)),
                         0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - start
    return torch.where(valid, rank, torch.full_like(rank, 1 << 30))


def unique_voxels(lat: torch.Tensor, feats: torch.Tensor,
                  valid: torch.Tensor, cap: int, mode: str = "mean",
                  stats: Optional[dict] = None, stat_name: str = "unique",
                  drop_offset: Optional[int] = None
                  ) -> Tuple[SparseTensor, torch.Tensor]:
    """Deduplicate lattice coords i32[P, 3], reducing feats [P, F] per
    voxel ('mean' == ME UNWEIGHTED_AVERAGE, 'first' == the first point in
    row order); ``drop_offset`` picks the training capacity window.
    Returns (SparseTensor stride 1, inverse i32[P]: output row of each
    point, -1 if dropped or invalid)."""
    P = lat.shape[0]
    dev = lat.device
    keys = pack_coords(lat, valid)
    sk, order = torch.sort(keys, stable=True)
    ok = sk != INVALID_KEY
    hk = (_heads(sk) & ok).to(torch.int32)
    uid_sorted = torch.cumsum(hk, 0, dtype=torch.int32) - 1
    n_uni = hk.sum()
    if stats is not None:
        stats[f"overflow/{stat_name}"] = (n_uni - cap).clamp(min=0)

    vq = _window_ranks(n_uni, cap, drop_offset)                    # [1, cap]
    big = torch.full_like(uid_sorted, 1 << 30)
    uid2 = torch.where(ok, uid_sorted, big)[None]
    start = _count_sorted(uid2, vq, strict=True)[0]
    end = _count_sorted(uid2, vq, strict=False)[0] - 1
    cnt = (end - start + 1).clamp(min=0)
    out_valid = cnt > 0

    first_row = take1(order, start)
    pad = torch.full((cap, 3), PAD_COORD, dtype=torch.int32, device=dev)
    out_coords = torch.where(out_valid[:, None],
                             take_rows(lat.to(torch.int32), first_row), pad)

    slot, kept = _window_slots(uid_sorted, ok, n_uni, cap, drop_offset)
    uid = torch.empty(P, dtype=torch.int32, device=dev)
    uid[order] = torch.where(kept, slot, torch.full_like(slot, -1))

    if mode == "mean":
        F = feats.shape[-1]
        fs = zero_invalid(feats, valid)
        seg = torch.where(kept, slot, torch.full_like(slot, cap))
        sums = segment_sum(fs.to(torch.float32), seg, cap + 1, rows=order)
        out_feats = (sums[:cap] / cnt.clamp(min=1)[:, None]).to(feats.dtype)
    elif mode == "first":
        out_feats = take_rows(feats, first_row)
    else:
        raise ValueError(mode)
    out_feats = zero_invalid(out_feats, out_valid)
    return SparseTensor(out_coords, out_feats, out_valid, stride=1), uid


def stride_reduce_coords(st: SparseTensor, factor: int, cap: int,
                         stats: Optional[dict] = None,
                         stat_name: str = "stride"
                         ) -> Tuple[SparseTensor, torch.Tensor]:
    """Coordinate set of a strided conv/pool output (ME semantics:
    unique(floor(c / (stride*factor))) * stride*factor); zero features."""
    new_stride = st.stride * factor
    lat = floor_div(st.coords, new_stride)
    dummy = torch.zeros((st.cap, 1), dtype=st.feats.dtype,
                        device=st.feats.device)
    ded, inv = unique_voxels(lat, dummy, st.valid, cap, mode="first",
                             stats=stats, stat_name=stat_name)
    pad = torch.full_like(ded.coords, PAD_COORD)
    out = SparseTensor(
        coords=torch.where(ded.valid[:, None], ded.coords * new_stride, pad),
        feats=torch.zeros((cap, st.num_channels), dtype=st.feats.dtype,
                          device=st.feats.device),
        valid=ded.valid, stride=new_stride)
    return out, inv


def unique_voxels_classes_paired(lat: torch.Tensor, feats: torch.Tensor,
                                 valid: torch.Tensor, cap_fine: int,
                                 cap_coarse: int, coarse_factor: int,
                                 train: bool = False,
                                 drop_offset: Optional[int] = None):
    """The dense head's per-class fine map AND its ``coarse_factor``-times
    coarser map from one sort.

    lat i32[G, P, 3] fine lattice coords; feats [P, F] shared by the
    groups; valid bool[G, P] per-group selection.  The fine map is the
    per-group segment mean over the key-sorted rows in bf16 rows with f32
    sums: in eval the first ``cap_fine`` keys through kernel K2
    (ops/segsum.py); in training (``train``) the cyclic ``drop_offset``
    window through ``gather.segment_sum``, which autograd differentiates
    (K2 has no backward, and the JAX package gates its kernel off in
    training the same way).  The coarse map is the count-weighted mean of
    fine voxels over fine // coarse_factor.  Returns ((coords, feats,
    valid) fine, (coords, feats, valid) coarse, (overflow_fine i32[G],
    overflow_coarse i32[G])).
    """
    G, P, _ = lat.shape
    keys = pack_coords(lat, valid)
    sk, order = torch.sort(keys, dim=1, stable=True)
    lat_s = unpack_keys(sk)
    feats_s = feats.to(torch.bfloat16)[order]                # [G, P, F]

    ok = sk != INVALID_KEY
    n_unique_f = (_heads(sk) & ok).sum(1, dtype=torch.int32)
    of_fine = (n_unique_f - cap_fine).clamp(min=0)
    if train:
        f_sum, f_cnt, start = _window_segment_sums(
            sk, ok, feats_s, n_unique_f, cap_fine, drop_offset)
    else:
        f_sum, f_cnt = segment_sums(sk.contiguous(), feats_s.contiguous(),
                                    cap_fine)
        # first row of segment j = #rows of segments < j (sorted layout)
        start = torch.cumsum(f_cnt, 1, dtype=torch.int32) - f_cnt
    f_valid = f_cnt > 0
    f_coords = torch.gather(
        lat_s, 1, start.clamp(0, P - 1).long()[..., None].expand(-1, -1, 3))
    f_coords = torch.where(f_valid[..., None], f_coords,
                           torch.full_like(f_coords, PAD_COORD))
    f_feats = zero_invalid(f_sum / f_cnt.clamp(min=1)[..., None], f_valid)
    (cc, cf, cv), of_coarse = _paired_coarse(
        cap_coarse, coarse_factor, f_coords, f_valid, f_sum, f_cnt)
    return (f_coords, f_feats, f_valid), (cc, cf, cv), (of_fine, of_coarse)


def _window_segment_sums(sk, ok, feats_s, n_unique, cap: int,
                         drop_offset: Optional[int]):
    """Training fine map: per group, f32 sums and counts of the key runs
    whose ranks the cyclic window keeps, and each kept run's first sorted
    row.  sk i32[G, P] sorted keys, feats_s bf16[G, P, F] sorted rows."""
    G, P, F = feats_s.shape
    uid = torch.cumsum((_heads(sk) & ok).to(torch.int32), 1,
                       dtype=torch.int32) - 1
    vq = _window_ranks(n_unique, cap, drop_offset)               # [G, cap]
    uid2 = torch.where(ok, uid, torch.full_like(uid, 1 << 30))
    start = _count_sorted(uid2, vq, strict=True)
    end = _count_sorted(uid2, vq, strict=False) - 1
    cnt = (end - start + 1).clamp(min=0)
    slot, kept = _window_slots(uid, ok, n_unique, cap, drop_offset)
    base = (torch.arange(G, device=sk.device, dtype=torch.int32)
            * (cap + 1))[:, None]
    seg = (torch.where(kept, slot, torch.full_like(slot, cap)) + base
           ).reshape(-1)
    sums = segment_sum(feats_s.reshape(-1, F).to(torch.float32), seg,
                       G * (cap + 1))
    return sums.reshape(G, cap + 1, F)[:, :cap], cnt, start


def _paired_coarse(cap_coarse, coarse_factor, f_coords, f_valid, f_sum,
                   f_cnt):
    """Coarse (expand) map from the fine map: count-weighted means over
    the ``coarse_factor``-reduced lattice."""
    G, cap_fine, F = f_sum.shape
    dev = f_sum.device
    lat_c = floor_div(f_coords, coarse_factor)
    keys_c = pack_coords(lat_c, f_valid)
    order2 = torch.argsort(keys_c, dim=1, stable=True)
    sk_c = torch.gather(keys_c, 1, order2)
    lat_c_s = torch.gather(lat_c, 1, order2[..., None].expand(-1, -1, 3))
    sum_s = torch.gather(f_sum, 1, order2[..., None].expand(-1, -1, F))
    cnt_s = torch.gather(f_cnt, 1, order2)

    head2 = _heads(sk_c)
    ok2 = sk_c != INVALID_KEY
    uid2 = torch.cumsum((head2 & ok2).to(torch.int32), 1,
                        dtype=torch.int32) - 1
    keep2 = ok2 & (uid2 < cap_coarse)
    n_unique2 = (head2 & ok2).sum(1, dtype=torch.int32)
    of_coarse = (n_unique2 - cap_coarse).clamp(min=0)
    cls2 = (torch.arange(G, device=dev, dtype=torch.int32)
            * (cap_coarse + 1))[:, None]
    dump = torch.full_like(uid2, cap_coarse)
    slot2 = (torch.where(head2 & keep2, uid2, dump) + cls2).reshape(-1).long()
    c_coords = torch.full((G * (cap_coarse + 1), 3), PAD_COORD,
                          dtype=torch.int32, device=dev)
    # non-head rows all write the dump slot (index cap_coarse), sliced away
    c_coords[slot2] = lat_c_s.reshape(-1, 3)
    c_coords = c_coords.reshape(G, cap_coarse + 1, 3)[:, :cap_coarse]
    seg2 = (torch.where(keep2, uid2, dump) + cls2).reshape(-1).long()
    c_cnt = torch.zeros(G * (cap_coarse + 1), dtype=torch.int32, device=dev)
    c_cnt.index_add_(0, seg2, torch.where(keep2, cnt_s,
                                          torch.zeros_like(cnt_s)).reshape(-1))
    c_cnt = c_cnt.reshape(G, cap_coarse + 1)[:, :cap_coarse]
    c_sum = segment_sum(sum_s.reshape(-1, F).to(torch.float32), seg2,
                        G * (cap_coarse + 1))
    c_sum = c_sum.reshape(G, cap_coarse + 1, F)[:, :cap_coarse]
    c_valid = c_cnt > 0
    c_feats = zero_invalid(c_sum / c_cnt.clamp(min=1)[..., None], c_valid)
    return (c_coords, c_feats, c_valid), of_coarse


def triple(v):
    """An int or a 3-sequence as a tuple of 3 ints."""
    return tuple(int(x) for x in np.broadcast_to(np.asarray(v), (3,)))


def spconv_reduce_lat(lat: torch.Tensor, valid: torch.Tensor, kernel, stride,
                      padding, cap: int, stats: Optional[dict] = None,
                      stat_name: str = "spconv", in_extent=None):
    """Output lattice of an spconv strided SparseConv3d: output o exists
    iff some input lies in its receptive field o*s - p + [0, k) (not ME's
    floor division).  Per axis an input i has the candidates o in
    [ceil((i + p - k + 1) / s), floor((i + p) / s)], at most 1 + (k-1)//s
    of them, each checked against the receptive field.  ``in_extent``
    (the input's dense extent) clamps outputs to the dense output extent
    (X + 2p - k)//s + 1, past which spconv makes no voxel.  lat i32[N, 3]
    in input lattice units; kernel/stride/padding ints or triples.
    Returns (out_lat i32[cap, 3] in output lattice units, key-sorted with
    invalid rows last, out_valid bool[cap])."""
    k, s, p = triple(kernel), triple(stride), triple(padding)
    dev = lat.device
    out_extent = None
    if in_extent is not None:
        e = triple(in_extent)
        out_extent = torch.tensor([(e[a] + 2 * p[a] - k[a]) // s[a] + 1
                                   for a in range(3)], dtype=torch.int32,
                                  device=dev)
    n_opts = [1 + (k[a] - 1) // s[a] for a in range(3)]
    st, pt, kt = (torch.tensor(v, dtype=torch.int32, device=dev)
                  for v in (s, p, k))
    lat = lat.to(torch.int32)
    base = floor_div(lat + pt - kt + 1 + st - 1, st)      # first candidate
    cands, oks = [], []
    for d in np.ndindex(*n_opts):
        o = base + torch.tensor(d, dtype=torch.int32, device=dev)
        lo = o * st - pt
        ok = ((lat >= lo) & (lat < lo + kt)).all(-1) & (o >= 0).all(-1) & \
            valid
        if out_extent is not None:
            ok = ok & (o < out_extent).all(-1)
        cands.append(o)
        oks.append(ok)
    lat_c = torch.cat(cands)
    dummy = torch.zeros(lat_c.shape[0], 1, device=dev)
    ded, _ = unique_voxels(lat_c, dummy, torch.cat(oks), cap, mode="first",
                           stats=stats, stat_name=stat_name)
    return ded.coords, ded.valid
