"""Quantization + deduplication (voxelization) with static capacity, eval.

Counterpart of ``cagroup3d_tpu/core/voxelize.py``: pack coords to int32
keys, one stable sort, head-flag unique, reduce features per voxel.  Under
capacity overflow the voxels with the ``cap`` smallest keys are kept (the
JAX package's eval identity window), so packing and tie-breaking match it
exactly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.segsum import segment_sums
from .gather import take1, take_rows
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


def _window_ranks(n_unique: torch.Tensor, cap: int) -> torch.Tensor:
    """Voxel ranks kept under capacity overflow: the identity window
    [0, cap) of the key-rank order (eval).  n_unique i32[G] or scalar;
    returns i32[G, cap]."""
    n = n_unique.reshape(-1)
    s = torch.arange(cap, dtype=torch.int32, device=n.device)
    return s[None].expand(n.shape[0], cap)


def unique_voxels(lat: torch.Tensor, feats: torch.Tensor,
                  valid: torch.Tensor, cap: int, mode: str = "mean",
                  stats: Optional[dict] = None, stat_name: str = "unique"
                  ) -> Tuple[SparseTensor, torch.Tensor]:
    """Deduplicate lattice coords i32[P, 3], reducing feats [P, F] per
    voxel ('mean' == ME UNWEIGHTED_AVERAGE, 'first' == the first point in
    row order).  Returns (SparseTensor stride 1, inverse i32[P]: output
    row of each point, -1 if dropped or invalid)."""
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

    vq = _window_ranks(n_uni, cap)                                 # [1, cap]
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

    kept = ok & (uid_sorted < cap)
    slot = torch.where(kept, uid_sorted, torch.full_like(uid_sorted, -1))
    uid = torch.empty(P, dtype=torch.int32, device=dev)
    uid[order] = slot

    if mode == "mean":
        F = feats.shape[-1]
        fs = zero_invalid(feats, valid)
        seg = torch.where(kept, uid_sorted,
                          torch.full_like(uid_sorted, cap)).long()
        sums = torch.zeros(cap + 1, F, dtype=torch.float32, device=dev)
        sums.index_add_(0, seg, fs[order].to(torch.float32))
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
                                 cap_coarse: int, coarse_factor: int):
    """The dense head's per-class fine map AND its ``coarse_factor``-times
    coarser map from one sort (eval).

    lat i32[G, P, 3] fine lattice coords; feats [P, F] shared by the
    groups; valid bool[G, P] per-group selection.  The fine map is the
    per-group segment mean over the key-sorted rows (kernel K2,
    ops/segsum.py) in bf16 rows with f32 sums; the coarse map is the
    count-weighted mean of fine voxels over fine // coarse_factor.
    Returns ((coords, feats, valid) fine, (coords, feats, valid) coarse,
    (overflow_fine i32[G], overflow_coarse i32[G])).
    """
    G, P, _ = lat.shape
    keys = pack_coords(lat, valid)
    sk, order = torch.sort(keys, dim=1, stable=True)
    lat_s = unpack_keys(sk)
    feats_s = feats.to(torch.bfloat16)[order]                # [G, P, F]

    ok = sk != INVALID_KEY
    n_unique_f = (_heads(sk) & ok).sum(1, dtype=torch.int32)
    of_fine = (n_unique_f - cap_fine).clamp(min=0)
    f_sum, f_cnt = segment_sums(sk.contiguous(), feats_s.contiguous(),
                                cap_fine)
    f_valid = f_cnt > 0
    # first row of segment j = #rows of segments < j (sorted layout)
    start = torch.cumsum(f_cnt, 1, dtype=torch.int32) - f_cnt
    f_coords = torch.gather(
        lat_s, 1, start.clamp(0, P - 1).long()[..., None].expand(-1, -1, 3))
    f_coords = torch.where(f_valid[..., None], f_coords,
                           torch.full_like(f_coords, PAD_COORD))
    f_feats = zero_invalid(f_sum / f_cnt.clamp(min=1)[..., None], f_valid)
    (cc, cf, cv), of_coarse = _paired_coarse(
        cap_coarse, coarse_factor, f_coords, f_valid, f_sum, f_cnt)
    return (f_coords, f_feats, f_valid), (cc, cf, cv), (of_fine, of_coarse)


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
    c_sum = torch.zeros(G * (cap_coarse + 1), F, dtype=torch.float32,
                        device=dev)
    c_sum.index_add_(0, seg2, sum_s.reshape(-1, F).to(torch.float32))
    c_sum = c_sum.reshape(G, cap_coarse + 1, F)[:, :cap_coarse]
    c_valid = c_cnt > 0
    c_feats = zero_invalid(c_sum / c_cnt.clamp(min=1)[..., None], c_valid)
    return (c_coords, c_feats, c_valid), of_coarse
