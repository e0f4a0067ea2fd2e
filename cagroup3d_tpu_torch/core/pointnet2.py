"""PointNet++ op family over batched scenes.

Counterpart of ``cagroup3d_tpu/core/pointnet2.py`` (the reference's
pointnet2_batch ops: FarthestPointSampling, BallQuery, ThreeNN,
ThreeInterpolate, GroupingOperation, QueryAndGroup).  The JAX functions
take one scene and are vmapped; here every function takes a leading scene
axis ``[B, ...]``, so one loop of farthest point sampling serves the whole
batch and batch norm after a grouping sees every scene's rows at once.

Squared distances are the sum of the squared x, y and z differences in
that order, as the JAX code's ``jnp.sum((a - b) ** 2, -1)``; a matrix
product (``torch.cdist``) would change them by round-off and flip the
radius tests.  Dense distance blocks are computed in chunks of queries
whose size keeps a block under ``CHUNK_ELEMS`` elements.
"""
from __future__ import annotations

from typing import Optional

import torch

BIG = 1e10
CHUNK_ELEMS = 1 << 26


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, 3], b [..., N, 3] -> [..., M, N] squared distances."""
    out = None
    for k in range(3):
        d = a[..., :, None, k] - b[..., None, :, k]
        d = d * d
        out = d if out is None else out + d
    return out


def query_chunk(batch: int, n_queries: int, n_points: int) -> int:
    """Queries per chunk so that a [batch, chunk, n_points] block holds at
    most ``CHUNK_ELEMS`` elements."""
    return max(1, min(n_queries, CHUNK_ELEMS // max(batch * n_points, 1)))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C] gathered at idx [B, ...] (indices into N) ->
    [B, ..., C]; one ``index_select`` over the flattened scenes."""
    B, N = x.shape[:2]
    off = torch.arange(B, device=idx.device).reshape(
        (B,) + (1,) * (idx.dim() - 1)) * N
    flat = (idx.long() + off).reshape(-1)
    out = x.reshape(B * N, *x.shape[2:]).index_select(0, flat)
    return out.reshape(*idx.shape, *x.shape[2:])


def gather1(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N] gathered at idx [B, ...] -> [B, ...]."""
    return gather_rows(x[..., None], idx)[..., 0]


def farthest_point_sample(xyz: torch.Tensor, valid: torch.Tensor,
                          n_samples: int) -> torch.Tensor:
    """i64[B, n_samples]: per scene, farthest point sampling that starts at
    the first valid point and takes the first maximum of the running
    min-distance at each step.  Invalid points keep distance -BIG, so they
    are never picked while a valid one is left; with fewer valid points
    than ``n_samples`` the indices repeat.  One host loop of
    ``n_samples - 1`` steps for the whole batch, with no host sync."""
    with torch.no_grad():
        return _fps(xyz.detach(), valid, n_samples)


def _fps(xyz, valid, n_samples):
    B, N = valid.shape
    start = valid.to(torch.uint8).argmax(-1)
    big = torch.tensor(BIG, dtype=xyz.dtype, device=xyz.device)
    dist = torch.where(valid, big, -big)
    idxs = start[:, None].repeat(1, n_samples)
    rows = torch.arange(B, device=xyz.device)
    last = start
    for i in range(1, n_samples):
        p = xyz[rows, last]                                   # [B, 3]
        d = xyz - p[:, None, :]
        d = d * d
        d = d[..., 0] + d[..., 1] + d[..., 2]
        # invalid points hold -BIG < d: the minimum keeps them there
        torch.minimum(dist, d, out=dist)
        last = dist.argmax(-1)
        idxs[:, i] = last
    return idxs


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               xyz_valid: torch.Tensor, centers: torch.Tensor,
               centers_valid: torch.Tensor):
    """Per center, the first ``nsample`` valid points (in index order)
    within ``radius``; empty slots repeat the first one found, or 0 if
    none.  xyz [B, N, 3], centers [B, M, 3] -> (idx i64[B, M, nsample],
    any_found bool[B, M])."""
    B, N = xyz_valid.shape
    M = centers.shape[1]
    r2 = radius ** 2
    ar = torch.arange(N, device=xyz.device)
    idx_out, found_out = [], []
    step = query_chunk(B, M, N)
    for s in range(0, M, step):
        c, cv = centers[:, s:s + step], centers_valid[:, s:s + step]
        inball = (sq_dist(c, xyz) < r2) & xyz_valid[:, None, :] & \
            cv[:, :, None]
        key = torch.where(inball, ar, ar + N)
        vals, idx = torch.topk(key, nsample, dim=-1, largest=False,
                               sorted=True)
        found = vals < N
        first = torch.where(found[..., 0], idx[..., 0],
                            torch.zeros_like(idx[..., 0]))
        idx_out.append(torch.where(found, idx, first[..., None]))
        found_out.append(found[..., 0])
    return torch.cat(idx_out, 1), torch.cat(found_out, 1)


def three_nn(unknown: torch.Tensor, unknown_valid: torch.Tensor,
             known: torch.Tensor, known_valid: torch.Tensor):
    """The 3 nearest valid known points of each unknown point, ties to the
    lower index: (dist [B, N, 3], idx i64[B, N, 3]).  The distances carry
    no gradient (the reference's ThreeNN is not differentiable), which
    also avoids sqrt(0)'s infinite slope where points coincide."""
    dists, idxs = [], []
    step = query_chunk(unknown.shape[0], unknown.shape[1], known.shape[1])
    for s in range(0, unknown.shape[1], step):
        d2 = sq_dist(unknown[:, s:s + step], known)
        d2 = torch.where(known_valid[:, None, :], d2,
                         torch.full_like(d2, BIG))
        v, i = torch.sort(d2, dim=-1, stable=True)
        dists.append(v[..., :3])
        idxs.append(i[..., :3])
    d = torch.cat(dists, 1)
    return torch.sqrt(d.clamp(min=0.0)).detach(), torch.cat(idxs, 1)


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      dist: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted interpolation: feats [B, M, C], idx and
    dist [B, N, 3] -> [B, N, C]."""
    recip = 1.0 / torch.clamp(dist * dist, min=1e-8)
    w = recip / (recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3])
    g = gather_rows(feats, idx)                               # [B, N, 3, C]
    return (g[..., 0, :] * w[..., 0:1] + g[..., 1, :] * w[..., 1:2] +
            g[..., 2, :] * w[..., 2:3])


def query_and_group(radius: float, nsample: int, xyz, xyz_valid, centers,
                    centers_valid, feats: Optional[torch.Tensor] = None,
                    use_xyz: bool = True, zero_query: bool = False):
    """QueryAndGroup: per center the ball's points relative to the center
    (and their features) [B, M, nsample, 3 + C]; with ``zero_query``
    (the reference's ZeroQueryAndGroup) groups whose ball found nothing are
    zero.  Returns (grouped, idx, any_found)."""
    idx, found = ball_query(radius, nsample, xyz, xyz_valid, centers,
                            centers_valid)
    parts = [gather_rows(xyz, idx) - centers[:, :, None, :]] if use_xyz \
        else []
    if feats is not None:
        parts.append(gather_rows(feats, idx))
    out = torch.cat(parts, -1)
    if zero_query:
        out = torch.where(found[:, :, None, None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out, idx, found
