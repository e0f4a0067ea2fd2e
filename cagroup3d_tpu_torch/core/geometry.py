"""Box geometry: z rotations, axis-aligned and rotated IoU, box corners.

Counterpart of ``cagroup3d_tpu/core/geometry.py``.  Box convention: (x, y,
z, dx, dy, dz, heading), heading rotating x toward y about +z (pcdet).
The rotated BEV overlap is the JAX package's branch-free Sutherland-Hodgman
clipping of rect A by the four half-planes of rect B, with the same
comparisons, the same vertex order and the same guards, so areas and their
autograd gradients follow the reference's, touching and coincident edges
included.  It serves the rotated NMS (SUN RGB-D), the proposal target
layer's 3D IoU (both datasets) and the rotated IoU loss.  ``jnp.maximum``
and ``jnp.minimum`` split the gradient of a tie in half, as
``torch.maximum`` does; ``clamp`` would not, so the rotated path uses the
former.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _max0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with ``jnp.maximum``'s gradient (half at x == 0)."""
    return torch.maximum(x, torch.zeros_like(x))


def rotate_points_along_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """points [..., N, 3+C] rotated by angle [...] (pcdet semantics)."""
    cosa, sina = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    xr = x * cosa - y * sina
    yr = x * sina + y * cosa
    return torch.cat([xr[..., None], yr[..., None], points[..., 2:]], dim=-1)


def rotation_3d_in_axis(points: torch.Tensor, angles: torch.Tensor,
                        axis: int = 2) -> torch.Tensor:
    """points [N, M, 3] rotated by angles [N] about ``axis`` (the
    reference's cagroup_utils.rotation_3d_in_axis: points @ R)."""
    s, c = torch.sin(angles), torch.cos(angles)
    ones, zeros = torch.ones_like(c), torch.zeros_like(c)
    if axis == 1:
        rows = [[c, zeros, -s], [zeros, ones, zeros], [s, zeros, c]]
    elif axis in (2, -1):
        rows = [[c, -s, zeros], [s, c, zeros], [zeros, zeros, ones]]
    elif axis == 0:
        rows = [[zeros, c, -s], [zeros, s, c], [ones, zeros, zeros]]
    else:
        raise ValueError(axis)
    rot = torch.stack([torch.stack(r, -1) for r in rows], -2)   # [N, 3, 3]
    return torch.einsum("amj,ajk->amk", points, rot)


def iou_bev_aligned(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV IoU ignoring heading (CUDA iou_normal)."""
    lo = torch.maximum(a7[..., :2] - a7[..., 3:5] / 2,
                       b7[..., :2] - b7[..., 3:5] / 2)
    hi = torch.minimum(a7[..., :2] + a7[..., 3:5] / 2,
                       b7[..., :2] + b7[..., 3:5] / 2)
    wh = (hi - lo).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    sa = a7[..., 3] * a7[..., 4]
    sb = b7[..., 3] * b7[..., 4]
    return inter / (sa + sb - inter).clamp(min=1e-8)


def z_overlap(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    zmax = torch.minimum(a7[..., 2] + a7[..., 5] / 2, b7[..., 2] + b7[..., 5] / 2)
    zmin = torch.maximum(a7[..., 2] - a7[..., 5] / 2, b7[..., 2] - b7[..., 5] / 2)
    return _max0(zmax - zmin)


def iou3d_aligned(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """Axis-aligned 3D IoU."""
    lo = torch.maximum(a7[..., :3] - a7[..., 3:6] / 2,
                       b7[..., :3] - b7[..., 3:6] / 2)
    hi = torch.minimum(a7[..., :3] + a7[..., 3:6] / 2,
                       b7[..., :3] + b7[..., 3:6] / 2)
    whd = (hi - lo).clamp(min=0.0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    va = torch.prod(a7[..., 3:6], dim=-1)
    vb = torch.prod(b7[..., 3:6], dim=-1)
    return inter / (va + vb - inter).clamp(min=1e-8)


def pairwise(fn, a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """[..., N, 7] x [..., M, 7] -> [..., N, M] for any IoU above."""
    return fn(a7[..., :, None, :], b7[..., None, :, :])


# ---------------------------------------------------------------------------
# Rotated BEV intersection
# ---------------------------------------------------------------------------

def box2corners_bev(box5: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, dx, dy, heading) -> [..., 4, 2] corners (CCW)."""
    x, y, dx, dy, a = box5.unbind(-1)
    xs = torch.stack([dx / 2, -dx / 2, -dx / 2, dx / 2], -1)
    ys = torch.stack([dy / 2, dy / 2, -dy / 2, -dy / 2], -1)
    c, s = torch.cos(a)[..., None], torch.sin(a)[..., None]
    cx = xs * c - ys * s + x[..., None]
    cy = xs * s + ys * c + y[..., None]
    return torch.stack([cx, cy], -1)


def _point_in_quad(pts: torch.Tensor, box5: torch.Tensor) -> torch.Tensor:
    """pts [..., P, 2] inside the rotated rect box5 [..., 5] -> bool
    [..., P] (with a 1e-6 margin)."""
    x, y, dx, dy, a = box5.unbind(-1)
    px = pts[..., 0] - x[..., None]
    py = pts[..., 1] - y[..., None]
    c, s = torch.cos(a)[..., None], torch.sin(a)[..., None]
    u = px * c + py * s
    v = -px * s + py * c
    eps = 1e-6
    return (u.abs() <= dx[..., None] / 2 + eps) & \
        (v.abs() <= dy[..., None] / 2 + eps)


def _seg_intersections(ca: torch.Tensor, cb: torch.Tensor):
    """The 16 edge-pair intersections of two quads ca, cb [..., 4, 2]:
    (points [..., 16, 2], valid [..., 16]), a-edges major."""
    a0 = ca[..., :, None, :]
    a1 = torch.roll(ca, -1, dims=-2)[..., :, None, :]
    b0 = cb[..., None, :, :]
    b1 = torch.roll(cb, -1, dims=-2)[..., None, :, :]
    da = a1 - a0
    db = b1 - b0
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    diff = b0 - a0
    t = diff[..., 0] * db[..., 1] - diff[..., 1] * db[..., 0]
    u = diff[..., 0] * da[..., 1] - diff[..., 1] * da[..., 0]
    nz = denom.abs() > 1e-10
    safe = torch.where(nz, denom, torch.ones_like(denom))
    t = t / safe
    u = u / safe
    ok = nz & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pt = a0 + t[..., None] * da
    lead = pt.shape[:-3]
    return pt.reshape(*lead, 16, 2), ok.reshape(*lead, 16)


def _cyclic_prev_valid_fill(verts: torch.Tensor, valid: torch.Tensor):
    """Each invalid slot of verts [..., S, 2] takes the previous valid
    vertex, cyclically (slots before the first valid one take the last),
    keeping the polygon's order; no valid slot leaves slot 0's values."""
    S = verts.shape[-2]
    idx = torch.arange(S, device=verts.device)
    run_max = torch.where(valid, idx, torch.full_like(idx, -1))
    # the running max in log2(S) elementwise maxima over shifted copies
    # (torch.cummax's CUDA scan with indices is far slower at these shapes)
    step = 1
    while step < S:
        run_max = torch.maximum(run_max, F.pad(run_max[..., :-step],
                                               (step, 0), value=-1))
        step *= 2
    last = run_max[..., -1:]
    src = torch.where(run_max >= 0, run_max, _max0(last))
    return torch.gather(verts, -2, src[..., None].expand(*src.shape, 2))


def _clip_by_edges(verts: torch.Tensor, clip_corners: torch.Tensor):
    """Sutherland-Hodgman: clip the polygon verts [..., S, 2] (every slot
    valid, duplicates allowed) by the 4 half-planes of the CCW rect
    ``clip_corners`` [..., 4, 2].  Returns [..., 16 S, 2] with the same
    invariant, and whether the polygon is non-empty."""
    out = verts
    nonempty = torch.ones(verts.shape[:-2], dtype=torch.bool,
                          device=verts.device)
    for e in range(4):
        p0 = clip_corners[..., e, :]
        p1 = clip_corners[..., (e + 1) % 4, :]
        ex = p1 - p0
        cur = out
        nxt = torch.roll(out, -1, dims=-2)

        def side(v):     # left of the directed edge = inside (CCW)
            return (ex[..., None, 0] * (v[..., 1] - p0[..., None, 1]) -
                    ex[..., None, 1] * (v[..., 0] - p0[..., None, 0]))

        s_cur = side(cur)
        s_nxt = side(nxt)
        cur_in = s_cur >= -1e-9
        nxt_in = s_nxt >= -1e-9
        denom = s_cur - s_nxt
        t = s_cur / torch.where(denom.abs() > 1e-12, denom,
                                torch.ones_like(denom))
        inter = cur + t[..., None] * (nxt - cur)
        cross = cur_in ^ nxt_in
        # emitted in order: the crossing point if the edge crosses, then
        # the next vertex if it is inside
        S = cur.shape[-2]
        ev = torch.stack([inter, nxt], dim=-2).reshape(
            *cur.shape[:-2], 2 * S, 2)
        em = torch.stack([cross, nxt_in], dim=-1).reshape(
            *cur.shape[:-2], 2 * S)
        nonempty = nonempty & em.any(-1)
        out = _cyclic_prev_valid_fill(ev, em)
    return out, nonempty


def rotated_intersection_area(boxa5: torch.Tensor,
                              boxb5: torch.Tensor) -> torch.Tensor:
    """Intersection area of rotated BEV rects [..., 5] (broadcastable):
    rect A clipped by rect B's half-planes, then the shoelace sum.
    Differentiable."""
    batch = torch.broadcast_shapes(boxa5.shape[:-1], boxb5.shape[:-1])
    ca = box2corners_bev(boxa5).expand(*batch, 4, 2)
    cb = box2corners_bev(boxb5).expand(*batch, 4, 2)
    poly, nonempty = _clip_by_edges(ca, cb)
    nxt = torch.roll(poly, -1, dims=-2)
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    area = 0.5 * cross.sum(-1).abs()
    return torch.where(nonempty, area, torch.zeros_like(area))


def _bev5(b: torch.Tensor) -> torch.Tensor:
    return b[..., [0, 1, 3, 4, 6]]


def _div_floor_den(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / max(den, 1e-8) with ``jnp.maximum``'s gradient."""
    return num / torch.maximum(den, torch.full_like(den, 1e-8))


def iou_bev_rotated(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU (the reference's iou_bev / nms_gpu overlap)."""
    inter = rotated_intersection_area(_bev5(a7), _bev5(b7))
    sa = a7[..., 3] * a7[..., 4]
    sb = b7[..., 3] * b7[..., 4]
    return _div_floor_den(inter, sa + sb - inter)


def iou3d_rotated(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """3D IoU with a rotated BEV footprint (boxes_iou3d_gpu,
    rotated_iou.cal_iou_3d)."""
    inter = rotated_intersection_area(_bev5(a7), _bev5(b7)) * \
        z_overlap(a7, b7)
    va = a7[..., 3] * a7[..., 4] * a7[..., 5]
    vb = b7[..., 3] * b7[..., 4] * b7[..., 5]
    return _div_floor_den(inter, va + vb - inter)


def boxes_to_corners_3d(boxes7: torch.Tensor) -> torch.Tensor:
    """[N, 7] -> [N, 8, 3] corners (pcdet box_utils.boxes_to_corners_3d)."""
    template = torch.tensor(
        [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]],
        dtype=boxes7.dtype, device=boxes7.device) / 2
    corners = boxes7[:, None, 3:6] * template[None]
    corners = rotate_points_along_z(corners, boxes7[:, 6])
    return corners + boxes7[:, None, 0:3]
