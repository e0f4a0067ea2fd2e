"""Synthetic ScanNet-style scenes (no dataset on disk).

The port's own copy of the JAX package's numpy generator
(``cagroup3d_tpu/utils/synthetic.py``): ~100k coloured points on room
surfaces (floor and walls) plus box-shaped furniture objects with GT
boxes.  It draws the same numbers from a ``np.random.RandomState`` as the
JAX package's copy, so both packages see the same scenes for a seed.  With
``yaw`` (SUN RGB-D-style scenes, an option of this copy only) each object
also draws a heading in [0, 2 pi) after everything else, and its points
turn with it about the box centre.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def box_local_xy(xy: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Points' BEV coordinates [..., 2] in the frame of a box (x, y, z, dx,
    dy, dz, heading): the inverse of the object placement below, the
    frame in which the one-stage assigner tests a point inside a box."""
    c, s = np.cos(box[6]), np.sin(box[6])
    dx, dy = xy[..., 0] - box[0], xy[..., 1] - box[1]
    return np.stack([dx * c - dy * s, dx * s + dy * c], -1)


def synthetic_scene(rng: np.random.RandomState, n_points=100_000,
                    room=(8.0, 8.0, 3.0), n_objects=12, n_classes=18,
                    yaw=False):
    W, L, H = room
    n_floor = n_points // 3
    n_wall = n_points // 6
    n_obj = n_points - n_floor - n_wall

    floor = np.stack([rng.rand(n_floor) * W, rng.rand(n_floor) * L,
                      rng.rand(n_floor) * 0.05], -1)
    wx = rng.rand(n_wall) * W
    wy = (rng.rand(n_wall) > 0.5).astype(np.float32) * L
    wall = np.stack([wx, wy + rng.randn(n_wall) * 0.02,
                     rng.rand(n_wall) * H], -1)

    centers = np.stack([rng.rand(n_objects) * (W - 2) + 1,
                        rng.rand(n_objects) * (L - 2) + 1,
                        rng.rand(n_objects) * 0.8 + 0.4], -1)
    sizes = rng.rand(n_objects, 3) * np.array([1.2, 1.2, 1.0]) + 0.3
    labels = rng.randint(0, n_classes, n_objects)
    per = n_obj // n_objects
    obj_pts = []
    for i in range(n_objects):
        # points near the box faces, strictly inside the GT box (points on
        # a face fail the inside-box test and starve the assigner)
        u = (rng.rand(per, 3) - 0.5) * 0.9
        face = rng.randint(0, 3, per)
        sign = rng.choice([-0.45, 0.45], per)
        u[np.arange(per), face] = sign
        obj_pts.append(u * sizes[i])
    headings = np.zeros(n_objects)
    if yaw:
        headings = rng.rand(n_objects) * 2 * np.pi
    for i, (local, a) in enumerate(zip(obj_pts, headings)):
        # box-local (u, v) -> (u cos a + v sin a, -u sin a + v cos a): the
        # heading of the mmdet3d depth boxes the one-stage head is given
        c, s = np.cos(a), np.sin(a)
        xy = np.stack([local[:, 0] * c + local[:, 1] * s,
                       -local[:, 0] * s + local[:, 1] * c], -1) \
            if yaw else local[:, :2]
        obj_pts[i] = centers[i] + np.concatenate([xy, local[:, 2:]], -1)
    obj = np.concatenate(obj_pts)[: n_obj]
    pts = np.concatenate([floor, wall, obj]).astype(np.float32)
    rgb = (rng.rand(len(pts), 3) * 255).astype(np.float32)
    points = np.concatenate([pts, rgb], -1)

    gt = np.concatenate([centers, sizes, headings[:, None],
                         labels[:, None].astype(np.float32)],
                        -1).astype(np.float32)
    return points, gt


def synthetic_batch(rng, batch_size=1, n_points=100_000, point_cap=100_000,
                    max_gt=64, n_classes=18, n_objects=12, room=(8., 8., 3.),
                    yaw=False):
    """A padded numpy batch: points [B, point_cap, 6], points_valid,
    gt_boxes [B, max_gt, 8] (xyz, size, heading -- 0 unless ``yaw`` --,
    label), gt_valid, and empty semantic/instance masks (every point
    unlabelled)."""
    pts = np.zeros((batch_size, point_cap, 6), np.float32)
    pvalid = np.zeros((batch_size, point_cap), bool)
    gt = np.zeros((batch_size, max_gt, 8), np.float32)
    gvalid = np.zeros((batch_size, max_gt), bool)
    sem = np.full((batch_size, point_cap), n_classes, np.int32)
    ins = np.zeros((batch_size, point_cap), np.int32)
    for b in range(batch_size):
        p, g = synthetic_scene(rng, n_points, room=room,
                               n_objects=n_objects, n_classes=n_classes,
                               yaw=yaw)
        n = min(len(p), point_cap)
        pts[b, :n] = p[:n]
        pvalid[b, :n] = True
        m = min(len(g), max_gt)
        gt[b, :m] = g[:m]
        gvalid[b, :m] = True
    return dict(points=pts, points_valid=pvalid, gt_boxes=gt,
                gt_valid=gvalid, semantic_mask=sem, instance_mask=ins)


def synthetic_request(seed: int, device, n_points: int = 100_000,
                      **kw) -> Dict[str, torch.Tensor]:
    """One scene as a ``forward_eval`` batch: points f32[1, n_points, 6]
    (xyz, rgb 0..255) and points_valid bool[1, n_points] on ``device``.
    Extra keywords (``room``, ``n_objects``, ``n_classes``, ``yaw``) go to
    ``synthetic_batch``."""
    b = synthetic_batch(np.random.RandomState(seed), batch_size=1,
                        n_points=n_points, point_cap=n_points, **kw)
    return {k: torch.from_numpy(b[k]).to(device)
            for k in ("points", "points_valid")}
