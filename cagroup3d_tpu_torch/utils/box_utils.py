"""Host-side numpy box and KITTI frame helpers.

The port's own copies of ``cagroup3d_tpu/utils/box_utils.py`` and of the
frame conversions of ``cagroup3d_tpu/datasets/kitti_dataset.py`` (the
reference's pcdet/utils/box_utils.py and utils/calibration_kitti.py), and
of ``points_in_boxes_np`` from ``cagroup3d_tpu/datasets/augmentor.py``.
Lidar boxes are (x, y, z centre, l, w, h, heading); KITTI camera boxes
(x, y, z bottom centre, l, h, w, rotation_y).
"""
from __future__ import annotations

import numpy as np


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """points [N, 3+C], scalar angle (x ==> y)."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], points.dtype)
    out = points.copy()
    out[:, :3] = points[:, :3] @ rot
    return out


def boxes_to_corners_3d(boxes7: np.ndarray) -> np.ndarray:
    """[N, 7] -> [N, 8, 3] corners."""
    template = np.array(
        [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float32) / 2
    corners = boxes7[:, None, 3:6] * template[None]
    c, s = np.cos(boxes7[:, 6]), np.sin(boxes7[:, 6])
    x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    out = np.stack([x, y, corners[..., 2]], -1)
    return out + boxes7[:, None, 0:3]


def mask_boxes_outside_range_numpy(boxes, limit_range, min_num_corners=1):
    """bool [N]: boxes with >= min_num_corners corners inside the range."""
    corners = boxes_to_corners_3d(boxes)
    r = np.asarray(limit_range)
    inside = np.all((corners >= r[:3]) & (corners <= r[3:6]), axis=2)
    return inside.sum(axis=1) >= min_num_corners


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    out = boxes3d.copy()
    out[:, 3:6] += 2 * np.asarray(extra_width)
    return out


def points_in_boxes_np(points, boxes7):
    """bool [P, N]: point inside the rotated 3D box."""
    if len(boxes7) == 0 or len(points) == 0:
        return np.zeros((len(points), len(boxes7)), bool)
    d = points[:, None, :3] - boxes7[None, :, :3]
    c, s = np.cos(boxes7[:, 6]), np.sin(boxes7[:, 6])
    u = d[..., 0] * c[None] + d[..., 1] * s[None]
    v = -d[..., 0] * s[None] + d[..., 1] * c[None]
    return (np.abs(u) <= boxes7[None, :, 3] / 2) & \
        (np.abs(v) <= boxes7[None, :, 4] / 2) & \
        (np.abs(d[..., 2]) <= boxes7[None, :, 5] / 2)


# ---------------------------------------------------------------------------
# KITTI frames (calibration_kitti.Calibration)
# ---------------------------------------------------------------------------

def _rect_from_lidar(R0, V2C):
    R0_ext = np.eye(4, dtype=np.float32)
    R0_ext[:3, :3] = R0
    V2C_ext = np.vstack([V2C, np.array([0, 0, 0, 1], np.float32)])
    return R0_ext @ V2C_ext


def rect_to_lidar(pts_rect, R0, V2C):
    pts_hom = np.hstack([pts_rect, np.ones((len(pts_rect), 1), np.float32)])
    return (pts_hom @ np.linalg.inv(_rect_from_lidar(R0, V2C)).T)[:, :3]


def lidar_to_rect(pts_lidar, R0, V2C):
    pts_hom = np.hstack([pts_lidar,
                         np.ones((len(pts_lidar), 1), np.float32)])
    return (pts_hom @ _rect_from_lidar(R0, V2C).T)[:, :3]


def boxes_camera_to_lidar(boxes_cam, R0, V2C):
    """box_utils.boxes3d_kitti_camera_to_lidar."""
    xyz, r = boxes_cam[:, 0:3], boxes_cam[:, 6:7]
    l, h, w = boxes_cam[:, 3:4], boxes_cam[:, 4:5], boxes_cam[:, 5:6]
    xyz_lidar = rect_to_lidar(xyz, R0, V2C)
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes_lidar_to_camera(boxes7, R0, V2C):
    """box_utils.boxes3d_lidar_to_kitti_camera."""
    xyz = boxes7[:, 0:3].copy()
    l, w, h = boxes7[:, 3:4], boxes7[:, 4:5], boxes7[:, 5:6]
    xyz[:, 2] -= h[:, 0] / 2
    xyz_cam = lidar_to_rect(xyz, R0, V2C)
    r = -boxes7[:, 6:7] - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r], axis=-1)


def boxes_camera_to_imageboxes(boxes_cam, P2, image_shape=None):
    """box_utils.boxes3d_kitti_camera_to_imageboxes: the 8 camera-frame
    corners projected through P2, their axis-aligned hull clipped to the
    image."""
    n = len(boxes_cam)
    if n == 0:
        return np.zeros((0, 4), np.float32)
    l, h, w = boxes_cam[:, 3], boxes_cam[:, 4], boxes_cam[:, 5]
    ry = boxes_cam[:, 6]
    xs = np.stack([l / 2, l / 2, -l / 2, -l / 2] * 2, -1)
    ys = np.stack([np.zeros(n)] * 4 + [-h] * 4, -1)
    zs = np.stack([w / 2, -w / 2, -w / 2, w / 2] * 2, -1)
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    x = c * xs + s * zs
    z = -s * xs + c * zs
    corners = np.stack([x, ys, z], -1) + boxes_cam[:, None, 0:3]
    hom = np.concatenate([corners, np.ones((n, 8, 1))], -1)
    img = hom @ np.asarray(P2).T
    uv = img[..., :2] / np.maximum(img[..., 2:3], 1e-6)
    boxes = np.concatenate([uv.min(1), uv.max(1)], -1).astype(np.float32)
    if image_shape is not None:
        boxes[:, 0] = np.clip(boxes[:, 0], 0, image_shape[1] - 1)
        boxes[:, 1] = np.clip(boxes[:, 1], 0, image_shape[0] - 1)
        boxes[:, 2] = np.clip(boxes[:, 2], 0, image_shape[1] - 1)
        boxes[:, 3] = np.clip(boxes[:, 3], 0, image_shape[0] - 1)
    return boxes
