"""Synthetic ScanNet-style scenes (no dataset on disk).

The port's own copy of the JAX package's numpy generator
(``cagroup3d_tpu/utils/synthetic.py``): ~100k coloured points on room
surfaces (floor and walls) plus box-shaped furniture objects with GT
boxes.  It draws the same numbers from a ``np.random.RandomState`` as the
JAX package's copy, so both packages see the same scenes for a seed.  With
``yaw`` (SUN RGB-D-style scenes, an option of this copy only) each object
also draws a heading in [0, 2 pi) after everything else, and its points
turn with it about the box centre.  ``write_indoor_tree`` writes such
scenes as an mmdet3d-format ScanNet or SUN RGB-D dataset tree, and
``write_kitti_tree`` raw KITTI lidar frames (``kitti_frame``) with their
infos.
"""
from __future__ import annotations

import logging
import pickle
from pathlib import Path
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


# nyu40 category ids of the ScanNet classes, in CLASS_NAMES order (the
# dataset YAML's ``valid_cat_ids``); 40 ("otherprop") is outside them
SCANNET_CAT_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34,
                   36, 39)
OTHER_CAT_ID, OTHER_NAME = 40, "otherprop"


def points_in_boxes(xyz: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """bool [N, M]: point n strictly inside box m (x, y, z, dx, dy, dz,
    heading), tested in the box's frame as ``box_local_xy`` gives it (the
    frame the synthetic objects are placed in)."""
    inside = np.zeros((len(xyz), len(boxes)), bool)
    for m, box in enumerate(boxes):
        inside[:, m] = np.all(np.abs(box_local_xy(xyz[:, :2], box)) <
                              box[3:5] / 2, axis=-1) & \
            (np.abs(xyz[:, 2] - box[2]) < box[5] / 2)
    return inside


def align_points(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Points [N, 6] from a scan's raw frame into its axis-aligned frame,
    ``xyz @ R^T + t`` in float32 for the 4 x 4 ``matrix``'s rotation R and
    translation t (the ScanNet ``axis_align_matrix``)."""
    out = points.copy()
    out[:, :3] = points[:, :3] @ matrix[:3, :3].T + matrix[:3, -1]
    return out


def _scene_exact(rng, n_points, room, n_objects, n_classes, yaw):
    """``synthetic_scene`` topped up with floor points to exactly
    ``n_points`` (its objects take a whole number of points each), so
    that SUN RGB-D's ``indoor_point_sample`` at ``n_points`` keeps every
    point."""
    points, gt = synthetic_scene(rng, n_points, room=room,
                                 n_objects=n_objects, n_classes=n_classes,
                                 yaw=yaw)
    k = n_points - len(points)
    extra = np.stack([rng.rand(k) * room[0], rng.rand(k) * room[1],
                      rng.rand(k) * 0.05, *(rng.rand(3, k) * 255)], -1)
    return np.concatenate([points, extra.astype(np.float32)]), gt


def write_indoor_tree(root, dataset: str, class_names, n_scenes: int,
                      n_points: int = 100_000, seed: int = 0,
                      n_objects: int = 12, room=(8.0, 8.0, 3.0)) -> Dict:
    """Write an mmdet3d-format ScanNet (``dataset="scannet"``) or SUN RGB-D
    (``"sunrgbd"``) tree of ``synthetic_scene`` scenes under ``root``: the
    train and val pkl infos (the same scenes) and ``points/*.bin``, plus
    ScanNet's ``instance_mask`` and ``semantic_mask`` (nyu40 ids).

    Every GT box of the infos is an object in the points.  Each info's
    ``class`` is the box's index in ``class_names``; the last object is
    named ``OTHER_NAME``, outside them, and is left out of ``class`` (so
    the evaluator, which reads ``class``, sees the GT that the loader's
    class filter keeps).  ScanNet points are stored in a raw frame: each
    scene draws a z rotation and a translation as its
    ``axis_align_matrix``, and the GT boxes stay in the aligned frame.
    SUN RGB-D boxes are headed ``gt_boxes_upright_depth``.

    Returns {frame_id: int64 [n_in_class]}: per in-class GT box, in info
    order, the number of points inside it in the aligned frame, counted on
    the stored points as ``align_points`` moves them (float32, so the count
    matches a correct loader's to the bit)."""
    root = Path(root)
    sun = dataset == "sunrgbd"
    if dataset not in ("scannet", "sunrgbd"):
        raise ValueError(f"unknown dataset {dataset!r}")
    (root / "points").mkdir(parents=True, exist_ok=True)
    if not sun:
        (root / "instance_mask").mkdir(exist_ok=True)
        (root / "semantic_mask").mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    names_all = np.array(list(class_names) + [OTHER_NAME])
    infos, counts = [], {}
    for i in range(n_scenes):
        points, gt = _scene_exact(rng, n_points, room, n_objects,
                                  len(class_names), sun)
        labels = gt[:, 7].astype(np.int64)
        names = names_all[labels]
        names[-1] = OTHER_NAME
        boxes = gt[:, :7]
        if sun:
            frame_id = i + 1
            raw, matrix = points, None
            fname = str(frame_id).zfill(6)
        else:
            frame_id = fname = f"scene{i:04d}_00"
            a = rng.uniform(-np.pi, np.pi)
            t = np.array([*rng.uniform(-3.0, 3.0, 2), rng.uniform(0, 0.5)])
            matrix = np.eye(4, dtype=np.float32)
            matrix[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            matrix[:3, 3] = t
            raw = points.copy()       # aligned = raw R^T + t
            raw[:, :3] = ((points[:, :3].astype(np.float64) - t) @
                          matrix[:3, :3].astype(np.float64)).astype(
                              np.float32)
            points = align_points(raw, matrix)
        raw.astype(np.float32).tofile(root / "points" / f"{fname}.bin")
        inside = points_in_boxes(points[:, :3], boxes)
        counts[frame_id] = inside[:, :-1].sum(0).astype(np.int64)
        if not sun:
            # first box in index order wins; background 0 (unannotated)
            cat = np.array([SCANNET_CAT_IDS[c] for c in labels[:-1]] +
                           [OTHER_CAT_ID])
            first = np.where(inside.any(1), inside.argmax(1), -1)
            sem = np.where(first >= 0, cat[first], 0).astype(np.int64)
            ins = (first + 1).astype(np.int64)
            sem.tofile(root / "semantic_mask" / f"{fname}.bin")
            ins.tofile(root / "instance_mask" / f"{fname}.bin")
        annos = dict(gt_num=len(boxes), name=names,
                     location=boxes[:, :3].copy(),
                     dimensions=boxes[:, 3:6].copy(),
                     gt_boxes_upright_depth=boxes.copy(),
                     index=np.arange(len(boxes), dtype=np.int32),
                     **{"class": labels[:-1]})
        if sun:
            annos["rotation_y"] = boxes[:, 6].copy()
        else:
            annos["axis_align_matrix"] = matrix
        infos.append(dict(point_cloud=dict(num_features=6,
                                           lidar_idx=frame_id),
                          annos=annos))
    prefix = "sunrgbd" if sun else "scannet"
    for split in ("train", "val"):
        with open(root / f"{prefix}_infos_{split}.pkl", "wb") as f:
            pickle.dump(infos, f)
    return counts


# A real KITTI calibration (object split, frame 000000's camera rig).
KITTI_CALIB = """P0: 707.0493 0 604.0814 0 0 707.0493 180.5066 0 0 0 1 0
P1: 707.0493 0 604.0814 -379.7842 0 707.0493 180.5066 0 0 0 1 0
P2: 707.0493 0 604.0814 45.75831 0 707.0493 180.5066 -0.3454157 0 0 1 0.004981016
P3: 707.0493 0 604.0814 -334.1081 0 707.0493 180.5066 2.33966 0 0 1 0.003201153
R0_rect: 0.9999128 0.01009263 -0.008511932 -0.01012729 0.9999406 -0.004037671 0.008470675 0.004123522 0.9999556
Tr_velo_to_cam: 0.006927964 -0.9999722 -0.002757829 -0.02457729 -0.001162982 0.002749836 -0.9999955 -0.06127237 0.9999753 0.006931141 0.003111131 -0.3321029
Tr_imu_to_velo: 0.9999976 0.0007553071 -0.002035826 -0.8086759 -0.0007854027 0.9998898 -0.01482298 0.3195559 0.002024406 0.01482454 0.9998881 -0.7997231
"""
KITTI_SIZES = {"Car": (3.9, 1.6, 1.56), "Pedestrian": (0.8, 0.6, 1.73),
               "Cyclist": (1.76, 0.6, 1.73)}
KITTI_IMAGE = (375, 1242)
GROUND_Z = -1.73          # the lidar sits 1.73 m above the road


def kitti_frame(rng: np.random.RandomState, n_points: int = 120_000,
                n_objects: int = 18):
    """One synthetic 360-degree lidar frame: ``n_points`` points (x, y, z,
    intensity) f32 on a ground plane (denser near the sensor), two walls
    along the road and ``n_objects`` labelled objects (Car, Pedestrian and
    Cyclist in turn) 6-27 m ahead inside the camera's view, apart from each
    other, each a box of 200-600 points.  Returns (points [n_points, 4],
    names [n], boxes [n, 7] lidar (x, y, z centre, l, w, h, heading))."""
    names = [list(KITTI_SIZES)[i % 3] for i in range(n_objects)]
    boxes, radii = [], []
    for name in names:
        l, w, h = KITTI_SIZES[name]
        r = np.hypot(l, w) / 2
        for _ in range(1000):
            x = rng.uniform(6.0, 27.0)
            y = rng.uniform(-0.7, 0.7) * x
            if all(np.hypot(x - b[0], y - b[1]) > r + q + 0.5
                   for b, q in zip(boxes, radii)):
                break
        else:
            raise ValueError(f"no room for {n_objects} objects")
        boxes.append(np.array([x, y, GROUND_Z + h / 2, l, w, h,
                               rng.uniform(-np.pi, np.pi)], np.float32))
        radii.append(r)
    boxes = np.stack(boxes)
    n_obj_pts = [int(rng.randint(200, 600)) for _ in names]
    n_wall = n_points // 5
    n_ground = n_points - n_wall - sum(n_obj_pts)
    if n_ground <= 0:
        raise ValueError(f"{n_points} points do not cover the objects")
    r = 3.0 + 77.0 * rng.rand(n_ground) ** 2
    a = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(a), r * np.sin(a),
                       GROUND_Z + rng.randn(n_ground) * 0.02], -1)
    side = np.where(rng.rand(n_wall) < 0.5, -1.0, 1.0)
    wall = np.stack([rng.uniform(-70, 70, n_wall),
                     side * (28.0 + rng.rand(n_wall) * 0.3),
                     rng.uniform(GROUND_Z, 2.5, n_wall)], -1)
    objs = []
    for b, n in zip(boxes, n_obj_pts):
        u = (rng.rand(n, 3) - 0.5) * 0.95 * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        objs.append(np.stack([u[:, 0] * c - u[:, 1] * s + b[0],
                              u[:, 0] * s + u[:, 1] * c + b[1],
                              u[:, 2] + b[2]], -1))
    xyz = np.concatenate([ground, wall] + objs)
    pts = np.concatenate([xyz, rng.rand(len(xyz), 1)], -1).astype(np.float32)
    return pts[rng.permutation(len(pts))], np.array(names), boxes


def write_kitti_tree(root, n_frames: int, n_points: int = 120_000,
                     seed: int = 0, n_objects: int = 18,
                     n_train: int = 1) -> Dict:
    """Write a raw KITTI object tree of ``kitti_frame`` frames under
    ``root`` (``training/velodyne/*.bin``, ``calib/*.txt`` with a real
    KITTI calibration, ``label_2/*.txt`` in the camera frame, no images:
    the infos take the 375 x 1242 fallback; ``ImageSets/val.txt`` all the
    frames, ``train.txt`` the first ``n_train``), then run
    ``create_kitti_infos`` over it (the infos and the train gt database).

    Labels carry truncation 0, occlusion 0 and the 2-D box of the
    projected 3-D box, so every object is 'easy' (taller than 40 px) and
    counts in all three difficulties.  The official AP reaches 100 only
    with at least 41 GT boxes of a class (41 recall samples), so a tree
    for an AP check needs n_frames * n_objects / 3 >= 41.  Returns
    {frame_id: number of points inside the point-cloud range [0, -40, -3,
    70.4, 40, 1)}."""
    from ..datasets.kitti_infos import create_kitti_infos, parse_calib_file
    from .box_utils import boxes_camera_to_imageboxes, boxes_lidar_to_camera
    root = Path(root)
    sub = root / "training"
    for d in ("velodyne", "calib", "label_2"):
        (sub / d).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = [f"{i:06d}" for i in range(n_frames)]
    (sub / "calib" / "tmp.txt").write_text(KITTI_CALIB)
    calib = parse_calib_file(sub / "calib" / "tmp.txt")
    (sub / "calib" / "tmp.txt").unlink()
    R0, V2C = calib["R0_rect"][:3, :3], calib["Tr_velo_to_cam"][:3]
    lo = np.array([0, -40, -3], np.float32)
    hi = np.array([70.4, 40, 1], np.float32)
    in_range = {}
    for idx in ids:
        pts, names, boxes = kitti_frame(rng, n_points, n_objects)
        pts.tofile(sub / "velodyne" / f"{idx}.bin")
        (sub / "calib" / f"{idx}.txt").write_text(KITTI_CALIB)
        cam = boxes_lidar_to_camera(boxes, R0, V2C)
        bbox = boxes_camera_to_imageboxes(cam, calib["P2"], KITTI_IMAGE)
        alpha = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
        lines = []
        for n, c, bb, al in zip(names, cam, bbox, alpha):
            # KITTI order: h w l, location (bottom centre), rotation_y
            lines.append(" ".join([n, "0.00", "0", f"{al:.6f}"] +
                                  [f"{v:.4f}" for v in bb] +
                                  [f"{c[4]:.6f}", f"{c[5]:.6f}",
                                   f"{c[3]:.6f}"] +
                                  [f"{v:.6f}" for v in c[:3]] +
                                  [f"{c[6]:.6f}"]))
        (sub / "label_2" / f"{idx}.txt").write_text("\n".join(lines) + "\n")
        in_range[idx] = int(np.all((pts[:, :3] >= lo) & (pts[:, :3] < hi),
                                   axis=1).sum())
    (root / "ImageSets" / "val.txt").write_text("\n".join(ids) + "\n")
    (root / "ImageSets" / "train.txt").write_text(
        "\n".join(ids[:n_train]) + "\n")
    (root / "ImageSets" / "test.txt").write_text("")
    create_kitti_infos(root, class_names=tuple(KITTI_SIZES),
                       logger=logging.getLogger(__name__))
    return in_range
