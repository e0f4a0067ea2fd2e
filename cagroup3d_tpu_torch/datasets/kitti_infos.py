"""KITTI raw data -> infos and the gt database.

The port's own copy of ``cagroup3d_tpu/datasets/kitti_infos.py`` (the
reference's pcdet/datasets/kitti/kitti_dataset.py get_infos /
create_groundtruth_database, utils/object3d_kitti.py and
utils/calibration_kitti.py), writing the same pcdet pickle schemas:
  kitti_infos_{train,val,trainval,test}.pkl: per frame point_cloud,
    image, calib (P2, R0_rect, Tr_velo_to_cam as 4x4) and annos (camera
    frame label fields, gt_boxes_lidar, difficulty, num_points_in_gt);
  kitti_dbinfos_train.pkl and gt_database/*.bin: per-object point crops
    for gt sampling in training.
Pure numpy.  An image's size is read from its PNG header (the IHDR chunk,
the numbers PIL reports), so no imaging library is needed; a frame
without ``image_2/`` gets the JAX package's fallback shape [375, 1242].
"""
from __future__ import annotations

import pickle
import struct
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..utils.box_utils import lidar_to_rect, points_in_boxes_np, \
    rect_to_lidar

_CLS_TO_ID = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}


def parse_calib_file(path) -> Dict[str, np.ndarray]:
    """KITTI calib txt -> {'P2': 4x4, 'R0_rect': 4x4,
    'Tr_velo_to_cam': 4x4} (calibration_kitti.Calibration + the 4x4
    extension in get_infos, kitti_dataset.py:163-169)."""
    vals = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals[k.strip()] = np.asarray(
                [float(x) for x in v.split()], np.float32)
    P2 = np.concatenate([vals["P2"].reshape(3, 4),
                         np.array([[0, 0, 0, 1]], np.float32)], axis=0)
    R0 = np.zeros((4, 4), np.float32)
    R0[3, 3] = 1.0
    R0[:3, :3] = vals["R0_rect"].reshape(3, 3)
    V2C = np.concatenate([vals["Tr_velo_to_cam"].reshape(3, 4),
                          np.array([[0, 0, 0, 1]], np.float32)], axis=0)
    return {"P2": P2, "R0_rect": R0, "Tr_velo_to_cam": V2C}


def _difficulty(box2d, truncation, occlusion) -> int:
    """object3d_kitti.get_kitti_obj_level (0 easy / 1 moderate / 2 hard /
    -1 unknown)."""
    height = float(box2d[3]) - float(box2d[1]) + 1
    if height >= 40 and truncation <= 0.15 and occlusion <= 0:
        return 0
    if height >= 25 and truncation <= 0.3 and occlusion <= 1:
        return 1
    if height >= 25 and truncation <= 0.5 and occlusion <= 2:
        return 2
    return -1


def parse_label_file(path) -> Dict[str, np.ndarray]:
    """KITTI label_2 txt -> pcdet annotations dict (camera frame;
    object3d_kitti.Object3d fields, get_infos annotations block)."""
    rows = []
    with open(path) as f:
        for line in f:
            t = line.strip().split(" ")
            if len(t) < 15:
                continue
            rows.append(t)
    n = len(rows)
    annos = dict(
        name=np.asarray([r[0] for r in rows]),
        truncated=np.asarray([float(r[1]) for r in rows], np.float32),
        occluded=np.asarray([float(r[2]) for r in rows], np.float32),
        alpha=np.asarray([float(r[3]) for r in rows], np.float32),
        bbox=np.asarray([[float(x) for x in r[4:8]] for r in rows],
                        np.float32).reshape(n, 4),
        # lhw (camera) ordering, get_infos: dimensions = [l, h, w]
        dimensions=np.asarray([[float(r[10]), float(r[8]), float(r[9])]
                               for r in rows], np.float32).reshape(n, 3),
        location=np.asarray([[float(x) for x in r[11:14]] for r in rows],
                            np.float32).reshape(n, 3),
        rotation_y=np.asarray([float(r[14]) for r in rows], np.float32),
        score=np.asarray([float(r[15]) if len(r) == 16 else -1.0
                          for r in rows], np.float32),
    )
    annos["difficulty"] = np.asarray(
        [_difficulty(b, t, o) for b, t, o in
         zip(annos["bbox"], annos["truncated"], annos["occluded"])],
        np.int32)
    num_objects = int(np.sum(annos["name"] != "DontCare"))
    annos["index"] = np.asarray(
        list(range(num_objects)) + [-1] * (n - num_objects), np.int32)
    return annos


def _image_shape(path) -> np.ndarray:
    """[height, width] of a PNG from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return np.asarray([h, w], np.int32)


def fov_flag(points_lidar, image_shape, calib) -> np.ndarray:
    """get_fov_flag (kitti_dataset.py:132-148): lidar points whose image
    projection lands inside the frame with positive depth."""
    R0 = calib["R0_rect"][:3, :3]
    V2C = calib["Tr_velo_to_cam"][:3]
    rect = lidar_to_rect(points_lidar[:, :3], R0, V2C)
    hom = np.hstack([rect, np.ones((len(rect), 1), np.float32)])
    img = hom @ calib["P2"].T
    uv = img[:, :2] / np.maximum(img[:, 2:3], 1e-6)
    h, w = int(image_shape[0]), int(image_shape[1])
    return ((uv[:, 0] >= 0) & (uv[:, 0] < w) &
            (uv[:, 1] >= 0) & (uv[:, 1] < h) & (rect[:, 2] >= 0))


def get_infos(root: Path, split: str, sample_ids: List[str],
              has_label: bool = True,
              count_inside_pts: bool = True) -> List[Dict]:
    """Per-frame info dicts (get_infos, kitti_dataset.py:150-225)."""
    root = Path(root)
    sub = root / ("training" if split != "test" else "testing")
    infos = []
    for idx in sample_ids:
        info: Dict = {"point_cloud": dict(num_features=4, lidar_idx=idx)}
        img_file = sub / "image_2" / f"{idx}.png"
        shape = _image_shape(img_file) if img_file.exists() \
            else np.asarray([375, 1242], np.int32)
        info["image"] = dict(image_idx=idx, image_shape=shape)
        calib = parse_calib_file(sub / "calib" / f"{idx}.txt")
        info["calib"] = calib
        if has_label:
            annos = parse_label_file(sub / "label_2" / f"{idx}.txt")
            num_objects = int(np.sum(annos["index"] >= 0))
            loc = annos["location"][:num_objects]
            dims = annos["dimensions"][:num_objects]       # [l, h, w]
            rots = annos["rotation_y"][:num_objects]
            R0 = calib["R0_rect"][:3, :3]
            V2C = calib["Tr_velo_to_cam"][:3]
            loc_lidar = rect_to_lidar(loc, R0, V2C)
            l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
            loc_lidar[:, 2] += h[:, 0] / 2                 # bottom->center
            annos["gt_boxes_lidar"] = np.concatenate(
                [loc_lidar, l, w, h,
                 -(np.pi / 2 + rots[:, None])], axis=1).astype(np.float32)
            if count_inside_pts:
                pts = np.fromfile(str(sub / "velodyne" / f"{idx}.bin"),
                                  np.float32).reshape(-1, 4)
                flag = fov_flag(pts, shape, calib)
                inside = points_in_boxes_np(pts[flag],
                                            annos["gt_boxes_lidar"])
                num = -np.ones(len(annos["name"]), np.int32)
                num[:num_objects] = inside.sum(axis=0)
                annos["num_points_in_gt"] = num
            info["annos"] = annos
        infos.append(info)
    return infos


def create_groundtruth_database(root: Path, info_path: Path,
                                used_classes: Optional[List[str]] = None,
                                split: str = "train",
                                logger=None) -> Path:
    """Crop each GT's points into gt_database/*.bin + dbinfos pickle
    (create_groundtruth_database, kitti_dataset.py:224-273)."""
    root = Path(root)
    db_dir = root / ("gt_database" if split == "train"
                     else f"gt_database_{split}")
    db_dir.mkdir(parents=True, exist_ok=True)
    db_info_path = root / f"kitti_dbinfos_{split}.pkl"
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    all_db: Dict[str, List] = {}
    for info in infos:
        idx = info["point_cloud"]["lidar_idx"]
        sub = root / ("training" if split != "test" else "testing")
        pts = np.fromfile(str(sub / "velodyne" / f"{idx}.bin"),
                          np.float32).reshape(-1, 4)
        annos = info["annos"]
        boxes = annos["gt_boxes_lidar"]
        inside = points_in_boxes_np(pts, boxes)            # [P, N]
        for i in range(len(boxes)):
            name = str(annos["name"][i])
            if used_classes is not None and name not in used_classes:
                continue
            gt_pts = pts[inside[:, i]].copy()
            gt_pts[:, :3] -= boxes[i, :3]
            fn = f"{idx}_{name}_{i}.bin"
            gt_pts.tofile(str(db_dir / fn))
            all_db.setdefault(name, []).append(dict(
                name=name, path=str((db_dir / fn).relative_to(root)),
                image_idx=idx, gt_idx=i, box3d_lidar=boxes[i],
                num_points_in_gt=int(len(gt_pts)),
                difficulty=int(annos["difficulty"][i]),
                bbox=annos["bbox"][i], score=float(annos["score"][i])))
    for k, v in all_db.items():
        (logger.info if logger else print)(f"Database {k}: {len(v)}")
    with open(db_info_path, "wb") as f:
        pickle.dump(all_db, f)
    return db_info_path


def _split_ids(root: Path, split: str) -> List[str]:
    p = Path(root) / "ImageSets" / f"{split}.txt"
    if p.exists():
        return [x.strip() for x in p.read_text().splitlines() if x.strip()]
    sub = Path(root) / ("training" if split != "test" else "testing")
    return sorted(f.stem for f in (sub / "velodyne").glob("*.bin"))


def create_kitti_infos(data_path, save_path=None, workers: int = 4,
                       class_names=("Car", "Pedestrian", "Cyclist"),
                       logger=None) -> None:
    """Full preparation pipeline (create_kitti_infos,
    kitti_dataset.py:430-467): train/val/trainval/test infos + the
    train gt database."""
    root = Path(data_path)
    save = Path(save_path or data_path)
    say = logger.info if logger else print
    out = {}
    for split in ("train", "val"):
        ids = _split_ids(root, split)
        out[split] = get_infos(root, split, ids, has_label=True,
                               count_inside_pts=True)
        with open(save / f"kitti_infos_{split}.pkl", "wb") as f:
            pickle.dump(out[split], f)
        say(f"kitti_infos_{split}: {len(out[split])} frames")
    with open(save / "kitti_infos_trainval.pkl", "wb") as f:
        pickle.dump(out["train"] + out["val"], f)
    test_ids = _split_ids(root, "test")
    if test_ids:
        test_infos = get_infos(root, "test", test_ids, has_label=False,
                               count_inside_pts=False)
        with open(save / "kitti_infos_test.pkl", "wb") as f:
            pickle.dump(test_infos, f)
        say(f"kitti_infos_test: {len(test_infos)} frames")
    create_groundtruth_database(
        root, save / "kitti_infos_train.pkl",
        used_classes=list(class_names), split="train", logger=logger)
    say("KITTI data preparation done")
