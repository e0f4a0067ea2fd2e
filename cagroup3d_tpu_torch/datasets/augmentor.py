"""Data augmentation pipeline (numpy, host-side).

The port's own copy of ``cagroup3d_tpu/datasets/augmentor.py`` (the
reference's pcdet/datasets/augmentor/{data_augmentor,augmentor_utils,
database_sampler}.py) for every stage that the ScanNet, SUN RGB-D and
KITTI dataset YAMLs name -- global_alignment, point_seg_class_mapping,
gt_sampling (``DataBaseSampler``), random_world_flip / rotation /
rotation_mmdet3d / scaling / translation and indoor_point_sample.  The
same math as the JAX package's copy (the mmdet3d rotation sign, the y-flip
heading transform), drawing from the global ``np.random`` stream in the
same order, so one seed gives the same scene in both packages.  Any other
stage name raises ``NotImplementedError``; the local, frustum and pyramid
augmentations are not ported.
"""
from __future__ import annotations

import pickle
from functools import partial
from pathlib import Path

import numpy as np

from ..utils.box_utils import enlarge_box3d, points_in_boxes_np
from .indoor_eval import rotated_intersection_np


def rotate_points_along_z_np(points, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=points.dtype)
    out = points.copy()
    out[:, :3] = points[:, :3] @ rot
    return out


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def global_alignment(points, axis_align_matrix, rotation_axis=2):
    """Points from the scan's raw frame into the axis-aligned frame of the
    GT boxes: ``xyz @ R^T + t`` for the matrix's rotation R and
    translation t."""
    rot = axis_align_matrix[:3, :3]
    trans = axis_align_matrix[:3, -1]
    if not np.allclose(np.linalg.det(rot), 1.0, atol=1e-5):
        raise ValueError("axis_align_matrix is not a rotation and a "
                         "translation")
    points = points.copy()
    points[:, :3] = points[:, :3] @ rot.T + trans
    return points


def point_seg_class_mapping(semantic_mask, valid_cat_ids, max_cat_id):
    """Raw category ids -> indices into ``valid_cat_ids``; every other id
    maps to ``len(valid_cat_ids)`` (unlabelled)."""
    max_cat_id = int(max_cat_id)
    neg = len(valid_cat_ids)
    lut = np.full(max_cat_id + 1, neg, dtype=np.int64)
    for idx, cid in enumerate(valid_cat_ids):
        lut[cid] = idx
    return lut[np.clip(semantic_mask, 0, max_cat_id)]


def random_flip_along_x(gt_boxes, points):
    if np.random.choice([False, True]):
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
    return gt_boxes, points


def random_flip_along_y(gt_boxes, points):
    if np.random.choice([False, True]):
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rot_range, mmdet3d_sign=False):
    noise = np.random.uniform(rot_range[0], rot_range[1])
    points = rotate_points_along_z_np(points, noise)
    gt_boxes[:, 0:3] = rotate_points_along_z_np(gt_boxes[:, 0:3], noise)
    if mmdet3d_sign:
        gt_boxes[:, 6] -= noise
    else:
        gt_boxes[:, 6] += noise
    return gt_boxes, points


def global_scaling(gt_boxes, points, scale_range):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    s = np.random.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= s
    gt_boxes[:, :6] *= s
    return gt_boxes, points


def random_translation(gt_boxes, points, std, axes=("x", "y", "z")):
    ax_map = {"x": 0, "y": 1, "z": 2}
    for a in axes:
        off = np.random.normal(0, std, 1)
        points[:, ax_map[a]] += off
        gt_boxes[:, ax_map[a]] += off
    return gt_boxes, points


def points_random_sampling(points, num_samples):
    """(points[choices], choices): ``num_samples`` draws, with replacement
    only when the scene has fewer points."""
    replace = points.shape[0] < num_samples
    choices = np.random.choice(points.shape[0], num_samples, replace=replace)
    return points[choices], choices


class DataBaseSampler:
    """GT-paste augmentation for outdoor training (the reference's
    database_sampler.py; the JAX package's ``DataBaseSampler``): draw
    pre-cropped object point clouds from the gt database and paste those
    that overlap no box in BEV into the scene.

    The db infos are filtered by the ``PREPARE`` filters; each class of
    ``SAMPLE_GROUPS`` draws round-robin from a permutation of its infos
    that is redrawn (from the global ``np.random``) when it runs out; the
    collision test is the rotated BEV intersection of
    ``indoor_eval.rotated_intersection_np``; the pasted boxes' points
    (enlarged by ``REMOVE_EXTRA_WIDTH``) are carved out of the scene before
    the objects' points go in front.  ``USE_ROAD_PLANE`` is read and, as in
    the JAX package, not applied: sampled boxes keep their database height
    (the reference moves them onto the frame's road plane)."""

    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.class_names = list(class_names)
        self.num_point_features = int(sampler_cfg.get(
            "NUM_POINT_FEATURES", 4))
        self.remove_extra_width = [float(x) for x in sampler_cfg.get(
            "REMOVE_EXTRA_WIDTH", [0.0, 0.0, 0.0])]
        self.limit_whole_scene = bool(sampler_cfg.get(
            "LIMIT_WHOLE_SCENE", False))
        self.use_road_plane = bool(sampler_cfg.get("USE_ROAD_PLANE", False))
        self.db_infos = {c: [] for c in self.class_names}
        for rel in sampler_cfg.get("DB_INFO_PATH", []):
            path = self.root_path / rel
            if not path.exists():
                if logger:
                    logger.warning(f"gt_sampling: missing db infos {path}")
                continue
            with open(path, "rb") as f:
                infos = pickle.load(f)
            for c in self.class_names:
                self.db_infos[c].extend(infos.get(c, []))
        for fn_name, val in dict(sampler_cfg.get("PREPARE", {})).items():
            self.db_infos = getattr(self, fn_name)(self.db_infos, val)
        self.sample_groups = {}
        for spec in sampler_cfg.get("SAMPLE_GROUPS", []):
            name, num = str(spec).split(":")
            if name in self.class_names:
                n = len(self.db_infos[name])
                self.sample_groups[name] = dict(
                    target=int(num), pointer=n, indices=np.arange(n))

    # -- PREPARE filters ------------------------------------------------
    def filter_by_difficulty(self, db_infos, removed_difficulty):
        return {k: [i for i in v
                    if i.get("difficulty", 0) not in removed_difficulty]
                for k, v in db_infos.items()}

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for spec in min_gt_points_list:
            name, num = str(spec).split(":")
            if int(num) > 0 and name in db_infos:
                db_infos[name] = [i for i in db_infos[name]
                                  if i.get("num_points_in_gt", 0) >=
                                  int(num)]
        return db_infos

    # -------------------------------------------------------------------
    def _draw(self, name, n):
        """The next n infos of the class's permutation, a new permutation
        when fewer than n are left (sample_with_fixed_number)."""
        grp = self.sample_groups[name]
        infos = self.db_infos[name]
        if grp["pointer"] + n > len(infos):
            grp["indices"] = np.random.permutation(len(infos))
            grp["pointer"] = 0
        picked = [infos[i] for i in
                  grp["indices"][grp["pointer"]:grp["pointer"] + n]]
        grp["pointer"] += n
        return picked

    def __call__(self, data_dict):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"].astype(str)
        W = gt_boxes.shape[1] if gt_boxes.size else 7
        existed = gt_boxes[:, :7].copy()
        accepted, accepted_boxes = [], []
        for name, grp in self.sample_groups.items():
            n = grp["target"]
            if self.limit_whole_scene:
                n -= int(np.sum(gt_names == name))
            n = min(n, len(self.db_infos[name]))
            if n <= 0:
                continue
            cands = self._draw(name, n)
            boxes = np.stack([np.asarray(c["box3d_lidar"], np.float32)[:W]
                              for c in cands])
            if boxes.shape[1] < W:               # db boxes without velocity
                boxes = np.concatenate(
                    [boxes, np.zeros((len(boxes), W - boxes.shape[1]),
                                     np.float32)], axis=1)
            # collision-free: no BEV overlap with the scene's boxes, the
            # boxes accepted so far, or another candidate of this draw
            bev = boxes[:, [0, 1, 3, 4, 6]]
            i1 = rotated_intersection_np(bev, existed[:, [0, 1, 3, 4, 6]])
            i2 = rotated_intersection_np(bev, bev)
            np.fill_diagonal(i2, 0.0)
            ok = (i1.max(1, initial=0.0) + i2.max(1)) == 0
            for i in np.flatnonzero(ok):
                accepted.append(cands[i])
                accepted_boxes.append(boxes[i])
                existed = np.concatenate([existed, boxes[i:i + 1, :7]])
        obj_pts, keep_boxes, keep_names = [], [], []
        for info, box in zip(accepted, accepted_boxes):
            f = self.root_path / info["path"]
            if not f.exists():
                continue
            pts = np.fromfile(str(f), np.float32).reshape(
                -1, self.num_point_features).copy()
            pts[:, :3] += box[:3]
            obj_pts.append(pts)
            keep_boxes.append(box)
            keep_names.append(info["name"])
        if not keep_boxes:
            return data_dict
        sampled_boxes = np.stack(keep_boxes)
        obj_pts = np.concatenate(obj_pts, axis=0)
        points = data_dict["points"]
        big = enlarge_box3d(sampled_boxes, self.remove_extra_width)
        inside = points_in_boxes_np(points, big).any(axis=1)
        mask = data_dict.get("gt_boxes_mask", np.ones(len(gt_boxes), bool))
        data_dict["points"] = np.concatenate(
            [obj_pts[:, :points.shape[1]], points[~inside]], axis=0)
        data_dict["gt_boxes"] = np.concatenate(
            [gt_boxes[mask][:, :W], sampled_boxes], axis=0)
        data_dict["gt_names"] = np.concatenate(
            [gt_names[mask], np.asarray(keep_names)])
        data_dict.pop("gt_boxes_mask", None)
        return data_dict


class DataAugmentor:
    """Pipeline driver (the reference's data_augmentor.py:19-24, 295-326):
    the stages of ``AUG_CONFIG_LIST`` less ``DISABLE_AUG_LIST``, in order,
    then the heading wrapped into [-pi, pi) and the GT boxes outside
    ``gt_boxes_mask`` (when given) dropped.  ``gt_sampling`` reads its
    database under ``root_path``; ``class_names`` names the classes it
    samples."""

    STAGES = ("global_alignment", "point_seg_class_mapping", "gt_sampling",
              "random_world_flip", "random_world_rotation",
              "random_world_rotation_mmdet3d", "random_world_scaling",
              "random_world_translation", "indoor_point_sample")

    def __init__(self, root_path, augmentor_configs, class_names,
                 logger=None):
        self.queue = []
        disable = augmentor_configs.get("DISABLE_AUG_LIST", [])
        for cfg in augmentor_configs.AUG_CONFIG_LIST:
            if cfg.NAME in disable:
                continue
            if cfg.NAME not in self.STAGES:
                raise NotImplementedError(
                    f"augmentor stage {cfg.NAME!r} is not ported (ported "
                    f"stages: {', '.join(self.STAGES)})")
            if cfg.NAME == "gt_sampling":
                sampler = DataBaseSampler(root_path, cfg, class_names,
                                          logger=logger)
                self.queue.append(lambda data_dict, _s=sampler: _s(data_dict))
                continue
            self.queue.append(partial(getattr(self, cfg.NAME), config=cfg))

    # -- pipeline stages -------------------------------------------------
    def global_alignment(self, data_dict, config):
        data_dict["points"] = global_alignment(
            data_dict["points"], data_dict["axis_align_matrix"],
            config.get("rotation_axis", 2))
        return data_dict

    def point_seg_class_mapping(self, data_dict, config):
        if "semantic_mask" in data_dict:
            data_dict["semantic_mask"] = point_seg_class_mapping(
                data_dict["semantic_mask"], config["valid_cat_ids"],
                config["max_cat_id"])
        return data_dict

    def random_world_flip(self, data_dict, config):
        gt, pts = data_dict["gt_boxes"], data_dict["points"]
        for ax in config["ALONG_AXIS_LIST"]:
            fn = {"x": random_flip_along_x, "y": random_flip_along_y}[ax]
            gt, pts = fn(gt, pts)
        data_dict["gt_boxes"], data_dict["points"] = gt, pts
        return data_dict

    def random_world_rotation(self, data_dict, config, mmdet3d_sign=False):
        rr = config["WORLD_ROT_ANGLE"]
        rr = rr if isinstance(rr, list) else [-rr, rr]
        gt, pts = global_rotation(data_dict["gt_boxes"], data_dict["points"],
                                  rr, mmdet3d_sign=mmdet3d_sign)
        data_dict["gt_boxes"], data_dict["points"] = gt, pts
        return data_dict

    def random_world_rotation_mmdet3d(self, data_dict, config):
        return self.random_world_rotation(data_dict, config,
                                          mmdet3d_sign=True)

    def random_world_scaling(self, data_dict, config):
        gt, pts = global_scaling(data_dict["gt_boxes"], data_dict["points"],
                                 config["WORLD_SCALE_RANGE"])
        data_dict["gt_boxes"], data_dict["points"] = gt, pts
        return data_dict

    def random_world_translation(self, data_dict, config):
        std = config["NOISE_TRANSLATE_STD"]
        if std == 0:
            return data_dict
        gt, pts = random_translation(data_dict["gt_boxes"],
                                     data_dict["points"], std,
                                     config["ALONG_AXIS_LIST"])
        data_dict["gt_boxes"], data_dict["points"] = gt, pts
        return data_dict

    def indoor_point_sample(self, data_dict, config):
        pts, choices = points_random_sampling(data_dict["points"],
                                              config["num_points"])
        data_dict["points"] = pts
        for k in ("instance_mask", "semantic_mask"):
            if data_dict.get(k) is not None:
                data_dict[k] = data_dict[k][choices]
        return data_dict

    # --------------------------------------------------------------------
    def forward(self, data_dict):
        for fn in self.queue:
            data_dict = fn(data_dict=data_dict)
        data_dict["gt_boxes"][:, 6] = limit_period(
            data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi)
        if "gt_boxes_mask" in data_dict:
            m = data_dict.pop("gt_boxes_mask")
            data_dict["gt_boxes"] = data_dict["gt_boxes"][m]
            data_dict["gt_names"] = data_dict["gt_names"][m]
        return data_dict
