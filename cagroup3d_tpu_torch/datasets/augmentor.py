"""Indoor data augmentation pipeline (numpy, host-side).

The port's own copy of the indoor part of
``cagroup3d_tpu/datasets/augmentor.py`` (the reference's
pcdet/datasets/augmentor/{data_augmentor,augmentor_utils}.py): every stage
that the ScanNet and SUN RGB-D dataset YAMLs name -- global_alignment,
point_seg_class_mapping, random_world_flip / rotation / rotation_mmdet3d /
scaling / translation and indoor_point_sample.  The same math as the JAX
package's copy (the mmdet3d rotation sign, the y-flip heading transform),
drawing from the global ``np.random`` stream in the same order, so one
seed gives the same scene in both packages.  Any other stage name raises
``NotImplementedError``; the outdoor stages (``gt_sampling``, the local
and frustum augmentations) are not ported.
"""
from __future__ import annotations

from functools import partial

import numpy as np


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


class DataAugmentor:
    """Pipeline driver (the reference's data_augmentor.py:19-24, 295-326):
    the stages of ``AUG_CONFIG_LIST`` less ``DISABLE_AUG_LIST``, in order,
    then the heading wrapped into [-pi, pi) and the GT boxes outside
    ``gt_boxes_mask`` (when given) dropped.  ``root_path``, ``class_names``
    and ``logger`` keep the JAX package's signature; no indoor stage reads
    them."""

    STAGES = ("global_alignment", "point_seg_class_mapping",
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
                    f"augmentor stage {cfg.NAME!r} is not ported (indoor "
                    f"stages only: {', '.join(self.STAGES)})")
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
