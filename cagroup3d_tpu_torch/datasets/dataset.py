"""Dataset template and the static-shape padded collate.

The port's own copy of the indoor part of ``cagroup3d_tpu/datasets/
dataset.py`` (the reference's pcdet/datasets/dataset.py).  Its collate
pads every scene to static capacities (``POINT_CAP`` points, ``MAX_GT``
boxes) with validity masks, so a batch is a dict of fixed-shape numpy
arrays ``[B, ...]`` with the same keys, shapes and dtypes as the JAX
package's; the eval harness moves what the model reads to its device.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np


def mask_points_and_boxes_outside_range(data_dict, pc_range,
                                        remove_outside_boxes=True,
                                        training=True):
    """DATA_PROCESSOR 'mask_points_and_boxes_outside_range' (the
    reference's data_processor.py:78-91): points outside the range go, with
    their masks; in training, so do GT boxes whose centre lies more than
    0.5 m outside it."""
    pts = data_dict["points"]
    r = np.asarray(pc_range)
    mask = np.all((pts[:, :3] >= r[:3]) & (pts[:, :3] <= r[3:6]), axis=1)
    data_dict["points"] = pts[mask]
    for k in ("instance_mask", "semantic_mask"):
        if data_dict.get(k) is not None and len(data_dict[k]) == len(mask):
            data_dict[k] = data_dict[k][mask]
    if remove_outside_boxes and training and \
            data_dict.get("gt_boxes", None) is not None and \
            len(data_dict["gt_boxes"]):
        gt = data_dict["gt_boxes"]
        bm = np.all((gt[:, :3] >= r[:3] - 0.5) & (gt[:, :3] <= r[3:6] + 0.5),
                    axis=1)
        data_dict["gt_boxes"] = gt[bm]
        if "gt_names" in data_dict:
            data_dict["gt_names"] = data_dict["gt_names"][bm]
    return data_dict


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = Path(root_path if root_path is not None
                              else dataset_cfg.DATA_PATH)
        self.point_cloud_range = np.array(
            dataset_cfg.POINT_CLOUD_RANGE, dtype=np.float32)
        self.point_cap = int(dataset_cfg.get("POINT_CAP", 100_000))
        self.max_gt = int(dataset_cfg.get("MAX_GT", 64))
        for proc in dataset_cfg.get("DATA_PROCESSOR", []):
            if proc.NAME != "mask_points_and_boxes_outside_range":
                raise NotImplementedError(
                    f"data processor {proc.NAME!r} is not ported")

    @property
    def mode(self):
        return "train" if self.training else "test"

    def run_data_processor(self, data_dict):
        for proc in self.dataset_cfg.get("DATA_PROCESSOR", []):
            data_dict = mask_points_and_boxes_outside_range(
                data_dict, self.point_cloud_range,
                proc.get("REMOVE_OUTSIDE_BOXES", True), self.training)
        return data_dict

    # ------------------------------------------------------------------
    def collate_batch(self, batch_list: List[Dict]) -> Dict[str, np.ndarray]:
        """Pad scenes to (POINT_CAP, MAX_GT): points f32 [B, P, 6],
        points_valid bool [B, P], gt_boxes f32 [B, G, 8] (the class index
        last), gt_valid bool [B, G], frame_id (a list), and, when a scene
        has them, semantic_mask (unlabelled = the number of classes) and
        instance_mask int32 [B, P]."""
        B = len(batch_list)
        P, G = self.point_cap, self.max_gt
        out = dict(
            points=np.zeros((B, P, 6), np.float32),
            points_valid=np.zeros((B, P), bool),
            gt_boxes=np.zeros((B, G, 8), np.float32),
            gt_valid=np.zeros((B, G), bool),
            frame_id=[d.get("frame_id") for d in batch_list],
        )
        has_sem = any("semantic_mask" in d for d in batch_list)
        if has_sem:
            out["semantic_mask"] = np.full((B, P), len(self.class_names),
                                            np.int32)
            out["instance_mask"] = np.zeros((B, P), np.int32)
        for b, d in enumerate(batch_list):
            pts = d["points"][:, :6]
            n = min(len(pts), P)
            out["points"][b, :n] = pts[:n]
            out["points_valid"][b, :n] = True
            gt = d.get("gt_boxes")
            if gt is not None and len(gt):
                m = min(len(gt), G)
                out["gt_boxes"][b, :m] = gt[:m, :8]
                out["gt_valid"][b, :m] = True
            if has_sem and d.get("semantic_mask") is not None:
                out["semantic_mask"][b, :n] = d["semantic_mask"][:n]
                out["instance_mask"][b, :n] = d["instance_mask"][:n]
        return out
