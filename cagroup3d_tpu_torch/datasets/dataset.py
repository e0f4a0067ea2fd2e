"""Dataset template and the static-shape padded collate.

The port's own copy of ``cagroup3d_tpu/datasets/dataset.py`` (the
reference's pcdet/datasets/dataset.py): the indoor template and the
outdoor sample preparation (``prepare_outdoor_sample``).  The collate
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


def parse_sample_points(dataset_cfg, mode):
    """NUM_POINTS[mode] of the 'sample_points' DATA_PROCESSOR entry
    (-1/absent -> None)."""
    for proc in dataset_cfg.get("DATA_PROCESSOR", []):
        if proc.get("NAME") == "sample_points":
            n = int(dict(proc.get("NUM_POINTS", {})).get(mode, -1))
            return n if n > 0 else None
    return None


def sample_points_depth_split(points, num_points, rs):
    """DataProcessor 'sample_points' (data_processor.py:145-175): when
    downsampling, keep ALL far points (depth >= 40 m) and fill the rest
    from near points — preserves the sparse far field PointRCNN needs.
    Upsampling pads with duplicate draws like the reference."""
    if num_points == len(points):
        return points
    if num_points < len(points):
        depth = np.linalg.norm(points[:, :3], axis=1)
        far = np.flatnonzero(depth >= 40.0)
        near = np.flatnonzero(depth < 40.0)
        if num_points > len(far):
            pick_near = rs.choice(near, num_points - len(far),
                                  replace=False)
            choice = np.concatenate([pick_near, far]) if len(far) \
                else pick_near
        else:
            choice = rs.choice(len(points), num_points, replace=False)
    else:
        extra = rs.choice(len(points), num_points - len(points),
                          replace=len(points) < num_points - len(points))
        choice = np.concatenate([np.arange(len(points)), extra])
    rs.shuffle(choice)
    return points[choice]


def prepare_outdoor_sample(data_dict, rs, *, augmentor, shuffle_points,
                           class_names, pc_range, point_cap, max_gt,
                           box_dim=7, sample_num_points=None):
    """Shared outdoor train/eval prep: augment (train) -> shuffle ->
    range mask -> sample_points -> class filter -> pad to static caps.

    Condenses the reference's DatasetTemplate.prepare_data +
    DataProcessor chain (dataset.py:88-158, data_processor.py) for the
    padded static-shape TPU collate.  `rs` is a per-frame seeded
    RandomState so eval is deterministic across runs.  gt_boxes are
    padded to [max_gt, box_dim + 1] with the class label in the last
    column (7-dof boxes, or 9-dof with velocity for nuScenes).
    """
    if augmentor is not None:
        data_dict["gt_boxes_mask"] = np.isin(
            data_dict["gt_names"], class_names)
        data_dict = augmentor.forward(data_dict)
    if shuffle_points:
        perm = rs.permutation(len(data_dict["points"]))
        data_dict["points"] = data_dict["points"][perm]
    pts = data_dict["points"]
    rng = np.asarray(pc_range)
    keep = np.all((pts[:, :3] >= rng[:3]) & (pts[:, :3] < rng[3:6]),
                  axis=1)
    pts = pts[keep]
    if sample_num_points and len(pts):
        pts = sample_points_depth_split(
            pts, min(int(sample_num_points), point_cap), rs)
    boxes = data_dict["gt_boxes"]
    names = data_dict["gt_names"]
    cls_mask = np.isin(names, class_names)
    boxes, names = boxes[cls_mask], names[cls_mask]
    labels = np.asarray([class_names.index(n) for n in names],
                        np.int32) if len(names) else np.zeros((0,),
                                                              np.int32)
    P, G, W = point_cap, max_gt, box_dim
    out_pts = np.zeros((P, pts.shape[1]), np.float32)
    out_val = np.zeros((P,), bool)
    n = min(len(pts), P)
    sel = rs.choice(len(pts), n, replace=False) if len(pts) > P \
        else np.arange(len(pts))
    out_pts[:n] = pts[sel][:n]
    out_val[:n] = True
    gb = np.zeros((G, W + 1), np.float32)
    gv = np.zeros((G,), bool)
    m = min(len(boxes), G)
    gb[:m, :W] = boxes[:m, :W]
    gb[:m, W] = labels[:m]
    gv[:m] = True
    return dict(points=out_pts, points_valid=out_val, gt_boxes=gb,
                gt_valid=gv, frame_id=data_dict["frame_id"])


class DatasetTemplate:
    # the DATA_PROCESSOR entries a dataset of this class applies
    DATA_PROCESSORS = ("mask_points_and_boxes_outside_range",)

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
            if proc.NAME not in self.DATA_PROCESSORS:
                raise NotImplementedError(
                    f"data processor {proc.NAME!r} is not ported")

    @property
    def mode(self):
        return "train" if self.training else "test"

    def run_data_processor(self, data_dict):
        for proc in self.dataset_cfg.get("DATA_PROCESSOR", []):
            if proc.NAME != "mask_points_and_boxes_outside_range":
                continue
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
