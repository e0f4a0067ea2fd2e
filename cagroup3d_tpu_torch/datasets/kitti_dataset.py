"""KITTI dataset: infos, velodyne points, the padded batch, the
prediction dicts and the official evaluation.

The port's own copy of the lidar path of ``cagroup3d_tpu/datasets/
kitti_dataset.py`` (the reference's pcdet/datasets/kitti/kitti_dataset.py):
it reads pcdet-format ``kitti_infos_*.pkl`` (camera-frame annos and calib
matrices per frame), converts GT boxes to the lidar frame, reads the
velodyne ``.bin`` points and prepares each frame with a RandomState seeded
by ``crc32(frame_id)`` (``dataset.prepare_outdoor_sample``: the range mask
with its upper bound exclusive, the class filter, padding to ``POINT_CAP``
points and ``MAX_GT`` boxes), so the batches equal the JAX package's.
``FOV_POINTS_ONLY`` is read and, as in the JAX package, not applied: the
points outside the camera's field of view stay (the reference keeps only
those inside it).  Evaluation is the official R11/R40 protocol
(``kitti_eval.py``) when the infos carry camera annos, else the lidar-frame
3D-IoU AP of the indoor evaluator.  In training the train split's infos
go through the ``DATA_AUGMENTOR`` pipeline first (gt sampling from the
database under the data root, the world flip, rotation and scaling;
``augmentor.DataAugmentor``, drawing from the global ``np.random``), then
the same preparation, with ``shuffle_points`` on.  The camera inputs
(images, depth maps) of the image-based models are not ported.
"""
from __future__ import annotations

import pickle
import zlib
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..utils.box_utils import (boxes_camera_to_imageboxes,
                               boxes_camera_to_lidar, boxes_lidar_to_camera)
from .augmentor import DataAugmentor
from .dataset import (DatasetTemplate, parse_sample_points,
                      prepare_outdoor_sample)
from .indoor_eval import indoor_eval
from .kitti_eval import get_official_eval_result


class KittiDataset(DatasetTemplate):
    DATA_PROCESSORS = ("mask_points_and_boxes_outside_range", "shuffle_points",
                       "transform_points_to_voxels", "sample_points")

    def __init__(self, dataset_cfg, class_names, root_path=None,
                 training=True, logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path,
                         logger=logger)
        items = list(dataset_cfg.get("GET_ITEM_LIST", ["points"]))
        if items != ["points"]:
            raise NotImplementedError(f"KITTI items {items} are not ported "
                                      f"(points only)")
        self.split = dataset_cfg.DATA_SPLIT["train" if training else "test"]
        root = Path(root_path or dataset_cfg.DATA_PATH)
        self.root_split = root / ("training" if self.split != "test"
                                  else "testing")
        self.infos: List[Dict] = []
        for pkl in dataset_cfg.INFO_PATH.get(self.mode, []):
            p = root / pkl
            if p.exists():
                with open(p, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if logger:
            logger.info(f"KITTI {self.split}: {len(self.infos)} samples")
        self.point_cap = int(dataset_cfg.get("POINT_CAP", 65536))
        self.max_gt = int(dataset_cfg.get("MAX_GT", 64))
        self.fov_only = bool(dataset_cfg.get("FOV_POINTS_ONLY", True))
        aug_cfg = dataset_cfg.get("DATA_AUGMENTOR", None)
        self.augmentor = DataAugmentor(root, aug_cfg, class_names, logger) \
            if training and aug_cfg is not None else None
        self.sample_num_points = parse_sample_points(dataset_cfg, self.mode)
        self.shuffle_points = False
        for proc in dataset_cfg.get("DATA_PROCESSOR", []):
            if proc.get("NAME") == "shuffle_points":
                self.shuffle_points = bool(dict(proc.get(
                    "SHUFFLE_ENABLED", {})).get(self.mode, False))

    def __len__(self):
        return len(self.infos)

    def collate_batch(self, batch_list):
        """Items come padded to static caps: stack them (``frame_id`` a
        list of strings)."""
        out = {}
        for k in batch_list[0]:
            if k == "frame_id":
                out[k] = [d[k] for d in batch_list]
            else:
                out[k] = np.stack([d[k] for d in batch_list])
        return out

    def get_points(self, idx: str) -> np.ndarray:
        f = self.root_split / "velodyne" / f"{idx}.bin"
        return np.fromfile(f, np.float32).reshape(-1, 4)

    def __getitem__(self, index):
        info = self.infos[index]
        sample_idx = info["point_cloud"]["lidar_idx"]
        points = self.get_points(sample_idx)
        calib = info.get("calib", {})
        R0 = np.asarray(calib.get("R0_rect", np.eye(4)))[:3, :3]
        V2C = np.asarray(calib.get("Tr_velo_to_cam", np.eye(4)))[:3, :4]
        gt_boxes = np.zeros((0, 7), np.float32)
        gt_names = np.zeros((0,), dtype="<U16")
        annos = info.get("annos")
        if annos is not None:
            mask = annos["name"] != "DontCare"
            if "gt_boxes_lidar" in annos:
                gb = np.asarray(annos["gt_boxes_lidar"], np.float32)
                # get_infos leaves DontCare rows out of gt_boxes_lidar;
                # other pickles may keep full-length arrays
                gt_boxes = gb if len(gb) == int(mask.sum()) else gb[mask]
            else:
                cam = np.concatenate(
                    [annos["location"][mask], annos["dimensions"][mask],
                     annos["rotation_y"][mask][..., None]],
                    axis=1).astype(np.float32)
                gt_boxes = boxes_camera_to_lidar(cam, R0, V2C)
            gt_names = annos["name"][mask]
        data_dict = dict(points=points, gt_boxes=gt_boxes, gt_names=gt_names,
                         frame_id=sample_idx)
        rs = np.random.RandomState(
            zlib.crc32(str(sample_idx).encode()) & 0x7FFFFFFF)
        return prepare_outdoor_sample(
            data_dict, rs, augmentor=self.augmentor,
            shuffle_points=self.shuffle_points,
            class_names=self.class_names,
            pc_range=self.dataset_cfg.POINT_CLOUD_RANGE,
            point_cap=self.point_cap, max_gt=self.max_gt,
            sample_num_points=self.sample_num_points)

    # ------------------------------------------------------------------
    def _info_for_frame(self, frame_id):
        if not hasattr(self, "_by_frame"):
            self._by_frame = {
                str(i["point_cloud"]["lidar_idx"]): i for i in self.infos}
        return self._by_frame.get(str(frame_id))

    def generate_prediction_dicts(self, batch_dict, pred_dicts,
                                  class_names, output_path=None):
        """pcdet-format prediction annos (kitti_dataset.py:
        generate_prediction_dicts): lidar boxes + the camera-frame fields
        (location/dimensions/rotation_y/alpha/bbox) the official eval
        consumes, via the per-frame calib from the infos."""
        annos = []
        for i, pd in enumerate(pred_dicts):
            frame_id = np.asarray(batch_dict["frame_id"])[i] \
                if "frame_id" in batch_dict else i
            boxes_lidar = np.asarray(pd["pred_boxes"], np.float32)
            n = len(boxes_lidar)
            anno = dict(
                frame_id=frame_id,
                boxes_lidar=boxes_lidar,
                score=np.asarray(pd["pred_scores"], np.float32),
                pred_labels=np.asarray(pd["pred_labels"]),
                name=np.asarray([class_names[int(l)]
                                 for l in pd["pred_labels"]]),
                truncated=np.zeros(n, np.float32),
                occluded=np.zeros(n, np.float32),
            )
            info = self._info_for_frame(frame_id)
            calib = (info or {}).get("calib", {})
            if n and "R0_rect" in calib:
                R0 = np.asarray(calib["R0_rect"])[:3, :3]
                V2C = np.asarray(calib["Tr_velo_to_cam"])[:3, :4]
                cam = boxes_lidar_to_camera(boxes_lidar[:, :7], R0, V2C)
                anno["location"] = cam[:, 0:3]
                anno["dimensions"] = cam[:, 3:6]      # l, h, w
                anno["rotation_y"] = cam[:, 6]
                anno["alpha"] = (-np.arctan2(-boxes_lidar[:, 1],
                                             boxes_lidar[:, 0]) + cam[:, 6])
                if "P2" in calib:
                    shape = (info.get("image", {}) or {}).get("image_shape")
                    anno["bbox"] = boxes_camera_to_imageboxes(
                        cam, np.asarray(calib["P2"]), shape)
                else:
                    anno["bbox"] = np.tile(
                        np.asarray([[0, 0, 100, 100]], np.float32), (n, 1))
            else:
                anno["location"] = np.zeros((n, 3), np.float32)
                anno["dimensions"] = np.zeros((n, 3), np.float32)
                anno["rotation_y"] = np.zeros(n, np.float32)
                anno["alpha"] = np.full(n, -10.0, np.float32)
                anno["bbox"] = np.tile(
                    np.asarray([[0, 0, 100, 100]], np.float32), (n, 1))
            annos.append(anno)
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """Official KITTI protocol (R11/R40, easy/moderate/hard,
        bbox/bev/3d/aos) when the infos carry full camera annos;
        falls back to the indoor-style 3D AP otherwise."""
        if not self.infos or "annos" not in self.infos[0]:
            return {}, ""
        gt0 = self.infos[0]["annos"]
        if all(k in gt0 for k in
               ("occluded", "truncated", "bbox", "location")):
            gt_annos = [dict(info["annos"]) for info in self.infos]
            result_str, result_dict = get_official_eval_result(
                gt_annos, det_annos, class_names)
            return result_dict, result_str
        return self._evaluation_lidar_fallback(det_annos, class_names)

    def _evaluation_lidar_fallback(self, det_annos, class_names):
        """3D-IoU area-AP over lidar boxes (pre-round-3 stand-in; kept
        for infos without camera annos, e.g. synthetic pipelines)."""
        gt_annos, dt_annos = [], []
        for i, det in enumerate(det_annos):
            info = self.infos[i]
            annos = info.get("annos", {})
            mask = annos.get("name", np.zeros(0)) != "DontCare" \
                if "name" in annos else np.zeros(0, bool)
            boxes = annos.get("gt_boxes_lidar",
                              np.zeros((0, 7)))[mask] \
                if "gt_boxes_lidar" in annos else np.zeros((0, 7))
            names = annos.get("name", np.zeros(0, dtype="<U16"))[mask] \
                if "name" in annos else []
            labs = np.asarray([class_names.index(n) for n in names
                               if n in class_names], np.int64)
            keep = np.asarray([n in class_names for n in names], bool)
            gt_annos.append({
                "gt_num": int(keep.sum()),
                "gt_boxes_upright_depth": np.asarray(boxes)[keep][:, :7]
                if len(boxes) else np.zeros((0, 7)),
                "class": labs})
            dt_annos.append(dict(boxes_3d=det["boxes_lidar"][:, :7],
                                 scores_3d=det["score"],
                                 labels_3d=det["pred_labels"]))
        label2cat = {i: n for i, n in enumerate(class_names)}
        ret = indoor_eval(gt_annos, dt_annos, [0.5, 0.7], label2cat)
        return ret, ""
