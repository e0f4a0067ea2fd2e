"""ScanNetV2 dataset.

The port's own copy of ``cagroup3d_tpu/datasets/scannet_dataset.py`` (the
reference's pcdet/datasets/scannet/scannet_dataset.py): mmdet3d-format pkl
infos, per-scene ``.bin`` points (N x 6 xyzrgb, the scan's raw frame) with
instance and semantic masks, the info's axis-align matrix (applied by the
``global_alignment`` stage), REPEAT copies of the split, separate train and
test augmentor pipelines, and the indoor mAP evaluation.
"""
from __future__ import annotations

import copy
import pickle
import warnings

import numpy as np

from .augmentor import DataAugmentor
from .dataset import DatasetTemplate
from .indoor_eval import indoor_eval


class ScannetDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True,
                 root_path=None, logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path,
                         logger=logger)
        self.repeat = self.dataset_cfg.REPEAT[self.mode]
        self._include_data()
        self.data_augmentor_train = DataAugmentor(
            self.root_path, self.dataset_cfg.DATA_AUGMENTOR_TRAIN,
            class_names, logger)
        self.data_augmentor_test = DataAugmentor(
            self.root_path, self.dataset_cfg.DATA_AUGMENTOR_TEST,
            class_names, logger)

    def _include_data(self):
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH[self.mode]:
            p = self.root_path / info_path
            if not p.exists():
                continue
            with open(p, "rb") as f:
                infos.extend(pickle.load(f))
        self.infos = infos * self.repeat
        if self.logger:
            self.logger.info(f"Total samples for {type(self).__name__}: "
                             f"{len(infos)}")

    def get_lidar(self, idx):
        f = self.root_path / "points" / f"{idx}.bin"
        return np.fromfile(str(f), dtype=np.float32).reshape(-1, 6)

    def get_instance_mask(self, idx):
        f = self.root_path / "instance_mask" / f"{idx}.bin"
        return np.fromfile(str(f), dtype=np.int64)

    def get_semantic_mask(self, idx):
        f = self.root_path / "semantic_mask" / f"{idx}.bin"
        return np.fromfile(str(f), dtype=np.int64)

    def get_axis_align_matrix(self, info):
        if "axis_align_matrix" in info["annos"]:
            return np.array(info["annos"]["axis_align_matrix"],
                            dtype=np.float32)
        warnings.warn("axis_align_matrix not found; using identity")
        return np.eye(4, dtype=np.float32)

    def get_gt(self, annos):
        """GT boxes f32 [n, 7] of an info's annos (gt_num > 0): axis-aligned
        boxes from location and dimensions."""
        loc, dims = annos["location"], annos["dimensions"]
        rots = np.zeros((len(loc), 1), np.float32)
        return np.concatenate([loc, dims, rots], axis=1).astype(np.float32)

    def get_item_extras(self, sample_idx, get_item_list):
        """The per-point masks that ``GET_ITEM_LIST`` names."""
        d = {}
        if "instance_mask" in get_item_list:
            d["instance_mask"] = self.get_instance_mask(sample_idx)
        if "semantic_mask" in get_item_list:
            d["semantic_mask"] = self.get_semantic_mask(sample_idx)
        return d

    def __len__(self):
        return len(self.infos)

    def prepare_data(self, data_dict):
        gt_boxes_mask = np.array(
            [n in self.class_names for n in data_dict["gt_names"]], bool)
        aug = self.data_augmentor_train if self.training \
            else self.data_augmentor_test
        data_dict = aug.forward({**data_dict, "gt_boxes_mask": gt_boxes_mask})
        data_dict = self.run_data_processor(data_dict)
        if data_dict.get("gt_boxes", None) is not None:
            names = data_dict["gt_names"]
            sel = [i for i, n in enumerate(names) if n in self.class_names]
            data_dict["gt_boxes"] = data_dict["gt_boxes"][sel]
            data_dict["gt_names"] = names[sel]
            cls = np.array([self.class_names.index(n)
                            for n in data_dict["gt_names"]], np.float32)
            data_dict["gt_boxes"] = np.concatenate(
                [data_dict["gt_boxes"], cls[:, None]], axis=1)
        data_dict.pop("gt_names", None)
        data_dict.pop("axis_align_matrix", None)
        return data_dict

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        sample_idx = info["point_cloud"]["lidar_idx"]
        get_item_list = self.dataset_cfg.get("GET_ITEM_LIST", ["points"])
        d = {"frame_id": sample_idx}
        if info["annos"]["gt_num"] != 0:
            d["gt_names"] = info["annos"]["name"]
            d["gt_boxes"] = self.get_gt(info["annos"])
        else:
            d["gt_names"] = np.array([])
            d["gt_boxes"] = np.zeros((0, 7), np.float32)
        if "points" in get_item_list:
            d["points"] = self.get_lidar(sample_idx)
        d.update(self.get_item_extras(sample_idx, get_item_list))
        d["axis_align_matrix"] = self.get_axis_align_matrix(info)
        d = self.prepare_data(d)
        if self.training and len(d["gt_boxes"]) == 0:   # filter empty GT
            return self[np.random.randint(len(self))]
        return d

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names):
        """pred_dicts: per scene, numpy pred_boxes / pred_scores /
        pred_labels already unpadded to the valid rows."""
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            scores = np.asarray(box_dict["pred_scores"])
            boxes = np.asarray(box_dict["pred_boxes"])
            labels = np.asarray(box_dict["pred_labels"]).astype(np.int64)
            anno = {
                "name": np.array(class_names)[labels] if len(labels)
                else np.zeros(0),
                "labels_3d": labels,
                "dimensions": boxes[:, 3:6] if len(boxes)
                else np.zeros((0, 3)),
                "location": boxes[:, 0:3] if len(boxes) else np.zeros((0, 3)),
                "rotation_y": boxes[:, 6] if len(boxes) else np.zeros(0),
                "scores_3d": scores,
                "boxes_3d": boxes,
                "frame_id": batch_dict["frame_id"][index],
            }
            annos.append(anno)
        return annos

    def evaluation(self, det_annos, class_names):
        """(ret, ret): the indoor mAP/AR dict at IoU 0.25 and 0.50 against
        every info's annos (the per-class table is printed)."""
        eval_gt_annos = [copy.deepcopy(info["annos"])
                         for info in self.infos]
        label2cat = {i: cat for i, cat in enumerate(class_names)}
        ret = indoor_eval(eval_gt_annos, copy.deepcopy(det_annos),
                          [0.25, 0.5], label2cat)
        return ret, ret
