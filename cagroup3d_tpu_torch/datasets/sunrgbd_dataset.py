"""SUN RGB-D dataset.

The port's own copy of ``cagroup3d_tpu/datasets/sunrgbd_dataset.py`` (the
reference's pcdet/datasets/sunrgbd/sunrgbd_dataset.py): zero-padded point
files, 7-DoF headed boxes from ``gt_boxes_upright_depth``, no axis-align
matrix and no instance or semantic masks; everything else as ScanNet.
"""
from __future__ import annotations

import numpy as np

from .scannet_dataset import ScannetDataset


class SunrgbdDataset(ScannetDataset):
    def get_lidar(self, idx):
        f = self.root_path / "points" / (str(idx).zfill(6) + ".bin")
        return np.fromfile(str(f), dtype=np.float32).reshape(-1, 6)

    def get_axis_align_matrix(self, info):
        return np.eye(4, dtype=np.float32)

    def get_gt(self, annos):
        return np.asarray(annos["gt_boxes_upright_depth"])[:, :7].astype(
            np.float32)

    def get_item_extras(self, sample_idx, get_item_list):
        return {}
