"""Dataset preparation CLI: KITTI infos and the gt-sampling database.

Counterpart of the JAX package's ``tools/create_infos.py``.  Run from the
repository root:

    python -m cagroup3d_tpu_torch.tools.create_infos --dataset kitti \\
        --data_path data/kitti [--save_path ...] \\
        [--class_names Car Pedestrian Cyclist]

It writes kitti_infos_{train,val,trainval,test}.pkl, gt_database/ and
kitti_dbinfos_train.pkl from a raw KITTI tree (ImageSets/,
training/{velodyne,calib,label_2,image_2}).
"""
from __future__ import annotations

import argparse

from ..datasets.kitti_infos import create_kitti_infos
from ..utils.common_utils import create_logger


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="kitti",
                        choices=["kitti"])
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--class_names", type=str, nargs="+",
                        default=["Car", "Pedestrian", "Cyclist"])
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)
    create_kitti_infos(args.data_path, args.save_path, workers=args.workers,
                       class_names=args.class_names, logger=create_logger())


if __name__ == "__main__":
    main()
