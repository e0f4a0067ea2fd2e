"""Demo CLI: the YAML's model on raw ``.bin`` / ``.npy`` point files, one
scene at a time; the detections go to the log and, with ``--out_file``, to
a pickle, and with ``--render_dir`` to a PNG a scene.

Counterpart of the JAX package's ``tools/demo.py`` (the reference's
tools/demo.py, its open3d/mayavi viewer replaced by the headless dump),
with its flags and ``--device`` (default ``cuda``; a missing card is an
error).  Run from the repository root:

    python -m cagroup3d_tpu_torch.tools.demo \\
        --cfg_file tools/cfgs/scannet_models/CAGroup3D.yaml \\
        --ckpt output/.../checkpoint_epoch_10.pkl \\
        --data_path scenes/ --ext .bin --out_file dets.pkl

A scene is a float32 ``.bin`` of (x, y, z, r, g, b) rows, or an ``.npy``
whose first six columns are those; a directory is read in sorted order.
Each scene is cut to its first 100,000 points (``.bin`` files are read by
the C++ library of ``datasets/native_io``, or numpy where it cannot be
built) and padded to that cap.  ``--ckpt`` takes a checkpoint of either
package; without it the model keeps its seeded init.  The forward is the
model's ``forward_eval`` at epoch 1000 (the JAX demo's ``eval_step(...,
1000.0)``: the end of the head's semantic-threshold schedule).  The
``--out_file`` pickle is a list of dicts a scene: ``boxes`` [n, 7],
``scores`` [n], ``labels`` [n] (numpy) and ``file``.  ``--render_dir``
needs matplotlib; where it is missing the CLI fails before the first
scene.  The model must take six-channel points (the CAGroup3D and RBGNet
YAMLs).
"""
from __future__ import annotations

import argparse
import glob
import pickle
from pathlib import Path

import numpy as np
import torch

from ..config import EasyDict, cfg_from_yaml_file
from ..datasets import native_io
from ..models import build_network
from ..training.checkpoint import load_checkpoint
from ..utils.common_utils import create_logger

POINT_CAP = 100_000     # points a scene; the rest are cut


class DemoDataset:
    """The scenes of ``data_path`` (a file, or a directory's ``*ext``
    files in sorted order), each padded or cut to ``point_cap`` points.
    ``io_path`` is the reading path of ``.bin`` scenes ("native" or
    "numpy", ``native_io.io_path()``)."""

    def __init__(self, data_path, ext=".bin", point_cap=POINT_CAP):
        self.ext = ext
        data_path = Path(data_path)
        self.files = sorted(glob.glob(str(data_path / f"*{ext}"))) \
            if data_path.is_dir() else [str(data_path)]
        self.point_cap = point_cap
        self.io_path = native_io.io_path() if ext == ".bin" else "numpy"

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i):
        """Scene i's points [N, 6], every row."""
        if self.ext == ".bin":
            return np.fromfile(self.files[i], np.float32).reshape(-1, 6)
        if self.ext == ".npy":
            return np.load(self.files[i]).astype(np.float32)[:, :6]
        raise NotImplementedError(self.ext)

    def batch(self, i):
        """Scene i as a batch of one: points [1, P, 6] (its first P rows,
        zero-padded) and points_valid [1, P]."""
        P = self.point_cap
        if self.ext == ".bin":
            pts, n = native_io.read_points(self.files[i], P)
        else:
            pts = self[i][:P]
            n = len(pts)
            pts = np.concatenate([pts, np.zeros((P - n, 6), np.float32)])
        valid = np.zeros((1, P), bool)
        valid[0, :n] = True
        return dict(points=pts[None], points_valid=valid)


def parse_config(argv=None):
    """(args, cfg) from the command line (``argv``; ``sys.argv[1:]`` when
    None)."""
    parser = argparse.ArgumentParser(description="arg parser")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--ext", type=str, default=".bin")
    parser.add_argument("--out_file", type=str, default=None)
    parser.add_argument("--render_dir", type=str, default=None,
                        help="write a headless PNG per scene "
                             "(visual_utils.headless_vis_utils)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the model (tests pass cpu)")
    args = parser.parse_args(argv)
    return args, cfg_from_yaml_file(args.cfg_file, EasyDict())


def main(args, cfg):
    """Run the demo; returns the list that ``--out_file`` holds."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs the demo on the "
                           "card (--device cpu is for tests)")
    if args.render_dir:
        from .visual_utils.headless_vis_utils import require_matplotlib
        require_matplotlib()
    logger = create_logger()
    demo = DemoDataset(args.data_path, args.ext)
    logger.info(f"Total number of samples: {len(demo)}")

    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=device)
    if args.ckpt:
        ck = load_checkpoint(args.ckpt)
        model.load_jax_params(ck["params"], ck["state"])
    else:
        logger.warning("no --ckpt given; using random init")
    model.eval()

    results = []
    for i in range(len(demo)):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in demo.batch(i).items()}
        with torch.inference_mode():
            preds = model.forward_eval(batch, cur_epoch=1000.0)
        v = preds["pred_valid"][0].cpu().numpy()
        boxes = preds["pred_boxes"][0].cpu().numpy()[v]
        scores = preds["pred_scores"][0].cpu().numpy()[v]
        labels = preds["pred_labels"][0].cpu().numpy()[v]
        logger.info(f"sample {i}: {len(boxes)} detections")
        for b, s, lab in zip(boxes[:10], scores[:10], labels[:10]):
            logger.info(f"  {cfg.CLASS_NAMES[int(lab)]:>14} score={s:.3f} "
                        f"box={np.round(b, 2).tolist()}")
        results.append(dict(boxes=boxes, scores=scores, labels=labels,
                            file=demo.files[i]))
        if args.render_dir:
            from .visual_utils.headless_vis_utils import draw_scenes
            png = draw_scenes(
                demo[i], ref_boxes=boxes, ref_labels=labels,
                ref_scores=scores,
                save_path=Path(args.render_dir) /
                (Path(demo.files[i]).stem + ".png"),
                title=Path(demo.files[i]).name)
            logger.info(f"  rendered {png}")
    if args.out_file:
        with open(args.out_file, "wb") as f:
            pickle.dump(results, f)
        logger.info(f"wrote {args.out_file}")
    logger.info("Demo done.")
    return results


if __name__ == "__main__":
    main(*parse_config())
