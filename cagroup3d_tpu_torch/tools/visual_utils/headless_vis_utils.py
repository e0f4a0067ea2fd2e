"""Headless scene renderer of the ``demo`` CLI's ``--render_dir``: the
port's own copy of ``tools/visual_utils/headless_vis_utils.py`` (which
replaces the reference's mayavi viewer, tools/visual_utils/
visualize_utils.py:72-225, with matplotlib so that it needs no display),
on the port's ``utils/box_utils.boxes_to_corners_3d``.

draw_scenes(points, gt_boxes, ref_boxes, ..., save_path=...) writes a
two-panel PNG: a bird's-eye view and a side (x-z) view, points coloured
by height, GT boxes in blue, detections in per-class hues with their
scores.  matplotlib is imported only when a scene is drawn;
``require_matplotlib()`` raises a clear error where it is not installed
(a GPU server often has none), so the CLI can fail before it runs the
first scene."""
from pathlib import Path

import numpy as np

from ...utils.box_utils import boxes_to_corners_3d

DET_COLORS = ["#2ca02c", "#17becf", "#bcbd22", "#e377c2", "#ff7f0e",
              "#9467bd", "#8c564b", "#7f7f7f", "#1f77b4", "#d62728"]
BEV_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0)]


def require_matplotlib() -> None:
    """Raise ``RuntimeError`` naming matplotlib when it cannot be
    imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "--render_dir needs matplotlib, which is not installed in this "
            "environment: run the demo without --render_dir (the boxes go "
            "to the log and --out_file) or install matplotlib") from e


def _draw_boxes_bev(ax, boxes, color=None, labels=None, scores=None):
    boxes = np.asarray(boxes, np.float32)
    if boxes.size == 0:
        return
    corners = boxes_to_corners_3d(boxes[:, :7])[:, :4, :2]  # bottom ring
    for i, c4 in enumerate(corners):
        col = color or DET_COLORS[int(labels[i]) % len(DET_COLORS)
                                  if labels is not None else 0]
        ring = np.concatenate([c4, c4[:1]], axis=0)
        ax.plot(ring[:, 0], ring[:, 1], color=col, linewidth=1.0)
        # heading tick from center to front-face midpoint
        ctr = boxes[i, :2]
        front = (c4[0] + c4[1]) / 2
        ax.plot([ctr[0], front[0]], [ctr[1], front[1]], color=col,
                linewidth=0.8)
        if scores is not None:
            ax.text(ctr[0], ctr[1], f"{float(scores[i]):.2f}",
                    color=col, fontsize=5)


def _draw_boxes_side(ax, boxes, color=None, labels=None):
    boxes = np.asarray(boxes, np.float32)
    if boxes.size == 0:
        return
    for i, b in enumerate(boxes):
        col = color or DET_COLORS[int(labels[i]) % len(DET_COLORS)
                                  if labels is not None else 0]
        x0, x1 = b[0] - b[3] / 2, b[0] + b[3] / 2
        z0, z1 = b[2] - b[5] / 2, b[2] + b[5] / 2
        ax.plot([x0, x1, x1, x0, x0], [z0, z0, z1, z1, z0],
                color=col, linewidth=1.0)


def draw_scenes(points, gt_boxes=None, ref_boxes=None, ref_labels=None,
                ref_scores=None, save_path="scene.png", title=None,
                point_size=0.3, dpi=150):
    """Render one scene to `save_path`; returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = np.asarray(points)
    fig, (ax_bev, ax_side) = plt.subplots(
        1, 2, figsize=(14, 7),
        gridspec_kw={"width_ratios": [2, 1]})
    for ax in (ax_bev, ax_side):
        ax.set_facecolor("black")
        ax.set_aspect("equal")
    z = points[:, 2] if points.shape[1] > 2 else np.zeros(len(points))
    ax_bev.scatter(points[:, 0], points[:, 1], s=point_size, c=z,
                   cmap="viridis", linewidths=0)
    ax_bev.set_xlabel("x [m]")
    ax_bev.set_ylabel("y [m]")
    ax_side.scatter(points[:, 0], z, s=point_size, c=z, cmap="viridis",
                    linewidths=0)
    ax_side.set_xlabel("x [m]")
    ax_side.set_ylabel("z [m]")
    if gt_boxes is not None and len(gt_boxes):
        _draw_boxes_bev(ax_bev, gt_boxes, color="#1f4fff")
        _draw_boxes_side(ax_side, gt_boxes, color="#1f4fff")
    if ref_boxes is not None and len(ref_boxes):
        _draw_boxes_bev(ax_bev, ref_boxes, labels=ref_labels,
                        scores=ref_scores)
        _draw_boxes_side(ax_side, ref_boxes, labels=ref_labels)
    if title:
        fig.suptitle(title)
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=dpi, bbox_inches="tight",
                facecolor="white")
    plt.close(fig)
    return str(save_path)
