"""Eval harness: the model's eval forward over the val loader, predictions
unpadded into the dataset's prediction dicts, recall counters, and the
dataset's indoor mAP evaluation.

Counterpart of ``cagroup3d_tpu/training/eval_utils.py`` (the reference's
tools/eval_utils/eval_utils.py).  The loader yields padded numpy batches;
each batch's points go to the model's device, ``forward_eval`` runs under
``torch.inference_mode()``, and its padded outputs come back to the host
(which waits for the card) before they are unpadded by ``pred_valid``.
"""
from __future__ import annotations

import pickle
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..datasets.indoor_eval import d3_box_overlap

RECALL_THRESHOLDS = (0.25, 0.5)


def statistics_info(recall_dict, pred_boxes, gt_boxes):
    """Accumulate recall counters (the reference's eval_utils.py:12-19,
    detector3d_template.generate_recall_record): a GT box is recalled at
    threshold t (0.25 and 0.5, the evaluator's) if some prediction overlaps
    it with 3D IoU > t."""
    if not recall_dict:
        recall_dict = {"gt": 0}
        for t in RECALL_THRESHOLDS:
            recall_dict[f"rcnn_{t}"] = 0
    n_gt = len(gt_boxes)
    recall_dict["gt"] += n_gt
    if n_gt == 0 or len(pred_boxes) == 0:
        return recall_dict
    iou = d3_box_overlap(np.asarray(pred_boxes[:, :7]),
                         np.asarray(gt_boxes[:, :7]))
    best = iou.max(axis=0)
    for t in RECALL_THRESHOLDS:
        recall_dict[f"rcnn_{t}"] += int((best > t).sum())
    return recall_dict


def eval_one_epoch(model, dataset, loader, epoch_id, logger,
                   result_dir: Path = None, class_names=None,
                   dist: bool = False) -> Dict:
    """Evaluate ``model`` (a detector with ``forward_eval``) over every
    batch of ``loader``; write ``result_dir / "result.pkl"`` (the
    prediction dicts, one per scene) when ``result_dir`` is given and
    return the dataset's evaluation dict.  Multi-process evaluation
    (``dist``) is not ported."""
    if dist:
        raise NotImplementedError("distributed evaluation is not ported; "
                                  "run one process")
    class_names = class_names or dataset.class_names
    device = next(model.parameters()).device
    det_annos: List[Dict] = []
    total_time = 0.0
    n_scenes = 0
    recall_dict: Dict = {}
    for batch_np in loader:
        batch = {k: torch.from_numpy(batch_np[k]).to(device)
                 for k in ("points", "points_valid")}
        t0 = time.time()
        with torch.inference_mode():
            preds = model.forward_eval(batch, cur_epoch=epoch_id)
        overflow = int(preds["overflow"].sum())
        if overflow > 0:
            logger.warning(
                f"capacity overflow: {overflow} voxels dropped this batch "
                f"-- raise the capacity knobs (INPUT_CAP/FINE_CAP/CAPS)")
        boxes = preds["pred_boxes"].cpu().numpy()
        total_time += time.time() - t0
        scores = preds["pred_scores"].cpu().numpy()
        labels = preds["pred_labels"].cpu().numpy()
        valid = preds["pred_valid"].cpu().numpy()
        B = boxes.shape[0]
        n_scenes += B
        pred_dicts = []
        for b in range(B):
            v = valid[b]
            pred_dicts.append(dict(pred_boxes=boxes[b][v],
                                   pred_scores=scores[b][v],
                                   pred_labels=labels[b][v]))
            if "gt_boxes" in batch_np:
                gt = batch_np["gt_boxes"][b][batch_np["gt_valid"][b]]
                recall_dict = statistics_info(recall_dict, boxes[b][v], gt)
        det_annos += dataset.generate_prediction_dicts(
            batch_np, pred_dicts, class_names)
    logger.info(f"eval: {n_scenes} scenes, "
                f"{total_time / max(n_scenes, 1) * 1e3:.1f} ms/scene "
                f"(incl. host transfer)")
    if recall_dict.get("gt", 0) > 0:
        for k, v in recall_dict.items():
            if k != "gt":
                logger.info(f"recall_{k}: {v / recall_dict['gt']:.4f}")
    if result_dir is not None:
        result_dir.mkdir(parents=True, exist_ok=True)
        with open(result_dir / "result.pkl", "wb") as f:
            pickle.dump(det_annos, f)
    ret_dict, _ = dataset.evaluation(det_annos, class_names)
    for k, v in sorted(ret_dict.items()):
        logger.info(f"{k}: {float(v):.4f}")
    return ret_dict
