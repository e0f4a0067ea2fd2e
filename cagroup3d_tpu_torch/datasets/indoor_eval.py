"""Indoor mAP/AR evaluator (numpy, host-side).

The port's own copy of ``cagroup3d_tpu/datasets/indoor_eval.py`` (the
reference's scannet_object_eval_python/eval.py, identical for sunrgbd):
VOC area-AP over greedy TP/FP matching at IoU {0.25, 0.5}, with 3D IoU =
rotated-BEV intersection x z-overlap / union (``d3_box_overlap``; the BEV
intersection of the reference's rotate_iou_gpu_eval with criterion=2, the
raw intersection area).  The BEV intersection is a vectorized numpy
polygon intersection (corner containment + edge crossings, angular sort,
shoelace), equivalent to polygon clipping for convex rectangles.  The same
numpy operations in the same order as the JAX package's copy, so both give
the same numbers; its documented divergences are kept.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# rotated BEV intersection (vectorized numpy over an N x K box grid)
# ---------------------------------------------------------------------------

def _corners(b5):
    x, y, dx, dy, a = (b5[:, i] for i in range(5))
    xs = np.stack([dx / 2, -dx / 2, -dx / 2, dx / 2], -1)
    ys = np.stack([dy / 2, dy / 2, -dy / 2, -dy / 2], -1)
    c, s = np.cos(a)[:, None], np.sin(a)[:, None]
    return np.stack([xs * c - ys * s + x[:, None],
                     xs * s + ys * c + y[:, None]], -1)  # [N, 4, 2]


def _points_in_box(pts, b5):
    """pts [..., P, 2] vs boxes b5 broadcast [..., 5]."""
    px = pts[..., 0] - b5[..., 0:1]
    py = pts[..., 1] - b5[..., 1:2]
    c, s = np.cos(b5[..., 4:5]), np.sin(b5[..., 4:5])
    u = px * c + py * s
    v = -px * s + py * c
    eps = 1e-6
    return (np.abs(u) <= b5[..., 2:3] / 2 + eps) & \
           (np.abs(v) <= b5[..., 3:4] / 2 + eps)


def rotated_intersection_np(a5, b5):
    """a5 [N, 5], b5 [K, 5] -> intersection areas [N, K]."""
    N, K = len(a5), len(b5)
    if N == 0 or K == 0:
        return np.zeros((N, K), np.float32)
    ca = _corners(a5)  # [N, 4, 2]
    cb = _corners(b5)  # [K, 4, 2]
    A5 = a5[:, None, :]
    B5 = b5[None, :, :]
    a_in_b = _points_in_box(np.broadcast_to(ca[:, None], (N, K, 4, 2)), B5)
    b_in_a = _points_in_box(np.broadcast_to(cb[None, :], (N, K, 4, 2)), A5)

    a0 = ca[:, None, :, None, :]                    # [N,1,4,1,2]
    a1 = np.roll(ca, -1, axis=1)[:, None, :, None, :]
    b0 = cb[None, :, None, :, :]                    # [1,K,1,4,2]
    b1 = np.roll(cb, -1, axis=1)[None, :, None, :, :]
    da = a1 - a0
    db = b1 - b0
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    diff = b0 - a0
    t = diff[..., 0] * db[..., 1] - diff[..., 1] * db[..., 0]
    u = diff[..., 0] * da[..., 1] - diff[..., 1] * da[..., 0]
    safe = np.where(np.abs(denom) > 1e-10, denom, 1.0)
    t = t / safe
    u = u / safe
    ok = (np.abs(denom) > 1e-10) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    xpts = a0 + t[..., None] * da                   # [N,K,4,4,2]

    verts = np.concatenate([
        np.broadcast_to(ca[:, None], (N, K, 4, 2)),
        np.broadcast_to(cb[None, :], (N, K, 4, 2)),
        xpts.reshape(N, K, 16, 2)], axis=2)         # [N,K,24,2]
    mask = np.concatenate([a_in_b, b_in_a, ok.reshape(N, K, 16)], axis=2)

    num = mask.sum(-1, keepdims=True)
    center = np.where(mask[..., None], verts, 0).sum(2, keepdims=True) \
        / np.maximum(num[..., None], 1)
    rel = verts - center
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    ang = np.where(mask, ang, 1e9)
    order = np.argsort(ang, axis=-1)
    sv = np.take_along_axis(verts, order[..., None], axis=2)
    sm = np.take_along_axis(mask, order, axis=2)
    first = sv[..., :1, :]
    sv = np.where(sm[..., None], sv, first)
    nxt = np.roll(sv, -1, axis=2)
    cross = sv[..., 0] * nxt[..., 1] - nxt[..., 0] * sv[..., 1]
    area = 0.5 * np.abs(cross.sum(-1))
    return np.where(num[..., 0] >= 3, area, 0.0).astype(np.float32)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D IoU [N, K] for (x, y, z_center, dx, dy, dz, yaw) boxes."""
    rinc = rotated_intersection_np(boxes[:, [0, 1, 3, 4, 6]],
                                   qboxes[:, [0, 1, 3, 4, 6]])
    top = np.minimum(boxes[:, None, 2] + boxes[:, None, 5] / 2,
                     qboxes[None, :, 2] + qboxes[None, :, 5] / 2)
    bot = np.maximum(boxes[:, None, 2] - boxes[:, None, 5] / 2,
                     qboxes[None, :, 2] - qboxes[None, :, 5] / 2)
    iw = np.maximum(top - bot, 0.0)
    inc = iw * rinc
    va = np.prod(boxes[:, 3:6], axis=1)[:, None]
    vb = np.prod(qboxes[:, 3:6], axis=1)[None, :]
    if criterion == -1:
        ua = va + vb - inc
    elif criterion == 0:
        ua = va
    elif criterion == 1:
        ua = vb
    else:
        ua = inc
    return np.where((rinc > 0) & (iw > 0), inc / np.maximum(ua, 1e-12), 0.0)


# ---------------------------------------------------------------------------
# VOC-style AP (reference eval.py:44-225)
# ---------------------------------------------------------------------------

def average_precision(recalls, precisions, mode="area"):
    if recalls.ndim == 1:
        recalls = recalls[None]
        precisions = precisions[None]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == "area":
        zeros = np.zeros((num_scales, 1), recalls.dtype)
        ones = np.ones((num_scales, 1), recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind]) *
                           mpre[i, ind + 1])
    else:
        raise ValueError(mode)
    return ap


def eval_det_cls(pred, gt, iou_thr):
    class_recs = {}
    npos = 0
    for img_id in gt:
        bbox = np.array(gt[img_id], np.float32).reshape(-1, 7)
        det = [[False] * len(bbox) for _ in iou_thr]
        npos += len(bbox)
        class_recs[img_id] = {"bbox": bbox, "det": det}

    image_ids, confidence, ious = [], [], []
    for img_id in pred:
        cur = pred[img_id]
        if not cur:
            continue
        boxes = np.stack([b for b, s in cur]).astype(np.float32)
        for b, s in cur:
            image_ids.append(img_id)
            confidence.append(s)
        gt_cur = class_recs.get(img_id, {"bbox": np.zeros((0, 7))})["bbox"]
        if len(gt_cur) > 0:
            iou_cur = d3_box_overlap(boxes, gt_cur)
            ious.extend(list(iou_cur))
        else:
            ious.extend([np.zeros(1)] * len(boxes))

    confidence = np.array(confidence)
    order = np.argsort(-confidence)
    image_ids = [image_ids[i] for i in order]
    ious = [ious[i] for i in order]

    nd = len(image_ids)
    tp_thr = [np.zeros(nd) for _ in iou_thr]
    fp_thr = [np.zeros(nd) for _ in iou_thr]
    for d in range(nd):
        R = class_recs.get(image_ids[d])
        iou_max, jmax = -np.inf, -1
        if R is not None and len(R["bbox"]) > 0:
            for j in range(len(R["bbox"])):
                if ious[d][j] > iou_max:
                    iou_max = ious[d][j]
                    jmax = j
        for k, thresh in enumerate(iou_thr):
            if iou_max > thresh and R is not None:
                if not R["det"][k][jmax]:
                    tp_thr[k][d] = 1.0
                    R["det"][k][jmax] = True
                else:
                    fp_thr[k][d] = 1.0
            else:
                fp_thr[k][d] = 1.0

    ret = []
    for k, thresh in enumerate(iou_thr):
        fp = np.cumsum(fp_thr[k])
        tp = np.cumsum(tp_thr[k])
        recall = tp / max(float(npos), 1e-12)
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        ret.append((recall, precision, average_precision(recall, precision)))
    return ret


def eval_map_recall(pred, gt, ovthresh):
    ret_values = {}
    for classname in gt:
        if classname in pred:
            ret_values[classname] = eval_det_cls(pred[classname],
                                                 gt[classname], ovthresh)
    recall = [{} for _ in ovthresh]
    precision = [{} for _ in ovthresh]
    ap = [{} for _ in ovthresh]
    for label in gt:
        for k in range(len(ovthresh)):
            if label in pred:
                recall[k][label], precision[k][label], ap[k][label] = \
                    ret_values[label][k]
            else:
                recall[k][label] = np.zeros(1)
                precision[k][label] = np.zeros(1)
                ap[k][label] = np.zeros(1)
    return recall, precision, ap


def _ascii_table(header, rows, footing_rows=1):
    """terminaltables.AsciiTable-compatible rendering (the reference's
    report formatter, scannet_object_eval_python/eval.py:328-331, with
    inner_footing_row_border=True): grid borders, left-aligned cells,
    a separator line before the last ``footing_rows`` rows."""
    data = [list(map(str, header))] + [list(map(str, r)) for r in rows]
    widths = [max(len(r[c]) for r in data) for c in range(len(header))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt(row):
        return "| " + " | ".join(c.ljust(w) for c, w in zip(row, widths)) \
            + " |"

    lines = [sep, fmt(data[0]), sep]
    body, foot = data[1:], []
    if footing_rows and len(body) > footing_rows:
        body, foot = body[:-footing_rows], body[-footing_rows:]
    lines += [fmt(r) for r in body]
    if foot:
        lines.append(sep)
        lines += [fmt(r) for r in foot]
    lines.append(sep)
    return "\n".join(lines)


def indoor_eval(gt_annos, dt_annos, metric, label2cat, logger=None):
    assert len(dt_annos) == len(gt_annos)
    pred, gt = {}, {}
    for img_id in range(len(dt_annos)):
        det = dt_annos[img_id]
        for i in range(len(det["labels_3d"])):
            label = int(det["labels_3d"][i])
            pred.setdefault(label, {}).setdefault(img_id, []).append(
                (det["boxes_3d"][i], det["scores_3d"][i]))
            gt.setdefault(label, {}).setdefault(img_id, [])
        ga = gt_annos[img_id]
        if ga.get("gt_num", 0) != 0:
            gb = np.asarray(ga["gt_boxes_upright_depth"], np.float32)
            if gb.shape[-1] == 6:
                gb = np.concatenate(
                    [gb, np.zeros((len(gb), 1), np.float32)], -1)
            labels_3d = ga["class"]
        else:
            gb = np.zeros((0, 7), np.float32)
            labels_3d = np.zeros(0, np.int64)
        for i in range(len(labels_3d)):
            label = int(labels_3d[i])
            gt.setdefault(label, {}).setdefault(img_id, []).append(gb[i])

    rec, prec, ap = eval_map_recall(pred, gt, metric)
    ret = {}
    # per-class AP/AR table in the reference's exact report shape
    # (eval.py:296-332): header [classes, AP_t, AR_t, ...], one row per
    # class, Overall (mAP/mAR) footing row behind a border
    header = ["classes"]
    labels = list(ap[0].keys()) if ap else []
    table_columns = [[label2cat[lab] for lab in labels] + ["Overall"]]
    for i, t in enumerate(metric):
        header += [f"AP_{t:.2f}", f"AR_{t:.2f}"]
        for label in ap[i]:
            ret[f"{label2cat[label]}_AP_{t:.2f}"] = float(ap[i][label][0])
        ret[f"mAP_{t:.2f}"] = float(np.mean([v[0] for v in ap[i].values()])) \
            if ap[i] else 0.0
        table_columns.append(
            [f"{float(ap[i][lab][0]):.4f}" for lab in labels]
            + [f"{ret[f'mAP_{t:.2f}']:.4f}"])
        rec_list = []
        for label in rec[i]:
            ret[f"{label2cat[label]}_rec_{t:.2f}"] = float(rec[i][label][-1])
            rec_list.append(rec[i][label][-1])
        ret[f"mAR_{t:.2f}"] = float(np.mean(rec_list)) if rec_list else 0.0
        table_columns.append(
            [f"{float(rec[i][lab][-1]):.4f}" for lab in labels]
            + [f"{ret[f'mAR_{t:.2f}']:.4f}"])
    summary = _ascii_table(header, list(zip(*table_columns)))
    (logger.info if logger else print)("\n" + summary)
    return ret
