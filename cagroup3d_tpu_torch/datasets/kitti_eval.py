"""Official KITTI evaluation protocol: R11/R40 AP over easy/moderate/hard
difficulty buckets for 2D bbox, BEV, 3D and AOS.

The port's own copy of ``cagroup3d_tpu/datasets/kitti_eval.py`` (the
reference's kitti_object_eval_python/eval.py and rotate_iou.py): vectorized
numpy overlap matrices (the indoor evaluator's rotated intersection with the
reference's clockwise rotation), and the sequential greedy matcher in native
C++ (``csrc/kitti_eval.cpp``, built at first use with the host compiler into
``.kernel_build/`` by ``ops/build.build_host`` and bound with ctypes), with
``compute_statistics_py`` as its plain Python version: the fallback where
no compiler is found and the reference the tests hold it against.

Everything is host-side; the protocol defines the metric, so the math
follows the reference exactly (thresholds at 41 recall points, the
left/right recall rounding of get_thresholds, ignored/DontCare absorption,
precision right-max smoothing, R11 = every 4th sample / 11, R40 = samples
1..40 / 40).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..ops import build
from .indoor_eval import rotated_intersection_np

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting",
               "truck"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41


# ---------------------------------------------------------------------------
# overlap matrices (vectorized numpy)
# ---------------------------------------------------------------------------

def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D axis-aligned overlap [N, K] (eval.py:87-114)."""
    N, K = len(boxes), len(query_boxes)
    if N == 0 or K == 0:
        return np.zeros((N, K), np.float64)
    b = boxes[:, None]
    q = query_boxes[None, :]
    iw = np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0])
    ih = np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1])
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    area_q = (q[..., 2] - q[..., 0]) * (q[..., 3] - q[..., 1])
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = area_b
    elif criterion == 1:
        ua = area_q
    else:
        ua = 1.0
    return np.where(inter > 0, inter / ua, 0.0)


def _rotated_inter_cw(b5a, b5b):
    """Rotated intersection with the reference's clockwise rotation
    (rotate_iou.py:208-228 rotates x' = c x + s y); our helper rotates
    CCW, so negate the angles."""
    a = b5a.copy()
    b = b5b.copy()
    a[:, 4] = -a[:, 4]
    b[:, 4] = -b[:, 4]
    return rotated_intersection_np(a, b).astype(np.float64)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """Rotated BEV overlap in camera x/z (eval.py:116-119).
    boxes [N, 5] = (x, z, l, w, ry)."""
    N, K = len(boxes), len(qboxes)
    if N == 0 or K == 0:
        return np.zeros((N, K), np.float64)
    inter = _rotated_inter_cw(boxes, qboxes)
    area_b = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_q = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q, inter.shape)
    else:
        return inter
    return np.where(inter > 0, inter / np.maximum(ua, 1e-12), 0.0)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D IoU in CAMERA coords (eval.py:122-155): boxes [N, 7] =
    (x, y, z, l, h, w, ry), y is the box BOTTOM."""
    N, K = len(boxes), len(qboxes)
    if N == 0 or K == 0:
        return np.zeros((N, K), np.float64)
    rinc = _rotated_inter_cw(boxes[:, [0, 2, 3, 5, 6]],
                             qboxes[:, [0, 2, 3, 5, 6]])
    b, q = boxes[:, None], qboxes[None, :]
    iw = np.minimum(b[..., 1], q[..., 1]) - \
        np.maximum(b[..., 1] - b[..., 4], q[..., 1] - q[..., 4])
    inc = np.where(iw > 0, iw * rinc, 0.0)
    va = (b[..., 3] * b[..., 4] * b[..., 5])
    vb = (q[..., 3] * q[..., 4] * q[..., 5])
    if criterion == -1:
        ua = va + vb - inc
    elif criterion == 0:
        ua = np.broadcast_to(va, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(vb, inc.shape)
    else:
        ua = inc
    return np.where((rinc > 0) & (iw > 0), inc / np.maximum(ua, 1e-12),
                    0.0)


# ---------------------------------------------------------------------------
# per-frame data cleaning (eval.py:30-84)
# ---------------------------------------------------------------------------

def clean_data(gt_anno, dt_anno, current_class, difficulty):
    cls_name = CLASS_NAMES[current_class]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        bbox = gt_anno["bbox"][i]
        gt_name = str(gt_anno["name"][i]).lower()
        height = bbox[3] - bbox[1]
        if gt_name == cls_name:
            valid_class = 1
        elif cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty] or
                  gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty] or
                  height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno["name"][i]) == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if str(dt_anno["name"][i]).lower() == cls_name \
            else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def get_thresholds(scores, num_gt, num_sample_pts=N_SAMPLE_PTS):
    """Score thresholds at ~41 evenly spaced recall points
    (eval.py:10-27, incl. the left/right recall rounding)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) \
                and i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


# ---------------------------------------------------------------------------
# sequential greedy matching kernel — python mirror of csrc/kitti_eval.cpp
# (reference compute_statistics_jit, eval.py:158-277)
# ---------------------------------------------------------------------------

NO_DETECTION = -10000000.0


def compute_statistics_py(overlaps, gt_datas, dt_datas, ignored_gt,
                          ignored_det, dc_bboxes, metric, min_overlap,
                          thresh=0.0, compute_fp=False, compute_aos=False):
    det_size, gt_size = len(dt_datas), len(gt_datas)
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    assigned = np.zeros(det_size, bool)
    ign_thr = (dt_scores < thresh) if compute_fp else \
        np.zeros(det_size, bool)
    tp = fp = fn = 0
    similarity = 0.0
    thresholds, delta = [], []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ign_thr[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if not compute_fp and overlap > min_overlap and \
                    dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif compute_fp and overlap > min_overlap and \
                    (overlap > max_overlap or assigned_ignored_det) and \
                    ignored_det[j] == 0:
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif compute_fp and overlap > min_overlap and \
                    valid_detection == NO_DETECTION and \
                    ignored_det[j] == 1:
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and \
                (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_det[j] in (-1, 1) or
                    ign_thr[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes):
            ov_dc = image_box_overlap(dt_datas[:, :4],
                                      np.asarray(dc_bboxes), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if assigned[j] or ignored_det[j] in (-1, 1) or \
                            ign_thr[j]:
                        continue
                    if ov_dc[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.asarray(thresholds)


# -- native kernel ----------------------------------------------------------

_native: dict = {}


def native_lib(required: bool = False):
    """The matcher's library, built on first use; None when it cannot be
    built (no host compiler; ``native_error`` says why, and the build is
    not tried again) unless ``required``."""
    if "lib" not in _native:
        try:
            _native["lib"] = build.load_host("kitti_eval")
        except (RuntimeError, OSError) as e:
            _native["lib"], _native["error"] = None, f"{type(e).__name__}: {e}"
    if _native["lib"] is None and required:
        raise RuntimeError(f"the KITTI matcher did not build: "
                           f"{_native['error']}")
    return _native["lib"]


def native_error():
    """Why the matcher's library did not build, or None."""
    native_lib()
    return _native.get("error")


def stats_batch(frames, metric, min_overlap, thresholds, compute_aos,
                native: Optional[bool] = None):
    """Accumulate pr[t] = (tp, fp, fn, similarity) over frames x
    thresholds (reference fused_compute_statistics, eval.py:291-338):
    ``native`` True the C++ matcher (raises if it cannot be built), False
    the Python mirror, None the matcher where it builds."""
    lib = None if native is False else native_lib(required=bool(native))
    pr = np.zeros((len(thresholds), 4), np.float64)
    if lib is not None and len(thresholds):
        f64 = np.float64
        ov = np.concatenate([f["overlaps"].reshape(-1) for f in frames]) \
            if frames else np.zeros(0)
        gt_nums = np.asarray([len(f["gt_datas"]) for f in frames], np.int32)
        dt_nums = np.asarray([len(f["dt_datas"]) for f in frames], np.int32)
        dc_nums = np.asarray([len(f["dc_bboxes"]) for f in frames], np.int32)
        gt_d = np.concatenate([f["gt_datas"] for f in frames]).astype(f64)
        dt_d = np.concatenate([f["dt_datas"] for f in frames]).astype(f64)
        dc = np.concatenate(
            [np.asarray(f["dc_bboxes"], f64).reshape(-1, 4)
             for f in frames]) if dc_nums.sum() else np.zeros((0, 4))
        ig = np.concatenate([f["ignored_gt"] for f in frames]).astype(
            np.int32)
        idt = np.concatenate([f["ignored_det"] for f in frames]).astype(
            np.int32)
        thr = np.ascontiguousarray(thresholds, f64)

        def pd(a):
            return np.ascontiguousarray(a, np.float64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_double))

        def pi(a):
            return np.ascontiguousarray(a, np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32))

        lib.kitti_stats_batch(
            pd(ov), pi(gt_nums), pi(dt_nums), pi(dc_nums),
            ctypes.c_int(len(frames)),
            pd(gt_d), pd(dt_d), pd(dc), pi(ig), pi(idt),
            ctypes.c_int(int(metric)), ctypes.c_double(float(min_overlap)),
            pd(thr), ctypes.c_int(len(thr)),
            ctypes.c_int(1 if compute_aos else 0),
            pr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return pr
    for f in frames:
        for t, th in enumerate(thresholds):
            tp, fp, fn, sim, _ = compute_statistics_py(
                f["overlaps"], f["gt_datas"], f["dt_datas"],
                f["ignored_gt"], f["ignored_det"], f["dc_bboxes"],
                metric, min_overlap, thresh=th, compute_fp=True,
                compute_aos=compute_aos)
            pr[t, 0] += tp
            pr[t, 1] += fp
            pr[t, 2] += fn
            if sim != -1:
                pr[t, 3] += sim
    return pr


# ---------------------------------------------------------------------------
# the evaluation (reference eval_class + do_eval, eval.py:448-618)
# ---------------------------------------------------------------------------

def _frame_overlaps(gt_annos, dt_annos, metric):
    """Per-frame [ndt, ngt] overlap matrices."""
    out = []
    for g, d in zip(gt_annos, dt_annos):
        if metric == 0:
            ov = image_box_overlap(np.asarray(d["bbox"], np.float64),
                                   np.asarray(g["bbox"], np.float64))
        elif metric == 1:
            db = np.concatenate(
                [d["location"][:, [0, 2]], d["dimensions"][:, [0, 2]],
                 d["rotation_y"][:, None]], 1)
            gb = np.concatenate(
                [g["location"][:, [0, 2]], g["dimensions"][:, [0, 2]],
                 g["rotation_y"][:, None]], 1)
            ov = bev_box_overlap(db, gb)
        else:
            db = np.concatenate(
                [d["location"], d["dimensions"], d["rotation_y"][:, None]],
                1)
            gb = np.concatenate(
                [g["location"], g["dimensions"], g["rotation_y"][:, None]],
                1)
            ov = d3_box_overlap(db, gb)
        out.append(ov.astype(np.float64))
    return out


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, native=None):
    assert len(gt_annos) == len(dt_annos)
    overlaps = _frame_overlaps(gt_annos, dt_annos, metric)
    num_minoverlap = len(min_overlaps)
    shape = [len(current_classes), len(difficultys), num_minoverlap,
             N_SAMPLE_PTS]
    precision = np.zeros(shape)
    recall = np.zeros(shape)
    aos = np.zeros(shape)
    for m, cls in enumerate(current_classes):
        for l, diff in enumerate(difficultys):
            frames = []
            total_valid_gt = 0
            for i in range(len(gt_annos)):
                nv, ig, idt, dc = clean_data(gt_annos[i], dt_annos[i],
                                             cls, diff)
                total_valid_gt += nv
                gt_datas = np.concatenate(
                    [gt_annos[i]["bbox"],
                     gt_annos[i]["alpha"][:, None]], 1)
                dt_datas = np.concatenate(
                    [dt_annos[i]["bbox"], dt_annos[i]["alpha"][:, None],
                     dt_annos[i]["score"][:, None]], 1)
                frames.append(dict(
                    overlaps=overlaps[i], gt_datas=gt_datas,
                    dt_datas=dt_datas, ignored_gt=np.asarray(ig, np.int64),
                    ignored_det=np.asarray(idt, np.int64), dc_bboxes=dc))
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                scores = []
                for f in frames:
                    _, _, _, _, th = compute_statistics_py(
                        f["overlaps"], f["gt_datas"], f["dt_datas"],
                        f["ignored_gt"], f["ignored_det"], f["dc_bboxes"],
                        metric, min_overlap, thresh=0.0, compute_fp=False)
                    scores += th.tolist()
                thresholds = np.asarray(
                    get_thresholds(np.asarray(scores), total_valid_gt))
                pr = stats_batch(frames, metric, min_overlap, thresholds,
                                 compute_aos, native)
                for i in range(len(thresholds)):
                    recall[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:])
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:])
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:])
    return dict(recall=recall, precision=precision, orientation=aos)


def get_mAP(prec):
    return np.sum(prec[..., ::4], axis=-1) / 11 * 100


def get_mAP_R40(prec):
    return np.sum(prec[..., 1:], axis=-1) / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, native=None):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos, native)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_bbox_R40 = get_mAP_R40(ret["precision"])
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret["orientation"])
        mAP_aos_R40 = get_mAP_R40(ret["orientation"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps, native=native)
    mAP_bev = get_mAP(ret["precision"])
    mAP_bev_R40 = get_mAP_R40(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps, native=native)
    mAP_3d = get_mAP(ret["precision"])
    mAP_3d_R40 = get_mAP_R40(ret["precision"])
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos,
            mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40)


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             native: Optional[bool] = None):
    """(result_str, ret_dict) like the reference (eval.py:639-747);
    ``native`` as in ``stats_batch``."""
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7]] * 3)
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], 0)  # [2, 3, 6]
    name_to_class = {n.capitalize() if "_" not in n else
                     "_".join(s.capitalize() for s in n.split("_")): i
                     for i, n in enumerate(CLASS_NAMES)}
    name_to_class["Person_sitting"] = CLASS_NAMES.index("person_sitting")
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    cls_int = [name_to_class[c] if isinstance(c, str) else int(c)
               for c in current_classes]
    min_overlaps = min_overlaps[:, :, cls_int]
    compute_aos = False
    for anno in dt_annos:
        if len(anno["alpha"]):
            compute_aos = anno["alpha"][0] != -10
            break
    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(gt_annos, dt_annos, cls_int, min_overlaps,
                           compute_aos, native)
    result = ""
    ret = {}
    for j, c in enumerate(cls_int):
        name = [n for n, v in name_to_class.items() if v == c][0]
        for i in range(min_overlaps.shape[0]):
            ovl = min_overlaps[i, :, j]
            result += (f"{name} AP@{ovl[0]:.2f}, {ovl[1]:.2f}, "
                       f"{ovl[2]:.2f}:\n")
            result += (f"bbox AP:{mAPbbox[j, 0, i]:.4f}, "
                       f"{mAPbbox[j, 1, i]:.4f}, {mAPbbox[j, 2, i]:.4f}\n")
            result += (f"bev  AP:{mAPbev[j, 0, i]:.4f}, "
                       f"{mAPbev[j, 1, i]:.4f}, {mAPbev[j, 2, i]:.4f}\n")
            result += (f"3d   AP:{mAP3d[j, 0, i]:.4f}, "
                       f"{mAP3d[j, 1, i]:.4f}, {mAP3d[j, 2, i]:.4f}\n")
            result += (f"{name} AP_R40@{ovl[0]:.2f}, {ovl[1]:.2f}, "
                       f"{ovl[2]:.2f}:\n")
            result += (f"bbox AP:{mAPbbox_R40[j, 0, i]:.4f}, "
                       f"{mAPbbox_R40[j, 1, i]:.4f}, "
                       f"{mAPbbox_R40[j, 2, i]:.4f}\n")
            result += (f"bev  AP:{mAPbev_R40[j, 0, i]:.4f}, "
                       f"{mAPbev_R40[j, 1, i]:.4f}, "
                       f"{mAPbev_R40[j, 2, i]:.4f}\n")
            result += (f"3d   AP:{mAP3d_R40[j, 0, i]:.4f}, "
                       f"{mAP3d_R40[j, 1, i]:.4f}, "
                       f"{mAP3d_R40[j, 2, i]:.4f}\n")
            if compute_aos:
                result += (f"aos  AP:{mAPaos_R40[j, 0, i]:.2f}, "
                           f"{mAPaos_R40[j, 1, i]:.2f}, "
                           f"{mAPaos_R40[j, 2, i]:.2f}\n")
                if i == 0:
                    for d, dn in enumerate(("easy", "moderate", "hard")):
                        ret[f"{name}_aos/{dn}_R40"] = mAPaos_R40[j, d, 0]
            if i == 0:
                for d, dn in enumerate(("easy", "moderate", "hard")):
                    ret[f"{name}_3d/{dn}_R40"] = mAP3d_R40[j, d, 0]
                    ret[f"{name}_bev/{dn}_R40"] = mAPbev_R40[j, d, 0]
                    ret[f"{name}_image/{dn}_R40"] = mAPbbox_R40[j, d, 0]
                    ret[f"{name}_3d/{dn}"] = mAP3d[j, d, 0]
                    ret[f"{name}_bev/{dn}"] = mAPbev[j, d, 0]
    return result, ret
