"""Greedy NMS over fixed-capacity candidate sets.

Counterpart of ``cagroup3d_tpu/core/nms.py``: ``rotated=False`` is pcdet's
nms_normal_gpu (axis-aligned BEV IoU, ScanNet), ``rotated=True`` its
nms_gpu (rotated BEV IoU, SUN RGB-D).  The classes are a batch axis: one
greedy pass in score order over the candidates suppresses in every class
at once.  Ties break toward the lower index everywhere, as
``jax.lax.top_k`` and the stable ``jnp.argsort`` do.  The IoU matrix is
built in blocks of rows of at most ``BLOCK_PAIRS`` pairs each: the rotated
overlap clips every pair's polygon to 64 vertices, so one [4096, 4096]
block would hold tens of GB at once.  Each pair's value is computed alone,
so the blocks give the matrix's values and the greedy pass its order.
"""
from __future__ import annotations

import torch

from .geometry import iou_bev_aligned, iou_bev_rotated, pairwise

NEG_INF = -1e10
BLOCK_PAIRS = 1 << 20


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index: (values, idx)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def overlap_matrix(boxes7: torch.Tensor, iou_thr: float, rotated: bool,
                   block_pairs: int = BLOCK_PAIRS) -> torch.Tensor:
    """IoU(boxes7[..., i], boxes7[..., j]) > iou_thr as bool [..., N, N],
    computed in blocks of rows of at most ``block_pairs`` pairs."""
    n = boxes7.shape[-2]
    iou_fn = iou_bev_rotated if rotated else iou_bev_aligned
    rows = max(1, block_pairs // max(1, boxes7[..., 0].numel()))
    if rows >= n:
        return pairwise(iou_fn, boxes7, boxes7) > iou_thr
    return torch.cat([pairwise(iou_fn, boxes7[..., i:i + rows, :], boxes7)
                      > iou_thr for i in range(0, n, rows)], dim=-2)


def greedy_nms(boxes7: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, iou_thr: float,
               rotated: bool = False) -> torch.Tensor:
    """boxes7 [..., N, 7], scores/valid [..., N] -> keep bool[..., N]
    (original order), batched over the leading axes."""
    n = boxes7.shape[-2]
    s = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-s, dim=-1, stable=True)
    b = torch.gather(boxes7.detach(), -2, order[..., None].expand_as(boxes7))
    v = torch.gather(valid, -1, order)
    over = overlap_matrix(b, iou_thr, rotated)                # [..., N, N]
    keep = torch.zeros_like(v)
    suppressed = torch.zeros_like(v)
    for i in range(n):
        k = v[..., i] & ~suppressed[..., i]
        keep[..., i] = k
        suppressed |= k[..., None] & over[..., i, :]
    out = torch.zeros_like(keep)
    out.scatter_(-1, order, keep)
    return out


def multiclass_nms(bboxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, score_thr: float, iou_thr: float,
                   per_cls_cap: int, out_cap: int, rotated: bool = False,
                   flip_heading_for_iou: bool = True):
    """Per-class NMS (CAGroup3DHead._nms).

    bboxes [P, D] (D >= 7: extra columns ride along), scores [P, C],
    valid [P].  Candidates per class: the top
    ``per_cls_cap`` above ``score_thr``; output: the top ``out_cap`` kept
    detections over all classes.  ``rotated`` uses the rotated BEV IoU;
    with ``flip_heading_for_iou`` its boxes are compared with the heading
    negated, as the reference calls nms_gpu from the head.  Returns (boxes
    [out_cap, D], scores [out_cap], labels i64[out_cap], valid
    [out_cap])."""
    P, C = scores.shape
    cls_scores = scores.T                                        # [C, P]
    cand = valid[None, :] & (cls_scores > score_thr)
    top_s, idx = topk_stable(
        torch.where(cand, cls_scores, torch.full_like(cls_scores, NEG_INF)),
        per_cls_cap)
    sel_ok = top_s > NEG_INF / 2
    b = bboxes[idx]                                              # [C, K, D]
    s = torch.gather(cls_scores, 1, idx)
    b_iou = b
    if rotated and flip_heading_for_iou:
        b_iou = torch.cat([b[..., :6], -b[..., 6:7], b[..., 7:]], dim=-1)
    keep = greedy_nms(b_iou, s, sel_ok, iou_thr, rotated)
    labels = torch.arange(C, device=scores.device)[:, None].expand_as(keep)
    s_flat = s.reshape(-1)
    top, idx2 = topk_stable(
        torch.where(keep.reshape(-1), s_flat, torch.full_like(s_flat, NEG_INF)),
        out_cap)
    ok = top > NEG_INF / 2
    zero = torch.zeros((), device=scores.device)
    out_boxes = torch.where(ok[:, None], b.reshape(-1, b.shape[-1])[idx2],
                            zero)
    out_scores = torch.where(ok, s_flat[idx2], zero)
    out_labels = torch.where(ok, labels.reshape(-1)[idx2],
                             torch.zeros_like(idx2))
    return out_boxes, out_scores, out_labels, ok
