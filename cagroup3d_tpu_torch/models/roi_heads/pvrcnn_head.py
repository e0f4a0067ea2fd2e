"""The proposal layer of the outdoor two-stage heads.

Counterpart of the part of ``PVRCNNHead`` in
``cagroup3d_tpu/models/roi_heads/pvrcnn_head.py`` that ``SECONDHead``
inherits (the reference's roi_head_template.py proposal_layer): the top
``NMS_PRE_MAXSIZE`` anchors by their best class score, a class-agnostic
rotated greedy NMS at ``NMS_THRESH``, and the top ``NMS_POST_MAXSIZE`` of
what it keeps, padded, from the ``NMS_CONFIG`` of the phase (``TRAIN`` or
``TEST``).  The overlap matrix is built in row blocks
(``core/nms.overlap_matrix``), never whole: at the training setting of
SECOND-IoU, 9000 candidates, it has 81M pairs.  PV-RCNN's keypoint grid
pooling is not ported.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core import nms as nms_mod


class PVRCNNHead(nn.Module):
    def __init__(self, model_cfg):
        super().__init__()
        self.nms_cfg = model_cfg.NMS_CONFIG

    @torch.no_grad()
    def proposal_layer(self, boxes: torch.Tensor, scores: torch.Tensor,
                       labels: torch.Tensor, valid: torch.Tensor,
                       train: bool):
        """One scene: boxes [A, 7] (decoded anchors), scores [A] (the
        best class's sigmoid), labels [A], valid [A] -> (rois [M, 7],
        roi_scores [M], roi_labels [M], roi_valid [M]) with M =
        min(NMS_POST_MAXSIZE, NMS_PRE_MAXSIZE, A), best first; ties go to
        the lower index, as ``jax.lax.top_k``'s do.  No gradient flows
        into the proposals (the reference's ``torch.no_grad``)."""
        nc = self.nms_cfg["TRAIN" if train else "TEST"]
        k = min(int(nc["NMS_PRE_MAXSIZE"]), boxes.shape[0])
        neg = torch.full_like(scores, -1.0)
        s, ids = nms_mod.topk_stable(torch.where(valid, scores, neg), k)
        b, lab = boxes[ids], labels[ids]
        v = s > -0.5
        keep = nms_mod.greedy_nms(b, torch.where(v, s, torch.full_like(
            s, -1.0)), v, float(nc["NMS_THRESH"]), rotated=True)
        v = v & keep
        m = min(int(nc["NMS_POST_MAXSIZE"]), k)
        so, oid = nms_mod.topk_stable(torch.where(v, s, torch.full_like(
            s, -1.0)), m)
        return b[oid], so, lab[oid], v[oid]
