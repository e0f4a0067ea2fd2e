"""CenterNet utilities: the gaussian radius, dense gaussian heatmaps and the
top-k peaks of a heatmap.

Counterpart of ``cagroup3d_tpu/models/model_utils/centernet_utils.py`` (the
reference's pcdet/models/model_utils/centernet_utils.py): the heatmap is a
max over the objects' windowed gaussians evaluated on the whole [H, W] grid
(no per-object loop), and the peaks are the top k of the flattened map,
ties to the lower index as ``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

import torch

from ...core.nms import topk_stable


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float = 0.5) -> torch.Tensor:
    """The smallest of CornerNet's three radii for boxes of ``height`` x
    ``width`` (elementwise)."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4.0 * c1).clamp(min=0.0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt((b2 ** 2 - 4 * 4.0 * c2).clamp(min=0.0))) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_gaussians_dense(centers: torch.Tensor, radii: torch.Tensor,
                         cls_ids: torch.Tensor, valid: torch.Tensor,
                         num_classes: int, fmap_hw) -> torch.Tensor:
    """Heatmap [num_classes, H, W]: per class the max over its valid objects
    of the reference's windowed gaussian about the floored center (sigma =
    (2r + 1) / 6, support |dx|, |dy| <= r).

    centers f32[G, 2] (x, y) in map cells; radii int[G]; cls_ids int[G]
    (0-based); valid bool[G]."""
    H, W = fmap_hw
    dev = centers.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    cx = torch.floor(centers[:, 0])
    cy = torch.floor(centers[:, 1])
    dx = xs[None, None, :] - cx[:, None, None]                 # [G, 1, W]
    dy = ys[None, :, None] - cy[:, None, None]                 # [G, H, 1]
    r = radii.to(torch.float32)[:, None, None]
    sigma = (2.0 * r + 1.0) / 6.0
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    support = (dx.abs() <= r) & (dy.abs() <= r) & valid[:, None, None]
    g = torch.where(support, g, torch.zeros_like(g))           # [G, H, W]
    onehot = (cls_ids[None, :] == torch.arange(
        num_classes, device=dev)[:, None]).to(g.dtype)          # [C, G]
    if g.shape[0] == 0:
        return g.new_zeros(num_classes, H, W)
    return (g[None] * onehot[..., None, None]).amax(dim=1)


def topk_peaks(heatmap: torch.Tensor, K: int):
    """heatmap [C, H, W] -> (scores [K], class ids i32[K], flat pixel ids
    i32[K], ys [K], xs [K]) of the K largest values, ties to the lower flat
    index."""
    C, H, W = heatmap.shape
    scores, inds = topk_stable(heatmap.reshape(-1), K)
    pix = inds % (H * W)
    return (scores, (inds // (H * W)).to(torch.int32), pix.to(torch.int32),
            (pix // W).to(torch.float32), (pix % W).to(torch.float32))
