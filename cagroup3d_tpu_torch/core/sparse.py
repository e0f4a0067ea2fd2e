"""Fixed-capacity sparse voxel tensor (one scene).

Counterpart of ``cagroup3d_tpu/core/sparse.py``: a tensor holds up to
``cap`` voxels, of which the ``valid`` rows are real.  Coordinates are
integer lattice coordinates scaled by ``stride`` (MinkowskiEngine's
convention); padding rows hold ``PAD_COORD``.
"""
from __future__ import annotations

import dataclasses

import torch

# Coordinate of padding rows: any kernel offset added to it stays outside
# the packable range, so lookups always miss.
PAD_COORD = 1 << 20


def zero_invalid(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """x [..., N, C] with the rows where valid [..., N] is False set to 0."""
    return torch.where(valid[..., None], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and held in f32: products of two such values are
    exact in f32, so an f32 matmul of them is a bf16 matmul with f32
    accumulation (the JAX package's ``preferred_element_type=f32``)."""
    return x.to(torch.bfloat16).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """coords i32[cap, 3], feats f32[cap, C], valid bool[cap], stride int."""

    coords: torch.Tensor
    feats: torch.Tensor
    valid: torch.Tensor
    stride: int

    @property
    def cap(self) -> int:
        return self.coords.shape[0]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    def with_feats(self, feats: torch.Tensor) -> "SparseTensor":
        return SparseTensor(self.coords, feats, self.valid, self.stride)

    def masked_feats(self) -> torch.Tensor:
        return zero_invalid(self.feats, self.valid)
