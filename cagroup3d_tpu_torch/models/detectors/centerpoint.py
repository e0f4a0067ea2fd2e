"""CenterPoint: SECOND's voxel pipeline (MeanVFE, VoxelBackBone8x,
HeightCompression, BaseBEVBackbone) with the anchor-free ``CenterHead``.

Counterpart of ``cagroup3d_tpu/models/detectors/centerpoint.py`` (the
reference's pcdet/models/detectors/centerpoint.py).  The head's forward,
loss and prediction keep ``SECONDNet``'s contracts, so eval, training and
``--dist`` are SECONDNet's; without a dataset the class names come from
the head's ``CLASS_NAMES_EACH_HEAD``.
"""
from __future__ import annotations

from .second_net import SECONDNet


class CenterPoint(SECONDNet):
    pass
