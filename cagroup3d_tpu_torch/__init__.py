"""PyTorch/CUDA port of CAGroup3D-TPU for NVIDIA Hopper (H100).

Mirrors the layout of the JAX package ``cagroup3d_tpu`` (``core/``,
``ops/``, ``models/...``), which stays the reference; the port imports
``torch`` and never ``jax``.  Hand-written CUDA kernels live in ``csrc/``
and are built at first use (``ops/build.py``).
"""

__version__ = "0.1.0"
