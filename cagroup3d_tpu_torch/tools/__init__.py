"""Command-line entry points (``python -m cagroup3d_tpu_torch.tools.test``)."""
