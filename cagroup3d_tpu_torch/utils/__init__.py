"""Utilities: synthetic scenes as tensors."""
