"""Utilities: synthetic scenes and dataset trees, the CLI logger."""
