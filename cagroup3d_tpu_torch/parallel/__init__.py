"""The training step (one card)."""
