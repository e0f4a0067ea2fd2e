"""Training: optimizer and schedule, checkpoints, the training loop, the
eval harness."""
