"""Training: optimizer, step, compression, checkpoints, int8 state."""
