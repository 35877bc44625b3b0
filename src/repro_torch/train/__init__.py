"""Training: optimizer, step, compression, checkpoints, int8 state, and
the GPipe pipeline over ``pod``."""
