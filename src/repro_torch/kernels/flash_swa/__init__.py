"""Banded sliding-window flash attention (K7): ``csrc/flash_swa.cu``."""
