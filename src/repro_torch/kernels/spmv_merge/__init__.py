"""Merge-path SpMV and the chunk-walk executor kernels."""
