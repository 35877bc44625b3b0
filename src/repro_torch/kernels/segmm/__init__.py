"""Segmented (grouped) matmul: the MoE expert GEMM, the wavefront's level
GEMM."""
