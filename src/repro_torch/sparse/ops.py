"""Load-balanced sparse linear algebra (paper Listings 3-4, §5.3).

The *computation* is the atom transform plus the per-tile reduction;
which schedule partitions the work and which executor consumes it are
arguments.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import (Schedule, blocked_tile_reduce, choose_schedule,
                              execute_tile_reduce, make_partition,
                              tile_reduce)
from repro_torch.sparse.formats import CSR

DEFAULT_BLOCKS = 128  # grid blocks used by the blocked executors


def spmv_reference(A: CSR, x: torch.Tensor) -> torch.Tensor:
    """Oracle: one global segmented reduction (schedule-free)."""
    vals, cols = A.values, A.col_indices
    return tile_reduce(A.workspec(), lambda nz: vals[nz] * x[cols[nz]])


def spmv(A: CSR, x: torch.Tensor, *,
         schedule: Optional[Schedule | str] = None,
         num_blocks: int = DEFAULT_BLOCKS,
         impl: str = "blocked") -> torch.Tensor:
    """Load-balanced SpMV ``y = A @ x``.

    ``schedule=None`` applies the paper's §6.2 heuristic.  ``impl``:
    ``"blocked"`` (the pure blocked executor), ``"pallas"`` (the
    reference's name, kept: the merge-path CUDA kernel) or
    ``"reference"``.
    """
    if schedule is None:
        schedule = choose_schedule(A.shape[0], A.nnz)
    schedule = Schedule(schedule)
    if impl == "reference":
        return spmv_reference(A, x)
    if impl == "pallas":
        from repro_torch.kernels.spmv_merge import ops as kops
        return kops.spmv_merge_path(A, x, num_blocks=num_blocks)
    if impl != "blocked":
        raise ValueError(f"unknown impl: {impl!r}")
    spec = A.workspec()
    part = make_partition(spec, schedule, num_blocks)
    vals, cols = A.values, A.col_indices
    return blocked_tile_reduce(spec, part, lambda nz: vals[nz] * x[cols[nz]])


def spmm(A: CSR, B: torch.Tensor, *,
         schedule: Optional[Schedule | str] = None,
         num_blocks: int = DEFAULT_BLOCKS) -> torch.Tensor:
    """SpMM ``C = A @ B`` — the paper's Listing 4: one extra loop over the
    columns of B around the unchanged SpMV computation, with the partition
    built once per call and shared by every column.  Each column runs on
    the default execution path (the chunk-walk kernel where the partition
    supports it)."""
    if schedule is None:
        schedule = choose_schedule(A.shape[0], A.nnz)
    spec = A.workspec()
    part = make_partition(spec, schedule, num_blocks)   # once per spmm call
    vals, cols = A.values, A.col_indices
    columns = []
    for j in range(B.shape[1]):
        b = B[:, j]   # atom_fn runs inside the call, so the loop cell is safe
        columns.append(execute_tile_reduce(
            spec, part, lambda nz: vals[nz] * b[cols[nz]]))
    if not columns:
        return torch.zeros((A.shape[0], 0), dtype=torch.float32,
                           device=A.device)
    return torch.stack(columns, dim=1)


def spvv(x_sparse_vals: torch.Tensor, x_sparse_idx: torch.Tensor,
         y_dense: torch.Tensor) -> torch.Tensor:
    """Sparse-vector x dense-vector dot (the perfectly balanced case)."""
    return torch.dot(x_sparse_vals, y_dense[x_sparse_idx])
