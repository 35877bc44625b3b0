"""Plain PyTorch oracle for the merge-path SpMV kernel."""
from __future__ import annotations

import torch

from repro_torch.core.segops import segment_sum


def _row_ids(row_offsets: torch.Tensor, nnz: int) -> torch.Tensor:
    atoms = torch.arange(nnz, dtype=torch.int32, device=row_offsets.device)
    return torch.searchsorted(row_offsets, atoms, right=True,
                              out_int32=True) - 1


def spmv_ref(row_offsets: torch.Tensor, col_indices: torch.Tensor,
             values: torch.Tensor, x: torch.Tensor,
             num_rows: int) -> torch.Tensor:
    """y = A @ x via one global segmented reduction (no blocking)."""
    nnz = int(values.shape[0])
    prods = values.float() * x[col_indices.long()].float()
    return segment_sum(prods, _row_ids(row_offsets, nnz), num_rows)


def merge_stream_ref(row_offsets, col_indices, values, x, num_rows: int,
                     nnz: int, padded_total: int):
    """The merged work-item stream: ``(stream_vals, stream_rows)``.

    Atom ``a`` sits at position ``a + row(a)`` with value
    ``vals[a] * x[col[a]]``; row ``r``'s end marker at
    ``row_offsets[r+1] + r`` with value 0; padding rows = ``num_rows``.
    """
    device = row_offsets.device
    row_ids = _row_ids(row_offsets, nnz)
    prods = values.float() * x[col_indices.long()].float()
    stream_vals = torch.zeros(padded_total, dtype=torch.float32,
                              device=device)
    stream_rows = torch.full((padded_total,), num_rows, dtype=torch.int32,
                             device=device)
    atom_pos = torch.arange(nnz, device=device) + row_ids
    stream_vals[atom_pos] = prods
    stream_rows[atom_pos] = row_ids
    rows = torch.arange(num_rows, dtype=torch.int32, device=device)
    stream_rows[(row_offsets[1:] + rows).long()] = rows
    return stream_vals, stream_rows
