"""Load-balanced document packing — the paper's abstraction applied to the
data pipeline.

Packing documents of wildly varying length into fixed-length rows is a
load-balancing problem: atoms = tokens, tiles = documents, processors =
batch rows.  The merge-path partition splits ``tokens + documents`` work
exactly evenly across rows, so every packed row carries the same token
count (+-1 document boundary).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import as_int32
from repro_torch.core import WorkSpec, merge_path_partition


def _host(doc_lengths) -> np.ndarray:
    if isinstance(doc_lengths, torch.Tensor):
        return doc_lengths.detach().cpu().numpy()
    return np.asarray(doc_lengths)


def _validate_lengths(doc_lengths, num_rows: int,
                      row_capacity: Optional[int]) -> None:
    """Reject malformed packing inputs with a clean error at build time:
    an empty document set, zero or negative lengths, ``num_rows < 1``, a
    bad ``row_capacity`` or more tokens than the rows can hold (the merge
    path would silently mis-pack each of them)."""
    if num_rows < 1:
        raise ValueError(f"num_rows must be >= 1, got {num_rows}")
    arr = _host(doc_lengths)
    if arr.size == 0:
        raise ValueError("pack_documents needs at least one document "
                         "(got empty doc_lengths)")
    if (arr < 0).any():
        bad = np.flatnonzero(arr < 0)
        raise ValueError(
            f"negative document lengths at indices {bad[:8].tolist()} "
            f"(e.g. {int(arr[bad[0]])}); lengths must be >= 0")
    if (arr == 0).any():
        bad = np.flatnonzero(arr == 0)
        raise ValueError(
            f"zero-length documents at indices {bad[:8].tolist()}; drop "
            f"empty entries before packing (an empty document would "
            f"silently vanish into a row boundary)")
    if row_capacity is not None:
        if row_capacity < 1:
            raise ValueError(f"row_capacity must be >= 1 or None, "
                             f"got {row_capacity}")
        total = int(arr.sum())
        if total > num_rows * row_capacity:
            raise ValueError(
                f"{total} tokens cannot fit {num_rows} rows of capacity "
                f"{row_capacity} ({num_rows * row_capacity} slots); "
                f"raise num_rows or row_capacity")


def pack_documents(doc_lengths, num_rows: int, *,
                   row_capacity: Optional[int] = None,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partition documents into ``num_rows`` balanced rows.

    Returns ``(row_token_starts [R+1], row_doc_starts [R+1])`` (int32):
    row ``r`` carries tokens ``[row_token_starts[r],
    row_token_starts[r+1])`` of the concatenated token stream (documents
    crossing a row boundary are split).  A tensor input keeps its device;
    anything else lands on ``device`` (``None``: the card).  Malformed
    inputs raise :class:`ValueError`; ``row_capacity`` optionally bounds
    the per-row token count.
    """
    _validate_lengths(doc_lengths, num_rows, row_capacity)
    lengths = as_int32(doc_lengths, device)
    total = int(lengths.sum())
    spec = WorkSpec.from_segment_sizes(lengths, num_atoms=total)
    part = merge_path_partition(spec, num_rows)
    if row_capacity is not None:
        per_row = np.diff(part.atom_starts.cpu().numpy())
        if per_row.size and int(per_row.max()) > row_capacity:
            worst = int(np.argmax(per_row))
            raise ValueError(
                f"balanced packing puts {int(per_row[worst])} tokens in "
                f"row {worst}, over row_capacity={row_capacity}; raise "
                f"num_rows or row_capacity")
    return part.atom_starts, part.tile_starts


def packing_efficiency(doc_lengths, num_rows: int, *, device=None) -> dict:
    """Compare balanced packing vs naive one-doc-per-row padding."""
    doc_lengths = _host(doc_lengths)
    total = int(doc_lengths.sum())
    starts, _ = pack_documents(doc_lengths, num_rows, device=device)
    per_row = np.diff(starts.cpu().numpy())
    balanced_cost = int(per_row.max()) * num_rows
    naive_rows = len(doc_lengths)
    naive_cost = int(doc_lengths.max()) * naive_rows
    return {
        "tokens": total,
        "balanced_padded": balanced_cost,
        "balanced_efficiency": total / max(balanced_cost, 1),
        "naive_padded": naive_cost,
        "naive_efficiency": total / max(naive_cost, 1),
    }
