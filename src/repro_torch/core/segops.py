"""Segmented primitives used by the work-execution stages.

The reference's ``onehot_segment_sum`` (a matrix-unit idiom of the TPU)
has no counterpart here: the executors and kernels reduce contiguous runs
directly, in ``O(atoms + segments)`` memory.
"""
from __future__ import annotations

import torch

#: Identity of each combiner (the empty segment's value).
IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}

_SCATTER_REDUCE = {"min": "amin", "max": "amax"}


def segment_reduce(combiner: str, values: torch.Tensor,
                   segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Segmented ``sum``/``min``/``max``; empty segments hold the identity.

    Ids outside ``[0, num_segments)`` are not allowed (route dropped
    values to an extra overflow segment and slice it off).  On CUDA the
    float ``sum`` adds in atomic order, so it is exact only for exactly
    summable values; ``min``/``max`` are exact regardless.
    """
    ids = segment_ids.to(torch.int64)
    if combiner == "sum":
        out = torch.zeros(num_segments, dtype=values.dtype,
                          device=values.device)
        return out.index_add_(0, ids, values)
    out = torch.full((num_segments,), IDENTITY[combiner], dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, ids, values, _SCATTER_REDUCE[combiner],
                               include_self=True)


def window_slots(starts: torch.Tensor, n: int, window: int):
    """Window coordinates of items ``0..n-1`` over ranges
    ``[starts[c], starts[c+1])`` (non-decreasing ``starts``): returns
    ``(range, offset, inside)`` — item ``i`` sits in slot
    ``(range, offset)``; ``inside`` is false when no range holds it within
    ``window`` of the range's start (``range`` is then clamped)."""
    num_ranges = int(starts.shape[0]) - 1
    item = torch.arange(n, dtype=torch.int32, device=starts.device)
    found = torch.searchsorted(starts, item, right=True) - 1
    safe = torch.clamp(found, 0, max(num_ranges - 1, 0))
    bounds = starts.long()
    offset = item.long() - bounds[safe]
    inside = ((found >= 0) & (found < num_ranges)
              & (item.long() < bounds[safe + 1]) & (offset < window))
    return safe, offset, inside


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return segment_reduce("sum", values, segment_ids, num_segments)


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return segment_reduce("max", values, segment_ids, num_segments)


def segment_count(segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    return torch.bincount(segment_ids.to(torch.int64),
                          minlength=num_segments)[:num_segments].to(
                              torch.int32)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable per-segment softmax."""
    ids = segment_ids.to(torch.int64)
    seg_max = segment_max(logits, ids, num_segments)
    exp = torch.exp(logits - seg_max[ids])
    denom = segment_sum(exp, ids, num_segments)
    return exp / torch.clamp(denom[ids], min=1e-30)


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive prefix sum — the group-mapped schedule's setup primitive."""
    return torch.cumsum(x, dim=dim) - x
