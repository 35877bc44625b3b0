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

    ``values`` is ``[n]`` or ``[n, B]`` (``B`` columns, each reduced by the
    same ids: column ``j`` of the result has the bits of the call on column
    ``j`` alone); the result is ``[num_segments]`` or ``[num_segments,
    B]``.  Ids outside ``[0, num_segments)`` are not allowed (route dropped
    values to an extra overflow segment and slice it off).  Every result
    has the same bits on every run: ``min``/``max`` and integer sums are
    exact in any order (``scatter_reduce_``/``index_add_``); a float
    ``sum`` adds in ascending position (``index_add_`` on the CPU) or, on
    the card, in the order of a stable sort of the ids
    (:func:`ordered_sum`).
    """
    if (combiner == "sum" and values.is_floating_point()
            and values.device.type == "cuda"):
        return ordered_sum(values, segment_ids, num_segments)
    ids = segment_ids.to(torch.int64)
    shape = (num_segments,) + tuple(values.shape[1:])
    if combiner == "sum":
        out = torch.zeros(shape, dtype=values.dtype, device=values.device)
        return out.index_add_(0, ids, values)
    out = torch.full(shape, IDENTITY[combiner], dtype=values.dtype,
                     device=values.device)
    if values.dim() == 2:
        ids = ids[:, None].expand(-1, values.shape[1])
    return out.scatter_reduce_(0, ids, values, _SCATTER_REDUCE[combiner],
                               include_self=True)


def ordered_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Float segment sum of ``[n]`` or ``[n, B]`` ``values`` in a fixed
    order: the items sorted by id with a stable sort (unique, so the same
    on every run, and done once for all ``B`` columns), then summed run by
    run by the ``segment_sum_sorted`` kernel (on CPU tensors its plain
    version).  float16/bfloat16 values are summed in float32 and rounded
    once."""
    # imported here: the kernels' module imports this one
    from repro_torch.kernels.spmv_merge.kernel import segment_sum_sorted
    if values.dim() not in (1, 2):
        raise ValueError(f"the ordered sum takes [n] or [n, B] values, got "
                         f"shape {tuple(values.shape)}")
    keys, order = torch.sort(segment_ids.to(torch.int32), stable=True)
    wide = (values if values.dtype in (torch.float32, torch.float64)
            else values.float())
    return segment_sum_sorted(wide.contiguous(), keys, num_segments,
                              order=order).to(values.dtype)


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


def exclusive_cumsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exclusive prefix sum — the group-mapped schedule's setup primitive."""
    return torch.cumsum(x, dim=axis) - x
