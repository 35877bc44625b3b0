"""Work execution (paper §3.3 / §4.3) — schedule-agnostic consumers.

The user supplies an *atom transform* (atom ids -> values, e.g.
``lambda nz: vals[nz] * x[col[nz]]`` for SpMV) and a combiner; the
executors consume a :class:`Partition`:

* :func:`tile_reduce` — the oracle: one segmented reduce over all atoms.
* :func:`blocked_tile_reduce` — the *pure* path: every block reduces
  exactly its partition slice into local tile bins, and the shared fixup
  combines tiles cut by block boundaries.
* :func:`native_chunk_tile_reduce` — the *native* path: the chunk-walk
  CUDA kernel (``repro_torch.kernels.spmv_merge.kernel``), one CTA per
  physical block draining its chunk queue.

:func:`execute_tile_reduce` routes a Partition to one of the two by
:class:`ExecutionPath`; :func:`execute_scatter_reduce` is the push
advance's counterpart (value windows combined by per-atom output ids, with
an optional gather-compacted window mode).  Both paths share the fixup and
the scatter, so they agree bitwise wherever the combine is exact.
"""
from __future__ import annotations

import enum
from typing import Callable, Tuple

import torch

from repro_torch.core.schedules import Partition, invert_block_map
from repro_torch.core.segops import IDENTITY, segment_reduce, window_slots
from repro_torch.core.work import WorkSpec

AtomFn = Callable[[torch.Tensor], torch.Tensor]  # atom ids -> values

#: Reduction combiners usable by every executor.  ``sum`` is the paper's
#: tile-reduce; ``min``/``max`` are the graph advance's scatter-min and
#: scatter-or.  min/max are exact in floating point.
COMBINER_IDENTITY = IDENTITY


def _check_combiner(combiner: str, dtype: torch.dtype) -> float:
    """Validate and return the combiner's identity element."""
    if combiner not in COMBINER_IDENTITY:
        raise ValueError(f"unknown combiner: {combiner!r} "
                         f"(expected one of {sorted(COMBINER_IDENTITY)})")
    if combiner != "sum" and not dtype.is_floating_point:
        raise ValueError(f"combiner {combiner!r} needs a floating dtype "
                         f"(its identity is +/-inf), got {dtype}")
    return COMBINER_IDENTITY[combiner]


class ExecutionPath(str, enum.Enum):
    """Which executor consumes a Partition: ``PURE`` (PyTorch blocked
    executor), ``NATIVE`` (the chunk-walk kernel), or ``AUTO`` (native when
    the partition supports it)."""

    AUTO = "auto"
    PURE = "pure"
    NATIVE = "native"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


def supports_native_execution(part: Partition) -> bool:
    """True when a Partition carries the kernel's window sizes (the span
    hints :func:`~repro_torch.core.schedules.finalize_partition` records).
    Every partition is concrete in eager PyTorch, so a block map can always
    be inverted."""
    return part.atom_span is not None and part.tile_span is not None


def resolve_execution_path(request: ExecutionPath | str, *,
                           native_supported: bool) -> ExecutionPath:
    """Collapse an ``auto``/``pure``/``native`` request to a concrete path."""
    request = ExecutionPath(request)
    if request == ExecutionPath.NATIVE and not native_supported:
        raise ValueError(
            "native execution path requested but the partition/workload "
            "does not support it (needs span hints from finalize_partition "
            "and float32 values)")
    if request == ExecutionPath.AUTO:
        return (ExecutionPath.NATIVE if native_supported
                else ExecutionPath.PURE)
    return request


def choose_execution_path(part: Partition,
                          request: ExecutionPath | str = ExecutionPath.AUTO
                          ) -> ExecutionPath:
    """The dispatcher's routing rule for a given Partition."""
    return resolve_execution_path(
        request, native_supported=supports_native_execution(part))


def _atom_values(spec: WorkSpec, atom_fn: AtomFn,
                 dtype: torch.dtype) -> torch.Tensor:
    atoms = torch.arange(spec.num_atoms, dtype=torch.int32,
                         device=spec.device)
    return atom_fn(atoms).to(dtype)


def tile_reduce(spec: WorkSpec, atom_fn: AtomFn,
                dtype: torch.dtype = torch.float32, *,
                combiner: str = "sum",
                atom_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle: per-tile ``combiner``-reduce of ``atom_fn(atom)`` over atoms.

    ``atom_mask`` (bool ``[num_atoms]``) drops atoms (their value becomes
    the identity); tiles with no unmasked atom hold the identity.
    """
    identity = _check_combiner(combiner, dtype)
    values = _atom_values(spec, atom_fn, dtype)
    if atom_mask is not None:
        values = torch.where(atom_mask, values,
                             torch.tensor(identity, dtype=dtype,
                                          device=values.device))
    return segment_reduce(combiner, values, spec.atom_tile_ids(),
                          spec.num_tiles)


def _window_sizes(spec: WorkSpec, part: Partition) -> Tuple[int, int]:
    """(atom window, local tile window) of blocked execution: the span
    hints, or the boundaries' own spans for a hand-built partition."""
    if part.atom_span is not None:
        window = max(part.atom_span, 1)
    else:
        window = max(int((part.atom_starts[1:]
                          - part.atom_starts[:-1]).max()), 1)
    if part.tile_span is not None:
        local_tiles = max(part.tile_span, 1)
    else:
        local_tiles = max(int((part.tile_starts[1:]
                               - part.tile_starts[:-1]).max()) + 1, 1)
    return window, local_tiles


def fixup_partials(spec: WorkSpec, part: Partition, partials: torch.Tensor,
                   local_tiles: int, combiner: str = "sum") -> torch.Tensor:
    """Combine per-chunk partials at their global tile offsets (Merrill &
    Garland's segmented fixup); shared by both paths.  Untouched bins hold
    the identity and drop out."""
    gtid = part.tile_starts[:-1, None].long() + torch.arange(
        local_tiles, device=partials.device)[None, :]
    gtid = torch.where(gtid < spec.num_tiles, gtid, spec.num_tiles)
    return segment_reduce(combiner, partials.reshape(-1), gtid.reshape(-1),
                          spec.num_tiles + 1)[:-1]


def blocked_tile_reduce(spec: WorkSpec, part: Partition, atom_fn: AtomFn,
                        dtype: torch.dtype = torch.float32, *,
                        combiner: str = "sum",
                        atom_mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Blocked execution faithful to the partition, in PyTorch.

    Each block reduces the atoms of its window into ``local_tiles`` bins
    (one ``index_add_``/``scatter_reduce_`` over ``block * L + local``
    bins: ``O(atoms + blocks * L)`` memory, no one-hot); cross-block tiles
    are combined by :func:`fixup_partials`.  Masked atoms drop out.
    """
    identity = _check_combiner(combiner, dtype)
    if spec.num_atoms == 0:
        return torch.full((spec.num_tiles,), identity, dtype=dtype,
                          device=spec.device)
    window, L = _window_sizes(spec, part)
    values = _atom_values(spec, atom_fn, dtype)
    block, _, ok = window_slots(part.atom_starts, spec.num_atoms, window)
    local = spec.atom_tile_ids().long() - part.tile_starts.long()[block]
    ok &= (local >= 0) & (local < L)
    if atom_mask is not None:
        ok &= atom_mask
    bins = torch.where(ok, block * L + local, part.num_blocks * L)
    partials = segment_reduce(combiner, values, bins,
                              part.num_blocks * L + 1)[:-1]
    return fixup_partials(spec, part, partials.view(part.num_blocks, L), L,
                          combiner)


def _chunk_queue_view(part: Partition
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(block_chunks [P, Cmax], counts [P], P) — identity for static
    partitions (every block is its own one-chunk queue)."""
    if part.block_chunks is not None:
        counts = part.block_chunk_counts
        return part.block_chunks, counts, int(counts.shape[0])
    if part.block_map is not None:
        phys = part.num_physical_blocks or part.num_blocks
        chunks, counts = invert_block_map(part.block_map, phys)
        return chunks, counts, int(counts.shape[0])
    n = part.num_blocks
    device = part.atom_starts.device
    return (torch.arange(n, dtype=torch.int32, device=device)[:, None],
            torch.ones(n, dtype=torch.int32, device=device), n)


def _queue_operands(part: Partition):
    block_chunks, counts, _ = _chunk_queue_view(part)
    return (block_chunks.reshape(-1).to(torch.int32).contiguous(),
            counts.to(torch.int32).contiguous(),
            int(block_chunks.shape[1]))


def _padded(x: torch.Tensor, window: int, fill) -> torch.Tensor:
    return torch.cat([x, x.new_full((window,), fill)])


def _check_native(part: Partition, dtype: torch.dtype) -> None:
    if dtype != torch.float32:
        raise ValueError("native path accumulates in float32")
    if not supports_native_execution(part):
        raise ValueError("partition does not support the native path "
                         "(see supports_native_execution)")


def chunk_walk_operands(spec: WorkSpec, part: Partition,
                        values: torch.Tensor, *, combiner: str = "sum",
                        emit: str = "tiles",
                        atom_mask: torch.Tensor | None = None,
                        idx: torch.Tensor | None = None):
    """``(args, kwargs)`` of the chunk-walk kernel launch the native
    executors make for the atom values ``values`` (f32 ``[num_atoms]``):
    ``chunk_walk_reduce(*args, **kwargs)``.

    Values, tile ids and the mask are padded by one window (padding is
    never inside a chunk).  ``emit="compact"`` takes the compacted index
    list ``idx`` instead of a mask and walks even chunk splits of it; its
    padded slots point at the identity padding of ``values``.
    """
    identity = COMBINER_IDENTITY[combiner]
    chunks, counts, max_chunks = _queue_operands(part)
    if emit == "compact":
        num_chunks = int(part.atom_starts.shape[0]) - 1
        window = _compact_window(num_chunks, int(idx.shape[0]))
        starts = compact_chunk_starts(num_chunks, int(idx.shape[0]),
                                      idx.device)
        idx_padded = _padded(torch.clamp(idx, max=spec.num_atoms), window,
                             spec.num_atoms)
        args = (_padded(values, window, identity), None, starts,
                torch.zeros_like(starts), chunks, counts, None, idx_padded)
        return args, dict(window=window, local_tiles=1,
                          max_chunks=max_chunks, combiner=combiner,
                          emit=emit)
    window, local_tiles = _window_sizes(spec, part)
    tids = None
    if emit == "tiles":
        tids = _padded(spec.atom_tile_ids(), window, spec.num_tiles)
    mask = None
    if atom_mask is not None:
        mask = _padded(atom_mask.to(torch.int32), window, 0)
    args = (_padded(values, window, identity), tids,
            part.atom_starts.to(torch.int32),
            part.tile_starts.to(torch.int32), chunks, counts, mask)
    return args, dict(window=window, local_tiles=local_tiles,
                      max_chunks=max_chunks, combiner=combiner, emit=emit)


def native_chunk_tile_reduce(spec: WorkSpec, part: Partition, atom_fn: AtomFn,
                             dtype: torch.dtype = torch.float32, *,
                             combiner: str = "sum",
                             atom_mask: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Device-side execution: the chunk-walk kernel in ``tiles`` mode.

    Materializes the atom transform and the atom -> tile map once
    (:func:`chunk_walk_operands`), launches one CTA per physical block, and
    resolves cross-chunk tiles with the shared fixup.  ``atom_mask`` rides
    into the kernel as an int32 operand.
    """
    identity = _check_combiner(combiner, dtype)
    _check_native(part, dtype)
    if spec.num_atoms == 0:
        return torch.full((spec.num_tiles,), identity, dtype=dtype,
                          device=spec.device)
    from repro_torch.kernels.spmv_merge.kernel import chunk_walk_reduce

    args, kw = chunk_walk_operands(spec, part,
                                   _atom_values(spec, atom_fn, dtype),
                                   combiner=combiner, atom_mask=atom_mask)
    return fixup_partials(spec, part, chunk_walk_reduce(*args, **kw),
                          kw["local_tiles"], combiner)


# ---------------------------------------------------------------------------
# Scatter-reduce: balanced value windows combined by arbitrary per-atom
# output ids (the push-direction graph advance).
# ---------------------------------------------------------------------------

def blocked_value_windows(spec: WorkSpec, part: Partition, atom_fn: AtomFn,
                          dtype: torch.dtype = torch.float32, *,
                          combiner: str = "sum",
                          atom_mask: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Per-block masked value windows ``[num_blocks, window]`` (pure):
    slot ``(b, i)`` holds atom ``atom_starts[b] + i`` when it lies in block
    ``b`` and is unmasked, else the identity."""
    identity = _check_combiner(combiner, dtype)
    window, _ = _window_sizes(spec, part)
    out = torch.full((part.num_blocks, window), identity, dtype=dtype,
                     device=spec.device)
    if spec.num_atoms == 0:
        return out
    values = _atom_values(spec, atom_fn, dtype)
    block, offset, ok = window_slots(part.atom_starts, spec.num_atoms, window)
    if atom_mask is not None:
        ok &= atom_mask
    out.view(-1)[(block * window + offset)[ok]] = values[ok]
    return out


def native_chunk_value_windows(spec: WorkSpec, part: Partition,
                               atom_fn: AtomFn,
                               dtype: torch.dtype = torch.float32, *,
                               combiner: str = "sum",
                               atom_mask: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The chunk-walk kernel in ``atoms`` mode: the same windows as
    :func:`blocked_value_windows`, written by the queue-walking CTAs."""
    identity = _check_combiner(combiner, dtype)
    _check_native(part, dtype)
    if spec.num_atoms == 0:
        window, _ = _window_sizes(spec, part)
        return torch.full((part.num_blocks, window), identity, dtype=dtype,
                          device=spec.device)
    from repro_torch.kernels.spmv_merge.kernel import chunk_walk_reduce

    args, kw = chunk_walk_operands(spec, part,
                                   _atom_values(spec, atom_fn, dtype),
                                   combiner=combiner, emit="atoms",
                                   atom_mask=atom_mask)
    return chunk_walk_reduce(*args, **kw)


def scatter_value_windows(spec: WorkSpec, part: Partition,
                          windows: torch.Tensor, out_ids: torch.Tensor,
                          num_out: int, combiner: str = "sum"
                          ) -> torch.Tensor:
    """Combine value windows by per-atom output ids (``[num_out]``).

    Slot ``(b, i)`` holds atom ``atom_starts[b] + i``, whose output segment
    is ``out_ids`` of that atom.  Only slots inside their block carry
    non-identity values, so each atom is read from its own slot, in
    ascending atom order; outputs nothing reaches hold the identity.
    """
    window = int(windows.shape[1])
    block, offset, ok = window_slots(part.atom_starts, spec.num_atoms, window)
    values = windows.reshape(-1)[torch.where(ok, block * window + offset, 0)]
    gid = torch.where(ok, out_ids.long(), num_out)
    return segment_reduce(combiner, values, gid, num_out + 1)[:-1]


# -- gather-compacted active-atom windows (sparse-frontier push mode) -------

def compact_active_atoms(atom_mask: torch.Tensor, capacity: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact a bool atom mask into ``(idx [capacity], count)``: the
    active atom ids ascending, padded with ``num_atoms``; ``count`` is the
    exact active total (``idx`` is truncated when it exceeds capacity)."""
    num_atoms = int(atom_mask.shape[0])
    active = torch.nonzero(atom_mask).reshape(-1)[:capacity].to(torch.int32)
    idx = torch.full((capacity,), num_atoms, dtype=torch.int32,
                     device=atom_mask.device)
    idx[:active.shape[0]] = active
    return idx, atom_mask.sum(dtype=torch.int32)


def compact_chunk_starts(num_chunks: int, capacity: int,
                         device=None) -> torch.Tensor:
    """Even chunk boundaries over ``[0, capacity]`` compacted slots (the
    compacted atoms are equal-cost units, so the even split is balanced)."""
    per = -(-max(capacity, 1) // max(num_chunks, 1))
    return torch.clamp(torch.arange(num_chunks + 1, dtype=torch.int32,
                                    device=device) * per, max=capacity)


def _compact_window(num_chunks: int, capacity: int) -> int:
    return -(-max(capacity, 1) // max(num_chunks, 1))


def _compact_slot_view(spec: WorkSpec, idx: torch.Tensor, num_chunks: int,
                       window: int):
    """Slot -> atom addressing of the compacted windows, shared by their
    producers and :func:`scatter_compact_windows`: ``(valid, safe_a)`` over
    the ``[num_chunks, window]`` slot grid."""
    capacity = int(idx.shape[0])
    starts = compact_chunk_starts(num_chunks, capacity, idx.device).long()
    slot = starts[:-1, None] + torch.arange(window, device=idx.device)[None]
    a = idx.long()[torch.clamp(slot, 0, capacity - 1)]
    valid = (slot < starts[1:, None]) & (a < spec.num_atoms)
    return valid, torch.clamp(a, 0, max(spec.num_atoms - 1, 0))


def blocked_compact_value_windows(spec: WorkSpec, part: Partition,
                                  atom_fn: AtomFn, idx: torch.Tensor,
                                  dtype: torch.dtype = torch.float32, *,
                                  combiner: str = "sum") -> torch.Tensor:
    """Per-chunk value windows over a compacted active-atom list (pure):
    slot ``(c, i)`` holds atom ``idx[starts[c] + i]``; padded slots hold
    the identity."""
    identity = _check_combiner(combiner, dtype)
    num_chunks = int(part.atom_starts.shape[0]) - 1
    window = _compact_window(num_chunks, int(idx.shape[0]))
    valid, safe_a = _compact_slot_view(spec, idx, num_chunks, window)
    values = _atom_values(spec, atom_fn, dtype)[safe_a]
    return torch.where(valid, values,
                       torch.tensor(identity, dtype=dtype,
                                    device=values.device))


def native_compact_value_windows(spec: WorkSpec, part: Partition,
                                 atom_fn: AtomFn, idx: torch.Tensor,
                                 dtype: torch.dtype = torch.float32, *,
                                 combiner: str = "sum") -> torch.Tensor:
    """The chunk-walk kernel in ``compact`` mode: the partition's queues
    walk even chunk splits of the compacted index list, and each slot
    gathers its value through it."""
    _check_combiner(combiner, dtype)
    _check_native(part, dtype)
    from repro_torch.kernels.spmv_merge.kernel import chunk_walk_reduce

    args, kw = chunk_walk_operands(spec, part,
                                   _atom_values(spec, atom_fn, dtype),
                                   combiner=combiner, emit="compact", idx=idx)
    return chunk_walk_reduce(*args, **kw)


def scatter_compact_windows(spec: WorkSpec, windows: torch.Tensor,
                            idx: torch.Tensor, out_ids: torch.Tensor,
                            num_out: int, combiner: str = "sum"
                            ) -> torch.Tensor:
    """Combine compacted value windows by per-atom output ids, in
    ascending atom order (as the masked scatter does)."""
    num_chunks, window = int(windows.shape[0]), int(windows.shape[1])
    valid, safe_a = _compact_slot_view(spec, idx, num_chunks, window)
    gid = torch.where(valid, out_ids.long()[safe_a], num_out)
    return segment_reduce(combiner, windows.reshape(-1), gid.reshape(-1),
                          num_out + 1)[:-1]


def execute_scatter_reduce(spec: WorkSpec, part: Partition, atom_fn: AtomFn,
                           out_ids: torch.Tensor, num_out: int,
                           dtype: torch.dtype = torch.float32, *,
                           path: ExecutionPath | str = ExecutionPath.AUTO,
                           combiner: str = "sum",
                           atom_mask: torch.Tensor | None = None,
                           compact_capacity: int | None = None
                           ) -> torch.Tensor:
    """Balanced per-atom values over ``part`` (either path), combined by
    ``out_ids`` (int ``[num_atoms]``, segments in ``[0, num_out)``).

    ``compact_capacity`` (needs ``atom_mask``) streams only the active
    atoms, compacted into that many slots; when more atoms are active (one
    scalar read decides) the masked full windows run instead, so any
    capacity is correct.
    """
    identity = _check_combiner(combiner, dtype)
    if spec.num_atoms == 0:
        return torch.full((num_out,), identity, dtype=dtype,
                          device=spec.device)
    native_ok = supports_native_execution(part) and dtype == torch.float32
    native = resolve_execution_path(
        path, native_supported=native_ok) == ExecutionPath.NATIVE

    if compact_capacity is not None and atom_mask is not None:
        capacity = int(min(max(int(compact_capacity), 1), spec.num_atoms))
        idx, count = compact_active_atoms(atom_mask, capacity)
        if int(count) <= capacity:
            make = (native_compact_value_windows if native
                    else blocked_compact_value_windows)
            windows = make(spec, part, atom_fn, idx, dtype,
                           combiner=combiner)
            return scatter_compact_windows(spec, windows, idx, out_ids,
                                           num_out, combiner)
    make = native_chunk_value_windows if native else blocked_value_windows
    windows = make(spec, part, atom_fn, dtype, combiner=combiner,
                   atom_mask=atom_mask)
    return scatter_value_windows(spec, part, windows, out_ids, num_out,
                                 combiner)


def execute_tile_reduce(spec: WorkSpec, part: Partition, atom_fn: AtomFn,
                        dtype: torch.dtype = torch.float32, *,
                        path: ExecutionPath | str = ExecutionPath.AUTO,
                        combiner: str = "sum",
                        atom_mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """One API over both executors — the dispatcher the ops layers call.

    ``path="auto"`` takes the native kernel when the partition supports it
    and ``dtype`` is float32 (the kernel's accumulator), the pure executor
    otherwise; ``combiner``/``atom_mask`` apply identically on either path.
    """
    native_ok = supports_native_execution(part) and dtype == torch.float32
    resolved = resolve_execution_path(path, native_supported=native_ok)
    run = (native_chunk_tile_reduce if resolved == ExecutionPath.NATIVE
           else blocked_tile_reduce)
    return run(spec, part, atom_fn, dtype, combiner=combiner,
               atom_mask=atom_mask)
