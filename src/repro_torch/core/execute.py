"""Work execution (paper §3.3 / §4.3) — schedule-agnostic consumers.

The user supplies an *atom transform* (atom ids -> values, e.g.
``lambda nz: vals[nz] * x[col[nz]]`` for SpMV) and a combiner; the
executors consume a :class:`Partition`.  The tile-reduce executors also
take an atom transform that gives ``[atoms, B]`` values (B columns per
atom: the reference's ``vmap`` over columns, written out as a batch
dimension) and return ``[num_tiles, B]``, column ``j`` equal to the call
on column ``j`` alone (bitwise on the CPU, and on the card wherever the
combine is exact); the scatter executors take ``[atoms]`` values only.

* :func:`tile_reduce` — the oracle: one segmented reduce over all atoms.
* :func:`blocked_tile_reduce` — the *pure* path: every block reduces
  exactly its partition slice into local tile bins, and the shared fixup
  combines tiles cut by block boundaries.
* :func:`native_chunk_tile_reduce` — the *native* path: the chunk-walk
  CUDA kernel (``repro_torch.kernels.spmv_merge.kernel``) over the chunks
  the physical blocks' queues pop.

:func:`execute_tile_reduce` routes a Partition to one of the two by
:class:`ExecutionPath`; :func:`execute_scatter_reduce` is the push
advance's counterpart (value windows combined by per-atom output ids, with
an optional gather-compacted window mode).  Both paths share the fixup and
the scatter, so they agree bitwise wherever the combine is exact.
:func:`execute_sharded_tile_reduce` and :func:`execute_sharded_scatter_reduce`
are the two directions on one rank of a sharded advance
(:mod:`repro_torch.sparse.shard`).
"""
from __future__ import annotations

import enum
from typing import Callable, Tuple

import torch
import torch.distributed as dist

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


def _atom_values(spec: WorkSpec, atom_fn: AtomFn, dtype: torch.dtype, *,
                 batched: bool = False) -> torch.Tensor:
    """``atom_fn`` over every atom: ``[num_atoms]``, or with ``batched``
    also ``[num_atoms, B]``."""
    atoms = torch.arange(spec.num_atoms, dtype=torch.int32,
                         device=spec.device)
    values = atom_fn(atoms).to(dtype)
    if values.dim() != 1 and not (batched and values.dim() == 2):
        shape = "[atoms] or [atoms, B]" if batched else "[atoms]"
        raise ValueError(f"the atom transform must give {shape} values, "
                         f"got shape {tuple(values.shape)}")
    return values


def _identity_tiles(spec: WorkSpec, values: torch.Tensor,
                    identity: float) -> torch.Tensor:
    """The result of a reduce that no atom reaches: ``[num_tiles]`` (or
    ``[num_tiles, B]``) of the identity."""
    return torch.full((spec.num_tiles,) + tuple(values.shape[1:]), identity,
                      dtype=values.dtype, device=spec.device)


def tile_reduce(spec: WorkSpec, atom_fn: AtomFn,
                dtype: torch.dtype = torch.float32, *,
                combiner: str = "sum",
                atom_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle: per-tile ``combiner``-reduce of ``atom_fn(atom)`` over atoms.

    ``atom_mask`` (bool ``[num_atoms]``) drops atoms (their value becomes
    the identity); tiles with no unmasked atom hold the identity.
    """
    identity = _check_combiner(combiner, dtype)
    values = _atom_values(spec, atom_fn, dtype, batched=True)
    if atom_mask is not None:
        if values.dim() == 2:
            atom_mask = atom_mask[:, None]
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
    """Combine per-chunk partials (``[C, L]``, or ``[C, L, B]`` for B
    columns) at their global tile offsets (Merrill & Garland's segmented
    fixup); shared by both paths, all columns in one segmented reduce.
    Untouched bins hold the identity and drop out.

    A float ``sum`` on the card goes to ``segment_sum_fixup``, which walks
    the order a stable sort of the bins' tile ids would give straight from
    ``part.tile_starts`` (non-decreasing in every partition the schedules
    build), with the bits of the sorted route and no sort; float16 and
    bfloat16 partials are summed in float32 and rounded once.  Everything
    else is one :func:`~repro_torch.core.segops.segment_reduce`."""
    if (combiner == "sum" and partials.is_floating_point()
            and partials.device.type == "cuda"):
        from repro_torch.kernels.spmv_merge.kernel import segment_sum_fixup
        wide = (partials if partials.dtype in (torch.float32, torch.float64)
                else partials.float())
        return segment_sum_fixup(
            wide.contiguous(), part.tile_starts.to(torch.int32).contiguous(),
            spec.num_tiles).to(partials.dtype)
    gtid = part.tile_starts[:-1, None].long() + torch.arange(
        local_tiles, device=partials.device)[None, :]
    gtid = torch.where(gtid < spec.num_tiles, gtid, spec.num_tiles)
    flat = partials.reshape(gtid.numel(), *partials.shape[2:])
    return segment_reduce(combiner, flat, gtid.reshape(-1),
                          spec.num_tiles + 1)[:-1]


def blocked_tile_reduce(spec: WorkSpec, part: Partition, atom_fn: AtomFn,
                        dtype: torch.dtype = torch.float32, *,
                        combiner: str = "sum",
                        atom_mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Blocked execution faithful to the partition, in PyTorch.

    Each block reduces the atoms of its window into ``local_tiles`` bins
    (one ``segment_reduce`` over ``block * L + local`` bins: ``O(atoms +
    blocks * L)`` memory, no one-hot); cross-block tiles
    are combined by :func:`fixup_partials`.  Masked atoms drop out.
    """
    identity = _check_combiner(combiner, dtype)
    values = _atom_values(spec, atom_fn, dtype, batched=True)
    if spec.num_atoms == 0:
        return _identity_tiles(spec, values, identity)
    bins, L = blocked_bins(spec, part, atom_mask)
    partials = segment_reduce(combiner, values, bins,
                              part.num_blocks * L + 1)[:-1]
    return fixup_partials(spec, part,
                          partials.view(part.num_blocks, L,
                                        *values.shape[1:]), L, combiner)


def blocked_bins(spec: WorkSpec, part: Partition,
                 atom_mask: torch.Tensor | None = None
                 ) -> Tuple[torch.Tensor, int]:
    """``(bins, L)`` of :func:`blocked_tile_reduce`: atom ``a``'s bin
    ``block * L + local`` among ``num_blocks * L`` local tile bins, or the
    extra bin ``num_blocks * L`` where it is masked or outside its block's
    windows."""
    window, L = _window_sizes(spec, part)
    block, _, ok = window_slots(part.atom_starts, spec.num_atoms, window)
    local = spec.atom_tile_ids().long() - part.tile_starts.long()[block]
    ok &= (local >= 0) & (local < L)
    if atom_mask is not None:
        ok &= atom_mask
    return torch.where(ok, block * L + local, part.num_blocks * L), L


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
    """``x`` (``[n]`` or ``[n, B]``) followed by ``window`` rows of
    ``fill``."""
    return torch.cat([x, x.new_full((window,) + tuple(x.shape[1:]), fill)])


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
    executors make for the atom values ``values`` (f32 ``[num_atoms]``, or
    ``[num_atoms, B]`` in tiles mode): ``chunk_walk_reduce(*args,
    **kwargs)``.

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
    (:func:`chunk_walk_operands`), launches the kernel once (all B columns
    of ``[atoms, B]`` values in the same launch), and resolves cross-chunk
    tiles with the shared fixup.  ``atom_mask`` rides into the kernel as an
    int32 operand.
    """
    identity = _check_combiner(combiner, dtype)
    _check_native(part, dtype)
    values = _atom_values(spec, atom_fn, dtype, batched=True)
    if spec.num_atoms == 0:
        return _identity_tiles(spec, values, identity)
    from repro_torch.kernels.spmv_merge.kernel import chunk_walk_reduce

    args, kw = chunk_walk_operands(spec, part, values, combiner=combiner,
                                   atom_mask=atom_mask)
    return fixup_partials(spec, part, chunk_walk_reduce(*args, **kw),
                          kw["local_tiles"], combiner)


class LaneLayout:
    """Up to ``lanes`` tile reduces in one launch, lane ``j`` with the bits
    of the one-column call on its atom values whatever the combine.

    The native path lays the lanes end to end through the one-column
    chunk walk: lane ``j``'s atoms start at ``j * stride`` (``stride`` =
    the atom count rounded up to 4, so the kernel's 4-atom groups keep
    their alignment), its tile ids and tile starts are shifted by ``j *
    (num_tiles + 1)``, and its chunks are numbered ``j * (C + 1) + c``:
    each lane is a copy of the partition, whose ``C + 1``-th chunk covers
    the gap before the next lane and is in no queue (its row is left
    unwritten).  Every chunk of lane ``j`` is walked as the one-lane launch
    walks it, so its partials have the same bits (the B-column kernel adds
    real values in an order that depends on B).  The tile ids, starts and
    queues depend only on the partition and are built here once, for
    ``lanes`` lanes; ``B <= lanes`` lanes use their prefix.  The pure path
    is the blocked executor over ``[atoms, B]`` values (column ``j``
    bitwise the one-column call).
    """

    def __init__(self, spec: WorkSpec, part: Partition, lanes: int, *,
                 path: ExecutionPath | str = ExecutionPath.AUTO):
        self.spec, self.part, self.lanes = spec, part, int(lanes)
        self.path = resolve_execution_path(
            path, native_supported=supports_native_execution(part))
        A = spec.num_atoms
        self.native = self.path == ExecutionPath.NATIVE and A > 0
        self.stride = -(-A // 4) * 4 if self.native else A
        if not self.native:
            return
        self.window, self.local_tiles = _window_sizes(spec, part)
        B, stride, tiles = self.lanes, self.stride, spec.num_tiles + 1
        device = spec.device
        lane = torch.arange(B, dtype=torch.int32, device=device)[:, None]
        self._tids = torch.full((B * stride + self.window,), B * tiles,
                                dtype=torch.int32, device=device)
        lane_tids = self._tids[:B * stride].view(B, stride)
        lane_tids[:] = lane * tiles + spec.num_tiles
        lane_tids[:, :A] = spec.atom_tile_ids()[None, :] + lane * tiles
        self.num_chunks = int(part.atom_starts.shape[0]) - 1
        # lane j's C + 1 starts end where lane j + 1's begin, so B lanes'
        # starts are the first B * (C + 1) + 1 entries
        last = torch.tensor([B * stride], dtype=torch.int32, device=device)
        self._atom_starts = torch.cat([(part.atom_starts.to(
            torch.int32)[None, :] + lane * stride).reshape(-1), last])
        last = torch.tensor([B * tiles], dtype=torch.int32, device=device)
        self._tile_starts = torch.cat([(part.tile_starts.to(
            torch.int32)[None, :] + lane * tiles).reshape(-1), last])
        chunks, counts, self.max_chunks = _queue_operands(part)
        self._chunks = (chunks[None, :]
                        + lane * (self.num_chunks + 1)).reshape(B, -1)
        self._counts = counts.repeat(B).view(B, -1)

    def operands(self, B: int, fill: Callable[[torch.Tensor], None], *,
                 combiner: str = "sum"):
        """``(args, kwargs)`` of the launch over ``B <= lanes`` lanes:
        ``chunk_walk_reduce(*args, **kwargs)`` gives partials ``[B * (C +
        1), L]``.  ``fill(out)`` writes lane ``j``'s f32 atom values into
        ``out[j]`` (``[B, num_atoms]``, each row contiguous: a view of the
        launch's value buffer, so the values are written once)."""
        if not 0 < B <= self.lanes:
            raise ValueError(f"{B} lanes on a layout of {self.lanes}")
        A, stride, window = self.spec.num_atoms, self.stride, self.window
        identity = COMBINER_IDENTITY[combiner]
        vals = torch.empty(B * stride + window, dtype=torch.float32,
                           device=self.spec.device)
        rows = vals[:B * stride].view(B, stride)
        rows[:, A:] = identity
        vals[B * stride:] = identity
        fill(rows[:, :A])
        n = B * (self.num_chunks + 1) + 1
        args = (vals, self._tids[:B * stride + window],
                self._atom_starts[:n], self._tile_starts[:n],
                self._chunks[:B].reshape(-1), self._counts[:B].reshape(-1),
                None)
        return args, dict(window=window, local_tiles=self.local_tiles,
                          max_chunks=self.max_chunks, combiner=combiner,
                          emit="tiles")

    def reduce(self, B: int, fill: Callable[[torch.Tensor], None], *,
               combiner: str = "sum") -> torch.Tensor:
        """The B lanes' tile reduces, ``[num_tiles, B]``: one chunk-walk
        launch and one fixup on the native path (``fill`` as in
        :meth:`operands`)."""
        _check_combiner(combiner, torch.float32)
        spec, part = self.spec, self.part
        if not self.native or B == 0:
            values = torch.empty((B, spec.num_atoms), dtype=torch.float32,
                                 device=spec.device)
            fill(values)
            return execute_tile_reduce(spec, part, lambda e: values.t(),
                                       torch.float32, path=self.path,
                                       combiner=combiner)
        from repro_torch.kernels.spmv_merge.kernel import chunk_walk_reduce

        args, kw = self.operands(B, fill, combiner=combiner)
        L, C = self.local_tiles, self.num_chunks
        partials = chunk_walk_reduce(*args, **kw).view(B, C + 1, L)
        partials = partials[:, :C].permute(1, 2, 0).contiguous()
        return fixup_partials(spec, part, partials, L, combiner)


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
    An ``atom_fn`` that gives ``[atoms, B]`` values gives ``[num_tiles, B]``
    (one kernel launch and one fixup for all columns).
    """
    native_ok = supports_native_execution(part) and dtype == torch.float32
    resolved = resolve_execution_path(path, native_supported=native_ok)
    run = (native_chunk_tile_reduce if resolved == ExecutionPath.NATIVE
           else blocked_tile_reduce)
    return run(spec, part, atom_fn, dtype, combiner=combiner,
               atom_mask=atom_mask)


# ---------------------------------------------------------------------------
# Shard-local dispatch (the same executors one level up, one rank a shard)
# ---------------------------------------------------------------------------

#: The collective matching each combiner: the shard-level continuation of a
#: scatter reduce (the reference's ``psum`` / ``pmin`` / ``pmax``).
COMBINER_COLLECTIVE = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                       "max": dist.ReduceOp.MAX}

#: The element-wise combine of gathered partials (``[S, n]`` -> ``[n]``)
#: the min/max collectives are carried out with: gloo's MIN/MAX (and
#: NCCL's) drop a NaN that is not on the first rank, where the reference's
#: ``pmin``/``pmax`` and ``torch.amin``/``amax`` keep it.
_GATHERED_COMBINE = {"min": torch.amin, "max": torch.amax}


def execute_sharded_tile_reduce(spec: WorkSpec, part: Partition,
                                atom_fn: AtomFn,
                                dtype: torch.dtype = torch.float32, *,
                                mesh=None,
                                path: ExecutionPath | str = ExecutionPath.AUTO,
                                combiner: str = "sum",
                                atom_mask: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """:func:`execute_tile_reduce` on one rank of a sharded advance.

    The pull direction's shard contract: each shard's local spec owns all
    atoms (in-edges) of its own tiles (destinations), so the local reduce
    is already the final per-tile answer: no collective, and the bits come
    from the same executor call one device makes.  ``mesh`` (a
    :class:`~repro_torch.launch.mesh.GraphMesh`) is accepted so both
    directions share a call shape, and unused.
    """
    del mesh
    return execute_tile_reduce(spec, part, atom_fn, dtype, path=path,
                               combiner=combiner, atom_mask=atom_mask)


def execute_sharded_scatter_reduce(spec: WorkSpec, part: Partition,
                                   atom_fn: AtomFn, out_ids: torch.Tensor,
                                   num_out: int,
                                   dtype: torch.dtype = torch.float32, *,
                                   mesh,
                                   path: ExecutionPath | str =
                                   ExecutionPath.AUTO,
                                   combiner: str = "sum",
                                   atom_mask: torch.Tensor | None = None,
                                   compact_capacity: int | None = None
                                   ) -> torch.Tensor:
    """:func:`execute_scatter_reduce` on one rank of a sharded advance.

    The push direction's shard contract: each shard streams only its own
    out-edges, whose destinations land anywhere, so every rank makes a
    full ``[num_out]`` partial (the identity where it touches nothing) and
    the partials are combined over ``mesh``: ``sum`` with
    ``all_reduce(SUM)`` (:data:`COMBINER_COLLECTIVE`); ``min``/``max`` by
    gathering the ``[S, num_out]`` partials and reducing them on each rank
    with ``torch.amin``/``amax``, exact and NaN-keeping like the
    reference's ``pmin``/``pmax``.  Every rank returns the combined
    ``[num_out]``.
    """
    partial = execute_scatter_reduce(spec, part, atom_fn, out_ids, num_out,
                                     dtype, path=path, combiner=combiner,
                                     atom_mask=atom_mask,
                                     compact_capacity=compact_capacity)
    if mesh.num_shards == 1:
        return partial
    if combiner == "sum":
        return mesh.all_reduce(partial, COMBINER_COLLECTIVE["sum"])
    gathered = mesh.all_gather(partial[None])
    return _GATHERED_COMBINE[combiner](gathered, dim=0)
