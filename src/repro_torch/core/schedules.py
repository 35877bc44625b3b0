"""Load-balancing schedules (paper §3.2, §4.2, §5.2).

A *schedule* partitions the atoms/tiles of a
:class:`~repro_torch.core.work.WorkSpec` across ``num_blocks`` processors
(CUDA thread blocks).  Partitioners are vectorized ``searchsorted`` calls
run before the launch — the inspector — so the kernels read their block
coordinates instead of searching for them.  Every partitioner returns a
:class:`Partition` with the same contract, so execution is
schedule-agnostic.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.work import WorkSpec


class Schedule(str, enum.Enum):
    """Named schedules (paper §5.2)."""

    THREAD_MAPPED = "thread_mapped"    # tile-per-lane (paper Listing 2)
    GROUP_MAPPED = "group_mapped"      # tiles-per-group + prefix-sum binning
    WARP_MAPPED = "warp_mapped"        # group_mapped, group = 128 lanes
    BLOCK_MAPPED = "block_mapped"      # group_mapped, group = 8*128 lanes
    NONZERO_SPLIT = "nonzero_split"    # equal atoms per block + fixup
    MERGE_PATH = "merge_path"          # equal (atoms + tiles) per block
    CHUNKED = "chunked"                # oversplit into K*B chunks + queue
    ADAPTIVE = "adaptive"              # inspect-then-balance two-phase
    AUTO = "auto"                      # cost-model selection (autotune)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


#: Schedules that produce partitions directly (everything except AUTO).
CONCRETE_SCHEDULES = (
    Schedule.THREAD_MAPPED, Schedule.GROUP_MAPPED, Schedule.WARP_MAPPED,
    Schedule.BLOCK_MAPPED, Schedule.NONZERO_SPLIT, Schedule.MERGE_PATH,
    Schedule.CHUNKED, Schedule.ADAPTIVE,
)


@dataclasses.dataclass(frozen=True)
class Partition:
    """Assignment of atom/tile subsequences to ``num_blocks`` entries.

    Entry ``b`` owns atoms ``[atom_starts[b], atom_starts[b+1])`` and
    touches tiles ``[tile_starts[b], tile_starts[b+1]]``; the last tile may
    be shared with entry ``b+1`` and is combined by the fixup.

    Dynamic schedules oversplit into chunks that ``num_physical_blocks``
    blocks drain as queues: ``block_map[c]`` is chunk ``c``'s block, and
    ``block_chunks[p, :block_chunk_counts[p]]`` is block ``p``'s queue in
    pop order (zero-padded).  ``atom_span``/``tile_span`` are the largest
    atom count and (inclusive) tile count of any entry: the kernels' window
    sizes.
    """

    schedule: Schedule
    num_blocks: int
    items_per_block: int
    atom_starts: torch.Tensor                     # int32 [num_blocks + 1]
    tile_starts: torch.Tensor                     # int32 [num_blocks + 1]
    tile_aligned: bool
    block_map: Optional[torch.Tensor] = None      # int32 [num_blocks]
    num_physical_blocks: Optional[int] = None
    atom_span: Optional[int] = None
    tile_span: Optional[int] = None
    block_chunks: Optional[torch.Tensor] = None        # int32 [P, max_chunks]
    block_chunk_counts: Optional[torch.Tensor] = None  # int32 [P]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def invert_block_map(block_map: torch.Tensor, num_physical_blocks: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert a chunk -> block map into per-block queues (padded CSR).

    Returns ``(block_chunks [P, max_chunks], block_chunk_counts [P])`` on
    ``block_map``'s device: row ``p`` lists block ``p``'s chunks in chunk
    order (its pop order), padded with 0.
    """
    bm = block_map.cpu().numpy().astype(np.int64)
    num_physical_blocks = max(int(num_physical_blocks), 1)
    counts = np.bincount(bm, minlength=num_physical_blocks)
    max_chunks = max(int(counts.max()) if counts.size else 0, 1)
    chunks = np.zeros((num_physical_blocks, max_chunks), np.int32)
    # a stable sort groups chunks by block and keeps each queue's order
    order = np.argsort(bm, kind="stable")
    slot = np.arange(bm.size) - np.concatenate(
        [[0], np.cumsum(counts)])[bm[order]]
    chunks[bm[order], slot] = order
    dev = block_map.device
    return (torch.from_numpy(chunks).to(dev),
            torch.from_numpy(counts.astype(np.int32)).to(dev))


def finalize_partition(part: Partition) -> Partition:
    """Record the span hints and the inverted queue view, once."""
    if part.atom_span is not None or part.num_blocks < 1:
        return part
    atom_span = int((part.atom_starts[1:] - part.atom_starts[:-1]).max())
    tile_span = int((part.tile_starts[1:] - part.tile_starts[:-1]).max()) + 1
    block_chunks, block_chunk_counts = (part.block_chunks,
                                        part.block_chunk_counts)
    if part.block_map is not None and block_chunks is None:
        block_chunks, block_chunk_counts = invert_block_map(
            part.block_map, part.num_physical_blocks or part.num_blocks)
    return dataclasses.replace(part, atom_span=max(atom_span, 1),
                               tile_span=max(tile_span, 1),
                               block_chunks=block_chunks,
                               block_chunk_counts=block_chunk_counts)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def tile_of_atoms(spec: WorkSpec, atoms: torch.Tensor) -> torch.Tensor:
    """``searchsorted(tile_offsets, atoms, right) - 1`` clipped to
    ``[0, num_tiles]``."""
    t = torch.searchsorted(spec.tile_offsets, atoms.to(torch.int32),
                           right=True, out_int32=True) - 1
    return torch.clamp(t, 0, spec.num_tiles)


# ---------------------------------------------------------------------------
# Tile-aligned schedules: thread-, warp-, block- and group-mapped.
# ---------------------------------------------------------------------------

def tile_mapped_partition(spec: WorkSpec, num_blocks: int,
                          schedule: Schedule = Schedule.THREAD_MAPPED
                          ) -> Partition:
    """An equal, contiguous span of *tiles* per block (imbalanced in atoms
    when tile sizes vary)."""
    tiles_per_block = _ceil_div(spec.num_tiles, num_blocks)
    tile_starts = torch.clamp(
        _iota(num_blocks + 1, spec.device) * tiles_per_block,
        max=spec.num_tiles)
    atom_starts = spec.tile_offsets[tile_starts.long()]
    return finalize_partition(Partition(
        schedule=schedule, num_blocks=num_blocks,
        items_per_block=tiles_per_block,
        atom_starts=atom_starts.to(torch.int32),
        tile_starts=tile_starts, tile_aligned=True))


def group_mapped_partition(spec: WorkSpec, num_blocks: int,
                           group_tiles: Optional[int] = None) -> Partition:
    """Paper §5.2.3 — tile-aligned groups; within a group, atoms are
    processed in parallel after a prefix sum of atoms-per-tile."""
    if group_tiles is not None:
        num_blocks = _ceil_div(spec.num_tiles, group_tiles)
    return tile_mapped_partition(spec, num_blocks, Schedule.GROUP_MAPPED)


# ---------------------------------------------------------------------------
# Atom-aligned schedules: nonzero splitting and merge-path.
# ---------------------------------------------------------------------------

def nonzero_split_partition(spec: WorkSpec, num_blocks: int) -> Partition:
    """Equal *atoms* per block; blocks may start or end mid-tile."""
    atoms_per_block = _ceil_div(max(spec.num_atoms, 1), num_blocks)
    atom_starts = torch.clamp(
        _iota(num_blocks + 1, spec.device) * atoms_per_block,
        max=spec.num_atoms)
    return finalize_partition(Partition(
        schedule=Schedule.NONZERO_SPLIT, num_blocks=num_blocks,
        items_per_block=atoms_per_block,
        atom_starts=atom_starts, tile_starts=tile_of_atoms(spec, atom_starts),
        tile_aligned=False))


def merge_path_partition(spec: WorkSpec, num_blocks: int) -> Partition:
    """Split ``num_atoms + num_tiles`` work items exactly evenly.

    Diagonal ``d``'s split is the largest ``t`` with
    ``tile_offsets[t] + t <= d`` (``f(t) = tile_offsets[t] + t`` is strictly
    increasing, so one ``searchsorted`` finds every block's start), and the
    atom coordinate is ``d - t``.
    """
    total = spec.total_work()
    items_per_block = _ceil_div(max(total, 1), num_blocks)
    diagonals = torch.clamp(
        _iota(num_blocks + 1, spec.device) * items_per_block, max=total)
    path = spec.tile_offsets + _iota(spec.num_tiles + 1, spec.device)
    tile_starts = torch.searchsorted(path, diagonals, right=True,
                                     out_int32=True) - 1
    tile_starts = torch.clamp(tile_starts, 0, spec.num_tiles)
    return finalize_partition(Partition(
        schedule=Schedule.MERGE_PATH, num_blocks=num_blocks,
        items_per_block=items_per_block,
        atom_starts=(diagonals - tile_starts).to(torch.int32),
        tile_starts=tile_starts, tile_aligned=False))


# ---------------------------------------------------------------------------
# Registry / dispatch.
# ---------------------------------------------------------------------------

# Concrete partition builds through make_partition, for regression tests:
# ops that batch many computations over one workload build once.
_PARTITION_BUILD_COUNT = 0


def partition_build_count() -> int:
    """Process-wide count of concrete partition builds via make_partition
    (including the ones the cost models perform while scoring)."""
    return _PARTITION_BUILD_COUNT


def make_partition(spec: WorkSpec, schedule: Schedule | str,
                   num_blocks: int, *, chunk_policy: str = "lpt"
                   ) -> Partition:
    global _PARTITION_BUILD_COUNT
    schedule = Schedule(schedule)
    if schedule != Schedule.AUTO:
        _PARTITION_BUILD_COUNT += 1
    if schedule == Schedule.THREAD_MAPPED:
        return tile_mapped_partition(spec, num_blocks, schedule)
    if schedule in (Schedule.GROUP_MAPPED, Schedule.WARP_MAPPED,
                    Schedule.BLOCK_MAPPED):
        part = group_mapped_partition(spec, num_blocks)
        return dataclasses.replace(part, schedule=schedule)
    if schedule == Schedule.NONZERO_SPLIT:
        return nonzero_split_partition(spec, num_blocks)
    if schedule == Schedule.MERGE_PATH:
        return merge_path_partition(spec, num_blocks)
    if schedule == Schedule.CHUNKED:
        from repro_torch.core.dynamic import chunked_partition
        return chunked_partition(spec, num_blocks, policy=chunk_policy)
    if schedule == Schedule.ADAPTIVE:
        from repro_torch.core.dynamic import adaptive_partition
        return adaptive_partition(spec, num_blocks)
    from repro_torch.core.autotune import select_schedule
    return make_partition(spec, select_schedule(spec, num_blocks), num_blocks)
