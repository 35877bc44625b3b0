"""Dynamic load-balancing schedules (Atos-style work queues, arXiv
2112.00132).

Instead of one final block assignment, *oversplit* the work into more
chunks than blocks and let each block drain a queue.  The queue discipline
is made static per input by an inspector that runs before the launch: it
produces a chunk-level :class:`~repro_torch.core.schedules.Partition` and
records the chunk -> block assignment in ``Partition.block_map``.

* :func:`chunked_partition` — ``chunk_factor * num_blocks`` chunks of
  roughly equal atom count, snapped to tile boundaries when one is close,
  assigned to blocks round-robin or by longest-processing-time (LPT).
* :func:`adaptive_partition` — keep the cheap tile-mapped partition when
  it is balanced; otherwise cut equal-atom spans that stay tile-aligned
  except inside tiles too heavy for one block.  Memoised per workload.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core.balance import CHUNK_OVERHEAD, LANES
from repro_torch.core.schedules import (Partition, Schedule,
                                        finalize_partition, tile_of_atoms,
                                        tile_mapped_partition)
from repro_torch.core.work import WorkSpec

#: Default oversplit factor: chunks per physical block (Atos uses 4-16).
DEFAULT_CHUNK_FACTOR = 4

#: Default adaptive trigger: re-balance when max block load > 1.5x mean.
DEFAULT_IMBALANCE_THRESHOLD = 1.5


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Shared inspector: equal-atom cuts with tile-boundary snapping.
# ---------------------------------------------------------------------------

def _snapped_atom_cuts(spec: WorkSpec, num_cuts: int,
                       quantum: int) -> torch.Tensor:
    """``num_cuts + 1`` non-decreasing atom boundaries covering all atoms.

    Cut ``c`` targets atom ``c * quantum`` and snaps to the nearest tile
    boundary within ``quantum // 2`` atoms; cuts inside heavier tiles stay
    mid-tile.  Every span is bounded by ``2 * quantum``.
    """
    cuts = torch.clamp(torch.arange(num_cuts + 1, dtype=torch.int32,
                                    device=spec.device) * quantum,
                       max=spec.num_atoms)
    if spec.num_tiles == 0 or spec.num_atoms == 0:
        return cuts
    tol = max(quantum // 2, 0)
    owner = torch.clamp(
        torch.searchsorted(spec.tile_offsets, cuts, right=True,
                           out_int32=True) - 1, 0, spec.num_tiles - 1).long()
    lo = spec.tile_offsets[owner]          # tile start at/before the cut
    hi = spec.tile_offsets[owner + 1]      # tile end at/after the cut
    d_lo = cuts - lo
    d_hi = hi - cuts
    snapped = torch.where((d_lo <= d_hi) & (d_lo <= tol), lo,
                          torch.where(d_hi <= tol, hi, cuts))
    snapped[0] = 0                         # endpoints are never snapped
    snapped[-1] = spec.num_atoms
    return snapped.to(torch.int32)


def _partition_from_atom_cuts(spec: WorkSpec, cuts: torch.Tensor,
                              schedule: Schedule,
                              block_map: Optional[torch.Tensor] = None,
                              num_physical_blocks: Optional[int] = None
                              ) -> Partition:
    """Assemble a Partition from atom boundaries (possibly mid-tile)."""
    tile_starts = tile_of_atoms(spec, cuts)
    spans = cuts[1:] - cuts[:-1]
    items = max(int(spans.max()), 1) if spans.shape[0] else 1
    aligned = bool(torch.isin(cuts, spec.tile_offsets).all())
    return finalize_partition(Partition(
        schedule=schedule, num_blocks=int(spans.shape[0]),
        items_per_block=items, atom_starts=cuts.to(torch.int32),
        tile_starts=tile_starts, tile_aligned=aligned,
        block_map=block_map, num_physical_blocks=num_physical_blocks))


# ---------------------------------------------------------------------------
# Chunked work queue (Atos-style).
# ---------------------------------------------------------------------------

def assign_chunks(chunk_cost: torch.Tensor, num_blocks: int,
                  policy: str = "lpt") -> torch.Tensor:
    """Map each chunk to a physical block.

    ``round_robin``: chunk ``c`` -> block ``c % num_blocks``.  ``lpt``: in
    descending cost order, each chunk goes to the least-loaded block so far
    (the greedy makespan bound of 4/3 OPT).  Runs on the host.
    """
    n = int(chunk_cost.shape[0])
    if policy == "round_robin":
        return torch.arange(n, dtype=torch.int32,
                            device=chunk_cost.device) % num_blocks
    if policy != "lpt":
        raise ValueError(f"unknown chunk policy: {policy}")
    cost = chunk_cost.cpu().numpy().astype(np.int64)
    order = np.argsort(-cost, kind="stable")
    load = np.zeros(num_blocks, np.int64)
    out = np.zeros(n, np.int32)
    for c in order:
        b = int(np.argmin(load))
        out[c] = b
        load[b] += int(cost[c])
    return torch.from_numpy(out).to(chunk_cost.device)


def chunked_partition(spec: WorkSpec, num_blocks: int, *,
                      chunk_factor: int = DEFAULT_CHUNK_FACTOR,
                      policy: str = "lpt") -> Partition:
    """Oversplit into ``chunk_factor * num_blocks`` tile-snapped chunks and
    assign them to ``num_blocks`` physical blocks (``block_map``)."""
    num_blocks = max(int(num_blocks), 1)
    num_chunks = max(chunk_factor, 1) * num_blocks
    # never oversplit beyond one atom per chunk
    num_chunks = min(num_chunks, max(spec.num_atoms, 1))
    quantum = _ceil_div(max(spec.num_atoms, 1), num_chunks)
    cuts = _snapped_atom_cuts(spec, num_chunks, quantum)
    # LPT balances what a block pays per chunk: lockstep steps plus the
    # constant queue-pop overhead (raw atoms would pile empty chunks up)
    spans = cuts[1:] - cuts[:-1]
    chunk_cost = -(-spans // LANES) + CHUNK_OVERHEAD
    block_map = assign_chunks(chunk_cost, num_blocks, policy)
    return _partition_from_atom_cuts(spec, cuts, Schedule.CHUNKED,
                                     block_map=block_map,
                                     num_physical_blocks=num_blocks)


# ---------------------------------------------------------------------------
# Adaptive inspect-then-balance.
# ---------------------------------------------------------------------------

# A serving loop calls the inspector per request; the memo keys on an exact
# content fingerprint of the offsets (the cut points depend on them).
_ADAPTIVE_CACHE: "OrderedDict[tuple, Partition]" = OrderedDict()
_ADAPTIVE_CACHE_CAPACITY = 256
_ADAPTIVE_CACHE_LOCK = threading.Lock()
_INSPECTION_COUNT = 0


def adaptive_inspection_count() -> int:
    """How many times the adaptive inspector actually ran (memo misses)."""
    return _INSPECTION_COUNT


def clear_adaptive_cache() -> None:
    with _ADAPTIVE_CACHE_LOCK:
        _ADAPTIVE_CACHE.clear()


def _workload_fingerprint(spec: WorkSpec) -> str:
    """Exact content hash of a WorkSpec, with its device."""
    digest = hashlib.sha1(np.ascontiguousarray(
        spec.tile_offsets.cpu().numpy().astype(np.int64)).tobytes()
    ).hexdigest()
    return f"{spec.device}:{spec.num_tiles}:{spec.num_atoms}:{digest}"


def adaptive_partition(spec: WorkSpec, num_blocks: int, *,
                       imbalance_threshold: float =
                       DEFAULT_IMBALANCE_THRESHOLD,
                       cache: bool = True) -> Partition:
    """Keep the tile-mapped partition when balanced; re-partition
    (splitting only over-threshold tiles) when not.  Memoised per
    (workload, num_blocks, threshold); ``cache=False`` re-inspects."""
    global _INSPECTION_COUNT
    num_blocks = max(int(num_blocks), 1)
    key = None
    if cache:
        key = (_workload_fingerprint(spec), num_blocks,
               float(imbalance_threshold))
        with _ADAPTIVE_CACHE_LOCK:
            hit = _ADAPTIVE_CACHE.get(key)
            if hit is not None:
                _ADAPTIVE_CACHE.move_to_end(key)
                return hit
    _INSPECTION_COUNT += 1
    part = _adaptive_partition_uncached(spec, num_blocks,
                                        imbalance_threshold)
    if key is not None:
        with _ADAPTIVE_CACHE_LOCK:
            _ADAPTIVE_CACHE[key] = part
            while len(_ADAPTIVE_CACHE) > _ADAPTIVE_CACHE_CAPACITY:
                _ADAPTIVE_CACHE.popitem(last=False)
    return part


def _adaptive_partition_uncached(spec: WorkSpec, num_blocks: int,
                                 imbalance_threshold: float) -> Partition:
    phase1 = tile_mapped_partition(spec, num_blocks, Schedule.ADAPTIVE)
    if spec.num_atoms == 0 or spec.num_tiles == 0 or num_blocks == 1:
        return phase1
    loads = np.diff(phase1.atom_starts.cpu().numpy())
    mean = spec.num_atoms / num_blocks
    if loads.max() <= imbalance_threshold * max(mean, 1.0):
        return phase1              # the inspector says: balanced already
    quantum = _ceil_div(spec.num_atoms, num_blocks)
    cuts = _snapped_atom_cuts(spec, num_blocks, quantum)
    return _partition_from_atom_cuts(spec, cuts, Schedule.ADAPTIVE)
