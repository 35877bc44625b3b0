"""Sharded graph advance: recursive load balancing across ranks.

The paper balances atoms over tiles and tiles over blocks; this module
adds the next level of the same recursion, **vertices over shards**.  A
shard is one rank of a 1-axis ``"shard"`` mesh
(:func:`repro_torch.launch.mesh.make_graph_mesh`), and the traversal runs
SPMD over ``torch.distributed``: every rank calls the same driver with the
same arguments, runs its own shard, and returns the global answer.  Each
shard owns a contiguous vertex range and holds *local* pull/push CSR views
of exactly its own rows, built by the view-level inspector one device uses
(:func:`repro_torch.sparse.advance.build_advance_views`): chunks balance
blocks, blocks balance shards, with one cost model a level
(``workload="advance_sharded"``,
:func:`repro_torch.core.autotune.select_sharded_plan`).

Where the split points fall is a pluggable *boundary* schedule
(:data:`SHARD_SCHEDULES`), the shard-level analogue of the block-level
schedules: ``"equal_width"`` (uniform ``ceil(V/S)`` ranges, the default),
``"edge_balanced"`` (split points on the prefix sum of in+out degree) and
``"lpt_contiguous"`` (edge-balanced boundaries nudged to lower the largest
shard's load).  Boundaries are contiguous; every local view is padded to
the widest shard.

Execution contract (what keeps the sharded answers **bitwise** equal to
one device's, held by ``tests/test_torch_shard.py``):

* Each local view is a contiguous *slice* of the global CSR with rebased
  offsets, so every destination's atoms reduce in the same order.  The
  views keep the reference's padded shapes: ``E_max`` atoms a direction,
  padding atoms in a pad tile past the owned rows (spread over the empty
  trailing slots too for the degree-aware schedules), masked out of every
  advance by ``pull_valid``/``push_valid``.  So each shard's partition,
  and with it every chunk-walk partial, is the reference's.
* State lives in **padded-slot coordinates**: vertex ``v`` of shard ``s``
  is slot ``s * shard_size + (v - lo_s)``; ``glob2pad``/``pad2glob`` map
  between the layouts (the identity for ``equal_width``) and every
  per-atom source/destination id is mapped at build time.  The map is
  monotone in the global id, so min-reductions over ids (BFS parents) pick
  the same winner.
* **Pull** is purely local (a shard's destinations own all their
  in-edges): :func:`repro_torch.core.execute.execute_sharded_tile_reduce`
  after one ``all_gather`` of the ``[shard_size]`` frontier/state halo.
* **Push** scatters anywhere: each rank makes a full ``[V_pad]`` partial
  and :func:`repro_torch.core.execute.execute_sharded_scatter_reduce`
  combines the partials over the mesh; each rank keeps its slice.
* The statics a shard's executors size from (windows, items per block,
  queue width, the tile-aligned flag) are made uniform over the ranks, as
  ``shard_map``'s single program needs them in the reference.
* Direction, termination and bucket choices are *global*: the population
  and active-edge counts are summed over the ranks (one collective and one
  host read an iteration) and compared with the plan's one threshold, so
  every rank takes the same branch and issues the same collectives (a
  rank that did not would leave the others waiting until the group's
  timeout).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (ExecutionPath, Schedule, choose_execution_path,
                              estimate_direction_threshold,
                              execute_sharded_scatter_reduce,
                              execute_sharded_tile_reduce, make_partition)
from repro_torch.core.autotune import (Plan, REGISTERED_PLANS, ShardedPlan,
                                       select_sharded_plan)
from repro_torch.core.execute import LaneLayout
from repro_torch.core.segops import segment_sum
from repro_torch.core.work import WorkSpec
from repro_torch.launch.mesh import GraphMesh, make_graph_mesh
from repro_torch.sparse.advance import (DEFAULT_NUM_BLOCKS, AdvancePlan,
                                        _CHUNK_POLICIES, _combined_mask,
                                        _compact_capacity,
                                        build_advance_views, estimate_delta)
from repro_torch.sparse.graph import (_FAR_BUCKET, _SSSP_ALGORITHMS,
                                      _active_edges, _bucket_of,
                                      _check_driver_direction, _gather_rows,
                                      _pagerank_share, _pagerank_update,
                                      _validate_sources)

__all__ = ["SHARD_SCHEDULES", "ShardedAdvancePlan", "build_sharded_advance",
           "shard_boundaries", "sharded_bfs", "sharded_bfs_multi",
           "sharded_delta_stepping", "sharded_pagerank", "sharded_sssp"]


# ---------------------------------------------------------------------------
# Inspector: local views
# ---------------------------------------------------------------------------

def _local_csr_view(csr, lo: int, hi: int, shard_size: int, e_max: int, *,
                    spread_pad: bool = False):
    """One shard's padded local view of a global CSR, on its device.

    Rows ``[lo, hi)`` become local tiles ``[0, hi - lo)`` (trailing tiles up
    to ``shard_size`` are empty for a narrow shard); tile ``shard_size`` is
    the *pad tile* holding the padding atoms ``[E_local, e_max)``.  Columns
    and values are the contiguous global slice.  ``spread_pad`` spreads the
    padding atoms evenly over the empty trailing slots and the pad tile
    (one huge pad segment would widen the executors' windows, which are
    uniform over the shards).  Returns ``(offsets [shard_size + 2], cols,
    vals, valid)``.
    """
    roff = csr.row_offsets
    dev = roff.device
    lo = min(lo, hi)
    a0, a1 = int(roff[lo]), int(roff[hi])
    e_local = a1 - a0
    counts = (roff[lo + 1:hi + 1] - roff[lo:hi]).to(torch.int64)
    if spread_pad:
        n_bins = shard_size - counts.numel() + 1
        base, rem = divmod(e_max - e_local, n_bins)
        pad_counts = torch.full((n_bins,), base, dtype=torch.int64,
                                device=dev)
        pad_counts[:rem] += 1
        sizes = torch.cat([counts, pad_counts])
    else:
        sizes = torch.cat([counts,
                           counts.new_zeros(shard_size - counts.numel()),
                           counts.new_full((1,), e_max - e_local)])
    offs = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    cols = torch.zeros(e_max, dtype=torch.int32, device=dev)
    vals = torch.zeros(e_max, dtype=torch.float32, device=dev)
    valid = torch.zeros(e_max, dtype=torch.bool, device=dev)
    cols[:e_local] = csr.col_indices[a0:a1]
    vals[:e_local] = csr.values[a0:a1]
    valid[:e_local] = True
    return offs.to(torch.int32), cols, vals, valid


def _direction_e_max(row_offsets: np.ndarray, ranges) -> int:
    return max(1, max(int(row_offsets[hi] - row_offsets[lo])
                      for lo, hi in ranges))


# ---------------------------------------------------------------------------
# Boundary schedules: where the contiguous split points fall
# ---------------------------------------------------------------------------

def _vertex_loads(fwd_row_offsets, rev_row_offsets) -> np.ndarray:
    """Per-vertex work: in + out degree + 1 (the merge-path measure one
    level down counts a tile *and* its atoms; the +1 keeps edgeless
    stretches from collapsing into one shard)."""
    fdeg = np.diff(np.asarray(fwd_row_offsets).astype(np.int64))
    rdeg = np.diff(np.asarray(rev_row_offsets).astype(np.int64))
    return fdeg + rdeg + 1


def _equal_width_boundaries(loads, num_vertices, num_shards):
    width = max(-(-num_vertices // num_shards) if num_vertices else 1, 1)
    return np.minimum(
        np.arange(num_shards + 1, dtype=np.int64) * width, num_vertices)


def _edge_balanced_boundaries(loads, num_vertices, num_shards):
    # nonzero_split one level up: boundary k where the cumulative load
    # first reaches k/S of the total
    cum = np.concatenate([[0], np.cumsum(loads)])
    targets = cum[-1] * np.arange(1, num_shards, dtype=np.float64) / num_shards
    inner = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], inner, [num_vertices]]).astype(np.int64)
    return np.maximum.accumulate(np.minimum(bounds, num_vertices))


def _lpt_contiguous_boundaries(loads, num_vertices, num_shards):
    # LPT's move-work-off-the-max under contiguity: from the edge-balanced
    # split, move each interior boundary to the position minimizing the
    # larger of its two neighbouring loads, until no boundary moves
    bounds = _edge_balanced_boundaries(loads, num_vertices, num_shards)
    cum = np.concatenate([[0], np.cumsum(loads)])

    def seg(a, b):
        return cum[b] - cum[a]

    for _ in range(2 * num_shards):
        moved = False
        for k in range(1, num_shards):
            lo, hi = bounds[k - 1], bounds[k + 1]
            mid = (cum[lo] + cum[hi]) / 2.0
            x = int(np.clip(np.searchsorted(cum, mid, side="left"), lo, hi))
            best = bounds[k]
            best_cost = max(seg(lo, best), seg(best, hi))
            for cand in (x - 1, x, x + 1):
                if lo <= cand <= hi:
                    cost = max(seg(lo, cand), seg(cand, hi))
                    if cost < best_cost:
                        best, best_cost = cand, cost
            if best != bounds[k]:
                bounds[k] = best
                moved = True
        if not moved:
            break
    return bounds


#: The shard-level schedule registry: per-vertex loads -> the ``[S+1]``
#: contiguous boundaries.  Order matters: auto-selection drops a split
#: identical to an earlier name's, so ``equal_width`` wins ties.
SHARD_SCHEDULES = {
    "equal_width": _equal_width_boundaries,
    "edge_balanced": _edge_balanced_boundaries,
    "lpt_contiguous": _lpt_contiguous_boundaries,
}


def _validate_boundaries(bounds, num_vertices, num_shards, name):
    b = np.asarray(bounds, dtype=np.int64)
    if (b.shape != (num_shards + 1,) or b[0] != 0 or b[-1] != num_vertices
            or np.any(np.diff(b) < 0)):
        raise ValueError(
            f"shard schedule {name!r} produced invalid boundaries "
            f"{b.tolist()} for V={num_vertices}, S={num_shards}: need a "
            f"non-decreasing [S+1] split of [0, V]")
    return b


def _host_offsets(csr) -> np.ndarray:
    return csr.row_offsets.cpu().numpy()


def _schedule_boundaries(fwd_roff: np.ndarray, rev_roff: np.ndarray,
                         num_vertices: int, num_shards: int, name: str):
    if name not in SHARD_SCHEDULES:
        raise ValueError(f"unknown shard schedule {name!r} (expected one "
                         f"of {sorted(SHARD_SCHEDULES)})")
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards > max(num_vertices, 1) and name != "equal_width":
        raise ValueError(
            f"shard schedule {name!r} cannot split V={num_vertices} "
            f"vertices into S={num_shards} contiguous non-degenerate "
            f"shards; only 'equal_width' accepts a mesh larger than the "
            f"graph (its trailing shards are all-empty padding)")
    loads = _vertex_loads(fwd_roff, rev_roff)
    bounds = SHARD_SCHEDULES[name](loads, num_vertices, num_shards)
    return _validate_boundaries(bounds, num_vertices, num_shards, name)


def shard_boundaries(graph, num_shards: int,
                     shard_schedule: str = "equal_width") -> np.ndarray:
    """The ``[S+1]`` contiguous vertex boundaries a shard schedule yields
    (the computation :func:`build_sharded_advance` runs)."""
    fwd = graph.csr
    return _schedule_boundaries(_host_offsets(fwd),
                                _host_offsets(fwd.transpose()),
                                graph.num_vertices, int(num_shards),
                                shard_schedule)


def _boundary_permutation(bounds, shard_size: int):
    """The global <-> padded-slot bijection of a boundary array: slot ``s *
    shard_size + j`` holds vertex ``bounds[s] + j`` for ``j < width_s``;
    the padding slots take the ids ``[V, V_pad)`` in order.  The identity
    for equal-width boundaries."""
    bounds = np.asarray(bounds, dtype=np.int64)
    num_shards = bounds.size - 1
    num_vertices = int(bounds[-1])
    v_pad = num_shards * shard_size
    pad2glob = np.empty(v_pad, dtype=np.int32)
    overflow = num_vertices
    for s in range(num_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        base = s * shard_size
        pad2glob[base:base + (hi - lo)] = np.arange(lo, hi, dtype=np.int32)
        n_pad = shard_size - (hi - lo)
        pad2glob[base + (hi - lo):base + shard_size] = np.arange(
            overflow, overflow + n_pad, dtype=np.int32)
        overflow += n_pad
    glob2pad = np.empty(v_pad, dtype=np.int32)
    glob2pad[pad2glob] = np.arange(v_pad, dtype=np.int32)
    return glob2pad, pad2glob


def _candidate_shard_counts(num_vertices: int, world: int):
    """Powers of two up to the smaller of the group's size and ``V``."""
    counts, c = [], 1
    while c <= max(world, 1) and c <= max(num_vertices, 1):
        counts.append(c)
        c *= 2
    return counts


def _default_world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# ---------------------------------------------------------------------------
# Uniform statics over the ranks
# ---------------------------------------------------------------------------

_SCHEDULES = list(Schedule)
_PATHS = list(ExecutionPath)


def _part_statics(part) -> list:
    def opt(v):
        return -1 if v is None else int(v)
    bc = part.block_chunks
    width = -1 if bc is None else int(bc.shape[1])
    return [opt(part.atom_span), opt(part.tile_span),
            opt(part.items_per_block), int(part.tile_aligned), width]


def _uniform(part, rows: np.ndarray):
    """``part`` with the statics made uniform over the ranks' ``rows``:
    the largest windows, items per block and queue width (``None`` if any
    rank has none), tile-aligned only if every rank is.  Every direction
    is mask-safe: larger windows add masked slots, a non-aligned flag runs
    the identity-combining fixup, and zero-padded queue columns lie past
    each block's chunk count."""
    def max_opt(col):
        return None if (col < 0).any() else int(col.max())

    bc = part.block_chunks
    if bc is not None:
        wmax = int(rows[:, 4].max())
        bc = torch.nn.functional.pad(bc, (0, wmax - int(bc.shape[1])))
    return dataclasses.replace(
        part, atom_span=max_opt(rows[:, 0]), tile_span=max_opt(rows[:, 1]),
        items_per_block=max_opt(rows[:, 2]),
        tile_aligned=bool(rows[:, 3].all()), block_chunks=bc)


def _uniform_plan(plan: AdvancePlan, mesh: GraphMesh) -> AdvancePlan:
    """One all_gather of this rank's statics; the plan with uniform
    partitions.  Raises on every rank alike where the schedule, paths or
    compaction capacity differ between ranks."""
    cap = plan.compact_capacity
    mine = (_part_statics(plan.part) + _part_statics(plan.push_part)
            + [_SCHEDULES.index(plan.schedule), _PATHS.index(plan.path),
               _SCHEDULES.index(plan.push_schedule),
               _PATHS.index(plan.push_path), -1 if cap is None else cap])
    rows = mesh.all_gather(torch.tensor([mine], dtype=torch.int64,
                                        device=mesh.device)).cpu().numpy()
    if (rows[:, 10:] != rows[0, 10:]).any():
        raise AssertionError(f"per-shard plan statics diverged: "
                             f"{rows[:, 10:].tolist()}")
    return dataclasses.replace(plan, part=_uniform(plan.part, rows[:, :5]),
                               push_part=_uniform(plan.push_part,
                                                  rows[:, 5:10]))


# ---------------------------------------------------------------------------
# The sharded plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedAdvancePlan:
    """Inspector output of the sharded advance, as one rank holds it.

    ``plan`` is this rank's own shard's
    :class:`~repro_torch.sparse.advance.AdvancePlan` on the mesh's device
    (its statics uniform over the ranks); ``pull_valid``/``push_valid``
    mask its padding atoms.  The rest is the same on every rank: the
    global sizes, the boundaries, and the global <-> padded-slot maps.
    State the drivers keep is this rank's ``[shard_size]`` slice of the
    padded layout; :meth:`to_global` gathers it into global vertex order.
    """

    mesh: GraphMesh
    num_shards: int
    num_vertices: int         # global V
    shard_size: int           # widest shard: the padded slice of a rank
    num_edges: int            # global edge count (not the padded E_max)
    plan: AdvancePlan
    pull_valid: torch.Tensor
    push_valid: torch.Tensor
    shard_schedule: str = "equal_width"
    boundaries: tuple = ()    # [S+1] contiguous vertex split points
    glob2pad: Optional[torch.Tensor] = None   # [V_pad] global id -> slot
    pad2glob: Optional[torch.Tensor] = None   # [V_pad] slot -> global id
    weight_delta: float = 1.0  # estimate_delta of the global weights

    @property
    def axis(self) -> str:
        return self.mesh.axis

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def template(self) -> AdvancePlan:
        """This rank's plan (its statics are every rank's)."""
        return self.plan

    @property
    def padded_vertices(self) -> int:
        return self.num_shards * self.shard_size

    @property
    def slot_offset(self) -> int:
        """This rank's first slot of the padded layout."""
        return self.rank * self.shard_size

    @property
    def width(self) -> int:
        """How many of this rank's slots hold real vertices."""
        return self.boundaries[self.rank + 1] - self.boundaries[self.rank]

    @property
    def direction_threshold(self) -> float:
        return self.plan.direction_threshold

    @property
    def delta(self) -> Optional[float]:
        return self.plan.delta

    @property
    def schedule(self) -> Schedule:
        return self.plan.schedule

    @property
    def path(self) -> ExecutionPath:
        return self.plan.path

    def edge_fraction(self, active_edge_count: int) -> float:
        """Measured *global* frontier density, in the reference's float32
        arithmetic: the summed active out-edge count over the true global
        edge count (the local plan's ``num_edges`` is its padded E_max)."""
        return float(np.float32(active_edge_count)
                     / np.float32(max(self.num_edges, 1)))

    def to_global(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's ``[..., shard_size]`` slice gathered into global
        vertex order, ``[..., V]`` (one all_gather; the identity layout for
        ``equal_width``)."""
        rows = local.reshape(-1, self.shard_size)
        full = self.mesh.all_gather(rows)
        full = full.view(self.num_shards, -1, self.shard_size)
        full = full.permute(1, 0, 2).reshape(*local.shape[:-1],
                                             self.padded_vertices)
        return torch.index_select(full, -1,
                                  self.glob2pad[:self.num_vertices].long())

    def with_delta(self, delta: Optional[float] = None
                   ) -> "ShardedAdvancePlan":
        """Attach the light/heavy bucket split to this rank's shard.
        ``None`` takes :attr:`weight_delta`, the estimate from the global
        weights (what one device estimates); the light out-degrees count
        only the valid light atoms of the owned rows."""
        delta = self.weight_delta if delta is None else delta
        delta = float(delta)
        if not delta > 0.0:
            raise ValueError(f"delta must be positive, got {delta}")
        lp = self.plan
        thr = torch.tensor(delta, dtype=torch.float32,
                           device=lp.weight.device)
        push_light = lp.push_weight <= thr
        light_out = segment_sum(
            (push_light & self.push_valid).to(torch.int32),
            lp.push_spec.atom_tile_ids(),
            self.shard_size + 1)[:self.shard_size]
        plan = dataclasses.replace(
            lp, delta=delta, light_mask=lp.weight <= thr,
            push_light_mask=push_light,
            light_out_degrees=light_out.to(torch.int32))
        return dataclasses.replace(self, plan=plan)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _resolve_schedule_enum(schedule) -> tuple:
    policy = _CHUNK_POLICIES.get(str(schedule))
    return (Schedule.CHUNKED if policy else Schedule(schedule)), policy


def _agree(pick: ShardedPlan, group) -> ShardedPlan:
    """Rank 0's pick on every rank (ranks that timed candidates could
    differ; they must not build different plans)."""
    if group is None:
        return pick
    box = [pick.encode()]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return ShardedPlan.decode(box[0])


def build_sharded_advance(graph, num_shards=None, *,
                          schedule: Schedule | str = "auto",
                          num_blocks: Optional[int] = None,
                          path: ExecutionPath | str = ExecutionPath.AUTO,
                          workload: str = "advance",
                          shard_schedule: Optional[str] = None,
                          direction_threshold: Optional[float] = None,
                          delta: Optional[float | str] = None,
                          compact: Optional[bool | int | float] = None,
                          measure=None) -> ShardedAdvancePlan:
    """Inspect a graph into this rank's :class:`ShardedAdvancePlan`; every
    rank of the mesh calls it with the same arguments.

    ``num_shards`` is an int (``1``: a local mesh; more: the default
    process group of that many ranks, :func:`~repro_torch.launch.mesh.
    make_graph_mesh`, on the graph's device type), a
    :class:`~repro_torch.launch.mesh.GraphMesh`, or ``None``/``"auto"``:
    :func:`~repro_torch.core.autotune.select_sharded_plan` picks the shard
    count (powers of two up to the default group's size) jointly with
    schedule, path and boundary schedule.  A count below the group's size
    gives the ranks past it empty shards (no vertices; they take part in
    the collectives and return the answer).  With an explicit count and
    ``schedule="auto"`` the selector picks (schedule, path, boundary);
    fully explicit arguments skip it.

    ``shard_schedule`` names a boundary schedule of
    :data:`SHARD_SCHEDULES`; ``None`` is ``"equal_width"`` when nothing
    else is auto, and joint selection whenever the selector runs;
    ``"auto"`` forces the selection.  The direction threshold, the delta
    estimate and the compaction capacity are resolved once from the
    *global* views (what one device computes) and handed to every shard.
    """
    num_blocks = DEFAULT_NUM_BLOCKS if num_blocks is None else num_blocks
    V = graph.num_vertices
    fwd = graph.csr
    rev = fwd.transpose()
    fwd_roff, rev_roff = _host_offsets(fwd), _host_offsets(rev)

    mesh = None
    if isinstance(num_shards, (tuple, list)):
        raise ValueError(f"sharded advance needs a 1-axis mesh, got a "
                         f"mesh shape {tuple(num_shards)}")
    if isinstance(num_shards, GraphMesh):
        mesh = num_shards
        S = world = mesh.num_shards
    elif num_shards is None or num_shards == "auto":
        S, world = None, _default_world()
    else:
        S = world = int(num_shards)
        if S < 1:
            raise ValueError(f"num_shards must be >= 1, got {S}")

    if shard_schedule is not None and shard_schedule != "auto" \
            and shard_schedule not in SHARD_SCHEDULES:
        raise ValueError(
            f"unknown shard schedule {shard_schedule!r} (expected one of "
            f"{sorted(SHARD_SCHEDULES)} or 'auto')")
    auto_sched = (str(schedule) not in _CHUNK_POLICIES
                  and Schedule(schedule) == Schedule.AUTO)
    auto_boundary = shard_schedule in (None, "auto")
    if mesh is None:
        mesh = make_graph_mesh(world, device=graph.device.type)
    if S is None or auto_sched or shard_schedule == "auto":
        counts = [S] if S is not None else _candidate_shard_counts(V, world)
        bnames = (tuple(SHARD_SCHEDULES) if auto_boundary
                  else (shard_schedule,))
        bounds_by_count = {}
        for c in counts:
            per, seen = {}, set()
            for bname in bnames:
                if c > max(V, 1) and bname != "equal_width":
                    continue  # degree-aware splits reject S > V
                arr = _schedule_boundaries(fwd_roff, rev_roff, V, c, bname)
                key = tuple(int(x) for x in arr)
                if key in seen:
                    continue  # identical split: the first name wins
                seen.add(key)
                per[bname] = arr
            bounds_by_count[c] = per
        plans = REGISTERED_PLANS
        if not auto_sched:
            sched_enum, _ = _resolve_schedule_enum(schedule)
            plans = (tuple(p for p in REGISTERED_PLANS
                           if p.schedule == sched_enum)
                     or (Plan(sched_enum),))
        if ExecutionPath(path) != ExecutionPath.AUTO:
            plans = (tuple(p for p in plans
                           if p.path == ExecutionPath(path)) or plans)
        sp = _agree(select_sharded_plan(
            rev.workspec(), bounds_by_count, num_blocks,
            push_spec=fwd.workspec(), plans=plans, measure=measure),
            mesh.group)
        if S is None:
            S = sp.num_shards
        if auto_boundary:
            shard_schedule = sp.boundary
        if auto_sched:
            schedule = sp.schedule
            if ExecutionPath(path) == ExecutionPath.AUTO:
                path = sp.path
    boundary_name = ("equal_width" if shard_schedule in (None, "auto")
                     else shard_schedule)

    bounds = _schedule_boundaries(fwd_roff, rev_roff, V, S, boundary_name)
    # ranks past the selected count own nothing
    bounds = np.concatenate([bounds, np.full(mesh.num_shards - S, V,
                                             np.int64)])
    ranges = list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))
    shard_size = max(max(hi - lo for lo, hi in ranges), 1)
    V_pad = mesh.num_shards * shard_size
    glob2pad, pad2glob = _boundary_permutation(bounds, shard_size)
    e_pull = _direction_e_max(rev_roff, ranges)
    e_push = _direction_e_max(fwd_roff, ranges)

    # the global direction threshold: the single-device inspector's own
    # computation over the global views, so S=1 matches it bit for bit
    sched_enum, policy = _resolve_schedule_enum(schedule)
    if direction_threshold is None:
        pull_spec_g, push_spec_g = rev.workspec(), fwd.workspec()
        pull_part_g = make_partition(pull_spec_g, sched_enum, num_blocks,
                                     chunk_policy=policy or "lpt")
        push_part_g = make_partition(push_spec_g, sched_enum, num_blocks,
                                     chunk_policy=policy or "lpt")
        direction_threshold = estimate_direction_threshold(
            pull_spec_g, push_spec_g, num_blocks,
            pull_schedule=sched_enum, push_schedule=sched_enum,
            pull_path=str(choose_execution_path(pull_part_g,
                                                ExecutionPath(path))),
            push_path=str(choose_execution_path(push_part_g,
                                                ExecutionPath(path))),
            pull_part=pull_part_g, push_part=push_part_g)
    # one global compaction capacity (executors clamp it to their local
    # window count)
    capacity = _compact_capacity(compact, graph.num_edges,
                                 float(direction_threshold))

    lo, hi = ranges[mesh.rank]
    spread_pad = boundary_name != "equal_width"
    g2p = torch.from_numpy(glob2pad).to(graph.device)
    poffs, pcols, pvals, pvalid = _local_csr_view(
        rev, lo, hi, shard_size, e_pull, spread_pad=spread_pad)
    qoffs, qcols, qvals, qvalid = _local_csr_view(
        fwd, lo, hi, shard_size, e_push, spread_pad=spread_pad)
    dev = mesh.device
    pull_spec = WorkSpec.from_segment_offsets(poffs.to(dev),
                                              num_atoms=e_pull)
    push_spec = WorkSpec.from_segment_offsets(qoffs.to(dev),
                                              num_atoms=e_push)
    # the owned vertices' real out-degrees, wherever the padding sits
    out_deg = torch.zeros(shard_size, dtype=torch.int32, device=dev)
    out_deg[:hi - lo] = torch.from_numpy(
        np.diff(fwd_roff[lo:hi + 1]).astype(np.int32)).to(dev)
    tids = push_spec.atom_tile_ids().to(graph.device).long()
    # padding atoms: source slot 0 and destination V_pad (dropped); real
    # atoms carry padded-layout ids, which index the gathered state
    push_src = torch.where(qvalid, g2p[torch.where(qvalid, lo + tids, 0)],
                           0).to(torch.int32)
    push_dst = torch.where(qvalid, g2p[torch.where(qvalid, qcols.long(), 0)],
                           V_pad).to(torch.int32)
    pull_src = g2p[pcols.long()].to(torch.int32)
    plan = build_advance_views(
        pull_spec=pull_spec, pull_src=pull_src.to(dev),
        pull_weight=pvals.to(dev), push_spec=push_spec,
        push_dst=push_dst.to(dev), push_weight=qvals.to(dev),
        push_src=push_src.to(dev), num_vertices=V_pad, schedule=schedule,
        num_blocks=num_blocks, path=path, workload=workload,
        direction_threshold=float(direction_threshold), compact=capacity,
        out_degrees=out_deg)
    splan = ShardedAdvancePlan(
        mesh=mesh, num_shards=mesh.num_shards, num_vertices=V,
        shard_size=shard_size, num_edges=graph.num_edges,
        plan=_uniform_plan(plan, mesh), pull_valid=pvalid.to(dev),
        push_valid=qvalid.to(dev), shard_schedule=boundary_name,
        boundaries=tuple(int(b) for b in bounds),
        glob2pad=torch.from_numpy(glob2pad).to(dev),
        pad2glob=torch.from_numpy(pad2glob).to(dev),
        weight_delta=estimate_delta(fwd.values))
    if delta is not None:
        splan = splan.with_delta(None if delta == "auto" else float(delta))
    return splan


# ---------------------------------------------------------------------------
# Shard-local advances and global scalars
# ---------------------------------------------------------------------------

def _pull_local(splan, frontier_full, atom_fn, *, combiner, edge_mask):
    """Local pull advance -> this rank's ``[shard_size]`` slice."""
    lp = splan.plan
    out = execute_sharded_tile_reduce(
        lp.spec, lp.part, atom_fn, torch.float32, mesh=splan.mesh,
        path=lp.path, combiner=combiner,
        atom_mask=_combined_mask(frontier_full, lp.src, edge_mask))
    return out[:splan.shard_size]


def _push_local(splan, frontier_full, atom_fn, *, combiner, edge_mask):
    """Local push advance + the combine over the mesh -> this rank's
    ``[shard_size]`` slice."""
    lp = splan.plan
    full = execute_sharded_scatter_reduce(
        lp.push_spec, lp.push_part, atom_fn, lp.dst, lp.num_vertices,
        torch.float32, mesh=splan.mesh, path=lp.push_path,
        combiner=combiner,
        atom_mask=_combined_mask(frontier_full, lp.push_src, edge_mask),
        compact_capacity=lp.compact_capacity)
    lo = splan.slot_offset
    return full[lo:lo + splan.shard_size]


def _subset_mask(lp: AdvancePlan, direction: str, edges: str, valid):
    """Edge-subset mask ANDed with the shard's padding-validity mask."""
    em = lp.edge_set_mask(edges, direction)
    return valid if em is None else valid & em


def _use_push(splan, direction: str, active_edges: int) -> bool:
    """The direction of an iteration: requested, or the *global* density
    against the plan's one threshold (so every rank agrees)."""
    if direction != "auto":
        return direction == "push"
    return (np.float32(splan.edge_fraction(active_edges))
            < np.float32(splan.direction_threshold))


def _relax_local(splan, push: bool, dist_full, frontier_full,
                 edges: str = "all"):
    """One min-relax in the chosen direction -> the candidate slice."""
    lp = splan.plan
    if push:
        src, w = lp.push_src, lp.push_weight
        return _push_local(splan, frontier_full,
                           lambda e: dist_full[src[e]] + w[e],
                           combiner="min", edge_mask=_subset_mask(
                               lp, "push", edges, splan.push_valid))
    src, w = lp.src, lp.weight
    return _pull_local(splan, frontier_full,
                       lambda e: dist_full[src[e]] + w[e], combiner="min",
                       edge_mask=_subset_mask(lp, "pull", edges,
                                              splan.pull_valid))


def _global_ints(splan, sums=(), mins=()) -> list:
    """Integer scalars (or vectors, flattened) summed (``sums``) or
    min-reduced (``mins``) over the ranks: one all_gather and one host
    read."""
    flat = lambda vs: [v.to(torch.int64).reshape(-1) for v in vs]
    k = sum(int(v.numel()) for v in flat(sums))
    rows = splan.mesh.all_gather(torch.cat(flat(sums) + flat(mins))[None])
    return torch.cat([rows[:, :k].sum(0), rows[:, k:].amin(0)]).tolist()


def _global_sum(splan, value: torch.Tensor) -> torch.Tensor:
    """A float32 scalar summed over the ranks (the reference's ``psum``),
    as a device scalar."""
    return splan.mesh.all_gather(value.reshape(1)).sum()


def _source_mask(splan, sources) -> torch.Tensor:
    """This rank's ``[B, shard_size]`` mask of the sources' slots."""
    n, dev = splan.shard_size, splan.mesh.device
    slots = splan.glob2pad[torch.as_tensor(
        sources, dtype=torch.long, device=dev)].long() - splan.slot_offset
    rows = torch.arange(slots.numel(), device=dev)
    mine = (slots >= 0) & (slots < n)
    mask = torch.zeros((slots.numel(), n), dtype=torch.bool, device=dev)
    mask[rows[mine], slots[mine]] = True
    return mask


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def sharded_bfs(splan: ShardedAdvancePlan, source, *,
                max_iters: Optional[int] = None,
                return_parents: bool = False, direction: str = "auto",
                return_direction_counts: bool = False):
    """Sharded BFS; the contract (and bits) of
    :func:`repro_torch.sparse.graph.bfs`."""
    _check_driver_direction(direction)
    V = splan.num_vertices
    _validate_sources(source, V)
    if return_parents and splan.padded_vertices >= (1 << 24):
        raise ValueError(
            f"sharded BFS parents reduce vertex ids as f32, exact only "
            f"below 2**24 padded vertices (got {splan.padded_vertices})")
    max_iters = V if max_iters is None else max_iters
    lp, n = splan.plan, splan.shard_size
    frontier = _source_mask(splan, [int(source)])[0]
    depth = torch.where(frontier, 0, -1).to(torch.int32)
    parent = torch.full((n,), -1, dtype=torch.int32, device=frontier.device)
    count, active = _global_ints(splan, sums=(
        frontier.sum(), _active_edges(frontier, lp.out_degrees)))
    iters = pushes = 0
    while iters < max_iters and count > 0:
        full_f = splan.mesh.all_gather(frontier)
        push = _use_push(splan, direction, active)
        advance = _push_local if push else _pull_local
        valid = splan.push_valid if push else splan.pull_valid
        if return_parents:
            # min over source slots: monotone in the global id
            src = lp.push_src if push else lp.src
            cand = advance(splan, full_f, lambda e: src[e].float(),
                           combiner="min", edge_mask=valid)
            cand = torch.where(torch.isfinite(cand), cand,
                               -1.0).to(torch.int32)
            newly = (cand >= 0) & (depth < 0)
            parent = torch.where(newly, cand, parent)
        else:
            reached = advance(
                splan, full_f,
                lambda e: torch.ones(e.shape, dtype=torch.float32,
                                     device=e.device),
                combiner="max", edge_mask=valid)
            newly = (reached > 0.0) & (depth < 0)
        depth = torch.where(newly, iters + 1, depth)
        frontier = newly
        count, active = _global_ints(splan, sums=(
            frontier.sum(), _active_edges(frontier, lp.out_degrees)))
        iters += 1
        pushes += push
    out = (splan.to_global(depth),)
    if return_parents:
        # slots -> the caller's global vertex ids
        parent = torch.where(
            parent >= 0, splan.pad2glob[torch.clamp(parent, min=0).long()],
            -1).to(torch.int32)
        out += (splan.to_global(parent),)
    if return_direction_counts:
        out += (torch.tensor([pushes, iters - pushes], dtype=torch.int32,
                             device=depth.device),)
    return out[0] if len(out) == 1 else out


def _reach_lanes(splan, layout: LaneLayout, frontier_full: torch.Tensor,
                 gather: torch.Tensor) -> torch.Tensor:
    """B local pull scatter-ors in one launch (``[B, V_pad]`` frontiers ->
    ``[B, shard_size]``): each lane's frontier folded into its atom values
    as the max identity, read through ``gather`` (the atoms' source slots,
    ``V_pad`` for padding atoms: a slot that is ``-inf`` in every lane)."""
    B, v_pad = frontier_full.shape
    tables = torch.full((B, v_pad + 1), float("-inf"),
                        device=frontier_full.device)
    tables[:, :v_pad].masked_fill_(frontier_full, 1.0)
    reached = layout.reduce(
        B, lambda out: _gather_rows(out, tables, gather), combiner="max")
    return reached.t()[:, :splan.shard_size] > 0.0


def sharded_bfs_multi(splan: ShardedAdvancePlan, sources, *,
                      max_iters: Optional[int] = None,
                      direction: str = "pull") -> torch.Tensor:
    """Batched sharded BFS: ``[B, V]`` depths, row ``b`` equal to
    ``sharded_bfs(splan, sources[b], direction=direction)`` bitwise.  Each
    level gathers all lanes' frontiers at once; the pull lanes run as one
    launch on this rank's shard (:class:`~repro_torch.core.execute.
    LaneLayout`), the push lanes one at a time."""
    _check_driver_direction(direction)
    V = splan.num_vertices
    _validate_sources(sources, V, what="bfs_multi sources")
    max_iters = V if max_iters is None else max_iters
    if isinstance(sources, torch.Tensor):
        sources = sources.cpu().numpy()
    sources = [int(s) for s in np.asarray(sources, np.int64).reshape(-1)]
    B, lp = len(sources), splan.plan
    frontier = _source_mask(splan, sources)
    depth = torch.where(frontier, 0, -1).to(torch.int32)
    layout = LaneLayout(lp.spec, lp.part, max(B, 1), path=lp.path)
    gather = torch.where(splan.pull_valid, lp.src, splan.padded_vertices)
    unit = lambda e: torch.ones(e.shape, dtype=torch.float32,
                                device=e.device)
    iters = 0
    while iters < max_iters and B:
        sums = (frontier.sum(1),)
        if direction == "auto":
            sums += (torch.where(frontier, lp.out_degrees, 0).sum(1),)
        live = _global_ints(splan, sums=sums) + [0] * (
            B if direction != "auto" else 0)
        lanes = [j for j in range(B) if live[j] > 0]
        if not lanes:
            break
        push = [j for j in lanes if _use_push(splan, direction, live[B + j])]
        pull = [j for j in lanes if j not in push]
        full_f = splan.mesh.all_gather(frontier).view(
            splan.num_shards, B, splan.shard_size).permute(1, 0, 2).reshape(
                B, splan.padded_vertices)
        reached = torch.zeros_like(frontier)
        if pull:
            idx = torch.tensor(pull, device=frontier.device)
            reached[idx] = _reach_lanes(splan, layout, full_f[idx], gather)
        for j in push:
            reached[j] = _push_local(splan, full_f[j], unit, combiner="max",
                                     edge_mask=splan.push_valid) > 0.0
        newly = reached & (depth < 0)
        depth = torch.where(newly, iters + 1, depth)
        frontier = newly
        iters += 1
    return splan.to_global(depth)


def sharded_sssp(splan: ShardedAdvancePlan, source, *,
                 max_iters: Optional[int] = None, direction: str = "auto",
                 algorithm: str = "bellman_ford",
                 delta: Optional[float] = None,
                 return_direction_counts: bool = False):
    """Sharded SSSP; the contract (and bits) of
    :func:`repro_torch.sparse.graph.sssp`."""
    _check_driver_direction(direction)
    if algorithm not in _SSSP_ALGORITHMS:
        raise ValueError(f"unknown algorithm: {algorithm!r} "
                         f"(expected one of {_SSSP_ALGORITHMS})")
    if algorithm == "delta":
        return sharded_delta_stepping(
            splan, source, delta=delta, max_iters=max_iters,
            direction=direction,
            return_direction_counts=return_direction_counts)
    V = splan.num_vertices
    _validate_sources(source, V)
    max_iters = V if max_iters is None else max_iters
    outdeg, mesh = splan.plan.out_degrees, splan.mesh
    frontier = _source_mask(splan, [int(source)])[0]
    dist_l = torch.where(frontier, 0.0, float("inf"))
    count, active = _global_ints(splan, sums=(
        frontier.sum(), _active_edges(frontier, outdeg)))
    iters = pushes = 0
    while iters < max_iters and count > 0:
        push = _use_push(splan, direction, active)
        cand = _relax_local(splan, push, mesh.all_gather(dist_l),
                            mesh.all_gather(frontier))
        new_dist = torch.minimum(dist_l, cand)
        frontier = new_dist < dist_l
        dist_l = new_dist
        count, active = _global_ints(splan, sums=(
            frontier.sum(), _active_edges(frontier, outdeg)))
        iters += 1
        pushes += push
    dist_g = splan.to_global(dist_l)
    if return_direction_counts:
        return dist_g, torch.tensor([pushes, iters - pushes],
                                    dtype=torch.int32, device=dist_g.device)
    return dist_g


def sharded_delta_stepping(splan: ShardedAdvancePlan, source, *,
                           delta: Optional[float] = None,
                           max_iters: Optional[int] = None,
                           direction: str = "auto",
                           return_direction_counts: bool = False):
    """Sharded delta-stepping, bitwise equal to the single-device driver:
    its loops (light inner loop, one heavy relax a settled bucket,
    Bellman-Ford backstop) with every bucket and termination scalar
    global (the bucket is a min over the ranks, the populations sums)."""
    _check_driver_direction(direction)
    V = splan.num_vertices
    _validate_sources(source, V)
    if splan.delta is None or (delta is not None
                               and float(delta) != splan.delta):
        splan = splan.with_delta(delta)
    width = splan.delta
    max_outer = (V + 2) if max_iters is None else max_iters
    inner_cap = V + 1
    lp, mesh = splan.plan, splan.mesh
    light_out = lp.light_out_degrees
    heavy_out = lp.out_degrees - light_out
    far = torch.tensor(_FAR_BUCKET, dtype=torch.int32, device=mesh.device)

    def relax(dist_l, frontier_l, active, edges):
        push = _use_push(splan, direction, active)
        cand = _relax_local(splan, push, mesh.all_gather(dist_l),
                            mesh.all_gather(frontier_l), edges)
        counts[0 if push else 1] += 1
        return torch.minimum(dist_l, cand)

    needs = _source_mask(splan, [int(source)])[0]
    dist_l = torch.where(needs, 0.0, float("inf"))
    counts = [0, 0]                       # (push, pull) advances
    outer = 0
    while outer < max_outer:
        nneeds, bucket = _global_ints(splan, sums=(needs.sum(),), mins=(
            torch.where(needs, _bucket_of(dist_l, width), far).min(),))
        if not nneeds:
            break
        settled = torch.zeros_like(needs)
        for _ in range(inner_cap):
            frontier = needs & (_bucket_of(dist_l, width) == bucket)
            nonempty, active = _global_ints(splan, sums=(
                frontier.sum(), _active_edges(frontier, light_out)))
            if not nonempty:
                break
            new_dist = relax(dist_l, frontier, active, "light")
            needs = (needs & ~frontier) | (new_dist < dist_l)
            settled |= frontier
            dist_l = new_dist
        # heavy phase: every vertex the bucket settled relaxes its heavy
        # out-edges once (skipped everywhere when none has any)
        (active_heavy,) = _global_ints(splan, sums=(
            _active_edges(settled, heavy_out),))
        if active_heavy > 0:
            new_dist = relax(dist_l, settled, active_heavy, "heavy")
            needs |= new_dist < dist_l
            dist_l = new_dist
        outer += 1

    # backstop: frontier Bellman-Ford over all edges finishes leftovers
    for _ in range(V):
        nonempty, active = _global_ints(splan, sums=(
            needs.sum(), _active_edges(needs, lp.out_degrees)))
        if not nonempty:
            break
        new_dist = relax(dist_l, needs, active, "all")
        needs = new_dist < dist_l
        dist_l = new_dist
    dist_g = splan.to_global(dist_l)
    if return_direction_counts:
        return dist_g, torch.tensor(counts, dtype=torch.int32,
                                    device=dist_g.device)
    return dist_g


def sharded_pagerank(splan: ShardedAdvancePlan, *, damping: float = 0.85,
                     num_iters: int = 50, tol: float = 0.0,
                     direction: str = "auto") -> torch.Tensor:
    """Sharded PageRank; matches :func:`repro_torch.sparse.graph.pagerank`.

    Pull contributions reduce the same rebased atom segments as one
    device; the dangling mass and the step change are sums of per-shard
    sums (another order than one device's one-pass sum: general graphs
    agree to a tolerance, dyadic ones bitwise).  Padding slots are pinned
    to rank 0 every iteration.
    """
    _check_driver_direction(direction)
    direction = "pull" if direction == "auto" else direction
    V = splan.num_vertices
    lp, mesh, n = splan.plan, splan.mesh, splan.shard_size
    if V == 0:
        return torch.zeros(0, dtype=torch.float32, device=mesh.device)
    is_real = torch.arange(n, device=mesh.device) < splan.width
    outdeg = lp.out_degrees.to(torch.float32)
    pr = torch.where(is_real, 1.0 / V, 0.0).to(torch.float32)
    push = direction == "push"
    src = lp.push_src if push else lp.src
    for _ in range(num_iters):
        full_share = mesh.all_gather(_pagerank_share(pr, outdeg))
        atom_fn = lambda e: full_share[src[e]]
        if push:
            contrib = _push_local(splan, None, atom_fn, combiner="sum",
                                  edge_mask=splan.push_valid)
        else:
            contrib = _pull_local(splan, None, atom_fn, combiner="sum",
                                  edge_mask=splan.pull_valid)
        dangling = _global_sum(splan, torch.where(outdeg > 0, 0.0, pr).sum())
        new_pr = _pagerank_update(contrib, dangling, damping, V)
        new_pr = torch.where(is_real, new_pr, 0.0)
        step = float(_global_sum(splan, (new_pr - pr).abs().sum()))
        pr = new_pr
        if not step > tol:
            break
    return splan.to_global(pr)
