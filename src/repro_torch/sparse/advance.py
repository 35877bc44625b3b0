"""Load-balanced graph frontier operators (paper §5.3, Listing 5).

Every edge leaving the frontier is one work atom, and the per-edge relax is
load-balanced exactly like a SpMV's multiply.  Two directions of the same
advance come from one inspector (:func:`build_advance` returns a pair):

* **pull** — tiles = destination vertices, atoms = in-edges of the
  transpose CSR; a per-destination reduce under a frontier mask
  (``frontier[src(e)]``).  Touches every edge: right for dense frontiers.
* **push** — tiles = source vertices, atoms = out-edges of the forward
  CSR; masked per-source value windows combined by edge *destination*
  (:func:`repro_torch.core.execute.execute_scatter_reduce`), the ordered
  stand-in for ``atomicMin``'s scatter.

The plan also carries the modeled push -> pull switch density, an optional
light/heavy delta split (delta-stepping) and an optional static capacity
for gather-compacted push windows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import (ExecutionPath, Partition, Schedule,
                              choose_execution_path,
                              estimate_compact_capacity,
                              estimate_direction_threshold,
                              execute_scatter_reduce, execute_tile_reduce,
                              make_partition)
from repro_torch.core.segops import segment_sum
from repro_torch.core.work import WorkSpec

#: Default physical blocks for graph advance.
DEFAULT_NUM_BLOCKS = 32

#: Accepted ``schedule=`` spellings for the dynamic queue policies.
_CHUNK_POLICIES = {"chunked": "lpt", "chunked_lpt": "lpt",
                   "chunked_rr": "round_robin"}

#: Directions an advance can run in.
DIRECTIONS = ("pull", "push")

#: Edge subsets an advance can restrict itself to (light/heavy need a delta
#: split on the plan).
EDGE_SETS = ("all", "light", "heavy")


def estimate_delta(weights) -> float:
    """Bucket width for delta-stepping: the mean positive weight (floored at
    the min); edgeless graphs get 1.0."""
    if isinstance(weights, torch.Tensor):
        weights = weights.cpu().numpy()
    w = np.asarray(weights, np.float32)
    w = w[np.isfinite(w) & (w > 0)]
    if w.size == 0:
        return 1.0
    return float(max(np.float32(w.mean()), w.min()))


@dataclasses.dataclass(frozen=True)
class AdvancePlan:
    """One-time inspector output: a pull/push pair of direction plans.

    Pull: ``spec`` (tiles = destinations), ``src``/``weight`` per in-edge
    atom, ``part``/``schedule``/``path``.  Push: ``push_spec`` (tiles =
    sources), ``dst`` (scatter ids), ``push_weight``, ``push_src`` per
    out-edge atom, ``push_part``/``push_schedule``/``push_path``.
    ``direction_threshold`` is the modeled out-edge density at which pull
    becomes cheaper than push; ``out_degrees`` measures the density.
    """

    spec: WorkSpec
    src: torch.Tensor            # [E] int32 source of each in-edge atom
    weight: torch.Tensor         # [E] f32 weight of each in-edge atom
    part: Partition
    schedule: Schedule
    path: ExecutionPath
    push_spec: WorkSpec
    dst: torch.Tensor            # [E] int32 destination of each out-edge
    push_weight: torch.Tensor    # [E] f32 weight of each out-edge
    push_src: torch.Tensor       # [E] int32 source tile of each out-edge
    push_part: Partition
    push_schedule: Schedule
    push_path: ExecutionPath
    num_vertices: int
    out_degrees: torch.Tensor    # [V] int32
    direction_threshold: float
    delta: Optional[float] = None
    light_mask: Optional[torch.Tensor] = None       # [E] bool, pull order
    push_light_mask: Optional[torch.Tensor] = None  # [E] bool, push order
    light_out_degrees: Optional[torch.Tensor] = None  # [V] int32
    compact_capacity: Optional[int] = None

    @property
    def num_edges(self) -> int:
        return self.push_spec.num_atoms

    def with_compact_capacity(self,
                              capacity: Optional[int]) -> "AdvancePlan":
        """Same plan pair, another static push-compaction capacity (any
        capacity is correct: overflow runs the masked windows)."""
        if capacity is not None:
            capacity = int(capacity)
            if capacity < 1:
                raise ValueError(f"compact capacity must be >= 1 or None, "
                                 f"got {capacity}")
        return dataclasses.replace(self, compact_capacity=capacity)

    def with_delta(self, delta: Optional[float] = None) -> "AdvancePlan":
        """Attach a light/heavy edge split at bucket width ``delta``
        (``None``: :func:`estimate_delta` of the weights)."""
        if delta is None:
            delta = estimate_delta(self.push_weight)
        delta = float(delta)
        if not delta > 0.0:
            raise ValueError(f"delta must be positive, got {delta}")
        thr = torch.tensor(delta, dtype=torch.float32)
        push_light = self.push_weight <= thr.to(self.push_weight.device)
        light_out = segment_sum(push_light.to(torch.int32), self.push_src,
                                self.num_vertices)
        return dataclasses.replace(
            self, delta=delta,
            light_mask=self.weight <= thr.to(self.weight.device),
            push_light_mask=push_light, light_out_degrees=light_out)

    def edge_set_mask(self, edges: str,
                      direction: str) -> Optional[torch.Tensor]:
        """The requested edge subset as a per-atom mask in ``direction``'s
        own edge order (``None`` for the full set)."""
        if edges not in EDGE_SETS:
            raise ValueError(f"unknown edge set: {edges!r} "
                             f"(expected one of {EDGE_SETS})")
        if edges == "all":
            return None
        if self.delta is None:
            raise ValueError(
                f"edges={edges!r} needs a delta split on the plan; build "
                f"with delta= or call plan.with_delta()")
        light = (self.push_light_mask if direction == "push"
                 else self.light_mask)
        return light if edges == "light" else ~light

    def edge_fraction(self, active_edge_count: int) -> float:
        """Fraction of the edge set ``active_edge_count`` covers, in the
        reference's float32 arithmetic (compared with
        ``direction_threshold``)."""
        return float(np.float32(active_edge_count)
                     / np.float32(max(self.num_edges, 1)))

    def frontier_edge_fraction(self, frontier: torch.Tensor) -> float:
        """Measured frontier density: fraction of edges leaving
        ``frontier``."""
        return self.edge_fraction(
            int(torch.where(frontier, self.out_degrees, 0).sum()))


def _resolve_direction_plan(spec: WorkSpec, schedule, path, num_blocks: int,
                            workload: str):
    """(schedule, path, Partition) for one direction's work view."""
    policy = _CHUNK_POLICIES.get(str(schedule))
    sched = Schedule.CHUNKED if policy else Schedule(schedule)
    req_path = ExecutionPath(path)
    if sched == Schedule.AUTO:
        from repro_torch.core.autotune import select_plan
        plan = select_plan(spec, num_blocks, workload=workload)
        sched = plan.schedule
        policy = "lpt" if sched == Schedule.CHUNKED else None
        if req_path == ExecutionPath.AUTO:
            req_path = plan.path
    part = make_partition(spec, sched, num_blocks,
                          chunk_policy=policy or "lpt")
    return sched, choose_execution_path(part, req_path), part


#: Push-direction sibling of each frontier-masked workload family.
_PUSH_WORKLOADS = {"advance": "advance_push",
                   "advance_delta": "advance_delta_push",
                   "wavefront": "wavefront_push"}


def build_advance(graph, *, schedule: Schedule | str = "auto",
                  num_blocks: Optional[int] = None,
                  path: ExecutionPath | str = ExecutionPath.AUTO,
                  workload: str = "advance",
                  direction_threshold: Optional[float] = None,
                  delta: Optional[float | str] = None,
                  compact: Optional[bool | int | float] = None
                  ) -> AdvancePlan:
    """Inspect a :class:`~repro_torch.sparse.graph.Graph` into a plan pair.

    ``schedule`` is any registered schedule, a dynamic queue spelling, or
    ``"auto"`` (a (schedule, path) plan per direction from the autotuner:
    the ``workload`` family for pull, its push sibling for push).
    ``direction_threshold`` overrides the modeled switch density (0.0:
    always pull, 1.0: always push).  ``delta`` attaches the light/heavy
    split (``"auto"`` estimates it); ``compact`` enables gather-compacted
    push windows (``True``: capacity from the threshold; a float in (0, 1]:
    that fraction of the edges; an int: that many slots).
    """
    pull = graph.csr.transpose()          # CSR of A^T: rows = destinations
    push_spec = graph.csr.workspec()      # forward CSR: rows = sources
    return build_advance_views(
        pull_spec=pull.workspec(), pull_src=pull.col_indices,
        pull_weight=pull.values, push_spec=push_spec,
        push_dst=graph.csr.col_indices, push_weight=graph.csr.values,
        num_vertices=graph.num_vertices, schedule=schedule,
        num_blocks=num_blocks, path=path, workload=workload,
        direction_threshold=direction_threshold, delta=delta,
        compact=compact)


def _compact_capacity(compact, num_edges: int,
                      direction_threshold: float) -> Optional[int]:
    if compact is None or compact is False:
        return None
    if compact is True:
        return estimate_compact_capacity(num_edges, direction_threshold)
    if isinstance(compact, float):
        if not 0.0 < compact <= 1.0:
            raise ValueError(f"compact fraction must be in (0, 1], "
                             f"got {compact}")
        return max(int(np.ceil(num_edges * compact)), 1)
    if int(compact) < 1:
        raise ValueError(f"compact capacity must be >= 1 (or None/False to "
                         f"disable), got {compact}")
    return int(compact)


def build_advance_views(*, pull_spec: WorkSpec, pull_src: torch.Tensor,
                        pull_weight: torch.Tensor, push_spec: WorkSpec,
                        push_dst: torch.Tensor, push_weight: torch.Tensor,
                        num_vertices: int,
                        schedule: Schedule | str = "auto",
                        num_blocks: Optional[int] = None,
                        path: ExecutionPath | str = ExecutionPath.AUTO,
                        workload: str = "advance",
                        direction_threshold: Optional[float] = None,
                        delta: Optional[float | str] = None,
                        compact: Optional[bool | int | float] = None
                        ) -> AdvancePlan:
    """The view-level inspector behind :func:`build_advance`: partitions
    both views, models the switch density, sizes compaction."""
    num_blocks = DEFAULT_NUM_BLOCKS if num_blocks is None else num_blocks
    sched, resolved, part = _resolve_direction_plan(
        pull_spec, schedule, path, num_blocks, workload)
    push_sched, push_resolved, push_part = _resolve_direction_plan(
        push_spec, schedule, path, num_blocks,
        _PUSH_WORKLOADS.get(workload, workload))
    if direction_threshold is None:
        direction_threshold = estimate_direction_threshold(
            pull_spec, push_spec, num_blocks,
            pull_schedule=sched, push_schedule=push_sched,
            pull_path=str(resolved), push_path=str(push_resolved),
            pull_part=part, push_part=push_part)
    plan = AdvancePlan(
        spec=pull_spec, src=pull_src,
        weight=pull_weight.to(torch.float32), part=part,
        schedule=sched, path=resolved,
        push_spec=push_spec, dst=push_dst,
        push_weight=push_weight.to(torch.float32),
        push_src=push_spec.atom_tile_ids(), push_part=push_part,
        push_schedule=push_sched, push_path=push_resolved,
        num_vertices=num_vertices,
        out_degrees=push_spec.atoms_per_tile().to(torch.int32),
        direction_threshold=float(direction_threshold),
        compact_capacity=_compact_capacity(compact, push_spec.num_atoms,
                                           float(direction_threshold)))
    if delta is not None:
        plan = plan.with_delta(None if delta == "auto" else delta)
    return plan


def _combined_mask(vertex_mask: Optional[torch.Tensor], gather: torch.Tensor,
                   edge_mask: Optional[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
    """frontier-gather AND edge-subset mask (either may be absent)."""
    atom_mask = None if vertex_mask is None else vertex_mask[gather]
    if edge_mask is None:
        return atom_mask
    return edge_mask if atom_mask is None else atom_mask & edge_mask


def advance(plan: AdvancePlan, frontier: Optional[torch.Tensor],
            atom_fn: Callable[[torch.Tensor], torch.Tensor], *,
            combiner: str = "sum",
            edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pull advance: per-destination ``combiner``-reduce over in-edge
    atoms whose *source* is in ``frontier`` (bool ``[V]``; ``None`` = all)
    and in ``edge_mask`` (pull edge order).  Returns ``[V]`` f32; untouched
    destinations hold the identity."""
    atom_mask = _combined_mask(frontier, plan.src, edge_mask)
    return execute_tile_reduce(plan.spec, plan.part, atom_fn, torch.float32,
                               path=plan.path, combiner=combiner,
                               atom_mask=atom_mask)


def advance_push(plan: AdvancePlan, frontier: Optional[torch.Tensor],
                 atom_fn: Callable[[torch.Tensor], torch.Tensor], *,
                 combiner: str = "sum",
                 edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The push advance: ``atom_fn`` over out-edge atoms (forward order),
    masked to frontier sources, combined by destination; compacted when
    the plan has a capacity.  Same bits as the pull advance for min/max
    and exactly summable values."""
    atom_mask = _combined_mask(frontier, plan.push_src, edge_mask)
    return execute_scatter_reduce(plan.push_spec, plan.push_part, atom_fn,
                                  plan.dst, plan.num_vertices, torch.float32,
                                  path=plan.push_path, combiner=combiner,
                                  atom_mask=atom_mask,
                                  compact_capacity=plan.compact_capacity)


def _check_direction(direction: str) -> str:
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown direction: {direction!r} "
                         f"(expected one of {DIRECTIONS})")
    return direction


def advance_relax_min(plan: AdvancePlan, potentials: torch.Tensor,
                      frontier: Optional[torch.Tensor], *,
                      direction: str = "pull",
                      edges: str = "all") -> torch.Tensor:
    """SSSP relax (Listing 5): ``cand[v] = min over active edges (u, v) of
    potentials[u] + w(u, v)``, in either direction (min is exact, so both
    give the same bits); ``edges`` restricts to one side of the delta
    split."""
    edge_mask = plan.edge_set_mask(edges, _check_direction(direction))
    if direction == "push":
        src, w = plan.push_src, plan.push_weight
        return advance_push(plan, frontier,
                            lambda e: potentials[src[e]] + w[e],
                            combiner="min", edge_mask=edge_mask)
    src, w = plan.src, plan.weight
    return advance(plan, frontier, lambda e: potentials[src[e]] + w[e],
                   combiner="min", edge_mask=edge_mask)


def advance_frontier(plan: AdvancePlan, frontier: torch.Tensor, *,
                     direction: str = "pull") -> torch.Tensor:
    """Scatter-or: which destinations have at least one active edge."""
    unit = lambda e: torch.ones(e.shape, dtype=torch.float32,
                                device=e.device)
    if _check_direction(direction) == "push":
        reached = advance_push(plan, frontier, unit, combiner="max")
    else:
        reached = advance(plan, frontier, unit, combiner="max")
    return reached > 0.0


def advance_src_argmin(plan: AdvancePlan, frontier: torch.Tensor, *,
                       direction: str = "pull") -> torch.Tensor:
    """Smallest active in-neighbour per destination (BFS parents), ``-1``
    where none; ids reduce exactly as f32 below 2**24 vertices."""
    if plan.num_vertices >= (1 << 24):
        raise ValueError(
            f"advance_src_argmin: vertex ids are reduced as f32, exact only "
            f"below 2**24 vertices (got {plan.num_vertices})")
    if _check_direction(direction) == "push":
        src = plan.push_src
        cand = advance_push(plan, frontier, lambda e: src[e].float(),
                            combiner="min")
    else:
        src = plan.src
        cand = advance(plan, frontier, lambda e: src[e].float(),
                       combiner="min")
    return torch.where(torch.isfinite(cand), cand, -1.0).to(torch.int32)


def frontier_filter(plan: AdvancePlan, frontier: torch.Tensor,
                    keep: Optional[torch.Tensor] = None, *,
                    direction: str = "pull") -> torch.Tensor:
    """The paper's ``filter``: next frontier = destinations of active edges
    that pass ``keep``."""
    nxt = advance_frontier(plan, frontier, direction=direction)
    if keep is not None:
        nxt = nxt & keep
    return nxt
