"""Data-centric graph algorithms on the load-balancing abstraction (§5.3).

BFS / SSSP / PageRank are frontier *advances*: atoms = edges, tiles =
vertices.  The topology is inspected once into an
:class:`~repro_torch.sparse.advance.AdvancePlan` (a pull/push pair); every
iteration runs the balanced advance through ``repro_torch.core.execute`` —
any schedule, either execution path.  Iterations are host loops, with one
device-to-host read per iteration (the termination test, fused with the
frontier's out-edge count that drives the direction switch).

**Direction optimization** (Beamer's push/pull switch): with
``direction="auto"`` BFS and SSSP push while the measured out-edge
fraction of the frontier is below the plan's ``direction_threshold`` and
pull above.  min/max are exact, so the direction never changes a bit.

**Delta-stepping** (:func:`delta_stepping`, ``sssp(algorithm="delta")``)
runs light/heavy-restricted advances over the same plan pair to the same
f32 fixed point as Bellman-Ford: the distances are bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ExecutionPath, Schedule
from repro_torch.sparse.advance import (AdvancePlan, advance,
                                        advance_frontier, advance_push,
                                        advance_relax_min,
                                        advance_src_argmin, build_advance)
from repro_torch.sparse.formats import CSR

#: Accepted ``direction=`` spellings for the traversal drivers.
_DRIVER_DIRECTIONS = ("auto", "pull", "push")

#: Accepted ``algorithm=`` spellings for :func:`sssp`.
_SSSP_ALGORITHMS = ("bellman_ford", "delta")

#: Bucket index standing in for +inf distances.
_FAR_BUCKET = 2 ** 30


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph as CSR adjacency; ``csr.values`` are edge weights."""

    csr: CSR

    @classmethod
    def from_dense(cls, w, *, device=None) -> "Graph":
        """Edge ``u -> v`` with weight ``w[u, v]`` wherever it is non-zero,
        on ``device`` (``None``: the card)."""
        return cls(CSR.from_dense(w, device=device))

    @property
    def device(self) -> torch.device:
        return self.csr.device

    @property
    def num_vertices(self) -> int:
        return self.csr.shape[0]

    @property
    def num_edges(self) -> int:
        return self.csr.nnz

    def edge_sources(self) -> torch.Tensor:
        """tile-of-atom: the paper's ``get_tile(edge)`` for every edge."""
        return self.csr.workspec().atom_tile_ids()

    def out_degrees(self) -> torch.Tensor:
        return self.csr.workspec().atoms_per_tile()

    def advance_plan(self, *, schedule: Schedule | str = "auto",
                     num_blocks: Optional[int] = None,
                     path: ExecutionPath | str = ExecutionPath.AUTO,
                     workload: str = "advance",
                     direction_threshold: Optional[float] = None
                     ) -> AdvancePlan:
        """One-time inspector: see :func:`build_advance`."""
        return build_advance(self, schedule=schedule, num_blocks=num_blocks,
                             path=path, workload=workload,
                             direction_threshold=direction_threshold)


def _resolve_plan(graph: Graph, plan: Optional[AdvancePlan], schedule,
                  num_blocks, path, workload: str = "advance", delta=None,
                  compact=None) -> AdvancePlan:
    if plan is not None:
        return plan
    return build_advance(graph, schedule=schedule, num_blocks=num_blocks,
                         path=path, workload=workload, delta=delta,
                         compact=compact)


def _check_driver_direction(direction: str) -> str:
    if direction not in _DRIVER_DIRECTIONS:
        raise ValueError(f"unknown direction: {direction!r} "
                         f"(expected one of {_DRIVER_DIRECTIONS})")
    return direction


def _validate_sources(sources, num_vertices: int, *,
                      what: str = "source") -> None:
    """Reject out-of-range traversal sources before the loop starts."""
    if isinstance(sources, torch.Tensor):
        sources = sources.cpu().numpy()
    arr = np.asarray(sources)
    if arr.size == 0:
        return
    if not np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.int64)
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0 or hi >= num_vertices:
        bad = arr[(arr < 0) | (arr >= num_vertices)]
        raise ValueError(
            f"{what} out of range for graph with {num_vertices} "
            f"vertices: {bad.reshape(-1)[:8].tolist()} (valid range "
            f"[0, {num_vertices - 1}])" if num_vertices else
            f"{what} {bad.reshape(-1)[:8].tolist()} on an empty graph "
            f"(no valid sources)")


def _active_edges(mask: torch.Tensor, out_degrees: torch.Tensor
                  ) -> torch.Tensor:
    """Out-edges leaving ``mask`` (a device scalar)."""
    return torch.where(mask, out_degrees, 0).sum()


def _read(*scalars: torch.Tensor) -> list:
    """One device-to-host transfer of several scalars."""
    return torch.stack([s.to(torch.int64) for s in scalars]).tolist()


def _use_push(plan: AdvancePlan, direction: str, active_edges: int) -> bool:
    """The per-iteration direction: requested, or measured density below
    the plan's modeled threshold (float32, as the reference compares)."""
    if direction != "auto":
        return direction == "push"
    return (np.float32(plan.edge_fraction(active_edges))
            < np.float32(plan.direction_threshold))


def _relax(plan: AdvancePlan, push: bool, dist: torch.Tensor,
           frontier: torch.Tensor, edges: str = "all") -> torch.Tensor:
    """One min-relax in the chosen direction; returns the new distances."""
    cand = advance_relax_min(plan, dist, frontier,
                             direction="push" if push else "pull",
                             edges=edges)
    return torch.minimum(dist, cand)


def _source_state(V: int, source: int, device):
    dist = torch.full((V,), float("inf"), dtype=torch.float32, device=device)
    dist[source] = 0.0
    mask = torch.zeros(V, dtype=torch.bool, device=device)
    mask[source] = True
    return dist, mask


def sssp(graph: Graph, source: int, *, max_iters: Optional[int] = None,
         schedule: Schedule | str = "auto",
         num_blocks: Optional[int] = None,
         path: ExecutionPath | str = ExecutionPath.AUTO,
         plan: Optional[AdvancePlan] = None,
         direction: str = "auto",
         algorithm: str = "bellman_ford",
         delta: Optional[float] = None,
         return_direction_counts: bool = False):
    """Single-source shortest path; distances ``[V]`` (inf = unreached).

    ``algorithm="bellman_ford"``: each iteration relaxes every edge whose
    source improved last round.  ``"delta"`` routes to
    :func:`delta_stepping`.  Both reach the same f32 fixed point, bit for
    bit.  ``return_direction_counts=True`` also returns int32 ``[2]``
    ``(push_iterations, pull_iterations)``.
    """
    _check_driver_direction(direction)
    if algorithm not in _SSSP_ALGORITHMS:
        raise ValueError(f"unknown algorithm: {algorithm!r} "
                         f"(expected one of {_SSSP_ALGORITHMS})")
    if algorithm == "delta":
        return delta_stepping(graph, source, delta=delta,
                              max_iters=max_iters, schedule=schedule,
                              num_blocks=num_blocks, path=path, plan=plan,
                              direction=direction,
                              return_direction_counts=return_direction_counts)
    V = graph.num_vertices
    _validate_sources(source, V)
    max_iters = V if max_iters is None else max_iters
    aplan = _resolve_plan(graph, plan, schedule, num_blocks, path)
    dist, frontier = _source_state(V, source, graph.device)
    iters = pushes = 0
    while iters < max_iters:
        nonempty, active = _read(frontier.any(),
                                 _active_edges(frontier, aplan.out_degrees))
        if not nonempty:
            break
        push = _use_push(aplan, direction, active)
        new_dist = _relax(aplan, push, dist, frontier)
        frontier = new_dist < dist
        dist = new_dist
        iters += 1
        pushes += push
    if return_direction_counts:
        return dist, torch.tensor([pushes, iters - pushes], dtype=torch.int32,
                                  device=dist.device)
    return dist


def _bucket_of(dist: torch.Tensor, delta: float) -> torch.Tensor:
    """floor(dist / delta) as int32; +inf (unreached) maps far away.  The
    float is clamped below 2**30 before the conversion (converting inf to
    an integer is undefined)."""
    b = torch.floor(dist / torch.tensor(delta, dtype=torch.float32,
                                        device=dist.device))
    b = torch.clamp(b, max=float(_FAR_BUCKET - 1))
    return torch.where(torch.isfinite(dist), b.to(torch.int32), _FAR_BUCKET)


def delta_stepping(graph: Graph, source: int, *,
                   delta: Optional[float] = None,
                   max_iters: Optional[int] = None,
                   schedule: Schedule | str = "auto",
                   num_blocks: Optional[int] = None,
                   path: ExecutionPath | str = ExecutionPath.AUTO,
                   plan: Optional[AdvancePlan] = None,
                   direction: str = "auto",
                   compact: Optional[bool | int | float] = True,
                   return_direction_counts: bool = False):
    """Delta-stepping SSSP (Meyer & Sanders) on the advance plan pair.

    The outer loop takes the lowest bucket (width ``delta``; default
    :func:`~repro_torch.sparse.advance.estimate_delta`) holding a vertex
    that needs relaxing; the inner loop relaxes its **light** edges until
    the bucket stops changing, then the **heavy** edges of everything the
    bucket settled are relaxed once.  Vertices re-enter whenever their
    distance improves, so the loops reach Bellman-Ford's fixed point: the
    distances are bit-identical to :func:`sssp` for every ``delta``.  If
    ``max_iters`` outer rounds (default ``V + 2``) run out with work left,
    plain frontier Bellman-Ford finishes it.

    ``compact=True`` builds the plan with gather-compacted push windows
    (the sparse bucket frontiers are their regime); with a prebuilt
    ``plan`` its own capacity governs.  ``return_direction_counts=True``
    also returns ``(push, pull)`` advance counts over all phases.
    """
    _check_driver_direction(direction)
    V = graph.num_vertices
    _validate_sources(source, V)
    aplan = _resolve_plan(graph, plan, schedule, num_blocks, path,
                          workload="advance_delta",
                          delta=delta if delta is not None else "auto",
                          compact=compact)
    if aplan.delta is None or (delta is not None
                               and float(delta) != aplan.delta):
        aplan = aplan.with_delta(delta)
    width = aplan.delta
    max_outer = (V + 2) if max_iters is None else max_iters
    inner_cap = V + 1
    light_out = aplan.light_out_degrees
    heavy_out = aplan.out_degrees - light_out

    # each phase's compaction capacity is clamped to its own edge subset
    # (the most its frontier can activate)
    light_plan = heavy_plan = aplan
    if aplan.compact_capacity is not None and aplan.num_edges:
        light_edges = int(light_out.sum())
        heavy_edges = aplan.num_edges - light_edges
        light_plan = aplan.with_compact_capacity(
            min(aplan.compact_capacity, max(light_edges, 1)))
        heavy_plan = aplan.with_compact_capacity(
            min(aplan.compact_capacity, max(heavy_edges, 1)))

    dist, needs = _source_state(V, source, graph.device)
    counts = [0, 0]                       # (push, pull) advances
    far = torch.tensor(_FAR_BUCKET, dtype=torch.int32, device=graph.device)
    outer = 0
    while outer < max_outer and bool(needs.any()):
        bucket = torch.where(needs, _bucket_of(dist, width), far).min()
        settled = torch.zeros(V, dtype=torch.bool, device=graph.device)
        for _ in range(inner_cap):
            frontier = needs & (_bucket_of(dist, width) == bucket)
            nonempty, active = _read(frontier.any(),
                                     _active_edges(frontier, light_out))
            if not nonempty:
                break
            push = _use_push(light_plan, direction, active)
            new_dist = _relax(light_plan, push, dist, frontier,
                              edges="light")
            needs = (needs & ~frontier) | (new_dist < dist)
            settled |= frontier
            dist = new_dist
            counts[0 if push else 1] += 1
        # heavy phase: every vertex the bucket settled relaxes its heavy
        # out-edges once (skipped when they have none)
        active_heavy = int(_active_edges(settled, heavy_out))
        if active_heavy > 0:
            push = _use_push(heavy_plan, direction, active_heavy)
            new_dist = _relax(heavy_plan, push, dist, settled,
                              edges="heavy")
            counts[0 if push else 1] += 1
            needs |= new_dist < dist
            dist = new_dist
        outer += 1

    # backstop: finish leftover work with frontier Bellman-Ford over all
    # edges (the same fixed point from any upper-bound state)
    for _ in range(V):
        nonempty, active = _read(needs.any(),
                                 _active_edges(needs, aplan.out_degrees))
        if not nonempty:
            break
        push = _use_push(aplan, direction, active)
        new_dist = _relax(aplan, push, dist, needs)
        needs = new_dist < dist
        dist = new_dist
        counts[0 if push else 1] += 1
    if return_direction_counts:
        return dist, torch.tensor(counts, dtype=torch.int32,
                                  device=dist.device)
    return dist


def bfs(graph: Graph, source: int, *, max_iters: Optional[int] = None,
        schedule: Schedule | str = "auto",
        num_blocks: Optional[int] = None,
        path: ExecutionPath | str = ExecutionPath.AUTO,
        plan: Optional[AdvancePlan] = None,
        return_parents: bool = False,
        direction: str = "auto",
        return_direction_counts: bool = False):
    """BFS depth labels ``[V]`` (-1 = unreached).

    ``return_parents=True`` also returns parents ``[V]`` (-1 at the source
    and unreached vertices): each newly reached vertex's smallest frontier
    in-neighbour, so ``depth[parent[v]] == depth[v] - 1``.
    ``direction="auto"`` is direction-optimizing;
    ``return_direction_counts=True`` appends int32 ``[2]``
    ``(push_iterations, pull_iterations)``.
    """
    _check_driver_direction(direction)
    V = graph.num_vertices
    _validate_sources(source, V)
    max_iters = V if max_iters is None else max_iters
    aplan = _resolve_plan(graph, plan, schedule, num_blocks, path)
    device = graph.device
    depth = torch.full((V,), -1, dtype=torch.int32, device=device)
    parent = torch.full((V,), -1, dtype=torch.int32, device=device)
    frontier = torch.zeros(V, dtype=torch.bool, device=device)
    if V:
        depth[source] = 0
        frontier[source] = True
    iters = pushes = 0
    while iters < max_iters:
        nonempty, active = _read(frontier.any(),
                                 _active_edges(frontier, aplan.out_degrees))
        if not nonempty:
            break
        push = _use_push(aplan, direction, active)
        way = "push" if push else "pull"
        if return_parents:
            # one advance does both jobs: cand >= 0 iff reached
            cand = advance_src_argmin(aplan, frontier, direction=way)
            newly = (cand >= 0) & (depth < 0)
            parent = torch.where(newly, cand, parent)
        else:
            newly = advance_frontier(aplan, frontier, direction=way) \
                & (depth < 0)
        depth = torch.where(newly, iters + 1, depth)
        frontier = newly
        iters += 1
        pushes += push
    out = (depth,)
    if return_parents:
        out += (parent,)
    if return_direction_counts:
        out += (torch.tensor([pushes, iters - pushes], dtype=torch.int32,
                             device=device),)
    return out[0] if len(out) == 1 else out


def _pagerank_share(pr: torch.Tensor, outdeg: torch.Tensor) -> torch.Tensor:
    """Degree-normalized contribution vector (dangling rows emit zero)."""
    return torch.where(outdeg > 0, pr / torch.clamp(outdeg, min=1.0), 0.0)


def _pagerank_update(contrib: torch.Tensor, dangling: torch.Tensor,
                     damping: float, V: int) -> torch.Tensor:
    """New rank vector, one individually rounded op at a time (eager
    PyTorch fuses nothing, which is what the reference pins with
    optimization barriers)."""
    total = contrib + dangling / V
    scaled = damping * total
    return (1.0 - damping) / V + scaled


def pagerank(graph: Graph, *, damping: float = 0.85, num_iters: int = 50,
             tol: float = 0.0,
             schedule: Schedule | str = "auto",
             num_blocks: Optional[int] = None,
             path: ExecutionPath | str = ExecutionPath.AUTO,
             plan: Optional[AdvancePlan] = None,
             direction: str = "auto") -> torch.Tensor:
    """Power-iteration PageRank ``[V]`` through the balanced advance.

    Each iteration is a full (unmasked) sum-advance — a pull SpMV of the
    degree-normalized adjacency.  Dangling mass is spread uniformly; stops
    early once the L1 step change is at most ``tol``.  ``"auto"`` is pull
    (the frontier is always full); ``"push"`` sums in another order.
    """
    _check_driver_direction(direction)
    direction = "pull" if direction == "auto" else direction
    V = graph.num_vertices
    if V == 0:
        return torch.zeros(0, dtype=torch.float32, device=graph.device)
    # the full-frontier sum-advance scores the plain "reduce" family
    aplan = _resolve_plan(graph, plan, schedule, num_blocks, path,
                          workload="reduce")
    outdeg = graph.out_degrees().to(torch.float32)
    src = aplan.push_src if direction == "push" else aplan.src
    pr = torch.full((V,), 1.0 / V, dtype=torch.float32, device=graph.device)
    for _ in range(num_iters):
        share = _pagerank_share(pr, outdeg)
        atom_fn = lambda e: share[src[e]]
        if direction == "push":
            contrib = advance_push(aplan, None, atom_fn, combiner="sum")
        else:
            contrib = advance(aplan, None, atom_fn, combiner="sum")
        dangling = torch.where(outdeg > 0, 0.0, pr).sum()
        new_pr = _pagerank_update(contrib, dangling, damping, V)
        step = float((new_pr - pr).abs().sum())
        pr = new_pr
        if not step > tol:
            break
    return pr
