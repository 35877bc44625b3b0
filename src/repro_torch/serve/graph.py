"""Continuous-batching graph-query serving over one ``AdvancePlan`` pair.

:func:`~repro_torch.sparse.graph.bfs_multi` runs identical queries; real
traffic is a stream of mixed BFS / SSSP / PageRank queries with arbitrary
sources, arriving and finishing at different times.  One
:class:`GraphServer` holds a plan pair built once per graph and a
:class:`QueryBatch` of fixed lane width ``W`` (per-lane traversal state on
the device); each :meth:`GraphServer.tick` retires converged lanes,
backfills free ones from a FIFO queue, and advances every occupied lane
one iteration.  Admission, retirement and backfill are tensor writes into
the batch: its shapes never change.

* **Unified lanes.**  BFS is unit-weight Bellman-Ford, so BFS and SSSP
  lanes share one min-relax whose edge weight is ``1.0`` on BFS lanes;
  PageRank lanes run the driver's power-iteration body.  A lane's ``[V]``
  value row holds its tentative distances or its rank vector.
* **One launch per kind.**  The pull relax of every BFS/SSSP lane is one
  ``chunk_walk_tiles`` launch on the card, each lane's frontier folded
  into its atom values as the ``min`` identity; the PageRank lanes' sums
  are a second launch, with one ordered fixup.  Both lay their lanes end
  to end through the one-column kernel
  (:class:`~repro_torch.core.execute.LaneLayout`, built once per server),
  so each lane keeps the bits of its single-query call.  Lanes that
  choose push (``direction="push"``, or ``"auto"`` below the plan's
  threshold) run one push advance each.  A kind with no occupied lane is
  skipped on the host's lane table, not on a device read.
* **Driver-exact answers.**  Each lane replays its single-query driver's
  loop body over the same plan, so a retired answer equals
  :func:`~repro_torch.sparse.graph.bfs` / ``sssp`` / ``pagerank`` bitwise
  (PageRank's two per-lane sums go through the driver's own helpers on
  each lane's contiguous row).
* **Host reads.**  One small transfer a tick (the lanes' ``done`` flags,
  iteration and push counts, and the measured frontier densities that
  ``"auto"`` switches on); retired lanes' rows are read back, and only
  theirs, through a pinned buffer.
* **Build once.**  The step and admit functions are built once per server
  (:attr:`GraphServer.step_traces` / :attr:`GraphServer.admit_traces`
  count the builds and stay 1 over any stream).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ExecutionPath, Schedule
from repro_torch.core.execute import LaneLayout
from repro_torch.sparse.advance import (AdvancePlan, advance_push,
                                        build_advance)
from repro_torch.sparse.graph import (Graph, _gather_rows, _pagerank_change,
                                      _pagerank_dangling, _pagerank_share,
                                      _pagerank_update, _use_push,
                                      _validate_sources)

__all__ = ["KIND_BFS", "KIND_SSSP", "KIND_PAGERANK", "QueryBatch",
           "ServedResult", "GraphServer"]

KIND_BFS = 0
KIND_SSSP = 1
KIND_PAGERANK = 2

_KIND_CODES = {"bfs": KIND_BFS, "sssp": KIND_SSSP, "pagerank": KIND_PAGERANK}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}

_INF = float("inf")


def _relax_lanes(plan: AdvancePlan, layout: LaneLayout, value: torch.Tensor,
                 frontier: torch.Tensor, unit: Sequence[bool],
                 finite: bool) -> torch.Tensor:
    """B pull min-relaxes in one launch: row ``j`` of the ``[B, V]``
    result is ``advance_relax_min(plan, value[j], frontier[j])`` with unit
    edge weights where ``unit[j]`` (BFS as unit-weight Bellman-Ford),
    bitwise.

    A masked atom must give the identity ``+inf``: its lane's table entry
    is ``+inf`` (a frontier vertex never holds ``+inf``, it just improved),
    which adding a finite weight keeps; unless ``finite`` (every weight
    finite), the entries that came from ``+inf`` are set back to ``+inf``
    after the add.
    """
    tables = torch.where(frontier, value, _INF)

    def fill(out: torch.Tensor) -> None:
        _gather_rows(out, tables, plan.src)
        for row, u in zip(out, unit):
            if u:
                row.add_(1.0)
            elif finite:
                row.add_(plan.weight)
            else:
                masked = row == _INF
                row.add_(plan.weight)
                row.masked_fill_(masked, _INF)

    return layout.reduce(len(unit), fill, combiner="min").t()


class QueryBatch(NamedTuple):
    """Fixed-width lane state on the device: every field is ``[W]`` or
    ``[W, V]``.

    ``value`` is each lane's answer row (tentative distances, ``inf`` =
    unreached, or the rank vector); ``active`` marks occupied lanes,
    ``done`` converged ones awaiting retirement; ``active_edges`` is the
    measured frontier out-edge count (read by ``direction="auto"``);
    ``delta`` the PageRank L1 step change; ``pushes`` the push-direction
    advances a lane ran.
    """

    kind: torch.Tensor          # [W] int32: KIND_BFS / KIND_SSSP / ...
    source: torch.Tensor        # [W] int32 (ignored by PageRank lanes)
    qid: torch.Tensor           # [W] int32 (-1 = free lane)
    active: torch.Tensor        # [W] bool
    done: torch.Tensor          # [W] bool
    iters: torch.Tensor         # [W] int32
    value: torch.Tensor         # [W, V] float32
    frontier: torch.Tensor      # [W, V] bool (BFS/SSSP lanes)
    active_edges: torch.Tensor  # [W] int32
    delta: torch.Tensor         # [W] float32
    pushes: torch.Tensor        # [W] int32


@dataclasses.dataclass(frozen=True)
class ServedResult:
    """One retired query: the answer plus serving metadata."""

    qid: int
    kind: str                # "bfs" | "sssp" | "pagerank"
    source: int
    value: np.ndarray        # bfs: int32 depths; sssp/pagerank: float32 [V]
    iterations: int          # traversal iterations the lane ran
    pushes: int              # push-direction advances the lane ran
    submitted_at: float      # perf_counter timestamps
    admitted_at: float
    completed_at: float

    @property
    def latency(self) -> float:
        """Submit-to-completion wall-clock seconds (queueing included)."""
        return self.completed_at - self.submitted_at


@dataclasses.dataclass
class _Pending:
    kind_code: int
    source: int
    submitted_at: float
    admitted_at: float = 0.0


class GraphServer:
    """Continuous-batching server for graph queries over one plan pair.

    Parameters mirror the single-query drivers.  ``schedule="auto"`` scores
    the ``"advance_serve"`` workload family (its own cache namespace;
    ``measure=`` as in :func:`~repro_torch.sparse.advance.build_advance`);
    ``direction`` orients the BFS/SSSP lanes (``"pull"`` by default: the
    batched advance); ``max_iters``/``damping``/``num_iters``/``tol`` are
    the drivers' convergence rules.  The batch lives on the graph's device.

    Host API::

        srv = GraphServer(graph, lanes=8)
        qid = srv.submit("bfs", source=3)
        results = srv.drain()          # or: srv.tick() per arrival slot
    """

    def __init__(self, graph: Graph, *, lanes: int = 8,
                 plan: Optional[AdvancePlan] = None,
                 schedule: Schedule | str = "auto",
                 num_blocks: Optional[int] = None,
                 path: ExecutionPath | str = ExecutionPath.AUTO,
                 direction: str = "pull",
                 max_iters: Optional[int] = None,
                 damping: float = 0.85, num_iters: int = 50,
                 tol: float = 0.0,
                 measure=None):
        if graph.num_vertices == 0:
            raise ValueError("GraphServer needs a non-empty graph "
                             "(no valid query sources on 0 vertices)")
        if lanes < 1:
            raise ValueError(f"lane width must be >= 1, got {lanes}")
        if direction not in ("pull", "push", "auto"):
            raise ValueError(f"unknown direction: {direction!r} "
                             f"(expected 'pull', 'push' or 'auto')")
        self.graph = graph
        self.lanes = int(lanes)
        self.direction = direction
        self.plan = plan if plan is not None else build_advance(
            graph, schedule=schedule, num_blocks=num_blocks, path=path,
            workload="advance_serve", measure=measure)
        V = graph.num_vertices
        self._V = V
        self.max_iters = V if max_iters is None else int(max_iters)
        self.damping = float(damping)
        self.num_iters = int(num_iters)
        self.tol = float(tol)

        # -- host bookkeeping ---------------------------------------------
        self._queue: Deque[int] = deque()          # qids awaiting a lane
        self._pending: Dict[int, _Pending] = {}    # qid -> submit metadata
        self._lane_qid = np.full(self.lanes, -1, np.int64)
        self._lane_kind = np.zeros(self.lanes, np.int64)
        self._lane_edges = np.zeros(self.lanes, np.int64)
        self._retired_lanes: List[int] = []
        # "auto" decides each lane's direction on the host: an admitted
        # lane's frontier is its source, whose out-degree the host holds
        self._out_degrees = (self.plan.out_degrees.cpu().numpy()
                             if direction == "auto" else None)
        self._next_qid = 0
        self.steps = 0            # serving steps executed
        self.served = 0           # queries retired
        self._step_traces: List[float] = []   # appended at build time
        self._admit_traces: List[float] = []

        self.batch = self._empty_batch()
        # host buffer that retired rows come back through (card only)
        self._staging = (torch.empty((self.lanes, V), dtype=torch.float32,
                                     pin_memory=True)
                         if self.graph.device.type == "cuda" else None)
        self._step = self._make_step()
        self._admit = self._make_admit()

    # -- construction helpers ---------------------------------------------

    def _empty_batch(self) -> QueryBatch:
        W, V, dev = self.lanes, self._V, self.graph.device
        i32 = dict(dtype=torch.int32, device=dev)
        return QueryBatch(
            kind=torch.zeros(W, **i32),
            source=torch.zeros(W, **i32),
            qid=torch.full((W,), -1, **i32),
            active=torch.zeros(W, dtype=torch.bool, device=dev),
            done=torch.zeros(W, dtype=torch.bool, device=dev),
            iters=torch.zeros(W, **i32),
            value=torch.zeros((W, V), dtype=torch.float32, device=dev),
            frontier=torch.zeros((W, V), dtype=torch.bool, device=dev),
            active_edges=torch.zeros(W, **i32),
            delta=torch.full((W,), _INF, dtype=torch.float32, device=dev),
            pushes=torch.zeros(W, **i32))

    def _make_step(self):
        self._step_traces.append(time.perf_counter())
        plan, V, dev = self.plan, self._V, self.graph.device
        max_iters, num_iters = self.max_iters, self.num_iters
        damping, tol = self.damping, self.tol
        track_edges = self.direction == "auto"
        outdeg = plan.out_degrees.to(torch.float32)
        src, psrc = plan.src, plan.push_src
        lane_index = lambda lanes: torch.tensor(lanes, dtype=torch.int64,
                                                device=dev)

        layout = LaneLayout(plan.spec, plan.part, self.lanes,
                            path=plan.path)
        # +inf + w stays +inf for a finite weight: only non-finite weights
        # need the masked atoms set back (one host read, at build time)
        finite = bool(torch.isfinite(plan.weight).all())

        def relax(b: QueryBatch, lanes: Sequence[int], kinds: Sequence[int],
                  push: Sequence[int]) -> None:
            # BFS/SSSP lanes: the pull ones in one launch, each push one on
            # its own (the drivers' relax, bit for bit)
            pull = [j for j in lanes if j not in push]
            if pull:
                idx = lane_index(pull)
                value, frontier = b.value[idx], b.frontier[idx]
                unit = [kinds[j] == KIND_BFS for j in pull]
                cand = _relax_lanes(plan, layout, value, frontier, unit,
                                    finite)
                new = torch.minimum(value, cand)
                b.frontier[idx] = new < value
                b.value[idx] = new
            for j in push:
                value, frontier = b.value[j], b.frontier[j]
                if kinds[j] == KIND_BFS:
                    atom = lambda e: value[psrc[e]] + 1.0
                else:
                    atom = lambda e: value[psrc[e]] + plan.push_weight[e]
                cand = advance_push(plan, frontier, atom, combiner="min")
                new = torch.minimum(value, cand)
                b.frontier[j] = new < value
                b.value[j] = new
            idx = lane_index(lanes)
            if push:
                b.pushes[lane_index(push)] += 1
            if track_edges:
                b.active_edges[idx] = torch.where(
                    b.frontier[idx], plan.out_degrees, 0).sum(1).to(
                        torch.int32)
            b.done[idx] = ((~b.frontier[idx].any(1))
                           | (b.iters[idx] >= max_iters))

        def power_iteration(b: QueryBatch, lanes: Sequence[int]) -> None:
            # PageRank lanes: the driver's pull body, all lanes in one
            # launch that keeps each lane's bits; the two sums per lane on
            # its own contiguous row
            idx = lane_index(lanes)
            pr = b.value[idx]                                   # [B, V]
            share = _pagerank_share(pr, outdeg)
            contrib = layout.reduce(
                len(lanes), lambda out: _gather_rows(out, share, src),
                combiner="sum")
            del share
            dangling = torch.stack([_pagerank_dangling(row, outdeg)
                                    for row in pr])
            new = _pagerank_update(contrib.t().contiguous(),
                                   dangling[:, None], damping, V)
            change = torch.stack([_pagerank_change(n, p)
                                  for n, p in zip(new, pr)])
            b.value[idx] = new
            b.delta[idx] = change
            # the driver's `not step > tol`, compared in double as the
            # host compares a Python float
            b.done[idx] = ((~(change.double() > tol))
                           | (b.iters[idx] >= num_iters))

        def step(b: QueryBatch, kinds: Sequence[int], dist: Sequence[int],
                 ranks: Sequence[int], push: Sequence[int]) -> QueryBatch:
            b.iters[lane_index(list(dist) + list(ranks))] += 1
            if dist:
                relax(b, dist, kinds, push)
            if ranks:
                power_iteration(b, ranks)
            return b

        return step

    def _make_admit(self):
        self._admit_traces.append(time.perf_counter())
        V, dev = self._V, self.graph.device

        def admit(b: QueryBatch, clear: Sequence[int], take: Sequence[int],
                  kind: Sequence[int], source: Sequence[int],
                  qid: Sequence[int]) -> QueryBatch:
            # clear: retired lanes to free; take: lanes to (re)initialize
            # from kind/source/qid.  Content writes only.
            if clear:
                idx = torch.tensor(clear, dtype=torch.int64, device=dev)
                b.qid[idx] = -1
                b.active[idx] = False
                b.done[idx] = False
            if not take:
                return b
            idx = torch.tensor(take, dtype=torch.int64, device=dev)
            k = len(take)
            is_pr = torch.tensor([c == KIND_PAGERANK for c in kind],
                                 device=dev)
            dist_rows = [i for i, c in enumerate(kind)
                         if c != KIND_PAGERANK]
            dist_src = torch.tensor([source[i] for i in dist_rows],
                                    dtype=torch.int64, device=dev)
            dist_rows = torch.tensor(dist_rows, dtype=torch.int64,
                                     device=dev)
            value = torch.where(
                is_pr[:, None],
                torch.full((k, V), 1.0 / V, dtype=torch.float32,
                           device=dev),
                torch.full((k, V), _INF, dtype=torch.float32, device=dev))
            value[dist_rows, dist_src] = 0.0
            frontier = torch.zeros((k, V), dtype=torch.bool, device=dev)
            frontier[dist_rows, dist_src] = True
            as_i32 = lambda x: torch.tensor(x, dtype=torch.int32,
                                            device=dev)
            b.kind[idx] = as_i32(kind)
            b.source[idx] = as_i32(source)
            b.qid[idx] = as_i32(qid)
            b.active[idx] = True
            b.done[idx] = False
            b.iters[idx] = 0
            b.value[idx] = value
            b.frontier[idx] = frontier
            if self._out_degrees is not None:
                b.active_edges[idx] = as_i32(
                    [0 if c == KIND_PAGERANK else self._out_degrees[s]
                     for c, s in zip(kind, source)])
            b.delta[idx] = _INF
            b.pushes[idx] = 0
            return b

        return admit

    # -- build counters (the build-once contract) --------------------------

    @property
    def step_traces(self) -> int:
        """Times the serving step has been built (stays 1)."""
        return len(self._step_traces)

    @property
    def admit_traces(self) -> int:
        """Times the admit function has been built (stays 1)."""
        return len(self._admit_traces)

    # -- host-side serving loop -------------------------------------------

    @property
    def queued(self) -> int:
        """Queries waiting for a lane."""
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        """Queries occupying lanes (running or awaiting retirement)."""
        return int((self._lane_qid >= 0).sum())

    def submit(self, kind: str, source: int = 0) -> int:
        """Enqueue one query; returns its qid.  Callable at any time."""
        if kind not in _KIND_CODES:
            raise ValueError(f"unknown query kind: {kind!r} "
                             f"(expected one of {sorted(_KIND_CODES)})")
        if kind != "pagerank":
            _validate_sources(source, self._V,
                              what=f"{kind} query source")
        qid = self._next_qid
        self._next_qid += 1
        self._pending[qid] = _Pending(_KIND_CODES[kind], int(source),
                                      time.perf_counter())
        self._queue.append(qid)
        return qid

    def _retire(self) -> List[ServedResult]:
        """Read converged lanes off the device and free them (host side):
        one transfer of the per-lane flags, then the retired rows."""
        occupied = self._lane_qid >= 0
        if not occupied.any():
            return []
        b = self.batch
        flags = torch.stack([b.done.to(torch.int64), b.iters.to(torch.int64),
                             b.pushes.to(torch.int64),
                             b.active_edges.to(torch.int64)]).cpu().numpy()
        self._lane_edges = flags[3]
        done = (flags[0] > 0) & occupied
        if not done.any():
            return []
        lanes = np.nonzero(done)[0]
        rows = b.value[torch.from_numpy(lanes).to(b.value.device)]
        if self._staging is None:
            rows = rows.numpy()
        else:
            # through pinned memory: a pageable copy runs at a tenth of
            # the rate
            staged = self._staging[:len(lanes)]
            staged.copy_(rows)
            rows = staged.numpy().copy()
        now = time.perf_counter()
        results = []
        for row, lane in zip(rows, lanes):
            qid = int(self._lane_qid[lane])
            meta = self._pending.pop(qid)
            if meta.kind_code == KIND_BFS:
                # integer-valued unit-weight distances -> the driver's
                # int32 depth labels (-1 = unreached); exact below 2**24
                out = np.where(np.isfinite(row), row, -1.0).astype(np.int32)
            else:
                out = row
            results.append(ServedResult(
                qid=qid, kind=_KIND_NAMES[meta.kind_code],
                source=meta.source, value=out,
                iterations=int(flags[1][lane]), pushes=int(flags[2][lane]),
                submitted_at=meta.submitted_at,
                admitted_at=meta.admitted_at, completed_at=now))
            self._lane_qid[lane] = -1
        self.served += len(results)
        self._retired_lanes = [int(lane) for lane in lanes]
        return results

    def tick(self) -> List[ServedResult]:
        """One serving slot: retire converged lanes, backfill from the
        queue, advance every occupied lane one iteration.  Returns the
        queries retired this tick."""
        results = self._retire()
        clear, self._retired_lanes = self._retired_lanes, []

        take, kind, source, qid = [], [], [], []
        now = time.perf_counter()
        for lane in np.nonzero(self._lane_qid < 0)[0]:
            if not self._queue:
                break
            q = self._queue.popleft()
            meta = self._pending[q]
            meta.admitted_at = now
            take.append(int(lane))
            kind.append(meta.kind_code)
            source.append(meta.source)
            qid.append(q)
            self._lane_qid[lane] = q
            self._lane_kind[lane] = meta.kind_code
            if self._out_degrees is not None:
                self._lane_edges[lane] = (
                    0 if meta.kind_code == KIND_PAGERANK
                    else int(self._out_degrees[meta.source]))

        if clear or take:
            self.batch = self._admit(self.batch, clear, take, kind, source,
                                     qid)
        occupied = [int(j) for j in np.nonzero(self._lane_qid >= 0)[0]]
        if occupied:
            kinds = [int(k) for k in self._lane_kind]
            dist = [j for j in occupied if kinds[j] != KIND_PAGERANK]
            ranks = [j for j in occupied if kinds[j] == KIND_PAGERANK]
            push = [j for j in dist if _use_push(
                self.plan, self.direction, int(self._lane_edges[j]))]
            self.batch = self._step(self.batch, kinds, dist, ranks, push)
            self.steps += 1
        return results

    def drain(self) -> List[ServedResult]:
        """Tick until the queue and every lane are empty; returns all
        queries retired during the drain, in retirement order."""
        results: List[ServedResult] = []
        while self._queue or (self._lane_qid >= 0).any():
            results.extend(self.tick())
        return results

    def serve(self, queries) -> Dict[int, ServedResult]:
        """Submit ``(kind, source)`` pairs (source optional for
        ``"pagerank"``), drain, return results by qid."""
        for q in queries:
            if isinstance(q, str):
                self.submit(q)
            else:
                self.submit(*q)
        return {r.qid: r for r in self.drain()}
