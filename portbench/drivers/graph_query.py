"""Graph queries from one closed-loop client: the driver of every traffic
file whose ``driver`` is ``graph_query``.

Set-up makes the configuration's graph on the device from the seed
(``generators/<generator>.py``), hands it to the port as a
``repro_torch.sparse.Graph``, builds the advance plan once with the
traffic's ``schedule`` (``"auto"``: what a user gets by default) and runs
``warmup_units`` queries.  A unit is one query of the traffic's
``algorithm`` on that plan, synchronized.  Its work is the edges its
advances processed: the CSR's edge count for each advance, counted on the
card by the launches of K2 (``chunk_walk_tiles``).

Route check, per query: every advance launched K2 once and the ordered
fixup (``segment_sum_fixup``) once, and nothing else of the chunk walk; a
query whose route falls back counts as failed.  On the CPU (the tests) the
plain path has no launches: each query counts ``num_iters`` advances.

``correct``: once the window has closed and the program's state is freed,
the plain reference (``reference/pagerank.py``) runs in float64 on the
same CSR, and every answer of the window is held to it by its widest
relative gap, against the traffic's ``limits``.
"""
from __future__ import annotations

import contextlib
import time
from unittest import mock

import torch

from portbench.harness import spec
from portbench.reference import pagerank as ref

#: Launch counters that a pull PageRank advance must not move.
_OFF_ROUTE = ("chunk_walk_atoms", "chunk_walk_compact", "segment_sum_sorted",
              "spmv_merge_stream")

ALGORITHMS = ("pagerank",)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.kernels.spmv_merge import kernel as K
        from repro_torch.sparse import graph as G
        from repro_torch.sparse.advance import build_advance
        from repro_torch.sparse.formats import CSR

        if traffic["algorithm"] not in ALGORITHMS:
            raise spec.SpecError(f"graph_query runs {ALGORITHMS}, not "
                                 f"{traffic['algorithm']!r}")
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.traffic = traffic
        self.launches = K.LAUNCHES
        self.G = G
        t = time.perf_counter()
        data = spec.generator(config["generator"]).make(config, seed,
                                                        self.device)
        self.gen_s = time.perf_counter() - t
        self.offsets, self.cols = data["row_offsets"], data["col_indices"]
        self.V, self.E = data["num_vertices"], data["num_edges"]
        self.edge_tuples = data["edge_tuples"]
        ones = torch.ones(self.E, dtype=torch.float32, device=self.device)
        self.graph = G.Graph(CSR(self.offsets, self.cols, ones,
                                 (self.V, self.V), self.E))
        t = time.perf_counter()
        self.plan = build_advance(self.graph,
                                  schedule=traffic.get("schedule", "auto"),
                                  workload="reduce")
        self.plan_s = time.perf_counter() - t
        self.plan_name = f"{self.plan.schedule}/{self.plan.path}"
        self.kwargs = dict(damping=float(traffic["damping"]),
                           num_iters=int(traffic["num_iters"]),
                           tol=float(traffic["tol"]))
        for _ in range(int(traffic.get("warmup_units", 1))):
            self.run_unit()

    def describe(self) -> str:
        return (f"graph V={self.V} E={self.E} (from {self.edge_tuples} "
                f"tuples) generated in {self.gen_s:.3f} s; plan "
                f"{self.plan_name} built in "
                f"{self.plan_s:.3f} s")

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def run_unit(self) -> dict:
        before = dict(self.launches)
        t = time.perf_counter()
        answer = self.G.pagerank(self.graph, plan=self.plan, **self.kwargs)
        self._sync()
        latency = time.perf_counter() - t
        delta = {k: self.launches[k] - before[k] for k in self.launches}
        if self.on_card:
            advances = delta["chunk_walk_tiles"]
            route_ok = (1 <= advances <= self.kwargs["num_iters"]
                        and delta["segment_sum_fixup"] == advances
                        and not any(delta[k] for k in _OFF_ROUTE))
        else:
            advances, route_ok = self.kwargs["num_iters"], True
        return {"latency_s": latency, "answer": answer, "advances": advances,
                "work": self.E * advances, "route_ok": route_ok}

    def context(self) -> dict:
        """What the metric readers need of this cell's shapes."""
        return {"V": self.V, "E": self.E}

    def release(self) -> None:
        """Drop the program's state (the plan and the graph); the inputs
        and the answers stay for the comparison."""
        self.plan = self.graph = None

    def reference(self) -> torch.Tensor:
        return ref.pagerank(self.offsets, self.cols,
                            damping=self.kwargs["damping"],
                            num_iters=self.kwargs["num_iters"])

    def control(self) -> torch.Tensor:
        return ref.pagerank_tf32(self.offsets, self.cols,
                                 damping=self.kwargs["damping"],
                                 num_iters=self.kwargs["num_iters"])

    def judge(self, records: list):
        """``(checks, bad)``: each number compared with its limit, and for
        each record whether it failed."""
        want = self.reference()
        limit = float(self.traffic["limits"]["rank_gap"])
        gaps = [ref.rank_gap(r["answer"], want) for r in records]
        worst = max(gaps) if gaps else float("inf")
        bad = [not (g <= limit and r["route_ok"])
               for g, r in zip(gaps, records)]
        return [{"name": "rank_gap", "value": worst, "limit": limit}], bad

    def control_reading(self) -> float:
        return ref.rank_gap(self.control(), self.reference())


@contextlib.contextmanager
def fault(name: str):
    """The program's query broken in one of the ways ``correct`` must
    catch: ``state_unchanged`` (no iteration runs: the initial ranks come
    back), ``half_batch`` (every advance sums the odd edges' half alone and
    doubles it), ``altered_answer`` (one vertex's rank off by 1%)."""
    from repro_torch.sparse import graph as G
    orig_pagerank, orig_advance = G.pagerank, G.advance

    def unchanged(graph, **kw):
        return orig_pagerank(graph, **dict(kw, num_iters=0))

    def half(aplan, frontier, atom_fn, **kw):
        return orig_advance(aplan, frontier, lambda e: torch.where(
            e % 2 == 0, 2.0 * atom_fn(e), 0.0), **kw)

    def altered(graph, **kw):
        pr = orig_pagerank(graph, **kw).clone()
        pr[0] *= 1.01
        return pr

    patches = {"state_unchanged": ("pagerank", unchanged),
               "half_batch": ("advance", half),
               "altered_answer": ("pagerank", altered)}
    attr, fn = patches[name]
    with mock.patch.object(G, attr, fn):
        yield


FAULTS = ("state_unchanged", "half_batch", "altered_answer")
