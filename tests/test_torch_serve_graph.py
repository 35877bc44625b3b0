"""Port parity: continuous-batching graph serving and ``bfs_multi``.

The reference's serving contract (``tests/test_serve_graph.py``), held by
the port: every retired answer carries the bits of the port's
single-query driver on the same plan, whatever the admission order, lane
width, kind mix or retire/backfill boundaries, and one build of the step
and admit functions serves every stream.  Beside it: the port's server
against the reference's ``GraphServer`` on the same graph and stream
(BFS/SSSP bitwise, PageRank within rtol 1e-5, the tolerance of
``test_torch_graph_live.py``), ``bfs_multi`` against the reference's and
the port's ``bfs``, the launch counts of the batched advance (the
executors' kernel entry, on its plain version here), and the launcher.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.kernels.spmv_merge import kernel as TK
from repro_torch.serve.graph import (KIND_BFS, KIND_PAGERANK, KIND_SSSP,
                                     GraphServer, QueryBatch)
from repro_torch.sparse import bfs, bfs_multi, pagerank, sssp

from _conformance import powerlaw_graph_dense
from _torch_parity import graph_of, medium_source, np_of, reference_modules
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)

PR_RTOL = 1e-5


def _dense(seed=0, V=20, density=0.18):
    rng = np.random.default_rng(seed)
    w = np.where(rng.random((V, V)) < density,
                 rng.random((V, V)).astype(np.float32) + 0.1,
                 0.0).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    return w


def _graph(seed=0, V=20, density=0.18):
    return graph_of(_dense(seed, V, density))


def _driver_answer(g, plan, kind, source, direction="pull"):
    if kind == "bfs":
        return np_of(bfs(g, source, plan=plan, direction=direction))
    if kind == "sssp":
        return np_of(sssp(g, source, plan=plan, direction=direction))
    return np_of(pagerank(g, plan=plan))


def _split(q):
    return (q, 0) if isinstance(q, str) else q


def _submit_all(srv, queries):
    return [srv.submit(*_split(q)) for q in queries]


def _assert_bitwise(server, results, queries, qids, direction="pull"):
    g = server.graph
    for qid, q in zip(qids, queries):
        kind, source = _split(q)
        got = np.asarray(results[qid].value)
        want = _driver_answer(g, server.plan, kind, source, direction)
        assert got.dtype == want.dtype, (kind, got.dtype, want.dtype)
        np.testing.assert_array_equal(
            got.view(np.uint32) if got.dtype == np.float32 else got,
            want.view(np.uint32) if want.dtype == np.float32 else want,
            err_msg=f"qid {qid} kind {kind} source {source}")


MIXED = [("bfs", 5), ("sssp", 2), "pagerank", ("bfs", 0),
         "pagerank", ("sssp", 7), ("bfs", 11)]


class TestBitwiseIdentity:
    @pytest.mark.parametrize("schedule,path", [("auto", "auto"),
                                               ("chunked_lpt", "native"),
                                               ("merge_path", "pure")])
    def test_mixed_stream_matches_drivers(self, schedule, path):
        srv = GraphServer(_graph(), lanes=3, schedule=schedule, path=path)
        qids = _submit_all(srv, MIXED)
        results = {r.qid: r for r in srv.drain()}
        assert len(results) == len(MIXED)
        _assert_bitwise(srv, results, MIXED, qids)

    @pytest.mark.parametrize("order", [
        list(range(7)), list(reversed(range(7))), [3, 0, 6, 2, 5, 1, 4]])
    def test_admission_order_invariant(self, order):
        srv = GraphServer(_graph(seed=1), lanes=2)
        queries = [MIXED[i] for i in order]
        qids = _submit_all(srv, queries)
        results = {r.qid: r for r in srv.drain()}
        _assert_bitwise(srv, results, queries, qids)

    @pytest.mark.parametrize("lanes", [1, 2, 7, 16])
    def test_lane_width_invariant(self, lanes):
        srv = GraphServer(_graph(seed=2), lanes=lanes)
        qids = _submit_all(srv, MIXED)
        results = {r.qid: r for r in srv.drain()}
        _assert_bitwise(srv, results, MIXED, qids)

    def test_more_queries_than_lanes_backfills(self):
        srv = GraphServer(_graph(seed=3, V=16), lanes=2)
        queries = [("bfs", i) for i in range(5)] + \
                  [("sssp", i) for i in range(5)] + ["pagerank", "pagerank"]
        qids = _submit_all(srv, queries)
        results = {r.qid: r for r in srv.drain()}
        assert len(results) == 12 and srv.served == 12
        _assert_bitwise(srv, results, queries, qids)

    def test_staggered_arrivals_mid_flight(self):
        srv = GraphServer(_graph(seed=4), lanes=2)
        queries = [("bfs", 3), ("sssp", 1), "pagerank", ("bfs", 9)]
        qids, results = [], {}
        for q in queries:
            qids.append(srv.submit(*_split(q)))
            for r in srv.tick():
                results[r.qid] = r
        for r in srv.drain():
            results[r.qid] = r
        _assert_bitwise(srv, results, queries, qids)

    @pytest.mark.parametrize("direction", ["auto", "push"])
    def test_direction_matches_the_driver(self, direction):
        # "auto" switches per lane on the measured density (a medium-degree
        # source of a power-law graph runs both ways); min is exact in both
        # directions, so the bits match the driver's
        w = powerlaw_graph_dense(48)
        src = medium_source(w)
        srv = GraphServer(graph_of(w), lanes=2, direction=direction,
                          num_blocks=8)
        queries = [("bfs", src), ("sssp", src), "pagerank", ("bfs", 0)]
        qids = _submit_all(srv, queries)
        results = {r.qid: r for r in srv.drain()}
        _assert_bitwise(srv, results, queries, qids, direction=direction)
        first = results[qids[0]]
        assert 0 < first.pushes
        if direction == "push":
            assert first.pushes == first.iterations
        else:
            assert first.pushes < first.iterations
        assert results[qids[2]].pushes == 0

    def test_unreached_and_odd_weights(self):
        # a vertex with no in-edge stays unreached (-1 / inf), and an edge
        # of weight -inf leaves no NaN in masked atoms
        w = _dense(seed=6)
        w[:, 19] = 0.0
        w[3, 4] = -np.inf
        g = graph_of(w)
        srv = GraphServer(g, lanes=2, schedule="chunked_lpt")
        queries = [("bfs", 1), ("sssp", 1), ("sssp", 7)]
        qids = _submit_all(srv, queries)
        results = {r.qid: r for r in srv.drain()}
        _assert_bitwise(srv, results, queries, qids)
        assert results[qids[0]].value[19] == -1


class TestLifecycle:
    def test_empty_stream(self):
        srv = GraphServer(_graph(), lanes=2)
        assert srv.drain() == []
        assert srv.serve([]) == {}
        assert srv.steps == 0 and srv.served == 0

    def test_single_build_across_whole_stream(self):
        srv = GraphServer(_graph(seed=6), lanes=2)
        srv.serve(MIXED)
        assert srv.step_traces == 1, "serving step rebuilt"
        assert srv.admit_traces == 1, "admit rebuilt"

    def test_single_build_across_separate_streams(self):
        srv = GraphServer(_graph(seed=7), lanes=2)
        srv.serve([("bfs", 1), "pagerank"])
        srv.serve([("sssp", 4), ("bfs", 8)])
        assert srv.step_traces == 1 and srv.admit_traces == 1

    def test_queue_and_flight_accounting(self):
        srv = GraphServer(_graph(seed=8), lanes=2)
        for q in [("bfs", 0), ("bfs", 1), ("bfs", 2)]:
            srv.submit(*q)
        assert srv.queued == 3 and srv.in_flight == 0
        srv.tick()
        assert srv.queued == 1 and srv.in_flight == 2
        srv.drain()
        assert srv.queued == 0 and srv.in_flight == 0

    def test_result_metadata(self):
        srv = GraphServer(_graph(seed=9), lanes=1)
        (r,) = srv.serve([("sssp", 3)]).values()
        assert r.kind == "sssp" and r.source == 3
        assert r.iterations >= 1 and r.pushes == 0
        assert r.completed_at >= r.admitted_at >= r.submitted_at
        assert r.latency >= 0.0

    def test_bfs_depths_are_int32(self):
        srv = GraphServer(_graph(seed=10), lanes=1)
        (r,) = srv.serve([("bfs", 0)]).values()
        assert r.value.dtype == np.int32

    def test_batch_fields(self):
        srv = GraphServer(_graph(seed=11), lanes=3)
        srv.submit("bfs", 1)
        srv.submit("pagerank")
        srv.tick()
        b = srv.batch
        assert isinstance(b, QueryBatch)
        assert b.value.shape == (3, 20) and b.frontier.dtype == torch.bool
        assert b.kind.tolist()[:2] == [KIND_BFS, KIND_PAGERANK]
        assert b.qid.tolist() == [0, 1, -1]
        assert b.active.tolist() == [True, True, False]
        assert b.iters.tolist() == [1, 1, 0]
        assert KIND_SSSP not in b.kind.tolist()[:2]

    def test_submit_validates(self):
        srv = GraphServer(_graph(), lanes=1)
        with pytest.raises(ValueError):
            srv.submit("pagerankk")
        with pytest.raises(ValueError):
            srv.submit("bfs", source=10_000)

    def test_constructor_validates(self):
        with pytest.raises(ValueError):
            GraphServer(_graph(), lanes=0)
        with pytest.raises(ValueError):
            GraphServer(_graph(), direction="sideways")
        with pytest.raises(ValueError):
            GraphServer(graph_of(np.zeros((0, 0), np.float32)))


def _count_tiles_calls(monkeypatch, num_chunks):
    """Count the native executors' tiles-mode kernel calls (the plain
    version runs on CPU tensors; on the card each call is one launch) and
    the columns or lanes each carries."""
    calls = []
    real = TK.chunk_walk_reduce

    def counted(*args, **kw):
        if kw.get("emit", "tiles") == "tiles":
            vals, atom_starts = args[0], args[2]
            calls.append(int(vals.shape[1]) if vals.dim() == 2 else
                         (int(atom_starts.shape[0]) - 1) // (num_chunks + 1))
        return real(*args, **kw)
    monkeypatch.setattr(TK, "chunk_walk_reduce", counted)
    return calls


class TestBatchedLaunches:
    def test_at_most_one_launch_per_kind_a_step(self, monkeypatch):
        srv = GraphServer(_graph(seed=12), lanes=4,
                          schedule="chunked_lpt", path="native")
        calls = _count_tiles_calls(
            monkeypatch, int(srv.plan.part.atom_starts.shape[0]) - 1)
        steps = []
        _submit_all(srv, MIXED)
        while srv.queued or srv.in_flight:
            before = len(calls)
            srv.tick()
            steps.append(calls[before:])
        assert max(len(s) for s in steps) == 2
        # each launch carries every occupied lane of its kind: the first
        # step holds MIXED's first four queries, three BFS/SSSP lanes and
        # one PageRank lane
        assert steps[0] == [3, 1]

    def test_bfs_multi_one_launch_a_level(self, monkeypatch):
        g = _graph(seed=13, V=30, density=0.1)
        sources = [0, 3, 5, 7, 29]
        plan = g.advance_plan(schedule="chunked_lpt", path="native")
        calls = _count_tiles_calls(
            monkeypatch, int(plan.part.atom_starts.shape[0]) - 1)
        depth = bfs_multi(g, sources, plan=plan)
        # a level per depth, then one that finds nothing new
        assert len(calls) == int(depth.max()) + 1
        assert calls[0] == len(sources)
        assert all(c <= len(sources) for c in calls)


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.sparse", "repro.serve.graph") as modules:
        yield dict(zip(("sparse", "serve"), modules))


class TestAgainstReference:
    def test_server_matches_the_reference_server(self, ref):
        w = _dense(seed=14, V=24)
        rs = ref["sparse"]
        jg = rs.Graph(rs.CSR.from_dense(w))
        g = graph_of(w)
        kw = dict(schedule="chunked_lpt", num_blocks=8, path="pure")
        queries = MIXED + [("sssp", 11), "pagerank", ("bfs", 23)]
        jsrv = ref["serve"].GraphServer(jg, lanes=3, **kw)
        want = jsrv.serve(queries)
        srv = GraphServer(g, lanes=3, **kw)
        got = srv.serve(queries)
        assert sorted(got) == sorted(want)
        for qid, r in got.items():
            jr = want[qid]
            assert (r.kind, r.source, r.pushes) == \
                (jr.kind, jr.source, jr.pushes)
            if r.kind == "pagerank":
                # the float sums add in another order, so the step change
                # may reach zero an iteration apart
                np.testing.assert_allclose(r.value, np.asarray(jr.value),
                                           rtol=PR_RTOL, atol=1e-7)
            else:
                assert r.iterations == jr.iterations
                assert r.value.dtype == np.asarray(jr.value).dtype
                np.testing.assert_array_equal(
                    r.value.view(np.uint32) if r.kind == "sssp" else r.value,
                    np.asarray(jr.value).view(np.uint32)
                    if r.kind == "sssp" else np.asarray(jr.value))

    @pytest.mark.parametrize("direction", ["pull", "push", "auto"])
    def test_bfs_multi(self, ref, direction):
        w = _dense(seed=15, V=40, density=0.08)
        rs = ref["sparse"]
        jg = rs.Graph(rs.CSR.from_dense(w))
        g = graph_of(w)
        sources = [0, 7, 7, 39, 12, 3]
        kw = dict(schedule="merge_path", num_blocks=8, direction=direction)
        want = np.asarray(rs.bfs_multi(jg, sources, path="pure", **kw))
        for path in ("pure", "native"):
            got = bfs_multi(g, sources, path=path, **kw)
            assert got.dtype == torch.int32 and got.shape == (6, 40)
            np.testing.assert_array_equal(np_of(got), want)
            for s, src in enumerate(sources):
                np.testing.assert_array_equal(
                    np_of(got[s]),
                    np_of(bfs(g, src, path=path, **kw)))

    def test_bfs_multi_edges(self):
        g = _graph(seed=16)
        assert bfs_multi(g, []).shape == (0, 20)
        capped = bfs_multi(g, [1, 2], max_iters=1)
        for i, src in enumerate([1, 2]):
            np.testing.assert_array_equal(
                np_of(capped[i]), np_of(bfs(g, src, max_iters=1,
                                            direction="pull")))
        with pytest.raises(ValueError, match="out of range"):
            bfs_multi(g, [0, 20])
        with pytest.raises(ValueError, match="direction"):
            bfs_multi(g, [0], direction="sideways")
        # two shards need a process group of two ranks
        with pytest.raises(ValueError, match=r"must be in \[1, 1\]"):
            bfs_multi(g, [0], mesh=2)


def test_launch_serve_graph_on_the_cpu():
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--graph", "--device", "cpu", "--graph-vertices", "200",
                    "--graph-edges", "1200", "--queries", "9",
                    "--lanes", "4", "--seed", "3"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("9 queries (") and "through 4 lanes" in \
        lines[0] and "q/s" in lines[0]
    assert "p50=" in lines[1] and "p99=" in lines[1]
    assert "step_traces=1 admit_traces=1" in lines[1]
