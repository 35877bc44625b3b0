"""Port parity: graph advance, the plan pair, and the drivers against the
NumPy oracles.

Both advance directions over every schedule x path are bitwise equal to
``_conformance``'s oracles; the plan pair equals the live reference's
(partitions, threshold, capacity, delta split).  ``bfs`` (depths,
parents), ``sssp`` and ``delta_stepping`` are bitwise equal to
``np_bfs``/``np_sssp``/``np_delta_stepping`` (integer weights: every f32
distance is exact); ``pagerank`` is held with ``allclose`` (rtol 1e-5)
plus mass conservation.  The drivers against the live reference are in
``test_torch_graph_live.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.sparse as TS
from repro_torch.interop import partition_to_arrays

from _conformance import (adversarial_graphs, np_advance, np_advance_push,
                          np_bfs, np_delta_stepping, np_pagerank, np_sssp,
                          powerlaw_graph_dense)
from _torch_parity import (assert_bitwise, assert_same_partition,
                           graph_of, medium_source, np_of,
                           reference_sparse)
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)

SCHEDULES = ("thread_mapped", "group_mapped", "nonzero_split", "merge_path",
             "chunked_lpt", "chunked_rr", "adaptive")
PATHS = ("pure", "native")
GRAPHS = {**adversarial_graphs(), "powerlaw": powerlaw_graph_dense(48)}


@pytest.fixture(scope="module")
def rs():
    with reference_sparse() as module:
        yield module


@pytest.fixture
def autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)


class TestAdvance:
    @pytest.mark.parametrize("combiner", ["sum", "min", "max"])
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_directions_match_oracles(self, name, combiner):
        w = GRAPHS[name]
        g = graph_of(w)
        V = g.num_vertices
        rng = np.random.default_rng(0)
        vv = rng.integers(1, 9, V).astype(np.float32)
        frontier = rng.random(V) < 0.4
        frontier[0] = True
        tf, tv = torch.from_numpy(frontier), torch.from_numpy(vv)
        for schedule in SCHEDULES:
            for path in PATHS:
                plan = TS.build_advance(g, schedule=schedule, num_blocks=4,
                                        path=path)
                src, psrc = plan.src, plan.push_src
                pull = TS.advance(plan, tf, lambda e: tv[src[e]],
                                  combiner=combiner)
                push = TS.advance_push(plan, tf, lambda e: tv[psrc[e]],
                                       combiner=combiner)
                nsrc = np_of(src)
                want = np_advance(np_of(plan.spec.tile_offsets), nsrc,
                                  vv[nsrc], frontier, combiner)
                want_push = np_advance_push(
                    np_of(plan.push_spec.tile_offsets), np_of(plan.dst),
                    vv[np_of(psrc)], frontier, combiner, V)
                tag = f"{schedule}/{path}"
                assert_bitwise(pull, want, tag)
                assert_bitwise(push, want_push, tag)
                assert_bitwise(push, pull, tag)

    def test_frontier_ops(self):
        g = graph_of(GRAPHS["star_hub"])
        plan = TS.build_advance(g, schedule="chunked", num_blocks=3,
                                path="native")
        frontier = torch.zeros(g.num_vertices, dtype=torch.bool)
        frontier[0] = True
        for direction in ("pull", "push"):
            reached = TS.frontier_filter(plan, frontier, direction=direction)
            assert reached[1:].all() and not reached[0]
            parents = TS.advance_src_argmin(plan, frontier,
                                            direction=direction)
            assert (parents[1:] == 0).all() and parents[0] == -1
        assert TS.frontier_filter(plan, frontier,
                                  keep=torch.zeros_like(frontier)).sum() == 0
        assert plan.frontier_edge_fraction(frontier) == pytest.approx(
            11 / g.num_edges)

    def test_plan_pair_matches_reference(self, rs, autotune_cache):
        w = GRAPHS["powerlaw"]
        jg = rs.Graph(rs.CSR.from_dense(w))
        g = graph_of(w)
        for schedule in ("auto", "chunked_lpt", "merge_path"):
            kw = dict(schedule=schedule, num_blocks=8, workload="advance",
                      delta="auto", compact=True)
            jp = rs.build_advance(jg, **kw)
            tp = TS.build_advance(g, **kw)
            assert_same_partition(jp.part, tp.part)
            assert_same_partition(jp.push_part, tp.push_part)
            assert (tp.schedule.value, tp.push_schedule.value,
                    tp.path.value, tp.push_path.value) == \
                (jp.schedule.value, jp.push_schedule.value, jp.path.value,
                 jp.push_path.value)
            assert tp.direction_threshold == jp.direction_threshold
            assert tp.compact_capacity == jp.compact_capacity
            assert tp.delta == jp.delta
            for name in ("src", "weight", "dst", "push_weight", "push_src",
                         "out_degrees", "light_mask", "push_light_mask",
                         "light_out_degrees"):
                np.testing.assert_array_equal(
                    np_of(getattr(tp, name)),
                    np_of(getattr(jp, name)), err_msg=name)
        assert partition_to_arrays(tp.part)["atom_span"] >= 1


class TestDriversAgainstOracles:
    @pytest.mark.parametrize("path", PATHS)
    @pytest.mark.parametrize("schedule", SCHEDULES)
    def test_all_graphs(self, schedule, path):
        for name, w in GRAPHS.items():
            g = graph_of(w)
            kw = dict(schedule=schedule, num_blocks=4, path=path)
            for source in sorted({0, medium_source(w)}):
                depth, parent = TS.bfs(g, source, return_parents=True, **kw)
                want_d, want_p = np_bfs(w, source)
                np.testing.assert_array_equal(np_of(depth), want_d, name)
                np.testing.assert_array_equal(np_of(parent), want_p, name)
                dist = TS.sssp(g, source, **kw)
                assert_bitwise(dist, np_sssp(w, source), name)
                assert_bitwise(TS.delta_stepping(g, source, **kw),
                               np_delta_stepping(w, source), name)
                assert_bitwise(TS.sssp(g, source, algorithm="delta",
                                       delta=0.5, **kw), dist, name)
            pr = np_of(TS.pagerank(g, **kw))
            np.testing.assert_allclose(pr, np_pagerank(w), rtol=1e-5,
                                       atol=1e-7, err_msg=name)
            assert abs(pr.sum() - 1.0) < 1e-5

    def test_source_validation_and_empty_graph(self):
        g = graph_of(GRAPHS["self_loops"])
        for bad in (-1, g.num_vertices):
            with pytest.raises(ValueError, match="out of range"):
                TS.bfs(g, bad)
            with pytest.raises(ValueError, match="out of range"):
                TS.delta_stepping(g, bad)
        empty = graph_of(np.zeros((0, 0), np.float32))
        assert TS.pagerank(empty).shape == (0,)
        with pytest.raises(ValueError, match="empty graph"):
            TS.sssp(empty, 0)
        with pytest.raises(ValueError, match="direction"):
            TS.bfs(g, 0, direction="sideways")

    def test_bucket_of_clamps_before_converting(self, rs):
        from repro_torch.sparse.graph import _bucket_of
        dist = np.asarray([0.0, 2.5, np.inf, 3e30, 7.0], np.float32)
        np.testing.assert_array_equal(
            np_of(_bucket_of(torch.from_numpy(dist), 0.5)),
            np_of(rs.graph._bucket_of(jnp.asarray(dist), 0.5)))
