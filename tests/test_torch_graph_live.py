"""Port parity: the traversal drivers against the live JAX reference.

``repro.sparse.graph`` is imported through the batching-table swap of
``_torch_parity``.  Depths, parents, distances and direction counts must
be bitwise equal; PageRank is held with ``allclose`` (rtol 1e-5).
"""
import numpy as np
import pytest

import repro_torch.sparse as TS

from _conformance import adversarial_graphs, powerlaw_graph_dense
from _torch_parity import (assert_bitwise, graph_of, medium_source, np_of,
                           reference_sparse)

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


class TestDriversAgainstLiveReference:
    @pytest.mark.parametrize("schedule", ["chunked_lpt", "merge_path",
                                          "auto"])
    def test_drivers(self, rs, autotune_cache, schedule):
        w = GRAPHS["powerlaw"]
        jg = rs.Graph(rs.CSR.from_dense(w))
        g = graph_of(w)
        source = medium_source(w)
        kw = dict(schedule=schedule, num_blocks=8)
        jd, jp, jc = rs.bfs(jg, source, return_parents=True,
                            return_direction_counts=True, path="pure", **kw)
        js, jsc = rs.sssp(jg, source, return_direction_counts=True,
                          path="pure", **kw)
        jdel, jdc = rs.delta_stepping(jg, source,
                                      return_direction_counts=True,
                                      path="pure", **kw)
        jpr = rs.pagerank(jg, path="pure", **kw)
        assert np_of(jc).min() > 0, "the source must exercise both ways"
        for path in PATHS:
            d, p, c = TS.bfs(g, source, return_parents=True,
                             return_direction_counts=True, path=path, **kw)
            np.testing.assert_array_equal(np_of(d), np_of(jd))
            np.testing.assert_array_equal(np_of(p), np_of(jp))
            np.testing.assert_array_equal(np_of(c), np_of(jc))
            s, sc = TS.sssp(g, source, return_direction_counts=True,
                            path=path, **kw)
            assert_bitwise(s, js)
            np.testing.assert_array_equal(np_of(sc), np_of(jsc))
            dl, dc = TS.delta_stepping(g, source,
                                       return_direction_counts=True,
                                       path=path, **kw)
            assert_bitwise(dl, jdel)
            np.testing.assert_array_equal(np_of(dc), np_of(jdc))
            np.testing.assert_allclose(np_of(TS.pagerank(g, path=path,
                                                         **kw)),
                                       np_of(jpr), rtol=1e-5, atol=1e-7)

    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_every_graph(self, rs, autotune_cache, name):
        """The adversarial graphs and the power law, one schedule each
        side: the reference's pure path, the port's kernels."""
        w = GRAPHS[name]
        jg = rs.Graph(rs.CSR.from_dense(w))
        g = graph_of(w)
        source = medium_source(w)
        kw = dict(schedule="merge_path", num_blocks=4)
        jd, jp = rs.bfs(jg, source, return_parents=True, path="pure", **kw)
        d, p = TS.bfs(g, source, return_parents=True, path="native", **kw)
        np.testing.assert_array_equal(np_of(d), np_of(jd))
        np.testing.assert_array_equal(np_of(p), np_of(jp))
        assert_bitwise(TS.sssp(g, source, path="native", **kw),
                       rs.sssp(jg, source, path="pure", **kw))
        assert_bitwise(TS.delta_stepping(g, source, path="native", **kw),
                       rs.delta_stepping(jg, source, path="pure", **kw))
        np.testing.assert_allclose(
            np_of(TS.pagerank(g, path="native", **kw)),
            np_of(rs.pagerank(jg, path="pure", **kw)), rtol=1e-5, atol=1e-7)

    def test_push_pagerank_and_fixed_directions(self, rs, autotune_cache):
        w = GRAPHS["zero_degree_tail"]
        jg = rs.Graph(rs.CSR.from_dense(w))
        g = graph_of(w)
        kw = dict(schedule="adaptive", num_blocks=4)
        np.testing.assert_allclose(
            np_of(TS.pagerank(g, direction="push", **kw)),
            np_of(rs.pagerank(jg, direction="push", **kw)), rtol=1e-5,
            atol=1e-7)
        for direction in ("pull", "push"):
            assert_bitwise(TS.sssp(g, 0, direction=direction, **kw),
                           rs.sssp(jg, 0, direction=direction, **kw))
            np.testing.assert_array_equal(
                np_of(TS.bfs(g, 0, direction=direction, **kw)),
                np_of(rs.bfs(jg, 0, direction=direction, **kw)))
