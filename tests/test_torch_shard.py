"""Port parity: the sharded graph traversal (``repro_torch.sparse.shard``).

Every class of the reference's ``tests/test_shard_advance.py``, on the
port, at the reference's small graphs.  The port runs each shard count of
2, 4 and 8 once, in a spawned ``gloo`` group of that many CPU ranks that
computes the whole matrix of cases and returns it
(``_torch_shard_group.matrix_job``); S = 1 runs in this process.  Each
parametrized case then checks its own entry.  The expected values:

* the port's single-device drivers on the same graph (bitwise where the
  reference's own tests assert bitwise, PageRank on a general graph at
  the reference's rtol 1e-6 / atol 1e-7);
* the reference's NumPy oracles (``_conformance``);
* the reference's sharded drivers and plan arrays at S = 1/2/4/8, from
  one fresh process that forces eight host devices
  (``_shard_reference.py``, started when the module starts, read when a
  test first needs it).
"""
import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
import repro_torch.sparse as TS
from repro_torch.launch.mesh import GraphMesh, make_graph_mesh
from repro_torch.sparse.shard import SHARD_SCHEDULES

from _conformance import (SCHEDULE_PATH_CASES, adversarial_graphs, np_bfs,
                          np_delta_stepping, np_pagerank, np_sssp,
                          powerlaw_graph_dense, shard_slices)
from _torch_parity import assert_bitwise, graph_of, np_of
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)
import _torch_shard_group as grp
from _torch_shard_group import BOUNDARIES, MB, run_group

HERE = pathlib.Path(__file__).resolve().parent
CASES = [(s.value, p.value) for s, p in SCHEDULE_PATH_CASES]
MULTI = [2, 4, 8]
ALL = [1, 2, 4, 8]
REF_DEADLINE_S = 240


def _dyadic_weights(V: int = 32, seed: int = 1) -> np.ndarray:
    """Unit weights, power-of-two out-degrees: PageRank stays dyadic, so
    the damping=0.5 power iteration is bit-exact in any summation order."""
    rng = np.random.default_rng(seed)
    deg = 2 ** rng.integers(0, 3, V)
    w = np.zeros((V, V), np.float32)
    for i in range(V):
        cols = rng.choice([c for c in range(V) if c != i], size=deg[i],
                          replace=False)
        w[i, cols] = 1.0
    return w


def _nan_weights() -> np.ndarray:
    w = powerlaw_graph_dense(24, avg_degree=3.0, seed=7)
    r, c = np.nonzero(w)
    w[r[3], c[3]] = np.nan
    return w


WEIGHTS = powerlaw_graph_dense(24, avg_degree=3.0, seed=7)
TINY = powerlaw_graph_dense(5, avg_degree=2.0, seed=3)
DATA = {"graph": WEIGHTS, "dyadic": _dyadic_weights(),
        "adversarial": adversarial_graphs(), "tiny": TINY,
        "nan_graph": _nan_weights()}
V = WEIGHTS.shape[0]


@pytest.fixture(scope="module")
def G():
    return graph_of(WEIGHTS)


@pytest.fixture(scope="module", autouse=True)
def _reference_process(tmp_path_factory):
    """The reference's sharded run, started once at module start."""
    out = tmp_path_factory.mktemp("shard_ref") / "ref.npz"
    np.save(out.parent / "dyadic.npy", DATA["dyadic"])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               REPRO_AUTOTUNE_CACHE=str(out.parent / "ref_autotune.json"))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.Popen([sys.executable, str(HERE / "_shard_reference.py"),
                             str(out), str(out.parent / "dyadic.npy")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    state = {"proc": proc, "out": out, "start": time.monotonic()}
    yield state
    if proc.poll() is None:
        proc.kill()
    proc.communicate(timeout=30)


@pytest.fixture(scope="module")
def ref(_reference_process):
    """``{key: array}`` of the reference's sharded run."""
    proc = _reference_process["proc"]
    left = REF_DEADLINE_S - (time.monotonic() - _reference_process["start"])
    try:
        log, _ = proc.communicate(timeout=max(left, 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, log.decode()[-3000:]
    with np.load(_reference_process["out"]) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """``S -> [per-rank results of matrix_job]``, each group run once."""
    cache = {}
    payload = dict(DATA, autotune_cache=str(
        tmp_path_factory.mktemp("shard_groups") / "port_autotune.json"))

    def get(S):
        if S not in cache:
            cache[S] = run_group(S, "matrix", payload)
        return cache[S]
    return get


@pytest.fixture(scope="module")
def res(groups):
    """``S -> rank 0's results`` (every rank returns the global answers;
    :class:`TestEveryRank` holds them equal)."""
    return lambda S: groups(S)[0]


def unsharded(fn, *args, **kw):
    return np_of(fn(*args, **kw))


def _bfs_pair(g, **kw):
    d, p = TS.bfs(g, 0, return_parents=True, **kw)
    return np_of(d), np_of(p)


def _assert_pair(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _local(G, S=1, **kw):
    kw.setdefault("shard_schedule", "equal_width")
    return TS.build_sharded_advance(G, S, **kw)


def _plan_rows(groups, S, key, G):
    """Per-rank plan arrays of ``key`` (S = 1 built here)."""
    if S == 1:
        kw = dict(MB)
        if key == "compact_delta":
            kw.update(delta="auto", compact=True)
        elif key != "equal_width":
            kw.update(shard_schedule=key, delta="auto")
        return [grp._plan_arrays(_local(G, 1, **kw))]
    return [r[f"plan/{key}"] for r in groups(S)]


# ---------------------------------------------------------------------------
# beyond the reference's file (first, so that they run while the
# reference's process does): cost terms, plans and cache against the
# reference's own functions; the collectives; the group's failure mode
# ---------------------------------------------------------------------------

def _spec_pair(G):
    spec = G.csr.transpose().workspec()
    jspec = J.WorkSpec.from_segment_offsets(
        jnp.asarray(np_of(spec.tile_offsets)), num_atoms=spec.num_atoms)
    return spec, jspec


class TestShardedCostAndPlans:
    def test_constants_match_reference(self):
        assert T.HALO_BYTE_COST == J.HALO_BYTE_COST
        assert T.SHARD_SYNC_OVERHEAD == J.SHARD_SYNC_OVERHEAD
        for family in ("advance_sharded", "advance_sharded_push"):
            assert T.WORKLOAD_ATOM_WORK[family] == \
                J.autotune.WORKLOAD_ATOM_WORK[family]
            assert T.WORKLOAD_ATOM_COEF[family] == J.WORKLOAD_ATOM_COEF[family]
        assert set(T.COMBINER_COLLECTIVE) == set(J.COMBINER_COLLECTIVE)

    @pytest.mark.parametrize("num_shards", [1, 3, 4, 8])
    def test_shard_specs_from_boundaries_match_reference(self, G,
                                                         num_shards):
        spec, jspec = _spec_pair(G)
        for name in SHARD_SCHEDULES:
            bounds = TS.shard_boundaries(G, num_shards, name)
            got = T.balance.shard_specs_from_boundaries(spec, bounds)
            want = J.balance.shard_specs_from_boundaries(jspec, bounds)
            assert len(got) == len(want) == num_shards
            for a, b in zip(got, want):
                assert (a.num_atoms, a.num_tiles) == (b.num_atoms,
                                                      b.num_tiles)
                np.testing.assert_array_equal(np_of(a.tile_offsets),
                                              np.asarray(b.tile_offsets))
        with pytest.raises(ValueError):
            T.balance.shard_specs_from_boundaries(spec, [0, 5, 3, V])

    @pytest.mark.parametrize("schedule", ["merge_path", "chunked",
                                          "thread_mapped", "adaptive"])
    def test_modeled_sharded_cost_matches_reference(self, G, schedule):
        spec, jspec = _spec_pair(G)
        for S in (1, 4):
            for name in SHARD_SCHEDULES:
                bounds = TS.shard_boundaries(G, S, name)
                kw = dict(path="native", atom_work=4, halo_elems=V,
                          boundaries=bounds)
                assert T.modeled_sharded_cost(spec, schedule, 4, **kw) == \
                    J.modeled_sharded_cost(jspec, schedule, 4, **kw)
            parts = T.balance.shard_specs_from_boundaries(
                spec, TS.shard_boundaries(G, S, "equal_width"))
            jparts = J.balance.shard_specs_from_boundaries(
                jspec, TS.shard_boundaries(G, S, "equal_width"))
            assert T.modeled_sharded_cost(parts, schedule, 4) == \
                J.modeled_sharded_cost(jparts, schedule, 4)

    @pytest.mark.parametrize("counts", [(1,), (1, 2), (1, 2, 4)])
    def test_select_sharded_plan_matches_reference(self, G, counts):
        spec, jspec = _spec_pair(G)
        push = G.csr.workspec()
        jpush = J.WorkSpec.from_segment_offsets(
            jnp.asarray(np_of(push.tile_offsets)), num_atoms=push.num_atoms)
        by_count = {c: {n: TS.shard_boundaries(G, c, n)
                        for n in SHARD_SCHEDULES} for c in counts}
        got = T.select_sharded_plan(spec, by_count, 4, push_spec=push,
                                    cache=None)
        want = J.select_sharded_plan(jspec, by_count, 4, push_spec=jpush,
                                     cache=None)
        assert got.encode() == want.encode()
        for halo in (0, 10 ** 6):
            assert T.select_sharded_plan(
                spec, by_count, 4, cache=None, halo_elems=halo).encode() == \
                J.select_sharded_plan(jspec, by_count, 4, cache=None,
                                      halo_elems=halo).encode()

    def test_sharded_cache_record_read_both_ways(self, G, tmp_path):
        spec, jspec = _spec_pair(G)
        by_count = {c: {n: TS.shard_boundaries(G, c, n)
                        for n in SHARD_SCHEDULES} for c in (1, 2, 4)}
        port_file, ref_file = tmp_path / "port.json", tmp_path / "ref.json"
        got = T.select_sharded_plan(spec, by_count, 4,
                                    cache=T.AutotuneCache(port_file))
        key = T.autotune.shape_key(spec, 4) + "|plan.advance_sharded.b"
        assert key == J.autotune.shape_key(jspec, 4) + \
            "|plan.advance_sharded.b"
        assert J.AutotuneCache(port_file).get_sharded_record(key).plan \
            .encode() == got.encode()
        want = J.select_sharded_plan(jspec, by_count, 4,
                                     cache=J.AutotuneCache(ref_file))
        record = T.AutotuneCache(ref_file).get_sharded_record(key)
        assert isinstance(record, T.ShardedCacheRecord)
        assert record.plan == T.ShardedPlan.decode(want.encode())
        # the codecs keep the families apart, as the reference's do
        assert T.AutotuneCache(ref_file).get_record(key).plan is None
        assert T.ShardedPlan.decode("merge_path@pure@s2") == T.ShardedPlan(
            T.Schedule.MERGE_PATH, T.ExecutionPath.PURE, 2, "equal_width")
        with pytest.raises(ValueError):
            T.ShardedPlan.decode("merge_path@pure")
        # a measured sharded record survives a model-only rewrite
        cache = T.AutotuneCache(tmp_path / "merge.json")
        cache.put_record(key, T.ShardedCacheRecord(
            plan=got, measured_us={got.encode(): 12.5}))
        cache.put_record(key, T.ShardedCacheRecord(plan=got))
        assert T.AutotuneCache(tmp_path / "merge.json").get_sharded_record(
            key).measured_us == {got.encode(): 12.5}


class TestCollectives:
    def test_group_helper_cases_are_the_reference_matrix(self):
        assert list(grp.SCHEDULE_PATH_CASES) == CASES

    @pytest.mark.parametrize("num_shards", MULTI)
    def test_every_rank_returns_the_same_answers(self, groups, num_shards):
        ranks = groups(num_shards)
        assert ranks[0]["mesh"].startswith(f"GraphMesh(shard={num_shards},")
        assert "backend gloo" in ranks[0]["mesh"]
        for r, out in enumerate(ranks[1:], 1):
            for key, value in ranks[0].items():
                if key.startswith("plan/") or key == "mesh":
                    continue
                np.testing.assert_equal(out[key], value,
                                        err_msg=f"rank {r} {key}")

    def test_min_combine_keeps_nan(self, G):
        """gloo's all_reduce(MIN) drops a NaN that is not on rank 0; the
        sharded push combine keeps it, like the reference's ``pmin``."""
        ranks = run_group(2, "nan", DATA)
        want = np.array([np.nan, np.nan, 10.0, 10.0], np.float32)
        for out in ranks:
            np.testing.assert_array_equal(out["combined"], want)
            assert not np.isnan(out["collective_min"][1])
        g = graph_of(DATA["nan_graph"])
        for d in ("push", "pull"):
            want = np_of(TS.sssp(g, 0, direction=d, **MB))
            for out in ranks:
                np.testing.assert_array_equal(np.isnan(out[f"sssp_{d}"]),
                                              np.isnan(want))
                assert_bitwise(np.nan_to_num(out[f"sssp_{d}"]),
                               np.nan_to_num(want))

    def test_failing_rank_fails_within_its_timeout(self):
        """A rank that raises leaves the other in a collective: the group
        fails within its timeout, and no rank is left running."""
        start = time.monotonic()
        with pytest.raises(RuntimeError, match="fails on purpose"):
            run_group(2, "failing", timeout_s=10, deadline_s=60)
        assert time.monotonic() - start < 60


# ---------------------------------------------------------------------------
# the classes of the reference's tests/test_shard_advance.py
# ---------------------------------------------------------------------------

class TestShardedMatchesSingleDevice:
    """The acceptance matrix: 3 shard counts x 6 schedules x both paths,
    bitwise equal to the single-device drivers."""

    @pytest.mark.parametrize("num_shards", MULTI)
    @pytest.mark.parametrize("schedule,path", CASES)
    def test_bfs_bitwise(self, res, ref, G, num_shards, schedule, path):
        got = res(num_shards)[f"bfs/{schedule}/{path}"]
        _assert_pair(got, _bfs_pair(G, schedule=schedule, path=path,
                                    num_blocks=4))
        _assert_pair(got, np_bfs(WEIGHTS, 0))
        key = f"s{num_shards}/bfs/depth"
        if (schedule, path) == ("merge_path", "pure") and key in ref:
            _assert_pair(got, (ref[key], ref[f"s{num_shards}/bfs/parent"]))

    @pytest.mark.parametrize("num_shards", MULTI)
    @pytest.mark.parametrize("schedule,path", CASES)
    def test_sssp_bitwise(self, res, ref, G, num_shards, schedule, path):
        got = res(num_shards)[f"sssp/{schedule}/{path}"]
        assert_bitwise(got, TS.sssp(G, 0, schedule=schedule, path=path,
                                    num_blocks=4))
        np.testing.assert_allclose(got, np_sssp(WEIGHTS, 0), rtol=1e-6)
        key = f"s{num_shards}/sssp"
        if (schedule, path) == ("merge_path", "pure") and key in ref:
            assert_bitwise(got, ref[key])

    @pytest.mark.parametrize("num_shards", MULTI)
    @pytest.mark.parametrize("schedule,path", CASES)
    def test_pagerank_dyadic_bitwise(self, res, ref, num_shards, schedule,
                                     path):
        g = graph_of(DATA["dyadic"])
        want = TS.pagerank(g, damping=0.5, num_iters=3, tol=0.0,
                           schedule=schedule, path=path, num_blocks=4)
        got = res(num_shards)[f"pr_dyadic/{schedule}/{path}"]
        assert_bitwise(got, want)
        if (schedule, path, num_shards) == ("merge_path", "pure", 4):
            assert_bitwise(got, ref["s4/pr_dyadic"])

    @pytest.mark.parametrize("num_shards", MULTI)
    @pytest.mark.parametrize("direction", ["auto", "pull", "push"])
    def test_direction_policies_bitwise(self, res, G, num_shards,
                                        direction):
        out = res(num_shards)
        np.testing.assert_array_equal(
            out[f"dir_bfs/{direction}"],
            unsharded(TS.bfs, G, 0, direction=direction, **MB))
        assert_bitwise(out[f"dir_sssp/{direction}"],
                       TS.sssp(G, 0, direction=direction, **MB))


class TestShardedDeltaStepping:
    @pytest.mark.parametrize("num_shards", MULTI)
    @pytest.mark.parametrize("schedule,path",
                             [("merge_path", "pure"), ("chunked", "native"),
                              ("group_mapped", "pure")])
    def test_delta_bitwise_vs_single_device(self, res, G, num_shards,
                                            schedule, path):
        got = res(num_shards)[f"delta/{schedule}/{path}"]
        assert_bitwise(got, TS.delta_stepping(G, 0, schedule=schedule,
                                              path=path, num_blocks=4,
                                              compact=None))
        assert_bitwise(got, np_delta_stepping(WEIGHTS, 0))

    @pytest.mark.parametrize("num_shards", MULTI)
    def test_explicit_delta_width(self, res, G, num_shards):
        got = res(num_shards)["delta3"]
        assert_bitwise(got, TS.delta_stepping(G, 0, delta=3.0, compact=None,
                                              **MB))
        assert_bitwise(got, np_delta_stepping(WEIGHTS, 0, 3.0))

    @pytest.mark.parametrize("num_shards", MULTI)
    def test_with_delta_rebuilds_light_masks(self, res, G, num_shards):
        delta, got = res(num_shards)["with_delta"]
        assert delta is None
        assert_bitwise(got, TS.delta_stepping(G, 0, compact=None, **MB))
        widened = _local(G, **MB).with_delta(None)
        assert widened.delta is not None and widened.delta > 0
        assert widened.delta == TS.build_advance(G, **MB).with_delta().delta


class TestMeshGlobalCompactCapacity:
    """``compact=`` resolves against the *global* edge count, as one
    device resolves it."""

    @pytest.mark.parametrize("num_shards", ALL)
    @pytest.mark.parametrize("compact", [True, 0.25, 17],
                             ids=["auto", "fraction", "explicit"])
    def test_capacity_matches_single_device(self, res, G, num_shards,
                                            compact):
        name = {True: "auto", 0.25: "fraction", 17: "explicit"}[compact]
        got = (_local(G, compact=compact, **MB).template.compact_capacity
               if num_shards == 1 else res(num_shards)[f"capacity/{name}"])
        assert got == TS.build_advance(G, compact=compact,
                                       **MB).compact_capacity

    @pytest.mark.parametrize("compact", [0.0, 1.5, 0, -3],
                             ids=["zero-frac", "over-frac", "zero", "neg"])
    def test_invalid_compact_rejected(self, G, compact):
        with pytest.raises(ValueError):
            TS.build_sharded_advance(G, 1, compact=compact, **MB)

    @pytest.mark.parametrize("num_shards", MULTI)
    def test_compacted_delta_bitwise(self, res, ref, G, num_shards):
        got, counts = res(num_shards)["delta_compact"]
        want, want_counts = TS.delta_stepping(G, 0, compact=True,
                                              return_direction_counts=True,
                                              **MB)
        assert_bitwise(got, want)
        np.testing.assert_array_equal(counts, np_of(want_counts))
        if num_shards == 4:
            assert_bitwise(got, ref["s4/delta_compact"])


class TestShardedPagerank:
    @pytest.mark.parametrize("num_shards", MULTI)
    def test_pagerank_close_general_graph(self, res, G, num_shards):
        got = res(num_shards)["pr12"]
        np.testing.assert_allclose(
            got, unsharded(TS.pagerank, G, num_iters=12, **MB), rtol=1e-6,
            atol=1e-7)
        np.testing.assert_allclose(got, np_pagerank(WEIGHTS, num_iters=12),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(
            res(num_shards)["pr_push"],
            unsharded(TS.pagerank, G, num_iters=12, direction="push", **MB),
            rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("num_shards", MULTI)
    def test_pagerank_mass_conserved(self, res, num_shards):
        got = res(num_shards)["pr20"]
        assert got.shape == (V,)
        np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-5)


class TestPerShardOwnership:
    """Each shard's slice of the result equals the oracle's slice."""

    @pytest.mark.parametrize("num_shards", ALL)
    def test_bfs_slices_match_oracle_slices(self, res, G, num_shards):
        got = (np_of(TS.sharded_bfs(_local(G, **MB), 0)) if num_shards == 1
               else res(num_shards)["bfs_plain"])
        oracle_d, _ = np_bfs(WEIGHTS, 0)
        slices = shard_slices(V, num_shards)
        assert sum(hi - lo for lo, hi in slices) == V
        for lo, hi in slices:
            np.testing.assert_array_equal(got[lo:hi], oracle_d[lo:hi])

    @pytest.mark.parametrize("num_shards", ALL)
    def test_local_views_cover_every_edge_exactly_once(self, groups, G,
                                                       num_shards):
        rows = _plan_rows(groups, num_shards, "equal_width", G)
        E = G.num_edges
        assert sum(int(r["pull_valid"].sum()) for r in rows) == E
        assert sum(int(r["push_valid"].sum()) for r in rows) == E
        assert sum(int(r["out_degrees"].sum()) for r in rows) == E


class TestAdversarialGraphs:
    @pytest.mark.parametrize("name", sorted(adversarial_graphs()))
    def test_bfs_sssp_bitwise(self, res, name):
        g = graph_of(DATA["adversarial"][name])
        depth, dist = res(4)[f"adversarial/{name}"]
        kw = dict(schedule="group_mapped", path="pure", num_blocks=4)
        np.testing.assert_array_equal(depth, unsharded(TS.bfs, g, 0, **kw))
        assert_bitwise(dist, TS.sssp(g, 0, **kw))

    def test_graph_smaller_than_mesh(self, res):
        """V=5 over 8 shards: the trailing shards hold only padding."""
        g = graph_of(TINY)
        num_shards, depth, dist = res(8)["tiny"]
        assert num_shards == 8
        np.testing.assert_array_equal(
            depth, unsharded(TS.bfs, g, 0, schedule="merge_path",
                             path="pure"))
        assert_bitwise(dist, TS.sssp(g, 0, schedule="merge_path",
                                     path="pure"))

    def test_single_vertex_graph(self, res):
        np.testing.assert_array_equal(res(2)["single_vertex"], [0])


class TestOneShardMatchesUnsharded:
    """The recursion's base case, in this process: a one-shard mesh is a
    bitwise no-op against the unsharded drivers."""

    @pytest.mark.parametrize("schedule,path", CASES)
    def test_bfs_sssp_bitwise(self, ref, G, schedule, path):
        kw = dict(schedule=schedule, path=path, num_blocks=4)
        splan = _local(G, **kw)
        d, p = TS.sharded_bfs(splan, 0, return_parents=True)
        _assert_pair((np_of(d), np_of(p)), _bfs_pair(G, **kw))
        dist = TS.sharded_sssp(splan, 0)
        assert_bitwise(dist, TS.sssp(G, 0, **kw))
        if (schedule, path) == ("merge_path", "pure"):
            _assert_pair((np_of(d), np_of(p)),
                         (ref["s1/bfs/depth"], ref["s1/bfs/parent"]))
            assert_bitwise(dist, ref["s1/sssp"])
        np.testing.assert_array_equal(
            np_of(TS.sharded_bfs_multi(splan, [0, 5, 11])),
            unsharded(TS.bfs_multi, G, [0, 5, 11], **kw))

    def test_threshold_matches_unsharded_inspector(self, G):
        splan = TS.build_sharded_advance(G, 1, **MB)
        assert splan.direction_threshold == \
            TS.build_advance(G, **MB).direction_threshold
        assert splan.mesh.backend == "local" and splan.num_shards == 1


class TestShardedBfsMulti:
    @pytest.mark.parametrize("num_shards", ALL)
    def test_batched_sources_bitwise(self, res, ref, G, num_shards):
        sources = [0, 5, 11]
        if num_shards == 1:
            splan = _local(G, **MB)
            got = np_of(TS.sharded_bfs_multi(splan, sources))
            auto = np_of(TS.sharded_bfs_multi(splan, sources,
                                              direction="auto"))
        else:
            got, auto = res(num_shards)["multi"], res(num_shards)[
                "multi_auto"]
        np.testing.assert_array_equal(
            got, unsharded(TS.bfs_multi, G, sources, **MB))
        np.testing.assert_array_equal(
            auto, unsharded(TS.bfs_multi, G, sources, direction="auto",
                            **MB))
        if num_shards == 2:
            np.testing.assert_array_equal(got, ref["s2/multi"])
        for i, s in enumerate(sources):
            np.testing.assert_array_equal(got[i], np_bfs(WEIGHTS, s)[0])


class TestDriverMeshDispatch:
    """``mesh=`` on the top-level drivers routes through the sharded
    path (two ranks)."""

    def test_bfs_mesh_kwarg(self, res, G):
        want = unsharded(TS.bfs, G, 0, **MB)
        np.testing.assert_array_equal(res(2)["driver"]["bfs"], want)
        np.testing.assert_array_equal(res(2)["driver"]["bfs_int"], want)
        np.testing.assert_array_equal(res(2)["driver"]["bfs_multi"],
                                      unsharded(TS.bfs_multi, G, [0, 5, 11],
                                                **MB))

    def test_sssp_prebuilt_plan(self, res, G):
        assert_bitwise(res(2)["driver"]["sssp_plan"], TS.sssp(G, 0, **MB))
        splan = _local(G, **MB)
        assert isinstance(splan, TS.ShardedAdvancePlan)
        assert_bitwise(TS.sssp(G, 0, plan=splan), TS.sssp(G, 0, **MB))

    def test_pagerank_and_delta_mesh_kwarg(self, res, G):
        np.testing.assert_allclose(
            res(2)["driver"]["pagerank"],
            unsharded(TS.pagerank, G, num_iters=8, **MB), rtol=1e-6,
            atol=1e-7)
        assert_bitwise(res(2)["driver"]["delta"],
                       TS.delta_stepping(G, 0, compact=None, **MB))

    def test_mesh_with_wrong_plan_type_raises(self, G):
        plan = TS.build_advance(G, **MB)
        with pytest.raises(TypeError):
            TS.bfs(G, 0, plan=plan, mesh=make_graph_mesh(1, device="cpu"))


class TestConstructionValidation:
    def test_make_graph_mesh_rejects_bad_counts(self):
        with pytest.raises(ValueError):
            make_graph_mesh(0, device="cpu")
        with pytest.raises(ValueError, match=r"must be in \[1, 1\]"):
            make_graph_mesh(2, device="cpu")   # no process group here
        mesh = make_graph_mesh(1, device="cpu")
        assert isinstance(mesh, GraphMesh) and mesh.rank == 0
        assert mesh.device.type == "cpu" and mesh.axis == "shard"

    def test_build_rejects_nonpositive_counts(self, G):
        with pytest.raises(ValueError):
            TS.build_sharded_advance(G, 0)
        with pytest.raises(ValueError):
            TS.build_sharded_advance(G, -2)

    def test_build_rejects_multi_axis_mesh(self, G):
        with pytest.raises(ValueError, match="1-axis"):
            TS.build_sharded_advance(G, (2, 1))

    def test_auto_selection_returns_valid_plan(self, res, G):
        splan = TS.build_sharded_advance(G, None, schedule="auto")
        assert splan.num_shards == 1
        np.testing.assert_array_equal(
            np_of(TS.sharded_bfs(splan, 0)),
            unsharded(TS.bfs, G, 0, schedule=splan.schedule,
                      path=splan.path))
        num_shards, schedule, path, bounds, depth = res(4)["auto"]
        assert 1 <= num_shards <= 4 and bounds[-1] == V
        np.testing.assert_array_equal(
            depth, unsharded(TS.bfs, G, 0, schedule=schedule, path=path))


def _hub_graph(V: int = 16384):
    """A ring plus an in-hub (every vertex points at vertex 0): the pull
    view's tile 0 owns ~V atoms, every other tile 1."""
    rows = np.concatenate([np.arange(V), np.arange(1, V)])
    cols = np.concatenate([(np.arange(V) + 1) % V, np.zeros(V - 1, np.int64)])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    roff = np.cumsum(np.bincount(rows + 1, minlength=V + 1))
    return TS.Graph(TS.CSR.from_numpy(roff, cols, np.ones(len(cols)),
                                      (V, V), device="cpu"))


class TestBoundarySchedules:
    """Every boundary schedule: bitwise equal to one device, every edge
    owned once, and equal_width's layout the identity."""

    @pytest.mark.parametrize("num_shards", MULTI)
    @pytest.mark.parametrize("boundary", sorted(SHARD_SCHEDULES))
    def test_bfs_sssp_delta_bitwise(self, res, ref, G, boundary, num_shards):
        name, pair, dist, delta = res(num_shards)[f"boundary/{boundary}"]
        assert name == boundary
        _assert_pair(pair, _bfs_pair(G, **MB))
        assert_bitwise(dist, TS.sssp(G, 0, **MB))
        assert_bitwise(delta, TS.delta_stepping(G, 0, compact=None, **MB))
        if (boundary, num_shards) == ("lpt_contiguous", 4):
            _assert_pair(pair, (ref["s4/lpt/depth"], ref["s4/lpt/parent"]))

    @pytest.mark.parametrize("num_shards", MULTI)
    @pytest.mark.parametrize("boundary", sorted(SHARD_SCHEDULES))
    def test_edges_owned_exactly_once(self, groups, G, boundary,
                                      num_shards):
        rows = _plan_rows(groups, num_shards, boundary, G)
        E = G.num_edges
        assert sum(int(r["pull_valid"].sum()) for r in rows) == E
        assert sum(int(r["push_valid"].sum()) for r in rows) == E
        assert sum(int(r["out_degrees"].sum()) for r in rows) == E
        bounds = rows[0]["boundaries"]
        assert bounds[0] == 0 and bounds[-1] == V
        assert (np.diff(bounds) >= 0).all()

    @pytest.mark.parametrize("num_shards", ALL)
    def test_equal_width_permutation_is_identity(self, groups, G,
                                                 num_shards):
        r = _plan_rows(groups, num_shards, "equal_width", G)[0]
        ident = np.arange(num_shards * r["shard_size"], dtype=np.int32)
        np.testing.assert_array_equal(r["glob2pad"], ident)
        np.testing.assert_array_equal(r["pad2glob"], ident)
        np.testing.assert_array_equal(
            r["boundaries"], [min(s * r["shard_size"], V)
                              for s in range(num_shards + 1)])

    @pytest.mark.parametrize("boundary", ["edge_balanced", "lpt_contiguous"])
    def test_driver_shard_schedule_kwarg(self, res, G, boundary):
        driver = res(2)["driver"]
        np.testing.assert_array_equal(driver[f"bfs/{boundary}"],
                                      unsharded(TS.bfs, G, 0, **MB))
        assert_bitwise(driver[f"sssp/{boundary}"], TS.sssp(G, 0, **MB))

    @pytest.mark.parametrize("boundary", ["edge_balanced", "lpt_contiguous"])
    @pytest.mark.parametrize("num_shards", MULTI)
    def test_pad_atoms_spread_over_empty_slots(self, groups, G, boundary,
                                               num_shards):
        """No padding tile's segment exceeds the even split of the shard's
        padding atoms over its empty slots and pad tile."""
        rows = _plan_rows(groups, num_shards, boundary, G)
        bounds = rows[0]["boundaries"]
        for s, r in enumerate(rows):
            counts = np.diff(r["pull_offsets"])
            pad_counts = counts[int(bounds[s + 1] - bounds[s]):]
            if pad_counts.size == 0:
                continue
            cap = -(-int(pad_counts.sum()) // pad_counts.size)
            assert pad_counts.max() <= cap, (s, pad_counts)

    @pytest.mark.parametrize("num_shards", MULTI)
    def test_bfs_multi_and_pagerank_uneven(self, res, G, num_shards):
        multi, pr = res(num_shards)["uneven"]
        np.testing.assert_array_equal(
            multi, unsharded(TS.bfs_multi, G, [0, 5, 11], **MB))
        np.testing.assert_allclose(
            pr, unsharded(TS.pagerank, G, num_iters=8, **MB), rtol=1e-6,
            atol=1e-7)

    @pytest.mark.parametrize("key,num_shards",
                             [(k, s) for k in BOUNDARIES for s in ALL]
                             + [("compact_delta", 4)])
    def test_plan_arrays_match_reference(self, groups, ref, G, key,
                                         num_shards):
        """Each rank's shard of the plan equals the reference's shard:
        padded views, masks, ids, spans, threshold, capacity, delta."""
        prefix = f"s{num_shards}/plan/{key}/"
        rows = _plan_rows(groups, num_shards, key, G)
        assert len(rows) == num_shards
        for name in ("glob2pad", "pad2glob", "boundaries", "shard_size",
                     "e_pull", "e_push", "compact_capacity", "pull_spans",
                     "push_spans", "threshold", "delta"):
            if prefix + name not in ref:
                continue
            got = rows[0][name]
            got = -1 if got is None else got
            np.testing.assert_array_equal(np.asarray(got), ref[prefix + name],
                                          err_msg=name)
        for s, r in enumerate(rows):
            for name in ("pull_offsets", "push_offsets", "src", "weight",
                         "dst", "push_weight", "push_src", "out_degrees",
                         "pull_valid", "push_valid", "light_mask",
                         "push_light_mask", "light_out_degrees"):
                if prefix + name not in ref:
                    continue
                np.testing.assert_array_equal(
                    r[name], ref[prefix + name][s], err_msg=f"{name}[{s}]")


class TestBoundaryCostModel:
    """Degree-aware boundaries lower the modeled max-shard cost; the
    port's model equals the reference's on the same views."""

    @pytest.mark.parametrize("num_shards", [2, 4, 8])
    def test_edge_balanced_strictly_beats_equal_width_on_hub(self,
                                                             num_shards):
        g = _hub_graph()
        spec = g.csr.transpose().workspec()
        jspec = J.WorkSpec.from_segment_offsets(
            jnp.asarray(np_of(spec.tile_offsets)), num_atoms=spec.num_atoms)
        costs = {}
        for name in ("equal_width", "edge_balanced", "lpt_contiguous"):
            bounds = TS.shard_boundaries(g, num_shards, name)
            costs[name] = T.modeled_sharded_cost(
                spec, T.Schedule.MERGE_PATH, 3, path="pure", atom_work=2,
                halo_elems=g.num_vertices, boundaries=bounds)
            assert costs[name] == J.modeled_sharded_cost(
                jspec, J.Schedule.MERGE_PATH, 3, path="pure", atom_work=2,
                halo_elems=g.num_vertices, boundaries=bounds)
        assert costs["edge_balanced"] < costs["equal_width"], costs
        assert costs["lpt_contiguous"] <= costs["edge_balanced"], costs

    def test_boundaries_cover_and_balance(self):
        g = _hub_graph(4096)
        loads = (np.diff(np_of(g.csr.row_offsets))
                 + np.diff(np_of(g.csr.transpose().row_offsets)) + 1)
        for name in SHARD_SCHEDULES:
            b = TS.shard_boundaries(g, 4, name)
            assert b[0] == 0 and b[-1] == g.num_vertices
            assert (np.diff(b) >= 0).all()
        eq = TS.shard_boundaries(g, 4, "equal_width")
        eb = TS.shard_boundaries(g, 4, "edge_balanced")
        seg = lambda bb: max(loads[lo:hi].sum()
                             for lo, hi in zip(bb[:-1], bb[1:]))
        assert seg(eb) < seg(eq)

    @pytest.mark.parametrize("num_shards", ALL)
    def test_boundaries_match_reference(self, ref, G, num_shards):
        for name in SHARD_SCHEDULES:
            np.testing.assert_array_equal(
                TS.shard_boundaries(G, num_shards, name),
                ref[f"s{num_shards}/plan/{name}/boundaries"])


class TestNumShardsValidation:
    """Degree-aware schedules reject S > V; equal_width keeps its
    all-empty-trailing-shards contract."""

    def test_degree_aware_rejects_more_shards_than_vertices(self, res):
        g = graph_of(TINY)
        for name in ("edge_balanced", "lpt_contiguous"):
            with pytest.raises(ValueError, match=r"V=5.*S=8"):
                TS.shard_boundaries(g, 8, name)
        errors = res(8)["tiny_rejects"]
        assert len(errors) == 2 and all("V=5" in e and "S=8" in e
                                        for e in errors)

    def test_unknown_shard_schedule_rejected(self, G):
        with pytest.raises(ValueError, match="unknown shard schedule"):
            TS.build_sharded_advance(G, 1, shard_schedule="bogus", **MB)
        with pytest.raises(ValueError, match="unknown shard schedule"):
            TS.shard_boundaries(G, 2, "bogus")

    def test_equal_width_keeps_small_graph_contract(self, res):
        g = graph_of(TINY)
        np.testing.assert_array_equal(
            res(8)["tiny"][1],
            unsharded(TS.bfs, g, 0, schedule="merge_path", path="pure"))

    def test_auto_boundary_on_small_graph_falls_back(self):
        g = graph_of(TINY)
        splan = TS.build_sharded_advance(g, None, schedule="merge_path",
                                         path="pure", shard_schedule="auto")
        assert splan.num_shards >= 1
        np.testing.assert_array_equal(
            np_of(TS.sharded_bfs(splan, 0)),
            unsharded(TS.bfs, g, 0, schedule="merge_path", path="pure"))
