"""Port parity: document packing, the wavefront scheduler and the TreeLSTM
against the live JAX reference and the sequential NumPy oracles.

``repro.sparse.wavefront``, ``repro.models.treelstm`` and
``repro.data.packing`` are imported through the batching-table swap of
``_torch_parity``.  Integer-valued fixtures with a bounded clip activation
keep every float32 sum exact, so the schedule x path matrix is held
bitwise against the reference, ``_conformance.np_wavefront`` and
``np_topo_levels``; the ``tanh`` TreeLSTM, on weights carried across with
``interop.treelstm_params_from_arrays``, to allclose 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.data.packing import pack_documents, packing_efficiency
from repro_torch.interop import treelstm_params_from_arrays
from repro_torch.models import treelstm as TT
from repro_torch.sparse import CSR, Graph
from repro_torch.sparse import wavefront as TW

from _conformance import np_topo_levels, np_wavefront, wavefront_dags
from _torch_parity import SCHEDULES, assert_bitwise, np_of, reference_modules
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)

DAGS = wavefront_dags(seed=0)
PATHS = ("pure", "native")
clip_t = lambda z: torch.clamp(z, -16.0, 16.0)
clip_n = lambda z: np.clip(z, np.float32(-16.0), np.float32(16.0))


def spelling(schedule: str, policy: str) -> str:
    """``build_advance``'s name for a (schedule, chunk policy) entry."""
    if schedule == "chunked":
        return "chunked_rr" if policy == "round_robin" else "chunked_lpt"
    return schedule


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.sparse", "repro.models.treelstm",
                           "repro.data.packing") as modules:
        yield modules


@pytest.fixture
def autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)


def dag_of(w) -> Graph:
    return Graph.from_dense(np.asarray(w, np.float32), device="cpu")


def exact_fixtures(V, K=4, O=3, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (V, K)).astype(np.float32)
    W = rng.integers(-2, 3, (O, K, K)).astype(np.float32)
    b = rng.integers(-3, 4, (O, K)).astype(np.float32)
    ops = rng.integers(0, O, V).astype(np.int32)
    return x, ops, W, b


class TestWavefrontMatrix:
    @pytest.mark.parametrize("schedule,policy", SCHEDULES)
    @pytest.mark.parametrize("name", sorted(DAGS))
    def test_bitwise_against_reference_and_oracle(self, ref, name,
                                                  schedule, policy):
        import jax.numpy as jnp
        rs = ref[0]
        w = DAGS[name]
        x, ops, W, b = exact_fixtures(w.shape[0], seed=0)
        want = np_wavefront(w, x, ops, W, bias=b, act=clip_n)
        jg = rs.Graph(rs.CSR.from_dense(w))
        sched = spelling(schedule, policy)
        for path in PATHS:
            jwp = rs.build_wavefront(jg, schedule=sched, num_blocks=4,
                                     path=path)
            live = rs.wavefront_eval(jwp, x, ops, W, bias=b,
                                     activation=lambda z: jnp.clip(
                                         z, -16.0, 16.0))
            wp = TW.build_wavefront(dag_of(w), schedule=sched, num_blocks=4,
                                    path=path)
            assert str(wp.plan.path) == path
            np.testing.assert_array_equal(wp.level_of, np_topo_levels(w))
            np.testing.assert_array_equal(wp.level_of, jwp.level_of)
            np.testing.assert_array_equal(wp.level_counts, jwp.level_counts)
            got, levels = TW.wavefront_eval(wp, x, ops, W, bias=b,
                                            activation=clip_t,
                                            return_levels=True)
            assert levels == wp.num_levels == jwp.num_levels
            assert_bitwise(got, want, f"{sched}/{path} vs oracle")
            assert_bitwise(got, live, f"{sched}/{path} vs reference")

    @pytest.mark.parametrize("name", sorted(DAGS))
    def test_segmm_overrides_are_bitwise_invariant(self, name):
        w = DAGS[name]
        x, ops, W, b = exact_fixtures(w.shape[0])
        want = np_wavefront(w, x, ops, W, bias=b, act=clip_n)
        wp = TW.build_wavefront(dag_of(w), schedule="merge_path",
                                num_blocks=4)
        for schedule in ("group_mapped", "chunked_rr", "chunked_lpt"):
            for path in PATHS:
                got = TW.wavefront_eval(wp, x, ops, W, bias=b,
                                        activation=clip_t,
                                        segmm_schedule=schedule,
                                        segmm_path=path)
                assert_bitwise(got, want, f"{schedule}/{path}")

    @pytest.mark.parametrize("activation", ["relu", "identity"])
    def test_named_exact_activations(self, ref, activation):
        rs = ref[0]
        w = DAGS["balanced_tree"]
        x, ops, W, b = exact_fixtures(w.shape[0])
        W = np.clip(W, -1, 1)          # keep identity's sums small
        jwp = rs.build_wavefront(rs.Graph(rs.CSR.from_dense(w)),
                                 schedule="chunked_lpt", num_blocks=4)
        live = rs.wavefront_eval(jwp, x, ops, W, bias=b,
                                 activation=activation)
        wp = TW.build_wavefront(dag_of(w), schedule="chunked_lpt",
                                num_blocks=4)
        assert_bitwise(TW.wavefront_eval(wp, x, ops, W, bias=b,
                                         activation=activation), live)

    @pytest.mark.parametrize("name", sorted(DAGS))
    def test_auto_picks_the_reference_plan(self, ref, autotune_cache, name):
        rs = ref[0]
        w = DAGS[name]
        jwp = rs.build_wavefront(rs.Graph(rs.CSR.from_dense(w)),
                                 schedule="auto", measure=False)
        wp = TW.build_wavefront(dag_of(w), schedule="auto")
        for field in ("schedule", "path", "push_schedule", "push_path"):
            assert str(getattr(wp.plan, field)) == str(
                getattr(jwp.plan, field)), field
        x, ops, W, b = exact_fixtures(w.shape[0])
        assert_bitwise(TW.wavefront_eval(wp, x, ops, W, bias=b,
                                         activation=clip_t),
                       np_wavefront(w, x, ops, W, bias=b, act=clip_n))

    def test_wavefront_families_registered(self):
        from repro_torch.core.autotune import WORKLOAD_ATOM_WORK
        from repro_torch.core.balance import (WAVEFRONT_ATOM_WORK,
                                              WAVEFRONT_PUSH_ATOM_WORK)
        from repro_torch.sparse.advance import _PUSH_WORKLOADS
        from repro.core import autotune as jat, balance as jbal
        assert WAVEFRONT_ATOM_WORK == jbal.WAVEFRONT_ATOM_WORK
        assert WAVEFRONT_PUSH_ATOM_WORK == jbal.WAVEFRONT_PUSH_ATOM_WORK
        for fam in ("wavefront", "wavefront_push"):
            assert WORKLOAD_ATOM_WORK[fam] == jat.WORKLOAD_ATOM_WORK[fam]
        assert _PUSH_WORKLOADS["wavefront"] == "wavefront_push"


class TestWavefrontEdges:
    def test_levels_match_reference(self, ref):
        for name, w in DAGS.items():
            csr = CSR.from_dense(w, device="cpu")
            args = (csr.row_offsets.numpy(), csr.col_indices.numpy(),
                    w.shape[0])
            np.testing.assert_array_equal(
                TW.topological_levels(*args),
                ref[0].topological_levels(*args), err_msg=name)

    def test_cycle_raises_at_build_time(self):
        w = np.zeros((3, 3), np.float32)
        w[0, 1] = w[1, 2] = w[2, 0] = 1.0
        with pytest.raises(ValueError, match="cycle"):
            TW.build_wavefront(dag_of(w), schedule="merge_path")

    def test_single_node_and_diamond(self):
        for w in (np.zeros((1, 1), np.float32),
                  np.array([[0, 1, 1, 0], [0, 0, 0, 1], [0, 0, 0, 1],
                            [0, 0, 0, 0]], np.float32)):
            x, ops, W, b = exact_fixtures(w.shape[0])
            wp = TW.build_wavefront(dag_of(w), schedule="chunked_lpt")
            got = TW.wavefront_eval(wp, x, ops, W, bias=b, activation=clip_t)
            assert_bitwise(got, np_wavefront(w, x, ops, W, bias=b,
                                             act=clip_n))

    def test_validation(self):
        w = DAGS["chain"]
        V = w.shape[0]
        wp = TW.build_wavefront(dag_of(w), schedule="merge_path")
        x = np.zeros((V, 4), np.float32)
        W = np.zeros((2, 4, 4), np.float32)
        with pytest.raises(ValueError, match="out of range"):
            TW.wavefront_eval(wp, x, np.full(V, 2, np.int32), W)
        with pytest.raises(ValueError, match="square"):
            TW.wavefront_eval(wp, x, np.zeros(V, np.int32),
                              np.zeros((2, 4, 3), np.float32))
        with pytest.raises(ValueError, match="unknown activation"):
            TW.wavefront_eval(wp, x, np.zeros(V, np.int32), W,
                              activation="swish")
        with pytest.raises(ValueError, match="bias"):
            TW.wavefront_eval(wp, x, np.zeros(V, np.int32), W,
                              bias=np.zeros((3, 4), np.float32))


def _trees():
    cherry = np.zeros((3, 3), np.float32)
    cherry[0, 2] = cherry[1, 2] = 1.0
    deep = np.zeros((5, 5), np.float32)
    for v in range(4):
        deep[v, v + 1] = 1.0
    return [cherry, deep, np.zeros((1, 1), np.float32)]


class TestForest:
    def test_packed_eval_matches_reference_and_per_tree(self, ref):
        rs = ref[0]
        trees = _trees()
        packed = TW.pack_forest([dag_of(t) for t in trees], num_rows=2)
        jpacked = rs.pack_forest([rs.Graph(rs.CSR.from_dense(t))
                                  for t in trees], num_rows=2)
        np.testing.assert_array_equal(packed.node_offsets,
                                      jpacked.node_offsets)
        np.testing.assert_array_equal(np_of(packed.row_node_starts),
                                      np_of(jpacked.row_node_starts))
        np.testing.assert_array_equal(np_of(packed.row_tree_starts),
                                      np_of(jpacked.row_tree_starts))
        np.testing.assert_array_equal(packed.dag.csr.to_dense(),
                                      np.asarray(jpacked.dag.csr.to_dense()))
        V = int(packed.node_offsets[-1])
        x, ops, W, b = exact_fixtures(V)
        wp = TW.build_wavefront(packed.dag, schedule="chunked_lpt",
                                num_blocks=4)
        assert wp.num_levels == 5
        h = TW.wavefront_eval(wp, x, ops, W, bias=b, activation=clip_t)
        for t, w in enumerate(trees):
            s = packed.tree_slice(t)
            assert_bitwise(h[s], np_wavefront(w, x[s], ops[s], W, bias=b,
                                              act=clip_n), f"tree {t}")

    def test_empty_forest_and_empty_tree_raise(self):
        with pytest.raises(ValueError, match="empty forest"):
            TW.pack_forest([])
        empty = CSR(torch.zeros(1, dtype=torch.int32),
                    torch.zeros(0, dtype=torch.int32), torch.zeros(0),
                    (0, 0), 0)
        with pytest.raises(ValueError, match="zero-length"):
            TW.pack_forest([dag_of(_trees()[0]), Graph(empty)])


class TestTreeLSTM:
    def _carry(self, ref, feat=8, seed=0):
        import jax
        jparams = {k: np.asarray(v) for k, v in ref[1].init_treelstm(
            jax.random.PRNGKey(seed), feat, num_ops=2).items()}
        return jparams, treelstm_params_from_arrays(jparams, device="cpu")

    def test_tanh_forest_against_reference(self, ref, autotune_cache):
        import jax.numpy as jnp
        rs, jt = ref[0], ref[1]
        rng = np.random.default_rng(3)
        trees = _trees() + [DAGS["balanced_tree"]]
        V = sum(t.shape[0] for t in trees)
        feat = 8
        jparams, params = self._carry(ref, feat)
        x = rng.normal(size=(V, feat)).astype(np.float32)
        ops = rng.integers(0, 2, V).astype(np.int32)
        jroots, _ = jt.treelstm_forest(
            jparams, [rs.Graph(rs.CSR.from_dense(t)) for t in trees],
            jnp.asarray(x), jnp.asarray(ops))
        for schedule in ("auto", "chunked_lpt", "merge_path"):
            roots, packed = TT.treelstm_forest(
                params, [dag_of(t) for t in trees], torch.from_numpy(x),
                torch.from_numpy(ops), schedule=schedule)
            assert roots.shape == (len(trees), feat)
            np.testing.assert_allclose(np_of(roots), np.asarray(jroots),
                                       rtol=1e-5, atol=1e-5)
        wp = TW.build_wavefront(packed.dag)
        assert TT.tree_roots(wp).tolist() == [2, 7, 8, 9]
        h = TT.treelstm_embed(params, wp, x, ops)
        assert_bitwise(roots, h[torch.as_tensor([2, 7, 8, 9])])

    def test_clip_forest_bitwise(self, ref):
        rs, jt = ref[0], ref[1]
        trees = _trees()
        V = sum(t.shape[0] for t in trees)
        x, ops, W, b = exact_fixtures(V, K=4, O=2)
        jparams = {"w": W, "b": b}
        params = treelstm_params_from_arrays(jparams, device="cpu")
        import jax.numpy as jnp
        jroots, _ = jt.treelstm_forest(
            {"w": jnp.asarray(W), "b": jnp.asarray(b)},
            [rs.Graph(rs.CSR.from_dense(t)) for t in trees], x, ops,
            activation=lambda z: jnp.clip(z, -16.0, 16.0))
        roots, _ = TT.treelstm_forest(params, [dag_of(t) for t in trees],
                                      x, ops, activation=clip_t)
        assert_bitwise(roots, jroots)

    def test_non_tree_forest_raises(self, ref):
        w = np.zeros((3, 3), np.float32)
        w[0, 1] = w[0, 2] = 1.0
        _, params = self._carry(ref, 4)
        with pytest.raises(ValueError, match="dependency sinks"):
            TT.treelstm_forest(params, [dag_of(w)], np.zeros((3, 4)),
                               np.zeros(3, np.int32))

    def test_init_shapes(self):
        params = TT.init_treelstm(torch.Generator().manual_seed(0), 8,
                                  num_ops=3, device="cpu")
        assert params["w"].shape == (3, 8, 8) and params["b"].shape == (3, 8)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TT.init_treelstm(torch.Generator(), 8)


class TestPacking:
    @pytest.mark.parametrize("num_rows", [1, 3, 8])
    def test_against_reference(self, ref, num_rows):
        import jax.numpy as jnp
        lengths = np.random.default_rng(num_rows).integers(1, 50, 23)
        jstarts, jdocs = ref[2].pack_documents(jnp.asarray(lengths),
                                               num_rows)
        starts, docs = pack_documents(torch.from_numpy(lengths), num_rows)
        np.testing.assert_array_equal(np_of(starts), np.asarray(jstarts))
        np.testing.assert_array_equal(np_of(docs), np.asarray(jdocs))
        assert packing_efficiency(lengths, num_rows, device="cpu") == \
            ref[2].packing_efficiency(lengths, num_rows)

    @pytest.mark.parametrize("lengths,num_rows,capacity", [
        ([3, 0, 2], 2, None), ([3, -1], 2, None), ([], 2, None),
        ([3, 4], 0, None), ([30, 40], 2, 20), ([3, 4], 2, 0),
        ([5, 5, 5, 5], 2, 9)])
    def test_guards_match_reference(self, ref, lengths, num_rows, capacity):
        import jax.numpy as jnp
        arr = np.asarray(lengths, np.int32)
        with pytest.raises(ValueError) as want:
            ref[2].pack_documents(jnp.asarray(arr), num_rows,
                                  row_capacity=capacity)
        with pytest.raises(ValueError) as got:
            pack_documents(torch.from_numpy(arr), num_rows,
                           row_capacity=capacity)
        assert str(got.value) == str(want.value)

    def test_capacity_ok_when_it_fits(self):
        starts, _ = pack_documents(torch.tensor([5, 5, 5, 5]), 2,
                                   row_capacity=10)
        assert np_of(starts).tolist() == [0, 10, 20]
