"""Port parity: ``core/measure.py``, the cost-feature fit and the
autotuner's persistent cache and measured mode, against the live JAX
reference.

The cache file format is shared: a file the port writes is read by the
reference's ``AutotuneCache`` and the other way round (v1 strings, v2
records, torn fields).  Measured selection with the same fake wall clock
picks the same plan and measures the same candidates as the reference; a
reloaded cache measures nothing; ``measure=False`` stays model-only at
every knob.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.autotune as JA
import repro_torch.core as T
import repro_torch.core.autotune as TA
from repro_torch.core import measure as TM

from _torch_parity import (graph_of, np_of, reference_modules, spec_pair,
                           t32, zoo)
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)

NB = 16
SIZES = [1, 1, 2, 2, 3, 4, 6, 9, 14, 22, 35, 56, 90, 144]
WORKLOADS = sorted(TA.WORKLOAD_ATOM_WORK)
SPECS = ("uniform", "one_heavy", "powerlaw", "empty_runs", "powerlaw_big",
         "empty")


def _encoded(d):
    return {p.encode(): v for p, v in d.items()}


def _fresh_default_cache(monkeypatch):
    """A new process's view of the default cache: memory empty, the file
    read on first use."""
    monkeypatch.setattr(TA._DEFAULT_CACHE, "_mem", {})
    monkeypatch.setattr(TA._DEFAULT_CACHE, "_loaded", False)


class TestTimeFn:
    @pytest.mark.parametrize("kw,match", [(dict(warmup=0), "warmup"),
                                          (dict(iters=0), "iters"),
                                          (dict(warmup=-1), "warmup")])
    def test_rejects_like_the_reference(self, kw, match):
        with pytest.raises(ValueError, match=match):
            J.time_fn(lambda: 1, **kw)
        with pytest.raises(ValueError, match=match):
            T.time_fn(lambda: 1, **kw)

    def test_counts_and_never_synchronizes_on_the_cpu(self, monkeypatch):
        def no_sync(*a, **k):
            raise AssertionError("synchronize on CPU tensors")
        monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
        before = T.measurement_count()
        calls = []
        us = T.time_fn(lambda x: calls.append(1) or x + 1, torch.ones(8),
                       warmup=2, iters=3)
        assert us > 0 and len(calls) == 5
        assert T.measurement_count() == before + 1
        assert TM.measurement_count() == T.measurement_count()

    def test_median_of_the_timed_calls(self, monkeypatch):
        clock = iter([0.0, 5e-6, 10.0, 10.000001, 20.0, 20.000009])
        monkeypatch.setattr(TM.time, "perf_counter", lambda: next(clock))
        assert T.time_fn(lambda: None, warmup=1, iters=3) == \
            pytest.approx(5.0)

    @pytest.mark.parametrize("xs", [[2.0, 8.0], [1.0], [3.0, 0.0, 7.5],
                                    [1e-3, 1e3, 5.0, 0.25]])
    def test_geomean(self, xs):
        assert T.geomean(xs) == pytest.approx(J.geomean(xs), rel=1e-12)

    def test_geomean_empty_is_an_error(self):
        with pytest.raises(ValueError, match="empty"):
            T.geomean([])


#: Cache values a file may hold: v1 strings, v2 records, and torn ones.
RAW_VALUES = {
    "v1": "merge_path@pure",
    "v1_bare_schedule": "chunked",
    "v1_stale": "no_such_schedule@pure",
    "v2": {"v": 2, "plan": "chunked@native",
           "measured_us": {"chunked@native": 12.5, "merge_path@pure": 30.0},
           "features": {"chunked@native": [3.0, {"ADVANCE_ATOM_WORK": 7.0,
                                                 "NATIVE_CHUNK_OVERHEAD":
                                                 2.0}]}},
    "v2_torn": {"v": 2, "plan": "bogus@pure",
                "measured_us": {"chunked@pure": "fast", "bad@pure": 3,
                                "merge_path@pure": -1,
                                "group_mapped@pure": 4.25,
                                "nonzero_split@pure": float("nan")},
                "features": {"chunked@pure": [1.0],
                             "merge_path@pure": "x",
                             "group_mapped@pure": [2.0, {"A": "b"}],
                             "adaptive@pure": [0.5, {"WAVEFRONT_ATOM_WORK":
                                                     1}]}},
    "v2_no_features": {"v": 2, "plan": "adaptive@pure",
                       "measured_us": {"adaptive@pure": 1.0}},
    "not_a_record": 17,
}


def _decoded(record):
    return (record.plan.encode() if record.plan else None,
            dict(record.measured_us),
            {k: (b, dict(f)) for k, (b, f) in record.features.items()})


class TestCacheFormat:
    @pytest.mark.parametrize("name", sorted(RAW_VALUES))
    def test_record_decode_and_encode(self, name):
        raw = RAW_VALUES[name]
        got = T.CacheRecord.decode(raw)
        want = J.CacheRecord.decode(raw)
        assert _decoded(got) == _decoded(want)
        assert got.encode() == want.encode()
        assert got.is_measured == want.is_measured

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_files_read_both_ways(self, tmp_path, writer):
        path = tmp_path / "shared.json"
        w = (T.AutotuneCache if writer == "port" else J.AutotuneCache)(path)
        codec = T.CacheRecord if writer == "port" else J.CacheRecord
        for key, raw in RAW_VALUES.items():
            if isinstance(raw, (str, dict)):
                w.put_record(key, codec.decode(raw))
        # a record with no decodable plan and no measurements is written
        # as null, which both readers drop
        on_disk = {k: v for k, v in json.loads(path.read_text()).items()
                   if v is not None}
        assert set(on_disk) == set(RAW_VALUES) - {"v1_stale", "not_a_record"}
        for reader in (T.AutotuneCache(path), J.AutotuneCache(path)):
            records = reader.records()
            assert set(records) == set(on_disk)
            for key in on_disk:
                want = J.CacheRecord.decode(RAW_VALUES[key])
                assert _decoded(records[key]) == _decoded(want), key

    def test_torn_file_reads_empty(self, tmp_path):
        path = tmp_path / "torn.json"
        path.write_text('{"b16|t3": "merge_path@pu')
        assert T.AutotuneCache(path).records() == {}
        path.write_text('["a list"]')
        assert T.AutotuneCache(path).get_record("x") is None

    def test_merge_rule_like_the_reference(self, tmp_path):
        """Model-only puts never erase measurements; an incoming
        measurement wins a per-plan conflict; the files end equal."""
        files = {}
        for name, A in (("port", T), ("reference", J)):
            path = tmp_path / f"{name}.json"
            cache = A.AutotuneCache(path)
            rec = A.CacheRecord
            plan = lambda s: (TA.Plan if A is T else JA.Plan).decode(s)
            cache.put_record("k", rec(plan=plan("merge_path@pure"),
                                      measured_us={"merge_path@pure": 9.0,
                                                   "chunked@native": 4.0},
                                      features={"chunked@native": (
                                          1.0, {"ADVANCE_ATOM_WORK": 2.0})}))
            cache.put_plan("k", plan("group_mapped@pure"))
            cache.put_record("k", rec(plan=plan("chunked@native"),
                                      measured_us={"chunked@native": 3.5}))
            cache.put("v1key", plan("adaptive@pure").schedule)
            files[name] = json.loads(path.read_text())
            record = A.AutotuneCache(path).get_record("k")
            assert record.measured_us == {"merge_path@pure": 9.0,
                                          "chunked@native": 3.5}
            assert record.plan.encode() == "chunked@native"
        assert files["port"] == files["reference"]

    def test_default_path_is_the_ports_own(self, tmp_path, monkeypatch):
        monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
        monkeypatch.setenv("HOME", str(tmp_path))
        path = T.AutotuneCache().path
        assert path == tmp_path / ".cache" / "repro_torch" / "autotune.json"
        assert path != J.AutotuneCache().path
        monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                           str(tmp_path / "x.json"))
        assert T.AutotuneCache().path == tmp_path / "x.json"

    def test_read_only_directory_stays_in_memory(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("")
        cache = T.AutotuneCache(blocker / "sub" / "c.json")
        cache.put_plan("k", TA.Plan.decode("merge_path@pure"))
        assert cache.get_plan("k").encode() == "merge_path@pure"


class TestCostModelParity:
    @pytest.mark.parametrize("name", SPECS)
    def test_cost_features(self, name):
        jspec, tspec = spec_pair(zoo()[name])
        for workload in WORKLOADS:
            for plan in TA.REGISTERED_PLANS:
                for nb in (4, NB):
                    kw = dict(path=str(plan.path), workload=workload)
                    got = T.cost_features(tspec, plan.schedule.value, nb,
                                          **kw)
                    want = J.cost_features(jspec, plan.schedule.value, nb,
                                           **kw)
                    assert got == want, (workload, plan, nb)
        for workload in ("advance_push", "advance_delta_push"):
            got = T.cost_features(tspec, "merge_path", NB,
                                  workload=workload, window_mode="compact")
            assert got == J.cost_features(jspec, "merge_path", NB,
                                          workload=workload,
                                          window_mode="compact")

    def test_cost_features_rebuild_the_modeled_cost(self):
        import repro_torch.core.balance as B
        _, tspec = spec_pair(SIZES)
        for sched in ("merge_path", "nonzero_split", "chunked"):
            base, feats = T.cost_features(tspec, sched, NB,
                                          workload="advance")
            total = base + sum(feats[n] * getattr(B, n) for n in feats)
            assert total == pytest.approx(
                T.modeled_advance_cost(tspec, sched, NB), rel=1e-6)

    def test_cost_features_errors(self):
        _, tspec = spec_pair(SIZES)
        with pytest.raises(ValueError, match="workload"):
            T.cost_features(tspec, "merge_path", NB, workload="nope")
        with pytest.raises(ValueError, match="push-family"):
            T.cost_features(tspec, "merge_path", NB, workload="advance",
                            window_mode="compact")

    def test_workload_tables(self):
        assert set(T.WORKLOAD_ATOM_COEF) == set(T.WORKLOAD_ATOM_WORK)
        assert T.WORKLOAD_ATOM_WORK == dict(JA.WORKLOAD_ATOM_WORK)
        assert T.WORKLOAD_ATOM_COEF == dict(J.WORKLOAD_ATOM_COEF)

    @pytest.mark.parametrize("case", ["no_measurements", "one", "inverted",
                                      "all"])
    def test_blend_scores(self, case):
        _, tspec = spec_pair(zoo()["powerlaw_big"])
        scores = T.score_plans(tspec, NB, workload="advance")
        plans = list(scores)
        measured = {"no_measurements": {}, "one": {plans[3]: 7.5},
                    "inverted": {plans[0]: 90.0, plans[4]: 3.0},
                    "all": {p: 1.0 + i for i, p in enumerate(plans)}}[case]
        got = T.blend_scores(scores, measured)
        jplans = {p.encode(): JA.Plan.decode(p.encode()) for p in plans}
        want = J.blend_scores({jplans[p.encode()]: c
                               for p, c in scores.items()},
                              {jplans[p.encode()]: us
                               for p, us in measured.items()})
        assert _encoded(got) == _encoded(want)


def _samples(seed, n, names, with_base=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = float(rng.uniform(1, 50)) if with_base else 0.0
        feats = {k: float(rng.uniform(1, 100))
                 for k in rng.choice(names, rng.integers(1, len(names) + 1),
                                     replace=False)}
        out.append((base, feats, float(rng.uniform(5, 500))))
    return out


class TestFitCoefficients:
    @pytest.mark.parametrize("case", ["noisy", "no_base", "one_sample",
                                      "unknown_feature"])
    def test_same_fit_as_the_reference(self, case):
        names = ["ADVANCE_ATOM_WORK", "NATIVE_CHUNK_OVERHEAD",
                 "WAVEFRONT_ATOM_WORK"]
        samples = {"noisy": _samples(1, 30, names),
                   "no_base": _samples(2, 12, names, with_base=False),
                   "one_sample": _samples(3, 1, names),
                   "unknown_feature": [(2.0, {"NOT_A_COEF": 3.0,
                                              "ADVANCE_ATOM_WORK": 1.0},
                                        10.0)] + _samples(4, 5, names)
                   }[case]
        got = T.fit_coefficients(samples)
        want = J.fit_coefficients(samples)
        assert got.constrained == want.constrained
        assert got.num_samples == want.num_samples
        assert got.current == want.current
        assert got.scale_us_per_step == pytest.approx(
            want.scale_us_per_step, rel=1e-9, abs=1e-9)
        assert got.residual_rel == pytest.approx(want.residual_rel,
                                                 rel=1e-9, abs=1e-9)
        for name, value in want.coefficients.items():
            assert got.coefficients[name] == pytest.approx(
                value, rel=1e-9, abs=1e-9), name
        assert got.report().splitlines()[1:] == \
            want.report().splitlines()[1:]

    def test_recovers_planted_coefficients(self):
        rng = np.random.default_rng(7)
        true = {"ADVANCE_ATOM_WORK": 3.5, "NATIVE_CHUNK_OVERHEAD": 0.4}
        samples = []
        for _ in range(40):
            base = float(rng.uniform(1, 50))
            feats = {n: float(rng.uniform(1, 100)) for n in true}
            samples.append((base, feats, 2.0 * (base + sum(
                feats[n] * true[n] for n in feats))))
        fit = T.fit_coefficients(samples)
        assert fit.scale_us_per_step == pytest.approx(2.0, rel=1e-4)
        for n, v in true.items():
            assert fit.coefficients[n] == pytest.approx(v, rel=1e-3)

    def test_empty_is_an_error(self):
        with pytest.raises(ValueError, match="at least one"):
            T.fit_coefficients([])


def _fake_clock(scores, table_of_rank, calls):
    ranked = sorted(scores, key=lambda p: (scores[p],
                                           list(scores).index(p)))
    table = {p.encode(): table_of_rank(i) for i, p in enumerate(ranked)}

    def run(plan):
        calls.append(plan.encode())
        return table[plan.encode()]
    return run


class TestMeasuredSelection:
    @pytest.mark.parametrize("k", [None, 1, 5])
    @pytest.mark.parametrize("workload", ["reduce", "advance",
                                          "advance_serve_push"])
    @pytest.mark.parametrize("name", ["powerlaw_big", "one_heavy"])
    def test_same_pick_and_measured_set(self, monkeypatch, tmp_path, name,
                                        workload, k):
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        jspec, tspec = spec_pair(zoo()[name])
        scores = T.score_plans(tspec, NB, workload=workload)
        jscores = J.score_plans(jspec, NB, workload=workload)
        # the fake wall clock inverts the model's ranking
        invert = lambda i: 100.0 - 10.0 * i
        calls, jcalls = [], []
        got = T.select_plan(tspec, NB, workload=workload, measure_k=k,
                            cache=T.AutotuneCache(tmp_path / "p.json"),
                            measure=_fake_clock(scores, invert, calls))
        want = J.select_plan(jspec, NB, workload=workload, measure_k=k,
                             cache=J.AutotuneCache(tmp_path / "r.json"),
                             measure=_fake_clock(jscores, invert, jcalls))
        assert got.encode() == want.encode()
        assert calls == jcalls and len(calls) == (k or 3)
        assert json.loads((tmp_path / "p.json").read_text()) == \
            json.loads((tmp_path / "r.json").read_text())

    def test_gate_off_is_model_only(self, tmp_path):
        assert not T.measurement_enabled()
        _, tspec = spec_pair(SIZES)
        calls = []
        plan = T.select_plan(tspec, NB, measure=lambda p: calls.append(p),
                             cache=T.AutotuneCache(tmp_path / "c.json"))
        assert calls == []
        scores = T.score_plans(tspec, NB)
        assert scores[plan] == min(scores.values())

    def test_topk_from_the_environment(self, monkeypatch, tmp_path):
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "yes")
        monkeypatch.setenv("REPRO_AUTOTUNE_TOPK", "2")
        _, tspec = spec_pair(SIZES)
        calls = []
        T.select_plan(tspec, NB, cache=None,
                      measure=lambda p: calls.append(p) or 5.0)
        assert len(calls) == 2

    def test_reload_reranks_without_measuring(self, monkeypatch, tmp_path):
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        _, tspec = spec_pair(SIZES)
        scores = T.score_plans(tspec, NB)
        calls = []
        clock = _fake_clock(scores, lambda i: 30.0 - 10.0 * i, calls)
        path = tmp_path / "c.json"
        first = T.select_plan(tspec, NB, cache=T.AutotuneCache(path),
                              measure=clock)
        assert len(calls) == 3
        again = T.select_plan(tspec, NB, cache=T.AutotuneCache(path),
                              measure=clock)
        assert len(calls) == 3 and again == first
        # and a reference process reloading the port's file agrees
        jspec, _ = spec_pair(SIZES)
        jcalls = []
        want = J.select_plan(jspec, NB, cache=J.AutotuneCache(path),
                             measure=lambda p: jcalls.append(p) or 1.0)
        assert jcalls == [] and want.encode() == first.encode()

    def test_measured_records_feed_the_fit(self, monkeypatch, tmp_path):
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        cache = T.AutotuneCache(tmp_path / "c.json")
        for i, name in enumerate(("powerlaw_big", "one_heavy", "uniform")):
            _, tspec = spec_pair(zoo()[name])
            T.select_plan(tspec, NB, cache=cache, workload="advance",
                          measure=lambda p: 5.0 + i)
        samples = T.collect_fit_samples(cache)
        jsamples = J.collect_fit_samples(J.AutotuneCache(cache.path))
        assert sorted(samples, key=repr) == sorted(jsamples, key=repr)
        assert len(samples) == 9
        assert any(feats for _, feats, _ in samples)
        fit = T.fit_coefficients(samples)
        assert "ADVANCE_ATOM_WORK" in fit.constrained
        assert "fit over 9 measured samples" in fit.report()


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.sparse", "repro.kernels.segmm.ops",
                           "repro.models.moe") as modules:
        yield dict(zip(("sparse", "segmm", "moe"), modules))


def _powerlaw(seed=0, V=48):
    rng = np.random.default_rng(seed)
    deg = (rng.zipf(1.7, V) % 17).astype(int)
    w = np.zeros((V, V), np.float32)
    for u in range(V):
        w[u, rng.choice(V, min(deg[u], V), replace=False)] = \
            rng.random(min(deg[u], V)).astype(np.float32) + 0.1
    return w


class TestKnobs:
    """``measure=False`` stays model-only with the gate on; ``None`` with
    the gate on times the default closure once, and a reload reuses it."""

    def test_spmv_merge_path(self, ref, monkeypatch):
        from repro_torch.kernels.spmv_merge.ops import spmv_merge_path
        from repro_torch.sparse import CSR
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        w = _powerlaw(1)
        A = CSR.from_dense(w, device="cpu")
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(48)
                             .astype(np.float32))
        jA = ref["sparse"].CSR.from_dense(w)
        from repro.kernels.spmv_merge.ops import spmv_merge_path as jspmv
        before = T.measurement_count()
        model = spmv_merge_path(A, x, schedule="auto", num_blocks=8,
                                measure=False)
        assert T.measurement_count() == before
        want = jspmv(jA, jnp.asarray(np_of(x)), schedule="auto",
                     num_blocks=8, measure=False)
        np.testing.assert_allclose(np_of(model), np_of(want), rtol=1e-5,
                                   atol=1e-5)
        _fresh_default_cache(monkeypatch)
        measured = spmv_merge_path(A, x, schedule="auto", num_blocks=8)
        assert T.measurement_count() == before + 3
        np.testing.assert_allclose(np_of(measured), np_of(model),
                                   rtol=1e-5, atol=1e-5)
        _fresh_default_cache(monkeypatch)
        spmv_merge_path(A, x, schedule="auto", num_blocks=8)
        assert T.measurement_count() == before + 3
        records = TA._DEFAULT_CACHE.records()
        assert [len(r.measured_us) for r in records.values()] == [3]

    def test_build_advance(self, ref, monkeypatch):
        from repro_torch.sparse import build_advance
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        w = _powerlaw(3)
        g = graph_of(w)
        jg = ref["sparse"].Graph(ref["sparse"].CSR.from_dense(w))
        before = T.measurement_count()
        plan = build_advance(g, num_blocks=8, measure=False)
        want = ref["sparse"].build_advance(jg, num_blocks=8, measure=False)
        assert T.measurement_count() == before
        assert (plan.schedule.value, plan.push_schedule.value) == \
            (want.schedule.value, want.push_schedule.value)
        seen = []
        build_advance(g, num_blocks=8, workload="advance_serve",
                      measure=lambda d, p: seen.append(d) or 2.0)
        assert seen.count("pull") == 3 and seen.count("push") == 3
        _fresh_default_cache(monkeypatch)
        build_advance(g, num_blocks=8, workload="advance_delta")
        assert T.measurement_count() == before + 6
        _fresh_default_cache(monkeypatch)
        build_advance(g, num_blocks=8, workload="advance_delta")
        assert T.measurement_count() == before + 6

    def test_build_advance_views(self, monkeypatch):
        from repro_torch.sparse import build_advance_views
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        g = graph_of(_powerlaw(4))
        pull = g.csr.transpose()
        kw = dict(pull_spec=pull.workspec(), pull_src=pull.col_indices,
                  pull_weight=pull.values, push_spec=g.csr.workspec(),
                  push_dst=g.csr.col_indices, push_weight=g.csr.values,
                  num_vertices=g.num_vertices, num_blocks=8)
        before = T.measurement_count()
        build_advance_views(**kw)
        assert T.measurement_count() == before
        seen = []
        build_advance_views(
            **kw, workload="wavefront",
            pull_measure=lambda p: seen.append(("pull", p)) or 1.0,
            push_measure=lambda p: seen.append(("push", p)) or 2.0)
        assert [d for d, _ in seen] == ["pull"] * 3 + ["push"] * 3
        measured = {k.rsplit(".", 1)[-1]: r.measured_us
                    for k, r in TA._DEFAULT_CACHE.records().items()
                    if r.is_measured}
        assert set(measured) == {"wavefront", "wavefront_push"}
        assert set(measured["wavefront_push"].values()) == {2.0}

    def test_build_wavefront(self, monkeypatch):
        from repro_torch.sparse import build_wavefront
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        w = np.triu(_powerlaw(5), 1)
        before = T.measurement_count()
        plan = build_wavefront(graph_of(w), num_blocks=8, measure=False)
        assert T.measurement_count() == before and plan.num_levels > 1
        seen = []
        build_wavefront(graph_of(w), num_blocks=8,
                        measure=lambda d, p: seen.append(d) or 1.0)
        assert sorted(set(seen)) == ["pull", "push"]

    def test_grouped_matmul_and_resolve_schedule(self, ref, monkeypatch):
        from repro_torch.kernels.segmm import ops as SO
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        rng = np.random.default_rng(6)
        E, T_, K, N = 4, 40, 16, 16
        eot = rng.integers(0, E, T_).astype(np.int32)
        tokens = rng.standard_normal((T_, K)).astype(np.float32)
        rhs = rng.standard_normal((E, K, N)).astype(np.float32)
        before = T.measurement_count()
        got = SO.resolve_schedule(t32(eot), E, measure=False)
        monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE")
        # (the reference calls a False measure when its gate is on)
        assert got == ref["segmm"].resolve_schedule(jnp.asarray(eot), E,
                                                    measure=False)
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        kw = dict(num_experts=E, bm=8, bn=16, bk=16, schedule="auto")
        model = SO.grouped_matmul(t32(tokens), t32(eot), t32(rhs),
                                  measure=False, **kw)
        assert T.measurement_count() == before
        measured = SO.grouped_matmul(t32(tokens), t32(eot), t32(rhs), **kw)
        assert T.measurement_count() == before + 3
        np.testing.assert_allclose(np_of(measured), np_of(model),
                                   rtol=1e-5, atol=1e-5)
        seen = []
        SO.resolve_schedule(t32(eot), E, num_blocks=5,
                            measure=lambda p: seen.append(p) or 1.0)
        assert len(seen) == 3

    def test_moe_sorted(self, monkeypatch):
        from repro_torch.models.moe import moe_init, moe_sorted
        gen = torch.Generator().manual_seed(0)
        params, _ = moe_init(gen, 16, 16, 4, 0, "swiglu", device="cpu")
        x = torch.randn(1, 12, 16, generator=gen)
        kw = dict(num_experts=4, top_k=2, bm=8, schedule="auto")
        before = T.measurement_count()
        model, aux = moe_sorted(params, x, **kw)
        assert T.measurement_count() == before
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        _fresh_default_cache(monkeypatch)
        measured, maux = moe_sorted(params, x, **kw)
        assert T.measurement_count() == before + 3
        torch.testing.assert_close(measured, model, rtol=1e-5, atol=1e-5)
        assert float(maux) == float(aux)

    def test_graph_server(self, monkeypatch):
        from repro_torch.serve.graph import GraphServer
        monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
        g = graph_of(_powerlaw(7))
        before = T.measurement_count()
        GraphServer(g, lanes=2, num_blocks=8, measure=False)
        assert T.measurement_count() == before
        seen = []
        srv = GraphServer(g, lanes=2, num_blocks=8,
                          measure=lambda d, p: seen.append(d) or 1.0)
        assert len(seen) == 6
        keys = TA._DEFAULT_CACHE.records()
        assert any(k.endswith("|plan.advance_serve") for k in keys)
        assert any(k.endswith("|plan.advance_serve_push") for k in keys)
        assert srv.serve([("bfs", 0)])[0].kind == "bfs"
