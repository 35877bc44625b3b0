"""Port parity: WorkSpec, segment ops, cost models and the autotuner.

The same tile sizes go through ``repro.core`` (JAX) and
``repro_torch.core`` (PyTorch on the CPU); cost-model values must be
equal as floats and the autotuner must pick the same plan.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T

from _torch_parity import (CPU, assert_same_partition, np_of, spec_pair,
                           t32, zoo)


class TestWorkSpec:
    @pytest.mark.parametrize("name", sorted(zoo()))
    def test_derived_arrays(self, name):
        jspec, tspec = spec_pair(zoo()[name])
        assert (tspec.num_atoms, tspec.num_tiles) == (jspec.num_atoms,
                                                       jspec.num_tiles)
        np.testing.assert_array_equal(np_of(tspec.atom_tile_ids()),
                                      np_of(jspec.atom_tile_ids()))
        np.testing.assert_array_equal(np_of(tspec.atoms_per_tile()),
                                      np_of(jspec.atoms_per_tile()))
        assert tspec.total_work() == jspec.total_work()
        T.validate_workspec(tspec)

    def test_constructors(self):
        sizes = np.asarray([3, 0, 2, 5], np.int32)
        spec = T.WorkSpec.from_segment_sizes(sizes, num_atoms=10,
                                             device="cpu")
        np.testing.assert_array_equal(np_of(spec.tile_offsets),
                                      [0, 3, 3, 5, 10])
        ids = np.repeat(np.arange(4), sizes)
        spec2 = T.WorkSpec.from_sorted_tile_ids(ids, num_tiles=4,
                                                num_atoms=10, device="cpu")
        np.testing.assert_array_equal(np_of(spec2.tile_offsets),
                                      np_of(spec.tile_offsets))
        assert spec.device == CPU

    def test_validate_rejects_bad_offsets(self):
        spec = T.WorkSpec.from_segment_offsets(np.asarray([0, 3, 2]),
                                               num_atoms=2, device="cpu")
        with pytest.raises(ValueError, match="non-decreasing"):
            T.validate_workspec(spec)

    def test_segops(self):
        rng = np.random.default_rng(1)
        vals = rng.standard_normal(40).astype(np.float32)
        ids = np.sort(rng.integers(0, 7, 40))
        js = J.segops
        np.testing.assert_allclose(
            np_of(T.segops.segment_softmax(t32(vals), t32(ids), 7)),
            np_of(js.segment_softmax(jnp.asarray(vals), jnp.asarray(ids), 7)),
            rtol=1e-6)
        np.testing.assert_array_equal(
            np_of(T.segops.segment_count(t32(ids), 7)),
            np_of(js.segment_count(jnp.asarray(ids), 7)))


class TestCostModel:
    @pytest.mark.parametrize("name", ["uniform", "one_heavy", "powerlaw",
                                      "empty_runs", "powerlaw_big"])
    def test_models_equal(self, name):
        jspec, tspec = spec_pair(zoo()[name])
        for schedule in ("thread_mapped", "group_mapped", "nonzero_split",
                         "merge_path", "chunked", "adaptive"):
            for path in ("pure", "native"):
                for work in (1, 2, 0.375):
                    assert T.modeled_cost(tspec, schedule, 8, path=path,
                                          atom_work=work) == \
                        J.modeled_cost(jspec, schedule, 8, path=path,
                                       atom_work=work)
            for direction in ("pull", "push"):
                assert T.modeled_advance_cost(
                    tspec, schedule, 8, direction=direction, density=0.3) \
                    == J.modeled_advance_cost(jspec, schedule, 8,
                                              direction=direction,
                                              density=0.3)
        assert T.modeled_advance_cost(tspec, "merge_path", 8,
                                      direction="push",
                                      window_mode="compact") == \
            J.modeled_advance_cost(jspec, "merge_path", 8, direction="push",
                                   window_mode="compact")
        assert T.ImbalanceStats.measure(tspec) == \
            T.ImbalanceStats(**vars(J.ImbalanceStats.measure(jspec)))
        assert T.landscape(tspec, 8, include_dynamic=True) == \
            J.landscape(jspec, 8, include_dynamic=True)

    def test_direction_threshold_and_capacity(self):
        jpull, tpull = spec_pair(zoo()["powerlaw_big"])
        jpush, tpush = spec_pair(zoo()["powerlaw"] * 40)
        for pull_s, push_s in [("merge_path", "chunked"),
                               ("group_mapped", "adaptive")]:
            want = J.estimate_direction_threshold(
                jpull, jpush, 8, pull_schedule=pull_s, push_schedule=push_s)
            got = T.estimate_direction_threshold(
                tpull, tpush, 8, pull_schedule=pull_s, push_schedule=push_s)
            assert got == want
            assert T.estimate_compact_capacity(5000, got) == \
                J.estimate_compact_capacity(5000, want)

    def test_choose_schedule(self):
        for tiles, atoms in [(10, 15), (10, 400), (900, 20_000)]:
            assert T.choose_schedule(tiles, atoms).value == \
                J.choose_schedule(tiles, atoms).value


class TestAutotune:
    @pytest.mark.parametrize("workload", ["reduce", "advance",
                                          "advance_push", "advance_delta",
                                          "advance_delta_push"])
    def test_same_plan(self, workload, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                           str(tmp_path / "autotune.json"))
        monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)
        memo = {}
        for name in ("uniform", "one_heavy", "powerlaw", "empty_runs",
                     "powerlaw_big", "empty"):
            jspec, tspec = spec_pair(zoo()[name])
            for num_blocks in (4, 32):
                want = J.select_plan(jspec, num_blocks, workload=workload)
                got = T.select_plan(tspec, num_blocks, workload=workload,
                                    cache=memo)
                assert got.encode() == want.encode(), (name, num_blocks)
                assert T.select_plan(tspec, num_blocks, workload=workload,
                                     cache=memo) == got
                scores = T.score_plans(tspec, num_blocks, workload=workload)
                want_scores = J.score_plans(jspec, num_blocks,
                                            workload=workload)
                assert {p.encode(): c for p, c in scores.items()} == \
                    {p.encode(): c for p, c in want_scores.items()}

    def test_select_schedule_and_auto_partition(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                           str(tmp_path / "autotune.json"))
        jspec, tspec = spec_pair(zoo()["powerlaw_big"])
        assert T.select_schedule(tspec, 16, cache=None).value == \
            J.select_schedule(jspec, 16).value
        assert_same_partition(J.make_partition(jspec, "auto", 16),
                              T.make_partition(tspec, "auto", 16))
