"""Port parity: sparse formats, the generators and merge-path SpMV.

The generators draw from numpy's RNG as the reference does, so matrices
must be identical bit for bit.  SpMV results are real-valued sums in
another order, held to rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.sparse as TS
from repro.kernels.spmv_merge import ops as JO
from repro_torch.interop import csr_from_arrays
from repro_torch.kernels.spmv_merge import ops as TO

from _torch_parity import np_of, reference_sparse, t32
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def rs():
    with reference_sparse() as module:
        yield module


@pytest.fixture
def autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)


def assert_same_csr(tA, jA):
    assert tA.shape == tuple(jA.shape) and tA.nnz == jA.nnz
    for name in ("row_offsets", "col_indices", "values"):
        got, want = np_of(getattr(tA, name)), np_of(getattr(jA, name))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.astype(got.dtype).view(np.uint32),
                                      err_msg=name)


def port_csr(jA):
    return csr_from_arrays(np_of(jA.row_offsets), np_of(jA.col_indices),
                           np_of(jA.values), tuple(jA.shape), device="cpu")


class TestFormats:
    @pytest.mark.parametrize("args", [
        (300, 300, 3000, 1.3, 0.3, 0), (64, 2000, 900, 0.0, 0.0, 4),
        (500, 1, 200, 0.0, 0.5, 2), (40, 40, 0, 0.9, 0.0, 1)])
    def test_random_csr_identical(self, rs, args):
        rows, cols, nnz, skew, ef, seed = args
        kw = dict(skew=skew, empty_frac=ef, seed=seed)
        assert_same_csr(TS.random_csr(rows, cols, nnz, device="cpu", **kw),
                        rs.random_csr(rows, cols, nnz, **kw))

    @pytest.mark.parametrize("smoke", [True, False])
    def test_suite_like_corpus_identical(self, rs, smoke):
        got = TS.suite_like_corpus(3, smoke=smoke, device="cpu")
        want = rs.suite_like_corpus(3, smoke=smoke)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, tA), (_, jA) in zip(got, want):
            assert_same_csr(tA, jA)

    def test_transpose_coo_dense(self, rs):
        jA = rs.random_csr(90, 70, 900, skew=1.1, empty_frac=0.2, seed=5)
        tA = port_csr(jA)
        assert_same_csr(tA.transpose(), jA.transpose())
        np.testing.assert_array_equal(tA.to_dense(), jA.to_dense())
        dense = jA.to_dense().astype(np.float32)
        assert_same_csr(TS.CSR.from_dense(dense, device="cpu"),
                        rs.CSR.from_dense(dense))
        coo = tA.to_coo()
        assert_same_csr(coo.to_csr(), jA)
        assert coo.workspec().num_tiles == 90

    def test_csc(self, rs):
        jA = rs.random_csr(30, 50, 200, skew=0.5, seed=6)
        tA = port_csr(jA)
        csc = TS.CSC(tA.row_offsets, tA.col_indices, tA.values, (50, 30),
                     tA.nnz)
        assert csc.to_csr_of_transpose().shape == (30, 50)
        assert csc.workspec().num_tiles == 30


class TestSpMV:
    @pytest.mark.parametrize("schedule", [None, "chunked_lpt", "auto"])
    def test_merge_path_matches_reference(self, rs, autotune_cache,
                                          schedule):
        for name, jA in rs.suite_like_corpus(0, smoke=True):
            x = np.random.default_rng(1).standard_normal(
                jA.shape[1]).astype(np.float32)
            want = np_of(JO.spmv_merge_path(jA, jnp.asarray(x),
                                            schedule=schedule,
                                            measure=False))
            tA = port_csr(jA)
            for path in ("auto", "pure", "native"):
                got = TO.spmv_merge_path(tA, t32(x), schedule=schedule,
                                         execution_path=path)
                np.testing.assert_allclose(np_of(got), want, rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=f"{name}/{path}")

    @pytest.mark.parametrize("schedule", ["chunked_rr", "adaptive",
                                          "merge_path", "group_mapped"])
    @pytest.mark.parametrize("num_blocks", [None, 7, 400])
    def test_schedules_match_oracle(self, schedule, num_blocks):
        for name, A in TS.suite_like_corpus(0, smoke=True, device="cpu"):
            x = torch.from_numpy(np.random.default_rng(2).standard_normal(
                A.shape[1]).astype(np.float32))
            want = TS.spmv_reference(A, x)
            for path in ("pure", "native"):
                got = TO.spmv_merge_path(A, x, schedule=schedule,
                                         num_blocks=num_blocks,
                                         execution_path=path)
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)

    def test_sparse_ops(self, rs):
        jA = rs.random_csr(200, 150, 2500, skew=1.2, empty_frac=0.1, seed=8)
        tA = port_csr(jA)
        rng = np.random.default_rng(9)
        x = rng.standard_normal(150).astype(np.float32)
        B = rng.standard_normal((150, 3)).astype(np.float32)
        want = np_of(rs.spmv_reference(jA, jnp.asarray(x)))
        np.testing.assert_allclose(np_of(TS.spmv_reference(tA, t32(x))),
                                   want, rtol=RTOL, atol=ATOL)
        for impl in ("blocked", "pallas", "reference"):
            for schedule in (None, "merge_path", "thread_mapped"):
                got = TS.spmv(tA, t32(x), schedule=schedule, impl=impl)
                np.testing.assert_allclose(np_of(got), want, rtol=RTOL,
                                           atol=ATOL, err_msg=impl)
        np.testing.assert_allclose(
            np_of(TS.spmm(tA, t32(B))),
            np_of(rs.spmm(jA, jnp.asarray(B))), rtol=RTOL, atol=ATOL)
        idx = np.asarray([3, 7, 100], np.int32)
        np.testing.assert_allclose(
            float(TS.spvv(t32(x[:3]), t32(idx), t32(x))),
            float(rs.spvv(jnp.asarray(x[:3]), jnp.asarray(idx),
                          jnp.asarray(x))), rtol=RTOL)
        with pytest.raises(ValueError, match="impl"):
            TS.spmv(tA, t32(x), impl="kernel")
