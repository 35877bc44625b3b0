"""Port parity: the packages' exports, and the segment primitives' call
signatures and CPU results, against the live JAX reference.

``repro.models``, ``repro.sparse`` and ``repro.serve.graph`` import
``repro.compat``, so they are imported through
``_torch_parity.reference_modules`` in a module-scoped fixture.  Every name of a reference ``__all__`` is either exported by the
port or listed below as not ported yet; a name listed there must be absent
from the port, so the lists shrink as the port grows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
import repro_torch.models as TM
import repro_torch.serve.graph as TSG
import repro_torch.sparse as TS
from repro_torch.kernels.spmv_merge import kernel as TK

from _torch_parity import assert_bitwise, np_of, reference_modules
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)

#: Reference exports the port does not have yet: the frontend's
#: jax.ShapeDtypeStruct helper (ROADMAP queue 1 item 5).
MODELS_NOT_PORTED = {"frontend_embed_shape"}

#: Every sparse and core name is ported (the sharded traversal, its
#: executors, cost terms and plans since the sharding slice).
SPARSE_NOT_PORTED = set()
CORE_NOT_PORTED = set()

PACKAGES = ("models", "sparse", "core", "serve.graph")


@pytest.fixture(scope="module")
def ref():
    with reference_modules(*(f"repro.{p}" for p in PACKAGES)) as modules:
        yield dict(zip(PACKAGES, modules))


@pytest.mark.parametrize("package,port,not_ported", [
    ("models", TM, MODELS_NOT_PORTED), ("sparse", TS, SPARSE_NOT_PORTED),
    ("core", T, CORE_NOT_PORTED), ("serve.graph", TSG, set())],
    ids=PACKAGES)
def test_all_holds_every_ported_name(ref, package, port, not_ported):
    want = set(ref[package].__all__)
    assert not_ported <= want, sorted(not_ported - want)
    assert want - not_ported <= set(port.__all__), \
        sorted(want - not_ported - set(port.__all__))
    assert not not_ported & set(port.__all__)
    assert not [n for n in not_ported if hasattr(port, n)]
    for name in port.__all__:
        assert hasattr(port, name), name
    assert len(port.__all__) == len(set(port.__all__))


def test_models_forward_is_importable():
    from repro_torch.models import forward
    from repro_torch.models.lm import forward as lm_forward
    assert forward is lm_forward


def test_sparse_wavefront_names_are_the_modules():
    from repro_torch.sparse import wavefront as W
    for name in ("build_wavefront", "wavefront_eval", "pack_forest",
                 "topological_levels", "WavefrontPlan", "PackedForest"):
        assert getattr(TS, name) is getattr(W, name)


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_exclusive_cumsum_axis(axis, dtype):
    x = np.random.default_rng(3).integers(-5, 9, (6, 11)).astype(dtype)
    want = J.segops.exclusive_cumsum(jnp.asarray(x), axis=axis)
    got = T.segops.exclusive_cumsum(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(np_of(got), np_of(want))
    np.testing.assert_array_equal(
        np_of(T.segops.exclusive_cumsum(torch.from_numpy(x))),
        np_of(J.segops.exclusive_cumsum(jnp.asarray(x))))


#: (ids, num_segments) cases: sorted, unsorted, empty segments, long runs.
def _ids(name, rng):
    if name == "sorted":
        return np.sort(rng.integers(0, 40, 500)), 40
    if name == "unsorted":
        return rng.integers(0, 300, 5000), 300
    if name == "empty_segments":
        return rng.choice([0, 5, 999], 700), 1000
    return np.concatenate([np.full(4000, 2), rng.integers(0, 9, 99)]), 9


@pytest.mark.parametrize("name", ["sorted", "unsorted", "empty_segments",
                                  "one_long_run"])
def test_segment_sum_on_cpu_is_unchanged(name):
    """On CPU tensors a float sum stays ``index_add_``: bitwise equal to
    the reference on integer-valued data, to ``index_add_`` on real data,
    and no kernel launch is counted."""
    rng = np.random.default_rng(4)
    ids, num = _ids(name, rng)
    tids = torch.from_numpy(ids.astype(np.int32))
    before = dict(TK.LAUNCHES)
    for vals in (rng.integers(-8, 9, ids.shape[0]).astype(np.float32),
                 rng.integers(-8, 9, ids.shape[0]).astype(np.int32)):
        got = T.segops.segment_reduce("sum", torch.from_numpy(vals), tids,
                                      num)
        want = J.segops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), num)
        np.testing.assert_array_equal(np_of(got), np_of(want))
    reals = torch.from_numpy(rng.standard_normal(ids.shape[0])
                             .astype(np.float32))
    assert_bitwise(T.segops.segment_sum(reals, tids, num),
                   torch.zeros(num).index_add_(0, tids.long(), reals))
    assert TK.LAUNCHES == before


def test_segment_sum_sorted_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 70, 900)
    tids = torch.from_numpy(ids.astype(np.int32))
    keys, order = torch.sort(tids, stable=True)
    vals = torch.from_numpy(rng.standard_normal(900))
    before = dict(TK.LAUNCHES)
    got = TK.segment_sum_sorted(vals, keys, 70, order=order)
    assert TK.LAUNCHES == before and got.dtype == torch.float64
    np.testing.assert_allclose(np_of(got), np.bincount(
        ids, weights=np_of(vals), minlength=70), rtol=1e-12, atol=1e-12)
    assert_bitwise(T.segops.ordered_sum(vals.float(), tids, 70),
                   TK.segment_sum_sorted(vals.float(), keys, 70, order=order))


def test_segment_sum_sorted_checks_its_operands():
    keys = torch.zeros(4, dtype=torch.int32)
    order = torch.arange(4)
    with pytest.raises(TypeError, match="float32 or float64"):
        TK.segment_sum_sorted(torch.ones(4, dtype=torch.int32), keys, 3,
                              order)
    with pytest.raises(TypeError, match="int32"):
        TK.segment_sum_sorted(torch.ones(4), keys.long(), 3, order)
    with pytest.raises(ValueError, match="entries"):
        TK.segment_sum_sorted(torch.ones(4), keys, 3, order[:3])
    with pytest.raises(ValueError, match="device"):
        TK.segment_sum_sorted(torch.ones(4, device="meta"),
                              keys.to("meta"), 3, order.to("meta"))
    with pytest.raises(ValueError, match=r"\[n\] or \[n, B\]"):
        T.segops.ordered_sum(torch.ones(4, 2, 2), keys, 3)
