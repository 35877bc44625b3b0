"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

The same numpy inputs go through the JAX reference (``repro``) and the
PyTorch port (``repro_torch``, on the CPU), and the outputs are compared as
numpy arrays.

``repro.sparse``, ``repro.models``, ``repro.kernels.segmm.ops`` and the
other modules that import ``repro.compat`` trip over the installed jax at
import (``compat``'s batching-rule registration tests ``in`` on a proxy
table).  :func:`reference_modules` imports any list of reference modules
with that table swapped for a throwaway dict, restores the table at once —
the rule it would register exists in this jax already — and on exit drops
the ``repro`` modules it loaded, so later test files in the same worker see
the reference exactly as they would without it.  Enter it in a
module-scoped fixture, never at import or collection time, so every test
worker collects the same tests.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import sys

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def isolated_autotune_cache(tmp_path, monkeypatch):
    """Each test's autotune caches under its ``tmp_path``: the port's
    default cache starts empty and writes its own file there, the
    reference's writes its file there, and measured mode is off unless the
    test turns it on.  Autouse in every test module that imports it."""
    from repro_torch.core import autotune
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "port_autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                       str(tmp_path / "ref_autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_TOPK", raising=False)
    monkeypatch.setattr(autotune._DEFAULT_CACHE, "_mem", {})
    monkeypatch.setattr(autotune._DEFAULT_CACHE, "_loaded", False)


@functools.cache
def zoo() -> dict:
    """Every tile-size zoo entry of ``_conformance``, plus the empty spec,
    an all-empty one and a larger power law.  Built on first call, since
    ``_conformance`` imports JAX and the card tests import this module
    where only the port is installed."""
    from _conformance import HAZARD_WORKLOADS, WORKLOADS
    return {**WORKLOADS, **HAZARD_WORKLOADS, "empty": [],
            "all_empty_tiles": [0, 0, 0],
            "powerlaw_big": (np.random.default_rng(0).zipf(1.6, 300) % 97)
            .tolist()}

#: (schedule, chunk policy): the six registered schedules, the chunked
#: queue under both policies, and a group-mapped alias.
SCHEDULES = [("thread_mapped", "lpt"), ("group_mapped", "lpt"),
             ("warp_mapped", "lpt"), ("nonzero_split", "lpt"),
             ("merge_path", "lpt"), ("chunked", "lpt"),
             ("chunked", "round_robin"), ("adaptive", "lpt")]


def assert_same_partition(jpart, tpart) -> None:
    """Every Partition field equal (arrays integer-equal)."""
    from repro_torch.interop import partition_to_arrays
    want = partition_to_arrays(jpart)
    got = partition_to_arrays(tpart)
    assert got.keys() == want.keys()
    for name, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[name], value, err_msg=name)
        else:
            assert got[name] == value, name


@contextlib.contextmanager
def reference_modules(*names: str):
    """The reference modules ``names`` (dotted), imported on this jax, for
    the duration of the context; yields them in order."""
    from jax.interpreters import batching
    before = set(sys.modules)
    saved = batching.primitive_batchers
    batching.primitive_batchers = {}
    try:
        importlib.import_module("repro.compat")
    finally:
        batching.primitive_batchers = saved
    try:
        yield tuple(importlib.import_module(name) for name in names)
    finally:
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name.split(".")[0] != "repro":
                continue
            module = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if getattr(sys.modules.get(parent), child, None) is module:
                delattr(sys.modules[parent], child)


@contextlib.contextmanager
def reference_sparse():
    """``repro.sparse`` (and ``repro.compat``), importable on this jax, for
    the duration of the context."""
    with reference_modules("repro.sparse") as (module,):
        yield module


def np_of(x) -> np.ndarray:
    """A jax array, torch tensor or array-like as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t32(x) -> torch.Tensor:
    """numpy -> CPU torch, int32 for integer arrays, float32 for floats."""
    arr = np.asarray(x)
    dtype = np.float32 if np.issubdtype(arr.dtype, np.floating) else np.int32
    return torch.from_numpy(np.array(arr, dtype))


def assert_bitwise(got, want, msg: str = "") -> None:
    """Equal bits as float32 (NaN/inf/-0.0 included)."""
    np.testing.assert_array_equal(
        np.asarray(np_of(got), np.float32).view(np.uint32),
        np.asarray(np_of(want), np.float32).view(np.uint32), err_msg=msg)


def spec_pair(sizes):
    """The same tile sizes as a reference and a port WorkSpec."""
    import jax.numpy as jnp
    from repro.core import WorkSpec as JWorkSpec
    from repro_torch.core import WorkSpec

    sizes = np.asarray(sizes, np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    num_atoms = int(offsets[-1])
    return (JWorkSpec.from_segment_offsets(jnp.asarray(offsets),
                                           num_atoms=num_atoms),
            WorkSpec.from_segment_offsets(t32(offsets), num_atoms=num_atoms))


def graph_of(w):
    """A port Graph on the CPU from a dense weight matrix."""
    from repro_torch.sparse import Graph
    return Graph.from_dense(np.asarray(w, np.float32), device="cpu")


def medium_source(w) -> int:
    """A vertex of middling out-degree (a hub saturates in one step and
    hides the direction switch)."""
    deg = (np.asarray(w) > 0).sum(axis=1)
    order = np.argsort(deg, kind="stable")
    live = order[deg[order] > 0]
    return int(live[len(live) // 2]) if live.size else 0
