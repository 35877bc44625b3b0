"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card the ``card`` fixture skips them.  They
import no JAX, so they run where only the port is installed (README,
"PyTorch port"):
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the shared conftest clears
JAX's caches).

Integer-valued sums and min/max are compared bitwise; real-valued sums to
a relative 1e-5 (the plain versions add in atomic order on the card, the
kernels in a fixed order).
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels.spmv_merge import kernel as TK
from repro_torch.kernels.spmv_merge import ops as TO
from repro_torch.sparse import (Graph, bfs, delta_stepping, pagerank,
                                random_csr, spmm, spmv_reference, sssp)

from _torch_parity import assert_bitwise

pytestmark = pytest.mark.cuda

SCHEDULES = ("thread_mapped", "group_mapped", "nonzero_split", "merge_path",
             "chunked", "adaptive")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _spec(sizes, device):
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return T.WorkSpec.from_segment_offsets(offsets,
                                           num_atoms=int(offsets[-1]),
                                           device=device)


#: Tile sizes that stress the sorted-window reduction: one tile across
#: every warp slice, long empty runs, many one-atom tiles, short windows.
SIZES = {
    "giant_tile": [3, 20_000, 0, 0, 7],
    "empty_runs": ([0] * 300 + [5] + [0] * 40 + [900]) * 5,
    "singletons": [1] * 5000,
    "powerlaw": (np.random.default_rng(0).zipf(1.4, 4000) % 3000).tolist(),
    "tiny": [2, 0, 1],
}


@pytest.mark.parametrize("integer_valued", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "min", "max"])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_tile_reduce_kernel(card, name, combiner, masked, integer_valued):
    spec = _spec(SIZES[name], card)
    rng = np.random.default_rng(1)
    n = spec.num_atoms
    vals = (rng.integers(-8, 9, n) if integer_valued
            else rng.standard_normal(n)).astype(np.float32)
    tv = torch.from_numpy(vals).to(card)
    mask = (torch.from_numpy(rng.random(n) < 0.7).to(card)
            if masked else None)
    want = T.tile_reduce(spec, lambda a: tv[a], combiner=combiner,
                         atom_mask=mask)
    for schedule in SCHEDULES:
        for blocks in (7, 264):
            part = T.make_partition(spec, schedule, blocks)
            before = TK.LAUNCHES["chunk_walk_tiles"]
            got = T.execute_tile_reduce(spec, part, lambda a: tv[a],
                                        path="native", combiner=combiner,
                                        atom_mask=mask)
            assert TK.LAUNCHES["chunk_walk_tiles"] == before + 1
            plain = T.execute_tile_reduce(spec, part, lambda a: tv[a],
                                          path="pure", combiner=combiner,
                                          atom_mask=mask)
            tag = f"{schedule}/{blocks}"
            if integer_valued or combiner != "sum":
                assert_bitwise(got, want, tag)
                assert_bitwise(got, plain, tag)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4,
                                           msg=tag)


@pytest.mark.parametrize("combiner", ["sum", "min", "max"])
def test_chunk_walk_partials_match_plain(card, combiner):
    """The raw [C, L] partials, kernel vs plain version, bitwise."""
    spec = _spec(SIZES["powerlaw"], card)
    part = T.make_partition(spec, "chunked", 33)
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.integers(-8, 9, spec.num_atoms)
                            .astype(np.float32)).to(card)
    mask = torch.from_numpy(rng.random(spec.num_atoms) < 0.5).to(card)
    idx, _ = T.compact_active_atoms(mask, spec.num_atoms // 2)
    for emit, extra in (("tiles", dict(atom_mask=mask)),
                        ("atoms", dict(atom_mask=mask)),
                        ("compact", dict(idx=idx))):
        args, kw = T.execute.chunk_walk_operands(
            spec, part, vals, combiner=combiner, emit=emit, **extra)
        got = TK.chunk_walk_reduce(*args, **kw)
        torch.cuda.synchronize()
        assert_bitwise(got, TK.chunk_walk_reduce_ref(*args, **kw), emit)


def test_sum_kernel_is_deterministic(card):
    spec = _spec(SIZES["giant_tile"], card)
    part = T.make_partition(spec, "merge_path", 3)
    gen = torch.Generator().manual_seed(0)
    vals = torch.randn(spec.num_atoms, generator=gen).to(card)
    runs = [T.execute_tile_reduce(spec, part, lambda a: vals[a],
                                  path="native") for _ in range(3)]
    for r in runs[1:]:
        assert_bitwise(r, runs[0])


@pytest.mark.parametrize("capacity", [None, 5, 100_000])
@pytest.mark.parametrize("combiner", ["sum", "min"])
def test_scatter_reduce_kernels(card, combiner, capacity):
    spec = _spec(SIZES["powerlaw"], card)
    rng = np.random.default_rng(3)
    n = spec.num_atoms
    vals = torch.from_numpy(rng.integers(-8, 9, n).astype(np.float32)).to(card)
    mask = torch.from_numpy(rng.random(n) < 0.3).to(card)
    out_ids = torch.from_numpy(rng.integers(0, 700, n).astype(np.int32)
                               ).to(card)
    want = T.segops.segment_reduce(
        combiner, torch.where(mask, vals, T.COMBINER_IDENTITY[combiner]),
        out_ids, 700).cpu()
    for schedule in SCHEDULES:
        part = T.make_partition(spec, schedule, 40)
        got = T.execute_scatter_reduce(spec, part, lambda a: vals[a], out_ids,
                                       700, path="native", combiner=combiner,
                                       atom_mask=mask,
                                       compact_capacity=capacity)
        assert_bitwise(got, want, schedule)


@pytest.mark.parametrize("schedule", [None, "chunked_lpt", "adaptive"])
def test_spmv_merge_path(card, schedule):
    A = random_csr(3000, 3000, 60_000, skew=1.3, empty_frac=0.3, seed=4,
                   device=card)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(3000)
                         .astype(np.float32)).to(card)
    before = dict(TK.LAUNCHES)
    y = TO.spmv_merge_path(A, x, schedule=schedule, num_blocks=264)
    torch.testing.assert_close(y, spmv_reference(A, x), rtol=1e-5, atol=1e-4)
    name = "spmv_merge_stream" if schedule is None else "chunk_walk_tiles"
    assert TK.LAUNCHES[name] == before[name] + 1


def test_spmm_runs_the_tiles_kernel(card):
    make = lambda device: random_csr(2000, 1500, 30_000, skew=1.3,
                                     empty_frac=0.3, seed=6, device=device)
    B = torch.from_numpy(np.random.default_rng(7).standard_normal((1500, 3))
                         .astype(np.float32))
    want = spmm(make("cpu"), B)
    before = TK.LAUNCHES["chunk_walk_tiles"]
    got = spmm(make(card), B.to(card))
    assert TK.LAUNCHES["chunk_walk_tiles"] == before + 3
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


def test_graph_drivers_match_cpu(card):
    rng = np.random.default_rng(3)
    V = 300
    degree = np.minimum(rng.zipf(1.6, V), V - 1)
    w = np.zeros((V, V), np.float32)
    for u in range(V):
        w[u, rng.choice(V, size=degree[u], replace=False)] = \
            rng.integers(1, 8, degree[u])
    gc, gg = Graph.from_dense(w, device="cpu"), Graph.from_dense(w,
                                                                 device=card)
    for schedule in ("chunked_lpt", "merge_path"):
        kw = dict(schedule=schedule, path="native", num_blocks=24)
        for run in (lambda g: bfs(g, 5, return_parents=True, **kw),
                    lambda g: (sssp(g, 5, **kw),),
                    lambda g: (delta_stepping(g, 5, **kw),)):
            for got, want in zip(run(gg), run(gc)):
                assert_bitwise(got.float(), want.float())
        torch.testing.assert_close(pagerank(gg, **kw).cpu(),
                                   pagerank(gc, **kw), rtol=1e-5, atol=1e-7)
