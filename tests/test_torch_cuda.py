"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card the ``card`` fixture skips them.  They
import no JAX, so they run where only the port is installed (README,
"PyTorch port"):
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the shared conftest clears
JAX's caches).

Integer-valued sums and min/max are compared bitwise (NaN bins by
position, then the other bits); real-valued sums to a relative 1e-5 (the
kernels and the plain versions add in different fixed orders), K2 on its
own operands to 1e-4 of the largest entry; the merge-path SpMV (K1)
likewise, and the compacted gather (K4)
bitwise, being a copy.  The ordered segment sum (``segment_sum_sorted``,
which every float segment sum on the card goes through) is held to a
float64 sum within 1e-5 of each segment's absolute sum, bitwise on
integer-valued data, and bitwise across runs; its sort-free form for
``fixup_partials`` (``segment_sum_fixup``) likewise, and bitwise to the
sorted route at every width.  The segmented-matmul
kernels (K5/K6) are held to their plain versions bitwise on integer-valued
operands and to rtol 1e-4 on real ones (5e-2 for bfloat16), and to each
other bitwise; on bf16 x bf16 operands (the tensor-core routes, counted
in ``segmm_wgmma`` or ``segmm_mma`` as ``kernel_for`` names them) every
real entry also lies within ``2 K 2**-24 sum|ab|`` of the plain version,
the float32 sum-order bound.  The banded sliding-window attention kernels (K7) are held
to their plain version at atol/rtol 2e-5 in float32, and for bfloat16
inputs to the float32 plain version on the same bf16-rounded inputs at
rtol 1e-2, atol 1e-4: the error there is the bf16 rounding of the output
(at most 2^-9 relative) and, on the tensor-core kernel, the rounding of
the probabilities split into two bf16 halves (about 2^-17 relative).
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels.flash_swa import kernel as FK
from repro_torch.kernels.segmm import kernel as SK
from repro_torch.kernels.segmm import ops as SO
from repro_torch.kernels.spmv_merge import kernel as TK
from repro_torch.kernels.spmv_merge import ops as TO
from repro_torch.sparse import (CSR, Graph, bfs, bfs_multi, build_advance,
                                build_sharded_advance, delta_stepping,
                                pagerank, random_csr, sharded_delta_stepping,
                                sharded_sssp, spmm, spmv_reference, sssp)

from _torch_parity import assert_bitwise
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("path", ["native", "pure"])
@pytest.mark.parametrize("blocks", [3, 264])
@pytest.mark.parametrize("name", ["giant_tile", "powerlaw", "empty_runs"])
def test_sum_kernel_is_deterministic(card, name, blocks, path):
    """Real-valued sums: bitwise across runs, up to 264 partials of one
    tile in the fixup."""
    spec = _spec(SIZES[name], card)
    part = T.make_partition(spec, "merge_path", blocks)
    gen = torch.Generator().manual_seed(0)
    vals = torch.randn(spec.num_atoms, generator=gen).to(card)
    runs = [T.execute_tile_reduce(spec, part, lambda a: vals[a],
                                  path=path) for _ in range(3)]
    for r in runs[1:]:
        assert_bitwise(r, runs[0])


#: K2 cases (tile sizes, blocks, schedule): chunk bases off a multiple of
#: 4; a hub tile across many chunks; chunks wider than a CTA's slice of
#: one column (16,384 atoms), so teams of CTAs skip the runs at their
#: slices' starts and read past their ends, a hub tile among them; chunks
#: with no atoms; a long run of empty tiles inside a chunk.
TILES_CASES = {
    "off4": ([3, 5, 2, 7, 1] * 900, 37, "chunked"),
    "hub": ([5, 60_000, 0, 3] + [2] * 500, 29, "chunked"),
    "hub_merge_path": ([5, 60_000, 0, 3] + [2] * 500, 29, "merge_path"),
    "hub_teams": ([5, 60_000, 0, 3] + [2] * 500, 2, "merge_path"),
    "wide_teams": ([3, 5, 2, 7, 1, 0, 40] * 8000, 5, "merge_path"),
    "empty_chunks": ([0] * 2000 + [3, 0, 1], 64, "merge_path"),
    "gaps": ([4] + [0] * 3000 + [6] + [0] * 40 + [9] * 300, 5, "chunked"),
}


def _tiles_operands(card, case, width, combiner, integer, seed=0):
    sizes, blocks, schedule = TILES_CASES[case]
    spec = _spec(sizes, card)
    part = T.make_partition(spec, schedule, blocks)
    rng = np.random.default_rng(seed + width)
    n = spec.num_atoms
    shape = (n,) if width == 1 else (n, width)
    vals = (rng.integers(-8, 9, shape) if integer
            else rng.standard_normal(shape)).astype(np.float32)
    if combiner != "sum":
        flat = vals.reshape(-1)
        flat[rng.integers(0, flat.size, 40)] = np.nan
    mask = torch.from_numpy(rng.random(n) < 0.8).to(card)
    return T.execute.chunk_walk_operands(
        spec, part, torch.from_numpy(vals).to(card), combiner=combiner,
        atom_mask=mask)


def _same_or_both_nan(got, want, msg=""):
    torch.cuda.synchronize()
    assert got.shape == want.shape, msg
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), msg
    assert_bitwise(got[~nan], want[~nan], msg)


@pytest.mark.parametrize("combiner,integer", [("sum", True),
                                              ("sum", False),
                                              ("min", True), ("max", True)])
@pytest.mark.parametrize("width", [1, 3, 4, 128])
@pytest.mark.parametrize("case", sorted(TILES_CASES))
def test_tiles_kernel_columns_match_plain(card, case, width, combiner,
                                         integer):
    """K2 on [A + window] and [A + window, B] values against its plain
    version: bitwise for min/max (NaN where a bin holds one) and
    integer-valued sums, rtol 1e-4 of the largest entry for real sums; the
    same bits on a second run."""
    args, kw = _tiles_operands(card, case, width, combiner, integer)
    before = TK.LAUNCHES["chunk_walk_tiles"]
    got = TK.chunk_walk_reduce(*args, **kw)
    again = TK.chunk_walk_reduce(*args, **kw)
    assert TK.LAUNCHES["chunk_walk_tiles"] == before + 2
    want = TK.chunk_walk_reduce_ref(*args, **kw)
    tag = f"{case}/{width}/{combiner}"
    assert_bitwise(again, got, tag)
    if combiner != "sum":
        assert bool(torch.isnan(want).any()), f"{tag}: no NaN bin to hold"
    if integer or combiner != "sum":
        _same_or_both_nan(got, want, tag)
    else:
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale, tag


def test_tiles_kernel_unaligned_operands(card):
    """Operands that start 4 bytes into an allocation take the scalar
    loads (one column) and stores (B columns)."""
    for width in (1, 4):
        args, kw = _tiles_operands(card, "off4", width, "sum", True)
        shifted = []
        for a in args:
            if a is None or a.dim() == 0:
                shifted.append(a)
                continue
            buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=card)
            view = buf[1:].view(a.shape)
            view.copy_(a)
            shifted.append(view)
        got = TK.chunk_walk_reduce(*shifted, **kw)
        assert_bitwise(got, TK.chunk_walk_reduce_ref(*args, **kw),
                       str(width))


@pytest.mark.parametrize("path", ["native", "pure"])
@pytest.mark.parametrize("combiner", ["sum", "min", "max"])
def test_batched_tile_reduce_matches_cpu(card, combiner, path):
    """[atoms, B] values through the executor: one kernel launch and one
    fixup, equal to the CPU plain version (integer-valued, so bitwise)."""
    spec_c = _spec(SIZES["powerlaw"], card)
    spec_h = _spec(SIZES["powerlaw"], "cpu")
    rng = np.random.default_rng(8)
    vals = torch.from_numpy(rng.integers(-8, 9, (spec_c.num_atoms, 128))
                            .astype(np.float32))
    mask = torch.from_numpy(rng.random(spec_c.num_atoms) < 0.6)
    want = T.tile_reduce(spec_h, lambda a: vals[a], combiner=combiner,
                         atom_mask=mask)
    vc, mc = vals.to(card), mask.to(card)
    part = T.make_partition(spec_c, "chunked", 264)
    before = TK.LAUNCHES["chunk_walk_tiles"]
    got = T.execute_tile_reduce(spec_c, part, lambda a: vc[a], path=path,
                                combiner=combiner, atom_mask=mc)
    assert TK.LAUNCHES["chunk_walk_tiles"] == before + (path == "native")
    assert_bitwise(got, want)


# ---------------------------------------------------------------------------
# The ordered segment sum (segment_sum_sorted).
# ---------------------------------------------------------------------------

def _segment_ids(name, rng):
    """(unsorted int32 ids, num_segments) of the ordered-sum cases."""
    if name == "giant":            # one 20,000-item segment among 5,000
        ids = np.concatenate([np.full(20_000, 3), rng.integers(0, 900, 5000)])
        return rng.permutation(ids), 900
    if name == "partials":         # 500 partials of each of 40 tiles, as
        starts = np.arange(500) * 37            # fixup_partials lays out
        ids = (starts[:, None] + np.arange(40)[None, :]).reshape(-1)
        return ids, int(ids.max()) + 1
    if name == "hub_partials":     # one 20,000-atom segment spread over 500
        rows = np.concatenate([np.full((500, 40), 7),   # partial rows
                               rng.integers(0, 60, (500, 10))], axis=1)
        return rng.permuted(rows, axis=1).reshape(-1), 60
    if name == "empty":            # most segments empty, long gaps
        ids = rng.choice([0, 7, 40_000, 40_001, 99_999], 3000)
        return ids, 100_000
    if name == "no_items":
        return np.zeros(0, np.int64), 5000
    return rng.integers(0, 3000, 50_000), 3000  # "unsorted"


SEGMENT_CASES = ["giant", "partials", "hub_partials", "empty", "no_items",
                 "unsorted"]


def _same_bits(got, want, msg=""):
    """Equal bits in the tensors' own type (float64 included)."""
    as_int = {torch.float32: torch.int32, torch.float64: torch.int64}
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape, msg
    assert torch.equal(got.view(as_int[got.dtype]),
                       want.view(as_int[want.dtype])), msg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", SEGMENT_CASES)
def test_segment_sum_sorted(card, name, dtype):
    rng = np.random.default_rng(11)
    ids, num = _segment_ids(name, rng)
    n = ids.shape[0]
    tids = torch.from_numpy(ids.astype(np.int32)).to(card)
    keys, order = torch.sort(tids, stable=True)
    # integer-valued: exact in any order, so bitwise against index_add_
    ints = torch.from_numpy(rng.integers(-8, 9, n)).to(dtype).to(card)
    before = TK.LAUNCHES["segment_sum_sorted"]
    got = TK.segment_sum_sorted(ints, keys, num, order=order)
    assert TK.LAUNCHES["segment_sum_sorted"] == before + 1
    want = torch.zeros(num, dtype=dtype, device=card).index_add_(
        0, tids.long(), ints)
    _same_bits(got, want, name)
    # real-valued: within 1e-5 of each segment's absolute sum of the
    # float64 sum, and the same bits on every run
    reals = rng.standard_normal(n)
    vals = torch.from_numpy(reals).to(dtype).to(card)
    runs = [TK.segment_sum_sorted(vals, keys, num, order=order)
            for _ in range(3)]
    for r in runs[1:]:
        _same_bits(r, runs[0], name)
    exact, scale = np.zeros(num), np.zeros(num)
    terms = vals.double().cpu().numpy()
    np.add.at(exact, ids, terms)
    np.add.at(scale, ids, np.abs(terms))
    err = np.abs(runs[0].double().cpu().numpy() - exact)
    assert (err <= 1e-5 * scale).all(), float(err.max())


@pytest.mark.parametrize("width", [3, 128])
@pytest.mark.parametrize("name", SEGMENT_CASES)
def test_segment_sum_sorted_columns(card, name, width):
    """[n, B] values: column j has the bits of the one-column call."""
    rng = np.random.default_rng(13)
    ids, num = _segment_ids(name, rng)
    n = ids.shape[0]
    keys, order = torch.sort(torch.from_numpy(ids.astype(np.int32))
                             .to(card), stable=True)
    vals = torch.from_numpy(rng.standard_normal((n, width))
                            .astype(np.float32)).to(card)
    before = TK.LAUNCHES["segment_sum_sorted"]
    got = TK.segment_sum_sorted(vals, keys, num, order=order)
    assert TK.LAUNCHES["segment_sum_sorted"] == before + 1
    assert got.shape == (num, width)
    for j in range(width):
        _same_bits(got[:, j].contiguous(), TK.segment_sum_sorted(
            vals[:, j].contiguous(), keys, num, order=order), f"{name}/{j}")


def test_segment_reduce_sums_through_the_ordered_kernel(card):
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(rng.integers(0, 50, 4000)).to(card)
    vals = torch.from_numpy(rng.standard_normal(4000).astype(np.float32)
                            ).to(card)
    before = TK.LAUNCHES["segment_sum_sorted"]
    runs = [T.segops.segment_reduce("sum", vals, ids, 50) for _ in range(3)]
    assert TK.LAUNCHES["segment_sum_sorted"] == before + 3
    for r in runs[1:]:
        assert_bitwise(r, runs[0])
    torch.testing.assert_close(runs[0].cpu(), T.segops.segment_reduce(
        "sum", vals.cpu(), ids.cpu(), 50), rtol=1e-5, atol=1e-5)
    half = T.segops.segment_reduce("sum", vals.bfloat16(), ids, 50)
    assert half.dtype == torch.bfloat16
    assert TK.LAUNCHES["segment_sum_sorted"] == before + 4
    # integer sums stay on index_add_ (exact in any order)
    counts = T.segops.segment_reduce("sum", torch.ones_like(ids), ids, 50)
    assert TK.LAUNCHES["segment_sum_sorted"] == before + 4
    assert int(counts.sum()) == 4000


def _fixup_layout(name, card):
    """(tile_starts int32 [C + 1], local_tiles, num_tiles) of the fixup
    cases: fixup_partials' layout of 500 chunks (some bins past the last
    tile), a hub tile that 500 chunks reach, and a real chunked_lpt
    partition."""
    if name == "partials":
        starts = np.arange(501) * 37
        return (torch.from_numpy(starts.astype(np.int32)).to(card), 40,
                499 * 37 + 20)
    if name == "hub_partials":
        starts = np.array([0] + [7] * 500 + [30, 55])
        return torch.from_numpy(starts.astype(np.int32)).to(card), 50, 60
    spec = _spec(SIZES["powerlaw"], card)
    part = T.schedules.finalize_partition(
        T.make_partition(spec, "chunked", 64))
    _, local_tiles = T.execute._window_sizes(spec, part)
    return part.tile_starts.to(torch.int32), local_tiles, spec.num_tiles


FIXUP_CASES = ["partials", "hub_partials", "chunked_lpt"]


@pytest.mark.parametrize("width", [1, 3, 8, 128])
@pytest.mark.parametrize("name", FIXUP_CASES)
def test_segment_sum_fixup_equals_the_sorted_route(card, name, width):
    """The sort-free fixup has the bits of the sorted route (a stable sort
    of the bins' tile ids, then segment_sum_sorted) at every width, one
    launch a call, the same bits on every run; integer-valued sums are
    bitwise equal to its plain version, real ones within 1e-5 of each
    tile's absolute sum of a float64 sum."""
    starts, local_tiles, num_tiles = _fixup_layout(name, card)
    chunks = int(starts.shape[0]) - 1
    rng = np.random.default_rng(17 + width)
    shape = (chunks, local_tiles) + (() if width == 1 else (width,))
    reals = rng.standard_normal(shape)
    reals[rng.random(shape) < 0.3] = 0.0
    vals = torch.from_numpy(reals.astype(np.float32)).to(card)
    gtid = starts[:-1, None].long() + torch.arange(
        local_tiles, device=card)[None, :]
    gtid = torch.where(gtid < num_tiles, gtid, num_tiles).reshape(-1)
    keys, order = torch.sort(gtid.to(torch.int32), stable=True)
    flat = vals.reshape(chunks * local_tiles, *shape[2:])
    before = dict(TK.LAUNCHES)
    runs = [TK.segment_sum_fixup(vals, starts, num_tiles) for _ in range(3)]
    assert TK.LAUNCHES["segment_sum_fixup"] == (
        before["segment_sum_fixup"] + 3)
    assert TK.LAUNCHES["segment_sum_sorted"] == before["segment_sum_sorted"]
    for r in runs[1:]:
        _same_bits(r, runs[0], name)
    sorted_route = TK.segment_sum_sorted(flat, keys, num_tiles + 1,
                                         order=order)[:-1]
    _same_bits(runs[0], sorted_route.contiguous(), f"{name}/{width}")
    want = TK.segment_sum_fixup_ref(vals.cpu(), starts.cpu(), num_tiles)
    exact = np.zeros((num_tiles + 1,) + shape[2:])
    scale = np.zeros_like(exact)
    terms = flat.double().cpu().numpy()
    np.add.at(exact, gtid.cpu().numpy(), terms)
    np.add.at(scale, gtid.cpu().numpy(), np.abs(terms))
    err = np.abs(runs[0].double().cpu().numpy() - exact[:num_tiles])
    assert (err <= 1e-5 * scale[:num_tiles]).all(), float(err.max())
    assert want.shape == runs[0].shape
    ints = torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32)
                            ).to(card)
    _same_bits(TK.segment_sum_fixup(ints, starts, num_tiles),
               TK.segment_sum_fixup_ref(ints.cpu(), starts.cpu(),
                                        num_tiles).to(card), name)


def test_fixup_partials_sums_through_the_fixup_kernel(card):
    """A float sum of fixup_partials on the card is one fixup launch and
    no sorted sum (so no sort); float64 and bfloat16 partials too; min
    stays on scatter_reduce_."""
    starts, local_tiles, num_tiles = _fixup_layout("chunked_lpt", card)
    spec = _spec(SIZES["powerlaw"], card)
    part = T.schedules.finalize_partition(
        T.make_partition(spec, "chunked", 64))
    rng = np.random.default_rng(21)
    partials = torch.from_numpy(rng.standard_normal(
        (part.num_blocks, local_tiles, 4))).to(card)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        before = dict(TK.LAUNCHES)
        got = T.execute.fixup_partials(spec, part, partials.to(dtype),
                                       local_tiles)
        assert got.dtype == dtype and got.shape == (num_tiles, 4)
        assert TK.LAUNCHES["segment_sum_fixup"] == (
            before["segment_sum_fixup"] + 1)
        assert TK.LAUNCHES["segment_sum_sorted"] == (
            before["segment_sum_sorted"])
    before = dict(TK.LAUNCHES)
    T.execute.fixup_partials(spec, part, partials.float(), local_tiles,
                             "min")
    assert TK.LAUNCHES == before


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


# ---------------------------------------------------------------------------
# K1: the merge-path SpMV straight from the CSR.
# ---------------------------------------------------------------------------

#: Row sizes and column counts of the merge-path hazards: no rows, rows but
#: no non-zeros, only the last row non-empty, V + nnz not a multiple of 128,
#: long empty runs between hubs, one-non-zero rows across many tiles.
MERGE_CSRS = {
    "no_rows": ([], 7),
    "no_nonzeros": ([0] * 5000, 7),
    "last_row_only": ([0] * 4000 + [300], 50),
    "odd_total": ([5, 0, 3] * 401 + [1], 40),
    "empty_runs": (([0] * 3000 + [7000]) * 3 + [2], 900),
    "singletons": ([1] * 20_000, 300),
}


def _merge_csr(sizes, num_cols, card, *, integer=True, seed=0):
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    nnz = int(offsets[-1])
    cols = rng.integers(0, num_cols, nnz).astype(np.int32)
    if integer:
        vals, x = rng.integers(-4, 5, nnz), rng.integers(-3, 4, num_cols)
    else:
        vals, x = rng.standard_normal(nnz), rng.standard_normal(num_cols)
    as_card = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    return (as_card(offsets), as_card(cols), as_card(vals.astype(np.float32)),
            as_card(x.astype(np.float32)))


def _check_merge_path(operands, num_rows, num_cols, integer, tag):
    kw = dict(num_rows=num_rows, num_cols=num_cols)
    before = TK.LAUNCHES["spmv_merge_stream"]
    got = TK.spmv_merge_csr(*operands, **kw)
    launched = num_rows + int(operands[2].shape[0]) > 0   # else nothing to do
    assert TK.LAUNCHES["spmv_merge_stream"] == before + launched
    want = TK.spmv_merge_csr_ref(*operands, num_rows=num_rows)
    torch.cuda.synchronize()
    if integer:
        assert_bitwise(got, want, tag)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=tag)
    return got


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("name", sorted(MERGE_CSRS))
def test_merge_path_matches_plain(card, name, integer):
    sizes, num_cols = MERGE_CSRS[name]
    ops = _merge_csr(sizes, num_cols, card, integer=integer)
    _check_merge_path(ops, len(sizes), num_cols, integer, name)


@pytest.mark.parametrize("integer", [True, False])
def test_merge_path_power_law(card, integer):
    A = random_csr(3000, 3000, 60_000, skew=1.3, empty_frac=0.3, seed=4,
                   device=card)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(3000).astype(np.float32)
                         ).to(card)
    values = A.values
    if integer:
        values, x = values.sign(), x.sign()
    _check_merge_path((A.row_offsets, A.col_indices, values, x), 3000, 3000,
                      integer, "power_law")


@pytest.mark.parametrize("spans", [(65,), (600,), (300, 260)], ids=str)
def test_merge_path_hub_row_over_64_tiles(card, spans):
    """Rows longer than 64 tiles; past 256 tiles a row's carries cross the
    carry kernel's CTAs.  Integer-valued: bitwise.  Real-valued rows of
    ~10**6 terms cancel to ~10**-3 of their absolute sum, and the plain
    version adds in another order, so there the kernel is held to the exact
    (float64) sum, within 1e-5 of each row's absolute sum."""
    tile = TK.merge_path_tile()
    sizes = [3] * 10
    for span in spans:
        sizes += [span * tile + 17] + [0] * 5 + [2] * 10
    ops = _merge_csr(sizes, 5000, card, integer=True, seed=1)
    _check_merge_path(ops, len(sizes), 5000, True, "hub")
    ops = _merge_csr(sizes, 5000, card, integer=False, seed=1)
    got = TK.spmv_merge_csr(*ops, num_rows=len(sizes), num_cols=5000)
    offsets, cols, vals, x = (t.cpu().numpy() for t in ops)
    terms = vals.astype(np.float64) * x[cols].astype(np.float64)
    rows = np.repeat(np.arange(len(sizes)), np.diff(offsets))
    exact, scale = np.zeros(len(sizes)), np.zeros(len(sizes))
    np.add.at(exact, rows, terms)
    np.add.at(scale, rows, np.abs(terms))
    err = np.abs(got.cpu().numpy() - exact)
    assert (err <= 1e-5 * scale).all(), float((err / scale).max())


def test_merge_path_negative_zero_products_give_positive_zero(card):
    offsets, cols, _, _ = _merge_csr([2, 0, 1] * 700 + [5000], 30, card)
    vals = torch.full(cols.shape, -1.0, device=card)
    x = torch.zeros(30, device=card)
    got = _check_merge_path((offsets, cols, vals, x), 2101, 30, True, "-0")
    assert (got.view(torch.int32) == 0).all()


def test_merge_path_is_deterministic(card):
    ops = _merge_csr([3] * 10 + [50_000] + [1] * 5000, 4000, card,
                     integer=False, seed=2)
    runs = [TK.spmv_merge_csr(*ops, num_rows=5011, num_cols=4000)
            for _ in range(3)]
    for r in runs[1:]:
        assert_bitwise(r, runs[0])


# ---------------------------------------------------------------------------
# K4: the compacted gather.
# ---------------------------------------------------------------------------

#: (name, chunk lengths, window, queue lengths): the window not a multiple
#: of 4, a window under one 4,096-slot slice, several slices, capacity under
#: the chunk count (empty chunks), chunk starts off multiples of 4, queues
#: of unequal length.
COMPACT_CASES = [
    ("aligned_slices", [9000] * 6 + [8000], 9000, [3, 1, 0, 3]),
    ("window_mod4", [1003] * 9 + [500], 1003, [4, 4, 2]),
    ("under_one_slice", [100] * 50, 100, [13, 13, 12, 12]),
    ("capacity_under_chunks", [1] * 5 + [0] * 7, 1, [5, 0, 7]),
    ("unaligned_starts", [5, 4097, 3, 0, 4100, 1, 4101, 7], 4101, [1, 2, 5]),
]


@pytest.mark.parametrize("combiner", ["sum", "min", "max"])
@pytest.mark.parametrize("case", COMPACT_CASES, ids=lambda c: c[0])
def test_chunk_walk_compact_matches_plain(card, case, combiner):
    _, lengths, window, queue_lengths = case
    rng = np.random.default_rng(len(lengths))
    num_chunks = len(lengths)
    assert sum(queue_lengths) == num_chunks
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    capacity, n = int(starts[-1]), 50_000
    vals = rng.standard_normal(n + window).astype(np.float32)
    vals[n:] = T.COMBINER_IDENTITY[combiner]
    idx = rng.integers(0, n + 1, capacity + window).astype(np.int32)
    order = rng.permutation(num_chunks)
    max_chunks = max(queue_lengths)
    queues = np.zeros((len(queue_lengths), max_chunks), np.int32)
    at = 0
    for p, m in enumerate(queue_lengths):
        queues[p, :m] = order[at:at + m]
        at += m
    as_card = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    args = (as_card(vals), None, as_card(starts),
            as_card(np.zeros_like(starts)), as_card(queues.reshape(-1)),
            as_card(np.asarray(queue_lengths, np.int32)), None, as_card(idx))
    kw = dict(window=window, local_tiles=1, max_chunks=max_chunks,
              combiner=combiner, emit="compact")
    before = TK.LAUNCHES["chunk_walk_compact"]
    got = TK.chunk_walk_reduce(*args, **kw)
    assert TK.LAUNCHES["chunk_walk_compact"] == before + 1
    torch.cuda.synchronize()
    assert_bitwise(got, TK.chunk_walk_reduce_ref(*args, **kw))


#: K3 windows: a multiple of 4, not one, and one under a thread's 4 slots.
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("window_pad", [0, 1, 2, 3])
@pytest.mark.parametrize("sizes", [[3, 5, 2, 7, 1] * 900, [4097, 1, 6],
                                   [1, 2]], ids=["short", "wide", "tiny"])
def test_chunk_walk_atoms_matches_plain(card, sizes, window_pad, masked):
    """K3 with chunk bases off a multiple of 4 and windows that are not
    multiples of 4 (scalar stores), bitwise: a copy."""
    spec = _spec(sizes, card)
    part = T.make_partition(spec, "chunked", 13)
    rng = np.random.default_rng(len(sizes) + window_pad)
    vals = torch.from_numpy(rng.standard_normal(spec.num_atoms)
                            .astype(np.float32)).to(card)
    mask = (torch.from_numpy(rng.random(spec.num_atoms) < 0.5).to(card)
            if masked else None)
    args, kw = T.execute.chunk_walk_operands(spec, part, vals,
                                             combiner="min", emit="atoms",
                                             atom_mask=mask)
    kw["window"] += window_pad
    args = (T.execute._padded(vals, kw["window"], float("inf")),) + args[1:]
    if mask is not None:
        args = args[:6] + (T.execute._padded(mask.to(torch.int32),
                                             kw["window"], 0),) + args[7:]
    before = TK.LAUNCHES["chunk_walk_atoms"]
    got = TK.chunk_walk_reduce(*args, **kw)
    assert TK.LAUNCHES["chunk_walk_atoms"] == before + 1
    torch.cuda.synchronize()
    assert_bitwise(got, TK.chunk_walk_reduce_ref(*args, **kw))


def test_spmm_runs_the_tiles_kernel(card):
    make = lambda device: random_csr(2000, 1500, 30_000, skew=1.3,
                                     empty_frac=0.3, seed=6, device=device)
    B = torch.from_numpy(np.random.default_rng(7).standard_normal((1500, 3))
                         .astype(np.float32))
    want = spmm(make("cpu"), B)
    before = TK.LAUNCHES["chunk_walk_tiles"]
    got = spmm(make(card), B.to(card))
    assert TK.LAUNCHES["chunk_walk_tiles"] == before + 1
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


def test_pagerank_and_chunked_spmv_are_deterministic(card):
    """Real-valued sums with many addends per output: bitwise across
    runs (the hub rows span many chunks)."""
    A = random_csr(20_000, 20_000, 400_000, skew=1.3, empty_frac=0.3,
                   seed=7, device=card)
    g = Graph(A)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(20_000)
                         .astype(np.float32)).to(card)
    for schedule in ("chunked_lpt", "merge_path"):
        kw = dict(schedule=schedule, path="native", num_blocks=264)
        before = TK.LAUNCHES["segment_sum_fixup"]
        runs = [pagerank(g, **kw) for _ in range(2)]
        assert TK.LAUNCHES["segment_sum_fixup"] > before
        assert_bitwise(runs[1], runs[0], f"pagerank {schedule}")
    ys = [TO.spmv_merge_path(A, x, schedule="chunked_lpt", num_blocks=264)
          for _ in range(2)]
    assert_bitwise(ys[1], ys[0], "spmv_merge_path chunked_lpt")
    torch.testing.assert_close(ys[0], spmv_reference(A, x), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# Graph serving and bfs_multi through K2's column batch; measured timing.
# ---------------------------------------------------------------------------

def _serving_graph(card, V=3000):
    A = random_csr(V, V, 10 * V, skew=1.3, empty_frac=0.3, seed=11,
                   device=card)
    return Graph(CSR(A.row_offsets, A.col_indices, A.values.abs() + 0.05,
                     A.shape, A.nnz))


def test_graph_server_matches_drivers_two_launches_a_step(card):
    from repro_torch.serve.graph import GraphServer
    g = _serving_graph(card)
    srv = GraphServer(g, lanes=4, schedule="chunked_lpt", path="native",
                      num_blocks=264)
    rng = np.random.default_rng(12)
    queries = [(("bfs", "sssp", "pagerank")[i % 3],
                int(rng.integers(g.num_vertices))) for i in range(10)]
    for q in queries:
        srv.submit(*q)
    results, per_step = {}, []
    while srv.queued or srv.in_flight:
        before = TK.LAUNCHES["chunk_walk_tiles"]
        for r in srv.tick():
            results[r.qid] = r
        per_step.append(TK.LAUNCHES["chunk_walk_tiles"] - before)
    assert max(per_step) == 2, per_step
    assert srv.step_traces == 1 and srv.admit_traces == 1
    for qid, (kind, source) in enumerate(queries):
        if kind == "bfs":
            want = bfs(g, source, plan=srv.plan, direction="pull")
        elif kind == "sssp":
            want = sssp(g, source, plan=srv.plan, direction="pull")
        else:
            want = pagerank(g, plan=srv.plan)
        got = torch.from_numpy(results[qid].value)
        assert got.dtype == want.dtype
        assert_bitwise(got.float(), want.cpu().float(), f"{kind} {source}")


def test_bfs_multi_one_launch_a_level(card):
    g = _serving_graph(card)
    plan = build_advance(g, schedule="chunked_lpt", path="native",
                         num_blocks=264)
    deg = g.out_degrees().cpu().numpy()
    sources = [int(v) for v in np.nonzero(deg)[0][:: 97][:8]]
    before = TK.LAUNCHES["chunk_walk_tiles"]
    depth = bfs_multi(g, sources, plan=plan)
    assert TK.LAUNCHES["chunk_walk_tiles"] - before == int(depth.max()) + 1
    for s, source in enumerate(sources):
        assert torch.equal(depth[s],
                           bfs(g, source, plan=plan, direction="pull"))


def test_sharded_sssp_one_shard_on_the_card(card):
    """The sharded drivers at S = 1 on the card: the plan on the card,
    SSSP in every direction and compacted delta-stepping bitwise equal to
    the unsharded drivers, through K2, K3 and K4."""
    g = _serving_graph(card)
    kw = dict(schedule="chunked_lpt", path="native", num_blocks=264)
    splan = build_sharded_advance(g, 1, delta="auto", compact=True, **kw)
    assert splan.mesh.device.type == "cuda" and splan.plan.src.is_cuda
    source = int(np.nonzero(g.out_degrees().cpu().numpy())[0][3])
    before = dict(TK.LAUNCHES)
    for direction in ("auto", "push", "pull"):
        assert_bitwise(sharded_sssp(splan, source, direction=direction),
                       sssp(g, source, direction=direction, **kw), direction)
    assert_bitwise(sharded_delta_stepping(splan, source),
                   delta_stepping(g, source, **kw), "delta_stepping")
    for name in ("chunk_walk_tiles", "chunk_walk_atoms",
                 "chunk_walk_compact"):
        assert TK.LAUNCHES[name] > before[name], name


@pytest.mark.parametrize("schedule", ["chunked_lpt", "merge_path"])
def test_lane_tile_reduce_keeps_each_lanes_bits(card, schedule):
    """Real-valued sums: lane j of one end-to-end launch has the bits of
    the one-column call (hub rows span many chunks and CTA teams; the atom
    count is not a multiple of 4)."""
    A = random_csr(20_000, 20_000, 400_001, skew=1.3, empty_frac=0.3,
                   seed=9, device=card)
    g = Graph(A)
    plan = build_advance(g, schedule=schedule, path="native",
                         num_blocks=264)
    gen = torch.Generator(device=card).manual_seed(10)
    layout = T.execute.LaneLayout(plan.spec, plan.part, 8, path="native")
    for lanes in (1, 2, 5, 8):
        vals = torch.randn(lanes, plan.spec.num_atoms, generator=gen,
                           device=card)
        before = TK.LAUNCHES["chunk_walk_tiles"]
        got = layout.reduce(lanes, lambda out: out.copy_(vals))
        assert TK.LAUNCHES["chunk_walk_tiles"] == before + 1
        for j in range(lanes):
            want = T.execute_tile_reduce(plan.spec, plan.part,
                                         lambda e: vals[j][e],
                                         path="native")
            assert_bitwise(got[:, j], want, f"{schedule} lane {j}/{lanes}")


def test_time_fn_synchronizes_on_card_results(card, monkeypatch):
    calls = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(1) or sync(*a))
    x = torch.ones(1 << 20, device=card)
    before = T.measurement_count()
    assert T.time_fn(lambda v: v * 2, x, warmup=1, iters=4) > 0
    assert len(calls) == 8 and T.measurement_count() == before + 1


# ---------------------------------------------------------------------------
# K5/K6: the segmented matmul.
# ---------------------------------------------------------------------------

#: (T, K, N, E, bm): MoE-like blocks, the level GEMM's bm = 8, ragged N and
#: K tails, one expert, many experts.
SEGMM_SHAPES = [(1000, 256, 384, 8, 128), (700, 128, 128, 2, 8),
                (300, 72, 100, 5, 32), (512, 64, 48, 1, 128),
                (150, 40, 24, 16, 16), (260, 136, 130, 3, 256)]
POLICY_PATHS = [(s, p) for s in SO.SCHEDULE_POLICIES
                for p in ("pure", "native")]


def _segmm_data(T, K, N, E, integer, card, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    if integer:
        draw = lambda *shape: torch.randint(-3, 4, shape, generator=gen
                                            ).float()
    else:
        draw = lambda *shape: torch.randn(*shape, generator=gen)
    tokens = draw(T, K).to(dtype).to(card)
    eot = torch.randint(0, E, (T,), generator=gen, dtype=torch.int32
                        ).to(card)
    return tokens, eot, draw(E, K, N).to(dtype).to(card)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("shape", SEGMM_SHAPES, ids=str)
def test_segmm_kernels_match_plain(card, shape, integer):
    T, K, N, E, bm = shape
    tokens, eot, rhs = _segmm_data(T, K, N, E, integer, card)
    outs = []
    for schedule, path in POLICY_PATHS:
        ops = SO.segmm_operands(tokens, eot, num_experts=E, bm=bm,
                                schedule=schedule, path=path)
        name = ("segmented_matmul_chunked" if ops.queue is not None
                else "segmented_matmul")
        before = dict(SK.LAUNCHES)
        got = SO.run_segmm(ops, rhs, bn=N, bk=K)
        assert SK.LAUNCHES[name] == before[name] + 1
        assert sum(SK.LAUNCHES.values()) == sum(before.values()) + 1
        if ops.queue is None:
            plain = SK.segmented_matmul_plain(ops.lhs, rhs, ops.block_expert,
                                              bm=bm, bn=N, bk=K)
        else:
            plain = SK.segmented_matmul_chunked_plain(
                ops.lhs, rhs, ops.block_expert, *ops.queue[:2], bm=bm, bn=N,
                bk=K, max_chunks=ops.queue[2])
        torch.cuda.synchronize()
        tag = f"{schedule}/{path}"
        if integer:
            assert_bitwise(got, plain, tag)
        else:
            torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4,
                                       msg=tag)
        outs.append(got[ops.rows])
    for (schedule, path), out in zip(POLICY_PATHS, outs):
        assert_bitwise(out, outs[0], f"{schedule}/{path} vs group_mapped")


@pytest.mark.parametrize("bm", [8, 128])
def test_segmm_chunked_equals_blocks_on_real_data(card, bm):
    tokens, eot, rhs = _segmm_data(2000, 256, 256, 6, False, card, seed=1)
    ops = SO.segmm_operands(tokens, eot, num_experts=6, bm=bm,
                            schedule="group_mapped", path="pure")
    blocks = ops.num_blocks
    for queues in (1, 8, blocks):
        cmax = -(-blocks // queues)
        order = torch.randperm(blocks, generator=torch.Generator()
                               .manual_seed(queues)).to(card)
        chunks = torch.zeros(queues * cmax, dtype=torch.int32, device=card)
        chunks[:blocks] = order.to(torch.int32)
        counts = torch.full((queues,), cmax, dtype=torch.int32, device=card)
        counts[-1] = blocks - cmax * (queues - 1)
        # queue q pops slots [q * cmax, q * cmax + counts[q])
        got = SK.segmented_matmul_chunked(ops.lhs, rhs, ops.block_expert,
                                          chunks, counts, bm=bm,
                                          max_chunks=cmax)
        want = SK.segmented_matmul(ops.lhs, rhs, ops.block_expert, bm=bm,
                                   bn=64, bk=32)
        assert_bitwise(got, want, f"{queues} queues")


def test_segmm_bf16(card):
    for lhs_dtype, rhs_dtype in ((torch.bfloat16, torch.bfloat16),
                                 (torch.bfloat16, torch.float32),
                                 (torch.float32, torch.bfloat16)):
        tokens, eot, rhs = _segmm_data(400, 96, 160, 4, False, card, seed=2)
        tokens, rhs = tokens.to(lhs_dtype), rhs.to(rhs_dtype)
        want = SO.grouped_matmul(tokens.cpu(), eot.cpu(), rhs.cpu(),
                                 num_experts=4, bm=32, bn=160)
        for schedule, path in POLICY_PATHS:
            got = SO.grouped_matmul(tokens, eot, rhs, num_experts=4, bm=32,
                                    bn=160, schedule=schedule,
                                    execution_path=path)
            assert got.dtype == torch.float32
            torch.testing.assert_close(got.cpu(), want, rtol=5e-2, atol=5e-2)


@pytest.fixture
def nan_empty(monkeypatch):
    """``torch.empty`` that fills floating-point tensors with NaN while the
    test runs, so that an output row no kernel writes shows as NaN (the
    wrappers allocate their outputs with ``torch.empty``)."""
    real = torch.empty

    def empty(*args, **kwargs):
        t = real(*args, **kwargs)
        if t.is_floating_point():
            t.fill_(float("nan"))
        return t
    monkeypatch.setattr(torch, "empty", empty)


def test_segmm_zero_rows_for_bad_experts_and_unpopped_blocks(card,
                                                             nan_empty):
    lhs = torch.ones((4 * 8, 8), device=card)
    rhs = torch.ones((2, 8, 8), device=card)
    be = torch.tensor([0, 1, 5, -1], dtype=torch.int32, device=card)
    out = SK.segmented_matmul(lhs, rhs, be, bm=8)
    assert_bitwise(out, SK.segmented_matmul_plain(lhs, rhs, be, bm=8))
    chunked = SK.segmented_matmul_chunked(
        lhs, rhs, be, torch.tensor([1, 0], dtype=torch.int32, device=card),
        torch.tensor([1], dtype=torch.int32, device=card), bm=8,
        max_chunks=2)
    assert (chunked[8:16] == 8).all() and (chunked[:8] == 0).all()
    assert (chunked[16:] == 0).all()


# K6's team geometry and K5's tile edges: K6 is held bitwise to K5 on the
# popped M-blocks, and both to their plain versions (bitwise on
# integer-valued operands, whose every sum is exact in float32).

def _draw(shape, integer, gen, card, dtype=torch.float32, misaligned=False):
    vals = (torch.randint(-3, 4, shape, generator=gen).float() if integer
            else torch.randn(*shape, generator=gen)).to(dtype)
    if not misaligned:
        return vals.to(card)
    flat = torch.empty(vals.numel() + 1, dtype=dtype, device=card)[1:]
    flat.copy_(vals.reshape(-1))
    return flat.view(shape)


def _sum_order_bound(lhs, rhs, be, **kw):
    """``2 K 2**-24 sum_k |a_k b_k|`` for every output element: how far two
    float32 sums of the same exact products, added in different orders,
    can lie apart (each within ``K u sum|a b|`` of the exact sum)."""
    return (2 * lhs.shape[1] * 2.0 ** -24) * SK.segmented_matmul_plain(
        lhs.abs(), rhs.abs(), be, **kw)


def _check_k5_k6(lhs, rhs, be, chunks, counts, cmax, bm, integer, tag):
    """K5 and K6 against their plain versions and each other; a launch
    counted on its tensor-core route (``segmm_wgmma`` or ``segmm_mma``, as
    ``kernel_for`` names it) and on no other, a CUDA-core one on neither;
    two K5 runs bitwise equal."""
    k_dim, n_dim = lhs.shape[1], rhs.shape[2]
    kw = dict(bm=bm, bn=n_dim, bk=k_dim)
    route = SK.kernel_for(lhs.dtype, rhs.dtype, bm, k_dim, n_dim)
    mma = route != "segmm_fma"
    routes = ("segmm_wgmma", "segmm_mma")
    before = {r: SK.LAUNCHES[r] for r in routes}

    def launched(times):
        return {r: SK.LAUNCHES[r] - before[r] for r in routes} == {
            r: times if r == route else 0 for r in routes}
    k5 = SK.segmented_matmul(lhs, rhs, be, **kw)
    assert launched(1), f"{tag}: K5 route"
    plain = SK.segmented_matmul_plain(lhs, rhs, be, **kw)
    k6 = SK.segmented_matmul_chunked(lhs, rhs, be, chunks, counts,
                                     max_chunks=cmax, **kw)
    assert launched(2), f"{tag}: K6 route"
    plain6 = SK.segmented_matmul_chunked_plain(lhs, rhs, be, chunks, counts,
                                               max_chunks=cmax, **kw)
    again = SK.segmented_matmul(lhs, rhs, be, **kw)
    torch.cuda.synchronize()
    assert_bitwise(again, k5, f"{tag}: K5 run twice")
    if integer:
        assert_bitwise(k5, plain, f"{tag}: K5 vs plain")
        assert_bitwise(k6, plain6, f"{tag}: K6 vs plain")
    else:
        torch.testing.assert_close(k5, plain, rtol=1e-4, atol=1e-4,
                                   msg=f"{tag}: K5 vs plain")
        if mma:
            over = (k5 - plain).abs() > _sum_order_bound(lhs, rhs, be, **kw)
            assert not bool(over.any()), (
                f"{tag}: {int(over.sum())} entries beyond the float32 "
                f"sum-order bound")
    popped = SK._popped_blocks(chunks, counts, cmax, be.shape[0])
    rows = (popped[:, None] * bm
            + torch.arange(bm, device=popped.device)).reshape(-1)
    assert_bitwise(k6[rows], k5[rows], f"{tag}: K6 vs K5")
    unpopped = torch.ones(k6.shape[0], dtype=torch.bool, device=k6.device)
    unpopped[rows] = False
    assert bool((k6[unpopped] == 0).all()), f"{tag}: unpopped rows"


def _queues(lengths, cmax, nblk, gen, card):
    """Queue layout with the given lengths: distinct M-blocks in the popped
    slots, junk (ids out of range and real ids) past each queue's end."""
    order = torch.randperm(nblk, generator=gen)
    chunks = torch.randint(-2, nblk + 2, (len(lengths), cmax), generator=gen)
    start = 0
    for q, n in enumerate(lengths):
        chunks[q, :n] = order[start:start + n]
        start += n
    assert start <= nblk
    return (chunks.reshape(-1).to(torch.int32).to(card),
            torch.tensor(lengths, dtype=torch.int32, device=card))


#: (name, bm, K, N, E, queue lengths, max_chunks, unpopped M-blocks).
QUEUE_CASES = [
    ("lengths_0_and_1", 128, 64, 256, 3, [0, 1, 0, 1, 1, 0, 0, 1], 1, 2),
    ("shorter_than_team", 128, 72, 1024, 4,
     [1, 3, 40, 40, 0, 2, 39, 40], 40, 5),
    ("team_of_one", 8, 136, 128, 2, [1] * 300, 1, 0),
    ("counts_at_max", 32, 72, 100, 5, [9, 9, 9], 9, 3),
    ("bm8_long_queues", 8, 128, 130, 2, [700, 699, 700, 698], 700, 10),
    ("no_queues", 8, 64, 128, 2, [], 1, 4),
]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", QUEUE_CASES, ids=lambda c: c[0])
def test_k6_team_geometry(card, case, integer):
    name, bm, k_dim, n_dim, e_dim, lengths, cmax, spare = case
    gen = torch.Generator().manual_seed(len(lengths) + bm)
    nblk = sum(lengths) + spare
    lhs = _draw((nblk * bm, k_dim), integer, gen, card)
    rhs = _draw((e_dim, k_dim, n_dim), integer, gen, card)
    be = torch.randint(0, e_dim, (nblk,), generator=gen,
                       dtype=torch.int32).sort().values.to(card)
    chunks, counts = _queues(lengths, cmax, nblk, gen, card)
    team, ctas = SK.queues_grid(len(lengths), cmax, bm, n_dim)
    assert ctas == len(lengths) * team * SK.column_tiles(n_dim)
    if name == "shorter_than_team":
        assert 0 < 1 < team, team
    if name == "team_of_one":
        assert team == 1
    _check_k5_k6(lhs, rhs, be, chunks, counts, cmax, bm, integer, name)


@pytest.mark.parametrize("bm", [8, 128])
@pytest.mark.parametrize("k_dim,n_dim", [(72, 24), (136, 100), (72, 130),
                                         (136, 128), (16, 4), (3, 7)])
def test_segmm_k_and_n_tails(card, k_dim, n_dim, bm):
    gen = torch.Generator().manual_seed(k_dim * n_dim + bm)
    nblk, e_dim = 37, 3
    lhs = _draw((nblk * bm, k_dim), True, gen, card)
    rhs = _draw((e_dim, k_dim, n_dim), True, gen, card)
    be = torch.randint(-1, e_dim + 1, (nblk,), generator=gen,
                       dtype=torch.int32).to(card)
    chunks, counts = _queues([10, 10, 9, 8], 10, nblk, gen, card)
    _check_k5_k6(lhs, rhs, be, chunks, counts, 10, bm, True,
                 f"K={k_dim} N={n_dim} bm={bm}")


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("lhs_dtype,rhs_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_segmm_operand_types_and_alignment(card, lhs_dtype, rhs_dtype,
                                           misaligned):
    gen = torch.Generator().manual_seed(7)
    for integer in (True, False):
        for bm, k_dim, n_dim in ((128, 136, 256), (8, 128, 128)):
            nblk = 24
            lhs = _draw((nblk * bm, k_dim), integer, gen, card, lhs_dtype,
                        misaligned)
            rhs = _draw((3, k_dim, n_dim), integer, gen, card, rhs_dtype,
                        misaligned)
            if misaligned:
                assert lhs.data_ptr() % 16 and rhs.data_ptr() % 16
            be = torch.randint(0, 3, (nblk,), generator=gen,
                               dtype=torch.int32).to(card)
            chunks, counts = _queues([8, 8, 8], 8, nblk, gen, card)
            _check_k5_k6(lhs, rhs, be, chunks, counts, 8, bm, integer,
                         f"{lhs_dtype}/{rhs_dtype} bm={bm} "
                         f"misaligned={misaligned} integer={integer}")


def test_segmm_more_than_65535_m_blocks(card):
    gen = torch.Generator().manual_seed(3)
    bm, nblk, k_dim, n_dim = 8, 70_001, 32, 48
    lhs = _draw((nblk * bm, k_dim), True, gen, card)
    rhs = _draw((2, k_dim, n_dim), True, gen, card)
    be = (torch.arange(nblk, device=card) * 2 // nblk).to(torch.int32)
    queues = 8
    cmax = -(-nblk // queues)
    slot = (torch.arange(queues)[:, None]
            + torch.arange(cmax)[None, :] * queues)
    counts = (slot < nblk).sum(1).to(torch.int32).to(card)
    chunks = slot.clamp(max=nblk - 1).reshape(-1).to(torch.int32).to(card)
    _check_k5_k6(lhs, rhs, be, chunks, counts, cmax, bm, True,
                 "70,001 M-blocks")


# The tensor-core instance (bf16 x bf16) through the same edges: K6's team
# geometry, K and N tails (8-element copies where K % 8 == N % 8 == 0,
# element loads elsewhere), more than 65,535 M-blocks, zero rows.

BF16 = dict(dtype=torch.bfloat16)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", QUEUE_CASES, ids=lambda c: c[0])
def test_k6_team_geometry_bf16(card, case, integer):
    name, bm, k_dim, n_dim, e_dim, lengths, cmax, spare = case
    gen = torch.Generator().manual_seed(len(lengths) + bm + 1)
    nblk = sum(lengths) + spare
    lhs = _draw((nblk * bm, k_dim), integer, gen, card, **BF16)
    rhs = _draw((e_dim, k_dim, n_dim), integer, gen, card, **BF16)
    be = torch.randint(0, e_dim, (nblk,), generator=gen,
                       dtype=torch.int32).sort().values.to(card)
    chunks, counts = _queues(lengths, cmax, nblk, gen, card)
    _check_k5_k6(lhs, rhs, be, chunks, counts, cmax, bm, integer,
                 f"bf16 {name}")


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("bm", [8, 128])
@pytest.mark.parametrize("k_dim", [3, 16, 72, 136])
@pytest.mark.parametrize("n_dim", [4, 7, 24, 100, 130])
def test_segmm_bf16_k_and_n_tails(card, n_dim, k_dim, bm, integer):
    gen = torch.Generator().manual_seed(k_dim * n_dim + bm + integer)
    nblk, e_dim = 37, 3
    lhs = _draw((nblk * bm, k_dim), integer, gen, card, **BF16)
    rhs = _draw((e_dim, k_dim, n_dim), integer, gen, card, **BF16)
    be = torch.randint(-1, e_dim + 1, (nblk,), generator=gen,
                       dtype=torch.int32).to(card)
    chunks, counts = _queues([10, 10, 9, 8], 10, nblk, gen, card)
    _check_k5_k6(lhs, rhs, be, chunks, counts, 10, bm, integer,
                 f"bf16 K={k_dim} N={n_dim} bm={bm}")


def test_segmm_bf16_more_than_65535_m_blocks(card):
    gen = torch.Generator().manual_seed(4)
    bm, nblk, k_dim, n_dim = 8, 70_001, 32, 48
    lhs = _draw((nblk * bm, k_dim), True, gen, card, **BF16)
    rhs = _draw((2, k_dim, n_dim), True, gen, card, **BF16)
    be = (torch.arange(nblk, device=card) * 2 // nblk).to(torch.int32)
    queues = 8
    cmax = -(-nblk // queues)
    slot = (torch.arange(queues)[:, None]
            + torch.arange(cmax)[None, :] * queues)
    counts = (slot < nblk).sum(1).to(torch.int32).to(card)
    chunks = slot.clamp(max=nblk - 1).reshape(-1).to(torch.int32).to(card)
    _check_k5_k6(lhs, rhs, be, chunks, counts, cmax, bm, True,
                 "bf16 70,001 M-blocks")


def test_segmm_bf16_zero_rows_for_bad_experts_and_unpopped_blocks(
        card, nan_empty):
    lhs = torch.ones((4 * 8, 8), device=card, dtype=torch.bfloat16)
    rhs = torch.ones((2, 8, 8), device=card, dtype=torch.bfloat16)
    be = torch.tensor([0, 1, 5, -1], dtype=torch.int32, device=card)
    before = SK.LAUNCHES["segmm_mma"]
    out = SK.segmented_matmul(lhs, rhs, be, bm=8)
    assert_bitwise(out, SK.segmented_matmul_plain(lhs, rhs, be, bm=8))
    assert (out[16:] == 0).all() and (out[:16] == 8).all()
    chunked = SK.segmented_matmul_chunked(
        lhs, rhs, be, torch.tensor([1, 0], dtype=torch.int32, device=card),
        torch.tensor([1], dtype=torch.int32, device=card), bm=8,
        max_chunks=2)
    assert (chunked[8:16] == 8).all() and (chunked[:8] == 0).all()
    assert (chunked[16:] == 0).all()
    assert SK.LAUNCHES["segmm_mma"] == before + 2


def test_segmm_cuda_core_pairs_never_count_the_tensor_cores(card):
    gen = torch.Generator().manual_seed(9)
    before = SK.LAUNCHES["segmm_mma"]
    before_wgmma = SK.LAUNCHES["segmm_wgmma"]
    for lt, rt in ((torch.float32, torch.float32),
                   (torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.float32)):
        lhs = _draw((4 * 128, 64), False, gen, card, lt)
        rhs = _draw((2, 64, 128), False, gen, card, rt)
        be = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=card)
        SK.segmented_matmul(lhs, rhs, be)
        SK.segmented_matmul_chunked(
            lhs, rhs, be, torch.arange(4, dtype=torch.int32, device=card),
            torch.tensor([4], dtype=torch.int32, device=card), max_chunks=4)
        assert SK.kernel_for(lt, rt, 128, 64, 128) == "segmm_fma"
    torch.cuda.synchronize()
    assert SK.LAUNCHES["segmm_mma"] == before
    assert SK.LAUNCHES["segmm_wgmma"] == before_wgmma


# The wgmma route (bf16 x bf16, bm a multiple of 128, K % 8 == N % 8 ==
# 0): bitwise on integer-valued operands, within the float32 sum-order
# bound on real ones, K6 bitwise equal to K5, through K tails and N tails
# (TMA's zero fill), two 128-row sub-tiles an M-block, bad experts, and K6
# queues with junk past their ends.

#: (bm, K, N, E, queue lengths, max_chunks, unpopped M-blocks)
WGMMA_CASES = [
    (128, 64, 256, 3, [3, 2, 0, 4], 4, 2),       # one N tile, one k slice
    (128, 72, 24, 4, [5, 5, 5], 5, 3),           # K tail of 8; N in one box
    (128, 136, 264, 3, [6, 1, 6, 6], 6, 1),      # N tail of 8 columns
    (256, 200, 520, 5, [4, 4], 4, 2),            # two sub-tiles, 3 N tiles
    (128, 2048, 1024, 8, [10] * 4, 10, 4),       # the MoE's w1 widths
    (128, 1024, 2048, 8, [5] * 8, 6, 3),         # and w2's
]


#: The MoE's widths: integer-valued here (bitwise); real-valued data at K
#: 1,024-2,048 has entries near zero that no two float32 summation orders
#: hold to ``_check_k5_k6``'s elementwise rtol 1e-4, so it is held to the
#: sum-order bound in ``test_segmm_wgmma_real_at_moe_widths``.
WGMMA_ROUTE_CASES = ([(c, i) for c in WGMMA_CASES[:4] for i in (True, False)]
                     + [(c, True) for c in WGMMA_CASES[4:]])


@pytest.mark.parametrize("case,integer", WGMMA_ROUTE_CASES, ids=str)
def test_segmm_wgmma_route(card, case, integer):
    bm, k_dim, n_dim, e_dim, lengths, cmax, spare = case
    assert SK.kernel_for(torch.bfloat16, torch.bfloat16, bm, k_dim,
                         n_dim) == "segmm_wgmma"
    gen = torch.Generator().manual_seed(k_dim + n_dim + integer)
    nblk = sum(lengths) + spare
    lhs = _draw((nblk * bm, k_dim), integer, gen, card, **BF16)
    rhs = _draw((e_dim, k_dim, n_dim), integer, gen, card, **BF16)
    be = torch.randint(-1, e_dim + 1, (nblk,), generator=gen,
                       dtype=torch.int32).to(card)
    chunks, counts = _queues(lengths, cmax, nblk, gen, card)
    _check_k5_k6(lhs, rhs, be, chunks, counts, cmax, bm, integer,
                 f"wgmma {case}")


@pytest.mark.parametrize("case", WGMMA_CASES[4:], ids=str)
def test_segmm_wgmma_real_at_moe_widths(card, case):
    """Real-valued bf16 operands at the MoE's widths: every entry within
    ``2 K 2**-24 sum|ab|`` of the plain version and within 1e-4 of its
    largest entry (``chip_smoke``'s parity gates), K6 bitwise equal to K5
    on the popped M-blocks and zero elsewhere."""
    bm, k_dim, n_dim, e_dim, lengths, cmax, spare = case
    gen = torch.Generator().manual_seed(k_dim + n_dim)
    nblk = sum(lengths) + spare
    lhs = _draw((nblk * bm, k_dim), False, gen, card, **BF16)
    rhs = _draw((e_dim, k_dim, n_dim), False, gen, card, **BF16)
    be = torch.randint(0, e_dim, (nblk,), generator=gen,
                       dtype=torch.int32).to(card)
    chunks, counts = _queues(lengths, cmax, nblk, gen, card)
    kw = dict(bm=bm, bn=n_dim, bk=k_dim)
    before = SK.LAUNCHES["segmm_wgmma"]
    k5 = SK.segmented_matmul(lhs, rhs, be, **kw)
    k6 = SK.segmented_matmul_chunked(lhs, rhs, be, chunks, counts,
                                     max_chunks=cmax, **kw)
    assert SK.LAUNCHES["segmm_wgmma"] == before + 2
    plain = SK.segmented_matmul_plain(lhs, rhs, be, **kw)
    err = (k5 - plain).abs()
    assert not bool((err > _sum_order_bound(lhs, rhs, be, **kw)).any())
    assert float(err.max()) <= 1e-4 * float(plain.abs().max())
    popped = SK.popped_mask(chunks, counts, cmax, nblk).to(card)
    rows = popped.repeat_interleave(bm)
    assert_bitwise(k6[rows], k5[rows], "K6 vs K5")
    assert bool((k6[~rows] == 0).all())


def test_segmm_wgmma_zero_rows_for_bad_experts_and_unpopped_blocks(
        card, nan_empty):
    bm, k_dim, n_dim = 128, 64, 264
    lhs = torch.ones((4 * bm, k_dim), device=card, dtype=torch.bfloat16)
    rhs = torch.ones((2, k_dim, n_dim), device=card, dtype=torch.bfloat16)
    be = torch.tensor([0, 1, 5, -1], dtype=torch.int32, device=card)
    before = SK.LAUNCHES["segmm_wgmma"]
    out = SK.segmented_matmul(lhs, rhs, be, bm=bm, bn=n_dim)
    assert_bitwise(out, SK.segmented_matmul_plain(lhs, rhs, be, bm=bm,
                                                  bn=n_dim))
    assert (out[:2 * bm] == k_dim).all() and (out[2 * bm:] == 0).all()
    chunked = SK.segmented_matmul_chunked(
        lhs, rhs, be, torch.tensor([1, 2, 9, 0], dtype=torch.int32,
                                   device=card),
        torch.tensor([3], dtype=torch.int32, device=card), bm=bm,
        bn=n_dim, max_chunks=4)
    # pops 1 (expert 1), 2 (expert 5: zero rows) and 9 (no M-block)
    assert (chunked[bm:2 * bm] == k_dim).all()
    assert (chunked[:bm] == 0).all() and (chunked[2 * bm:] == 0).all()
    assert SK.LAUNCHES["segmm_wgmma"] == before + 2


def test_segmm_wgmma_copies_unaligned_operands(card):
    gen = torch.Generator().manual_seed(11)
    bm, k_dim, n_dim, nblk = 128, 64, 128, 6
    lhs = _draw((nblk * bm, k_dim), True, gen, card, **BF16)
    rhs = _draw((3, k_dim, n_dim), True, gen, card, **BF16)
    be = torch.tensor([0, 2, 1, 1, 0, 2], dtype=torch.int32, device=card)
    want = SK.segmented_matmul(lhs, rhs, be, bm=bm)
    shifted = [torch.empty(t.numel() + 1, dtype=t.dtype, device=card)[1:]
               for t in (lhs, rhs)]
    for dst, src in zip(shifted, (lhs, rhs)):
        dst.copy_(src.reshape(-1))
    lhs_off, rhs_off = (t.view(src.shape) for t, src in
                        zip(shifted, (lhs, rhs)))
    assert lhs_off.data_ptr() % 16 and rhs_off.data_ptr() % 16
    copies, launches = SK.COPIES["segmm_wgmma"], SK.LAUNCHES["segmm_wgmma"]
    got = SK.segmented_matmul(lhs_off, rhs_off, be, bm=bm)
    assert SK.COPIES["segmm_wgmma"] == copies + 2
    assert SK.LAUNCHES["segmm_wgmma"] == launches + 1
    assert_bitwise(got, want)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("bm", [8, 64])
def test_segmm_mma_route_below_128_rows(card, bm, integer):
    """bf16 x bf16 at a bm that is no multiple of 128 stays on the
    ``mma.sync`` route, whatever K and N."""
    k_dim, n_dim = 64, 256
    assert SK.kernel_for(torch.bfloat16, torch.bfloat16, bm, k_dim,
                         n_dim) == "segmm_mma"
    gen = torch.Generator().manual_seed(bm + integer)
    nblk = 40
    lhs = _draw((nblk * bm, k_dim), integer, gen, card, **BF16)
    rhs = _draw((3, k_dim, n_dim), integer, gen, card, **BF16)
    be = torch.randint(0, 3, (nblk,), generator=gen,
                       dtype=torch.int32).to(card)
    chunks, counts = _queues([10, 10, 10], 12, nblk, gen, card)
    _check_k5_k6(lhs, rhs, be, chunks, counts, 12, bm, integer,
                 f"mma.sync bm={bm}")


#: bf16 MoE layer (sorted) against the capacity dispatch in bf16 with a
#: capacity that drops nothing: the two round to bf16 at different places
#: (capacity rounds h1, h3, their gated product and each weighted atom;
#: sorted keeps h1 and h3 in float32 and rounds h once), each rounding up
#: to 2**-9 relative; held to 3e-2 of each entry plus 3e-2 of the largest
#: (the CPU run at OLMoE-1B-7B width reads up to 1.2e-2 of the largest).
MOE_BF16_TOL = 3e-2


def test_moe_sorted_bf16_on_the_tensor_cores(card):
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = get_config("olmoe_1b_7b").reduced(d_model=128, d_ff=256,
                                            num_experts=16, top_k=4)
    params, _ = M.moe_init(torch.Generator().manual_seed(0), cfg.d_model,
                           cfg.d_ff, cfg.num_experts, 0, cfg.activation,
                           device=card)
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    x = torch.randn(2, 300, cfg.d_model, generator=torch.Generator(
        ).manual_seed(1)).to(card).to(torch.bfloat16)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k)
    base, aux = M.moe_sorted(params, x, **kw)
    assert base.dtype == torch.bfloat16
    for schedule, path in POLICY_PATHS + [("auto", "auto")]:
        before = dict(SK.LAUNCHES)
        out, aux2 = M.moe_sorted(params, x, schedule=schedule,
                                 execution_path=path, **kw)
        # bm 128, K and N multiples of 8: all three on the wgmma route
        assert SK.LAUNCHES["segmm_wgmma"] == before["segmm_wgmma"] + 3
        assert SK.LAUNCHES["segmm_mma"] == before["segmm_mma"]
        assert (SK.LAUNCHES["segmented_matmul"]
                + SK.LAUNCHES["segmented_matmul_chunked"]
                == before["segmented_matmul"]
                + before["segmented_matmul_chunked"] + 3)
        # bf16 -> float32 is exact: equal float32 bits are equal bf16 bits
        assert_bitwise(out.float(), base.float(), f"{schedule}/{path}")
        assert float(aux2) == float(aux)
    cap, _ = M.moe_capacity(params, x, capacity_factor=float(
        cfg.num_experts / cfg.top_k), **kw)
    scale = float(cap.float().abs().max())
    torch.testing.assert_close(base.float(), cap.float(), rtol=MOE_BF16_TOL,
                               atol=MOE_BF16_TOL * scale)


def test_moe_sorted_policies_bitwise_and_counted(card):
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = get_config("olmoe_1b_7b").reduced(d_model=128, d_ff=256,
                                            num_experts=16, top_k=4)
    params, _ = M.moe_init(torch.Generator().manual_seed(0), cfg.d_model,
                           cfg.d_ff, cfg.num_experts, 0, cfg.activation,
                           device=card)
    x = torch.randn(2, 300, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(card)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k)
    base, aux = M.moe_sorted(params, x, **kw)
    for schedule, path in POLICY_PATHS + [("auto", "auto")]:
        before = sum(SK.LAUNCHES.values())
        out, aux2 = M.moe_sorted(params, x, schedule=schedule,
                                 execution_path=path, **kw)
        assert sum(SK.LAUNCHES.values()) == before + 3
        assert_bitwise(out, base, f"{schedule}/{path}")
        assert float(aux2) == float(aux)
    cap, cap_aux = M.moe_capacity(params, x, capacity_factor=float(
        cfg.num_experts / cfg.top_k), **kw)
    torch.testing.assert_close(base, cap, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(aux, cap_aux, rtol=1e-5, atol=0)


def test_wavefront_on_the_card_matches_cpu(card):
    from repro_torch.sparse import wavefront as W
    rng = np.random.default_rng(0)
    trees = []
    for n in rng.integers(1, 12, 40):
        w = np.zeros((2 * n - 1, 2 * n - 1), np.float32)
        for child in range(1, 2 * n - 1):
            w[child, (child - 1) // 2] = 1.0
        trees.append(w)
    V = sum(t.shape[0] for t in trees)
    K = 128
    x = rng.integers(-2, 3, (V, K)).astype(np.float32)
    ws = rng.integers(-1, 2, (2, K, K)).astype(np.float32)
    b = rng.integers(-2, 3, (2, K)).astype(np.float32)
    ops = rng.integers(0, 2, V).astype(np.int32)
    clip = lambda z: torch.clamp(z, -16.0, 16.0)
    outs = {}
    for device in ("cpu", card):
        packed = W.pack_forest([Graph.from_dense(t, device=device)
                                for t in trees])
        for schedule in ("chunked_lpt", "merge_path"):
            for path in ("native", "pure"):
                wp = W.build_wavefront(packed.dag, schedule=schedule,
                                       path=path)
                before = dict(SK.LAUNCHES)
                outs[device, schedule, path] = W.wavefront_eval(
                    wp, x, ops, ws, bias=b, activation=clip).cpu()
                if device != "cpu":
                    assert sum(SK.LAUNCHES.values()) == \
                        sum(before.values()) + wp.num_levels
    first = outs["cpu", "chunked_lpt", "native"]
    for key, out in outs.items():
        assert_bitwise(out, first, str(key))


def test_wavefront_makes_two_tiles_launches_per_level(card):
    """One batched combine and one in-degree update a level."""
    from repro_torch.sparse import wavefront as W
    trees = []
    for n in (3, 9, 17):
        w = np.zeros((2 * n - 1, 2 * n - 1), np.float32)
        for child in range(1, 2 * n - 1):
            w[child, (child - 1) // 2] = 1.0
        trees.append(Graph.from_dense(w, device=card))
    wp = W.build_wavefront(W.pack_forest(trees).dag, schedule="chunked_lpt",
                           path="native")
    rng = np.random.default_rng(1)
    V = wp.num_nodes
    before = TK.LAUNCHES["chunk_walk_tiles"]
    W.wavefront_eval(wp, rng.integers(-2, 3, (V, 128)).astype(np.float32),
                     rng.integers(0, 2, V).astype(np.int32),
                     rng.integers(-1, 2, (2, 128, 128)).astype(np.float32))
    assert TK.LAUNCHES["chunk_walk_tiles"] == before + 2 * wp.num_levels


# ---------------------------------------------------------------------------
# K7: banded sliding-window attention.
# ---------------------------------------------------------------------------

#: (S, H, Hkv, hd, window, qc): Danube's head_dim 120 and GQA 4:1, Hymba's
#: 64 and 5:1, window == qc and window == S, S not a multiple of the
#: kernel's 64-row tile.
SWA_SHAPES = [(1024, 8, 2, 120, 256, 128), (512, 10, 2, 64, 128, 128),
              (512, 4, 1, 120, 64, 64), (384, 5, 1, 64, 384, 128),
              (96, 4, 4, 64, 32, 32), (256, 8, 2, 120, 256, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SWA_SHAPES, ids=str)
def test_flash_swa_matches_plain(card, shape, dtype):
    S, H, Hkv, hd, window, qc = shape
    gen = torch.Generator().manual_seed(S + H + hd)
    q, k, v = (torch.randn(2, S, heads, hd, generator=gen).to(dtype).to(card)
               for heads in (H, Hkv, Hkv))
    before = dict(FK.LAUNCHES)
    got = FK.flash_swa(q, k, v, window=window, qc=qc)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_swa"] == before["flash_swa"] + 1
    # bf16 heads up to 128 wide take a tensor-core kernel (wgmma where hd %
    # 8 == 0), the rest not
    for route in ("flash_swa_wgmma", "flash_swa_mma"):
        assert FK.LAUNCHES[route] == before[route] + (
            route == FK.kernel_for(dtype, hd))
    assert got.dtype == dtype and got.shape == q.shape
    want = FK.flash_swa_plain(q.float(), k.float(), v.float(),
                              window=window, qc=qc)
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, 1e-4)
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


#: The tensor-core kernels' edges (S, H, Hkv, hd, window, qc): heads not
#: a multiple of 8 (the mma.sync kernel's element loads) on a ragged S,
#: each padded width (24 -> 64, 96 -> 128 on the wgmma kernel), window 1,
#: and rows that start off 16 bytes (copied first on the wgmma route).
MMA_SHAPES = [(160, 4, 2, 100, 64, 32), (128, 2, 1, 24, 32, 32),
              (256, 4, 4, 96, 128, 64), (192, 4, 2, 128, 64, 64),
              (128, 2, 1, 64, 1, 1), (96, 2, 1, 20, 32, 32)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", MMA_SHAPES, ids=str)
def test_flash_swa_mma_edges(card, shape, offset):
    S, H, Hkv, hd, window, qc = shape
    gen = torch.Generator().manual_seed(S + hd + offset)

    def draw(heads):
        # offset 1: a contiguous view one element into its storage
        n = 2 * S * heads * hd
        t = torch.randn(n + offset, generator=gen).to(torch.bfloat16)
        return t.to(card)[offset:].view(2, S, heads, hd)

    q, k, v = draw(H), draw(Hkv), draw(Hkv)
    route = FK.kernel_for(torch.bfloat16, hd)
    before = FK.LAUNCHES[route]
    got = FK.flash_swa(q, k, v, window=window, qc=qc)
    torch.cuda.synchronize()
    assert FK.LAUNCHES[route] == before + 1
    want = FK.flash_swa_plain(q.float(), k.float(), v.float(),
                              window=window, qc=qc)
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-4)


def test_banded_attention_launches_k7_once(card):
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(0)
    params, _ = L.attention_init(gen, 256, 8, 2, 120, False, device="cpu")
    x = torch.randn(1, 512, 256, generator=gen)
    pos = torch.arange(512, dtype=torch.int32)[None]
    kw = dict(num_heads=8, num_kv_heads=2, head_dim=120, rope_theta=1e4,
              sliding_window=128, query_chunk=64, swa_banded=True)
    want = L.attention(params, x, pos, **kw)
    before = FK.LAUNCHES["flash_swa"]
    got = L.attention({n: p.to(card) for n, p in params.items()},
                      x.to(card), pos.to(card), **kw)
    assert FK.LAUNCHES["flash_swa"] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# K7's backward (csrc/flash_swa_bwd_mma.cu for bfloat16 heads up to 128,
# csrc/flash_swa_bwd.cu for the rest) and the autograd function.
# ---------------------------------------------------------------------------

#: (S, H, Hkv, hd, window, qc): the forward's shapes, plus the widest f32
#: head (256: 32-row tiles), S = qc + window + qc, and window 1.
SWA_BWD_SHAPES = SWA_SHAPES + [(256, 4, 2, 256, 128, 64),
                               (320, 4, 1, 64, 192, 64),
                               (128, 2, 1, 128, 1, 1)]
#: dq/dk/dv against the plain backward on the same inputs, output and
#: log-sum-exp, per element ``atol * max(1, max|want|) + rtol * |want|``
#: (the inputs are unit normals, so 1 is the size of a term: at window 1
#: dq is 0 up to the cancellation of dP - D): float32 sums in another
#: order (1e-4); bfloat16 adds the rounding of the outputs to bf16 (2^-9
#: relative: rtol 1e-2).
SWA_BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-3)}
#: The autograd function's gradients against autograd through the float32
#: plain forward on the same (bf16-rounded) inputs: for bfloat16 the D pass
#: reads the forward's bf16-rounded output (``tests/
#: test_torch_flash_swa_grad.py`` states the same 1e-2 for the CPU).
SWA_GRAD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def _swa_bwd_inputs(shape, dtype, card, seed):
    S, H, Hkv, hd, window, qc = shape
    gen = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(2, S, heads, hd, generator=gen).to(dtype)
                     .to(card) for heads in (H, Hkv, Hkv, H))
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    return q, k, v, out, lse, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SWA_BWD_SHAPES, ids=str)
def test_flash_swa_bwd_matches_plain(card, shape, dtype):
    S, H, Hkv, hd, window, qc = shape
    q, k, v, out, lse, dout = _swa_bwd_inputs(shape, dtype, card, S + hd)
    # the forward's log-sum-exp against the plain version's
    _, want_lse = FK.flash_swa_plain(q.float(), k.float(), v.float(),
                                     window=window, qc=qc, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    before = dict(FK.LAUNCHES)
    got = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_swa_bwd"] == before["flash_swa_bwd"] + 1
    # bf16 heads up to 128 wide take a tensor-core backward, the rest not
    for route in ("flash_swa_bwd_wgmma", "flash_swa_bwd_mma"):
        assert FK.LAUNCHES[route] == before[route] + (
            route == FK.bwd_kernel_for(dtype, hd))
    want = FK.flash_swa_bwd_plain(*(t.float() for t in (q, k, v, out)), lse,
                                  dout.float(), window=window, qc=qc)
    rtol, atol = SWA_BWD_TOL[dtype]
    for name, g, w, t in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape, name
        torch.testing.assert_close(g.float(), w, rtol=rtol,
                                   atol=atol * max(1.0, float(w.abs().max())),
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_swa_bwd_is_deterministic(card, dtype):
    shape = (1024, 8, 2, 120, 256, 128)
    q, k, v, out, lse, dout = _swa_bwd_inputs(shape, dtype, card, 3)
    route = FK.bwd_kernel_for(dtype, shape[3])
    before = FK.LAUNCHES[route]
    first = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=256, qc=128)
    second = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=256, qc=128)
    assert FK.LAUNCHES[route] == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16) if dtype == torch.bfloat16
                           else a.view(torch.int32),
                           b.view(torch.int16) if dtype == torch.bfloat16
                           else b.view(torch.int32))


#: The tensor-core backwards' edges (S, H, Hkv, hd, window, qc): Danube's
#: head (120), the widest (128), heads not a multiple of 8 (the mma.sync
#: kernel's element loads) on an S that is not a multiple of the 64-row
#: tile, each smaller padded width (24, 64, 96), window 1, and S = qc +
#: window + qc; each on the route ``bwd_kernel_for`` names.
BWD_MMA_SHAPES = [(512, 8, 2, 120, 128, 64), (192, 4, 2, 128, 64, 64),
                  (160, 4, 2, 100, 64, 32), (200, 2, 1, 24, 40, 40),
                  (320, 4, 1, 64, 192, 64), (256, 4, 4, 96, 128, 64),
                  (130, 2, 1, 120, 1, 1), (96, 2, 1, 20, 32, 32)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", BWD_MMA_SHAPES, ids=str)
def test_flash_swa_bwd_mma_edges(card, shape, offset):
    """bf16 through the route ``bwd_kernel_for`` names, against the float32
    plain backward (``SWA_BWD_TOL``), and twice for the same bits; offset
    1 puts every operand one element (2 bytes) into its storage, so the
    mma.sync kernel takes its element loads and the wgmma route copies
    the operands first."""
    S, H, Hkv, hd, window, qc = shape
    gen = torch.Generator().manual_seed(S + hd + offset)

    def draw(heads):
        n = 2 * S * heads * hd
        t = torch.randn(n + offset, generator=gen).to(torch.bfloat16)
        return t.to(card)[offset:].view(2, S, heads, hd)

    q, k, v, dout = draw(H), draw(Hkv), draw(Hkv), draw(H)
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    before = dict(FK.LAUNCHES)
    got = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    again = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    torch.cuda.synchronize()
    for name in ("flash_swa_bwd", FK.bwd_kernel_for(torch.bfloat16, hd)):
        assert FK.LAUNCHES[name] == before[name] + 2, name
    want = FK.flash_swa_bwd_plain(*(t.float() for t in (q, k, v, out)), lse,
                                  dout.float(), window=window, qc=qc)
    rtol, atol = SWA_BWD_TOL[torch.bfloat16]
    for name, g, w, a in zip("qkv", got, want, again):
        assert g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g.float(), w, rtol=rtol,
                                   atol=atol * max(1.0, float(w.abs().max())),
                                   msg=lambda m: f"d{name}: {m}")
        assert torch.equal(g.view(torch.int16), a.view(torch.int16)), name


# ---------------------------------------------------------------------------
# K7 and its backward on the wgmma routes (csrc/flash_swa_wgmma.cu and
# csrc/flash_swa_bwd_wgmma.cu: bf16, hd % 8 == 0, hd <= 128).
# ---------------------------------------------------------------------------

#: (form, N, K) of the wgmma shapes the two kernels use
#: (``kernels/csrc/wgmma.cuh``): ``ss`` both operands K-major in shared
#: memory (S, dP and their transposes; N 64 or 128 key rows, K 64 or 128:
#: heads of one or two boxes), ``rs`` A from registers and B MN-major (P
#: V, dS K, P^T dO, dS^T Q; N the head's width, K a 64- or 128-row tile).
WGMMA_FORMS = [("ss", 64, 64), ("ss", 64, 128), ("ss", 128, 64),
               ("ss", 128, 128), ("rs", 64, 64), ("rs", 120, 64),
               ("rs", 128, 64), ("rs", 64, 128), ("rs", 120, 128),
               ("rs", 128, 128)]


@pytest.mark.parametrize("form", WGMMA_FORMS, ids=str)
def test_wgmma_shapes_match_matmul(card, form):
    """Each wgmma shape on operands that TMA loads with the kernels' boxes
    and swizzle (``tests/csrc/wgmma_probe.cu``), against torch.matmul:
    integer-valued bf16 operands make every product and sum exact, so a
    wrong descriptor or fragment order shows as a mismatch."""
    import ctypes
    import pathlib
    from repro_torch.kernels import _build
    name, n, k = form
    lib = _build.load(pathlib.Path(__file__).parent / "csrc"
                      / "wgmma_probe.cu")
    fn = getattr(lib, f"probe_{name}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(n + k)
    a = torch.randint(-4, 5, (64, k), generator=gen).to(torch.bfloat16)
    b = torch.randint(-4, 5, (n, k) if name == "ss" else (k, n),
                      generator=gen).to(torch.bfloat16)
    a, b = a.to(card), b.to(card)
    out = torch.full((64, n), float("nan"), device=card)
    assert fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, k) == 0
    torch.cuda.synchronize()
    want = a.float() @ (b.float().T if name == "ss" else b.float())
    assert torch.equal(out, want)


#: The wgmma routes' edges (S, H, Hkv, hd, window, qc): Danube's 120 and
#: Hymba's 64 and the widest 128; S and the window not multiples of the
#: 64- or 128-row tiles, at each head width with a GQA group of 4; window
#: 1 and window == S (== qc); GQA 1, 4 and 5; a rank's 13-head block with
#: K/V repeated a query head (H == Hkv); Hymba's rank of ``(1, 4)``: 7
#: heads of 64, window 1,024, at S 1,280 and at its S 4,096.
WGMMA_SHAPES = [(200, 8, 2, 120, 40, 40), (328, 5, 1, 64, 8, 8),
                (256, 4, 4, 128, 1, 1), (384, 4, 1, 120, 384, 128),
                (130, 2, 1, 128, 130, 130), (200, 13, 13, 64, 100, 100),
                (1280, 7, 7, 64, 1024, 128), (4096, 7, 7, 64, 1024, 128),
                (300, 8, 2, 120, 100, 100), (712, 4, 1, 120, 328, 8),
                (456, 8, 2, 64, 152, 8), (520, 8, 2, 128, 200, 40)]


def _wgmma_inputs(shape, offset, card):
    S, H, Hkv, hd, window, qc = shape
    gen = torch.Generator().manual_seed(S + H + hd + offset)

    def draw(heads):
        # offset 1: a contiguous view one element (2 bytes) into its
        # storage, which the wgmma routes copy to an aligned base first
        n = 2 * S * heads * hd
        t = torch.randn(n + offset, generator=gen).to(torch.bfloat16)
        return t.to(card)[offset:].view(2, S, heads, hd)

    return draw(H), draw(Hkv), draw(Hkv), draw(H)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=str)
def test_flash_swa_wgmma_edges(card, shape, offset):
    S, H, Hkv, hd, window, qc = shape
    q, k, v, _ = _wgmma_inputs(shape, offset, card)
    route = FK.kernel_for(torch.bfloat16, hd)
    assert route == "flash_swa_wgmma"
    before, copies = dict(FK.LAUNCHES), dict(FK.COPIES)
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    torch.cuda.synchronize()
    for name in ("flash_swa", route):
        assert FK.LAUNCHES[name] == before[name] + 1, name
    assert FK.LAUNCHES["flash_swa_mma"] == before["flash_swa_mma"]
    assert FK.COPIES[route] == copies[route] + 3 * offset
    want, want_lse = FK.flash_swa_plain(q.float(), k.float(), v.float(),
                                        window=window, qc=qc,
                                        return_lse=True)
    torch.testing.assert_close(out.float(), want, rtol=1e-2, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=str)
def test_flash_swa_bwd_wgmma_edges(card, shape, offset):
    """The wgmma backward against the float32 plain backward
    (``SWA_BWD_TOL``) and twice for the same bits, its counters checked;
    offset 1 copies the five bf16 inputs to aligned bases first."""
    S, H, Hkv, hd, window, qc = shape
    q, k, v, dout = _wgmma_inputs(shape, offset, card)
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    if offset:   # out, as the backward gets it: off alignment too
        out = torch.cat([out.new_zeros(1), out.flatten()])[1:].view_as(out)
    route = FK.bwd_kernel_for(torch.bfloat16, hd)
    assert route == "flash_swa_bwd_wgmma"
    before, copies = dict(FK.LAUNCHES), dict(FK.COPIES)
    got = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    again = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    torch.cuda.synchronize()
    for name in ("flash_swa_bwd", route):
        assert FK.LAUNCHES[name] == before[name] + 2, name
    assert FK.LAUNCHES["flash_swa_bwd_mma"] == before["flash_swa_bwd_mma"]
    assert FK.COPIES[route] == copies[route] + 2 * 5 * offset
    want = FK.flash_swa_bwd_plain(*(t.float() for t in (q, k, v, out)), lse,
                                  dout.float(), window=window, qc=qc)
    rtol, atol = SWA_BWD_TOL[torch.bfloat16]
    for name, g, w, a in zip("qkv", got, want, again):
        assert g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g.float(), w, rtol=rtol,
                                   atol=atol * max(1.0, float(w.abs().max())),
                                   msg=lambda m: f"d{name}: {m}")
        assert torch.equal(g.view(torch.int16), a.view(torch.int16)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_attention_function_matches_autograd_of_plain(card, dtype):
    from repro_torch.kernels.flash_swa.ops import flash_swa_gqa
    S, H, Hkv, hd, window, qc = 512, 8, 2, 120, 128, 64
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, S, heads, hd, generator=gen).to(dtype).to(card)
               .requires_grad_() for heads in (H, Hkv, Hkv))
    dout = torch.randn(1, S, H, hd, generator=gen).to(dtype).to(card)
    before = dict(FK.LAUNCHES)
    out = flash_swa_gqa(q, k, v, window=window, qc=qc)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert FK.LAUNCHES["flash_swa"] == before["flash_swa"] + 1
    assert FK.LAUNCHES["flash_swa_bwd"] == before["flash_swa_bwd"] + 1
    assert (FK.LAUNCHES["flash_swa_bwd_wgmma"]
            == before["flash_swa_bwd_wgmma"] + (dtype == torch.bfloat16))
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        FK.flash_swa_plain(*leaves, window=window, qc=qc), leaves,
        dout.float())
    rtol, atol = SWA_GRAD_TOL[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, rtol=rtol,
                                   atol=atol * max(1.0, float(w.abs().max())))


def test_kernel_refuses_inputs_that_need_a_gradient(card):
    q = torch.randn(1, 128, 2, 64, device=card, requires_grad=True)
    kv = torch.randn(1, 128, 1, 64, device=card)
    with pytest.raises(RuntimeError, match="autograd"):
        FK.flash_swa(q, kv, kv, window=64, qc=64)
    with torch.no_grad():
        assert FK.flash_swa(q, kv, kv, window=64, qc=64).grad_fn is None


def test_banded_danube_layer_backward_reaches_every_leaf(card):
    """A Danube-shaped banded block (full width, S 6,144 > qc + window) on
    the card: after backward every leaf has a finite gradient, and the
    attention projections a non-zero one (the K7 forward once had no
    ``grad_fn``, which left wq/wk/wv without gradients)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm as LM
    cfg = dataclasses.replace(get_config("h2o_danube3_4b"), num_layers=1)
    gen = torch.Generator(device=card).manual_seed(0)
    layer, _ = LM._layer_init(cfg, gen, card)
    leaves = dict(LM.tree_leaves(layer))
    for leaf in leaves.values():
        leaf.requires_grad_()
    S = cfg.attn_query_chunk + cfg.sliding_window + cfg.attn_query_chunk
    x = torch.randn(1, S, cfg.d_model, generator=gen, device=card).to(
        torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=card)[None]
    before = dict(FK.LAUNCHES)
    y, _, _ = LM._block(cfg, layer, x, pos)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_swa"] == before["flash_swa"] + 1
    assert FK.LAUNCHES["flash_swa_bwd"] == before["flash_swa_bwd"] + 1
    assert (FK.LAUNCHES["flash_swa_bwd_wgmma"]
            == before["flash_swa_bwd_wgmma"] + 1)
    for path, leaf in leaves.items():
        assert leaf.grad is not None, path
        assert bool(torch.isfinite(leaf.grad).all()), path
    for name in ("wq", "wk", "wv"):
        assert float(leaves[f"/attn/{name}"].grad.abs().max()) > 0, name


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_k7_on_a_ranks_local_heads(card, tp):
    """K7 and its backward at the head counts a rank of a model axis of
    ``tp`` runs for Danube (``32 / tp`` query and ``8 / tp`` KV heads of
    120, the GQA group of 4 kept), bfloat16 on the wgmma routes, against
    their plain versions on the same inputs."""
    shape = (1024, 32 // tp, 8 // tp, 120, 256, 128)
    S, H, Hkv, hd, window, qc = shape
    before = dict(FK.LAUNCHES)
    q, k, v, out, lse, dout = _swa_bwd_inputs(shape, torch.bfloat16, card,
                                              tp)
    want_out = FK.flash_swa_plain(q.float(), k.float(), v.float(),
                                  window=window, qc=qc)
    torch.testing.assert_close(out.float(), want_out, rtol=1e-2, atol=1e-4)
    got = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    for name in ("flash_swa_wgmma", "flash_swa_bwd_wgmma"):
        assert FK.LAUNCHES[name] == before[name] + 1, name
    want = FK.flash_swa_bwd_plain(*(t.float() for t in (q, k, v, out)), lse,
                                  dout.float(), window=window, qc=qc)
    rtol, atol = SWA_BWD_TOL[torch.bfloat16]
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g.float(), w, rtol=rtol,
                                   atol=atol * max(1.0, float(w.abs().max())),
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_paths_match_the_kernels_shapes(card, dtype):
    """On ``meta`` tensors K7, its backward and K5/K6 return what the
    kernels return on the card (shapes and types), launch nothing, and
    tally their useful flop (``kernels.tally``)."""
    from repro_torch.kernels import tally
    S, H, Hkv, hd, window, qc = 1024, 8, 2, 120, 256, 128
    gen = torch.Generator(device=card).manual_seed(31)
    q = torch.randn((1, S, H, hd), generator=gen, device=card).to(dtype)
    k, v = (torch.randn((1, S, Hkv, hd), generator=gen,
                        device=card).to(dtype) for _ in range(2))
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    grads = FK.flash_swa_bwd(q, k, v, out, lse, out, window=window, qc=qc)
    lhs = torch.randn((256, 64), generator=gen, device=card).to(dtype)
    rhs = torch.randn((2, 64, 128), generator=gen, device=card).to(dtype)
    experts = torch.tensor([0, 1], dtype=torch.int32, device=card)
    queue = (torch.tensor([1, 0], dtype=torch.int32, device=card),
             torch.tensor([2], dtype=torch.int32, device=card))
    k5 = SK.segmented_matmul(lhs, rhs, experts)
    k6 = SK.segmented_matmul_chunked(lhs, rhs, experts, *queue,
                                     max_chunks=2)
    on_card = [out, lse, *grads, k5, k6]
    launches = (dict(FK.LAUNCHES), dict(SK.LAUNCHES))
    tally.reset()
    meta = lambda t: t.to("meta")
    m_out, m_lse = FK.flash_swa(meta(q), meta(k), meta(v), window=window,
                                qc=qc, return_lse=True)
    m_grads = FK.flash_swa_bwd(*map(meta, (q, k, v, out, lse, out)),
                               window=window, qc=qc)
    m_k5 = SK.segmented_matmul(*map(meta, (lhs, rhs, experts)))
    m_k6 = SK.segmented_matmul_chunked(*map(meta, (lhs, rhs, experts)),
                                       *map(meta, queue), max_chunks=2)
    for got, want in zip([m_out, m_lse, *m_grads, m_k5, m_k6], on_card):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert (dict(FK.LAUNCHES), dict(SK.LAUNCHES)) == launches
    pairs = tally.band_pairs(S, window)
    assert tally.TALLY["flops"] == (14 * hd * H * pairs
                                    + 2 * 2 * 256 * 64 * 128)
    assert tally.TALLY["calls"] == {"flash_swa": 1, "flash_swa_bwd": 1,
                                    "segmented_matmul": 1,
                                    "segmented_matmul_chunked": 1}


def test_pipeline_hop_on_cuda_tensors_through_gloo(card):
    """Two spawned ranks sharing the card in one gloo group: the
    pipeline's hop (``GraphMesh.shift``, staged through host memory) and
    its output broadcast on CUDA tensors, both ways, in float32 and
    bfloat16; then a two-stage ``make_pipeline_apply`` of ``tanh(x W +
    b)`` on the card, forward and stage gradients against
    ``reference_apply`` on the CPU (1e-5 / 1e-4)."""
    from repro_torch.models.lm import tree_map
    from repro_torch.train.pipeline import reference_apply, split_stages
    from _torch_shard_group import _flat, run_group
    rng = np.random.default_rng(7)
    layers = {"w": (rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((4, 8)) * 0.1).astype(np.float32)}
    xs = rng.standard_normal((3, 2, 8)).astype(np.float32)
    case = {"mesh": (2, 1), "layers": layers, "xs": xs, "device": "cuda"}
    res = run_group(2, "pipe_hop", {"device": "cuda",
                                    "cases": {"tanh": case}})
    assert [r["ok"] for r in res] == [True, True]

    def stage_fn(p, x):
        for i in range(p["w"].shape[0]):
            x = torch.tanh(x @ p["w"][i] + p["b"][i])
        return x

    stages = tree_map(lambda a: a.requires_grad_(), split_stages(
        {k: torch.from_numpy(v) for k, v in layers.items()}, 2))
    want = reference_apply(stage_fn, stages, torch.from_numpy(xs), 2)
    (want ** 2).sum().backward()
    for r in res:
        got = r["cases"]["tanh"]
        np.testing.assert_allclose(got["y"], want.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        for k, g in _flat(got["grads"]).items():
            w = stages[k.strip("/")].grad[got["coord"]].numpy()
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
