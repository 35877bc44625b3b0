"""The sort-free fixup (``kernel.segment_sum_fixup``) on the CPU.

``fixup_partials``' float sum on the card walks the order a stable sort of
the bins' tile ids would give, straight from ``part.tile_starts``.  Its
plain version builds that order from the same closed-form offsets the CUDA
kernel computes (``kernel.fixup_offsets``) and sums with ``index_add_``, so
here it must equal, bitwise, the route ``fixup_partials`` takes on the CPU
(one ``segment_reduce`` in flat bin order) and the sorted route (a stable
sort, then ``segment_sum_sorted``'s plain version), at every width; and the
reference's ``fixup_partials``: bitwise on integer-valued partials, within
1e-6 of each tile's absolute sum on real ones (XLA's CPU scatter-add adds
in its own order).  The order needs non-decreasing ``tile_starts``, which
every schedule's partition has.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import execute as E
from repro_torch.kernels.spmv_merge import kernel as TK

from _torch_parity import assert_bitwise, reference_modules, spec_pair
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)

SIX = ("thread_mapped", "group_mapped", "nonzero_split", "merge_path",
       "chunked", "adaptive")
WIDTHS = (1, 3, 8, 128)


def _graph_sizes(seed: int, rows: int = 300) -> np.ndarray:
    """Row lengths of a seeded scale-free graph: most rows short, a few
    hubs, runs of empty rows."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(rng.zipf(1.5, rows), 400)
    sizes[rng.random(rows) < 0.3] = 0
    return sizes.astype(np.int32)


def _spec(sizes):
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return T.WorkSpec.from_segment_offsets(torch.from_numpy(offsets),
                                           num_atoms=int(offsets[-1]))


def _partition(spec, schedule: str, num_blocks: int = 7):
    part = T.schedules.finalize_partition(
        T.make_partition(spec, schedule, num_blocks))
    return part, E._window_sizes(spec, part)[1]


def _partials(rng, chunks: int, local_tiles: int, width, integer=False):
    """``[C, L]`` (width None) or ``[C, L, B]`` partials with empty bins:
    a third hold +0.0 (the identity a chunk leaves in a bin it never
    reaches), a few -0.0."""
    shape = (chunks, local_tiles) + (() if width is None else (width,))
    vals = (rng.integers(-8, 9, shape) if integer
            else rng.standard_normal(shape))
    vals = np.where(rng.random(shape) < 0.3, 0.0, vals)
    vals = np.where(rng.random(shape) < 0.02, -0.0, vals)
    return torch.from_numpy(vals.astype(np.float32))


def _sorted_route(partials, tile_starts, num_tiles):
    """The sorted route on the CPU: a stable sort of the bins' tile ids,
    then ``segment_sum_sorted``'s plain version (bins past the last tile
    into an overflow segment, sliced off)."""
    chunks, local_tiles = partials.shape[:2]
    gtid = tile_starts[:-1, None].long() + torch.arange(local_tiles)[None, :]
    gtid = torch.where(gtid < num_tiles, gtid, num_tiles).reshape(-1)
    keys, order = torch.sort(gtid.to(torch.int32), stable=True)
    flat = partials.reshape(chunks * local_tiles, *partials.shape[2:])
    return TK.segment_sum_sorted(flat, keys, num_tiles + 1,
                                 order=order)[:-1]


def _hand_built(name: str):
    """(tile_starts, local_tiles, num_tiles) of hand-built partitions."""
    if name == "repeated_starts":     # runs of chunks starting on one tile
        starts = [0, 0, 0, 3, 3, 7, 7, 7, 7, 8, 20, 20, 31]
        return starts, 5, 32
    if name == "one_tile_500_chunks":  # one tile spans 500 chunks
        return [0] + [4] * 500 + [9], 3, 10
    if name == "bins_past_the_end":    # windows run past the last tile
        return [0, 2, 5, 9, 12, 12, 13], 6, 14
    if name == "starts_at_the_end":    # chunks that start on num_tiles
        return [0, 1, 4, 4, 6, 6, 6], 2, 6
    return [0, 6, 6, 13, 40], 30, 41   # "wide": long windows, a gap


HAND_BUILT = ["repeated_starts", "one_tile_500_chunks", "bins_past_the_end",
              "starts_at_the_end", "wide"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("schedule", SIX)
def test_tile_starts_never_decrease(schedule, seed):
    """The fixup's order needs non-decreasing ``tile_starts``: every
    schedule's partition has it, at several block counts."""
    spec = _spec(_graph_sizes(seed))
    for num_blocks in (1, 3, 7, 64):
        part = T.make_partition(spec, schedule, num_blocks)
        starts = part.tile_starts.numpy()
        assert (np.diff(starts) >= 0).all(), (schedule, num_blocks)
        assert starts[0] >= 0 and starts[-1] <= spec.num_tiles


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("schedule", SIX)
def test_plain_fixup_equals_fixup_partials(schedule, width):
    """Bitwise: the plain fixup, ``fixup_partials``' route on the CPU (one
    ``segment_reduce`` in flat bin order) and the sorted route, on the
    partitions of every schedule over a seeded graph."""
    rng = np.random.default_rng(SIX.index(schedule) * 10 + width)
    spec = _spec(_graph_sizes(5))
    part, local_tiles = _partition(spec, schedule)
    partials = _partials(rng, part.num_blocks, local_tiles,
                         None if width == 1 else width)
    want = E.fixup_partials(spec, part, partials, local_tiles)
    got = TK.segment_sum_fixup(partials, part.tile_starts, spec.num_tiles)
    assert got.shape == want.shape
    assert_bitwise(got, want, schedule)
    assert_bitwise(_sorted_route(partials, part.tile_starts,
                                 spec.num_tiles), want, schedule)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", HAND_BUILT)
def test_plain_fixup_on_hand_built_partitions(name, width):
    starts, local_tiles, num_tiles = _hand_built(name)
    tile_starts = torch.tensor(starts, dtype=torch.int32)
    rng = np.random.default_rng(HAND_BUILT.index(name))
    partials = _partials(rng, len(starts) - 1, local_tiles,
                         None if width == 1 else width)
    got = TK.segment_sum_fixup(partials, tile_starts, num_tiles)
    want = _sorted_route(partials, tile_starts, num_tiles)
    assert_bitwise(got, want, name)
    if width > 1:                  # column j: the call on column j alone
        for j in range(width):
            assert_bitwise(got[:, j], TK.segment_sum_fixup(
                partials[:, :, j].contiguous(), tile_starts, num_tiles),
                f"{name}/{j}")


@pytest.mark.parametrize("name", HAND_BUILT + list(SIX))
def test_fixup_order_is_the_stable_sort(name):
    """The kernel's closed-form offsets give the items (and their bins) of
    a stable sort of the bins' tile ids, the bins past the last tile left
    out; ``off`` equals the cumsum of an integer difference array."""
    if name in SIX:
        spec = _spec(_graph_sizes(7))
        part, local_tiles = _partition(spec, name)
        tile_starts, num_tiles = part.tile_starts, spec.num_tiles
    else:
        starts, local_tiles, num_tiles = _hand_built(name)
        tile_starts = torch.tensor(starts, dtype=torch.int32)
    chunks = int(tile_starts.shape[0]) - 1
    gtid = tile_starts[:-1, None].long() + torch.arange(local_tiles)[None, :]
    gtid = torch.where(gtid < num_tiles, gtid, num_tiles).reshape(-1)
    keys, order = torch.sort(gtid, stable=True)
    got_keys, rows = TK.fixup_order(tile_starts, local_tiles, num_tiles)
    n = int(got_keys.shape[0])
    assert torch.equal(got_keys, keys[:n]) and torch.equal(rows, order[:n])
    assert bool((keys[n:] == num_tiles).all())
    # the counts as an integer difference array over tile_starts
    starts = tile_starts[:-1].long()
    diff = torch.zeros(num_tiles + 1, dtype=torch.int64)
    diff.index_add_(0, torch.clamp(starts, max=num_tiles),
                    torch.ones(chunks, dtype=torch.int64))
    diff.index_add_(0, torch.clamp(starts + local_tiles, max=num_tiles),
                    -torch.ones(chunks, dtype=torch.int64))
    counts = torch.cumsum(diff, 0)[:num_tiles]
    off, lo = TK.fixup_offsets(tile_starts, local_tiles, num_tiles)
    assert torch.equal(off, torch.cat([torch.zeros(1, dtype=torch.int64),
                                       torch.cumsum(counts, 0)]))
    assert int(off[-1]) == n
    # lo(t): the first chunk that reaches tile t
    for t in range(0, num_tiles, max(1, num_tiles // 50)):
        reach = ((starts <= t) & (t < starts + local_tiles)).nonzero()
        if reach.numel():
            assert int(lo[t]) == int(reach[0])


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.core", "repro.core.execute") as mods:
        yield mods


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("schedule", SIX)
def test_plain_fixup_against_the_reference(ref, schedule, width, integer):
    """The reference's ``fixup_partials`` (one column at a time, its
    ``vmap`` written out) on the reference's own partition: bitwise on
    integer-valued partials; within 1e-6 of each tile's absolute sum on
    real ones."""
    J, JE = ref
    sizes = _graph_sizes(9, rows=200)
    jspec, tspec = spec_pair(sizes)
    jpart = J.make_partition(jspec, schedule, 6)
    tpart, local_tiles = _partition(tspec, schedule, 6)
    np.testing.assert_array_equal(np.asarray(jpart.tile_starts),
                                  tpart.tile_starts.numpy())
    rng = np.random.default_rng(SIX.index(schedule) + 20 * width)
    partials = _partials(rng, tpart.num_blocks, local_tiles, width,
                         integer=integer)
    got = TK.segment_sum_fixup(partials, tpart.tile_starts,
                               tspec.num_tiles).numpy()
    want = np.stack([np.asarray(JE.fixup_partials(
        jspec, jpart, jnp.asarray(partials[:, :, j].numpy()), local_tiles))
        for j in range(width)], axis=1)
    if integer:
        assert_bitwise(got, want, schedule)
        return
    gtid = (tpart.tile_starts[:-1, None].long()
            + torch.arange(local_tiles)[None, :]).numpy().reshape(-1)
    keep = gtid < tspec.num_tiles
    scale = np.zeros((tspec.num_tiles, width))
    np.add.at(scale, gtid[keep],
              np.abs(partials.numpy().reshape(-1, width)[keep]))
    assert (np.abs(got - want) <= 1e-6 * scale).all(), float(
        np.abs(got - want).max())


def test_fixup_partials_on_the_cpu_keeps_its_route():
    """On the CPU ``fixup_partials`` is one ``segment_reduce`` as before:
    no fixup launch is counted, min/max are unchanged, and bfloat16
    partials come back in bfloat16."""
    spec = _spec(_graph_sizes(3))
    part, local_tiles = _partition(spec, "chunked")
    rng = np.random.default_rng(3)
    partials = _partials(rng, part.num_blocks, local_tiles, 3)
    before = dict(TK.LAUNCHES)
    got = E.fixup_partials(spec, part, partials, local_tiles)
    assert TK.LAUNCHES == before
    assert_bitwise(got, TK.segment_sum_fixup(partials, part.tile_starts,
                                             spec.num_tiles))
    for combiner in ("min", "max"):
        out = E.fixup_partials(spec, part, partials, local_tiles, combiner)
        assert out.shape == (spec.num_tiles, 3)
    half = E.fixup_partials(spec, part, partials.bfloat16(), local_tiles)
    assert half.dtype == torch.bfloat16


def test_segment_sum_fixup_checks_its_operands():
    before = TK.LAUNCHES["segment_sum_fixup"]
    starts = torch.tensor([0, 1, 3], dtype=torch.int32)
    partials = torch.ones(2, 4)
    with pytest.raises(TypeError):
        TK.segment_sum_fixup(partials.int(), starts, 5)
    with pytest.raises(TypeError):
        TK.segment_sum_fixup(partials, starts.long(), 5)
    with pytest.raises(ValueError):
        TK.segment_sum_fixup(partials, starts[:2], 5)
    with pytest.raises(ValueError):
        TK.segment_sum_fixup(torch.ones(8), starts, 5)
    with pytest.raises(ValueError):
        TK.segment_sum_fixup(partials, starts, -1)
    with pytest.raises(ValueError):
        TK.segment_sum_fixup(torch.ones(2, 4, device="meta"),
                             starts.to("meta"), 5)
    assert TK.segment_sum_fixup(partials, starts, 0).shape == (0,)
    empty = TK.segment_sum_fixup(torch.ones(0, 4, 2),
                                 torch.zeros(1, dtype=torch.int32), 6)
    assert empty.shape == (6, 2) and not bool(empty.any())
    assert TK.LAUNCHES["segment_sum_fixup"] == before
