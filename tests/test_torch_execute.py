"""Port parity: the executors and the plain versions of the four kernels.

Atom values are integer-valued floats (``_conformance``), so every sum is
exact and every comparison here is bitwise: the port's executors across
schedule x path x combiner x mask against the live ``repro.core``
executors, and the plain versions of K1-K4 against the reference's Pallas
kernels run in interpret mode on the same operands.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.kernels.spmv_merge import kernel as JK
from repro.kernels.spmv_merge import ref as JR
from repro_torch.kernels.spmv_merge import kernel as TK
from repro_torch.kernels.spmv_merge import ref as TR

from _conformance import int_valued_atom_values
from _torch_parity import assert_bitwise, np_of, spec_pair, t32, zoo

SIX = ("thread_mapped", "group_mapped", "nonzero_split", "merge_path",
       "chunked", "adaptive")
PATHS = ("pure", "native")
COMBINERS = ("sum", "min", "max")
EXEC_WORKLOADS = ("uniform", "one_heavy", "empties_between", "powerlaw",
                  "heavy_then_empties", "leading_empties", "powerlaw_big",
                  "empty")
NUM_OUT = 9


def _case(name, seed=0):
    """(jspec, tspec, values, mask, out_ids) for one zoo workload."""
    jspec, tspec = spec_pair(zoo()[name])
    n = jspec.num_atoms
    rng = np.random.default_rng(seed + 1)
    vals = int_valued_atom_values(n, seed)[:max(n, 1)]
    mask = rng.random(n) < 0.6
    out_ids = rng.integers(0, NUM_OUT, n).astype(np.int32)
    return jspec, tspec, vals, mask, out_ids


def _fns(vals):
    jv, tv = jnp.asarray(vals), t32(vals)
    return (lambda a: jv[a]), (lambda a: tv[a])


class TestTileReduce:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("combiner", COMBINERS)
    @pytest.mark.parametrize("name", EXEC_WORKLOADS)
    def test_matrix(self, name, combiner, masked):
        jspec, tspec, vals, mask, _ = _case(name)
        jfn, tfn = _fns(vals)
        jmask = jnp.asarray(mask) if masked else None
        tmask = t32(mask).bool() if masked else None
        want = J.tile_reduce(jspec, jfn, combiner=combiner, atom_mask=jmask)
        assert_bitwise(T.tile_reduce(tspec, tfn, combiner=combiner,
                                     atom_mask=tmask), want)
        for schedule in SIX:
            tpart = T.make_partition(tspec, schedule, 4)
            for path in PATHS:
                got = T.execute_tile_reduce(tspec, tpart, tfn, path=path,
                                            combiner=combiner,
                                            atom_mask=tmask)
                assert_bitwise(got, want, f"{schedule}/{path}")

    @pytest.mark.parametrize("schedule", SIX)
    def test_blocked_equals_reference_blocked(self, schedule):
        """The reference's own pure executor, schedule by schedule."""
        jspec, tspec, vals, mask, _ = _case("powerlaw_big")
        jfn, tfn = _fns(vals)
        jpart = J.make_partition(jspec, schedule, 6)
        tpart = T.make_partition(tspec, schedule, 6)
        assert_bitwise(
            T.blocked_tile_reduce(tspec, tpart, tfn, combiner="sum",
                                  atom_mask=t32(mask).bool()),
            J.blocked_tile_reduce(jspec, jpart, jfn, combiner="sum",
                                  atom_mask=jnp.asarray(mask)))

    def test_paths_route(self):
        _, tspec, _, _, _ = _case("uniform")
        part = T.make_partition(tspec, "chunked", 4)
        assert T.choose_execution_path(part) == T.ExecutionPath.NATIVE
        assert T.choose_execution_path(part, "pure") == T.ExecutionPath.PURE
        bare = T.Partition(part.schedule, part.num_blocks,
                           part.items_per_block, part.atom_starts,
                           part.tile_starts, part.tile_aligned)
        assert not T.supports_native_execution(bare)
        with pytest.raises(ValueError, match="native"):
            T.choose_execution_path(bare, "native")
        with pytest.raises(ValueError, match="combiner"):
            T.tile_reduce(tspec, lambda a: a, combiner="prod")


class TestScatterReduce:
    @pytest.mark.parametrize("capacity", [None, 3, "exact", 100_000])
    @pytest.mark.parametrize("combiner", COMBINERS)
    @pytest.mark.parametrize("name", ["one_heavy", "powerlaw",
                                      "powerlaw_big", "alternating"])
    def test_matrix(self, name, combiner, capacity):
        """Masked windows, compacted windows, and compaction overflow
        (capacity 3 is far below the active count)."""
        jspec, tspec, vals, mask, out_ids = _case(name, seed=2)
        if capacity == "exact":
            capacity = int(mask.sum())
        jfn, tfn = _fns(vals)
        jpart = J.make_partition(jspec, "merge_path", 4)
        want = J.execute_scatter_reduce(
            jspec, jpart, jfn, jnp.asarray(out_ids), NUM_OUT, path="pure",
            combiner=combiner, atom_mask=jnp.asarray(mask),
            compact_capacity=capacity)
        for schedule in SIX:
            tpart = T.make_partition(tspec, schedule, 4)
            for path in PATHS:
                got = T.execute_scatter_reduce(
                    tspec, tpart, tfn, t32(out_ids), NUM_OUT, path=path,
                    combiner=combiner, atom_mask=t32(mask).bool(),
                    compact_capacity=capacity)
                assert_bitwise(got, want, f"{schedule}/{path}")

    @pytest.mark.parametrize("schedule", SIX)
    def test_windows_equal(self, schedule):
        """Both paths' value windows equal the reference's, slot by slot."""
        jspec, tspec, vals, mask, _ = _case("powerlaw_big", seed=3)
        jfn, tfn = _fns(vals)
        jpart = J.make_partition(jspec, schedule, 5)
        tpart = T.make_partition(tspec, schedule, 5)
        want = J.blocked_value_windows(jspec, jpart, jfn, combiner="min",
                                       atom_mask=jnp.asarray(mask))
        tmask = t32(mask).bool()
        for make in (T.blocked_value_windows, T.native_chunk_value_windows):
            assert_bitwise(make(tspec, tpart, tfn, combiner="min",
                                atom_mask=tmask), want, make.__name__)
        jidx, jcount = J.compact_active_atoms(jnp.asarray(mask), 64)
        tidx, tcount = T.compact_active_atoms(tmask, 64)
        np.testing.assert_array_equal(np_of(tidx), np_of(jidx))
        assert int(tcount) == int(jcount)
        want = J.blocked_compact_value_windows(jspec, jpart, jfn, jidx,
                                               combiner="max")
        for make in (T.blocked_compact_value_windows,
                     T.native_compact_value_windows):
            assert_bitwise(make(tspec, tpart, tfn, tidx, combiner="max"),
                           want, make.__name__)


def _native_operands(jspec, jpart, vals, mask, window):
    """The padded operands the reference's native executors build."""
    block_chunks, counts, _ = J.execute._chunk_queue_view(jpart)
    padded = np.concatenate([vals[:jspec.num_atoms],
                             np.zeros(window, np.float32)])
    tids = np.concatenate([np_of(jspec.atom_tile_ids()),
                           np.full(window, jspec.num_tiles)]).astype(np.int32)
    mask_p = np.concatenate([mask.astype(np.int32),
                             np.zeros(window, np.int32)])
    return (padded, tids, np_of(jpart.atom_starts).astype(np.int32),
            np_of(jpart.tile_starts).astype(np.int32),
            np_of(block_chunks).reshape(-1).astype(np.int32),
            np_of(counts).astype(np.int32), mask_p,
            int(np_of(block_chunks).shape[1]))


class TestKernelPlainVersions:
    """K1-K4's plain versions against the Pallas kernels (interpret)."""

    @pytest.mark.parametrize("combiner", COMBINERS)
    @pytest.mark.parametrize("schedule", ["chunked", "merge_path"])
    def test_chunk_walk_tiles(self, schedule, combiner):
        jspec, _, vals, mask, _ = _case("powerlaw_big", seed=4)
        jpart = J.make_partition(jspec, schedule, 5)
        window, local_tiles = J.execute._window_sizes(jspec, jpart)
        (v, tids, starts, tstarts, chunks, counts, m,
         max_chunks) = _native_operands(jspec, jpart, vals, mask, window)
        kw = dict(window=window, local_tiles=local_tiles,
                  max_chunks=max_chunks, combiner=combiner)
        want = JK.chunk_walk_reduce(
            jnp.asarray(v), jnp.asarray(tids), jnp.asarray(starts),
            jnp.asarray(tstarts), jnp.asarray(chunks), jnp.asarray(counts),
            jnp.asarray(m), interpret=True, **kw)
        args = [t32(a) for a in (v, tids, starts, tstarts, chunks, counts,
                                 m)]
        assert_bitwise(TK.chunk_walk_reduce_ref(*args, **kw), want)
        assert_bitwise(TK.chunk_walk_reduce(*args, **kw), want)

    @pytest.mark.parametrize("combiner", ["sum", "min"])
    def test_chunk_walk_atoms(self, combiner):
        jspec, _, vals, mask, _ = _case("powerlaw_big", seed=5)
        jpart = J.make_partition(jspec, "chunked", 5)
        window, local_tiles = J.execute._window_sizes(jspec, jpart)
        (v, _, starts, tstarts, chunks, counts, m,
         max_chunks) = _native_operands(jspec, jpart, vals, mask, window)
        kw = dict(window=window, local_tiles=local_tiles,
                  max_chunks=max_chunks, combiner=combiner, emit="atoms")
        want = JK.chunk_walk_reduce(
            jnp.asarray(v), None, jnp.asarray(starts), jnp.asarray(tstarts),
            jnp.asarray(chunks), jnp.asarray(counts), jnp.asarray(m),
            interpret=True, **kw)
        args = [t32(v), None] + [t32(a) for a in (starts, tstarts, chunks,
                                                  counts, m)]
        assert_bitwise(TK.chunk_walk_reduce_ref(*args, **kw), want)

    @pytest.mark.parametrize("combiner", ["max", "sum"])
    def test_chunk_walk_compact(self, combiner):
        jspec, _, vals, mask, _ = _case("powerlaw_big", seed=6)
        jpart = J.make_partition(jspec, "adaptive", 5)
        n = jspec.num_atoms
        capacity = 200
        idx, _ = J.compact_active_atoms(jnp.asarray(mask), capacity)
        num_chunks = int(jpart.atom_starts.shape[0]) - 1
        window = -(-capacity // num_chunks)
        starts = np_of(J.compact_chunk_starts(num_chunks, capacity))
        block_chunks, counts, _ = J.execute._chunk_queue_view(jpart)
        v = np.concatenate([vals[:n], np.zeros(window, np.float32)])
        idx_p = np.concatenate([np.minimum(np_of(idx), n),
                                np.full(window, n)]).astype(np.int32)
        ops = (starts.astype(np.int32), np.zeros_like(starts, np.int32),
               np_of(block_chunks).reshape(-1).astype(np.int32),
               np_of(counts).astype(np.int32))
        kw = dict(window=window, local_tiles=1,
                  max_chunks=int(np_of(block_chunks).shape[1]),
                  combiner=combiner, emit="compact")
        want = JK.chunk_walk_reduce(
            jnp.asarray(v), None, *map(jnp.asarray, ops), None,
            jnp.asarray(idx_p), interpret=True, **kw)
        got = TK.chunk_walk_reduce_ref(t32(v), None, *map(t32, ops), None,
                                       t32(idx_p), **kw)
        assert_bitwise(got, want)

    @pytest.mark.parametrize("block_items", [128, 256])
    def test_merge_stream(self, block_items):
        """K1 (+ its fixup) on an integer-valued merge stream."""
        rng = np.random.default_rng(7)
        sizes = rng.zipf(1.5, 120) % 40
        sizes[rng.random(120) < 0.2] = 0
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        nnz = int(offsets[-1])
        cols = rng.integers(0, 50, nnz).astype(np.int32)
        values = rng.integers(-4, 5, nnz).astype(np.float32)
        x = rng.integers(-3, 4, 50).astype(np.float32)
        total = -(-(120 + nnz) // block_items) * block_items
        js = JR.merge_stream_ref(jnp.asarray(offsets), jnp.asarray(cols),
                                 jnp.asarray(values), jnp.asarray(x), 120,
                                 nnz, total)
        ts = TR.merge_stream_ref(t32(offsets), t32(cols), t32(values), t32(x),
                                 120, nnz, total)
        for got, want in zip(ts, js):
            assert_bitwise(got, np_of(want).astype(np.float32))
        rows = np_of(js[1])
        row_base = np.minimum(rows[::block_items], 119).astype(np.int32)
        want = JK.spmv_merge_stream(js[0], js[1], jnp.asarray(row_base),
                                    num_rows=120, block_items=block_items,
                                    interpret=True)
        for run in (TK.spmv_merge_stream_ref, TK.spmv_merge_stream):
            assert_bitwise(run(ts[0], ts[1], t32(row_base), num_rows=120,
                               block_items=block_items), want)
        assert_bitwise(TR.spmv_ref(t32(offsets), t32(cols), t32(values),
                                   t32(x), 120),
                       JR.spmv_ref(jnp.asarray(offsets), jnp.asarray(cols),
                                   jnp.asarray(values), jnp.asarray(x), 120))

    def test_wrappers_check_operands(self):
        ok = dict(window=4, local_tiles=2, max_chunks=1)
        v = t32(np.zeros(8, np.float32))
        i = t32(np.zeros(8, np.int32))
        starts = t32(np.asarray([0, 4], np.int32))
        with pytest.raises(TypeError, match="float32"):
            TK.chunk_walk_reduce(i, i, starts, starts, starts[:1],
                                 starts[:1], **ok)
        with pytest.raises(ValueError, match="emit"):
            TK.chunk_walk_reduce(v, i, starts, starts, starts[:1],
                                 starts[:1], emit="rows", **ok)
        with pytest.raises(ValueError, match="block_items"):
            TK.merge_block_partials(v, i, starts[:1], block_items=3)
