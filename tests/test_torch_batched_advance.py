"""Port parity: the column batch of the tile-reduce executors, the pull
advance and the segmented reduces (the reference's ``vmap`` over columns,
written out as a batch dimension), on the CPU plain versions.

A batched call on ``[atoms, B]`` values must equal ``torch.stack`` of the
per-column calls bitwise, real-valued data included: on the CPU both sum
in ascending position.  ``spmm`` over B columns and the batched plain
version of K2 are held to the live reference (the SpMV tolerance, and
bitwise on the Pallas kernel in interpret mode, column by column).  A NaN
in a min/max bin gives NaN, as in the reference's ``chunk_walk_reduce``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro.kernels.spmv_merge import kernel as JK
from repro_torch.core import execute as E
from repro_torch.core import segops
from repro_torch.kernels.spmv_merge import kernel as TK
from repro_torch.sparse import Graph, advance, build_advance, random_csr
from repro_torch.sparse import wavefront as TW

from _torch_parity import assert_bitwise, np_of, reference_sparse, t32
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)

CPU = torch.device("cpu")
#: (schedule name of build_advance, make_partition schedule, chunk policy)
SCHEDULES = [("chunked_lpt", "chunked", "lpt"),
             ("chunked_rr", "chunked", "round_robin"),
             ("merge_path", "merge_path", "lpt")]
COMBINERS = ("sum", "min", "max")
PATHS = ("pure", "native")
WIDTHS = (1, 3, 128)


def _spec(seed=0, tiles=400):
    """A power-law tile-size spec with empty tiles and a hub tile."""
    sizes = np.random.default_rng(seed).zipf(1.5, tiles) % 60
    sizes[7] = 700
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return T.WorkSpec.from_segment_offsets(offsets,
                                           num_atoms=int(offsets[-1]),
                                           device=CPU)


def _columns(rng, n, width):
    return torch.from_numpy(rng.standard_normal((n, width))
                            .astype(np.float32))


def _per_column(run, vals):
    """``run(atom_fn)`` on each column of ``vals`` alone, stacked."""
    return torch.stack([run(lambda a, col=vals[:, j].contiguous(): col[a])
                        for j in range(vals.shape[1])], dim=1)


class TestExecutorBatch:
    @pytest.mark.parametrize("path", PATHS)
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("combiner", COMBINERS)
    @pytest.mark.parametrize("width", WIDTHS)
    @pytest.mark.parametrize("name,schedule,policy", SCHEDULES)
    def test_tile_reduce(self, name, schedule, policy, width, combiner,
                         masked, path):
        spec = _spec()
        part = T.make_partition(spec, schedule, 9, chunk_policy=policy)
        rng = np.random.default_rng(width)
        vals = _columns(rng, spec.num_atoms, width)
        mask = (torch.from_numpy(rng.random(spec.num_atoms) < 0.6)
                if masked else None)
        run = lambda fn: T.execute_tile_reduce(spec, part, fn, path=path,
                                               combiner=combiner,
                                               atom_mask=mask)
        got = run(lambda a: vals[a])
        assert got.shape == (spec.num_tiles, width)
        assert_bitwise(got, _per_column(run, vals), name)
        assert_bitwise(T.tile_reduce(spec, lambda a: vals[a],
                                     combiner=combiner, atom_mask=mask),
                       _per_column(lambda fn: T.tile_reduce(
                           spec, fn, combiner=combiner, atom_mask=mask),
                           vals))

    @pytest.mark.parametrize("path", PATHS)
    def test_no_atoms(self, path):
        spec = T.WorkSpec.from_segment_offsets(np.zeros(4, np.int32),
                                               num_atoms=0, device=CPU)
        part = T.make_partition(spec, "chunked", 3)
        vals = torch.zeros((0, 5))
        got = T.execute_tile_reduce(spec, part, lambda a: vals[a], path=path,
                                    combiner="max")
        assert got.shape == (3, 5) and bool((got == -np.inf).all())

    def test_chunk_walk_operands_pad_every_column(self):
        spec = _spec(1)
        part = T.make_partition(spec, "chunked", 5)
        vals = _columns(np.random.default_rng(0), spec.num_atoms, 3)
        args, kw = E.chunk_walk_operands(spec, part, vals, combiner="min")
        assert args[0].shape == (spec.num_atoms + kw["window"], 3)
        assert bool((args[0][spec.num_atoms:] == np.inf).all())

    def test_scatter_takes_one_column(self):
        spec = _spec(2)
        part = T.make_partition(spec, "chunked", 5)
        vals = torch.ones((spec.num_atoms, 2))
        out_ids = torch.zeros(spec.num_atoms, dtype=torch.int32)
        with pytest.raises(ValueError, match=r"\[atoms\] values"):
            T.execute_scatter_reduce(spec, part, lambda a: vals[a], out_ids,
                                     4, path="pure")
        with pytest.raises(ValueError, match=r"\[atoms\] or \[atoms, B\]"):
            T.execute_tile_reduce(spec, part,
                                  lambda a: torch.ones((a.shape[0], 2, 2)))


class TestLaneTileReduce:
    """B lanes laid end to end through the one-column chunk walk: each
    lane's chunks are copies of the partition's, so each lane's partials
    and result have the one-lane call's bits (on the card the B-column
    kernel adds real values in an order that depends on B).  The layout is
    built for 8 lanes and fewer use its prefix."""

    @pytest.mark.parametrize("path", PATHS)
    @pytest.mark.parametrize("combiner", COMBINERS)
    @pytest.mark.parametrize("lanes", (1, 2, 5, 8))
    @pytest.mark.parametrize("name,schedule,policy", SCHEDULES)
    def test_lanes_equal_one_lane_calls(self, name, schedule, policy, lanes,
                                        combiner, path):
        spec = _spec(3, tiles=401)
        part = T.make_partition(spec, schedule, 9, chunk_policy=policy)
        vals = _columns(np.random.default_rng(lanes), spec.num_atoms, lanes)
        layout = E.LaneLayout(spec, part, 8, path=path)
        got = layout.reduce(lanes, lambda out: out.copy_(vals.t()),
                            combiner=combiner)
        assert got.shape == (spec.num_tiles, lanes)
        want = _per_column(lambda fn: T.execute_tile_reduce(
            spec, part, fn, path=path, combiner=combiner), vals)
        assert_bitwise(got, want, name)

    @pytest.mark.parametrize("num_atoms_mod_4", [0, 1, 3])
    def test_lane_operands_copy_the_partition(self, num_atoms_mod_4):
        sizes = np.random.default_rng(4).integers(0, 30, 90)
        sizes[0] += (num_atoms_mod_4 - int(sizes.sum())) % 4
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        spec = T.WorkSpec.from_segment_offsets(
            offsets, num_atoms=int(offsets[-1]), device=CPU)
        part = T.make_partition(spec, "chunked", 4)
        B, A = 3, spec.num_atoms
        lanes = _columns(np.random.default_rng(5), A, B).t().contiguous()
        layout = E.LaneLayout(spec, part, B + 2, path="native")
        args, kw = layout.operands(B, lambda out: out.copy_(lanes))
        vals, tids, atom_starts, tile_starts, chunks, counts, mask = args
        stride = -(-A // 4) * 4
        C = int(part.atom_starts.shape[0]) - 1
        assert mask is None and vals.shape == tids.shape
        assert vals.shape[0] == B * stride + kw["window"]
        assert atom_starts.shape == (B * (C + 1) + 1,)
        assert int(atom_starts[-1]) == B * stride
        queues = counts.view(B, -1)
        assert bool((queues == queues[0]).all())
        # no queue pops a lane's gap chunk
        popped = set(chunks.view(counts.shape[0], -1)[
            torch.arange(kw["max_chunks"])[None, :]
            < counts[:, None].long()].tolist())
        assert popped == {j * (C + 1) + c for j in range(B)
                          for c in range(C)}
        one, kw1 = E.chunk_walk_operands(spec, part, lanes[0])
        want = TK.chunk_walk_reduce(*one, **kw1)
        got = TK.chunk_walk_reduce(*args, **kw).view(B, C + 1, -1)
        for j in range(B):
            assert int(atom_starts[j * (C + 1)]) == j * stride
            assert_bitwise(got[j, :C], TK.chunk_walk_reduce(
                *E.chunk_walk_operands(spec, part, lanes[j])[0], **kw1))
        assert_bitwise(got[0, :C], want)
        with pytest.raises(ValueError, match="lanes on a layout"):
            layout.operands(B + 3, lambda out: None)


class TestAdvanceBatch:
    @pytest.fixture(scope="class")
    def graph(self):
        A = random_csr(600, 600, 5000, skew=1.3, empty_frac=0.3, seed=3,
                       device=CPU)
        return Graph(A)

    @pytest.mark.parametrize("path", PATHS)
    @pytest.mark.parametrize("combiner", COMBINERS)
    @pytest.mark.parametrize("name,schedule,policy", SCHEDULES)
    def test_pull_advance(self, graph, name, schedule, policy, combiner,
                          path):
        plan = build_advance(graph, schedule=name, num_blocks=12, path=path)
        rng = np.random.default_rng(4)
        frontier = torch.from_numpy(rng.random(graph.num_vertices) < 0.5)
        for width in WIDTHS:
            h = _columns(rng, graph.num_vertices, width)
            src = plan.src
            got = advance(plan, frontier, lambda e: h[src[e]],
                          combiner=combiner)
            want = torch.stack(
                [advance(plan, frontier,
                         lambda e, col=h[:, j].contiguous(): col[src[e]],
                         combiner=combiner) for j in range(width)], dim=1)
            assert got.shape == (graph.num_vertices, width)
            assert_bitwise(got, want, f"{name}/{path}/{width}")


class TestSegmentReduceBatch:
    @pytest.mark.parametrize("width", WIDTHS)
    @pytest.mark.parametrize("combiner", COMBINERS)
    def test_columns_equal_one_column_calls(self, combiner, width):
        rng = np.random.default_rng(width + 7)
        ids = torch.from_numpy(rng.integers(0, 300, 5000))
        vals = _columns(rng, 5000, width)
        got = segops.segment_reduce(combiner, vals, ids, 301)
        want = torch.stack([segops.segment_reduce(combiner, vals[:, j],
                                                  ids, 301)
                            for j in range(width)], dim=1)
        assert got.shape == (301, width)
        assert_bitwise(got, want)

    @pytest.mark.parametrize("width", WIDTHS)
    def test_ordered_sum_and_its_plain_version(self, width):
        rng = np.random.default_rng(width)
        ids = torch.from_numpy(rng.integers(0, 90, 3000).astype(np.int32))
        vals = _columns(rng, 3000, width)
        keys, order = torch.sort(ids, stable=True)
        got = TK.segment_sum_sorted(vals, keys, 90, order=order)
        assert got.shape == (90, width)
        for j in range(width):
            assert_bitwise(got[:, j], TK.segment_sum_sorted(
                vals[:, j].contiguous(), keys, 90, order=order))
        assert_bitwise(segops.ordered_sum(vals, ids, 90), got)


def _reference_operands(spec, part, vals, mask, combiner):
    """The port's chunk-walk operands for ``vals`` (``[A]`` or ``[A, B]``)
    and the reference's call on one column of them."""
    args, kw = E.chunk_walk_operands(spec, part, vals, combiner=combiner,
                                     atom_mask=mask)

    def reference(col):
        j = [jnp.asarray(np_of(a)) if a is not None else None
             for a in args[1:7]]
        return np_of(JK.chunk_walk_reduce(
            jnp.asarray(np_of(col)), *j, interpret=True, **kw))
    return args, kw, reference


class TestChunkWalkPlainBatch:
    @pytest.mark.parametrize("combiner", COMBINERS)
    @pytest.mark.parametrize("schedule", ["chunked", "merge_path"])
    def test_columns_equal_reference(self, schedule, combiner):
        spec = _spec(3, tiles=120)
        part = T.make_partition(spec, schedule, 5)
        rng = np.random.default_rng(5)
        vals = torch.from_numpy(rng.integers(-8, 9, (spec.num_atoms, 3))
                                .astype(np.float32))
        mask = torch.from_numpy(rng.random(spec.num_atoms) < 0.7)
        args, kw, reference = _reference_operands(spec, part, vals, mask,
                                                  combiner)
        got = TK.chunk_walk_reduce(*args, **kw)
        assert got.shape == (part.num_blocks, kw["local_tiles"], 3)
        for j in range(3):
            assert_bitwise(got[:, :, j], reference(args[0][:, j]),
                           f"column {j}")

    @pytest.mark.parametrize("combiner", ["min", "max"])
    @pytest.mark.parametrize("schedule", ["chunked", "merge_path"])
    def test_nan_in_a_bin_gives_nan(self, schedule, combiner):
        spec = _spec(4, tiles=120)
        part = T.make_partition(spec, schedule, 5)
        rng = np.random.default_rng(6)
        vals = rng.integers(-8, 9, spec.num_atoms).astype(np.float32)
        offsets = np_of(spec.tile_offsets)
        # NaN at the first, a middle and the last atom of some bins
        starts = offsets[:-1][np.diff(offsets) >= 3]
        ends = offsets[1:][np.diff(offsets) >= 3]
        vals[starts[::5]] = np.nan
        vals[(starts[1::5] + ends[1::5]) // 2] = np.nan
        vals[ends[2::5] - 1] = np.nan
        mask = torch.from_numpy(rng.random(spec.num_atoms) < 0.8)
        args, kw, reference = _reference_operands(spec, part, t32(vals),
                                                  mask, combiner)
        got = np_of(TK.chunk_walk_reduce(*args, **kw))
        want = reference(args[0])
        assert np.isnan(want).any()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert_bitwise(got[~np.isnan(got)], want[~np.isnan(want)])
        # and through the executors: a NaN tile on both paths
        nan_tiles = np.isnan(np_of(T.tile_reduce(
            spec, lambda a: t32(vals)[a], combiner=combiner,
            atom_mask=mask)))
        assert nan_tiles.any()
        for path in PATHS:
            out = T.execute_tile_reduce(spec, part, lambda a: t32(vals)[a],
                                        path=path, combiner=combiner,
                                        atom_mask=mask)
            np.testing.assert_array_equal(np.isnan(np_of(out)), nan_tiles)


class TestCallers:
    @pytest.fixture(scope="class")
    def rs(self):
        with reference_sparse() as module:
            yield module

    @pytest.mark.parametrize("width", [1, 5])
    @pytest.mark.parametrize("schedule", [None, "merge_path", "chunked"])
    def test_spmm_matches_reference_and_spmv(self, rs, schedule, width):
        from repro_torch.interop import csr_from_arrays
        import repro_torch.sparse as TS
        jA = rs.random_csr(300, 200, 4000, skew=1.2, empty_frac=0.1, seed=9)
        tA = csr_from_arrays(np_of(jA.row_offsets), np_of(jA.col_indices),
                             np_of(jA.values), tuple(jA.shape), device=CPU)
        B = np.random.default_rng(10).standard_normal((200, width)).astype(
            np.float32)
        got = TS.spmm(tA, t32(B), schedule=schedule)
        np.testing.assert_allclose(
            np_of(got), np_of(rs.spmm(jA, jnp.asarray(B), schedule=schedule)),
            rtol=1e-5, atol=1e-5)
        vals, cols = tA.values, tA.col_indices
        spec = tA.workspec()
        part = T.make_partition(
            spec, schedule or T.choose_schedule(tA.shape[0], tA.nnz),
            TS.ops.DEFAULT_BLOCKS)
        for j in range(width):
            b = t32(B[:, j])
            assert_bitwise(got[:, j], T.execute_tile_reduce(
                spec, part, lambda nz: vals[nz] * b[cols[nz]]))

    def test_wavefront_makes_one_advance_per_combine(self, monkeypatch):
        trees = []
        for n in (3, 5, 8):
            w = np.zeros((2 * n - 1, 2 * n - 1), np.float32)
            for child in range(1, 2 * n - 1):
                w[child, (child - 1) // 2] = 1.0
            trees.append(Graph.from_dense(w, device=CPU))
        packed = TW.pack_forest(trees)
        wplan = TW.build_wavefront(packed.dag, schedule="chunked_lpt",
                                   path="native")
        calls = []
        real = TW.advance

        def counted(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)
        monkeypatch.setattr(TW, "advance", counted)
        V = wplan.num_nodes
        rng = np.random.default_rng(11)
        x = rng.integers(-2, 3, (V, 16)).astype(np.float32)
        w = rng.integers(-1, 2, (2, 16, 16)).astype(np.float32)
        ops = rng.integers(0, 2, V).astype(np.int32)
        TW.wavefront_eval(wplan, x, ops, w, activation="relu")
        assert len(calls) == 2 * wplan.num_levels
