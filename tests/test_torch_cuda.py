"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card the ``card`` fixture skips them.  They
import no JAX, so they run where only the port is installed (README,
"PyTorch port"):
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the shared conftest clears
JAX's caches).

Integer-valued sums and min/max are compared bitwise; real-valued sums to
a relative 1e-5 (the plain versions add in atomic order on the card, the
kernels in a fixed order).  The segmented-matmul kernels (K5/K6) are held
to their plain versions bitwise on integer-valued operands and to rtol
1e-4 on real ones (5e-2 for bfloat16), and to each other bitwise.  The
banded sliding-window attention kernel (K7) is held to its plain version
at atol/rtol 2e-5 in float32, and for bfloat16 inputs to the float32 plain
version on the same bf16-rounded inputs at rtol 1e-2, atol 1e-4: the only
true error there is the bf16 rounding of the output (at most 2^-9
relative).
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


def test_segmm_zero_rows_for_bad_experts_and_unpopped_blocks(card):
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
    before = FK.LAUNCHES["flash_swa"]
    got = FK.flash_swa(q, k, v, window=window, qc=qc)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_swa"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = FK.flash_swa_plain(q.float(), k.float(), v.float(),
                              window=window, qc=qc)
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, 1e-4)
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


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
