#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card, and check them.

Run from the repository root with no arguments (``python3 chip_smoke.py``).
Phases, in order; any failure exits non-zero:

1. card    — nvidia-smi's name and power limit, torch's device name;
2. build   — nvcc builds every CUDA source of the port (one process per
   source, all started together) and prints the ``-Xptxas -v`` register /
   shared-memory lines;
3. data    — a scale-free graph at soc-LiveJournal1 scale (2**22 vertices,
   2**26 edges requested, skew 1.3, 30% empty rows: the repo's
   ``scalefree_web`` class), made from ``--seed``; the SpMV uses the same
   CSR with its own values;
4. parity  — each slice-1 kernel (K1-K4) at the main path's shapes against
   its plain PyTorch version: bitwise for min/max and integer-valued sums,
   rtol 1e-4 for real-valued sums;
5. main    — the launch counters are zeroed, then the graph entry points
   run: ``spmv_merge_path`` (merge-path stream and ``chunked_lpt``),
   ``bfs`` with parents, ``sssp``, ``delta_stepping`` and ``pagerank``,
   each on ``chunked_lpt`` and ``merge_path`` with ``path="native"``;
   every kernel's counter must have risen.  Then ``schedule="auto"`` once;
6. moe/forest data — one MoE layer at OLMoE-1B-7B width (d_model 2048,
   64 experts of d_ff 1024, top-8; f32 weights from ``--seed``) on one
   4,096-token sequence, routed plainly (skew 0) and with the router's
   columns biased by ``-0.5 * arange(64)`` (skew 0.5); and a forest of
   11,855 random binary trees (SST's sentence count, 1-56 leaves) at
   feature width 128, integer-valued inputs and weights;
7. segmm parity — K5 and K6 at the MoE's ``w1`` shapes (``bm=128``) and at
   the forest's level-GEMM shapes (``bm=8``, ``K=N=128``) against their
   plain versions: bitwise on integer-valued operands, rtol 1e-4 on real
   ones, and K6 bitwise equal to K5 on real ones;
8. moe     — counters zeroed; ``MoELayer`` (``moe_sorted``) at both
   skews on ``group_mapped``, ``chunked_rr`` and ``chunked_lpt`` x
   native/pure, plus ``"auto"``: outputs bitwise equal, equal to ``moe_capacity`` with a
   capacity that drops nothing (rtol/atol 2e-3), ``aux`` equal, three
   segmm launches per call;
9. wavefront — counters zeroed; ``treelstm_forest`` with a clip activation
   on ``chunked_lpt`` and ``merge_path`` (native), and
   ``build_wavefront(path="pure")`` + ``treelstm_embed``: bitwise equal to
   each other and to a sequential per-node NumPy oracle on 256 trees; then
   one ``tanh`` run;
10. times  — each kernel (CUDA events) beside its bound, its plain version
   and a PyTorch library call where one computes the same thing (K5/K6 at
   both segmm shapes, with their TFLOP/s, share of the f32 peak, ratio to
   ``torch.bmm`` and K6's team and CTA count); end-to-end times of the
   entry points;
11. flash parity — K7 (``flash_swa``) against its plain version at
   H2O-Danube3-4B's attention shapes (B 1, S 8192, 32/8 heads of 120,
   window 4096) in float32 (atol/rtol 2e-5) and bfloat16 (rtol 1e-2, atol
   1e-4 against the float32 plain version on the same bf16-rounded
   inputs), at the edges ``window == S``, ``S == window == qc`` and
   ``Hkv == H``, and against the port's own ``_attend`` over the
   whole 8,192-token sequence (8 GiB of float32 scores, freed after);
12. lm data — H2O-Danube3-4B at full width and depth (24 layers, d_model
   3840, 3,961,839,360 parameters), weights drawn from ``--seed`` on the
   card and cast once to bfloat16;
13. serve — counters zeroed; ``DecoderLM.prefill`` of one 32,768-token
   prompt (the ``prefill_32k`` shape, batch cut from 32 to 1) in bfloat16
   with a 4,096-slot ring cache, then 32 greedy ``decode_step`` +
   ``sample_logits`` steps: K7 launched once per layer in the prefill and
   never in decode, every id in the vocabulary, every logit finite;
14. consistency — the reference's prefill/decode check
   (``tests/test_models.py``) at full width, depth cut to 2, float32: a
   6,144-token prefill (banded) and 1,024 teacher-forced decode steps
   against ``forward`` on all 7,168 tokens, at position 6,143 and every
   128th after it, rtol/atol 2e-3;
15. swa times — K7 at the prefill's launch shape (S 32,768, bfloat16)
   beside its bound, its plain version and cuDNN's
   ``scaled_dot_product_attention`` with the band mask; K7's output there
   held to the float32 plain version (bfloat16 limits above) and to SDPA
   (3e-2);
16. the ``kernels:`` summary, the JSON kernels line, and the final
   ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12             # H100 SXM f32 without tensor cores
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
REF_KERNEL = "src/repro/kernels/spmv_merge/kernel.py"
CSRC = "src/repro_torch/kernels/spmv_merge/csrc"
SEGMM_REF = "src/repro/kernels/segmm/kernel.py"
SEGMM_CSRC = "src/repro_torch/kernels/segmm/csrc"
KERNELS = {   # counter name -> (CUDA source, the Pallas kernel it replaces)
    "spmv_merge_stream": (f"{CSRC}/merge_stream.cu", f"{REF_KERNEL}:63"),
    "chunk_walk_tiles": (f"{CSRC}/chunk_walk.cu", f"{REF_KERNEL}:217"),
    "chunk_walk_atoms": (f"{CSRC}/chunk_walk.cu", f"{REF_KERNEL}:192"),
    "chunk_walk_compact": (f"{CSRC}/chunk_walk.cu", f"{REF_KERNEL}:183"),
    "segmented_matmul": (f"{SEGMM_CSRC}/segmm.cu", f"{SEGMM_REF}:50"),
    "segmented_matmul_chunked": (f"{SEGMM_CSRC}/segmm.cu",
                                 f"{SEGMM_REF}:128"),
    "flash_swa": ("src/repro_torch/kernels/flash_swa/csrc/flash_swa.cu",
                  "src/repro/kernels/flash_swa/kernel.py:79"),
}
REAL_RTOL = 1e-4   # real-valued f32 sums in another order
# soc-LiveJournal1 scale (SNAP: 4.8M vertices, 69M edges)
VERTICES = 2 ** 22
EDGES = 2 ** 26
BLOCKS_PER_SM = 2  # physical blocks (CTAs) per SM: num_blocks of every plan
# Path A: one MoE layer at OLMoE-1B-7B width on one train_4k sequence
MOE_ARCH = "olmoe_1b_7b"
MOE_TOKENS = 4096
MOE_SKEWS = (0.0, 0.5)     # router column bias -skew * arange(E)
MOE_TOL = 2e-3             # sorted vs capacity dispatch (tests/test_models.py)
# Path B: a TreeLSTM forest at Stanford Sentiment Treebank scale
FOREST_TREES = 11_855      # SST sentences
FOREST_MAX_LEAVES = 56
FOREST_MEAN_LEAVES = 19
FOREST_WIDTH = 128         # the level GEMM needs K % min(128, K) == 0
FOREST_ORACLE_TREES = 256
# Path C: H2O-Danube3-4B serving (banded sliding-window attention, K7)
DEVICE = "cuda"
LM_ARCH = "h2o_danube3_4b"
PROMPT = 32_768            # prefill_32k's sequence; batch cut from 32 to 1
DECODE_STEPS = 32
SWA_PARITY_S = 8192
SWA_TOL_F32 = 2e-5         # tests/test_flash_swa.py
# bfloat16 K7 against the float32 plain version on the same bf16-rounded
# inputs: the one true error is the output's bf16 rounding (<= 2^-9 relative)
SWA_RTOL_BF16 = 1e-2
SWA_ATOL_BF16 = 1e-4
SDPA_TOL = 3e-2            # cuDNN SDPA (bf16 probabilities) against K7
CONSIST_LAYERS = 2
CONSIST_PROMPT = 6144      # banded: > attn_query_chunk + sliding_window
CONSIST_DECODE = 1024
CONSIST_EVERY = 128
LM_TOL = 2e-3              # tests/test_models.py prefill/decode parity


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, *, warmup: int = 2, iters: int = 10) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def wall_s(fn):
    """(result, seconds) of ``fn()`` ending in a device synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tensor_bytes(obj, seen=None) -> int:
    """Device bytes held by the tensors of a (nested) dataclass."""
    import torch
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = obj.data_ptr()
        if key in seen:
            return 0
        seen.add(key)
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(tensor_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    return 0


def max_abs_err(got, want) -> float:
    import torch
    finite = torch.isfinite(want)
    check(bool(torch.equal(finite, torch.isfinite(got))),
          "kernel and plain version disagree on which entries are finite")
    if not bool(finite.any()):
        return 0.0
    return float((got[finite] - want[finite]).abs().max())


def compare(name: str, got, want, *, exact: bool) -> float:
    """Hold a kernel result against its plain version; returns the max
    absolute error (0 when bitwise)."""
    import torch
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    if exact:
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        check(bool(same), f"{name}: not bitwise equal to its plain version")
        log(f"parity {name}: bitwise equal")
        return 0.0
    err = max_abs_err(got, want)
    scale = float(want[torch.isfinite(want)].abs().max()) if want.numel() \
        else 0.0
    check(err <= REAL_RTOL * max(scale, 1e-30),
          f"{name}: max abs err {err} above rtol {REAL_RTOL} of {scale}")
    log(f"parity {name}: max abs err {err!r} (scale {scale!r}, "
        f"rtol {REAL_RTOL})")
    return err


def unit_values(values):
    """Integer-valued stand-ins in {-1, 0, 1}: sums of up to 2**24 of them
    are exact in float32, in any order."""
    return values.sign()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    log(card_line)
    props = torch.cuda.get_device_properties(0)
    log(f"torch device: {torch.cuda.get_device_name(0)} "
        f"({props.multi_processor_count} SMs, "
        f"{props.total_memory / 2**30:.1f} GiB); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card_line, props.multi_processor_count


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_swa import kernel as FK
    from repro_torch.kernels.segmm import kernel as SK
    from repro_torch.kernels.spmv_merge import kernel as K
    t0 = time.perf_counter()
    reports = _build.build(K.SOURCES + SK.SOURCES + FK.SOURCES)
    log(f"build: {len(reports)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for stem, report in reports.items():
        entry = None
        for line in report.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log(f"  {stem}: {entry}: {line.strip()}")


def phase_data(seed: int, num_blocks: int):
    import numpy as np
    import torch
    from repro_torch.sparse import CSR, Graph, random_csr

    (A, gen_s) = wall_s(lambda: random_csr(
        VERTICES, VERTICES, EDGES, skew=1.3, empty_frac=0.3, seed=seed,
        device="cuda"))
    # graph weights as benchmarks/fig_graph.py builds them: |v| + 0.05
    g = Graph(CSR(A.row_offsets, A.col_indices, A.values.abs() + 0.05,
                  A.shape, A.nnz))
    x = torch.from_numpy(np.random.default_rng(seed + 1)
                         .standard_normal(VERTICES).astype(np.float32)).cuda()
    degrees = g.out_degrees().cpu().numpy()
    log(f"data: V={g.num_vertices} E={g.num_edges} (requested "
        f"{EDGES}; rows clipped at V columns), "
        f"non-empty rows {int((degrees > 0).sum())}, max out-degree "
        f"{int(degrees.max())}, generated in {gen_s:.1f} s, "
        f"CSR {tensor_bytes(A) / 2**20:.1f} MiB + graph weights "
        f"{g.csr.values.numel() * 4 / 2**20:.1f} MiB on the device")
    log(f"num_blocks={num_blocks} (a multiple of the SM count)")
    # A medium-degree source with a well-connected (but not saturating)
    # out-neighbour: most rows are empty, so a random source often dies
    # out, and a hub source saturates in one step and hides the direction
    # switch.
    deg = g.out_degrees()
    best = torch.zeros(g.num_vertices, dtype=deg.dtype, device=deg.device)
    best.scatter_reduce_(0, g.edge_sources().long(),
                         deg[g.csr.col_indices.long()], "amax")
    ok = (deg >= 8) & (deg <= 64) & (best >= 1000) & (best <= 100_000)
    check(bool(ok.any()), "no medium-degree source found")
    source = int(torch.nonzero(ok)[0])
    log(f"source vertex {source} (out-degree {int(deg[source])}, largest "
        f"out-neighbour degree {int(best[source])})")
    return A, g, x, source


def build_plans(g, num_blocks: int):
    from repro_torch.sparse import build_advance
    plans = {}
    for schedule in ("chunked_lpt", "merge_path"):
        plain, s1 = wall_s(lambda: build_advance(
            g, schedule=schedule, num_blocks=num_blocks, path="native"))
        delta, s2 = wall_s(lambda: build_advance(
            g, schedule=schedule, num_blocks=num_blocks, path="native",
            workload="advance_delta", delta="auto", compact=True))
        plans[schedule] = (plain, delta)
        log(f"plan {schedule}: built in {s1:.2f} s (+{s2:.2f} s with the "
            f"delta split), {tensor_bytes(plain) / 2**20:.1f} MiB on the "
            f"device; pull {plain.schedule.value}@{plain.path.value} "
            f"(window {plain.part.atom_span}, tiles {plain.part.tile_span}),"
            f" push {plain.push_schedule.value}@{plain.push_path.value}, "
            f"direction threshold {plain.direction_threshold}, delta "
            f"{delta.delta}, compact capacity {delta.compact_capacity}")
    return plans


def phase_parity_and_times(A, x, g, plans, num_blocks: int, seed: int):
    """K1-K4 at the main path's shapes: parity, then timings."""
    import torch
    from repro_torch.core import execute as E
    from repro_torch.kernels.spmv_merge import kernel as K
    from repro_torch.kernels.spmv_merge import ops as O
    from repro_torch.sparse import CSR

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}

    # -- K1: the merge-path stream of spmv_merge_path(A, x, num_blocks) ----
    block_items = O.merge_block_items(A, num_blocks)

    def stream_of(values, xv):
        return O.merge_stream_operands(
            CSR(A.row_offsets, A.col_indices, values, A.shape, A.nnz), xv,
            block_items=block_items)

    kw1 = dict(block_items=block_items)
    s_unit = stream_of(unit_values(A.values), unit_values(x))
    compare("spmv_merge_stream (integer-valued)",
            K.merge_block_partials(*s_unit, **kw1),
            K.merge_block_partials_ref(*s_unit, **kw1), exact=True)
    del s_unit
    s_real = stream_of(A.values, x)
    partials = K.merge_block_partials(*s_real, **kw1)
    err1 = compare("spmv_merge_stream (real)", partials,
                   K.merge_block_partials_ref(*s_real, **kw1), exact=False)
    total = int(s_real[0].shape[0])
    grid, r_loc = (int(n) for n in partials.shape)
    del partials
    bytes1 = total * 8 + grid * 4 + grid * r_loc * 4
    a_csr = torch.sparse_csr_tensor(A.row_offsets, A.col_indices, A.values,
                                    A.shape)
    rows["spmv_merge_stream"] = dict(
        err=err1, bytes=bytes1,
        ms=cuda_ms(lambda: K.merge_block_partials(*s_real, **kw1)),
        plain_ms=cuda_ms(lambda: K.merge_block_partials_ref(*s_real, **kw1),
                         iters=3),
        library_ms=cuda_ms(lambda: a_csr @ x))
    log(f"K1 shapes: stream {total} items, grid {grid} x block_items "
        f"{block_items}, partials [{grid}, {r_loc}]")
    del s_real, a_csr

    # -- K2: pull advances (PageRank's unmasked sum, SSSP's masked min) ----
    errs2 = []
    for schedule, (plan, _) in plans.items():
        spec, part = plan.spec, plan.part
        frontier = torch.rand(g.num_vertices, generator=gen,
                              device="cuda") < 0.3
        mask = frontier[plan.src]
        dist = torch.rand(g.num_vertices, generator=gen, device="cuda")
        cand = dist[plan.src] + plan.weight
        cases = [("sum", plan.weight, None, False),
                 ("sum", unit_values(plan.weight - 0.5), None, True),
                 ("min", cand, mask, True), ("max", cand, mask, True)]
        for combiner, values, m, exact in cases:
            args, kw = E.chunk_walk_operands(spec, part, values,
                                             combiner=combiner, atom_mask=m)
            got = K.chunk_walk_reduce(*args, **kw)
            want = K.chunk_walk_reduce_ref(*args, **kw)
            tag = f"chunk_walk_tiles {schedule}/{combiner}"
            tag += "/masked" if m is not None else ""
            tag += "/integer-valued" if exact and combiner == "sum" else ""
            err = compare(tag, got, want, exact=exact)
            errs2.append(err)
            del got, want
        if schedule == "chunked_lpt":
            args, kw = E.chunk_walk_operands(spec, part, plan.weight)
            tids = spec.atom_tile_ids()
            num_chunks = part.num_blocks
            rows["chunk_walk_tiles"] = dict(
                bytes=spec.num_atoms * 8 + num_chunks * kw["local_tiles"] * 4,
                ms=cuda_ms(lambda: K.chunk_walk_reduce(*args, **kw)),
                plain_ms=cuda_ms(lambda: K.chunk_walk_reduce_ref(*args, **kw),
                                 iters=3),
                library_ms=cuda_ms(lambda: torch.zeros(
                    spec.num_tiles, device="cuda").index_add_(
                        0, tids, plan.weight)))
            args_m, kw_m = E.chunk_walk_operands(spec, part, cand,
                                                 combiner="min",
                                                 atom_mask=mask)
            masked_ms = cuda_ms(lambda: K.chunk_walk_reduce(*args_m, **kw_m))
            log(f"K2 shapes ({schedule}): {spec.num_atoms} atoms, "
                f"{num_chunks} chunks on {part.num_physical_blocks} blocks, "
                f"window {kw['window']}, local tiles {kw['local_tiles']}; "
                f"masked min {masked_ms:.3f} ms")
            del args, args_m, tids
    rows["chunk_walk_tiles"]["err"] = max(errs2)

    # -- K3: push value windows (BFS/SSSP push) -----------------------------
    plan = plans["chunked_lpt"][0]
    spec, part = plan.push_spec, plan.push_part
    frontier = torch.rand(g.num_vertices, generator=gen, device="cuda") < 0.05
    mask = frontier[plan.push_src]
    dist = torch.rand(g.num_vertices, generator=gen, device="cuda")
    cand = dist[plan.push_src] + plan.push_weight
    args3, kw3 = E.chunk_walk_operands(spec, part, cand, combiner="min",
                                       emit="atoms", atom_mask=mask)
    window = kw3["window"]
    compare("chunk_walk_atoms chunked_lpt/min/masked",
            K.chunk_walk_reduce(*args3, **kw3),
            K.chunk_walk_reduce_ref(*args3, **kw3), exact=True)
    active = int(mask.sum())
    rows["chunk_walk_atoms"] = dict(
        err=0.0, bytes=spec.num_atoms * 4 + active * 4
        + part.num_blocks * window * 4,
        ms=cuda_ms(lambda: K.chunk_walk_reduce(*args3, **kw3)),
        plain_ms=cuda_ms(lambda: K.chunk_walk_reduce_ref(*args3, **kw3),
                         iters=3),
        library_ms=None)
    log(f"K3 shapes: {spec.num_atoms} atoms ({active} active), windows "
        f"[{part.num_blocks}, {window}]")
    del args3

    # -- K4: compacted push windows (delta-stepping's push) -----------------
    dplan = plans["chunked_lpt"][1]
    spec, part = dplan.push_spec, dplan.push_part
    capacity = dplan.compact_capacity
    keep = min(0.5 * capacity / max(spec.num_atoms, 1), 1.0)
    mask = torch.rand(spec.num_atoms, generator=gen, device="cuda") < keep
    idx, count = E.compact_active_atoms(mask, capacity)
    check(int(count) <= capacity, "K4 parity mask overflows the capacity")
    num_chunks = part.num_blocks
    args4, kw4 = E.chunk_walk_operands(spec, part, cand, combiner="min",
                                       emit="compact", idx=idx)
    window = kw4["window"]
    compare("chunk_walk_compact chunked_lpt/min",
            K.chunk_walk_reduce(*args4, **kw4),
            K.chunk_walk_reduce_ref(*args4, **kw4), exact=True)
    rows["chunk_walk_compact"] = dict(
        err=0.0, bytes=capacity * 4 + int(count) * 4
        + num_chunks * window * 4,
        ms=cuda_ms(lambda: K.chunk_walk_reduce(*args4, **kw4)),
        plain_ms=cuda_ms(lambda: K.chunk_walk_reduce_ref(*args4, **kw4),
                         iters=3),
        library_ms=cuda_ms(lambda: torch.index_select(args4[0], 0, idx)))
    log(f"K4 shapes: capacity {capacity} ({int(count)} active), windows "
        f"[{num_chunks}, {window}]")
    return rows


def phase_main(A, x, g, plans, num_blocks: int, source: int):
    """The entry points, counted; returns end-to-end seconds per call."""
    import torch
    from repro_torch.kernels.spmv_merge import kernel as K
    from repro_torch.kernels.spmv_merge import ops as O
    from repro_torch.sparse import (bfs, delta_stepping, pagerank,
                                    spmv_reference, sssp)

    e2e = {}
    want = spmv_reference(A, x)
    K.reset_launch_counts()
    for schedule in (None, "chunked_lpt"):
        y, secs = wall_s(lambda: O.spmv_merge_path(A, x, schedule=schedule,
                                                   num_blocks=num_blocks))
        err = max_abs_err(y, want)
        scale = float(want.abs().max())
        check(y.shape == want.shape and err <= REAL_RTOL * scale,
              f"spmv_merge_path(schedule={schedule}): err {err}")
        e2e[f"spmv_merge_path[{schedule or 'merge_stream'}]"] = secs
        log(f"main spmv_merge_path(schedule={schedule}): {secs:.3f} s, "
            f"max abs err vs spmv_reference {err!r} (scale {scale!r})")
    for schedule, (plan, dplan) in plans.items():
        (depth, parent, counts), secs = wall_s(lambda: bfs(
            g, source, plan=plan, return_parents=True,
            return_direction_counts=True))
        reached = depth >= 0
        others = reached.clone()
        others[source] = False
        check(int(depth[source]) == 0 and int(parent[source]) == -1,
              "bfs: source labels")
        check(bool((depth[parent[others].long()] == depth[others] - 1)
                   .all()), "bfs: a parent is not one level up")
        check(bool((parent[~reached] == -1).all()), "bfs: stray parents")
        push, pull = counts.tolist()
        log(f"main bfs[{schedule}]: {secs:.3f} s, reached "
            f"{int(reached.sum())} vertices in {push + pull} levels "
            f"({push} push, {pull} pull)")
        check(push > 0 and pull > 0, "bfs did not run both directions")
        e2e[f"bfs[{schedule}]"] = secs
        (dist, scounts), secs = wall_s(lambda: sssp(
            g, source, plan=plan, return_direction_counts=True))
        e2e[f"sssp[{schedule}]"] = secs
        log(f"main sssp[{schedule}]: {secs:.3f} s, "
            f"{sum(scounts.tolist())} iterations {scounts.tolist()}, "
            f"{int(torch.isfinite(dist).sum())} reached")
        (ddist, dcounts), secs = wall_s(lambda: delta_stepping(
            g, source, plan=dplan, return_direction_counts=True))
        e2e[f"delta_stepping[{schedule}]"] = secs
        check(torch.equal(ddist.view(torch.int32), dist.view(torch.int32)),
              f"delta_stepping != sssp bitwise ({schedule})")
        check(bool((torch.isfinite(dist) == reached).all()),
              "sssp and bfs reach different vertex sets")
        log(f"main delta_stepping[{schedule}]: {secs:.3f} s, "
            f"{sum(dcounts.tolist())} advances {dcounts.tolist()}, bitwise "
            f"equal to sssp")
        pr, secs = wall_s(lambda: pagerank(g, plan=plan))
        e2e[f"pagerank[{schedule}]"] = secs
        mass = float(pr.double().sum())
        check(bool(torch.isfinite(pr).all()) and abs(mass - 1.0) < 1e-3,
              f"pagerank mass {mass}")
        log(f"main pagerank[{schedule}]: {secs:.3f} s, mass {mass!r}")
    launches = dict(K.LAUNCHES)
    log("main-path launches: " + json.dumps(launches))
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched on the main path")
    return launches, e2e


def phase_auto(g, num_blocks: int, source: int):
    from repro_torch.sparse import bfs, build_advance
    plan, secs = wall_s(lambda: build_advance(g, schedule="auto",
                                              num_blocks=num_blocks,
                                              path="native"))
    log(f"auto plan ({secs:.2f} s): pull {plan.schedule.value}@"
        f"{plan.path.value}, push {plan.push_schedule.value}@"
        f"{plan.push_path.value}, threshold {plan.direction_threshold}")
    (depth, counts), secs = wall_s(lambda: bfs(
        g, source, plan=plan, return_direction_counts=True))
    log(f"auto bfs: {secs:.3f} s, reached {int((depth >= 0).sum())}, "
        f"directions {counts.tolist()}")


# ---------------------------------------------------------------------------
# slice 2: the MoE layer (path A) and the TreeLSTM forest (path B)
# ---------------------------------------------------------------------------

def reset_all_counts() -> None:
    from repro_torch.kernels.flash_swa import kernel as FK
    from repro_torch.kernels.segmm import kernel as SK
    from repro_torch.kernels.spmv_merge import kernel as K
    K.reset_launch_counts()
    SK.reset_launch_counts()
    FK.reset_launch_counts()


def all_counts() -> dict:
    from repro_torch.kernels.flash_swa import kernel as FK
    from repro_torch.kernels.segmm import kernel as SK
    from repro_torch.kernels.spmv_merge import kernel as K
    return {**K.LAUNCHES, **SK.LAUNCHES, **FK.LAUNCHES}


def segmm_launches() -> int:
    from repro_torch.kernels.segmm import kernel as SK
    return sum(SK.LAUNCHES.values())


def phase_moe_data(seed: int):
    """One MoE layer per skew (shared weights, biased router) and the
    4,096-token input, all drawn on the card from ``seed``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoELayer, _router

    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base, secs = wall_s(lambda: MoELayer.from_config(cfg, gen,
                                                     device="cuda"))
    x = torch.randn((1, MOE_TOKENS, cfg.d_model), generator=gen,
                    device="cuda") * 0.5
    expert_bytes = sum(base.params()[n].numel() * 4
                       for n in ("w1", "w3", "w2"))
    log(f"moe data: {cfg.name} d_model={cfg.d_model} d_ff={cfg.d_ff} "
        f"experts={cfg.num_experts} top_k={cfg.top_k}; expert weights "
        f"{expert_bytes / 2**30:.2f} GiB f32, drawn in {secs:.2f} s; "
        f"x {tuple(x.shape)}")
    layers = {}
    for skew in MOE_SKEWS:
        bias = -skew * torch.arange(cfg.num_experts, device="cuda",
                                    dtype=torch.float32)
        params = dict(base.params())
        params["router"] = params["router"] + bias[None, :]
        layers[skew] = MoELayer(params, num_experts=cfg.num_experts,
                                top_k=cfg.top_k, dispatch="sorted")
        idx, _, _ = _router(params, x.reshape(-1, cfg.d_model),
                            cfg.num_experts, cfg.top_k)
        sizes = torch.bincount(idx.reshape(-1).long(),
                               minlength=cfg.num_experts)
        top = torch.topk(sizes, 8).indices.sort().values.tolist()
        log(f"moe routing skew {skew}: {int((sizes > 0).sum())} experts "
            f"hold tokens, atoms per expert min {int(sizes.min())} / max "
            f"{int(sizes.max())}, busiest experts {top}")
    return dict(cfg=cfg, x=x, layers=layers)


def random_binary_tree(leaves: int, rng):
    """Parent of each node of a random binary tree with ``leaves`` leaves
    (uniform split points); node 0 is the root, children follow parents."""
    import numpy as np
    parent = [-1]
    stack = [(0, leaves)]
    while stack:
        node, n = stack.pop()
        if n == 1:
            continue
        left = int(rng.integers(1, n))
        for part in (left, n - left):
            parent.append(node)
            stack.append((len(parent) - 1, part))
    return np.asarray(parent, np.int64)


def phase_forest_data(seed: int):
    """The SST-scale forest (11,855 trees, child -> parent edges) as port
    graphs on the card, node ops (leaf 0, internal 1), and integer-valued
    inputs and TreeLSTM weights."""
    import numpy as np
    import torch
    from repro_torch.sparse import CSR, Graph

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 2)
    # right-skewed sentence lengths (gamma, shape 4) clipped to [1, 56]
    leaves = np.clip(np.rint(rng.gamma(4.0, FOREST_MEAN_LEAVES / 4.0,
                                       FOREST_TREES)),
                     1, FOREST_MAX_LEAVES).astype(np.int64)
    parents = [random_binary_tree(int(n), rng) for n in leaves]
    trees, ops = [], []
    for par in parents:
        n = par.shape[0]
        has_parent = par >= 0
        offsets = np.concatenate([[0], np.cumsum(has_parent)])
        trees.append(Graph(CSR.from_numpy(
            offsets, par[has_parent], np.ones(int(has_parent.sum())),
            (n, n), device="cuda")))
        children = np.bincount(par[has_parent], minlength=n)
        ops.append((children > 0).astype(np.int32))
    ops = np.concatenate(ops)
    V = int(ops.shape[0])
    K = FOREST_WIDTH
    x = rng.integers(-2, 3, (V, K)).astype(np.float32)
    w = rng.integers(-1, 2, (2, K, K)).astype(np.float32)
    b = rng.integers(-2, 3, (2, K)).astype(np.float32)
    log(f"forest data: {FOREST_TREES} trees, leaves {int(leaves.min())}-"
        f"{int(leaves.max())} (mean {leaves.mean():.2f}), {V} nodes, "
        f"{V - FOREST_TREES} edges, width {K}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(parents=parents, trees=trees, ops=ops, x=x, w=w, b=b, V=V)


def clip16(z):
    """The exact bounded activation of the integer-valued forest runs."""
    import torch
    return torch.clamp(z, -16.0, 16.0)


def forest_oracle(forest, node_offsets, h, roots) -> None:
    """Sequential per-node NumPy evaluation of the first
    FOREST_ORACLE_TREES trees; every node state and root must equal
    ``h``/``roots`` bitwise."""
    import numpy as np
    x, w, b, ops = forest["x"], forest["w"], forest["b"], forest["ops"]
    h = h.cpu().numpy()
    roots = roots.cpu().numpy()
    for t in range(FOREST_ORACLE_TREES):
        par = forest["parents"][t]
        off = int(node_offsets[t])
        n = par.shape[0]
        comb = x[off:off + n].copy()
        want = np.zeros_like(comb)
        for v in range(n - 1, -1, -1):       # children before parents
            op = ops[off + v]
            want[v] = np.clip(comb[v] @ w[op] + b[op], np.float32(-16.0),
                              np.float32(16.0))
            if par[v] >= 0:
                comb[par[v]] += want[v]
        check(np.array_equal(want.view(np.uint32),
                             h[off:off + n].view(np.uint32)),
              f"wavefront: tree {t} differs from the sequential oracle")
        check(np.array_equal(want[0].view(np.uint32),
                             roots[t].view(np.uint32)),
              f"wavefront: root of tree {t} differs from the oracle")
    log(f"wavefront: {FOREST_ORACLE_TREES} trees bitwise equal to the "
        f"sequential per-node oracle")


def segmm_cases(moe, forest, seed: int):
    """(name, tokens, expert ids, rhs, experts, bm) for the parity and
    timing of K5/K6: the MoE layer's w1 GEMM (skew 0 routing) and the
    forest's level GEMM (integer forest inputs; real ones made here)."""
    import torch
    from repro_torch.models.moe import _router
    from repro_torch.models.treelstm import init_treelstm

    cfg = moe["cfg"]
    params = moe["layers"][0.0].params()
    x2d = moe["x"].reshape(-1, cfg.d_model)
    idx, _, _ = _router(params, x2d, cfg.num_experts, cfg.top_k)
    atom_token = torch.arange(x2d.shape[0], device="cuda").repeat_interleave(
        cfg.top_k)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    tree_w = init_treelstm(gen, FOREST_WIDTH, device="cuda")["w"]
    tree_x = torch.randn((forest["V"], FOREST_WIDTH), generator=gen,
                         device="cuda")
    return [("moe w1", x2d[atom_token], idx.reshape(-1), params["w1"],
             cfg.num_experts, 128),
            ("forest level", tree_x, torch.from_numpy(forest["ops"]).cuda(),
             tree_w, 2, 8)]


def phase_segmm_parity(cases):
    """K5 and K6 against their plain versions at both paths' shapes;
    returns the largest real-valued error and each case's operands."""
    from repro_torch.kernels.segmm import kernel as SK
    from repro_torch.kernels.segmm import ops as SO

    errs, prepared = [], {}
    for name, tokens, experts, rhs, num_experts, bm in cases:
        def operands(t):
            return (SO.segmm_operands(t, experts, num_experts=num_experts,
                                      bm=bm, schedule="group_mapped",
                                      path="pure"),
                    SO.segmm_operands(t, experts, num_experts=num_experts,
                                      bm=bm, schedule="chunked_lpt",
                                      path="native"))
        for label, t, r, exact in (("integer-valued", unit_values(tokens),
                                    unit_values(rhs), True),
                                   ("real", tokens, rhs, False)):
            o5, o6 = operands(t)
            k5 = SK.segmented_matmul(o5.lhs, r, o5.block_expert, bm=bm)
            errs.append(compare(
                f"segmented_matmul {name} ({label})", k5,
                SK.segmented_matmul_plain(o5.lhs, r, o5.block_expert,
                                          bm=bm), exact=exact))
            chunks, counts, cmax = o6.queue
            k6 = SK.segmented_matmul_chunked(o6.lhs, r, o6.block_expert,
                                             chunks, counts, bm=bm,
                                             max_chunks=cmax)
            errs.append(compare(
                f"segmented_matmul_chunked {name} ({label})", k6,
                SK.segmented_matmul_chunked_plain(
                    o6.lhs, r, o6.block_expert, chunks, counts, bm=bm,
                    max_chunks=cmax), exact=exact))
            if not exact:
                compare(f"segmented_matmul_chunked == segmented_matmul "
                        f"{name} (real)", k6, k5, exact=True)
                prepared[name] = (o5, o6, r)
            del k5, k6
        o5, o6, _ = prepared[name]
        log(f"segmm {name}: tokens {tuple(tokens.shape)}, M_pad "
            f"{o5.lhs.shape[0]} ({o5.num_blocks} M-blocks of {bm}), rhs "
            f"{tuple(rhs.shape)}, K6 queues {o6.queue[1].numel()} x "
            f"{o6.queue[2]} blocks")
    return max(errs), prepared


def phase_moe(moe, e2e):
    """Path A: ``MoELayer`` (dispatch="sorted") on every policy x path and
    "auto", both skews; the launch counts of the run."""
    import torch
    from repro_torch.kernels.segmm import ops as SO
    from repro_torch.models.moe import moe_capacity

    cfg, x = moe["cfg"], moe["x"]
    runs = [(s, p) for s in SO.SCHEDULE_POLICIES for p in ("native", "pure")]
    runs.append(("auto", "auto"))
    reset_all_counts()
    for skew, layer in moe["layers"].items():
        outs = []
        for schedule, path in runs:
            layer.schedule, layer.execution_path = schedule, path
            before = segmm_launches()
            (out, aux), secs = wall_s(lambda: layer(x))
            check(segmm_launches() == before + 3,
                  f"moe {schedule}/{path}: expected 3 segmm launches")
            check(out.shape == x.shape and bool(torch.isfinite(out).all()),
                  f"moe {schedule}/{path}: bad output")
            e2e[f"moe_sorted[skew {skew}, {schedule}@{path}]"] = secs
            outs.append((f"{schedule}@{path}", out, aux))
        first_name, first, first_aux = outs[0]
        for tag, out, aux in outs[1:]:
            check(torch.equal(out.view(torch.int32),
                              first.view(torch.int32)),
                  f"moe skew {skew}: {tag} != {first_name} bitwise")
            check(float(aux) == float(first_aux),
                  f"moe skew {skew}: aux of {tag} differs")
        cap, cap_aux = moe_capacity(
            layer.params(), x, num_experts=cfg.num_experts, top_k=cfg.top_k,
            capacity_factor=float(cfg.num_experts / cfg.top_k))
        err = float((cap - first).abs().max())
        ok = bool(((cap - first).abs()
                   <= MOE_TOL + MOE_TOL * first.abs()).all())
        check(ok, f"moe skew {skew}: sorted vs capacity err {err}")
        check(float(cap_aux) == float(first_aux),
              f"moe skew {skew}: capacity aux differs")
        del cap
        auto = SO.resolve_schedule(layer_atoms(layer, x, cfg),
                                   cfg.num_experts)
        log(f"moe skew {skew}: {len(outs)} runs bitwise equal, aux "
            f"{float(first_aux)!r}, max |sorted - capacity| {err!r} "
            f"(atol/rtol {MOE_TOL}); auto picked {auto}")
    counts = all_counts()
    log("moe launches: " + json.dumps(counts))
    for name in ("segmented_matmul", "segmented_matmul_chunked"):
        check(counts[name] > 0, f"{name} was never launched by the MoE path")
    return counts


def layer_atoms(layer, x, cfg):
    """The routed expert id of every atom of ``layer`` on ``x``."""
    from repro_torch.models.moe import _router
    idx, _, _ = _router(layer.params(), x.reshape(-1, cfg.d_model),
                        cfg.num_experts, cfg.top_k)
    return idx.reshape(-1)


def phase_wavefront(forest, seed: int, e2e):
    """Path B: ``treelstm_forest`` on chunked_lpt and merge_path (native),
    the pure path through ``build_wavefront`` + ``treelstm_embed``, the
    oracle, then one tanh run; the launch counts of the run."""
    import numpy as np
    import torch
    from repro_torch.interop import treelstm_params_from_arrays
    from repro_torch.models.treelstm import (init_treelstm, tree_roots,
                                             treelstm_embed, treelstm_forest)
    from repro_torch.sparse.wavefront import build_wavefront

    params = treelstm_params_from_arrays({"w": forest["w"], "b": forest["b"]},
                                         device="cuda")
    x = torch.from_numpy(forest["x"]).cuda()
    ops = torch.from_numpy(forest["ops"]).cuda()
    reset_all_counts()
    roots = {}
    for schedule in ("chunked_lpt", "merge_path"):
        before = all_counts()
        (r, packed), secs = wall_s(lambda: treelstm_forest(
            params, forest["trees"], x, ops, schedule=schedule,
            activation=clip16))
        roots[f"{schedule}@native"] = r
        e2e[f"treelstm_forest[{schedule}]"] = secs
        after = all_counts()
        rose = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        log(f"wavefront treelstm_forest[{schedule}]: {secs:.3f} s, "
            f"launches {json.dumps(rose)}")
    wplan, build_s = wall_s(lambda: build_wavefront(
        packed.dag, schedule="chunked_lpt", path="pure"))
    h, eval_s = wall_s(lambda: treelstm_embed(params, wplan, x, ops,
                                              activation=clip16))
    e2e["build_wavefront[chunked_lpt@pure]"] = build_s
    e2e["treelstm_embed[chunked_lpt@pure]"] = eval_s
    root_ids = torch.from_numpy(tree_roots(wplan)).cuda()
    roots["chunked_lpt@pure"] = h[root_ids]
    counts = np.asarray(wplan.level_counts)
    log(f"wavefront plan: {wplan.num_nodes} nodes, "
        f"{wplan.num_dependencies} dependencies, {wplan.num_levels} "
        f"levels (nodes per level {counts.tolist()}); pure build "
        f"{build_s:.3f} s, eval {eval_s:.3f} s")
    first = roots["chunked_lpt@native"]
    check(first.shape == (FOREST_TREES, FOREST_WIDTH), "wavefront: shape")
    for tag, r in roots.items():
        check(torch.equal(r.view(torch.int32), first.view(torch.int32)),
              f"wavefront: {tag} roots != chunked_lpt@native bitwise")
    log(f"wavefront: roots bitwise equal across {sorted(roots)}")
    forest_oracle(forest, packed.node_offsets, h, first)

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    tparams = init_treelstm(gen, FOREST_WIDTH, device="cuda")
    tx = torch.randn((forest["V"], FOREST_WIDTH), generator=gen,
                     device="cuda")
    (troots, _), secs = wall_s(lambda: treelstm_forest(
        tparams, forest["trees"], tx, ops))
    e2e["treelstm_forest[auto, tanh]"] = secs
    check(troots.shape == (FOREST_TREES, FOREST_WIDTH)
          and bool(torch.isfinite(troots).all())
          and float(troots.abs().max()) <= 1.0, "wavefront: tanh roots")
    log(f"wavefront tanh: {secs:.3f} s, roots finite in [-1, 1], mean "
        f"|h| {float(troots.abs().mean())!r}")
    counts = all_counts()
    log("wavefront launches: " + json.dumps(counts))
    for name in ("segmented_matmul", "segmented_matmul_chunked",
                 "chunk_walk_tiles"):
        check(counts[name] > 0,
              f"{name} was never launched by the wavefront path")
    return counts


def phase_segmm_times(cases, prepared):
    """K5/K6 times at both cases' shapes (CUDA events) beside the bound,
    the plain version and ``torch.bmm`` (TF32 off) on the gathered expert
    weights, with the achieved TFLOP/s (on the routed rows), its share of
    the 67 TFLOP/s float32 peak, the ratio to ``torch.bmm`` and K6's team
    and CTA count; the MoE w1 case fills the kernels line."""
    import torch
    from repro_torch.kernels.segmm import kernel as SK

    rows = {}
    for name, tokens, experts, _, _, bm in cases:
        o5, o6, rhs = prepared[name]
        atoms, k_dim = tokens.shape
        n_dim = rhs.shape[2]
        busy = int(torch.unique(experts).numel())
        flops = 2 * atoms * k_dim * n_dim
        nbytes = (atoms * k_dim * tokens.element_size()
                  + busy * k_dim * n_dim * rhs.element_size()
                  + atoms * n_dim * 4)
        bound_flops = flops / F32_FLOP_PER_S * 1e3
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(bound_flops, bound_bytes)
        bound_by = "operations" if bound_flops >= bound_bytes else "bytes"
        nblk = o5.num_blocks
        lhs_b = o5.lhs.view(nblk, bm, k_dim)
        rhs_g = rhs[o5.block_expert.long()]
        library = cuda_ms(lambda: torch.bmm(lhs_b, rhs_g), iters=3)
        del rhs_g
        chunks, counts, cmax = o6.queue
        team, ctas = SK.queues_grid(int(counts.numel()), cmax, bm,
                                    rhs.shape[2])
        calls = {
            "segmented_matmul": (
                lambda: SK.segmented_matmul(o5.lhs, rhs, o5.block_expert,
                                            bm=bm),
                lambda: SK.segmented_matmul_plain(o5.lhs, rhs,
                                                  o5.block_expert, bm=bm)),
            "segmented_matmul_chunked": (
                lambda: SK.segmented_matmul_chunked(
                    o6.lhs, rhs, o6.block_expert, chunks, counts, bm=bm,
                    max_chunks=cmax),
                lambda: SK.segmented_matmul_chunked_plain(
                    o6.lhs, rhs, o6.block_expert, chunks, counts, bm=bm,
                    max_chunks=cmax))}
        for kname, (kernel, plain) in calls.items():
            row = dict(ms=cuda_ms(kernel, iters=5),
                       plain_ms=cuda_ms(plain, iters=3), library_ms=library,
                       bound_ms=bound, bound_by=bound_by, flops=flops,
                       bytes=nbytes)
            tflops = flops / row["ms"] / 1e9
            geometry = (f"; K6 team {team}, {ctas} CTAs"
                        if kname == "segmented_matmul_chunked" else "")
            log(f"time {kname} [{name}]: {row['ms']:.4f} ms, "
                f"{tflops:.2f} TFLOP/s ({100 * tflops / 67:.1f}% of the "
                f"67 TFLOP/s f32 peak), {row['ms'] / library:.3f}x "
                f"torch.bmm (bound {bound:.4f} ms by {bound_by}: {flops} "
                f"flop at 67 TFLOP/s = {bound_flops:.4f} ms, {nbytes} bytes "
                f"at 3.35 TB/s = {bound_bytes:.4f} ms; plain "
                f"{row['plain_ms']:.3f} ms; torch.bmm {library:.3f} ms; "
                f"{busy} experts hold tokens{geometry})")
            if name == "moe w1":
                rows[kname] = row
    return rows


# ---------------------------------------------------------------------------
# slice 3: H2O-Danube3-4B serving on the banded attention kernel (path C)
# ---------------------------------------------------------------------------

def swa_launches() -> int:
    from repro_torch.kernels.flash_swa import kernel as FK
    return FK.LAUNCHES["flash_swa"]


def check_close(name: str, got, want, tol: float, atol: float = None
                ) -> float:
    """``|got - want| <= atol + tol * |want|`` everywhere (finite, same
    shape; ``atol`` defaults to ``tol``); returns the max absolute error."""
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    atol = tol if atol is None else atol
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    limit = f"atol/rtol {tol}" if atol == tol else f"rtol {tol}, atol {atol}"
    check(bool((diff <= atol + tol * want.abs()).all()),
          f"{name}: max abs err {err} above {limit}")
    log(f"parity {name}: max abs err {err!r} ({limit})")
    return err


def band_pairs(s: int, window: int) -> int:
    """(query, key) pairs inside a causal band: sum_i min(i + 1, window)."""
    n = min(s, window)
    return n * (n + 1) // 2 + (s - n) * window


def phase_swa_parity(cfg, seed: int) -> float:
    """K7 against its plain version at ``cfg``'s attention shapes, the
    edges, and the model's ``_attend`` core; returns the largest error."""
    import torch
    from repro_torch.kernels.flash_swa import kernel as FK
    from repro_torch.models.layers import _attend, _repeat_kv

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    window, qc = cfg.sliding_window, cfg.attn_query_chunk

    def draw(s, heads):
        return torch.randn((1, s, heads, hd), generator=gen, device=DEVICE)

    errs = []
    cases = [(f"S {SWA_PARITY_S}", SWA_PARITY_S, h, hkv, window),
             ("window == S", 2 * qc, h, hkv, 2 * qc),
             ("S == window == qc", qc, h, hkv, qc),
             ("Hkv == H", 2 * qc, hkv, hkv, qc)]
    for name, s, nh, nkv, w in cases:
        tag = f"flash_swa [{name}, {nh}/{nkv} heads of {hd}, window {w}]"
        q, k, v = draw(s, nh), draw(s, nkv), draw(s, nkv)
        got = FK.flash_swa(q, k, v, window=w, qc=qc)
        errs.append(check_close(f"{tag} f32", got, FK.flash_swa_plain(
            q, k, v, window=w, qc=qc), SWA_TOL_F32))
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        want = FK.flash_swa_plain(qb.float(), kb.float(), vb.float(),
                                  window=w, qc=qc)
        errs.append(check_close(f"{tag} bf16", FK.flash_swa(
            qb, kb, vb, window=w, qc=qc), want, SWA_RTOL_BF16,
            SWA_ATOL_BF16))
        if s == SWA_PARITY_S:
            # the model's masked-softmax core over the whole sequence:
            # [1, H, S, S] float32 scores, freed right after
            pos = torch.arange(s, dtype=torch.int32, device=DEVICE)[None]
            groups = nh // nkv
            core = _attend(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                           pos, pos, hd ** -0.5, w)
            errs.append(check_close(f"flash_swa == _attend [S {s}] f32", got,
                                    core, SWA_TOL_F32))
            del core
        del q, k, v, qb, kb, vb, got, want
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return max(errs)


def phase_lm_data(cfg, seed: int):
    """The whole model at ``cfg``'s widths and depth, weights drawn from
    ``seed`` on the card and cast once to bfloat16."""
    import torch
    from repro_torch.models.lm import DecoderLM, param_count

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 6)
    model, secs = wall_s(lambda: DecoderLM.from_config(
        cfg, gen, device=DEVICE, dtype=torch.bfloat16))
    n = sum(p.numel() for p in model.parameters())
    check(n == param_count(cfg), f"lm: {n} parameters, expected "
          f"{param_count(cfg)}")
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"lm data: {cfg.name} {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"window {cfg.sliding_window}, query chunk {cfg.attn_query_chunk}: "
        f"{n} parameters, {nbytes / 2**30:.2f} GiB bf16, drawn and cast in "
        f"{secs:.1f} s")
    return model


def phase_serve(model, seed: int, e2e) -> dict:
    """Path C: prefill one ``PROMPT``-token prompt, then ``DECODE_STEPS``
    greedy steps, counted; returns the prompt and the counts."""
    import torch
    from repro_torch.serve.decode import sample_logits

    cfg = model.cfg
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    bf16 = torch.bfloat16
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    (logits, cache), pre_s = wall_s(lambda: model.prefill(
        prompt, dtype=bf16, cache_len=PROMPT + DECODE_STEPS))
    prefill_counts = all_counts()
    check(prefill_counts["flash_swa"] == cfg.num_layers,
          f"serve: {prefill_counts['flash_swa']} K7 launches in the prefill, "
          f"expected one per layer ({cfg.num_layers})")
    ring = min(PROMPT + DECODE_STEPS, cfg.sliding_window)
    check(tuple(cache["k"].shape) == (cfg.num_layers, 1, ring,
                                      cfg.num_kv_heads,
                                      cfg.resolved_head_dim),
          f"serve: cache shape {tuple(cache['k'].shape)}")
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    finite = torch.isfinite(logits).all()
    tok = sample_logits(None, logits, 0.0, vocab_size=cfg.vocab_size)

    def decode():
        nonlocal tok, finite
        outs = [tok]
        for i in range(DECODE_STEPS):
            step_logits, _ = model.decode_step(tok, PROMPT + i, cache,
                                               dtype=bf16)
            finite = finite & torch.isfinite(step_logits).all()
            tok = sample_logits(None, step_logits, 0.0,
                                vocab_size=cfg.vocab_size)
            outs.append(tok)
        return torch.cat(outs, dim=1)

    ids, dec_s = wall_s(decode)
    counts = all_counts()
    check(counts == prefill_counts, "serve: a kernel was launched in decode")
    check(bool(finite), "serve: non-finite logits")
    check(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
          "serve: a sampled id lies outside the vocabulary")
    peak = (torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0)
    e2e[f"prefill[{cfg.name}, {PROMPT} tokens]"] = pre_s
    e2e[f"decode[{cfg.name}, {DECODE_STEPS} steps]"] = dec_s
    log(f"serve {cfg.name}: prefill {PROMPT} tokens in {pre_s * 1e3:.1f} ms "
        f"({PROMPT / pre_s:.0f} tokens/s), K7 launches {counts['flash_swa']}; "
        f"{DECODE_STEPS} greedy decode steps in {dec_s * 1e3:.1f} ms "
        f"({dec_s * 1e3 / DECODE_STEPS:.2f} ms/token, "
        f"{DECODE_STEPS / dec_s:.1f} tokens/s, batch 1); ring cache {ring} "
        f"slots, {cache_bytes / 2**20:.0f} MiB; peak device memory "
        f"{peak / 2**30:.2f} GiB; ids {ids[0, :8].tolist()}...")
    log("serve launches: " + json.dumps(counts))
    return dict(prompt=prompt, launches=counts["flash_swa"])


def phase_consistency(cfg, seed: int) -> None:
    """The reference's prefill + decode == forward check at ``cfg``'s
    width, depth cut to ``CONSIST_LAYERS``, in float32."""
    import torch
    from repro_torch.models.lm import (decode_step, forward, init_params,
                                       prefill)

    cfg = dataclasses.replace(cfg, num_layers=CONSIST_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 8)
    params, _ = init_params(cfg, gen, device=DEVICE)
    total = CONSIST_PROMPT + CONSIST_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (1, total), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    f32 = torch.float32
    t0 = time.perf_counter()
    before = swa_launches()
    want, _ = forward(params, cfg, tokens, dtype=f32)
    logits, cache = prefill(params, cfg, tokens[:, :CONSIST_PROMPT],
                            dtype=f32, cache_len=total)
    check(swa_launches() == before + 2 * cfg.num_layers,
          "consistency: forward and prefill must each launch K7 per layer")
    errs = [check_close(f"prefill vs forward [pos {CONSIST_PROMPT - 1}]",
                        logits[:, 0], want[:, CONSIST_PROMPT - 1], LM_TOL)]
    for t in range(CONSIST_PROMPT, total):
        logits, cache = decode_step(params, cfg, tokens[:, t:t + 1], t,
                                    cache, dtype=f32)
        if (t - CONSIST_PROMPT + 1) % CONSIST_EVERY == 0:
            errs.append(check_close(f"decode vs forward [pos {t}]",
                                    logits[:, 0], want[:, t], LM_TOL))
    check(swa_launches() == before + 2 * cfg.num_layers,
          "consistency: decode launched K7")
    log(f"consistency {cfg.name} x {cfg.num_layers} layers (f32): "
        f"{CONSIST_PROMPT}-token banded prefill + {CONSIST_DECODE} decode "
        f"steps through a {cache['k'].shape[2]}-slot ring == forward on "
        f"{total} tokens at {len(errs)} positions, max abs err "
        f"{max(errs)!r} (atol/rtol {LM_TOL}), {time.perf_counter() - t0:.1f}"
        f" s")


def sdpa_call(q, k, v, mask):
    """``scaled_dot_product_attention`` with the boolean band mask and GQA,
    on cuDNN: the one backend that takes both at S 32,768 (MATH would
    build the ``[1, 32, S, S]`` scores).  A CPU rehearsal runs MATH."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backend = (SDPBackend.CUDNN_ATTENTION if DEVICE == "cuda"
               else SDPBackend.MATH)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))    # [B, H, S, hd]

    def call():
        with sdpa_kernel([backend]):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)
    return call, backend.name


def phase_swa_times(cfg, seed: int) -> dict:
    """K7 at the prefill's launch shape (CUDA events) beside its bound, its
    plain version and SDPA with the band mask."""
    import torch
    from repro_torch.kernels.flash_swa import kernel as FK

    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    window, qc = cfg.sliding_window, cfg.attn_query_chunk
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)

    q, k, v = (torch.randn((1, PROMPT, heads, hd), generator=gen,
                           device=DEVICE).to(torch.bfloat16)
               for heads in (h, hkv, hkv))
    kernel_ms = cuda_ms(lambda: FK.flash_swa(q, k, v, window=window, qc=qc),
                        warmup=1, iters=5)
    plain_ms = cuda_ms(lambda: FK.flash_swa_plain(q, k, v, window=window,
                                                  qc=qc), warmup=1, iters=2)
    got = FK.flash_swa(q, k, v, window=window, qc=qc)
    err = check_close(f"flash_swa [S {PROMPT}] bf16", got, FK.flash_swa_plain(
        q.float(), k.float(), v.float(), window=window, qc=qc),
        SWA_RTOL_BF16, SWA_ATOL_BF16)
    pairs = band_pairs(PROMPT, window)
    flops = 4 * hd * h * pairs
    nbytes = 2 * PROMPT * hd * (2 * h + 2 * hkv)
    bound_bf16 = flops / BF16_FLOP_PER_S * 1e3
    bound_f32 = flops / F32_FLOP_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(bound_bf16, bound_bytes)
    bound_by = "operations" if bound_bf16 >= bound_bytes else "bytes"

    # the library call: SDPA with the [S, S] band as a boolean mask
    i = torch.arange(PROMPT, device=DEVICE)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    call, backend = sdpa_call(q, k, v, band)
    check_close(f"sdpa ({backend}) vs flash_swa [S {PROMPT}] bf16", call(),
                got, SDPA_TOL)
    library_ms = cuda_ms(call, warmup=1, iters=3)
    del band, got
    log(f"time flash_swa [S {PROMPT}, {h}/{hkv} heads of {hd}, window "
        f"{window}, bf16]: {kernel_ms:.4f} ms ({flops / kernel_ms / 1e9:.1f} "
        f"TFLOP/s); bound {bound:.4f} ms by {bound_by} ({pairs} band pairs "
        f"per head, {flops} flop at 989 TFLOP/s bf16 = {bound_bf16:.4f} ms, "
        f"at 67 TFLOP/s f32 = {bound_f32:.4f} ms; {nbytes} bytes at 3.35 "
        f"TB/s = {bound_bytes:.4f} ms); plain {plain_ms:.3f} ms; library "
        f"{library_ms:.4f} ms (scaled_dot_product_attention, {backend}, with "
        f"the band mask)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=bound_by, err=err)


def run_slice3(seed: int, profile: bool) -> tuple:
    """Path C end to end: ``(K7 row, main-path launches, e2e seconds)``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve.decode import sample_logits

    cfg = get_config(LM_ARCH)
    e2e = {}
    err = phase_swa_parity(cfg, seed)
    model = phase_lm_data(cfg, seed)
    serve = phase_serve(model, seed, e2e)
    if profile:
        prompt, bf16 = serve["prompt"], torch.bfloat16

        def prefill():
            return model.prefill(prompt, dtype=bf16,
                                 cache_len=PROMPT + DECODE_STEPS)

        def decode():
            # greedy steps on the prompt's cache (rewriting the same slots)
            tok = sample_logits(None, logits, 0.0, vocab_size=cfg.vocab_size)
            for i in range(DECODE_STEPS):
                step_logits, _ = model.decode_step(tok, PROMPT + i, cache,
                                                   dtype=bf16)
                tok = sample_logits(None, step_logits, 0.0,
                                    vocab_size=cfg.vocab_size)
            return tok

        logits, cache = prefill()
        phase_profile([(f"prefill[{cfg.name}, {PROMPT} tokens]", prefill),
                       (f"decode[{cfg.name}, {DECODE_STEPS} steps]", decode)])
        del logits, cache
    del model, serve["prompt"]
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    phase_consistency(cfg, seed)
    row = phase_swa_times(cfg, seed)
    row["err"] = max(err, row["err"])
    return row, serve["launches"], e2e


def phase_profile(calls) -> None:
    """Device time by operation for each ``(name, call)`` (``--profile``):
    how much of each call the kernels are."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, call in calls:
        _, bare = wall_s(call)           # also the warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, secs = wall_s(call)
        # device-side events only (kernels, copies, fills): one stream, so
        # their sum is the device's busy time; the idle share is taken
        # against the unprofiled wall time, which the profiler's own host
        # cost does not inflate
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        log(f"profile {name}: wall {secs * 1e3:.1f} ms profiled, "
            f"{bare * 1e3:.1f} ms unprofiled; device busy {busy:.1f} ms "
            f"({100 * busy / (secs * 1e3):.0f}% of the profiled wall); idle "
            f"share {max(0.0, 1 - busy / (bare * 1e3)):.3f} of the "
            f"unprofiled wall")
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        for e in events[:10]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                f"x{e.count:<5d} {e.key[:90]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by operation for one "
                             "bfs, pagerank, MoE layer, TreeLSTM "
                             "evaluation, Danube prefill and Danube "
                             "decode")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    card_line, sms = phase_card()
    phase_build()
    num_blocks = BLOCKS_PER_SM * sms
    A, g, x, source = phase_data(args.seed, num_blocks)
    plans = build_plans(g, num_blocks)
    rows = phase_parity_and_times(A, x, g, plans, num_blocks, args.seed)
    launches, e2e = phase_main(A, x, g, plans, num_blocks, source)
    phase_auto(g, num_blocks, source)
    if args.profile:
        from repro_torch.sparse import bfs, pagerank
        plan = plans["chunked_lpt"][0]
        phase_profile([("bfs[chunked_lpt]",
                        lambda: bfs(g, source, plan=plan)),
                       ("pagerank[chunked_lpt]",
                        lambda: pagerank(g, plan=plan))])
    for name, secs in e2e.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")
    for name, row in rows.items():
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        row["bound_by"] = "bytes"
    del A, g, x, plans
    torch.cuda.empty_cache()

    # slice 2: the segmented-GEMM kernels under the MoE layer and the
    # TreeLSTM wavefront
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    moe = phase_moe_data(args.seed)
    forest = phase_forest_data(args.seed)
    cases = segmm_cases(moe, forest, args.seed)
    err, prepared = phase_segmm_parity(cases)
    e2e2 = {}
    moe_counts = phase_moe(moe, e2e2)
    wave_counts = phase_wavefront(forest, args.seed, e2e2)
    seg_rows = phase_segmm_times(cases, prepared)
    for name, row in seg_rows.items():
        row["err"] = err
        rows[name] = row
        launches[name] = moe_counts[name] + wave_counts[name]
        log(f"main-path launches {name}: {moe_counts[name]} (moe) + "
            f"{wave_counts[name]} (wavefront)")
    if args.profile:
        from repro_torch.models.treelstm import treelstm_forest
        layer = moe["layers"][0.0]
        layer.schedule, layer.execution_path = "chunked_lpt", "native"
        wave_x = torch.from_numpy(forest["x"]).cuda()
        wave_ops = torch.from_numpy(forest["ops"]).cuda()
        from repro_torch.interop import treelstm_params_from_arrays
        wave_params = treelstm_params_from_arrays(
            {"w": forest["w"], "b": forest["b"]}, device="cuda")
        phase_profile([
            ("moe[skew 0, chunked_lpt@native]", lambda: layer(moe["x"])),
            ("treelstm_forest[chunked_lpt]", lambda: treelstm_forest(
                wave_params, forest["trees"], wave_x, wave_ops,
                schedule="chunked_lpt", activation=clip16))])
    for name, secs in e2e2.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")
    del moe, forest, cases, prepared
    torch.cuda.empty_cache()

    # slice 3: the banded attention kernel under H2O-Danube3-4B serving
    rows["flash_swa"], launches["flash_swa"], e2e3 = run_slice3(
        args.seed, args.profile)
    log(f"main-path launches flash_swa: {launches['flash_swa']} (prefill)")
    for name, secs in e2e3.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")

    kernels = []
    for name, (source_file, replaces) in KERNELS.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source_file,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
        log(f"time {name}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f} "
            f"ms by {row['bound_by']}; plain {row['plain_ms']:.3f} ms; "
            f"library {row['library_ms']})")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log("kernels: " + ", ".join(f"{k['name']} launches={k['launches']}"
                                for k in kernels))
    log(card_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
