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
   and a PyTorch library call where one computes the same thing;
   end-to-end times of the entry points;
11. the ``kernels:`` summary, the JSON kernels line, and the final
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
    from repro_torch.kernels.segmm import kernel as SK
    from repro_torch.kernels.spmv_merge import kernel as K
    t0 = time.perf_counter()
    reports = _build.build(K.SOURCES + SK.SOURCES)
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
    from repro_torch.kernels.segmm import kernel as SK
    from repro_torch.kernels.spmv_merge import kernel as K
    K.reset_launch_counts()
    SK.reset_launch_counts()


def all_counts() -> dict:
    from repro_torch.kernels.segmm import kernel as SK
    from repro_torch.kernels.spmv_merge import kernel as K
    return {**K.LAUNCHES, **SK.LAUNCHES}


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
    weights; the MoE w1 case fills the kernels line."""
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
            log(f"time {kname} [{name}]: {row['ms']:.4f} ms (bound "
                f"{bound:.4f} ms by {bound_by}: {flops} flop at 67 TFLOP/s "
                f"= {bound_flops:.4f} ms, {nbytes} bytes at 3.35 TB/s = "
                f"{bound_bytes:.4f} ms; plain {row['plain_ms']:.3f} ms; "
                f"torch.bmm {library:.3f} ms; {busy} experts hold tokens)")
            if name == "moe w1":
                rows[kname] = row
    return rows


def phase_profile(calls) -> None:
    """Device time by operation for each ``(name, call)`` (``--profile``):
    how much of each call the kernels are."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, call in calls:
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, secs = wall_s(call)
        # device-side events only (kernels, copies, fills): one stream, so
        # their sum is the device's busy time
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)
        log(f"profile {name}: wall {secs * 1e3:.1f} ms, device "
            f"busy {device_us / 1e3:.1f} ms "
            f"({100 * device_us / 1e3 / (secs * 1e3):.0f}%)")
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        for e in events[:10]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                f"x{e.count:<5d} {e.key[:90]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by operation for one "
                             "bfs, pagerank, MoE layer and TreeLSTM "
                             "evaluation")
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
