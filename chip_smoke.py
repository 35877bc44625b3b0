#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card, and check them.

Run from the repository root with no arguments (``python3 chip_smoke.py``).
Phases, in order; any failure exits non-zero:

1. card    — nvidia-smi's name and power limit, torch's device name;
2. build   — nvcc builds every CUDA source of the port (one process per
   source, all started together) and prints the ``-Xptxas -v`` register /
   shared-memory lines, ptxas's performance notes (C75xx) and each
   kernel's SASS summary (registers named, local loads and stores);
3. data    — a scale-free graph at soc-LiveJournal1 scale (2**22 vertices,
   2**26 edges requested, skew 1.3, 30% empty rows: the repo's
   ``scalefree_web`` class), made from ``--seed``; the SpMV uses the same
   CSR with its own values;
4. parity  — each slice-1 kernel (K1-K4) at the main path's shapes against
   its plain PyTorch version: bitwise for min/max and integer-valued sums,
   rtol 1e-4 for real-valued sums; K2's min/max also with NaN in some
   bins (NaN where the plain version has it, bitwise elsewhere); K1 (the
   merge-path SpMV over the CSR)
   against the reference's blocked formulation, timed for the whole ``y``
   beside ``torch``'s sparse CSR ``A @ x``;
5. main    — the launch counters are zeroed, then the graph entry points
   run: ``spmv_merge_path`` (``schedule=None`` and ``chunked_lpt``),
   ``bfs`` with parents, ``sssp``, ``delta_stepping`` and ``pagerank``,
   each on ``chunked_lpt`` and ``merge_path`` with ``path="native"``;
   the counter of every kernel of these drivers must have risen
   (``segment_sum_fixup``, the ordered float sum of every fixup of K2's
   partials, included; ``segment_sum_sorted``, the sorted one, is left to
   the pure path of phase 14).  Then ``schedule="auto"`` once;
6. determinism — ``pagerank`` and ``spmv_merge_path`` on ``chunked_lpt``
   twice each, bitwise equal (the graph's hub row spans ~100 chunks),
   timed beside the same calls with the float sums on
   ``index_add_`` (atomic order, as before the ordered sums); and at
   PageRank's fixup shape (``fixup_partials``' bins of one column)
   ``segment_sum_sorted`` against its plain version (bitwise on
   integer-valued data, rtol 1e-4 on real data) and ``segment_sum_fixup``
   bitwise against the sorted route (a stable sort, then
   ``segment_sum_sorted``) on real data and against its plain version;
   each timed (the sorted route with its sort too) beside its byte bound
   and ``index_add_``;
7. serving — counters zeroed; ``GraphServer`` (8 lanes, pull, the
   ``chunked_lpt`` plan) serves ``run_graph_serving``'s stream of 32
   queries (Poisson, 2 a tick; kinds uniform over BFS/SSSP/PageRank,
   sources from ``--seed``): one build of step and admit, at most 2
   ``chunk_walk_tiles`` launches a step, every answer bitwise equal to its
   single-query driver on the same plan; queries/s, p50/p99 latency,
   steps, peak transient memory; then K2 at the step's shape (8 lanes):
   the lanes laid end to end through the one-column kernel (the step's
   launch) against the B-column launch (min partials bitwise equal to
   the B-column ones, sum partials to each lane's one-column launch),
   timed; and the fixup of the 8 lanes' sum partials (``segment_sum_fixup``
   on ``[C, L, 8]``, bitwise equal to the sorted route) timed a launch
   beside the sorted route with its sort, its byte bound and
   ``index_add_``;
8. bfs_multi — counters zeroed; 8 medium-degree sources, one
   ``chunk_walk_tiles`` launch a level, rows bitwise equal to 8
   ``bfs(direction="pull")`` calls;
9. sharded — the sharded traversal (``mesh=``): counters zeroed, then at
   S = 1 in this process (a local mesh) ``sharded_bfs`` with parents,
   ``sharded_sssp``, ``sharded_delta_stepping`` (compacted windows, so K4
   runs), ``sharded_pagerank`` and ``sharded_bfs_multi`` over the 8
   sources on ``chunked_lpt@native``; then each boundary schedule's
   max/mean shard edges at S = 4; then four spawned processes, one rank
   a shard, in a ``gloo`` group (120 s timeout) on CUDA tensors of this
   one card (NCCL takes one rank a card), each memory-mapping the CSR the
   run wrote once: ``equal_width`` runs BFS, SSSP, delta-stepping and
   PageRank, ``edge_balanced`` and ``lpt_contiguous`` BFS and SSSP, and
   every rank builds ``mesh="auto"``'s plan (the pick is printed).  Every
   answer, on every rank, bitwise equal to the unsharded drivers' (PageRank
   at rtol 1e-6, atol 1e-7); K2, K3, K4 and ``segment_sum_fixup`` launched
   at S = 1 and on every rank; wall ms, iterations, ms and bytes in
   collectives, plan build s, plan bytes and peak memory a rank printed.
   Four ranks share one card, so S = 4 measures the sharded path's
   overhead, not its scaling.  The phase also runs on the CPU at a small
   size: import this module, set ``DEVICE = "cpu"``, stub ``torch.cuda``'s
   synchronize and memory counters, and call ``phase_sharded`` on a small
   CPU graph; its ranks then join a gloo group on CPU tensors;
10. measured autotune — with ``REPRO_AUTOTUNE_MEASURE=1`` (the cache is a
   temporary file of the run, as for every "auto" of the run)
   ``spmv_merge_path(schedule="auto")`` and ``build_advance(schedule=
   "auto")`` time their top-3 candidates: modeled cost and measured time
   of each, the model-only and measured picks; a reload of the cache
   selects the same plans with no new measurement; the report of
   ``fit_coefficients`` (the coefficients stay the reference's);
11. moe/forest data — one MoE layer at OLMoE-1B-7B width (d_model 2048,
   64 experts of d_ff 1024, top-8; f32 weights from ``--seed``) on one
   4,096-token sequence, routed plainly (skew 0) and with the router's
   columns biased by ``-0.5 * arange(64)`` (skew 0.5); and a forest of
   11,855 random binary trees (SST's sentence count, 1-56 leaves) at
   feature width 128, integer-valued inputs and weights;
12. segmm parity — K5 and K6 at the MoE's ``w1`` shapes (``bm=128``) and at
   the forest's level-GEMM shapes (``bm=8``, ``K=N=128``) against their
   plain versions: bitwise on integer-valued operands, rtol 1e-4 on real
   ones, and K6 bitwise equal to K5 on real ones; then with the operands
   cast once to bf16, at the ``w1`` shape (bm 128: the wgmma + TMA route,
   each launch counted in ``segmm_wgmma``) and at the level GEMM's (bm 8:
   the mma.sync route, counted in ``segmm_mma``): bitwise on
   integer-valued operands, every real entry within 2 K 2^-24 sum|ab| of
   the plain version (and rtol 1e-4), K6 bitwise equal to K5;
13. moe     — counters zeroed; ``MoELayer`` (``moe_sorted``) at both
   skews on ``group_mapped``, ``chunked_rr`` and ``chunked_lpt`` x
   native/pure, plus ``"auto"``: outputs bitwise equal, equal to ``moe_capacity`` with a
   capacity that drops nothing (rtol/atol 2e-3), ``aux`` equal, three
   segmm launches per call, none on the tensor cores; then the same
   layers with bf16 weights and input: outputs bitwise equal, three
   launches per call on the wgmma route, within 3e-2 (of each entry plus
   3e-2 of the largest) of ``moe_capacity`` in bf16 with a capacity that
   drops nothing (the two round to bf16 at different places), and
   ``moe_sorted`` on the same layer at ``bm = 64`` (three launches on the
   mma.sync route, within 3e-2 of the bm 128 output); the counts are
   read, then the bf16 layer is timed beside the ``grouped`` dispatch on
   the same input (launches outside the counted run);
14. wavefront — counters zeroed; ``treelstm_forest`` with a clip activation
   on ``chunked_lpt`` and ``merge_path`` (native), and
   ``build_wavefront(path="pure")`` + ``treelstm_embed``: bitwise equal to
   each other and to a sequential per-node NumPy oracle on 256 trees, each
   native call making two ``chunk_walk_tiles`` launches a level (the
   combine over all 128 columns, the in-degree update), the native and
   pure paths' fixups on ``segment_sum_fixup`` and the pure path's
   partial sums on ``segment_sum_sorted``; then one ``tanh``
   run; then K2 at the forest's shapes against its plain version and
   timed: the one-column launch of the in-degree update and the 128-column
   launch of a level's combine (bitwise equal, column by column, to 128
   one-column launches on integer-valued data), each beside its bound
   (values counted for unmasked atoms only) and ``index_add_``; the
   combine's fixup (``segment_sum_fixup`` on its ``[C, L, 128]``
   partials) bitwise equal to the sorted route on integer-valued and on
   real partials and to its plain version on integer-valued ones, timed
   beside the sorted route (kernel alone and with its sort), its byte
   bound and ``index_add_``; and the pure path's partial sums
   (``segment_sum_sorted`` over the level's ``[A, 128]`` atom values into
   ``C * L`` bins) against its plain version, timed beside its bound and
   ``index_add_``;
15. times  — each kernel (CUDA events) beside its bound, its plain version
   and a PyTorch library call where one computes the same thing (K5/K6 at
   the four segmm shapes, with their TFLOP/s, share of the f32 peak, or
   of the 989 TFLOP/s bf16 peak for the bf16 shapes, whose bound takes
   flop at that peak and bytes at 3.35 TB/s, ratio to ``torch.bmm``
   (bf16 in and out for the bf16 shapes) and K6's geometry); end-to-end
   times of the entry points;
16. flash parity — K7 (``flash_swa``) against its plain version at
   H2O-Danube3-4B's attention shapes (B 1, S 8192, 32/8 heads of 120,
   window 4096) in float32 (atol/rtol 2e-5) and bfloat16 (rtol 1e-2, atol
   1e-4 against the float32 plain version on the same bf16-rounded
   inputs), at the edges ``window == S``, ``S == window == qc`` and
   ``Hkv == H``, at one rank of phase 25's mesh (16/4 heads, S 8,192),
   at bf16 heads of 100 (not a multiple of 8: the mma.sync kernel; the
   others take the wgmma kernel), each bf16 case's route counter checked,
   and against the port's own ``_attend`` over the
   whole 8,192-token sequence (8 GiB of float32 scores, freed after);
17. lm data — H2O-Danube3-4B at full width and depth (24 layers, d_model
   3840, 3,961,839,360 parameters), weights drawn from ``--seed`` on the
   card and cast once to bfloat16;
18. serve — counters zeroed; ``DecoderLM.prefill`` of one 32,768-token
   prompt (the ``prefill_32k`` shape, batch cut from 32 to 1) in bfloat16
   with a 4,096-slot ring cache, then 32 greedy ``decode_step`` +
   ``sample_logits`` steps: K7 launched once per layer in the prefill and
   never in decode, all 24 on the wgmma kernel (``flash_swa_wgmma``),
   every id in the vocabulary, every logit finite;
19. consistency — the reference's prefill/decode check
   (``tests/test_models.py``) at full width, depth cut to 2, float32: a
   6,144-token prefill (banded) and 1,024 teacher-forced decode steps
   against ``forward`` on all 7,168 tokens, at position 6,143 and every
   128th after it, rtol/atol 2e-3;
20. swa times — first a line per wgmma forward kernel from the build's
   report: its registers at launch and stack / spill bytes (ptxas) and
   the registers its SASS names with its local loads and stores; then K7
   at the prefill's launch shape (S 32,768, bfloat16: the wgmma kernel)
   beside the mma.sync kernel before it at the same shape
   (called directly; both held to the float32 plain version, bfloat16
   limits above), its bound, the flop each executes, its plain version
   and cuDNN's ``scaled_dot_product_attention`` with the band mask (held
   to K7 at 3e-2); then the float32 K7 (the CUDA-core kernel) at the same
   shape;
21. swa backward — the same register lines for the wgmma backward's two
   kernels; then K7's backward (``flash_swa_bwd``) against its plain
   version on the same inputs, forward output and log-sum-exp (the
   forward's lse held to the plain forward's at 1e-4): at the training
   shape (S 8,192, 32/8 heads of 120, window 4,096, bfloat16: rtol 1e-2,
   atol 1e-3 of max(1, max|want|)) and at S = qc + window + qc with bf16
   heads of 64, 120 (operands 2 bytes off 16-byte alignment: copied to
   aligned bases) and 128, all on the wgmma kernels
   (``flash_swa_bwd_wgmma``), and 100 (the mma.sync kernels);
   in float32 at S 2,048 (window 1,024; 2e-5) and at the edge with heads
   of 256 (f32), both on the CUDA-core kernel; at one rank of phase 25's
   mesh (16/4 heads): S 8,192 in bfloat16 and its f32 parity shape (S
   2,048, window 1,024) in float32; every case run twice for
   the same bits, with the route counters checked; timed beside the
   mma.sync backward at the same shape (called directly, held to the plain
   version), its bound, the flop each executes, its plain version and
   SDPA's backward with the band mask; and K7's forward with lse there
   beside the mma.sync forward;
22. train consistency — ``loss_and_grads`` of Danube at full width, depth
   cut to 2, float32, one 8,192-token sequence from
   ``synthetic.batch_at``: K7 and its backward launched twice a layer and
   once a layer (forward + remat recompute, backward; the float32
   backward on the CUDA-core kernel), two runs bitwise
   equal, and the loss (1e-5) and every gradient leaf (1e-4 of its
   largest entry) equal to the same call with the plain version under
   autograd;
23. checkpoint — one train step of that model, then ``checkpoint.save``
   and ``restore_latest`` through a temporary directory, bitwise;
24. train — counters zeroed before each step; ``launch.train``'s loop
   (``make_train_step`` + ``synthetic.batch_at``) for H2O-Danube3-4B at
   full width and depth: float32 master weights and AdamW state, bf16
   compute, remat, S 8,192, global batch 2 in 2 microbatches, 3 steps;
   per step 96 K7 launches and 48 backward launches, all on the wgmma
   kernels (``flash_swa_wgmma``, ``flash_swa_bwd_wgmma``; none on the
   mma.sync kernels), and each step's time;
   finite losses, norms and parameters, every leaf changed, the
   optimizer's step 3; ms a step, tokens/s, peak memory and the model
   flop share of the bf16 peak (``--profile``: one more step profiled);
25. lm mesh — the LM on a ``(data, model)`` mesh: the training steps
   below first run on one device in this process (then freed); four
   spawned ranks then share this card in one gloo group (300 s timeout;
   NCCL takes one rank a card).  On the ``(2, 2)`` mesh: H2O-Danube3-4B at
   full width, depth cut to 4, float32 master weights and AdamW state
   stored as each rank's blocks (``param_specs``), bf16 compute, remat, S
   8,192, global batch 4 in 2 microbatches, 3 steps; on every rank per
   step 2 K7 launches and 1 backward launch a layer a microbatch on its
   16/4 heads, all on the wgmma kernels; finite losses and norms, each
   within 2e-2 (relative) of the one-device steps, every leaf changed and
   the gathered parameters finite; per rank ms a step, tokens/s, peak
   memory and collective calls, bytes and ms a step.  Then in float32 at
   depth 2, S 2,048 (window 1,024, two sequences) ``loss_and_grads`` on
   the mesh against one device's on rank 0 (loss 1e-5, every gathered
   gradient leaf 1e-4 of its largest entry); one float32 step, a
   checkpoint saved from ``(2, 2)`` and restored onto ``(1, 4)``, gathered
   back bitwise.  Then ``make_serve_step`` on ``(1, 4)``: Danube at full
   width and depth in bf16 (each rank draws its blocks), batch 1, a
   4,096-slot ring cache with the KV heads over ``model``, 32 greedy
   steps (ids in the vocabulary, logits finite, every rank the same ids);
   at depth 2 in float32, 8 steps' logits within 2e-3 of one device's
   ``decode_step``.  Four ranks on one card measure the sharded path's
   overhead (gloo moves CUDA tensors through the host), not its scaling;
26. pipeline — the GPipe pipeline (``train/pipeline.py``): the same 8
   H2O-Danube3-4B layers at full width (float32 weights, bf16 compute,
   remat a layer, positions 0..S-1) run first in order on one device
   (``reference_apply``: 4 microbatches of one 8,192-token sequence, loss
   ``mean(y.float()**2)``, forward and backward, 3 steps); then four
   spawned ranks share this card in one gloo group (300 s timeout) on a
   ``(pod, data) = (4, 1)`` mesh from ``make_mesh``, two layers a stage,
   T = 7 ticks: per rank and step 28 K7 launches (7 ticks x 2 layers,
   forward and recompute) and 14 backward launches, all on the tensor
   cores; the loss finite and within 2e-2 of the one-device loss, every
   stage gradient leaf finite and nonzero; ms a step, the bubble share
   (P-1)/T, hop calls, bytes and ms (each hop staged through host memory
   under gloo), the output broadcast, peak memory.  Then in float32 at
   depth 4 (one layer a stage), S 2,048, window 1,024: the output and every
   gathered stage gradient on rank 0 against ``reference_apply`` on one
   device (output 1e-5, gradients 1e-4 of each leaf's largest entry).
   Four stages on one card measure the pipeline's overhead, not its
   scaling;
27. dry-run check (run after phase 28, whose peak it reads) — four steps
   whose peak this run measures, traced on the ``meta`` device by
   ``launch/dryrun.py``: phase 24's one-device step, rank 0's step of
   phase 25's ``(2, 2)`` mesh and of phase 28's (fake groups of 4) and
   each stage's step of phase 26's pipeline (rank ``r`` of a fake group of
   4).  Each peak estimate (arguments plus the most bytes live in the
   step) is held within 25% of the measured ``max_memory_allocated``;
   phase 24's flop count is printed beside ``model_flops``' 6ND;
28. moe mesh — expert parallelism: OLMoE-1B-7B at full width (d_model
   2048, 16 heads, 64 experts of d_ff 1024, top-8, ``grouped``), depth cut
   to 2, S 4,096, global batch 4 in 2 microbatches, float32 weights and
   AdamW state, bf16 compute: 3 steps on one device in this process
   (freed), then four spawned ranks share this card in one gloo group
   (300 s timeout) on ``(data, model) = (2, 2)``, 32 experts a rank: 3
   steps, the loss and grad norm within 2e-2 of one device's at each
   step, every leaf changed, the gathered parameters finite; per rank ms
   a step, tokens/s, peak memory and collectives by kind (calls, MiB, ms).
   Then in float32 at depth 2, S 1,024, two sequences, ``loss_and_grads``
   on the mesh against one device's on rank 0 for OLMoE with ``grouped``,
   with ``capacity`` and DeepSeek-MoE-16B at full width (d_ff 1408, 2
   shared experts, top-6, vocab 102,400): the loss 1e-5, every gathered
   gradient leaf and the router's on both model ranks 1e-4 of its largest
   entry.  Then ``make_serve_step`` on ``(2, 2)``: OLMoE at full width and
   depth in bf16 (each rank draws its blocks), batch 4, 8 greedy steps
   (ids in the vocabulary, logits finite, every rank the same ids); at
   depth 2 in float32, 8 steps' logits within 2e-3 of one device's
   ``decode_step`` for each of ``grouped``, ``capacity`` and ``sorted``.
   Then ``prefill(mesh=)`` with ``sorted`` at full width, depth 2, S
   4,096, batch 2: K5 launched three times a layer on every rank, on its
   own experts, every launch on the wgmma route (bf16 x bf16, bm 128),
   the logits within 2e-2 (of max(1, max|logit|)) of one device's prefill;
   each rank's K5 and K6 at its own shape, bitwise equal, on the wgmma
   route, K5 within the float32 sum-order bound of its plain version
   (bitwise on integer-valued operands), timed beside ``torch.bmm`` on
   the same experts.  Four ranks on one card measure the path's
   overhead, not its scaling;
29. ssm mesh — tensor parallelism of the SSM blocks: RWKV6-3B (d_model
   2,560, 40 heads of 64, d_ff 8,960, vocab 65,536) and Hymba-1.5B
   (d_model 1,600, 25/5 attention heads of 64, window 1,024, ``d_inner``
   1,600, state 16) at full width, depth cut to 2, S 4,096, global batch
   4 in 2 microbatches, float32 weights and AdamW state, bf16 compute,
   remat, 10 steps of learning-rate warmup (``SSM_MESH_WARMUP``): 3 steps
   each on one device in this process (freed), then four
   spawned ranks share this card in one gloo group (300 s timeout) on
   ``(data, model) = (2, 2)``: RWKV6's time mix on 20 heads a rank, its
   channel mix on 4,480 of ``d_ff`` and 1,280 gate columns, Hymba's mamba
   on 800 channels a rank, its attention on the rank's block of 13 or 12
   of its 25 heads (``layers.head_block``): 3 steps each, the loss and
   grad norm within 2e-2 of one device's at each step, every leaf
   changed, the gathered parameters finite; on every Hymba rank 8 K7 and
   4 backward launches a step, all on the wgmma kernels, every one on the
   rank's block of heads; per rank ms a step, tokens/s, peak memory and
   collectives by kind.  Then
   in float32 at depth 2, S 2,048, two sequences (Hymba with window
   1,024 and ``attn_query_chunk`` 512, so that the band runs K7),
   ``loss_and_grads`` on the mesh against one device's on rank 0: the
   loss 1e-5, every gathered gradient leaf and each model rank's copy of
   ``mu``, ``decay_base``, ``bonus_u``, ``wb`` and ``wc`` 1e-4 of its
   largest entry.  Then ``make_serve_step`` on ``(1, 4)``: both models at
   full width and depth in bf16 (each rank draws its blocks), batch 1, 8
   greedy steps (ids in the vocabulary, logits finite, every rank the
   same ids, no weight all-gathered over ``model`` in any step; ms a step
   and collectives by kind); at depth 2 in float32, 8 steps' logits
   within 2e-3 of one device's ``decode_step``.  Then Hymba's
   ``prefill(mesh=)`` at full depth, S 4,096: K7 once a layer on every
   rank, on the wgmma kernels, on the rank's 7, 7, 7 or 4 heads, the
   states returned as the cache places them.  Then GLM-4-9B (32 query / 2
   KV heads of 128, d_model 4,096, vocab 151,552) at full width, depth
   cut to 2, on the same ``(1, 4)`` ranks: 8 query heads a rank on
   ``wq``'s and ``wo``'s stored blocks, its 2 KV heads gathered whole and
   narrowed to the one each block reads; float32 ``loss_and_grads`` at S
   1,024, two sequences, against one device's on rank 0 (loss 1e-5; the
   attention leaves and norms gathered whole, every other leaf on rank
   0's block, 1e-4 of its largest entry), then a bf16 prefill of one
   4,096-token sequence (finite logits, collectives by kind); both fail
   if ``wq`` or ``wo`` is all-gathered over ``model``.  With
   ``--parent-src DIR`` (another checkout's ``src``,
   e.g. the parent commit unpacked with ``git archive``),
   ``tools/time_ssm_decode.py`` then times that tree's decode step and
   this one's on the same ``(1, 4)`` mesh, printed side by side.  Four
   ranks on one card measure the path's overhead, not its scaling;
30. the ``kernels:`` summary (K7's launches include every rank's in the
   mesh, pipeline and ssm mesh phases, K5's the MoE mesh's;
   ``segmm_wgmma`` and ``segmm_mma`` are routes of K5 and K6, not kernels
   of their own: each counts again the K5/K6 launches that ran on it,
   ``segmm_wgmma``'s row timed as K5 at the bf16 ``w1`` shape,
   ``segmm_mma``'s at the bf16 level GEMM's; ``flash_swa_wgmma`` and
   ``flash_swa_bwd_wgmma`` are the routes of K7 and its backward that
   every main-path launch takes, their rows K7's; ``segment_sum_sorted``
   and ``segment_sum_fixup`` replace no Pallas kernel: each row names the
   reference function whose float sums it keeps in a fixed order, and
   carries phase 14's times), the JSON kernels line, and
   the final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_FLOP_PER_S = 67e12             # H100 SXM f32 without tensor cores
REF_KERNEL = "src/repro/kernels/spmv_merge/kernel.py"
CSRC = "src/repro_torch/kernels/spmv_merge/csrc"
SEGMM_REF = "src/repro/kernels/segmm/kernel.py"
SEGMM_CSRC = "src/repro_torch/kernels/segmm/csrc"
SWA_CSRC = "src/repro_torch/kernels/flash_swa/csrc"
SWA_REF = "src/repro/kernels/flash_swa/kernel.py:79"
SWA_BWD_REF = "src/repro/models/layers.py:213"
KERNELS = {   # counter name -> (CUDA source, the Pallas kernel it replaces)
    "spmv_merge_stream": (f"{CSRC}/merge_path.cu", f"{REF_KERNEL}:63"),
    "chunk_walk_tiles": (f"{CSRC}/chunk_walk.cu", f"{REF_KERNEL}:217"),
    "chunk_walk_atoms": (f"{CSRC}/chunk_walk.cu", f"{REF_KERNEL}:192"),
    "chunk_walk_compact": (f"{CSRC}/chunk_walk.cu", f"{REF_KERNEL}:183"),
    "segmented_matmul": (f"{SEGMM_CSRC}/segmm.cu", f"{SEGMM_REF}:50"),
    "segmented_matmul_chunked": (f"{SEGMM_CSRC}/segmm.cu",
                                 f"{SEGMM_REF}:128"),
    # routes of K5 and K6, not kernels: their launches on bf16 x bf16
    # operands, counted again here; wgmma + TMA where bm % 128 == 0 and
    # K % 8 == N % 8 == 0, mma.sync otherwise (segmm.kernel.kernel_for)
    "segmm_wgmma": (f"{SEGMM_CSRC}/segmm_wgmma.cu",
                    f"{SEGMM_REF}:50, {SEGMM_REF}:128"),
    "segmm_mma": (f"{SEGMM_CSRC}/segmm.cu",
                  f"{SEGMM_REF}:50, {SEGMM_REF}:128"),
    "flash_swa": (f"{SWA_CSRC}/flash_swa_wgmma.cu", SWA_REF),
    # the reference differentiates its jnp band (K7 has no backward)
    "flash_swa_bwd": (f"{SWA_CSRC}/flash_swa_bwd_wgmma.cu", SWA_BWD_REF),
    # routes of K7 and its backward, not kernels: their launches on bf16
    # heads that are a multiple of 8 (every main-path launch), counted again
    # here (flash_swa.kernel.kernel_for); the mma.sync kernels keep the
    # other bf16 heads, on no main path (phases 16 and 21 hold them)
    "flash_swa_wgmma": (f"{SWA_CSRC}/flash_swa_wgmma.cu", SWA_REF),
    "flash_swa_bwd_wgmma": (f"{SWA_CSRC}/flash_swa_bwd_wgmma.cu",
                            SWA_BWD_REF),
    # port glue, no Pallas kernel: the ordered float sums of the card,
    # beside the reference functions whose sums they keep in one order
    # (XLA's scatter-add on the TPU)
    "segment_sum_sorted": (f"{CSRC}/segsum.cu",
                           "src/repro/core/segops.py:18"),
    "segment_sum_fixup": (f"{CSRC}/segsum.cu",
                          "src/repro/core/execute.py:197"),
}
REAL_RTOL = 1e-4   # real-valued f32 sums in another order
# soc-LiveJournal1 scale (SNAP: 4.8M vertices, 69M edges)
VERTICES = 2 ** 22
EDGES = 2 ** 26
BLOCKS_PER_SM = 2  # physical blocks (CTAs) per SM: num_blocks of every plan
# graph serving: run_graph_serving's stream (launch/serve.py --graph) on the
# smoke graph
SERVE_LANES = 8
SERVE_QUERIES = 32
SERVE_RATE = 2.0           # mean Poisson arrivals per serving tick
MULTI_SOURCES = 8          # bfs_multi's batch
# the sharded traversal: four gloo ranks sharing the card
SHARD_RANKS = 4
SHARD_BOUNDARIES = ("equal_width", "edge_balanced", "lpt_contiguous")
SHARD_KERNELS = ("chunk_walk_tiles", "chunk_walk_atoms", "chunk_walk_compact",
                 "segment_sum_sorted", "segment_sum_fixup")
SHARD_TIMEOUT_S = 120      # each group's collective timeout
SHARD_DEADLINE_S = 600     # the parent joins its ranks by then
SHARD_PR_RTOL = 1e-6       # tests/test_shard_advance.py,
SHARD_PR_ATOL = 1e-7       # test_pagerank_close_general_graph
# Path A: one MoE layer at OLMoE-1B-7B width on one train_4k sequence
MOE_ARCH = "olmoe_1b_7b"
MOE_TOKENS = 4096
MOE_SKEWS = (0.0, 0.5)     # router column bias -skew * arange(E)
MOE_TOL = 2e-3             # sorted vs capacity dispatch (tests/test_models.py)
# the bf16 layer (bf16 weights and input) against the capacity dispatch in
# bf16: the two round to bf16 at different places (capacity rounds h1, h3,
# their gated product and each weighted atom; sorted keeps h1 and h3 in
# float32 and rounds h once), each rounding up to 2**-9 relative; 3e-2 of
# each entry plus 3e-2 of the largest (a CPU run at this width reads up to
# 1.2e-2 of the largest)
MOE_BF16_TOL = 3e-2
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
# a bf16 head that is not a multiple of 8: K7 and its backward stay on the
# mma.sync kernels there (kernel.kernel_for), held to their plain versions
MMA_HEAD = 100
FWD_ROUTES = ("flash_swa_wgmma", "flash_swa_mma")
BWD_ROUTES = ("flash_swa_bwd_wgmma", "flash_swa_bwd_mma")
# K7's counters that the kernels line reads from the main path: every
# launch, and those on the wgmma kernels
K7_COUNTERS = ("flash_swa", "flash_swa_wgmma", "flash_swa_bwd",
               "flash_swa_bwd_wgmma")
CONSIST_LAYERS = 2
CONSIST_PROMPT = 6144      # banded: > attn_query_chunk + sliding_window
CONSIST_DECODE = 1024
CONSIST_EVERY = 128
LM_TOL = 2e-3              # tests/test_models.py prefill/decode parity
# Path D: H2O-Danube3-4B training at S 8,192 (> qc + window: K7's band)
TRAIN_SEQ = 8192
TRAIN_BATCH = 2
TRAIN_MICRO = 2
TRAIN_STEPS = 3
BWD_F32_S = 2048
BWD_F32_WINDOW = 1024
# K7's backward against its plain version in float32 on the same inputs,
# output and lse: ``rtol * |want| + atol * max(1, max|want|)``.  float32:
# sums in another order, K7's 2e-5; bfloat16: the outputs' bf16 rounding
# (2^-9 relative)
BWD_TOL_F32 = (2e-5, 2e-5)
BWD_TOL_BF16 = (1e-2, 1e-3)
LSE_TOL = 1e-4             # the forward's row log-sum-exp (natural log)
# depth-2 loss_and_grads, K7 against the plain version under autograd,
# float32: the loss, and each gradient leaf to 1e-4 of its largest entry
# (sums in another order through two layers and 8,192 tokens)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4

MESH_RANKS = 4             # spawned ranks sharing the card (gloo)
MESH_MODEL_AXIS = 2        # the training mesh: (data, model) = (2, 2)
MESH_LAYERS = 4            # depth cut so four ranks and one device fit
MESH_BATCH = 4             # one sequence a data rank a microbatch
MESH_MICRO = 2
MESH_STEPS = 3
#: (sequence, global batch, microbatches, steps) of phase 25's training
MESH_SHAPE = (TRAIN_SEQ, MESH_BATCH, MESH_MICRO, MESH_STEPS)
MESH_RTOL = 2e-2           # bf16 losses and grad norms against one device
MESH_F32_LAYERS = 2
MESH_F32_S = 2048
MESH_F32_WINDOW = 1024     # attn_query_chunk 512: the band runs K7
MESH_DECODE_CHECK = 8      # float32 steps held to one device's decode_step
MESH_TIMEOUT_S = 300       # the group's collective timeout
MESH_DEADLINE_S = 900      # the parent joins its ranks by then

PIPE_RANKS = 4             # spawned ranks sharing the card: the stages
PIPE_LAYERS = 8            # depth cut: two Danube layers a stage
PIPE_MICRO = 4             # microbatches of one sequence: T = 7 ticks
PIPE_STEPS = 3
PIPE_F32_LAYERS = 4        # the float32 parity check: one layer a stage
PIPE_F32_S = 2048
PIPE_F32_WINDOW = 1024     # attn_query_chunk 512: the band runs K7
PIPE_OUT_TOL = 1e-5        # the pipeline's float32 output against one device
PIPE_TIMEOUT_S = 300       # the group's collective timeout
PIPE_DEADLINE_S = 600      # the parent joins its ranks by then
DRYRUN_PEAK_TOL = 0.25     # the dry run's peak estimates against the measured

MOE_MESH_ARCH = "olmoe_1b_7b"
MOE_PARITY_ARCH = "deepseek_moe_16b"   # full width: d_ff 1408, 2 shared, top-6
MOE_MESH_LAYERS = 2        # depth cut from 16: one device's state fits
MOE_MESH_SEQ = 4096        # train_4k's sequence
MOE_MESH_BATCH = 4         # cut from 256: a sequence a data rank a microbatch
MOE_MESH_MICRO = 2
MOE_MESH_STEPS = 3
MOE_MESH_SHAPE = (MOE_MESH_SEQ, MOE_MESH_BATCH, MOE_MESH_MICRO,
                  MOE_MESH_STEPS)
MOE_MESH_F32_S = 1024      # the float32 parity check, two sequences
MOE_SERVE_BATCH = 4        # two rows a data rank
MOE_SERVE_STEPS = 8        # each gathers every layer's weights over data
                           # (cut from 16, ~10 s each: the script's time)
MOE_SERVE_CACHE = 4096
MOE_SERVE_CHECK = 8        # float32 steps held to one device's decode_step
MOE_PREFILL_S = 4096
MOE_PREFILL_BATCH = 2      # one sequence a data rank
MOE_PREFILL_TOL = 2e-2     # bf16 prefill logits against one device's

SSM_ARCHS = ("rwkv6_3b", "hymba_15b")
SSM_MESH_LAYERS = 2        # depth cut from 32: one device's state fits
SSM_MESH_SEQ = 4096        # train_4k's; > qc + window = 2,048: K7's band
SSM_MESH_BATCH = 4         # cut from 256: a sequence a data rank a microbatch
SSM_MESH_MICRO = 2
SSM_MESH_STEPS = 3
SSM_MESH_SHAPE = (SSM_MESH_SEQ, SSM_MESH_BATCH, SSM_MESH_MICRO,
                  SSM_MESH_STEPS)
# Learning-rate warmup of the phase's bf16 steps.  At full rate from step 1
# Hymba's gradient norm leaps from 21.9 to 354.6 at step 2, and the three
# steps amplify bf16 rounding: on an H100 one device against itself with
# the embedding moved by a relative 2^-22 read 7.35e-3 apart at step 3,
# and a (2, 2) rank whose attention sums its heads' partials over
# ``model`` 2.68e-2 (the whole attention of earlier trees 1.58e-2); with
# 10 warmup steps 2.31e-3 and 3.59e-3, under MESH_RTOL.
SSM_MESH_WARMUP = 10
SSM_F32_S = 2048           # the float32 parity check, two sequences
SSM_F32_WINDOW = 1024      # Hymba's attn_query_chunk 512: the band runs K7
SSM_SERVE_STEPS = 8        # bf16 greedy steps at full depth, batch 1 (cut
                           # from 16: the phase's 150 s)
SSM_SERVE_CHECK = 8        # float32 steps held to one device's decode_step
SSM_PREFILL_S = 4096       # Hymba's prefill on (1, 4): K7 on every rank
HEADS_ARCH = "glm4_9b"     # 32 query / 2 KV heads of 128 on (1, 4)
HEADS_LAYERS = 2           # depth cut from 40: one device's f32 state fits
HEADS_F32_S = 1024
HEADS_F32_BATCH = 2
HEADS_PREFILL_S = 4096

#: what later phases read of earlier ones (the measured peaks of phases
#: 24, 25, 26 and 28)
MEASURED = {}


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


def graph_ms(fn, *, iters: int = 20) -> float:
    """Mean device time of ``fn()`` in ms, replayed from a captured CUDA
    graph: launches too short to hide the host's cost of issuing them
    (the wrappers' checks and allocation) are timed without the gaps it
    leaves between them."""
    import torch
    fn()                                  # load the library, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
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


def compare_nan(name: str, got, want) -> float:
    """Min/max with NaN inputs: NaN exactly where the plain version has
    it, bitwise elsewhere; returns 0."""
    import torch
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    nan = torch.isnan(want)
    check(bool(nan.any()), f"{name}: the plain version has no NaN bin, so "
          f"the case tests nothing")
    check(bool(torch.equal(torch.isnan(got), nan)),
          f"{name}: NaN where the plain version has none, or none where "
          f"it has one")
    check(bool(torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32))),
          f"{name}: not bitwise equal to its plain version off the NaNs")
    log(f"parity {name}: {int(nan.sum())} NaN bins where the plain version "
        f"has them, bitwise equal elsewhere")
    return 0.0


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
            elif line.startswith("sass: "):
                log(f"  {stem}: {line}")
            elif ("registers" in line or "spill" in line
                  or "setmaxnreg" in line or "(C75" in line):
                log(f"  {stem}: {entry}: {line.strip()}")


def kernel_registers(source) -> list:
    """One line per kernel of a built source (``_build.build``'s report):
    the registers a thread holds at launch and the stack and spill bytes
    (ptxas's ``-v`` lines), then the registers its SASS names, which is
    what a consumer warpgroup runs on after ``setmaxnreg``, and the local
    loads and stores in its code."""
    from repro_torch.kernels import _build
    report = _build.build([source])[source.stem]
    ptxas, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line and "'" in line:
            entry = line.split("'")[1]
            ptxas[entry] = []
        elif entry and ("bytes stack frame" in line or "Used" in line):
            ptxas[entry].append(line.split(":", 1)[-1].strip())
    lines = []
    for line in report.splitlines():
        if not line.startswith("sass: "):
            continue
        name, rest = line[len("sass: "):].split(": ", 1)
        launch = "; ".join(ptxas.get(name, [])) or "no ptxas line"
        lines.append(f"{source.stem} {name}: at launch {launch}; after "
                     f"setmaxnreg {rest}")
    return lines


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
    ok, best = medium_sources(g)
    check(bool(ok.any()), "no medium-degree source found")
    source = int(torch.nonzero(ok)[0])
    deg = g.out_degrees()
    log(f"source vertex {source} (out-degree {int(deg[source])}, largest "
        f"out-neighbour degree {int(best[source])})")
    return A, g, x, source


def medium_sources(g):
    """``(ok, best)``: vertices of medium out-degree with a well-connected
    (but not saturating) out-neighbour, and each vertex's largest
    out-neighbour degree.  Most rows are empty, so a random source often
    dies out, and a hub source saturates in one step and hides the
    direction switch."""
    import torch
    deg = g.out_degrees()
    best = torch.zeros(g.num_vertices, dtype=deg.dtype, device=deg.device)
    best.scatter_reduce_(0, g.edge_sources().long(),
                         deg[g.csr.col_indices.long()], "amax")
    ok = (deg >= 8) & (deg <= 64) & (best >= 1000) & (best <= 100_000)
    return ok, best


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

    # -- K1: the merge-path SpMV of spmv_merge_path(A, x) -----------------
    num_rows, num_cols, nnz = A.shape[0], A.shape[1], A.nnz
    kw1 = dict(num_rows=num_rows,
               block_items=O.merge_block_items(A, num_blocks))
    csr = (A.row_offsets, A.col_indices)
    unit = (unit_values(A.values), unit_values(x))
    compare("spmv_merge_stream (integer-valued)",
            K.spmv_merge_csr(*csr, *unit, num_cols=num_cols, **kw1),
            K.spmv_merge_csr_ref(*csr, *unit, **kw1), exact=True)
    del unit
    err1 = compare("spmv_merge_stream (real)",
                   K.spmv_merge_csr(*csr, A.values, x, num_cols=num_cols,
                                    **kw1),
                   K.spmv_merge_csr_ref(*csr, A.values, x, **kw1),
                   exact=False)
    a_csr = torch.sparse_csr_tensor(A.row_offsets, A.col_indices, A.values,
                                    A.shape)
    # bytes: the CSR and x read once, y written once (the reference's
    # stream formulation moves 8 * G * block_items + 4 * G + 4 * G * r_loc)
    rows["spmv_merge_stream"] = dict(
        err=err1, bytes=4 * (num_rows + 1) + 8 * nnz + 4 * num_cols
        + 4 * num_rows,
        ms=cuda_ms(lambda: K.spmv_merge_csr(*csr, A.values, x,
                                            num_cols=num_cols, **kw1)),
        plain_ms=cuda_ms(lambda: K.spmv_merge_csr_ref(*csr, A.values, x,
                                                      **kw1), iters=3),
        library_ms=cuda_ms(lambda: a_csr @ x))
    tile = K.merge_path_tile()
    log(f"K1 shapes: {num_rows} rows + {nnz} non-zeros = "
        f"{num_rows + nnz} merge items, tile {tile} items, grid "
        f"{-(-(num_rows + nnz) // tile)} CTAs, then the carry kernel; the "
        f"plain version's blocks: {kw1['block_items']} items")
    del a_csr

    # -- K2: pull advances (PageRank's unmasked sum, SSSP's masked min) ----
    errs2 = []
    for schedule, (plan, _) in plans.items():
        spec, part = plan.spec, plan.part
        frontier = torch.rand(g.num_vertices, generator=gen,
                              device="cuda") < 0.3
        mask = frontier[plan.src]
        dist = torch.rand(g.num_vertices, generator=gen, device="cuda")
        cand = dist[plan.src] + plan.weight
        # NaN in one atom of a few thousand bins (min/max must keep it);
        # its own generator leaves the later phases' draws as they were
        nan_gen = torch.Generator(device="cuda").manual_seed(seed + 11)
        nan_cand = cand.clone()
        nan_cand[torch.randint(0, spec.num_atoms, (4096,), generator=nan_gen,
                               device="cuda")] = float("nan")
        cases = [("sum", plan.weight, None, False),
                 ("sum", unit_values(plan.weight - 0.5), None, True),
                 ("min", cand, mask, True), ("max", cand, mask, True),
                 ("min", nan_cand, mask, "nan"), ("max", nan_cand, mask,
                                                  "nan")]
        for combiner, values, m, exact in cases:
            args, kw = E.chunk_walk_operands(spec, part, values,
                                             combiner=combiner, atom_mask=m)
            got = K.chunk_walk_reduce(*args, **kw)
            want = K.chunk_walk_reduce_ref(*args, **kw)
            tag = f"chunk_walk_tiles {schedule}/{combiner}"
            tag += "/masked" if m is not None else ""
            tag += "/integer-valued" if exact and combiner == "sum" else ""
            if exact == "nan":
                err = compare_nan(tag + "/NaN", got, want)
            else:
                err = compare(tag, got, want, exact=exact)
            errs2.append(err)
            del got, want
        del nan_cand
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
    """The entry points, counted; returns the launches, end-to-end seconds
    per call, and the graph drivers' answers on each plan."""
    import torch
    from repro_torch.kernels.spmv_merge import kernel as K
    from repro_torch.kernels.spmv_merge import ops as O
    from repro_torch.sparse import (bfs, delta_stepping, pagerank,
                                    spmv_reference, sssp)

    e2e, answers = {}, {}
    want = spmv_reference(A, x)
    K.reset_launch_counts()
    for schedule in (None, "chunked_lpt"):
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y, secs = wall_s(lambda: O.spmv_merge_path(A, x, schedule=schedule,
                                                   num_blocks=num_blocks))
        transient = torch.cuda.max_memory_allocated() - held
        err = max_abs_err(y, want)
        scale = float(want.abs().max())
        check(y.shape == want.shape and err <= REAL_RTOL * scale,
              f"spmv_merge_path(schedule={schedule}): err {err}")
        e2e[f"spmv_merge_path[{schedule or 'merge_stream'}]"] = secs
        log(f"main spmv_merge_path(schedule={schedule}): {secs * 1e3:.3f} "
            f"ms, peak transient device memory {transient / 2**20:.1f} MiB, "
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
        answers[schedule] = dict(depth=depth, parent=parent, dist=dist,
                                 delta=ddist, pagerank=pr)
    launches = dict(K.LAUNCHES)
    log("main-path launches: " + json.dumps(launches))
    for name, n in launches.items():
        # the drivers' float sums are all fixups (segment_sum_fixup); the
        # sorted sum runs under the pure path (phase 14)
        check(n > 0 or name == "segment_sum_sorted",
              f"kernel {name} was never launched on the main path")
    return launches, e2e, answers


@contextlib.contextmanager
def atomic_sums():
    """The port's float segment sums on the card through ``index_add_``
    (atomic order), as they were before the ordered sums: the "before"
    of :func:`phase_determinism`."""
    import torch
    from repro_torch.core import segops
    from repro_torch.kernels.spmv_merge import kernel as K
    ordered, fixup = segops.ordered_sum, K.segment_sum_fixup

    def atomic(values, segment_ids, num_segments):
        out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                          dtype=values.dtype, device=values.device)
        return out.index_add_(0, segment_ids.to(torch.int64), values)

    def atomic_fixup(partials, tile_starts, num_tiles):
        ids = fixup_ids(tile_starts, int(partials.shape[1]), num_tiles)
        flat = partials.reshape((ids.shape[0],) + tuple(partials.shape[2:]))
        return atomic(flat, ids, num_tiles + 1)[:-1]

    segops.ordered_sum, K.segment_sum_fixup = atomic, atomic_fixup
    try:
        yield
    finally:
        segops.ordered_sum, K.segment_sum_fixup = ordered, fixup


def same_bits(a, b) -> bool:
    import torch
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def fixup_ids(tile_starts, local_tiles: int, num_tiles: int):
    """``fixup_partials``' bins' tile ids, flattened (a bin at or past
    the last tile in the extra segment ``num_tiles``)."""
    import torch
    gtid = tile_starts[:-1, None].long() + torch.arange(
        local_tiles, device=tile_starts.device)[None, :]
    return torch.where(gtid < num_tiles, gtid, num_tiles).reshape(-1)


def sorted_case(tag: str, vals, ids, num: int) -> dict:
    """``segment_sum_sorted`` on real ``vals`` ([n] or [n, B]) summed by
    ``ids`` into ``num`` segments, keys and order from a stable sort:
    against its plain version (bitwise on the integer-valued stand-ins,
    rtol 1e-4 on the real values), timed alone and with its sort (the
    route of ``segops.ordered_sum``) beside its byte bound and
    ``index_add_``.  Returns its row."""
    from repro_torch.launch import roofline as RL
    import torch
    from repro_torch.core import segops
    from repro_torch.kernels.spmv_merge import kernel as K

    keys, order = torch.sort(ids.to(torch.int32), stable=True)
    batch = tuple(vals.shape[1:])
    width = batch[0] if batch else 1
    n = int(ids.numel())
    unit = unit_values(vals)
    compare(f"segment_sum_sorted {tag} (integer-valued)",
            K.segment_sum_sorted(unit, keys, num, order=order),
            K.segment_sum_sorted_ref(unit, keys, num, order=order),
            exact=True)
    del unit
    err = compare(f"segment_sum_sorted {tag} (real)",
                  K.segment_sum_sorted(vals, keys, num, order=order),
                  K.segment_sum_sorted_ref(vals, keys, num, order=order),
                  exact=False)
    # keys and order (int64) read once, the values once, the output once
    nbytes = 12 * n + 4 * n * width + 4 * num * width
    r = dict(err=err, bytes=nbytes, bound_ms=nbytes / RL.HBM_BW * 1e3,
             bound_by="bytes",
             ms=cuda_ms(lambda: K.segment_sum_sorted(vals, keys, num,
                                                     order=order)),
             sort_ms=cuda_ms(lambda: segops.ordered_sum(vals, ids, num)),
             plain_ms=cuda_ms(lambda: K.segment_sum_sorted_ref(
                 vals, keys, num, order=order), iters=3),
             library_ms=cuda_ms(lambda: torch.zeros(
                 (num,) + batch, device="cuda").index_add_(0, ids, vals)))
    log(f"time segment_sum_sorted [{tag}: {n} x {width} values into {num} "
        f"segments]: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
        f"bytes, {nbytes} B: keys, order, values, output); with its stable "
        f"sort {r['sort_ms']:.4f} ms; library {r['library_ms']:.4f} ms "
        f"(index_add_, atomic order); plain {r['plain_ms']:.3f} ms; max abs "
        f"err {err!r}")
    return r


def fixup_case(tag: str, partials, tile_starts, num_tiles: int) -> dict:
    """``segment_sum_fixup`` on real ``partials`` ([C, L] or [C, L, B])
    at ``tile_starts``: bitwise equal to the sorted route (a stable sort of
    the bins' tile ids, then ``segment_sum_sorted``), and against its
    plain version (bitwise on the integer-valued stand-ins, rtol 1e-4 on
    the real values); timed beside the sorted route (its kernel alone and
    with the sort, as ``fixup_partials`` ran it before), its byte bound
    and ``index_add_``.  Returns its row."""
    from repro_torch.launch import roofline as RL
    import torch
    from repro_torch.core import segops
    from repro_torch.kernels.spmv_merge import kernel as K

    chunks, local_tiles = int(partials.shape[0]), int(partials.shape[1])
    batch = tuple(partials.shape[2:])
    width = batch[0] if batch else 1
    ids = fixup_ids(tile_starts, local_tiles, num_tiles)
    keys, order = torch.sort(ids.to(torch.int32), stable=True)
    flat = partials.reshape((chunks * local_tiles,) + batch)
    num = num_tiles + 1
    fixup = lambda: K.segment_sum_fixup(partials, tile_starts, num_tiles)
    compare(f"segment_sum_fixup {tag} (real) against the sorted route",
            fixup(), K.segment_sum_sorted(flat, keys, num,
                                          order=order)[:-1], exact=True)
    unit = unit_values(partials)
    compare(f"segment_sum_fixup {tag} (integer-valued)",
            K.segment_sum_fixup(unit, tile_starts, num_tiles),
            K.segment_sum_fixup_ref(unit, tile_starts, num_tiles),
            exact=True)
    del unit
    err = compare(f"segment_sum_fixup {tag} (real)", fixup(),
                  K.segment_sum_fixup_ref(partials, tile_starts, num_tiles),
                  exact=False)
    # tile_starts, the partials of the bins before the last tile, the
    # output: each once
    n_valid = int(K.fixup_offsets(tile_starts, local_tiles,
                                  num_tiles)[0][-1])
    nbytes = 4 * (chunks + 1) + 4 * n_valid * width + 4 * num_tiles * width
    r = dict(err=err, bytes=nbytes, bound_ms=nbytes / RL.HBM_BW * 1e3,
             bound_by="bytes", ms=cuda_ms(fixup),
             sorted_ms=cuda_ms(lambda: K.segment_sum_sorted(
                 flat, keys, num, order=order)),
             sort_ms=cuda_ms(lambda: segops.ordered_sum(flat, ids, num)),
             plain_ms=cuda_ms(lambda: K.segment_sum_fixup_ref(
                 partials, tile_starts, num_tiles), iters=3),
             library_ms=cuda_ms(lambda: torch.zeros(
                 (num,) + batch, device="cuda").index_add_(0, ids, flat)))
    log(f"time segment_sum_fixup [{tag}: {chunks} x {local_tiles} x {width} "
        f"partials, {n_valid} bins before tile {num_tiles}]: "
        f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by bytes, {nbytes} "
        f"B: tile_starts, those bins' partials, output); the sorted route "
        f"{r['sort_ms']:.4f} ms with its stable sort, "
        f"{r['sorted_ms']:.4f} ms its kernel alone; library "
        f"{r['library_ms']:.4f} ms (index_add_, atomic order); plain "
        f"{r['plain_ms']:.3f} ms; max abs err {err!r}")
    return r


def phase_determinism(A, x, g, plans, num_blocks: int, seed: int) -> dict:
    """Ordered float sums: PageRank and the chunked SpMV bitwise across
    two runs, each timed beside the same call on ``index_add_`` sums;
    ``segment_sum_sorted`` and ``segment_sum_fixup`` at PageRank's fixup
    shape against the sorted route and their plain versions, timed.
    Returns e2e seconds."""
    import torch
    from repro_torch.core import execute as E
    from repro_torch.kernels.spmv_merge import kernel as K
    from repro_torch.kernels.spmv_merge import ops as O
    from repro_torch.sparse import pagerank

    plan = plans["chunked_lpt"][0]
    spec, part = plan.spec, plan.part
    hub = int(g.out_degrees().max())
    window, local_tiles = E._window_sizes(spec, part)
    log(f"determinism: the hub row's {hub} non-zeros span "
        f"{-(-hub // window)} chunks of chunked_lpt (window {window})")
    calls = {
        "pagerank[chunked_lpt]": lambda: pagerank(g, plan=plan),
        "spmv_merge_path[chunked_lpt]": lambda: O.spmv_merge_path(
            A, x, schedule="chunked_lpt", num_blocks=num_blocks)}
    e2e = {}
    for name, call in calls.items():
        before = K.LAUNCHES["segment_sum_fixup"]
        (a, s1), (b, s2) = wall_s(call), wall_s(call)
        launched = K.LAUNCHES["segment_sum_fixup"] - before
        check(same_bits(a, b), f"determinism: {name} differs between two "
              f"runs")
        with atomic_sums():
            (c, s3), (d, s4) = wall_s(call), wall_s(call)
        e2e[f"{name} ordered sums"] = s1
        e2e[f"{name} index_add_ sums"] = s3
        log(f"determinism {name}: two runs bitwise equal, "
            f"{launched // 2} segment_sum_fixup launches a call; "
            f"{s1 * 1e3:.3f} / {s2 * 1e3:.3f} ms with the ordered sums, "
            f"{s3 * 1e3:.3f} / {s4 * 1e3:.3f} ms with index_add_ (atomic "
            f"order; its two runs "
            f"{'bitwise equal' if same_bits(c, d) else 'differ'})")
        del a, b, c, d

    # the ordered sums at PageRank's fixup shape: fixup_partials' bins of
    # one column, on the sorted route and on the fixup
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    starts = part.tile_starts.to(torch.int32).contiguous()
    vals = torch.randn((part.num_blocks, local_tiles), generator=gen,
                       device="cuda")
    sorted_case("PageRank's fixup", vals.reshape(-1),
                fixup_ids(starts, local_tiles, spec.num_tiles),
                spec.num_tiles + 1)
    fixup_case("PageRank's fixup", vals, starts, spec.num_tiles)
    return e2e


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
# slice 8: graph serving, bfs_multi, measured autotuning (on the graph cell)
# ---------------------------------------------------------------------------

def serve_stream(g, plan, seed: int, on_tick=None):
    """``run_graph_serving``'s stream through a new ``GraphServer`` on
    ``plan``: Poisson arrivals, kinds uniform over BFS/SSSP/PageRank,
    sources uniform, from ``seed``.  ``on_tick(k2)`` gets each tick's
    ``chunk_walk_tiles`` launches.  Returns ``(server, results, {qid:
    (kind, source)}, seconds)``."""
    import numpy as np
    import torch
    from repro_torch.kernels.spmv_merge import kernel as K
    from repro_torch.serve.graph import GraphServer

    srv = GraphServer(g, lanes=SERVE_LANES, direction="pull", plan=plan)
    rng = np.random.default_rng(seed)
    kinds = ["bfs", "sssp", "pagerank"]
    queries, results = {}, []
    submitted = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while submitted < SERVE_QUERIES or srv.queued or srv.in_flight:
        if submitted < SERVE_QUERIES:
            for _ in range(min(int(rng.poisson(SERVE_RATE)),
                               SERVE_QUERIES - submitted)):
                kind = kinds[int(rng.integers(len(kinds)))]
                source = int(rng.integers(g.num_vertices))
                queries[srv.submit(kind, source=source)] = (kind, source)
                submitted += 1
        before = K.LAUNCHES["chunk_walk_tiles"]
        results.extend(srv.tick())
        if on_tick is not None:
            on_tick(K.LAUNCHES["chunk_walk_tiles"] - before)
    torch.cuda.synchronize()
    return srv, results, queries, time.perf_counter() - t0


def phase_graph_serving(g, plan, seed: int):
    """The served stream, counted; every answer against its single-query
    driver on the same plan, bitwise.  Returns (launches, e2e seconds)."""
    import numpy as np
    import torch
    from repro_torch.sparse import bfs, pagerank, sssp

    reset_all_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    per_tick = []
    srv, results, queries, secs = serve_stream(g, plan, seed,
                                               per_tick.append)
    transient = torch.cuda.max_memory_allocated() - held
    counts = all_counts()
    check(len(results) == SERVE_QUERIES,
          f"serving: {len(results)} of {SERVE_QUERIES} queries retired")
    check(srv.step_traces == 1 and srv.admit_traces == 1,
          f"serving: step built {srv.step_traces}x, admit "
          f"{srv.admit_traces}x")
    check(max(per_tick) <= 2, f"serving: {max(per_tick)} chunk_walk_tiles "
          f"launches in one step")
    for name in ("chunk_walk_tiles", "segment_sum_fixup"):
        check(counts[name] > 0, f"serving: {name} was never launched")
    lat = sorted(r.latency * 1e3 for r in results)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(np.ceil(0.99 * len(lat))) - 1)]
    by_kind = {k: sum(r.kind == k for r in results)
               for k in ("bfs", "sssp", "pagerank")}
    log(f"serving: {len(results)} queries ({by_kind}) through "
        f"{SERVE_LANES} lanes in {secs:.3f} s ({len(results) / secs:.2f} "
        f"q/s); latency p50 {p50:.1f} ms, p99 {p99:.1f} ms; {srv.steps} "
        f"steps, step_traces={srv.step_traces} "
        f"admit_traces={srv.admit_traces}; peak transient device memory "
        f"{transient / 2**20:.1f} MiB")
    log(f"serving: chunk_walk_tiles launches {counts['chunk_walk_tiles']} "
        f"({max(per_tick)} at most a step, "
        f"{sum(k == 2 for k in per_tick)} steps with 2); launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    t0 = time.perf_counter()
    for r in results:
        kind, source = queries[r.qid]
        if kind == "bfs":
            want = bfs(g, source, plan=plan, direction="pull")
        elif kind == "sssp":
            want = sssp(g, source, plan=plan, direction="pull")
        else:
            want = pagerank(g, plan=plan)
        got = torch.from_numpy(r.value).to(want.device)
        check(got.dtype == want.dtype and same_bits(got, want),
              f"serving: qid {r.qid} ({kind} from {source}) differs from "
              f"the driver")
    log(f"serving: all {len(results)} answers bitwise equal to the "
        f"single-query drivers on the same plan (checked in "
        f"{time.perf_counter() - t0:.1f} s)")
    e2e = {f"graph serving [{SERVE_QUERIES} queries, {SERVE_LANES} lanes]":
           secs}
    lane_layout_times(plan, seed)
    return counts, e2e


def lane_layout_times(plan, seed: int) -> None:
    """K2 at the serving step's shape (8 lanes of the pull view, real
    values): 8 lanes laid end to end through the one-column kernel (the
    serving step's and ``bfs_multi``'s launch) against the B-column
    launch.  The lanes' min partials equal the B-column ones and their sum
    partials each lane's one-column launch, bitwise."""
    from repro_torch.launch import roofline as RL
    import torch
    from repro_torch.core import execute as E
    from repro_torch.kernels.spmv_merge import kernel as K

    spec, part = plan.spec, plan.part
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)
    lanes = torch.rand(SERVE_LANES, spec.num_atoms, generator=gen,
                       device="cuda")
    num_chunks = int(part.atom_starts.shape[0]) - 1
    cols, ckw = E.chunk_walk_operands(spec, part, lanes.t().contiguous(),
                                      combiner="min")
    layout = E.LaneLayout(spec, part, SERVE_LANES, path="native")
    fill = lambda out: out.copy_(lanes)
    rows, rkw = layout.operands(SERVE_LANES, fill, combiner="min")
    L = ckw["local_tiles"]
    got = K.chunk_walk_reduce(*rows, **rkw).view(SERVE_LANES, num_chunks + 1,
                                                 L)[:, :num_chunks]
    want = K.chunk_walk_reduce(*cols, **ckw).permute(2, 0, 1)
    check(same_bits(got.contiguous(), want.contiguous()),
          "lane layout: min partials differ from the B-column launch")
    srows, skw = layout.operands(SERVE_LANES, fill, combiner="sum")
    sums = K.chunk_walk_reduce(*srows, **skw).view(SERVE_LANES,
                                                   num_chunks + 1, L)
    for j in (0, SERVE_LANES - 1):
        one, okw = E.chunk_walk_operands(spec, part, lanes[j].contiguous())
        check(same_bits(sums[j, :num_chunks].contiguous(),
                        K.chunk_walk_reduce(*one, **okw)),
              f"lane layout: lane {j}'s sums differ from its one-column "
              f"launch")
    batched = cuda_ms(lambda: K.chunk_walk_reduce(*cols, **ckw))
    laid = cuda_ms(lambda: K.chunk_walk_reduce(*rows, **rkw))
    one, okw = E.chunk_walk_operands(spec, part, lanes[0].contiguous(),
                                     combiner="min")
    single = cuda_ms(lambda: K.chunk_walk_reduce(*one, **okw))
    plain = cuda_ms(lambda: K.chunk_walk_reduce_ref(*cols, **ckw), iters=3)
    # library: scatter_reduce_'s amin per tile of the same 8 columns
    values = lanes.t().contiguous()
    tids = spec.atom_tile_ids().long()[:, None].expand(-1, SERVE_LANES)
    out = torch.empty((spec.num_tiles, SERVE_LANES), device=values.device)
    library = cuda_ms(lambda: out.fill_(float("inf")).scatter_reduce_(
        0, tids, values, "amin"))
    nbytes = SERVE_LANES * 4 * spec.num_atoms + 4 * spec.num_atoms \
        + SERVE_LANES * 4 * num_chunks * L
    log(f"time chunk_walk_tiles at the serving step's shape "
        f"[{spec.num_atoms} atoms, {SERVE_LANES} lanes, min]: B-column "
        f"launch {batched:.4f} ms; lanes end to end (one-column kernel) "
        f"{laid:.4f} ms; one lane alone {single:.4f} ms; bound "
        f"{nbytes / RL.HBM_BW * 1e3:.4f} ms ({nbytes} B by bytes: "
        f"values, tile ids once, partials); plain {plain:.3f} ms; library "
        f"{library:.4f} ms (scatter_reduce_ amin per tile); lane partials "
        f"bitwise equal (min: to the B-column launch; sum: to each lane's "
        f"one-column launch)")
    # the step's fixup of the 8 lanes' sum partials, as LaneLayout.reduce
    # hands them to fixup_partials
    partials = sums[:, :num_chunks].permute(1, 2, 0).contiguous()
    fixup_case(f"serving, {SERVE_LANES} lanes", partials,
               part.tile_starts.to(torch.int32).contiguous(), spec.num_tiles)


def phase_bfs_multi(g, plan, seed: int, source: int):
    """``bfs_multi`` over 8 sources: one ``chunk_walk_tiles`` launch a
    level, rows bitwise equal to 8 ``bfs`` calls.  Returns (launches, e2e
    seconds, sources, depths)."""
    import numpy as np
    import torch
    from repro_torch.sparse import bfs, bfs_multi

    # sources that traverse the graph (medium_sources), not ones that die
    # out after a level or two
    ok = np.nonzero(medium_sources(g)[0].cpu().numpy())[0]
    rng = np.random.default_rng(seed + 20)
    others = rng.choice(ok[ok != source], MULTI_SOURCES - 1, replace=False)
    sources = [source] + sorted(int(v) for v in others)
    reset_all_counts()
    depth, secs = wall_s(lambda: bfs_multi(g, sources, plan=plan))
    counts = all_counts()
    levels = int(depth.max()) + 1
    check(counts["chunk_walk_tiles"] == levels,
          f"bfs_multi: {counts['chunk_walk_tiles']} chunk_walk_tiles "
          f"launches for {levels} levels")
    single = 0.0
    for s, src in enumerate(sources):
        want, t = wall_s(lambda: bfs(g, src, plan=plan, direction="pull"))
        single += t
        check(bool(torch.equal(depth[s], want)),
              f"bfs_multi: row {s} (source {src}) differs from bfs")
    reached = (depth >= 0).sum(1).tolist()
    log(f"bfs_multi: {MULTI_SOURCES} sources {sources}, {levels} levels, "
        f"{counts['chunk_walk_tiles']} chunk_walk_tiles launches (one a "
        f"level); {secs * 1e3:.1f} ms against {single * 1e3:.1f} ms for "
        f"{MULTI_SOURCES} bfs(direction='pull') calls; rows bitwise equal; "
        f"reached {reached}")
    return counts, {f"bfs_multi[{MULTI_SOURCES} sources]": secs,
                    f"{MULTI_SOURCES} x bfs[pull]": single}, sources, depth


def phase_measured_autotune(A, x, g, num_blocks: int):
    """``REPRO_AUTOTUNE_MEASURE=1``: ``spmv_merge_path(schedule="auto")``
    and ``build_advance(schedule="auto")`` time their top model-ranked
    candidates; each candidate's modeled cost and measured time, both
    picks; a reload that measures nothing; the coefficient fit (report
    only).  The cache is the run's temporary file."""
    from repro_torch.core import (AutotuneCache, collect_fit_samples,
                                  fit_coefficients, measurement_count,
                                  score_plans, select_plan)
    from repro_torch.core.autotune import shape_key
    from repro_torch.kernels.spmv_merge import ops as O
    from repro_torch.sparse import build_advance, spmv_reference

    os.environ["REPRO_AUTOTUNE_MEASURE"] = "1"
    try:
        before = measurement_count()
        y, spmv_s = wall_s(lambda: O.spmv_merge_path(
            A, x, schedule="auto", num_blocks=num_blocks))
        plan, adv_s = wall_s(lambda: build_advance(
            g, schedule="auto", num_blocks=num_blocks))
        taken = measurement_count() - before
    finally:
        del os.environ["REPRO_AUTOTUNE_MEASURE"]
    want = spmv_reference(A, x)
    err = max_abs_err(y, want)
    scale = float(want.abs().max())
    check(err <= REAL_RTOL * scale, f"measured spmv_merge_path: err {err}")
    log(f"measured autotune: spmv_merge_path(schedule='auto') "
        f"{spmv_s:.2f} s, build_advance(schedule='auto') {adv_s:.2f} s, "
        f"{taken} candidates timed; max abs err vs spmv_reference {err!r}")
    check(taken == 9, f"measured autotune: {taken} measurements, not 3 + "
          f"3 + 3")
    path = AutotuneCache().path
    cases = (("spmv_merge_path", A.workspec(), "reduce"),
             ("build_advance pull", plan.spec, "advance"),
             ("build_advance push", plan.push_spec, "advance_push"))
    disk = AutotuneCache(path)          # a new process's view of the file
    picks = {}
    for name, spec, workload in cases:
        key = shape_key(spec, num_blocks) + "|plan"
        key += "" if workload == "reduce" else f".{workload}"
        record = disk.get_record(key)
        check(record is not None and len(record.measured_us) == 3,
              f"measured autotune: no measured record for {name}")
        model = select_plan(spec, num_blocks, cache=None, workload=workload)
        scores = score_plans(spec, num_blocks, workload=workload)
        for plan_, cost in sorted(scores.items(), key=lambda kv: kv[1]):
            us = record.measured_us.get(plan_.encode())
            log(f"  {name}: {plan_.encode():22s} modeled {cost:12.1f} "
                f"steps, measured "
                + (f"{us:12.1f} us" if us else "not timed"))
        fastest = min(record.measured_us, key=record.measured_us.get)
        log(f"measured autotune {name}: model-only pick "
            f"{model.encode()}, measured pick {record.plan.encode()} "
            f"(fastest timed: {fastest})")
        picks[name] = (spec, workload, record.plan)

    def remeasured(plan_):
        fail(f"measured autotune: {plan_.encode()} timed again after a "
             f"reload")

    os.environ["REPRO_AUTOTUNE_MEASURE"] = "1"
    try:
        before = measurement_count()
        for name, (spec, workload, pick) in picks.items():
            again = select_plan(spec, num_blocks, workload=workload,
                                cache=AutotuneCache(path),
                                measure=remeasured)
            check(again == pick, f"measured autotune: {name} picks "
                  f"{again.encode()} after a reload, not {pick.encode()}")
        check(measurement_count() == before,
              "measured autotune: the reload measured again")
    finally:
        del os.environ["REPRO_AUTOTUNE_MEASURE"]
    log("measured autotune: reloaded cache re-selected the same plans with "
        "0 new measurements")
    fit = fit_coefficients(collect_fit_samples(AutotuneCache(path)))
    for line in fit.report().splitlines():
        log(f"  fit: {line}")


# ---------------------------------------------------------------------------
# slice 9: the sharded traversal (one rank a shard, torch.distributed)
# ---------------------------------------------------------------------------

def shard_plan_kw(num_blocks: int) -> dict:
    return dict(schedule="chunked_lpt", path="native", num_blocks=num_blocks)


def pagerank_close(got, want) -> bool:
    """The reference's ``test_pagerank_close_general_graph`` tolerance."""
    import torch
    return bool(torch.allclose(got, want, rtol=SHARD_PR_RTOL,
                               atol=SHARD_PR_ATOL))


def sharded_drivers(splan, dplan, source: int, want: dict, sources=None,
                    want_multi=None) -> list:
    """Every sharded driver this mesh runs, each timed (host clock ending
    in a synchronize) and held to the unsharded answer in ``want``:
    ``[(name, ms, iterations, collective ms, collective calls, bytes
    gathered, ok), ...]``.  ``dplan`` (or ``None``) adds delta-stepping
    and PageRank; ``sources`` adds ``bfs_multi``."""
    from repro_torch.kernels.spmv_merge import kernel as K
    from repro_torch.sparse import (sharded_bfs, sharded_bfs_multi,
                                    sharded_delta_stepping,
                                    sharded_pagerank, sharded_sssp)
    stats = splan.mesh.stats
    runs = [("bfs", lambda: sharded_bfs(splan, source, return_parents=True,
                                        return_direction_counts=True)),
            ("sssp", lambda: sharded_sssp(splan, source,
                                          return_direction_counts=True))]
    if dplan is not None:
        runs += [("delta_stepping", lambda: sharded_delta_stepping(
            dplan, source, return_direction_counts=True)),
                 ("pagerank", lambda: sharded_pagerank(splan))]
    if sources is not None:
        runs.append(("bfs_multi", lambda: sharded_bfs_multi(splan,
                                                            sources)))
    rows = []
    for name, fn in runs:
        stats.reset()
        k2 = K.LAUNCHES["chunk_walk_tiles"]
        out, secs = wall_s(fn)
        if name == "bfs":
            depth, parent, counts = out
            ok = same_bits(depth, want["depth"]) and same_bits(
                parent, want["parent"])
            iters = sum(counts.tolist())
        elif name in ("sssp", "delta_stepping"):
            dist, counts = out
            ok = same_bits(dist, want["dist"]) and same_bits(
                dist, want["delta"])
            iters = sum(counts.tolist())
        elif name == "pagerank":
            ok = pagerank_close(out, want["pagerank"])
            iters = K.LAUNCHES["chunk_walk_tiles"] - k2
        else:
            ok = same_bits(out, want_multi)
            iters = int(out.max()) + 1
        rows.append((name, secs * 1e3, iters, stats.seconds * 1e3,
                     stats.calls, stats.bytes, ok))
    return rows


def shard_rank(rank: int, world: int, port: int, job: dict, out_q,
               fn: str = "shard_rank_job",
               timeout_s: float = SHARD_TIMEOUT_S) -> None:
    """One rank of a four-rank phase (a spawned process): joins the gloo
    group, runs the job function named ``fn`` (:func:`shard_rank_job`, or
    :func:`mesh_rank_job`), and reports to the parent."""
    import datetime
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        out_q.put((rank, "ok", globals()[fn](world, job)))
    except BaseException:                      # reported to the parent
        out_q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def shard_rank_job(world: int, job: dict) -> dict:
    """The sharded drivers on this rank's shard of the memory-mapped
    graph, for every boundary schedule, each answer held on this rank to
    the unsharded one; then the ``"auto"`` pick at this world size."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.kernels.spmv_merge import kernel as K
    from repro_torch.launch.mesh import make_graph_mesh
    from repro_torch.sparse import CSR, Graph, build_sharded_advance

    mesh = make_graph_mesh(world, device=DEVICE)   # card rank % count
    dev = mesh.device
    with warnings.catch_warnings():       # read-only memory maps
        warnings.simplefilter("ignore", UserWarning)
        loaded = {name: torch.from_numpy(np.load(path, mmap_mode="r"))
                  for name, path in job["arrays"].items()}
    csr = CSR(loaded["row_offsets"].to(dev), loaded["col_indices"].to(dev),
              loaded["values"].to(dev), job["shape"], job["nnz"])
    g = Graph(csr)
    want = {k: loaded[k].to(dev) for k in ("depth", "parent", "dist",
                                             "delta", "pagerank")}
    kw = shard_plan_kw(job["num_blocks"])
    out = {"mesh": str(mesh), "runs": []}
    K.reset_launch_counts()
    for boundary in SHARD_BOUNDARIES:
        torch.cuda.reset_peak_memory_stats(dev)
        splan, build_s = wall_s(lambda: build_sharded_advance(
            g, mesh, shard_schedule=boundary, **kw))
        dplan, dbuild_s = None, 0.0
        if boundary == "equal_width":
            dplan, dbuild_s = wall_s(lambda: build_sharded_advance(
                g, mesh, shard_schedule=boundary, workload="advance_delta",
                delta="auto", compact=True, **kw))
        rows = sharded_drivers(splan, dplan, job["source"], want)
        out["runs"].append(dict(
            boundary=boundary, build_s=build_s, dbuild_s=dbuild_s,
            plan_bytes=tensor_bytes(splan),
            width=splan.width, shard_size=splan.shard_size,
            e_pull=splan.plan.spec.num_atoms,
            e_push=splan.plan.push_spec.num_atoms,
            peak=torch.cuda.max_memory_allocated(dev), rows=rows))
        del splan, dplan
    auto, auto_s = wall_s(lambda: build_sharded_advance(
        g, "auto", num_blocks=job["num_blocks"]))
    b = auto.boundaries
    owners = sum(1 for lo, hi in zip(b[:-1], b[1:]) if hi > lo)
    out["auto"] = (f"{auto.schedule.value}@{auto.path.value}@s{owners}"
                   f"@b{auto.shard_schedule}", auto_s)
    out["launches"] = dict(K.LAUNCHES)
    return out


def run_shard_ranks(world: int, job: dict, fn: str = "shard_rank_job",
                    timeout_s: float = SHARD_TIMEOUT_S,
                    deadline_s: float = SHARD_DEADLINE_S) -> list:
    """The four ranks, spawned, each running the job function ``fn``;
    every rank's result in rank order.  Each group has its own collective
    timeout, and the parent joins the ranks by a deadline, kills what is
    left and fails."""
    import multiprocessing as mp
    import queue
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=shard_rank,
                         args=(r, world, port, job, out_q, fn, timeout_s),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + deadline_s
    results = {}
    try:
        while len(results) < world and time.monotonic() < deadline:
            try:
                rank, status, res = out_q.get(timeout=5)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            results[rank] = (status, res)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    for r in range(world):
        check(r in results, f"{fn}: rank {r} reported nothing within "
              f"{deadline_s} s")
        check(results[r][0] == "ok", f"{fn}: rank {r} failed:\n"
              f"{results[r][1]}")
    return [results[r][1] for r in range(world)]


def log_shard_rows(tag: str, rows, iters_name="iterations") -> None:
    for name, ms, iters, coll_ms, calls, gathered, ok in rows:
        check(ok, f"sharded {tag} {name}: not equal to the unsharded "
              f"driver's answer")
        log(f"sharded {tag} {name}: {ms:.1f} ms, {iters} {iters_name}, "
            f"collectives {coll_ms:.1f} ms in {calls} calls, "
            f"{gathered / max(iters, 1) / 2**20:.2f} MiB gathered an "
            f"iteration; equal to the unsharded driver")


def phase_sharded(g, plans, num_blocks: int, source: int, sources,
                  want: dict, want_multi) -> dict:
    """The sharded drivers at S = 1 in this process and at S = 4 on four
    spawned gloo ranks sharing this card; answers against the unsharded
    drivers' (bitwise; PageRank at rtol 1e-6, atol 1e-7).  Returns the
    launches of K2-K4 and the ordered sums (S = 1 plus every rank)."""
    import numpy as np
    import torch
    from repro_torch.kernels.spmv_merge import kernel as K
    from repro_torch.sparse import build_sharded_advance, shard_boundaries

    kw = shard_plan_kw(num_blocks)
    reset_all_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    splan, build_s = wall_s(lambda: build_sharded_advance(g, 1, **kw))
    dplan, dbuild_s = wall_s(lambda: build_sharded_advance(
        g, 1, workload="advance_delta", delta="auto", compact=True, **kw))
    log(f"sharded S=1 ({splan.mesh}): plans built in {build_s:.2f} s "
        f"(+{dbuild_s:.2f} s with the delta split), "
        f"{tensor_bytes(splan) / 2**20:.1f} MiB")
    rows = sharded_drivers(splan, dplan, source, want, sources, want_multi)
    log_shard_rows("S=1", rows)
    counts = dict(K.LAUNCHES)
    log(f"sharded S=1 launches {json.dumps(counts)}; peak transient "
        f"{(torch.cuda.max_memory_allocated() - held) / 2**20:.1f} MiB")
    for name in ("chunk_walk_tiles", "chunk_walk_atoms",
                 "chunk_walk_compact", "segment_sum_fixup"):
        check(counts[name] > 0, f"sharded S=1: {name} never launched")
    del splan, dplan

    # the shard-level balance of each boundary schedule at S = 4
    out_deg = np.diff(g.csr.row_offsets.cpu().numpy().astype(np.int64))
    in_deg = np.bincount(g.csr.col_indices.cpu().numpy(),
                         minlength=g.num_vertices)
    for boundary in SHARD_BOUNDARIES:
        b = shard_boundaries(g, SHARD_RANKS, boundary)
        pull = [int(in_deg[lo:hi].sum()) for lo, hi in zip(b[:-1], b[1:])]
        push = [int(out_deg[lo:hi].sum()) for lo, hi in zip(b[:-1], b[1:])]
        log(f"sharded balance {boundary} S={SHARD_RANKS}: boundaries "
            f"{b.tolist()}; pull edges max/mean "
            f"{max(pull) / np.mean(pull):.4f} ({pull}), push edges "
            f"max/mean {max(push) / np.mean(push):.4f} ({push})")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        arrays = {"row_offsets": g.csr.row_offsets,
                  "col_indices": g.csr.col_indices, "values": g.csr.values,
                  **{k: want[k] for k in ("depth", "parent", "dist",
                                          "delta", "pagerank")}}
        paths = {}
        for name, t in arrays.items():
            paths[name] = os.path.join(tmp, f"{name}.npy")
            np.save(paths[name], t.cpu().numpy())
        job = dict(arrays=paths, shape=g.csr.shape, nnz=g.csr.nnz,
                   num_blocks=num_blocks, source=source)
        ranks, secs = wall_s(lambda: run_shard_ranks(SHARD_RANKS, job))
    log(f"sharded S={SHARD_RANKS}: {ranks[0]['mesh']} x {SHARD_RANKS} "
        f"processes on this card, {secs:.1f} s in all (spawn, load, build, "
        f"drive); four ranks share one card, so these times are the "
        f"sharded path's overhead, not scaling")
    totals = {name: counts[name] for name in SHARD_KERNELS}
    for r, res in enumerate(ranks):
        for run in res["runs"]:
            tag = f"S={SHARD_RANKS} {run['boundary']} rank {r}"
            if r == 0:
                log_shard_rows(tag, run["rows"])
            else:
                for row in run["rows"]:
                    check(row[-1], f"sharded {tag} {row[0]}: not equal to "
                          f"the unsharded driver's answer")
            log(f"sharded {tag}: plan built in {run['build_s']:.2f} s "
                f"(+{run['dbuild_s']:.2f} s delta plan), "
                f"{run['plan_bytes'] / 2**20:.1f} MiB, {run['width']} of "
                f"{run['shard_size']} slots real, E_max pull "
                f"{run['e_pull']} push {run['e_push']}, peak device memory "
                f"{run['peak'] / 2**20:.1f} MiB")
        launched = res["launches"]
        log(f"sharded S={SHARD_RANKS} rank {r} launches "
            f"{json.dumps(launched)}")
        for name in ("chunk_walk_tiles", "chunk_walk_atoms",
                     "chunk_walk_compact", "segment_sum_fixup"):
            check(launched[name] > 0, f"sharded rank {r}: {name} never "
                  f"launched")
        for name in totals:
            totals[name] += launched[name]
        check(res["auto"][0] == ranks[0]["auto"][0],
              f"sharded: rank {r} picked {res['auto'][0]} under 'auto'")
    log(f"sharded select_sharded_plan pick with mesh='auto' at world size "
        f"{SHARD_RANKS}: {ranks[0]['auto'][0]} (selected and built in "
        f"{ranks[0]['auto'][1]:.2f} s)")
    return totals


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
    """K5 and K6 launches (``segmm_wgmma`` and ``segmm_mma`` count some of
    them again)."""
    from repro_torch.kernels.segmm import kernel as SK
    return (SK.LAUNCHES["segmented_matmul"]
            + SK.LAUNCHES["segmented_matmul_chunked"])


#: K5/K6's tensor-core routes, each counted on top of the kernel's launch.
SEGMM_ROUTES = ("segmm_wgmma", "segmm_mma")


def route_launches() -> dict:
    """The launches of each tensor-core route of K5/K6 so far."""
    from repro_torch.kernels.segmm import kernel as SK
    return {r: SK.LAUNCHES[r] for r in SEGMM_ROUTES}


def check_routes(name: str, before: dict, route: str, n: int) -> None:
    """Since ``before``, ``n`` launches on ``route`` and none on the other
    tensor-core route (``route`` "segmm_fma": none on either)."""
    got = {r: v - before[r] for r, v in route_launches().items()}
    want = {r: n if r == route else 0 for r in SEGMM_ROUTES}
    check(got == want, f"{name}: tensor-core route launches {got}, expected "
          f"{want}")


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
    layers, layers_bf16 = {}, {}
    for skew in MOE_SKEWS:
        bias = -skew * torch.arange(cfg.num_experts, device="cuda",
                                    dtype=torch.float32)
        params = dict(base.params())
        params["router"] = params["router"] + bias[None, :]
        layers[skew] = MoELayer(params, num_experts=cfg.num_experts,
                                top_k=cfg.top_k, dispatch="sorted")
        # the same layer with its weights cast once to bf16 (the input
        # too, in phase_moe): K5/K6 on the tensor cores
        layers_bf16[skew] = MoELayer(
            {k: v.to(torch.bfloat16) for k, v in params.items()},
            num_experts=cfg.num_experts, top_k=cfg.top_k,
            dispatch="sorted", capacity_factor=cfg.capacity_factor)
        idx, _, _ = _router(params, x.reshape(-1, cfg.d_model),
                            cfg.num_experts, cfg.top_k)
        sizes = torch.bincount(idx.reshape(-1).long(),
                               minlength=cfg.num_experts)
        top = torch.topk(sizes, 8).indices.sort().values.tolist()
        log(f"moe routing skew {skew}: {int((sizes > 0).sum())} experts "
            f"hold tokens, atoms per expert min {int(sizes.min())} / max "
            f"{int(sizes.max())}, busiest experts {top}")
    return dict(cfg=cfg, x=x, layers=layers, layers_bf16=layers_bf16)


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
    forest's level GEMM (integer forest inputs; real ones made here), in
    float32 and in bf16 (one case for each tensor-core route)."""
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
             tree_w, 2, 8),
            # tokens and w1 cast once to bf16: the wgmma route (bm 128)
            ("moe w1 bf16", x2d[atom_token].to(torch.bfloat16),
             idx.reshape(-1), params["w1"].to(torch.bfloat16),
             cfg.num_experts, 128),
            # the level GEMM's shape in bf16 (bm 8): the mma.sync route
            ("forest level bf16", tree_x.to(torch.bfloat16),
             torch.from_numpy(forest["ops"]).cuda(),
             tree_w.to(torch.bfloat16), 2, 8)]


def sum_order_limit(lhs, rhs, block_expert, bm: int):
    """``2 K 2**-24 sum_k |a_k b_k|`` for each output row of K5 on these
    operands: a product of two bf16 values is exact in float32, so two
    float32 sums of the same products in different orders (the
    tensor-core chain of mma k-steps, the plain version's matmul) are each
    within ``K u sum|a b|`` of the exact sum (``u = 2**-24``), and within
    twice that of each other."""
    from repro_torch.kernels.segmm import kernel as SK
    return (2 * lhs.shape[1] * 2.0 ** -24) * SK.segmented_matmul_plain(
        lhs.abs(), rhs.abs(), block_expert, bm=bm)


def compare_sum_order(name: str, got, want, limit) -> float:
    """Hold a bf16 x bf16 K5/K6 result to its plain version within the
    float32 sum-order bound ``limit`` (elementwise); returns the max
    absolute error."""
    import torch
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    err = max_abs_err(got, want)
    over = int(((got - want).abs() > limit).sum())
    check(over == 0, f"{name}: {over} entries differ from the plain version "
          f"beyond the float32 sum-order bound (max abs err {err})")
    log(f"parity {name}: max abs err {err!r}, every entry within 2 K 2^-24 "
        f"sum|ab| (largest bound {float(limit.max())!r}, median |want| "
        f"{float(want.abs().median())!r})")
    return err


def phase_segmm_parity(cases):
    """K5 and K6 against their plain versions at both paths' shapes, and
    on bf16 x bf16 operands at the MoE's ``w1`` shape (the wgmma route)
    and at the level GEMM's (bm 8: the mma.sync route): each launch
    counted on its route, real data within the float32 sum-order bound;
    returns the largest real-valued error of each route
    (``{"segmm_fma": ..., "segmm_wgmma": ..., "segmm_mma": ...}``) and
    each case's operands."""
    from repro_torch.kernels.segmm import kernel as SK
    from repro_torch.kernels.segmm import ops as SO

    errs, prepared = {}, {}
    for name, tokens, experts, rhs, num_experts, bm in cases:
        route = SK.kernel_for(tokens.dtype, rhs.dtype, bm, tokens.shape[1],
                              rhs.shape[2])
        mma = route != "segmm_fma"
        case_errs = errs.setdefault(route, [])

        def counted_launch(fn):
            before = route_launches()
            out = fn()
            check_routes(f"segmm {name}", before, route, 1)
            return out

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
            k5 = counted_launch(lambda: SK.segmented_matmul(
                o5.lhs, r, o5.block_expert, bm=bm))
            plain5 = SK.segmented_matmul_plain(o5.lhs, r, o5.block_expert,
                                               bm=bm)
            case_errs.append(compare(f"segmented_matmul {name} ({label})",
                                     k5, plain5, exact=exact))
            chunks, counts, cmax = o6.queue
            k6 = counted_launch(lambda: SK.segmented_matmul_chunked(
                o6.lhs, r, o6.block_expert, chunks, counts, bm=bm,
                max_chunks=cmax))
            plain6 = SK.segmented_matmul_chunked_plain(
                o6.lhs, r, o6.block_expert, chunks, counts, bm=bm,
                max_chunks=cmax)
            case_errs.append(compare(
                f"segmented_matmul_chunked {name} ({label})", k6, plain6,
                exact=exact))
            if mma and not exact:
                for kname, got, want, o in (
                        ("segmented_matmul", k5, plain5, o5),
                        ("segmented_matmul_chunked", k6, plain6, o6)):
                    compare_sum_order(
                        f"{kname} {name} (real)", got, want,
                        sum_order_limit(o.lhs, r, o.block_expert, bm))
            del plain5, plain6
            if not exact:
                compare(f"segmented_matmul_chunked == segmented_matmul "
                        f"{name} (real)", k6, k5, exact=True)
                prepared[name] = (o5, o6, r)
            del k5, k6
        o5, o6, _ = prepared[name]
        log(f"segmm {name}: tokens {tuple(tokens.shape)} "
            f"{str(tokens.dtype)[6:]}, M_pad {o5.lhs.shape[0]} "
            f"({o5.num_blocks} M-blocks of {bm}), rhs {tuple(rhs.shape)} "
            f"{str(rhs.dtype)[6:]}, K6 queues {o6.queue[1].numel()} x "
            f"{o6.queue[2]} blocks, route {route}")
    return {r: max(e) for r, e in errs.items()}, prepared


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
    check(not any(route_launches().values()), "moe: a float32 layer ran on "
          "the tensor cores")
    phase_moe_bf16(moe, e2e)
    counts = all_counts()
    log("moe launches: " + json.dumps(counts))
    for name in ("segmented_matmul", "segmented_matmul_chunked",
                 "segmm_wgmma", "segmm_mma"):
        check(counts[name] > 0, f"{name} was never launched by the MoE path")
    time_moe_bf16(moe)
    return counts


def phase_moe_bf16(moe, e2e):
    """The bf16 ``MoELayer`` (weights and input cast once to bf16) on every
    policy x path and "auto", both skews: outputs bitwise equal, three
    launches a call on the wgmma route (bm 128), within ``MOE_BF16_TOL``
    of the capacity dispatch in bf16 with a capacity that drops nothing;
    then ``moe_sorted`` at ``bm = 64`` on the same layer (a smaller
    M-block: the mma.sync route), three launches there, within the same
    tolerance of the bm 128 output."""
    import torch
    from repro_torch.kernels.segmm import ops as SO
    from repro_torch.models.moe import moe_capacity, moe_sorted

    cfg, x = moe["cfg"], moe["x"].to(torch.bfloat16)
    runs = [(s, p) for s in SO.SCHEDULE_POLICIES for p in ("native", "pure")]
    runs.append(("auto", "auto"))
    for skew, layer in moe["layers_bf16"].items():
        outs = []
        for schedule, path in runs:
            layer.schedule, layer.execution_path = schedule, path
            before, before_routes = segmm_launches(), route_launches()
            (out, aux), secs = wall_s(lambda: layer(x))
            check(segmm_launches() == before + 3,
                  f"moe bf16 {schedule}/{path}: expected 3 segmm launches")
            check_routes(f"moe bf16 {schedule}/{path}", before_routes,
                         "segmm_wgmma", 3)
            check(out.shape == x.shape and out.dtype == torch.bfloat16
                  and bool(torch.isfinite(out).all()),
                  f"moe bf16 {schedule}/{path}: bad output")
            e2e[f"moe_sorted bf16[skew {skew}, {schedule}@{path}]"] = secs
            outs.append((f"{schedule}@{path}", out, aux))
        first_name, first, first_aux = outs[0]
        for tag, out, aux in outs[1:]:
            check(torch.equal(out.view(torch.int16),
                              first.view(torch.int16)),
                  f"moe bf16 skew {skew}: {tag} != {first_name} bitwise")
            check(float(aux) == float(first_aux),
                  f"moe bf16 skew {skew}: aux of {tag} differs")
        cap, _ = moe_capacity(
            layer.params(), x, num_experts=cfg.num_experts, top_k=cfg.top_k,
            capacity_factor=float(cfg.num_experts / cfg.top_k))
        diff = (cap.float() - first.float()).abs()
        scale = float(cap.float().abs().max())
        err = float(diff.max())
        over = int((diff > MOE_BF16_TOL * cap.float().abs()
                    + MOE_BF16_TOL * scale).sum())
        check(over == 0, f"moe bf16 skew {skew}: sorted vs capacity differ "
              f"in {over} entries beyond rtol {MOE_BF16_TOL} + atol "
              f"{MOE_BF16_TOL} x {scale} (max abs err {err})")
        del cap, diff
        log(f"moe bf16 skew {skew}: {len(outs)} runs bitwise equal, 3 "
            f"wgmma-route launches each, max |sorted - capacity| {err!r} "
            f"(largest |capacity| {scale!r}; rtol/atol {MOE_BF16_TOL} of "
            f"it)")
        # the same layer at bm 64: K5/K6 on the mma.sync route
        before, before_routes = segmm_launches(), route_launches()
        small, _ = moe_sorted(layer.params(), x, num_experts=cfg.num_experts,
                              top_k=cfg.top_k, bm=64, schedule="chunked_lpt",
                              execution_path="native")
        check(segmm_launches() == before + 3, f"moe bf16 skew {skew} bm 64: "
              f"expected 3 segmm launches")
        check_routes(f"moe bf16 skew {skew} bm 64", before_routes,
                     "segmm_mma", 3)
        diff = (small.float() - first.float()).abs()
        scale = float(first.float().abs().max())
        over = int((diff > MOE_BF16_TOL * first.float().abs()
                    + MOE_BF16_TOL * scale).sum())
        check(over == 0, f"moe bf16 skew {skew}: bm 64 differs from bm 128 "
              f"in {over} entries beyond rtol/atol {MOE_BF16_TOL}")
        log(f"moe bf16 skew {skew}: moe_sorted at bm 64, 3 mma.sync-route "
            f"launches, max |bm 64 - bm 128| {float(diff.max())!r}")
        del small, diff


def time_moe_bf16(moe):
    """The bf16 ``MoELayer``'s time (sorted, group_mapped@native) beside
    the ``grouped`` dispatch's (the config's capacity factor) on the same
    input, both skews; called after the counts of phase 13 are read."""
    import torch
    x = moe["x"].to(torch.bfloat16)
    for skew, layer in moe["layers_bf16"].items():
        layer.schedule, layer.execution_path = "group_mapped", "native"
        sorted_ms = cuda_ms(lambda: layer(x), warmup=1, iters=5)
        layer.dispatch = "grouped"
        grouped_ms = cuda_ms(lambda: layer(x), warmup=1, iters=5)
        layer.dispatch = "sorted"
        log(f"moe bf16 skew {skew}: layer {sorted_ms:.3f} ms (sorted, "
            f"group_mapped@native, mean of 5 on CUDA events) against the "
            f"grouped dispatch {grouped_ms:.3f} ms (capacity factor "
            f"{moe['cfg'].capacity_factor}) on the same bf16 input")


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
    tiles_launches = {}
    for schedule in ("chunked_lpt", "merge_path"):
        before = all_counts()
        (r, packed), secs = wall_s(lambda: treelstm_forest(
            params, forest["trees"], x, ops, schedule=schedule,
            activation=clip16))
        roots[f"{schedule}@native"] = r
        e2e[f"treelstm_forest[{schedule}]"] = secs
        after = all_counts()
        rose = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        tiles_launches[schedule] = rose.get("chunk_walk_tiles", 0)
        log(f"wavefront treelstm_forest[{schedule}]: {secs:.3f} s, "
            f"launches {json.dumps(rose)}")
    wplan, build_s = wall_s(lambda: build_wavefront(
        packed.dag, schedule="chunked_lpt", path="pure"))
    for schedule, n in tiles_launches.items():
        check(n == 2 * wplan.num_levels,
              f"wavefront: treelstm_forest[{schedule}] made {n} "
              f"chunk_walk_tiles launches, not 2 x {wplan.num_levels} "
              f"levels")
    log(f"wavefront: {2 * wplan.num_levels} chunk_walk_tiles launches a "
        f"forest call (2 x {wplan.num_levels} levels)")
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
                 "chunk_walk_tiles", "segment_sum_fixup",
                 "segment_sum_sorted"):
        check(counts[name] > 0,
              f"{name} was never launched by the wavefront path")
    return counts, packed.dag


def forest_k2_operands(forest, dag, seed: int):
    """K2's inputs at the forest's shapes, as one level of
    ``wavefront_eval`` builds them on ``chunked_lpt``: the in-degree update
    (unit values, masked to the level's ready nodes) and the combine (the
    resolved predecessors' integer-valued states ``h[src]``, 128 columns).
    Returns ``(plan, update_mask, combine_values, combine_mask)``."""
    import torch
    from repro_torch.sparse.wavefront import build_wavefront

    wplan = build_wavefront(dag, schedule="chunked_lpt", path="native")
    plan = wplan.plan
    level = torch.from_numpy(wplan.level_of).cuda()
    mid = wplan.num_levels // 2
    ready, resolved = level == mid, level < mid
    src = plan.src.long()
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    h = torch.randint(-4, 5, (wplan.num_nodes, FOREST_WIDTH), generator=gen,
                      device="cuda").float()
    return plan, ready[src], h[src], resolved[src]


def phase_k2_forest(forest, dag, seed: int, *, per_column: bool = False):
    """K2 at the forest's shapes (one level of ``chunked_lpt``): the
    one-column launch of the in-degree update and the 128-column launch of
    the combine, each against its plain version and timed beside its byte
    bound and ``index_add_``; then the combine's fixup
    (``segment_sum_fixup`` over its ``[C, L, 128]`` partials) against the
    sorted route and its plain version, and the pure path's partial sums
    (``segment_sum_sorted``) against its plain version, each timed
    beside its byte bound and ``index_add_``.  With ``per_column``
    (for a port whose K2 takes one column) the combine is timed as 128
    one-column launches instead, and the sums are left out.  Returns
    ``{name: row}``."""
    from repro_torch.launch import roofline as RL
    import torch
    from repro_torch.core import execute as E
    from repro_torch.kernels.spmv_merge import kernel as K

    plan, ready, values, mask = forest_k2_operands(forest, dag, seed)
    spec, part = plan.spec, plan.part
    ones = torch.ones(spec.num_atoms, device="cuda")
    args1, kw1 = E.chunk_walk_operands(spec, part, ones, atom_mask=ready)
    A, C, L = spec.num_atoms, part.num_blocks, kw1["local_tiles"]
    compare("chunk_walk_tiles forest/sum/masked (one column)",
            K.chunk_walk_reduce(*args1, **kw1),
            K.chunk_walk_reduce_ref(*args1, **kw1), exact=True)
    log(f"K2 forest shapes: {A} atoms, {C} chunks on "
        f"{part.num_physical_blocks} blocks, window {kw1['window']}, local "
        f"tiles {L}")
    tids = spec.atom_tile_ids()
    rows = {}

    def row(name, atom_mask, masked, kernel, plain, launches=1):
        # the unmasked atoms' values, every atom's tile id and mask read
        # once; C * L * width partials written.  ms: device time (graph
        # replay); host_ms: back-to-back calls issued from Python; library:
        # index_add_ per tile of the values with the mask applied before
        width = masked.shape[1] if masked.dim() == 2 else 1
        active = int(atom_mask.sum())
        nbytes = 4 * active * width + 8 * A + 4 * C * L * width
        bins = torch.zeros((spec.num_tiles,) + tuple(masked.shape[1:]),
                           device="cuda")
        r = dict(ms=graph_ms(kernel), host_ms=cuda_ms(kernel),
                 plain_ms=cuda_ms(plain, iters=3),
                 library_ms=cuda_ms(lambda: bins.index_add_(0, tids,
                                                            masked)),
                 bound_ms=nbytes / RL.HBM_BW * 1e3, bytes=nbytes)
        rows[name] = r
        log(f"time chunk_walk_tiles [forest, {name}]: {r['ms']:.4f} ms "
            f"on the device ({r['host_ms']:.4f} ms a call issued from "
            f"Python) (bound {r['bound_ms']:.4f} ms by bytes, {nbytes} B, "
            f"{active} of {A} atoms unmasked; {launches} launches; plain "
            f"{r['plain_ms']:.3f} ms; library {r['library_ms']:.4f} ms)")

    row("one column", ready, ready.float(),
        lambda: K.chunk_walk_reduce(*args1, **kw1),
        lambda: K.chunk_walk_reduce_ref(*args1, **kw1))
    masked = values * mask[:, None]
    if per_column:
        columns = [E.chunk_walk_operands(spec, part,
                                         values[:, j].contiguous(),
                                         atom_mask=mask)
                   for j in range(FOREST_WIDTH)]
        row("128 one-column launches", mask, masked,
            lambda: [K.chunk_walk_reduce(*a, **k) for a, k in columns],
            lambda: [K.chunk_walk_reduce_ref(*a, **k) for a, k in columns],
            launches=FOREST_WIDTH)
        return rows
    args, kw = E.chunk_walk_operands(spec, part, values, atom_mask=mask)
    partials = K.chunk_walk_reduce(*args, **kw)
    compare("chunk_walk_tiles forest/sum/masked (128 columns)", partials,
            K.chunk_walk_reduce_ref(*args, **kw), exact=True)
    stacked = []
    for j in range(FOREST_WIDTH):
        a, k = E.chunk_walk_operands(spec, part, values[:, j].contiguous(),
                                     atom_mask=mask)
        stacked.append(K.chunk_walk_reduce(*a, **k))
    compare("chunk_walk_tiles forest: 128 columns vs 128 one-column "
            "launches", partials, torch.stack(stacked, dim=2), exact=True)
    del stacked
    row("128 columns", mask, masked,
        lambda: K.chunk_walk_reduce(*args, **kw),
        lambda: K.chunk_walk_reduce_ref(*args, **kw))

    if not hasattr(K, "segment_sum_fixup"):
        log("K2 forest: this port has no segment_sum_fixup; the sums are "
            "left out (tools/time_ordered_sums.py times both routes)")
        return rows
    # the combine's fixup, as fixup_partials runs it (segment_sum_fixup),
    # on the level's integer-valued partials and on real ones
    starts = part.tile_starts.to(torch.int32).contiguous()
    ids = fixup_ids(starts, L, spec.num_tiles)
    keys, order = torch.sort(ids.to(torch.int32), stable=True)
    compare("segment_sum_fixup forest [C, L, 128] (integer-valued) against "
            "the sorted route",
            K.segment_sum_fixup(partials, starts, spec.num_tiles),
            K.segment_sum_sorted(partials.reshape(C * L, FOREST_WIDTH), keys,
                                 spec.num_tiles + 1, order=order)[:-1],
            exact=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    rows["segment_sum_fixup"] = fixup_case(
        "forest combine", torch.randn(partials.shape, generator=gen,
                                      device="cuda"),
        starts, spec.num_tiles)
    # the pure path's partial sums of the same level (blocked_tile_reduce:
    # the atoms' values into each chunk's L local bins) on the sorted route
    bins, _ = E.blocked_bins(spec, part, mask)
    rows["segment_sum_sorted"] = sorted_case(
        "forest combine, pure path", torch.randn(values.shape, generator=gen,
                                                 device="cuda"),
        bins, C * L + 1)
    return rows


def time_segmm_case(name: str, tokens, experts, rhs, bm: int, o5, o6):
    """K5/K6 times at one case's shape (CUDA events) beside the bound, the
    plain version and ``torch.bmm`` (TF32 off) on the gathered expert
    weights, with the achieved TFLOP/s (on the routed rows), its share of
    the peak of the routine's type (67 TFLOP/s float32 on the CUDA cores,
    989 TFLOP/s bf16 on the tensor cores), the ratio to ``torch.bmm``,
    K6's geometry (its team and CTAs, or on the wgmma route its items and
    persistent CTAs) and the time of a whole-output zero fill of
    ``[M_pad, N]`` float32 (what K6's wrapper did before its zero pass
    over the unpopped M-blocks; a port with the older wrapper still does).
    Returns ``{kernel: row}``."""
    from repro_torch.launch import roofline as RL
    import torch
    from repro_torch.kernels.segmm import kernel as SK

    atoms, k_dim = tokens.shape
    n_dim = rhs.shape[2]
    # the types, not SK.kernel_for: tools/time_segmm.py also times ports
    # whose wrapper has no picker
    mma = tokens.dtype == rhs.dtype == torch.bfloat16
    peak, peak_name = ((RL.PEAK_FLOPS_BF16, "bf16 tensor-core") if mma
                       else (F32_FLOP_PER_S, "f32"))
    busy = int(torch.unique(experts).numel())
    flops = 2 * atoms * k_dim * n_dim
    nbytes = (atoms * k_dim * tokens.element_size()
              + busy * k_dim * n_dim * rhs.element_size()
              + atoms * n_dim * 4)
    bound_flops = flops / peak * 1e3
    bound_bytes = nbytes / RL.HBM_BW * 1e3
    bound = max(bound_flops, bound_bytes)
    bound_by = "operations" if bound_flops >= bound_bytes else "bytes"
    nblk = o5.num_blocks
    lhs_b = o5.lhs.view(nblk, bm, k_dim)
    rhs_g = rhs[o5.block_expert.long()]
    library = cuda_ms(lambda: torch.bmm(lhs_b, rhs_g), iters=3)
    del rhs_g
    chunks, counts, cmax = o6.queue
    if hasattr(SK, "wgmma_items") and SK.kernel_for(
            tokens.dtype, rhs.dtype, bm, k_dim, n_dim) == "segmm_wgmma":
        items = SK.wgmma_items(int(counts.numel()) * cmax, bm, n_dim)
        geometry = (f"; K6 {items} items (queue slots x 128-row sub-tiles "
                    f"x 256-column N tiles) on "
                    f"{SK.wgmma_grid(items, SK._sms(o6.lhs.device))} "
                    f"persistent CTAs, route segmm_wgmma")
    else:
        team, ctas = SK.queues_grid(int(counts.numel()), cmax, bm, n_dim)
        geometry = f"; K6 team {team}, {ctas} CTAs"
    zero_ms = cuda_ms(lambda: torch.zeros((o6.lhs.shape[0], n_dim),
                                          dtype=torch.float32,
                                          device=o6.lhs.device), iters=5)
    calls = {
        "segmented_matmul": (
            lambda: SK.segmented_matmul(o5.lhs, rhs, o5.block_expert,
                                        bm=bm),
            lambda: SK.segmented_matmul_plain(o5.lhs, rhs, o5.block_expert,
                                              bm=bm)),
        "segmented_matmul_chunked": (
            lambda: SK.segmented_matmul_chunked(
                o6.lhs, rhs, o6.block_expert, chunks, counts, bm=bm,
                max_chunks=cmax),
            lambda: SK.segmented_matmul_chunked_plain(
                o6.lhs, rhs, o6.block_expert, chunks, counts, bm=bm,
                max_chunks=cmax))}
    bmm_note = ("; torch.bmm writes a bf16 output, half the output bytes"
                if mma else "")
    rows = {}
    for kname, (kernel, plain) in calls.items():
        row = dict(ms=cuda_ms(kernel, iters=20),
                   plain_ms=cuda_ms(plain, iters=3), library_ms=library,
                   bound_ms=bound, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        tflops = flops / row["ms"] / 1e9
        notes = (f"{geometry}; a whole-output zero fill {zero_ms:.4f} ms"
                 if kname == "segmented_matmul_chunked" else "")
        log(f"time {kname} [{name}]: {row['ms']:.4f} ms, "
            f"{tflops:.2f} TFLOP/s ({100 * tflops / (peak / 1e12):.1f}% of "
            f"the {peak / 1e12:.0f} TFLOP/s {peak_name} peak), "
            f"{row['ms'] / library:.3f}x torch.bmm (bound {bound:.4f} ms by "
            f"{bound_by}: {flops} flop at {peak / 1e12:.0f} TFLOP/s = "
            f"{bound_flops:.4f} ms, {nbytes} bytes at 3.35 TB/s = "
            f"{bound_bytes:.4f} ms; plain {row['plain_ms']:.3f} ms; "
            f"torch.bmm {library:.4f} ms{bmm_note}; {busy} experts hold "
            f"tokens{notes})")
        rows[kname] = row
    return rows


def phase_segmm_times(cases, prepared):
    """:func:`time_segmm_case` at every case's shape; the MoE w1 case's K5
    and K6 rows fill the kernels line for the CUDA-core routine, the bf16
    w1 case's K5 row for the wgmma route (``segmm_wgmma``), the bf16
    level GEMM's K5 row for the mma.sync route (``segmm_mma``)."""
    rows = {}
    for name, tokens, experts, _, _, bm in cases:
        o5, o6, rhs = prepared[name]
        case = time_segmm_case(name, tokens, experts, rhs, bm, o5, o6)
        if name == "moe w1":
            rows.update(case)
        elif name == "forest level bf16":
            rows["segmm_mma"] = case["segmented_matmul"]
        elif name == "moe w1 bf16":
            rows["segmm_wgmma"] = case["segmented_matmul"]
            k5, k6 = (case[k]["ms"] for k in ("segmented_matmul",
                                               "segmented_matmul_chunked"))
            f32 = rows["segmented_matmul"]["ms"]
            log(f"segmm moe w1: K5 bf16 {k5:.4f} ms against K5 f32 "
                f"{f32:.4f} ms ({f32 / k5:.2f}x), K6 bf16 {k6:.4f} ms "
                f"({k6 / k5:.3f}x K5)")
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


def k7_routes(fwd: int, bwd: int) -> dict:
    """K7's route counters when every launch of a bf16 path with heads a
    multiple of 8 takes the wgmma kernels: ``fwd`` forward and ``bwd``
    backward launches there, none on the mma.sync kernels."""
    return dict(flash_swa_wgmma=fwd, flash_swa_mma=0,
                flash_swa_bwd_wgmma=bwd, flash_swa_bwd_mma=0)


def mma_executed_flop(s: int, window: int, heads: int, hd: int) -> int:
    """Flop the tensor-core K7 (``csrc/flash_swa_mma.cu``) executes: per
    (128-row query tile, head), every 64-row KV tile of its band whole —
    ``Q K^T`` over the head padded to a multiple of 16, ``P V`` twice (the
    split ``P``) over ``ceil(hd / 8)`` n8 tiles (rounded as the kernel's
    widths are: 4, 8, 12, 15 or 16)."""
    bq, bk = 128, 64          # the kernel's kBQ and kBK
    tiles = 0
    for q0 in range(0, s, bq):
        q_last = min(q0 + bq, s) - 1
        kt0 = max(0, q0 - window + 1) // bk * bk
        tiles += (q_last - kt0) // bk + 1
    n8 = -(-hd // 8)
    n8 = next(w for w in (4, 8, 12, 15, 16) if n8 <= w)
    padded = 16 * -(-n8 // 2)
    per_tile = 2 * bq * bk * padded + 2 * (2 * bq * bk * 8 * n8)
    return heads * tiles * per_tile


def bwd_mma_executed_flop(s: int, window: int, heads: int, kv_heads: int,
                          hd: int) -> int:
    """Flop the tensor-core backward (``csrc/flash_swa_bwd_mma.cu``)
    executes: the dq kernel's 128-row query tiles against every 64-row KV
    tile of their band (``Q K^T`` and ``dO V^T`` over the head padded to a
    multiple of 16, ``dS K`` twice: the split) and the dk/dv kernel's 64-row
    KV tiles against every 32-row query tile of their band for each head
    of the group (``K Q^T``, ``V dO^T``, ``P^T dO`` and ``dS^T Q``, the last
    two twice), each tile whole; output widths rounded as the kernel's
    are (4, 8, 12, 15 or 16 n8 tiles)."""
    n8 = -(-hd // 8)
    n8 = next(w for w in (4, 8, 12, 15, 16) if n8 <= w)
    padded = 16 * -(-n8 // 2)
    dq_tiles = 0
    for q0 in range(0, s, 128):
        q_last = min(q0 + 128, s) - 1
        kt0 = max(0, q0 - window + 1) // 64 * 64
        dq_tiles += (q_last - kt0) // 64 + 1
    kv_tiles = 0
    for kt in range(0, s, 64):
        q_end = min(s - 1, kt + 64 - 1 + window - 1)
        kv_tiles += (q_end - kt) // 32 + 1
    per_dq = 2 * (2 * 128 * 64 * padded) + 2 * (2 * 128 * 64 * 8 * n8)
    per_kv = 2 * (2 * 64 * 32 * padded) + 4 * (2 * 64 * 32 * 8 * n8)
    return heads * dq_tiles * per_dq + heads * kv_tiles * per_kv


def _wgmma_widths(hd: int) -> tuple:
    """``(DP, NO)`` of the wgmma kernels at heads of ``hd``: the head padded
    to 64 or 128 for ``Q K^T`` (its k-steps) and the output width of the
    products that write a head (64, 120 or 128)."""
    if hd <= 64:
        return 64, 64
    return 128, 120 if hd == 120 else 128


def wgmma_executed_flop(s: int, window: int, heads: int, hd: int) -> int:
    """Flop the wgmma K7 (``csrc/flash_swa_wgmma.cu``) executes: per
    (128-row query tile, head), every 128-row KV tile of its band whole
    (the walk of ``kernel.wgmma_band_walk``) — ``Q K^T`` over the padded
    head, ``P V`` twice (the split ``P``) at the output width
    (:func:`_wgmma_widths`)."""
    from repro_torch.kernels.flash_swa import kernel as FK
    window = min(window, s)
    tiles = sum(len(FK.wgmma_band_walk(q0, s, window))
                for q0 in range(0, s, FK.WGMMA_FWD_Q))
    dp, no = _wgmma_widths(hd)
    tile = 2 * FK.WGMMA_FWD_Q * FK.WGMMA_FWD_KV   # a 128 x 128 x 1 product
    return heads * tiles * (tile * dp + 2 * tile * no)


def bwd_wgmma_executed_flop(s: int, window: int, heads: int,
                            hd: int) -> int:
    """Flop the wgmma backward (``csrc/flash_swa_bwd_wgmma.cu``) executes:
    the dq kernel's 128-row query tiles against every 64-row KV tile of
    their band (``Q K^T`` and ``dO V^T`` over the padded head, ``dS K``
    twice: the split) and, for each head, the dk/dv kernel's 128-row key
    tiles against the 64-row query tiles of their band, each consumer
    warpgroup's 64 key rows computing ``K Q^T`` and ``V dO^T`` once and
    ``P^T dO`` and ``dS^T Q`` twice on every query tile it does not pass
    over (``kernel.wgmma_dkdv_walk``), each tile whole
    (:func:`_wgmma_widths`)."""
    from repro_torch.kernels.flash_swa import kernel as FK
    window = min(window, s)
    dp, no = _wgmma_widths(hd)
    dq_tiles = sum(len(FK.wgmma_band_walk(q0, s, window, FK.WGMMA_DQ_Q,
                                          FK.WGMMA_DQ_KV))
                   for q0 in range(0, s, FK.WGMMA_DQ_Q))
    kv_steps = sum(state != "skip"
                   for kt in range(0, s, FK.WGMMA_DKDV_KV)
                   for _, states in FK.wgmma_dkdv_walk(kt, s, window)
                   for state in states)
    dq_tile = 2 * FK.WGMMA_DQ_Q * FK.WGMMA_DQ_KV          # 128 x 64 x 1
    kv_step = 2 * FK.WGMMA_ROWS * FK.WGMMA_DKDV_Q
    per_dq = 2 * dq_tile * dp + 2 * dq_tile * no
    per_kv = 2 * kv_step * dp + 4 * kv_step * no
    return heads * (dq_tiles * per_dq + kv_steps * per_kv)


def phase_swa_parity(cfg, seed: int) -> float:
    """K7 against its plain version at ``cfg``'s attention shapes, the
    edges, and the model's ``_attend`` core; returns the largest error."""
    import torch
    from repro_torch.kernels.flash_swa import kernel as FK
    from repro_torch.models.layers import _attend, _repeat_kv

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    window, qc = cfg.sliding_window, cfg.attn_query_chunk

    def draw(s, heads, d):
        return torch.randn((1, s, heads, d), generator=gen, device=DEVICE)

    errs = []
    cases = [(f"S {SWA_PARITY_S}", SWA_PARITY_S, h, hkv, window, hd),
             ("window == S", 2 * qc, h, hkv, 2 * qc, hd),
             ("S == window == qc", qc, h, hkv, qc, hd),
             ("Hkv == H", 2 * qc, hkv, hkv, qc, hd),
             # one rank of the training mesh: its own heads
             (f"mesh rank, S {TRAIN_SEQ}", TRAIN_SEQ, h // MESH_MODEL_AXIS,
              hkv // MESH_MODEL_AXIS, window, hd),
             # a head that is not a multiple of 8: the mma.sync kernel
             ("mma.sync head", 2 * qc, h, hkv, qc, MMA_HEAD)]
    for name, s, nh, nkv, w, d in cases:
        tag = f"flash_swa [{name}, {nh}/{nkv} heads of {d}, window {w}]"
        q, k, v = draw(s, nh, d), draw(s, nkv, d), draw(s, nkv, d)
        got = FK.flash_swa(q, k, v, window=w, qc=qc)
        errs.append(check_close(f"{tag} f32", got, FK.flash_swa_plain(
            q, k, v, window=w, qc=qc), SWA_TOL_F32))
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        want = FK.flash_swa_plain(qb.float(), kb.float(), vb.float(),
                                  window=w, qc=qc)
        route = FK.kernel_for(torch.bfloat16, d)
        before = all_counts()
        errs.append(check_close(f"{tag} bf16 ({route})", FK.flash_swa(
            qb, kb, vb, window=w, qc=qc), want, SWA_RTOL_BF16,
            SWA_ATOL_BF16))
        moved = {r: all_counts()[r] - before[r] for r in FWD_ROUTES}
        check(moved == {r: int(r == route) for r in FWD_ROUTES},
              f"{tag} bf16: route launches {moved}, expected one on "
              f"{route}")
        if name == f"S {SWA_PARITY_S}":
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
    routes = {k: prefill_counts[k] for k in ("flash_swa_wgmma",
                                            "flash_swa_mma")}
    check(routes == {"flash_swa_wgmma": cfg.num_layers, "flash_swa_mma": 0},
          f"serve: the prefill's K7 launches by route {routes}, expected "
          f"all {cfg.num_layers} on the wgmma kernel")
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
        f"({PROMPT / pre_s:.0f} tokens/s), K7 launches {counts['flash_swa']} "
        f"({counts['flash_swa_wgmma']} on the wgmma kernel); "
        f"{DECODE_STEPS} greedy decode steps in {dec_s * 1e3:.1f} ms "
        f"({dec_s * 1e3 / DECODE_STEPS:.2f} ms/token, "
        f"{DECODE_STEPS / dec_s:.1f} tokens/s, batch 1); ring cache {ring} "
        f"slots, {cache_bytes / 2**20:.0f} MiB; peak device memory "
        f"{peak / 2**30:.2f} GiB; ids {ids[0, :8].tolist()}...")
    log("serve launches: " + json.dumps(counts))
    return dict(prompt=prompt, launches={k: counts[k] for k in (
        "flash_swa", "flash_swa_wgmma")})


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


def mma_route(FK, q, k, v, window: int, lse=None, backward=None):
    """A call of the mma.sync K7 (``csrc/flash_swa_mma.cu``) or, with
    ``backward = (out, lse, dout, dsum, dq, dk, dv)``, of its backward
    (``csrc/flash_swa_bwd_mma.cu``) on bf16 operands with heads a multiple
    of 8 and 16-byte aligned bases, which the wrapper sends to the wgmma
    kernels: the route before them, timed beside them at the same shape.
    Returns ``(call, out)``; the call returns the kernel's CUDA error code
    and counts nothing."""
    import torch
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    if backward is None:
        out = torch.empty_like(q)
        fn = FK._function(FK.SOURCES[1], "flash_swa_mma_fwd")
        ptrs = (q, k, v, out)
        lse_ptr = None if lse is None else lse.data_ptr()
        return (lambda: fn(*(t.data_ptr() for t in ptrs), lse_ptr, b, s, h,
                           hkv, hd, min(window, s), hd ** -0.5, 1,
                           stream)), out
    fn = FK._function(FK.SOURCES[3], "flash_swa_bwd_mma")
    o, l, dout, dsum, *grads = backward
    ptrs = (q, k, v, o, dout, l, dsum, *grads)
    return (lambda: fn(*(t.data_ptr() for t in ptrs), b, s, h, hkv, hd,
                       min(window, s), hd ** -0.5, 1, stream)), grads


def phase_swa_times(cfg, seed: int) -> dict:
    """K7 at the prefill's launch shape (CUDA events) on the wgmma kernel
    and on the mma.sync kernel before it, beside its bound, the flop each
    executes, its plain version and SDPA with the band mask."""
    from repro_torch.launch import roofline as RL
    import torch
    from repro_torch.kernels.flash_swa import kernel as FK

    for line in kernel_registers(FK.CSRC / "flash_swa_wgmma.cu"):
        log(f"registers: {line}")
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    window, qc = cfg.sliding_window, cfg.attn_query_chunk
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)

    q, k, v = (torch.randn((1, PROMPT, heads, hd), generator=gen,
                           device=DEVICE).to(torch.bfloat16)
               for heads in (h, hkv, hkv))
    route = FK.kernel_for(q.dtype, hd)
    kernel_ms = cuda_ms(lambda: FK.flash_swa(q, k, v, window=window, qc=qc),
                        warmup=1, iters=5)
    mma_call, mma_out = mma_route(FK, q, k, v, window)
    mma_ms = cuda_ms(mma_call, warmup=1, iters=5)
    plain_ms = cuda_ms(lambda: FK.flash_swa_plain(q, k, v, window=window,
                                                  qc=qc), warmup=1, iters=2)
    got = FK.flash_swa(q, k, v, window=window, qc=qc)
    want = FK.flash_swa_plain(q.float(), k.float(), v.float(),
                              window=window, qc=qc)
    err = check_close(f"flash_swa [S {PROMPT}] bf16 ({route})", got, want,
                      SWA_RTOL_BF16, SWA_ATOL_BF16)
    check(mma_call() == 0, "flash_swa_mma_fwd: launch failed")
    check_close(f"flash_swa [S {PROMPT}] bf16 (flash_swa_mma)", mma_out, want,
                SWA_RTOL_BF16, SWA_ATOL_BF16)
    del want
    pairs = band_pairs(PROMPT, window)
    flops = 4 * hd * h * pairs
    executed = wgmma_executed_flop(PROMPT, window, h, hd)
    mma_executed = mma_executed_flop(PROMPT, window, h, hd)
    nbytes = 2 * PROMPT * hd * (2 * h + 2 * hkv)
    bound_bf16 = flops / RL.PEAK_FLOPS_BF16 * 1e3
    bound_f32 = flops / F32_FLOP_PER_S * 1e3
    bound_bytes = nbytes / RL.HBM_BW * 1e3
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
        f"{window}, bf16, {route}]: {kernel_ms:.4f} ms "
        f"({flops / kernel_ms / 1e9:.1f} TFLOP/s useful; executes {executed}"
        f" flop, {executed / flops:.3f}x, {executed / kernel_ms / 1e9:.1f} "
        f"TFLOP/s executed, {bound / kernel_ms:.1%} of the bound); the "
        f"mma.sync kernel at the same shape {mma_ms:.4f} ms (executes "
        f"{mma_executed} flop, {mma_executed / mma_ms / 1e9:.1f} TFLOP/s "
        f"executed, {bound / mma_ms:.1%} of the bound); bound {bound:.4f} ms "
        f"by {bound_by} ({pairs} band pairs "
        f"per head, {flops} flop at 989 TFLOP/s bf16 = {bound_bf16:.4f} ms, "
        f"at 67 TFLOP/s f32 = {bound_f32:.4f} ms; {nbytes} bytes at 3.35 "
        f"TB/s = {bound_bytes:.4f} ms); plain {plain_ms:.3f} ms; library "
        f"{library_ms:.4f} ms (scaled_dot_product_attention, {backend}, with "
        f"the band mask)")
    # the float32 K7 (the CUDA-core kernel) at the same shape
    q, k, v = (t.float() for t in (q, k, v))
    f32_ms = cuda_ms(lambda: FK.flash_swa(q, k, v, window=window, qc=qc),
                     warmup=1, iters=3)
    log(f"time flash_swa [S {PROMPT}, {h}/{hkv} heads of {hd}, window "
        f"{window}, f32, CUDA cores]: {f32_ms:.4f} ms "
        f"({flops / f32_ms / 1e9:.1f} TFLOP/s; bound {bound_f32:.4f} ms at "
        f"67 TFLOP/s f32)")
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


# ---------------------------------------------------------------------------
# slice 10: H2O-Danube3-4B training through K7 and its backward (path D)
# ---------------------------------------------------------------------------

def bwd_case(tag: str, s: int, heads: int, kv_heads: int, hd: int,
             window: int, qc: int, dtype, tol: tuple, gen,
             offset: int = 0):
    """K7's backward on one draw against its plain version in float32 on
    the same inputs, output and log-sum-exp (and the forward's lse against
    the plain forward's), then once more for the same bits, through the
    kernel that ``bwd_kernel_for`` names (checked on the counter); with
    ``offset`` 1 every input starts one element into its storage.  Returns
    ``(max abs err, (q, k, v, out, lse, dout))``."""
    import torch
    from repro_torch.kernels.flash_swa import kernel as FK

    def draw(n):
        flat = torch.randn((s * n * hd + offset,), generator=gen,
                           device=DEVICE).to(dtype)
        return flat[offset:].view(1, s, n, hd)

    q, k, v, dout = (draw(n) for n in (heads, kv_heads, kv_heads, heads))
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    f32 = [t.float() for t in (q, k, v, out)]
    _, want_lse = FK.flash_swa_plain(*f32[:3], window=window, qc=qc,
                                     return_lse=True)
    route = FK.bwd_kernel_for(dtype, hd)
    name = (f"{route} [{tag}: S {s}, {heads}/{kv_heads} heads of {hd}"
            f", window {window}, {str(dtype).split('.')[-1]}"
            f"{', 2 bytes off alignment' if offset else ''}]")
    errs = [check_close(f"{name} lse", lse, want_lse, LSE_TOL)]
    before = dict(FK.LAUNCHES)
    got = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    want = FK.flash_swa_bwd_plain(*f32, lse, dout.float(), window=window,
                                  qc=qc)
    rtol, atol = tol
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        errs.append(check_close(f"{name} {label}", g, w, rtol,
                                atol * max(1.0, float(w.abs().max()))))
    again = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two runs differ")
    moved = {r: FK.LAUNCHES[r] - before[r] for r in BWD_ROUTES}
    check(moved == {r: 2 * (r == route) for r in BWD_ROUTES},
          f"{name}: tensor-core route launches {moved}, expected 2 on "
          f"{route}")
    log(f"determinism {name}: two runs bitwise equal")
    return max(errs), (q, k, v, out, lse, dout)


def phase_swa_bwd(cfg, seed: int) -> dict:
    """K7's backward at the training shape (bf16) and the edges against
    its plain version, rerun for the same bits; timed beside its bound,
    its plain version, K7's forward with lse and SDPA's backward."""
    from repro_torch.launch import roofline as RL
    import torch
    from repro_torch.kernels.flash_swa import kernel as FK

    for line in kernel_registers(FK.CSRC / "flash_swa_bwd_wgmma.cu"):
        log(f"registers: {line}")
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    window, qc = cfg.sliding_window, cfg.attn_query_chunk
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 10)
    bf16, f32 = torch.bfloat16, torch.float32
    edge_s = qc + window + qc
    errs = []
    # the last field: the inputs' offset into their storage (1: unaligned)
    for *args, offset in [("f32", BWD_F32_S, h, hkv, hd, BWD_F32_WINDOW,
                           BWD_F32_WINDOW // 2, f32, BWD_TOL_F32, 0),
                          ("edge", edge_s, 8, 2, 64, window, qc, bf16,
                           BWD_TOL_BF16, 0),
                          ("edge", edge_s, 8, 2, hd, window, qc, bf16,
                           BWD_TOL_BF16, 1),
                          ("edge", edge_s, 8, 2, 128, window, qc, bf16,
                           BWD_TOL_BF16, 0),
                          # the mma.sync backward: a head not a multiple of 8
                          ("edge", edge_s, 8, 2, MMA_HEAD, window, qc, bf16,
                           BWD_TOL_BF16, 0),
                          ("edge", edge_s, 8, 2, 256, window, qc, f32,
                           BWD_TOL_F32, 0),
                          # one rank of the mesh phase: its own heads, at
                          # its f32 parity shape and its training shape
                          ("mesh rank f32", MESH_F32_S, h // MESH_MODEL_AXIS,
                           hkv // MESH_MODEL_AXIS, hd, MESH_F32_WINDOW,
                           MESH_F32_WINDOW // 2, f32, BWD_TOL_F32, 0),
                          ("mesh rank", TRAIN_SEQ, h // MESH_MODEL_AXIS,
                           hkv // MESH_MODEL_AXIS, hd, window, qc, bf16,
                           BWD_TOL_BF16, 0)]:
        err, tensors = bwd_case(*args, gen, offset)
        errs.append(err)
        del tensors
    err, (q, k, v, out, lse, dout) = bwd_case(
        "training", TRAIN_SEQ, h, hkv, hd, window, qc, bf16, BWD_TOL_BF16,
        gen)
    errs.append(err)

    route = FK.bwd_kernel_for(q.dtype, hd)
    fwd_ms = cuda_ms(lambda: FK.flash_swa(q, k, v, window=window, qc=qc,
                                          return_lse=True), warmup=1,
                     iters=5)
    mma_lse = torch.empty_like(lse)
    mma_fwd, _ = mma_route(FK, q, k, v, window, lse=mma_lse)
    mma_fwd_ms = cuda_ms(mma_fwd, warmup=1, iters=5)
    kernel_ms = cuda_ms(lambda: FK.flash_swa_bwd(
        q, k, v, out, lse, dout, window=window, qc=qc), warmup=1, iters=5)
    mma_bwd, mma_grads = mma_route(FK, q, k, v, window, backward=(
        out, lse, dout, torch.empty_like(lse), *(torch.empty_like(t)
                                                 for t in (q, k, v))))
    mma_ms = cuda_ms(mma_bwd, warmup=1, iters=5)
    check(mma_bwd() == 0, "flash_swa_bwd_mma: launch failed")
    want = FK.flash_swa_bwd_plain(*(t.float() for t in (q, k, v, out)), lse,
                                  dout.float(), window=window, qc=qc)
    for label, g, w in zip(("dq", "dk", "dv"), mma_grads, want):
        check_close(f"flash_swa_bwd_mma [training: S {TRAIN_SEQ}] {label}",
                    g, w, BWD_TOL_BF16[0],
                    BWD_TOL_BF16[1] * max(1.0, float(w.abs().max())))
    del want, mma_grads
    plain_ms = cuda_ms(lambda: FK.flash_swa_bwd_plain(
        q, k, v, out, lse, dout, window=window, qc=qc), warmup=1, iters=2)
    pairs = band_pairs(TRAIN_SEQ, window)
    flops = 10 * hd * h * pairs
    executed = bwd_wgmma_executed_flop(TRAIN_SEQ, window, h, hd)
    mma_executed = bwd_mma_executed_flop(TRAIN_SEQ, window, h, hkv, hd)
    fwd_executed = wgmma_executed_flop(TRAIN_SEQ, window, h, hd)
    mma_fwd_executed = mma_executed_flop(TRAIN_SEQ, window, h, hd)
    nbytes = (2 * TRAIN_SEQ * hd * (3 * h + 2 * hkv)     # q, out, dout, k, v
              + 4 * h * TRAIN_SEQ                        # lse
              + 2 * TRAIN_SEQ * hd * (h + 2 * hkv))      # dq, dk, dv
    bound_ops = flops / RL.PEAK_FLOPS_BF16 * 1e3
    bound_bytes = nbytes / RL.HBM_BW * 1e3
    bound = max(bound_ops, bound_bytes)
    bound_by = "operations" if bound_ops >= bound_bytes else "bytes"

    # the library call: SDPA with the band mask, its backward alone (the
    # forward's graph kept) and forward plus backward
    i = torch.arange(TRAIN_SEQ, device=DEVICE)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    call, backend = sdpa_call(*leaves, band)
    library_ms = fwd_bwd_ms = None
    try:
        lib_out = call()
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True), warmup=1, iters=3)
        fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            call(), leaves, dout), warmup=1, iters=3)
        lib_grads = torch.autograd.grad(lib_out, leaves, dout)
        got = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window,
                               qc=qc)
        diffs = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(lib_grads, got)]
        log(f"sdpa ({backend}) backward vs flash_swa_bwd [S {TRAIN_SEQ}] "
            f"bf16: max abs diff dq/dk/dv {diffs} (not a check: both "
            f"round to bf16)")
        del lib_out, lib_grads, got
    except RuntimeError as exc:      # a backend that refuses the mask
        log(f"sdpa ({backend}) backward with the band mask refused: "
            f"{str(exc).splitlines()[0][:200]}")
    del band, leaves
    fwd_bound = 4 * hd * h * pairs / RL.PEAK_FLOPS_BF16 * 1e3
    log(f"time flash_swa_bwd [S {TRAIN_SEQ}, {h}/{hkv} heads of {hd}, "
        f"window {window}, bf16, {route}]: {kernel_ms:.4f} ms "
        f"({flops / kernel_ms / 1e9:.1f} TFLOP/s useful; executes "
        f"{executed} flop, {executed / flops:.3f}x, "
        f"{executed / kernel_ms / 1e9:.1f} TFLOP/s executed, "
        f"{bound / kernel_ms:.1%} of the bound); the mma.sync backward at "
        f"the same shape {mma_ms:.4f} ms (executes {mma_executed} flop, "
        f"{mma_executed / mma_ms / 1e9:.1f} TFLOP/s executed, "
        f"{bound / mma_ms:.1%} of the bound); "
        f"bound {bound:.4f} ms by {bound_by} ({pairs} band pairs per head, "
        f"10 hd H pairs = {flops} flop at 989 TFLOP/s bf16 = "
        f"{bound_ops:.4f} ms, at 67 TFLOP/s f32 = "
        f"{flops / F32_FLOP_PER_S * 1e3:.4f} ms; {nbytes} bytes at 3.35 "
        f"TB/s = {bound_bytes:.4f} ms); plain {plain_ms:.3f} ms; library "
        f"{library_ms} ms (scaled_dot_product_attention's backward, "
        f"{backend}, band mask, enable_gqa; forward + backward "
        f"{fwd_bwd_ms} ms)")
    log(f"time flash_swa with lse [S {TRAIN_SEQ}, {h}/{hkv} heads of {hd}, "
        f"window {window}, bf16, {FK.kernel_for(q.dtype, hd)}]: "
        f"{fwd_ms:.4f} ms ({fwd_executed / fwd_ms / 1e9:.1f} TFLOP/s "
        f"executed, {fwd_bound / fwd_ms:.1%} of the bound {fwd_bound:.4f} "
        f"ms); the mma.sync kernel at the same shape {mma_fwd_ms:.4f} ms "
        f"({mma_fwd_executed / mma_fwd_ms / 1e9:.1f} TFLOP/s executed, "
        f"{fwd_bound / mma_fwd_ms:.1%} of the bound)")
    del q, k, v, out, lse, dout
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=bound_by, err=max(errs))


def leaf_close(name: str, got, want, tol: float) -> float:
    """``|got - want| <= tol * max|want|`` everywhere; the max error
    relative to the leaf's largest entry."""
    import torch
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= tol * max(scale, 1e-30),
          f"{name}: max abs err {err} above {tol} x {scale}")
    return err / max(scale, 1e-30)


def phase_train_consistency(cfg, seed: int):
    """``loss_and_grads`` at full width, depth cut to ``CONSIST_LAYERS``,
    float32, one ``TRAIN_SEQ``-token sequence: through K7 and its backward
    (twice, for the same bits) and through the plain version under
    autograd; returns the depth-cut config, its parameters and the
    batch."""
    import torch
    from repro_torch.data.synthetic import batch_at, for_model
    from repro_torch.kernels.flash_swa import kernel as FK
    from repro_torch.models import layers as LYR
    from repro_torch.models.lm import init_params, tree_leaves
    from repro_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(cfg, num_layers=CONSIST_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    params, _ = init_params(cfg, gen, device=DEVICE)
    batch = batch_at(for_model(cfg, seq_len=TRAIN_SEQ, global_batch=1,
                               seed=seed), 0, cfg, device=DEVICE)
    f32 = torch.float32
    reset_all_counts()
    (loss, _, grads), secs = wall_s(lambda: loss_and_grads(
        params, cfg, batch, 1, f32))
    want_counts = dict(flash_swa=2 * cfg.num_layers,
                       flash_swa_bwd=cfg.num_layers, **k7_routes(0, 0))
    counts = {k: all_counts()[k] for k in want_counts}
    check(counts == want_counts,
          f"train consistency: launches {counts}, expected {want_counts} "
          f"(forward + remat recompute, backward, a layer; float32 on the "
          f"CUDA-core backward)")
    loss2, _, grads2 = loss_and_grads(params, cfg, batch, 1, f32)
    same = torch.equal(loss, loss2) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(grads),
                                                    tree_leaves(grads2)))
    check(same, "train consistency: two backwards differ")
    log("determinism loss_and_grads [Danube x 2 layers, f32]: two runs "
        "bitwise equal (loss and every gradient leaf)")
    del grads2
    original = LYR.flash_swa_gqa

    def plain_attention(q, k, v, *, window, qc):
        return FK.flash_swa_plain(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=window, qc=qc)

    LYR.flash_swa_gqa = plain_attention
    try:
        reset_all_counts()
        want_loss, _, want = loss_and_grads(params, cfg, batch, 1, f32)
        check(all_counts()["flash_swa"] == 0,
              "train consistency: the plain run launched K7")
    finally:
        LYR.flash_swa_gqa = original
    check(abs(float(loss) - float(want_loss))
          <= TRAIN_LOSS_RTOL * abs(float(want_loss)),
          f"train consistency: loss {float(loss)!r} vs plain "
          f"{float(want_loss)!r}")
    worst = max(leaf_close(f"train consistency grad {path}", g,
                           dict(tree_leaves(want))[path], TRAIN_GRAD_TOL)
                for path, g in tree_leaves(grads))
    log(f"consistency train {cfg.name} x {cfg.num_layers} layers (f32, S "
        f"{TRAIN_SEQ}): loss {float(loss)!r} vs plain {float(want_loss)!r};"
        f" every gradient leaf within {worst:.3e} of its largest entry "
        f"(limit {TRAIN_GRAD_TOL}); launches {counts}; {secs:.2f} s")
    del grads, want
    return cfg, params, batch


def phase_checkpoint(cfg, params, batch) -> None:
    """One train step of the depth-cut model, then ``checkpoint.save``
    and ``restore_latest`` through a temporary directory: bitwise."""
    import torch
    from repro_torch.models.lm import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    opt = init_opt_state(params)
    step = make_train_step(cfg, OptConfig(warmup_steps=1),
                           dtype=torch.float32)
    params, opt, _ = step(params, opt, batch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        _, save_s = wall_s(lambda: ckpt.save(d, 1, params, opt,
                                             extra={"arch": cfg.name}))
        (got_p, got_o, meta), load_s = wall_s(
            lambda: ckpt.restore_latest(d, params, opt))
        nbytes = os.path.getsize(os.path.join(d, "step_1", "arrays.npz"))
    check(meta["step"] == 1 and meta["arch"] == cfg.name,
          f"checkpoint: meta {meta}")
    for want, got in ((params, got_p), (opt, got_o)):
        got = dict(tree_leaves(got))
        for path, leaf in tree_leaves(want):
            check(got[path].device == leaf.device
                  and torch.equal(got[path], leaf),
                  f"checkpoint: {path} differs after the round trip")
    log(f"checkpoint {cfg.name} x {cfg.num_layers} layers: params and "
        f"AdamW state ({nbytes / 2**30:.2f} GiB) saved in {save_s:.1f} s, "
        f"restored in {load_s:.1f} s, bitwise equal")


def phase_train(cfg, seed: int, profile: bool) -> tuple:
    """Path D: ``launch.train``'s loop (``make_train_step`` +
    ``synthetic.batch_at``) at full width and depth; returns the K7
    launches of the steps and their e2e seconds."""
    import torch
    from repro_torch.data.synthetic import batch_at, for_model
    from repro_torch.launch import roofline as RL
    from repro_torch.models.lm import init_params, param_count, tree_leaves
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 12)
    (params, _), init_s = wall_s(lambda: init_params(cfg, gen,
                                                     device=DEVICE))
    opt = init_opt_state(params)
    # a strided sample of every leaf, to show that each one moved
    samples = {path: leaf.reshape(-1)[::max(1, leaf.numel() // 4096)]
               .clone() for path, leaf in tree_leaves(params)}
    step = make_train_step(cfg, OptConfig(warmup_steps=1),
                           num_microbatches=TRAIN_MICRO,
                           dtype=torch.bfloat16)
    dcfg = for_model(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                     seed=seed)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # a layer a microbatch: the forward and its remat recompute, then the
    # backward
    per_layer = cfg.num_layers * TRAIN_MICRO
    per_step = dict(flash_swa=2 * per_layer, flash_swa_bwd=per_layer,
                    **k7_routes(2 * per_layer, per_layer))
    totals = {name: 0 for name in per_step}
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        batch = batch_at(dcfg, i, cfg, device=DEVICE)
        reset_all_counts()
        (params, opt, m), secs = wall_s(lambda: step(params, opt, batch))
        counts = {k: all_counts()[k] for k in per_step}
        check(counts == per_step,
              f"train step {i + 1}: launches {counts}, expected {per_step}")
        for name in totals:
            totals[name] += counts[name]
        metrics = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(v) for v in metrics.values()),
              f"train step {i + 1}: non-finite metrics {metrics}")
        times.append(secs)
        losses.append(metrics["loss"])
        log(f"train step {i + 1}: loss {metrics['loss']!r}, grad_norm "
            f"{metrics['grad_norm']!r}, lr {metrics['lr']!r}, "
            f"{secs * 1e3:.1f} ms, launches {counts}")
    peak = (torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0)
    check(int(opt["step"]) == TRAIN_STEPS,
          f"train: optimizer step {int(opt['step'])}")
    for path, leaf in tree_leaves(params):
        check(bool(torch.isfinite(leaf).all()), f"train: {path} not finite")
        now = leaf.reshape(-1)[::max(1, leaf.numel() // 4096)]
        check(not torch.equal(now, samples[path]),
              f"train: {path} did not change")
    MEASURED["train_peak"] = peak
    step_s = statistics.median(times[1:] or times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = param_count(cfg)
    n_matmul = n_params - cfg.padded_vocab * cfg.d_model   # no embed table
    attn = (12 * cfg.num_layers * cfg.num_heads * cfg.resolved_head_dim
            * band_pairs(TRAIN_SEQ, cfg.sliding_window) * TRAIN_BATCH)
    model_flop = int(RL.model_flops(cfg, train_case(), n_matmul)) + attn
    share = model_flop / step_s / RL.PEAK_FLOPS_BF16
    log(f"train {cfg.name}: {cfg.num_layers} layers at full width "
        f"({n_params} parameters, float32 master weights and AdamW state), "
        f"S {TRAIN_SEQ}, global batch {TRAIN_BATCH} in {TRAIN_MICRO} "
        f"microbatches, bf16 compute, remat; {TRAIN_STEPS} steps, losses "
        f"{losses}; {step_s * 1e3:.1f} ms a step (median of steps 2-"
        f"{TRAIN_STEPS}; step 1 {times[0] * 1e3:.1f} ms), "
        f"{tokens / step_s:.0f} tokens/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; model flop {model_flop} a step = 6 x "
        f"{n_matmul} (parameters less the embedding table) x {tokens} "
        f"tokens + 12 L H hd pairs B = {attn} (attention's band, forward "
        f"and backward), {model_flop / step_s / 1e12:.1f} TFLOP/s = "
        f"{share:.3f} of the {RL.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16 "
        f"peak (roofline.PEAK_FLOPS_BF16); init {init_s:.1f} s")
    log("train launches: " + json.dumps(totals))
    e2e = {f"train step[{cfg.name}, S {TRAIN_SEQ}, batch {TRAIN_BATCH}]":
           step_s}
    if profile:
        batch = batch_at(dcfg, TRAIN_STEPS, cfg, device=DEVICE)
        phase_profile([(f"train step[{cfg.name}, S {TRAIN_SEQ}, batch "
                        f"{TRAIN_BATCH}]", lambda: step(params, opt,
                                                        batch))])
    del params, opt, samples
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return totals, e2e


def train_case():
    """Phase 24's cell: S 8,192, global batch 2 (``configs.ShapeCase``)."""
    from repro_torch.configs import ShapeCase
    return ShapeCase(f"train_{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")


def run_slice10(seed: int, profile: bool) -> tuple:
    """Path D end to end: ``(K7 backward row, main-path launches, e2e
    seconds)``."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    row = phase_swa_bwd(cfg, seed)
    cut, params, batch = phase_train_consistency(cfg, seed)
    phase_checkpoint(cut, params, batch)
    del params, batch
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    launches, e2e = phase_train(cfg, seed, profile)
    return row, launches, e2e


# ---------------------------------------------------------------------------
# the LM on a (data, model) mesh
# ---------------------------------------------------------------------------

def mesh_one_device(cfg, seed: int, shape: tuple, warmup: int = 1) -> list:
    """The mesh phase's training steps on one device in this process, at
    ``shape`` (``MESH_SHAPE``, ``MOE_MESH_SHAPE``) with ``warmup`` steps of
    learning-rate warmup: the metrics of each step (the ranks are held to
    them)."""
    import torch
    from repro_torch.data.synthetic import batch_at, for_model
    from repro_torch.models.lm import init_params
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    seq, batch_size, micro, steps = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    params, _ = init_params(cfg, gen, device=DEVICE)
    opt = init_opt_state(params)
    step = make_train_step(cfg, OptConfig(warmup_steps=warmup),
                           num_microbatches=micro, dtype=torch.bfloat16)
    dcfg = for_model(cfg, seq_len=seq, global_batch=batch_size, seed=seed)
    out = []
    for i in range(steps):
        batch = batch_at(dcfg, i, cfg, device=DEVICE)
        (params, opt, m), secs = wall_s(lambda: step(params, opt, batch))
        out.append(({k: float(v) for k, v in m.items()}, secs))
    del params, opt
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_train(mesh, cfg, seed: int, shape: tuple, warmup: int = 1) -> dict:
    """One rank's part of the sharded training steps on ``mesh`` at
    ``shape`` and ``warmup`` (as :func:`mesh_one_device`'s): each
    step's metrics, time, kernel launches (K7's a layer a microbatch on
    this rank's heads; none of the port's in the MoE cell, whose attention
    has no window and whose experts run ``grouped``) and collectives, in
    all and by kind; then every leaf changed (this rank's block) and
    finite (gathered whole)."""
    import torch
    from repro_torch.data.synthetic import batch_at, for_model
    from repro_torch.models.lm import init_params, tree_leaves
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.step import (make_train_step, param_specs,
                                        shardings_for)

    dev = mesh.device
    psh = shardings_for(mesh, param_specs(cfg))
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    params, _ = init_params(cfg, gen, device=dev, shardings=psh)
    opt = init_opt_state(params)
    samples = {path: leaf.reshape(-1)[::max(1, leaf.numel() // 4096)]
               .clone() for path, leaf in tree_leaves(params)}
    seq, batch_size, micro, n_steps = shape
    moe = cfg.family == "moe"
    step = make_train_step(cfg, OptConfig(warmup_steps=warmup), mesh,
                           num_microbatches=micro, dtype=torch.bfloat16)
    dcfg = for_model(cfg, seq_len=seq, global_batch=batch_size, seed=seed)
    # a layer a microbatch where the band runs (on this rank's block of
    # heads): the forward and its remat recompute, then the backward, all
    # on the tensor cores; none without a window (RWKV6, OLMoE)
    banded = bool(cfg.swa_banded and cfg.sliding_window
                  and seq > cfg.attn_query_chunk + cfg.sliding_window)
    per_layer = cfg.num_layers * micro if banded else 0
    per_step = dict(flash_swa=2 * per_layer, flash_swa_bwd=per_layer,
                    **k7_routes(2 * per_layer, per_layer))
    if moe:
        per_step.update(segmented_matmul=0, segmented_matmul_chunked=0)
    tag = ("moe mesh" if moe else "ssm mesh"
           if cfg.family in ("ssm", "hybrid") else "lm mesh")
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for i in range(n_steps):
        batch = batch_at(dcfg, i, cfg, device=dev)
        reset_all_counts()
        mesh.stats.reset()
        (params, opt, m), secs = wall_s(lambda: step(params, opt, batch))
        counts = {k: all_counts()[k] for k in per_step}
        check(counts == per_step, f"{tag} rank {mesh.rank} step {i + 1}: "
              f"launches {counts}, expected {per_step}")
        metrics = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(v) for v in metrics.values()),
              f"{tag} rank {mesh.rank} step {i + 1}: non-finite "
              f"{metrics}")
        steps.append(dict(metrics=metrics, secs=secs, counts=counts,
                          calls=mesh.stats.calls, bytes=mesh.stats.bytes,
                          coll_s=mesh.stats.seconds,
                          kinds={f"{k}@{n}": list(v) for (k, n), v
                                 in mesh.stats.kinds.items()}))
    peak = torch.cuda.max_memory_allocated(dev) if DEVICE == "cuda" else 0
    check(int(opt["step"]) == n_steps,
          f"{tag} rank {mesh.rank}: optimizer step {int(opt['step'])}")
    shardings = dict(tree_leaves(psh))
    for path, leaf in tree_leaves(params):
        now = leaf.reshape(-1)[::max(1, leaf.numel() // 4096)]
        check(not torch.equal(now, samples[path]),
              f"{tag} rank {mesh.rank}: {path} did not change")
        whole = shardings[path].gather(leaf)
        check(bool(torch.isfinite(whole).all()),
              f"{tag}: {path} (gathered) not finite")
        del whole
    return dict(steps=steps, peak=peak, local_bytes=sum(
        t.numel() * t.element_size() for tree in (params, opt["mu"],
                                                  opt["nu"])
        for _, t in tree_leaves(tree)))


def mesh_f32_and_checkpoint(mesh, cfg, seed: int, ckpt_dir: str) -> dict:
    """The float32 parity check of ``loss_and_grads`` on ``mesh`` against
    one device (rank 0 computes it), one float32 train step, then a
    checkpoint saved from ``mesh``, restored onto ``(1, world)`` and
    gathered back (bitwise, leaf by leaf)."""
    import torch
    from repro_torch.data.synthetic import batch_at, for_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import init_params, tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.step import (loss_and_grads, make_train_step,
                                        opt_shardings, param_specs,
                                        shardings_for)

    dev = mesh.device
    f32 = torch.float32
    psh = shardings_for(mesh, param_specs(cfg))
    draw = lambda sh: init_params(cfg, torch.Generator(device=dev)
                                  .manual_seed(seed + 14), device=dev,
                                  shardings=sh)[0]
    params = draw(psh)
    batch = batch_at(for_model(cfg, seq_len=MESH_F32_S, global_batch=2,
                               seed=seed), 0, cfg, device=dev)
    reset_all_counts()
    (loss, _, grads), secs = wall_s(lambda: loss_and_grads(
        params, cfg, batch, 1, f32, mesh=mesh))
    counts = {k: all_counts()[k] for k in ("flash_swa", "flash_swa_bwd")}
    want_counts = dict(flash_swa=2 * cfg.num_layers,
                       flash_swa_bwd=cfg.num_layers)
    check(counts == want_counts, f"lm mesh f32 rank {mesh.rank}: launches "
          f"{counts}, expected {want_counts}")
    out = dict(f32_secs=secs, f32_counts=counts)
    want = want_loss = None
    if mesh.rank == 0:
        full = draw(None)
        want_loss, _, want = loss_and_grads(full, cfg, batch, 1, f32)
        want = dict(tree_leaves(want))
        del full
    shardings = dict(tree_leaves(psh))
    worst = 0.0
    for path, g in tree_leaves(grads):
        whole = shardings[path].gather(g)
        if want is not None:
            worst = max(worst, leaf_close(f"lm mesh f32 grad {path}", whole,
                                          want[path], TRAIN_GRAD_TOL))
    if mesh.rank == 0:
        check(abs(float(loss) - float(want_loss))
              <= TRAIN_LOSS_RTOL * abs(float(want_loss)),
              f"lm mesh f32: loss {float(loss)!r} vs one device "
              f"{float(want_loss)!r}")
        out.update(f32_loss=(float(loss), float(want_loss)), f32_worst=worst)
    del grads, want

    osh = opt_shardings(mesh, psh)
    opt = init_opt_state(params)
    step = make_train_step(cfg, OptConfig(warmup_steps=1), mesh, dtype=f32)
    params, opt, _ = step(params, opt, batch)
    _, save_s = wall_s(lambda: ckpt.save(ckpt_dir, 1, params, opt,
                                         param_sh=psh, opt_sh=osh))
    other = make_host_mesh(mesh.size, device=DEVICE)            # (1, 4)
    psh2 = shardings_for(other, param_specs(cfg))
    osh2 = opt_shardings(other, psh2)
    (p2, o2, meta), load_s = wall_s(lambda: ckpt.restore(
        ckpt_dir, 1, params, opt, param_sh=psh2, opt_sh=osh2))
    same = meta["step"] == 1
    for (tree, sh), (tree2, sh2) in (((params, psh), (p2, psh2)),
                                     ((opt, osh), (o2, osh2))):
        sh, sh2, tree2 = (dict(tree_leaves(t)) for t in (sh, sh2, tree2))
        for path, leaf in tree_leaves(tree):
            a, b = sh[path].gather(leaf), sh2[path].gather(tree2[path])
            same = same and a.dtype == b.dtype and torch.equal(a, b)
    check(same, f"lm mesh rank {mesh.rank}: the checkpoint saved on "
          f"{mesh.shape} and restored onto {other.shape} differs")
    out.update(ckpt_save_s=save_s, ckpt_load_s=load_s,
               ckpt_meshes=(mesh.shape, other.shape),
               ckpt_bytes=os.path.getsize(os.path.join(
                   ckpt_dir, "step_1", "arrays.npz")))
    return out


def mesh_decode(cfg, seed: int, world: int) -> dict:
    """``make_serve_step`` on a ``(1, world)`` mesh: full depth in
    bfloat16, greedy steps (ids in the vocabulary, logits finite, no K7
    launch); then depth 2 in float32, each step's logits held to one
    device's ``decode_step`` on rank 0."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import (cast_params, decode_step, init_cache,
                                       init_params)
    from repro_torch.serve.decode import make_serve_step, sample_logits

    mesh = make_host_mesh(world, device=DEVICE)                 # (1, 4)
    dev = mesh.device
    bf16 = torch.bfloat16
    step, psh, csh, cache = make_serve_step(
        cfg, mesh, batch=1, seq_len=cfg.sliding_window, dtype=bf16)
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    params = cast_params(init_params(cfg, gen, device=dev,
                                     shardings=psh)[0], bf16)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    reset_all_counts()
    mesh.stats.reset()
    ids, times = [], []
    for t in range(DECODE_STEPS):
        (logits, cache), secs = wall_s(lambda: step(params, tok, t, cache))
        check(bool(torch.isfinite(logits).all()),
              f"lm mesh decode step {t}: non-finite logits")
        tok = sample_logits(None, logits, 0.0, vocab_size=cfg.vocab_size)
        ids.append(int(tok))
        times.append(secs)
    check(all(0 <= i < cfg.vocab_size for i in ids),
          f"lm mesh decode: ids {ids} outside the vocabulary")
    check(all_counts()["flash_swa"] == 0, "lm mesh decode launched K7")
    out = dict(decode_ms=statistics.median(times[1:]) * 1e3,
               decode_first_ms=times[0] * 1e3, decode_ids=ids,
               decode_calls=mesh.stats.calls / DECODE_STEPS,
               decode_bytes=mesh.stats.bytes / DECODE_STEPS,
               decode_coll_ms=mesh.stats.seconds / DECODE_STEPS * 1e3,
               decode_cache=tuple(cache["k"].shape),
               decode_mesh=mesh.shape)
    del params, cache

    cut = dataclasses.replace(cfg, num_layers=2)
    f32 = torch.float32
    step, psh, _, cache = make_serve_step(
        cut, mesh, batch=1, seq_len=cfg.sliding_window, dtype=f32)
    draw = lambda sh: init_params(cut, torch.Generator(device=dev)
                                  .manual_seed(seed + 16), device=dev,
                                  shardings=sh)[0]
    params = draw(psh)
    full = draw(None) if mesh.rank == 0 else None
    plain = (init_cache(cut, 1, cfg.sliding_window, f32, device=dev)
             if full is not None else None)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, MESH_DECODE_CHECK)).astype(np.int32)).to(dev)
    worst = 0.0
    for t in range(MESH_DECODE_CHECK):
        logits, cache = step(params, tokens[:, t:t + 1], t, cache)
        if full is not None:
            want, plain = decode_step(full, cut, tokens[:, t:t + 1], t,
                                      plain, dtype=f32)
            check(torch.allclose(logits, want, rtol=LM_TOL, atol=LM_TOL),
                  f"lm mesh decode f32 step {t}: logits differ from one "
                  f"device's by {max_abs_err(logits, want)}")
            worst = max(worst, max_abs_err(logits, want))
    out.update(decode_f32_worst=worst)
    return out


def mesh_rank_job(world: int, job: dict) -> dict:
    """The mesh phase on one rank: training on the ``(2, 2)`` mesh, the
    float32 parity check and the checkpoint, then decode on ``(1, 4)``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh

    base = get_config(LM_ARCH)
    mesh = make_host_mesh(MESH_MODEL_AXIS, device=DEVICE)
    out = dict(mesh=str(mesh))
    out.update(mesh_train(mesh, dataclasses.replace(
        base, num_layers=MESH_LAYERS), job["seed"], MESH_SHAPE))
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    out.update(mesh_f32_and_checkpoint(mesh, dataclasses.replace(
        base, num_layers=MESH_F32_LAYERS, sliding_window=MESH_F32_WINDOW,
        attn_query_chunk=MESH_F32_WINDOW // 2), job["seed"],
        job["ckpt_dir"]))
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    out.update(mesh_decode(base, job["seed"], world))
    return out


def phase_lm_mesh(cfg, seed: int) -> tuple:
    """The LM on a ``(data, model)`` mesh: the training steps on one
    device first (freed), then four spawned ranks sharing this card in one
    gloo group run :func:`mesh_rank_job`.  Returns the ranks' K7 launches
    in the training steps and the e2e seconds."""
    import torch

    cut = dataclasses.replace(cfg, num_layers=MESH_LAYERS)
    single = mesh_one_device(cut, seed, MESH_SHAPE)
    for i, (m, secs) in enumerate(single):
        log(f"lm mesh one device step {i + 1}: loss {m['loss']!r}, "
            f"grad_norm {m['grad_norm']!r}, {secs * 1e3:.1f} ms")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        ranks, secs = wall_s(lambda: run_shard_ranks(
            MESH_RANKS, dict(seed=seed, ckpt_dir=d), fn="mesh_rank_job",
            timeout_s=MESH_TIMEOUT_S, deadline_s=MESH_DEADLINE_S))
    log(f"lm mesh: {MESH_RANKS} processes on this card in one gloo group, "
        f"{secs:.1f} s in all; four ranks share one card and gloo moves "
        f"CUDA tensors through the host, so these times are the sharded "
        f"path's overhead, not its scaling")
    tokens = MESH_BATCH * TRAIN_SEQ
    totals = dict.fromkeys(K7_COUNTERS, 0)
    e2e = {}
    for r, res in enumerate(ranks):
        for i, (row, (want, _)) in enumerate(zip(res["steps"], single)):
            for key in ("loss", "grad_norm"):
                got = row["metrics"][key]
                check(abs(got - want[key]) <= MESH_RTOL * abs(want[key]),
                      f"lm mesh rank {r} step {i + 1}: {key} {got!r} vs one "
                      f"device {want[key]!r} (rtol {MESH_RTOL})")
            for name in totals:
                totals[name] += row["counts"][name]
        steps = res["steps"]
        step_s = statistics.median([row["secs"] for row in steps[1:]]
                                   or [steps[0]["secs"]])
        last = steps[-1]
        log(f"lm mesh train rank {r} ({res['mesh']}): {cut.name} x "
            f"{cut.num_layers} layers at full width, S {TRAIN_SEQ}, global "
            f"batch {MESH_BATCH} in {MESH_MICRO} microbatches; losses "
            f"{[row['metrics']['loss'] for row in steps]}, grad norms "
            f"{[row['metrics']['grad_norm'] for row in steps]}; "
            f"{step_s * 1e3:.1f} ms a step (median of steps 2-{MESH_STEPS};"
            f" step 1 {steps[0]['secs'] * 1e3:.1f} ms), {tokens / step_s:.0f}"
            f" tokens/s; peak device memory {res['peak'] / 2**30:.2f} GiB "
            f"(its blocks of the weights and AdamW state "
            f"{res['local_bytes'] / 2**30:.2f} GiB); collectives a step "
            f"{last['calls']} calls, {last['bytes'] / 2**20:.1f} MiB, "
            f"{last['coll_s'] * 1e3:.1f} ms; launches a step "
            f"{json.dumps(last['counts'])}")
        if r == 0:
            e2e[f"train step[mesh 2x2, {cut.name} x {cut.num_layers}, S "
                f"{TRAIN_SEQ}, batch {MESH_BATCH}]"] = step_s
    r0 = ranks[0]
    MEASURED["mesh_peak"] = r0["peak"]
    one = statistics.median([s for _, s in single[1:]] or [single[0][1]])
    log(f"lm mesh one device: {one * 1e3:.1f} ms a step (median of steps "
        f"2-{MESH_STEPS}), {tokens / one:.0f} tokens/s; every rank's losses "
        f"and grad norms within {MESH_RTOL} of it")
    loss, want_loss = r0["f32_loss"]
    log(f"lm mesh f32 loss_and_grads ({MESH_F32_LAYERS} layers, S "
        f"{MESH_F32_S}, window {MESH_F32_WINDOW}, 2 sequences, "
        f"{r0['mesh']}): loss {loss!r} vs one device {want_loss!r}; every "
        f"gathered gradient leaf within {r0['f32_worst']:.3e} of its "
        f"largest entry (limit {TRAIN_GRAD_TOL}); launches "
        f"{json.dumps(r0['f32_counts'])} a rank; {r0['f32_secs']:.2f} s")
    before, after = r0["ckpt_meshes"]
    log(f"lm mesh checkpoint: params and AdamW state "
        f"({r0['ckpt_bytes'] / 2**30:.2f} GiB) saved from {before} in "
        f"{r0['ckpt_save_s']:.1f} s, restored onto {after} in "
        f"{r0['ckpt_load_s']:.1f} s, gathered back bitwise equal")
    for r, res in enumerate(ranks):
        check(res["decode_ids"] == r0["decode_ids"],
              f"lm mesh decode: rank {r} sampled other ids")
    log(f"lm mesh decode {cfg.name} x {cfg.num_layers} layers bf16 on "
        f"{r0['decode_mesh']}: cache block {r0['decode_cache']} a rank, "
        f"{DECODE_STEPS} greedy steps, {r0['decode_ms']:.2f} ms a step "
        f"(median; first {r0['decode_first_ms']:.1f} ms), collectives a "
        f"step {r0['decode_calls']:.0f} calls, "
        f"{r0['decode_bytes'] / 2**10:.1f} KiB, {r0['decode_coll_ms']:.2f} "
        f"ms; ids {r0['decode_ids'][:8]}...; float32 x 2 layers: "
        f"{MESH_DECODE_CHECK} steps' logits within "
        f"{r0['decode_f32_worst']:.2e} of one device's (limit {LM_TOL})")
    e2e[f"decode step[mesh 1x{MESH_RANKS}, {cfg.name}, bf16]"] = (
        r0["decode_ms"] / 1e3)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return totals, e2e


# ---------------------------------------------------------------------------
# the GPipe pipeline over ``pod``, and the dry run's estimate
# ---------------------------------------------------------------------------

def pipe_layers(cfg, seed: int, layers, device):
    """Stacked ``params["layers"]`` of ``cfg``'s layers ``layers``, layer
    ``j`` drawn from a seed of its own: a rank draws its stage alone and
    gets the same values as the whole stack drawn in one process."""
    import torch
    from repro_torch.models.lm import init_params, tree_map
    one = dataclasses.replace(cfg, num_layers=1)
    drawn = []
    for j in layers:
        gen = torch.Generator(device=device).manual_seed(seed * 1009 + j)
        drawn.append(init_params(one, gen, device=device)[0]["layers"])
    return tree_map(lambda *ls: torch.cat(ls), *drawn)


def pipe_inputs(cfg, seed: int, s: int, device, dtype):
    """``xs``: ``PIPE_MICRO`` microbatches of one sequence ``[1, s,
    d_model]``, the same on every rank."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 15)
    return torch.randn((PIPE_MICRO, 1, s, cfg.d_model), generator=gen,
                       device=device).to(dtype)


def pipe_step(apply, params, xs):
    """One training step's forward and backward through ``apply``:
    ``(loss, y)`` with the loss ``mean(y.float()**2)``; the stage
    gradients in ``.grad``."""
    from repro_torch.models.lm import tree_leaves
    for _, p in tree_leaves(params):
        p.grad = None
    y = apply(params, xs)
    loss = (y.float() ** 2).mean()
    loss.backward()
    return loss.detach(), y.detach()


def pipe_counts(ticks: int, layers: int, bf16: bool) -> dict:
    """K7 launches of one step: a layer a tick, forward and remat
    recompute, then the backward; in bf16 all on the wgmma kernels."""
    out = dict(flash_swa=2 * ticks * layers, flash_swa_bwd=ticks * layers)
    if bf16:
        out.update(k7_routes(2 * ticks * layers, ticks * layers))
    return out


def pipe_sequential(cfg, seed: int) -> dict:
    """The pipeline phase's steps run sequentially on one device in this
    process (``reference_apply`` over every stage): ms a step, launches,
    peak memory."""
    import torch
    from repro_torch.models.lm import tree_map
    from repro_torch.train.pipeline import (block_stage_fn, reference_apply,
                                            split_stages)

    full = pipe_layers(cfg, seed, range(cfg.num_layers), DEVICE)
    params = tree_map(lambda a: a.detach().requires_grad_(),
                      split_stages(full, PIPE_RANKS))
    del full
    xs = pipe_inputs(cfg, seed, TRAIN_SEQ, DEVICE, torch.bfloat16)
    stage_fn = block_stage_fn(cfg, TRAIN_SEQ)
    apply = lambda p, x: reference_apply(stage_fn, p, x, PIPE_RANKS)
    want = pipe_counts(PIPE_MICRO, cfg.num_layers, True)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(PIPE_STEPS):
        reset_all_counts()
        (loss, _), secs = wall_s(lambda: pipe_step(apply, params, xs))
        counts = {k: all_counts()[k] for k in want}
        check(counts == want, f"pipeline one device step {i + 1}: launches "
              f"{counts}, expected {want}")
        times.append(secs)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    del params, xs
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return dict(times=times, losses=losses, counts=want, peak=peak)


def pipe_train(mesh, cfg, seed: int) -> dict:
    """One rank's part of the pipeline's bf16 training steps: its stage's
    float32 weights, each step's loss, time, launches, hops and
    broadcast; every leaf of its gradient finite and nonzero."""
    import torch
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.train.pipeline import (block_stage_fn,
                                            make_pipeline_apply)

    dev, world = mesh.device, mesh.axis_size("pod")
    stage, per = mesh.coord("pod"), cfg.num_layers // world
    mine = pipe_layers(cfg, seed, range(stage * per, (stage + 1) * per), dev)
    params = tree_map(lambda a: a[None].detach().requires_grad_(), mine)
    del mine
    xs = pipe_inputs(cfg, seed, TRAIN_SEQ, dev, torch.bfloat16)
    apply = make_pipeline_apply(block_stage_fn(cfg, TRAIN_SEQ), mesh, world,
                                PIPE_MICRO)
    ticks = PIPE_MICRO + world - 1
    want = pipe_counts(ticks, per, True)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for i in range(PIPE_STEPS):
        reset_all_counts()
        mesh.stats.reset()
        (loss, _), secs = wall_s(lambda: pipe_step(apply, params, xs))
        counts = {k: all_counts()[k] for k in want}
        check(counts == want, f"pipeline rank {mesh.rank} step {i + 1}: "
              f"launches {counts}, expected {want}")
        check(math.isfinite(float(loss)), f"pipeline rank {mesh.rank} step "
              f"{i + 1}: loss {float(loss)}")
        kinds = mesh.stats.kinds
        hop = kinds.get(("collective-permute", world), [0, 0, 0.0])
        out = kinds.get(("broadcast", world), [0, 0, 0.0])
        steps.append(dict(loss=float(loss), secs=secs, counts=counts,
                          hop=list(hop), out=list(out)))
    for path, p in tree_leaves(params):
        check(bool(torch.isfinite(p.grad).all()),
              f"pipeline rank {mesh.rank}: {path}'s gradient not finite")
        check(bool((p.grad != 0).any()),
              f"pipeline rank {mesh.rank}: {path}'s gradient is zero")
    peak = torch.cuda.max_memory_allocated(dev) if DEVICE == "cuda" else 0
    return dict(steps=steps, peak=peak, ticks=ticks)


def pipe_f32(mesh, cfg, seed: int) -> dict:
    """The float32 parity check: the pipeline's output and every stage's
    gradient, gathered, on rank 0 against ``reference_apply`` on one
    device."""
    import torch
    from repro_torch.launch.mesh import NamedSharding
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.train.pipeline import (block_stage_fn,
                                            make_pipeline_apply,
                                            reference_apply, split_stages)

    dev, world = mesh.device, mesh.axis_size("pod")
    stage, f32 = mesh.coord("pod"), torch.float32
    params = tree_map(lambda a: a[None].detach().requires_grad_(),
                      pipe_layers(cfg, seed + 1, [stage], dev))
    xs = pipe_inputs(cfg, seed + 1, PIPE_F32_S, dev, f32)
    stage_fn = block_stage_fn(cfg, PIPE_F32_S)
    apply = make_pipeline_apply(stage_fn, mesh, world, PIPE_MICRO)
    reset_all_counts()
    (loss, y), secs = wall_s(lambda: pipe_step(apply, params, xs))
    counts = {k: all_counts()[k] for k in ("flash_swa", "flash_swa_bwd")}
    want_counts = pipe_counts(PIPE_MICRO + world - 1, 1, False)
    check(counts == want_counts, f"pipeline f32 rank {mesh.rank}: launches "
          f"{counts}, expected {want_counts}")
    by_stage = NamedSharding(mesh, ("pod",))
    grads = {path: by_stage.gather(p.grad) for path, p in tree_leaves(params)}
    out = dict(f32_secs=secs, f32_counts=counts)
    if mesh.rank == 0:
        full = tree_map(lambda a: a.detach().requires_grad_(), split_stages(
            pipe_layers(cfg, seed + 1, range(world), dev), world))
        want_y = reference_apply(stage_fn, full, xs, world)
        (want_y.float() ** 2).mean().backward()
        out["f32_out_err"] = check_close("pipeline f32 output", y,
                                         want_y.detach(), PIPE_OUT_TOL)
        out["f32_loss"] = (float(loss),
                           float((want_y.detach().float() ** 2).mean()))
        worst = 0.0
        for path, p in tree_leaves(full):
            worst = max(worst, leaf_close(f"pipeline f32 grad {path}",
                                          grads[path], p.grad,
                                          TRAIN_GRAD_TOL))
        out["f32_worst"] = worst
    return out


def pipe_rank_job(world: int, job: dict) -> dict:
    """The pipeline phase on one rank of the ``(pod, data) = (world, 1)``
    mesh: the bf16 training steps, then the float32 parity check."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh

    base = get_config(LM_ARCH)
    mesh = make_mesh((world, 1), ("pod", "data"), device=DEVICE)
    out = dict(mesh=str(mesh), backend=mesh.backend)
    out.update(pipe_train(mesh, dataclasses.replace(
        base, num_layers=PIPE_LAYERS), job["seed"]))
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    out.update(pipe_f32(mesh, dataclasses.replace(
        base, num_layers=PIPE_F32_LAYERS, sliding_window=PIPE_F32_WINDOW,
        attn_query_chunk=PIPE_F32_WINDOW // 2), job["seed"]))
    return out


def phase_pipeline(cfg, seed: int) -> tuple:
    """The GPipe pipeline (``train/pipeline.py``) over four spawned ranks
    sharing this card in one gloo group, its stages Danube blocks at full
    width; the same layers run sequentially on one device first.  Returns
    the ranks' K7 launches and the e2e seconds."""
    import torch

    cut = dataclasses.replace(cfg, num_layers=PIPE_LAYERS)
    one = pipe_sequential(cut, seed)
    one_s = statistics.median(one["times"][1:] or one["times"])
    log(f"pipeline one device: {cut.name} x {PIPE_LAYERS} layers at full "
        f"width, {PIPE_MICRO} microbatches of S {TRAIN_SEQ}, bf16 compute "
        f"from float32 weights, remat, run in order (reference_apply); "
        f"losses {one['losses']}; {one_s * 1e3:.1f} ms a step (median of "
        f"steps 2-{PIPE_STEPS}; step 1 {one['times'][0] * 1e3:.1f} ms); "
        f"peak device memory {one['peak'] / 2**30:.2f} GiB; launches a step "
        f"{json.dumps(one['counts'])}")
    ranks, secs = wall_s(lambda: run_shard_ranks(
        PIPE_RANKS, dict(seed=seed), fn="pipe_rank_job",
        timeout_s=PIPE_TIMEOUT_S, deadline_s=PIPE_DEADLINE_S))
    ticks = ranks[0]["ticks"]
    MEASURED["pipe_peaks"] = [res["peak"] for res in ranks]
    log(f"pipeline: {PIPE_RANKS} processes on this card in one gloo group "
        f"({ranks[0]['mesh']}), {secs:.1f} s in all; four stages share one "
        f"card and each hop goes through host memory, so these times are "
        f"the pipeline's overhead, not its scaling")
    totals = dict.fromkeys(K7_COUNTERS, 0)
    e2e = {}
    for r, res in enumerate(ranks):
        steps = res["steps"]
        for i, row in enumerate(steps):
            check(abs(row["loss"] - one["losses"][i])
                  <= MESH_RTOL * abs(one["losses"][i]),
                  f"pipeline rank {r} step {i + 1}: loss {row['loss']!r} vs "
                  f"one device {one['losses'][i]!r} (rtol {MESH_RTOL})")
            for name in totals:
                totals[name] += row["counts"][name]
        step_s = statistics.median([row["secs"] for row in steps[1:]]
                                   or [steps[0]["secs"]])
        last = steps[-1]
        hop_calls, hop_bytes, hop_s = last["hop"]
        log(f"pipeline rank {r} (stage {r}, {PIPE_LAYERS // PIPE_RANKS} "
            f"layers): losses {[row['loss'] for row in steps]}; "
            f"{step_s * 1e3:.1f} ms a step (median of steps 2-{PIPE_STEPS}; "
            f"step 1 {steps[0]['secs'] * 1e3:.1f} ms); T = {ticks} ticks, "
            f"bubble share (P-1)/T = {(PIPE_RANKS - 1) / ticks:.3f}; hops a "
            f"step {hop_calls} calls, {hop_bytes / 2**20:.1f} MiB sent, "
            f"{hop_s * 1e3:.1f} ms; output broadcast {last['out'][0]} call, "
            f"{last['out'][1] / 2**20:.1f} MiB, {last['out'][2] * 1e3:.1f} "
            f"ms; peak device memory {res['peak'] / 2**30:.2f} GiB; launches "
            f"a step {json.dumps(last['counts'])}")
        if r == 0:
            e2e[f"pipeline step[{PIPE_RANKS} stages on one card, {cut.name} "
                f"x {PIPE_LAYERS}, {PIPE_MICRO} x S {TRAIN_SEQ}]"] = step_s
    e2e[f"pipeline step[one device, {cut.name} x {PIPE_LAYERS}, "
        f"{PIPE_MICRO} x S {TRAIN_SEQ}]"] = one_s
    r0 = ranks[0]
    loss, want_loss = r0["f32_loss"]
    log(f"pipeline f32 ({PIPE_F32_LAYERS} layers, one a stage, S "
        f"{PIPE_F32_S}, window {PIPE_F32_WINDOW}, {PIPE_MICRO} "
        f"microbatches): output within {r0['f32_out_err']!r} of "
        f"reference_apply on one device (limit {PIPE_OUT_TOL}), loss "
        f"{loss!r} vs {want_loss!r}; every gathered stage gradient leaf "
        f"within {r0['f32_worst']:.3e} of its largest entry (limit "
        f"{TRAIN_GRAD_TOL}); launches {json.dumps(r0['f32_counts'])} a rank; "
        f"{r0['f32_secs']:.2f} s")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return totals, e2e


# ---------------------------------------------------------------------------
# expert parallelism: the MoE configs on the (data, model) mesh
# ---------------------------------------------------------------------------

def arch_cfg(name: str, layers: int = None, **over):
    """``name``'s config at full width, ``layers`` deep (its own depth
    when ``None``), with ``over``."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                               **over)


def counted(fn):
    """``(fn(), the segmm launches it made)``: K5, K6 and those of them
    that ran on each tensor-core route."""
    before = {k: all_counts()[k] for k in ("segmented_matmul",
                                           "segmented_matmul_chunked",
                                           *SEGMM_ROUTES)}
    out = fn()
    return out, {k: all_counts()[k] - v for k, v in before.items()}


def moe_f32(mesh, seed: int) -> dict:
    """The float32 parity of ``loss_and_grads`` on ``mesh`` against one
    device's on rank 0, depth 2 at full width: OLMoE with ``grouped`` and
    with ``capacity``, and DeepSeek-MoE.  Every gathered gradient leaf is
    held to one device's, and the router's gradient (copied on every
    rank) on each rank of ``model``."""
    import torch
    from repro_torch.data.synthetic import batch_at, for_model
    from repro_torch.models.lm import init_params, tree_leaves
    from repro_torch.train.step import (loss_and_grads, param_specs,
                                        shardings_for)

    dev, f32 = mesh.device, torch.float32
    out = {}
    for label, cfg in (
            ("olmoe grouped", arch_cfg(MOE_MESH_ARCH, 2)),
            ("olmoe capacity", arch_cfg(MOE_MESH_ARCH, 2,
                                       moe_dispatch="capacity")),
            ("deepseek grouped", arch_cfg(MOE_PARITY_ARCH, 2))):
        psh = shardings_for(mesh, param_specs(cfg))
        draw = lambda sh: init_params(cfg, torch.Generator(device=dev)
                                      .manual_seed(seed + 17), device=dev,
                                      shardings=sh)[0]
        params = draw(psh)
        batch = batch_at(for_model(cfg, seq_len=MOE_MESH_F32_S,
                                   global_batch=2, seed=seed), 0, cfg,
                         device=dev)
        (loss, _, grads), secs = wall_s(lambda: loss_and_grads(
            params, cfg, batch, 1, f32, mesh=mesh))
        routers = mesh.all_gather(grads["layers"]["moe"]["router"][None],
                                  "model")
        want = want_loss = None
        if mesh.rank == 0:
            full = draw(None)
            want_loss, _, want = loss_and_grads(full, cfg, batch, 1, f32)
            want = dict(tree_leaves(want))
            del full
        shardings = dict(tree_leaves(psh))
        worst = 0.0
        for path, g in tree_leaves(grads):
            whole = shardings[path].gather(g)
            if want is not None:
                worst = max(worst, leaf_close(f"moe mesh f32 {label} grad "
                                              f"{path}", whole, want[path],
                                              TRAIN_GRAD_TOL))
        res = dict(secs=secs, mesh=str(mesh))
        if mesh.rank == 0:
            for m in range(routers.shape[0]):
                worst = max(worst, leaf_close(
                    f"moe mesh f32 {label} router grad on model rank {m}",
                    routers[m], want["/layers/moe/router"], TRAIN_GRAD_TOL))
            check(abs(float(loss) - float(want_loss))
                  <= TRAIN_LOSS_RTOL * abs(float(want_loss)),
                  f"moe mesh f32 {label}: loss {float(loss)!r} vs one "
                  f"device {float(want_loss)!r}")
            res.update(loss=(float(loss), float(want_loss)), worst=worst)
        out[label] = res
        del params, grads, want, routers
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


def moe_decode(mesh, seed: int) -> dict:
    """``make_serve_step`` on ``mesh``: OLMoE at full width and depth in
    bfloat16 (each rank draws its blocks), greedy steps (ids in the
    vocabulary, logits finite); then depth 2 in float32 with each
    dispatch, each step's logits held to one device's ``decode_step`` on
    rank 0."""
    import numpy as np
    import torch
    from repro_torch.models.lm import (cast_params, decode_step, init_cache,
                                       init_params)
    from repro_torch.serve.decode import make_serve_step, sample_logits

    dev, bf16, f32 = mesh.device, torch.bfloat16, torch.float32
    cfg = arch_cfg(MOE_MESH_ARCH)
    step, psh, _, cache = make_serve_step(
        cfg, mesh, batch=MOE_SERVE_BATCH, seq_len=MOE_SERVE_CACHE,
        dtype=bf16)
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    params = cast_params(init_params(cfg, gen, device=dev,
                                     shardings=psh)[0], bf16)
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        MOE_SERVE_BATCH, 1)).astype(np.int32)).to(dev)
    mesh.stats.reset()
    ids, times = [], []
    for t in range(MOE_SERVE_STEPS):
        (logits, cache), secs = wall_s(lambda: step(params, tok, t, cache))
        check(bool(torch.isfinite(logits).all()),
              f"moe mesh decode step {t}: non-finite logits")
        tok = sample_logits(None, logits, 0.0, vocab_size=cfg.vocab_size)
        ids.append(tok[:, 0].tolist())
        times.append(secs)
    check(all(0 <= i < cfg.vocab_size for row in ids for i in row),
          f"moe mesh decode: ids outside the vocabulary")
    out = dict(decode_ms=statistics.median(times[1:]) * 1e3,
               decode_first_ms=times[0] * 1e3, decode_ids=ids,
               decode_calls=mesh.stats.calls / MOE_SERVE_STEPS,
               decode_bytes=mesh.stats.bytes / MOE_SERVE_STEPS,
               decode_coll_ms=mesh.stats.seconds / MOE_SERVE_STEPS * 1e3,
               decode_cache=tuple(cache["k"].shape), decode_layers=
               cfg.num_layers)
    del params, cache
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        MOE_SERVE_BATCH, MOE_SERVE_CHECK)).astype(np.int32)).to(dev)
    launches = {"segmented_matmul": 0, "segmented_matmul_chunked": 0,
                "segmm_wgmma": 0, "segmm_mma": 0}
    worst = {}
    for dispatch in ("grouped", "capacity", "sorted"):
        cut = arch_cfg(MOE_MESH_ARCH, 2, moe_dispatch=dispatch)
        step, psh, _, cache = make_serve_step(
            cut, mesh, batch=MOE_SERVE_BATCH, seq_len=MOE_SERVE_CHECK,
            dtype=f32)
        draw = lambda sh: init_params(cut, torch.Generator(device=dev)
                                      .manual_seed(seed + 19), device=dev,
                                      shardings=sh)[0]
        params = draw(psh)
        full = draw(None) if mesh.rank == 0 else None
        plain = (init_cache(cut, MOE_SERVE_BATCH, MOE_SERVE_CHECK, f32,
                            device=dev) if full is not None else None)
        worst[dispatch] = 0.0
        for t in range(MOE_SERVE_CHECK):
            (logits, cache), n = counted(lambda: step(
                params, tokens[:, t:t + 1], t, cache))
            for k in launches:
                launches[k] += n[k]
            if full is not None:
                with torch.no_grad():
                    want, plain = decode_step(full, cut, tokens[:, t:t + 1],
                                              t, plain, dtype=f32)
                err = max_abs_err(logits, want)
                check(torch.allclose(logits, want, rtol=LM_TOL, atol=LM_TOL),
                      f"moe mesh decode f32 {dispatch} step {t}: logits "
                      f"differ from one device's by {err}")
                worst[dispatch] = max(worst[dispatch], err)
        del params, full, plain, cache
    check(launches["segmented_matmul"] > 0, f"moe mesh decode rank "
          f"{mesh.rank}: the sorted dispatch launched no K5")
    check(launches["segmm_mma"] == launches["segmm_wgmma"] == 0,
          f"moe mesh decode rank {mesh.rank}: a float32 step ran K5/K6 on "
          f"the tensor cores")
    out.update(decode_f32_worst=worst, decode_launches=launches)
    return out


def moe_prefill(mesh, seed: int) -> dict:
    """``prefill(mesh=)`` with ``moe_dispatch="sorted"``: each rank's
    grouped GEMMs (K5) over the atoms routed to its experts, the logits
    against one device's prefill on rank 0; then each rank's K5 and K6 at
    its own shape (the atoms of a sequence routed to its experts by the
    first layer's router), bitwise equal, K5 held to its plain version on
    the same bf16 operands, timed (one rank at a time) beside ``torch.bmm``
    on the same experts and its bound."""
    import numpy as np
    import torch
    from repro_torch.kernels.segmm import kernel as SK
    from repro_torch.launch import roofline as RL
    from repro_torch.kernels.segmm.ops import segmm_operands
    from repro_torch.launch.mesh import NamedSharding
    from repro_torch.models import layers as L
    from repro_torch.models.lm import (cast_params, init_params, prefill)
    from repro_torch.models.moe import _router
    from repro_torch.serve.decode import _data_axes, cache_pspecs
    from repro_torch.train.step import param_specs, shardings_for

    dev, bf16 = mesh.device, torch.bfloat16
    cfg = arch_cfg(MOE_MESH_ARCH, 2, moe_dispatch="sorted")
    b = MOE_PREFILL_BATCH
    psh = shardings_for(mesh, param_specs(cfg))
    csh = shardings_for(mesh, cache_pspecs(cfg, mesh, b))
    daxes = _data_axes(mesh, b) or None
    rows = NamedSharding(mesh, (daxes, None))
    rows3 = NamedSharding(mesh, (daxes, None, None))
    draw = lambda sh: cast_params(init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed + 20), device=dev,
        shardings=sh)[0], bf16)
    params = draw(psh)
    tokens = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (b, MOE_PREFILL_S)).astype(np.int32)).to(dev)
    mesh.stats.reset()
    with torch.no_grad():
        ((logits, cache), n), secs = wall_s(lambda: counted(
            lambda: prefill(params, cfg, rows.shard(tokens), dtype=bf16,
                            mesh=mesh, cache_sh=csh)))
        logits = rows3.gather(logits)
    check(n["segmented_matmul"] == 3 * cfg.num_layers,
          f"moe mesh prefill rank {mesh.rank}: K5 launches {n}, expected "
          f"{3 * cfg.num_layers} (three grouped GEMMs a layer)")
    check(n["segmm_wgmma"] == n["segmented_matmul"] and n["segmm_mma"] == 0,
          f"moe mesh prefill rank {mesh.rank}: {n['segmm_wgmma']} of the "
          f"{n['segmented_matmul']} K5 launches ran on the wgmma route "
          f"(bf16 weights and activations, bm 128: all should)")
    out = dict(prefill_s=secs, prefill_launches=n,
               prefill_calls=mesh.stats.calls, prefill_bytes=
               mesh.stats.bytes, prefill_coll_s=mesh.stats.seconds)
    del cache
    if mesh.rank == 0:
        with torch.no_grad():
            full = draw(None)
            want, _ = prefill(full, cfg, tokens, dtype=bf16)
            del full
        err = max_abs_err(logits, want)
        scale = max(1.0, float(want.float().abs().max()))
        check(err <= MOE_PREFILL_TOL * scale,
              f"moe mesh prefill: logits differ from one device's by {err} "
              f"(limit {MOE_PREFILL_TOL} x {scale})")
        out.update(prefill_err=err, prefill_scale=scale)

    # each rank's K5/K6 at its own shape: a sequence's atoms routed to its
    # experts by layer 0's router
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    with torch.no_grad():
        w1 = L.gather(layer["w1"], mesh, L.FSDP, 1).contiguous()
    n_loc = w1.shape[0]
    first = mesh.coord(L.TP) * n_loc
    gen = torch.Generator(device=dev).manual_seed(seed + 21 + mesh.rank)
    x = torch.randn((MOE_PREFILL_S, cfg.d_model), generator=gen,
                    device=dev).to(bf16)
    idx, _, _ = _router(layer, x, cfg.num_experts, cfg.top_k)
    experts = idx.reshape(-1)
    mine = (experts >= first) & (experts < first + n_loc)
    atoms = x.repeat_interleave(cfg.top_k, dim=0)[mine]
    local = (experts[mine] - first).to(torch.int32)
    o5 = segmm_operands(atoms, local, num_experts=n_loc, bm=128,
                        schedule="group_mapped", path="pure")
    o6 = segmm_operands(atoms, local, num_experts=n_loc, bm=128,
                        schedule="chunked_lpt", path="native")
    chunks, counts, cmax = o6.queue
    (y5, y6), n = counted(lambda: (
        SK.segmented_matmul(o5.lhs, w1, o5.block_expert, bm=128)[o5.rows],
        SK.segmented_matmul_chunked(o6.lhs, w1, o6.block_expert, chunks,
                                    counts, bm=128,
                                    max_chunks=cmax)[o6.rows]))
    check(n["segmm_wgmma"] == 2 and n["segmm_mma"] == 0,
          f"moe mesh rank {mesh.rank}: K5/K6 at the rank's bf16 shape did "
          f"not run on the wgmma route ({n})")
    check(torch.equal(y5, y6), f"moe mesh rank {mesh.rank}: K6 differs from "
          f"K5 at the rank's shape")
    # K5 against its plain version on these bf16 operands: within the
    # float32 sum-order bound (sum_order_limit), and bitwise on
    # integer-valued stand-ins, whose every sum is exact
    plain = SK.segmented_matmul_plain(o5.lhs, w1, o5.block_expert,
                                      bm=128)[o5.rows]
    limit = sum_order_limit(o5.lhs, w1, o5.block_expert, 128)[o5.rows]
    err5 = compare_sum_order(f"segmented_matmul moe mesh rank {mesh.rank} "
                             f"(real)", y5, plain, limit)
    unit_lhs, unit_w1 = unit_values(o5.lhs), unit_values(w1)
    check(torch.equal(
        SK.segmented_matmul(unit_lhs, unit_w1, o5.block_expert, bm=128),
        SK.segmented_matmul_plain(unit_lhs, unit_w1, o5.block_expert,
                                  bm=128)),
          f"moe mesh rank {mesh.rank}: K5 bf16 on integer-valued operands "
          f"not bitwise equal to its plain version")
    out.update(k5_plain_err=err5, k5_plain_limit=float(limit.max()),
               k5_typical=float(plain.abs().median()))
    del plain, limit, unit_lhs, unit_w1
    nblk = o5.num_blocks
    lhs_b = o5.lhs.view(nblk, 128, cfg.d_model)
    rhs_g = w1[o5.block_expert.long()]
    k5 = lambda: SK.segmented_matmul(o5.lhs, w1, o5.block_expert, bm=128)
    # the ranks share one card, and a CUDA event pair on one rank also
    # spans the other ranks' kernels time-sliced in between: K5 once with
    # every rank timing at the same time, then each rank alone in turn
    mesh.barrier()
    out.update(k5_shared_ms=cuda_ms(k5, iters=5))
    for r in range(mesh.size):
        mesh.barrier()
        if r == mesh.rank:
            out.update(
                k5_ms=cuda_ms(k5, iters=5),
                k6_ms=cuda_ms(lambda: SK.segmented_matmul_chunked(
                    o6.lhs, w1, o6.block_expert, chunks, counts, bm=128,
                    max_chunks=cmax), iters=5),
                bmm_ms=cuda_ms(lambda: torch.bmm(lhs_b, rhs_g), iters=5))
    mesh.barrier()
    out.update(k5_shape=(int(atoms.shape[0]), nblk, n_loc, tuple(w1.shape)),
               k5_flop=2 * int(atoms.shape[0]) * cfg.d_model * cfg.d_ff)
    # its bound: each operand read once (bf16 atoms, the busy experts'
    # bf16 w1), the f32 output written once; flop at the bf16 tensor peak
    # (the routine's) and at the f32 CUDA-core rate (the parent's FMA
    # chain's)
    busy = int(torch.unique(local).numel())
    nbytes = (int(atoms.shape[0]) * cfg.d_model * 2
              + busy * cfg.d_model * cfg.d_ff * 2
              + int(atoms.shape[0]) * cfg.d_ff * 4)
    out.update(k5_bytes_ms=nbytes / RL.HBM_BW * 1e3,
               k5_bf16_ms=out["k5_flop"] / RL.PEAK_FLOPS_BF16 * 1e3,
               k5_f32_ms=out["k5_flop"] / F32_FLOP_PER_S * 1e3)
    del params, w1, rhs_g, lhs_b
    return out


def moe_rank_job(world: int, job: dict) -> dict:
    """Phase 28 on one rank of the ``(2, 2)`` mesh: training, the float32
    parity checks, serving and the ``sorted`` prefill."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(MESH_MODEL_AXIS, device=DEVICE)
    out = dict(mesh=str(mesh))
    out.update(mesh_train(mesh, arch_cfg(MOE_MESH_ARCH, MOE_MESH_LAYERS),
                          job["seed"], MOE_MESH_SHAPE))
    for part in (moe_f32, moe_decode, moe_prefill):
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        out[part.__name__] = part(mesh, job["seed"])
    return out


def phase_moe_mesh(seed: int) -> tuple:
    """Expert parallelism: OLMoE-1B-7B's training steps on one device
    first (freed), then four spawned ranks sharing this card in one gloo
    group run :func:`moe_rank_job` on ``(data, model) = (2, 2)``.  Returns
    the ranks' segmm launches on the mesh path and the e2e seconds."""
    import torch

    cut = arch_cfg(MOE_MESH_ARCH, MOE_MESH_LAYERS)
    seq, batch, micro, steps = MOE_MESH_SHAPE
    tokens = batch * seq
    single = mesh_one_device(cut, seed, MOE_MESH_SHAPE)
    for i, (m, secs) in enumerate(single):
        log(f"moe mesh one device step {i + 1}: loss {m['loss']!r}, "
            f"grad_norm {m['grad_norm']!r}, {secs * 1e3:.1f} ms")
    ranks, secs = wall_s(lambda: run_shard_ranks(
        MESH_RANKS, dict(seed=seed), fn="moe_rank_job",
        timeout_s=MESH_TIMEOUT_S, deadline_s=MESH_DEADLINE_S))
    log(f"moe mesh: {MESH_RANKS} processes on this card in one gloo group, "
        f"{secs:.1f} s in all; four ranks share one card and gloo moves "
        f"CUDA tensors through the host, so these times are the "
        f"expert-parallel path's overhead, not its scaling")
    e2e = {}
    for r, res in enumerate(ranks):
        for i, (row, (want, _)) in enumerate(zip(res["steps"], single)):
            for key in ("loss", "grad_norm"):
                got = row["metrics"][key]
                check(abs(got - want[key]) <= MESH_RTOL * abs(want[key]),
                      f"moe mesh rank {r} step {i + 1}: {key} {got!r} vs "
                      f"one device {want[key]!r} (rtol {MESH_RTOL})")
        rows = res["steps"]
        step_s = statistics.median([row["secs"] for row in rows[1:]]
                                   or [rows[0]["secs"]])
        last = rows[-1]
        kinds = ", ".join(f"{k} {v[0]} calls {v[1] / 2**20:.1f} MiB "
                          f"{v[2] * 1e3:.1f} ms"
                          for k, v in sorted(last["kinds"].items()))
        log(f"moe mesh train rank {r} ({res['mesh']}): {cut.name} x "
            f"{cut.num_layers} layers at full width ({cut.num_experts} "
            f"experts, {cut.num_experts // MESH_MODEL_AXIS} a rank, top-"
            f"{cut.top_k}, {cut.moe_dispatch}), S {seq}, global batch "
            f"{batch} in {micro} microbatches; losses "
            f"{[row['metrics']['loss'] for row in rows]}, grad norms "
            f"{[row['metrics']['grad_norm'] for row in rows]}; "
            f"{step_s * 1e3:.1f} ms a step (median of steps 2-{steps}; "
            f"step 1 {rows[0]['secs'] * 1e3:.1f} ms), {tokens / step_s:.0f}"
            f" tokens/s; peak device memory {res['peak'] / 2**30:.2f} GiB "
            f"(its blocks of the weights and AdamW state "
            f"{res['local_bytes'] / 2**30:.2f} GiB); collectives a step "
            f"{last['calls']} calls, {last['bytes'] / 2**20:.1f} MiB, "
            f"{last['coll_s'] * 1e3:.1f} ms; by kind: {kinds}")
        if r == 0:
            e2e[f"moe train step[mesh 2x2, {cut.name} x {cut.num_layers}, "
                f"S {seq}, batch {batch}]"] = step_s
    r0 = ranks[0]
    MEASURED["moe_mesh_peak"] = r0["peak"]
    one = statistics.median([s for _, s in single[1:]] or [single[0][1]])
    log(f"moe mesh one device: {one * 1e3:.1f} ms a step (median of steps "
        f"2-{steps}), {tokens / one:.0f} tokens/s; every rank's losses and "
        f"grad norms within {MESH_RTOL} of it")
    e2e[f"moe train step[one device, {cut.name} x {cut.num_layers}, S "
        f"{seq}, batch {batch}]"] = one
    for label, res in r0["moe_f32"].items():
        loss, want_loss = res["loss"]
        log(f"moe mesh f32 loss_and_grads {label} (2 layers at full width, "
            f"S {MOE_MESH_F32_S}, 2 sequences, {res['mesh']}): loss "
            f"{loss!r} vs one device {want_loss!r}; every gathered gradient "
            f"leaf and the router's on each model rank within "
            f"{res['worst']:.3e} of its largest entry (limit "
            f"{TRAIN_GRAD_TOL}); {res['secs']:.2f} s")
    dec = r0["moe_decode"]
    for r, res in enumerate(ranks):
        check(res["moe_decode"]["decode_ids"] == dec["decode_ids"],
              f"moe mesh decode: rank {r} sampled other ids")
    log(f"moe mesh decode {MOE_MESH_ARCH} x {dec['decode_layers']} layers "
        f"bf16 on {r0['mesh']}: batch {MOE_SERVE_BATCH}, cache block "
        f"{dec['decode_cache']} a rank, {MOE_SERVE_STEPS} greedy steps, "
        f"{dec['decode_ms']:.2f} ms a step (median; first "
        f"{dec['decode_first_ms']:.1f} ms), collectives a step "
        f"{dec['decode_calls']:.0f} calls, "
        f"{dec['decode_bytes'] / 2**20:.1f} MiB, "
        f"{dec['decode_coll_ms']:.2f} ms; ids {dec['decode_ids'][:2]}...; "
        f"float32 x 2 layers, {MOE_SERVE_CHECK} steps' logits within "
        f"{json.dumps(dec['decode_f32_worst'])} of one device's (limit "
        f"{LM_TOL}); segmm launches in the sorted steps "
        f"{json.dumps(dec['decode_launches'])}")
    e2e[f"moe decode step[mesh 2x2, {MOE_MESH_ARCH}, bf16, batch "
        f"{MOE_SERVE_BATCH}]"] = dec["decode_ms"] / 1e3
    totals = {"segmented_matmul": 0, "segmented_matmul_chunked": 0,
              "segmm_wgmma": 0, "segmm_mma": 0}
    for r, res in enumerate(ranks):
        pre = res["moe_prefill"]
        for k in totals:
            totals[k] += (pre["prefill_launches"][k]
                          + res["moe_decode"]["decode_launches"][k])
        atoms, nblk, n_loc, w_shape = pre["k5_shape"]
        tflops = pre["k5_flop"] / pre["k5_ms"] / 1e9
        log(f"moe mesh prefill rank {r}: sorted, 2 layers, S "
            f"{MOE_PREFILL_S}, one sequence a data rank: "
            f"{pre['prefill_s']:.2f} s, segmm launches {json.dumps(pre['prefill_launches'])}, "
            f"collectives {pre['prefill_calls']} calls, "
            f"{pre['prefill_bytes'] / 2**20:.1f} MiB, "
            f"{pre['prefill_coll_s'] * 1e3:.1f} ms; K5 at the rank's shape "
            f"({atoms} atoms on its {n_loc} experts, {nblk} M-blocks, w1 "
            f"{w_shape}, bf16), each rank timed alone: {pre['k5_ms']:.4f} "
            f"ms ({tflops:.2f} TFLOP/s; {pre['k5_shared_ms']:.4f} ms with "
            f"the four ranks timing it at once), K6 {pre['k6_ms']:.4f} ms "
            f"(bitwise K5's), torch.bmm on the same experts "
            f"{pre['bmm_ms']:.4f} ms; bound "
            f"{max(pre['k5_bf16_ms'], pre['k5_bytes_ms']):.4f} ms at the "
            f"bf16 tensor peak ({pre['k5_bf16_ms']:.4f} ms of flop, "
            f"{pre['k5_bytes_ms']:.4f} ms of bytes), "
            f"{max(pre['k5_f32_ms'], pre['k5_bytes_ms']):.4f} ms at the "
            f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s f32 CUDA-core rate; K5 "
            f"against its plain version on the same bf16 operands: max abs "
            f"err {pre['k5_plain_err']!r}, every entry within the f32 "
            f"sum-order bound (largest {pre['k5_plain_limit']!r}; median "
            f"|output| {pre['k5_typical']!r}), bitwise on integer-valued "
            f"operands")
    log(f"moe mesh prefill logits on {r0['mesh']} within "
        f"{r0['moe_prefill']['prefill_err']!r} of one device's (limit "
        f"{MOE_PREFILL_TOL} x {r0['moe_prefill']['prefill_scale']!r})")
    e2e[f"moe prefill[mesh 2x2, {MOE_MESH_ARCH} x 2, sorted, S "
        f"{MOE_PREFILL_S}, batch {MOE_PREFILL_BATCH}]"] = (
        r0["moe_prefill"]["prefill_s"])
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return totals, e2e


# ---------------------------------------------------------------------------
# tensor parallelism of the SSM blocks: RWKV6-3B and Hymba-1.5B
# ---------------------------------------------------------------------------

#: the leaves of the SSM blocks that are whole over ``model``: each rank's
#: copy of their gradient is held to one device's
SSM_COPIED = ("/layers/tmix/mu", "/layers/tmix/decay_base",
              "/layers/tmix/bonus_u", "/layers/cmix/mu", "/layers/mamba/wb",
              "/layers/mamba/wc")


def ssm_f32_cfg(name: str):
    """``name`` at full width and depth 2 for the float32 parity check
    (Hymba with phase 25's window, so that the band runs K7 at S
    2,048)."""
    if name == "hymba_15b":
        return arch_cfg(name, 2, sliding_window=SSM_F32_WINDOW,
                        attn_query_chunk=SSM_F32_WINDOW // 2)
    return arch_cfg(name, 2)


def ssm_f32(mesh, seed: int) -> dict:
    """The float32 parity of ``loss_and_grads`` on ``mesh`` against one
    device's on rank 0, depth 2 at full width, for both SSM models: the
    loss, every gathered gradient leaf, and each model rank's copy of
    the leaves whole over ``model`` (:data:`SSM_COPIED`)."""
    import torch
    from repro_torch.data.synthetic import batch_at, for_model
    from repro_torch.models.lm import init_params, tree_leaves
    from repro_torch.train.step import (loss_and_grads, param_specs,
                                        shardings_for)

    dev, f32 = mesh.device, torch.float32
    out = {}
    for name in SSM_ARCHS:
        cfg = ssm_f32_cfg(name)
        psh = shardings_for(mesh, param_specs(cfg))
        draw = lambda sh: init_params(cfg, torch.Generator(device=dev)
                                      .manual_seed(seed + 22), device=dev,
                                      shardings=sh)[0]
        params = draw(psh)
        batch = batch_at(for_model(cfg, seq_len=SSM_F32_S, global_batch=2,
                                   seed=seed), 0, cfg, device=dev)
        reset_all_counts()
        with k7_heads() as heads:
            (loss, _, grads), secs = wall_s(lambda: loss_and_grads(
                params, cfg, batch, 1, f32, mesh=mesh))
        check_k7_heads(f"ssm mesh f32 {name}", heads, mesh, cfg.num_heads)
        counts = {k: all_counts()[k] for k in ("flash_swa", "flash_swa_bwd")}
        want_counts = ({"flash_swa": 2 * cfg.num_layers,
                        "flash_swa_bwd": cfg.num_layers}
                       if cfg.family == "hybrid"
                       else {"flash_swa": 0, "flash_swa_bwd": 0})
        check(counts == want_counts, f"ssm mesh f32 {name} rank "
              f"{mesh.rank}: launches {counts}, expected {want_counts}")
        want = want_loss = None
        if mesh.rank == 0:
            full = draw(None)
            want_loss, _, want = loss_and_grads(full, cfg, batch, 1, f32)
            want = dict(tree_leaves(want))
            del full
        shardings = dict(tree_leaves(psh))
        worst, copies = 0.0, 0
        for path, g in tree_leaves(grads):
            whole = shardings[path].gather(g)
            if want is not None:
                worst = max(worst, leaf_close(f"ssm mesh f32 {name} grad "
                                              f"{path}", whole, want[path],
                                              TRAIN_GRAD_TOL))
            if path in SSM_COPIED:
                ranks = mesh.all_gather(whole[None], "model")
                copies += ranks.shape[0]
                for m in range(ranks.shape[0] if want is not None else 0):
                    worst = max(worst, leaf_close(
                        f"ssm mesh f32 {name} grad {path} on model rank {m}",
                        ranks[m], want[path], TRAIN_GRAD_TOL))
            del whole
        res = dict(secs=secs, counts=counts, copies=copies,
                   copied=[p for p in SSM_COPIED if p in shardings])
        if mesh.rank == 0:
            check(abs(float(loss) - float(want_loss))
                  <= TRAIN_LOSS_RTOL * abs(float(want_loss)),
                  f"ssm mesh f32 {name}: loss {float(loss)!r} vs one "
                  f"device {float(want_loss)!r}")
            res.update(loss=(float(loss), float(want_loss)), worst=worst)
        out[name] = res
        del params, grads, want
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


def ssm_decode(mesh, seed: int) -> dict:
    """``make_serve_step`` on ``mesh`` (``(1, 4)``) for both SSM models:
    full width and depth in bfloat16 (each rank draws its blocks), batch
    1, greedy steps (ids in the vocabulary, logits finite), each step's
    time and collectives by kind; then depth 2 in float32, each step's
    logits held to one device's ``decode_step`` on rank 0."""
    import numpy as np
    import torch
    from repro_torch.models.lm import (cast_params, decode_step, init_cache,
                                       init_params)
    from repro_torch.serve.decode import make_serve_step, sample_logits

    dev, bf16, f32 = mesh.device, torch.bfloat16, torch.float32
    out = {}
    for name in SSM_ARCHS:
        cfg = arch_cfg(name)
        cache_len = cfg.sliding_window or SSM_SERVE_STEPS
        step, psh, _, cache = make_serve_step(
            cfg, mesh, batch=1, seq_len=cache_len, dtype=bf16)
        gen = torch.Generator(device=dev).manual_seed(seed + 23)
        params = cast_params(init_params(cfg, gen, device=dev,
                                         shardings=psh)[0], bf16)
        tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        blocks = weight_blocks(params)
        reset_all_counts()
        ids, times, kinds = [], [], {}
        for t in range(SSM_SERVE_STEPS):
            mesh.stats.reset()
            with model_gathers() as shapes:
                (logits, cache), secs = wall_s(lambda: step(params, tok, t,
                                                            cache))
            hits = sorted({blocks[x] for x in shapes if x in blocks})
            check(not hits, f"ssm mesh decode {name} step {t}: weights "
                  f"{hits} all-gathered over model")
            check(bool(torch.isfinite(logits).all()),
                  f"ssm mesh decode {name} step {t}: non-finite logits")
            tok = sample_logits(None, logits, 0.0, vocab_size=cfg.vocab_size)
            ids.append(int(tok))
            times.append(secs)
            if t:                   # steps after the first, summed
                for (k, n), v in mesh.stats.kinds.items():
                    row = kinds.setdefault(f"{k}@{n}", [0, 0, 0.0])
                    for j in range(3):
                        row[j] += v[j]
        check(all(0 <= i < cfg.vocab_size for i in ids),
              f"ssm mesh decode {name}: ids {ids} outside the vocabulary")
        check(all_counts()["flash_swa"] == 0,
              f"ssm mesh decode {name} launched K7")
        n = SSM_SERVE_STEPS - 1
        out[name] = dict(
            ms=statistics.median(times[1:]) * 1e3, first_ms=times[0] * 1e3,
            ids=ids, layers=cfg.num_layers, kinds={
                k: [v[0] / n, v[1] / n, v[2] / n] for k, v in kinds.items()},
            cache={k: tuple(c.shape) for k, c in cache.items()})
        del params, cache
        if DEVICE == "cuda":
            torch.cuda.empty_cache()

        cut = ssm_f32_cfg(name)
        step, psh, _, cache = make_serve_step(
            cut, mesh, batch=1, seq_len=cache_len, dtype=f32)
        draw = lambda sh: init_params(cut, torch.Generator(device=dev)
                                      .manual_seed(seed + 24), device=dev,
                                      shardings=sh)[0]
        params = draw(psh)
        full = draw(None) if mesh.rank == 0 else None
        plain = (init_cache(cut, 1, cache_len, f32, device=dev)
                 if full is not None else None)
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cut.vocab_size, (1, SSM_SERVE_CHECK)).astype(np.int32)
        ).to(dev)
        worst = 0.0
        for t in range(SSM_SERVE_CHECK):
            logits, cache = step(params, tokens[:, t:t + 1], t, cache)
            if full is not None:
                with torch.no_grad():
                    want, plain = decode_step(full, cut, tokens[:, t:t + 1],
                                              t, plain, dtype=f32)
                err = max_abs_err(logits, want)
                check(torch.allclose(logits, want, rtol=LM_TOL, atol=LM_TOL),
                      f"ssm mesh decode f32 {name} step {t}: logits differ "
                      f"from one device's by {err}")
                worst = max(worst, err)
        out[name]["f32_worst"] = worst
        del params, full, plain, cache
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


def ssm_prefill(mesh, seed: int) -> dict:
    """Hymba's ``prefill(mesh=)`` on ``mesh`` (``(1, 4)``) at full width
    and depth in bfloat16, one sequence of ``SSM_PREFILL_S``: K7 once a
    layer on every rank (on its block of heads), all on the tensor cores;
    finite logits; the returned states placed as the cache stores
    them."""
    import numpy as np
    import torch
    from repro_torch.models.lm import (cache_shape, cast_params,
                                       init_params, prefill)
    from repro_torch.serve.decode import cache_pspecs
    from repro_torch.train.step import param_specs, shardings_for

    dev, bf16 = mesh.device, torch.bfloat16
    cfg = arch_cfg("hymba_15b")
    psh = shardings_for(mesh, param_specs(cfg))
    csh = shardings_for(mesh, cache_pspecs(cfg, mesh, 1))
    params = cast_params(init_params(cfg, torch.Generator(device=dev)
                                     .manual_seed(seed + 25), device=dev,
                                     shardings=psh)[0], bf16)
    tokens = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, cfg.vocab_size, (1, SSM_PREFILL_S)).astype(np.int32)).to(dev)
    reset_all_counts()
    mesh.stats.reset()
    with torch.no_grad():
        (logits, cache), secs = wall_s(lambda: prefill(
            params, cfg, tokens, dtype=bf16, cache_len=cfg.sliding_window,
            mesh=mesh, cache_sh=csh))
    want = dict(flash_swa=cfg.num_layers,
                **k7_routes(cfg.num_layers, 0))
    counts = {k: all_counts()[k] for k in want}
    check(counts == want, f"ssm mesh prefill rank {mesh.rank}: launches "
          f"{counts}, expected {want}")
    check(bool(torch.isfinite(logits).all()),
          f"ssm mesh prefill rank {mesh.rank}: non-finite logits")
    for name, (shape, _) in cache_shape(cfg, 1, cfg.sliding_window).items():
        local = csh[name].local_shape(shape)
        check(tuple(cache[name].shape) == local, f"ssm mesh prefill: cache "
              f"{name} {tuple(cache[name].shape)}, expected this rank's "
              f"block {local}")
    out = dict(secs=secs, counts=counts, calls=mesh.stats.calls,
               bytes=mesh.stats.bytes, coll_s=mesh.stats.seconds,
               h=tuple(cache["h"].shape))
    del params, cache
    return out


@contextlib.contextmanager
def k7_heads():
    """The query heads of every K7 forward and backward call made inside,
    ``{"flash_swa": [...], "flash_swa_bwd": [...]}`` (the ops module
    looks the kernel functions up at call time)."""
    from repro_torch.kernels.flash_swa import kernel as FK
    seen = {"flash_swa": [], "flash_swa_bwd": []}
    fwd, bwd = FK.flash_swa, FK.flash_swa_bwd

    def fwd_seen(q, *a, **kw):
        seen["flash_swa"].append(int(q.shape[2]))
        return fwd(q, *a, **kw)

    def bwd_seen(q, *a, **kw):
        seen["flash_swa_bwd"].append(int(q.shape[2]))
        return bwd(q, *a, **kw)

    FK.flash_swa, FK.flash_swa_bwd = fwd_seen, bwd_seen
    try:
        yield seen
    finally:
        FK.flash_swa, FK.flash_swa_bwd = fwd, bwd


@contextlib.contextmanager
def model_gathers():
    """The shapes of every tensor all-gathered over ``model`` inside."""
    from repro_torch.launch.mesh import LMMesh
    shapes = []
    plain = LMMesh.all_gather

    def spied(self, x, axis, dim=0):
        if axis == "model" and self.axis_size(axis) > 1:
            shapes.append(tuple(x.shape))
        return plain(self, x, axis, dim)

    LMMesh.all_gather = spied
    try:
        yield shapes
    finally:
        LMMesh.all_gather = plain


def weight_blocks(params, names=None) -> dict:
    """``{shape: path}`` of this rank's weight blocks as a gather over
    ``model`` would take them (a layer's, without the stacked axis), of
    the leaves whose path ends in one of ``names`` (all without)."""
    from repro_torch.models.lm import tree_leaves
    out = {}
    for path, t in tree_leaves(params):
        if names is None or path.rsplit("/", 1)[1] in names:
            shape = t.shape[1:] if path.startswith("/layers/") else t.shape
            out[tuple(shape)] = path
    return out


def check_k7_heads(tag: str, heads: dict, mesh, num_heads: int) -> None:
    """Every K7 call (forward and backward) of ``heads`` ran on this
    rank's block of ``num_heads`` (``layers.head_block``)."""
    from repro_torch.models.layers import head_block
    start, stop = head_block(num_heads, mesh)
    for name, seen in heads.items():
        check(set(seen) <= {stop - start}, f"{tag} rank {mesh.rank}: "
              f"{name} ran on {sorted(set(seen))} heads, expected the "
              f"rank's block [{start}, {stop})")


def glm_heads(mesh, seed: int) -> dict:
    """GLM-4-9B at full width, depth ``HEADS_LAYERS``, on ``mesh`` (``(1,
    4)``): 8 query heads a rank on ``wq``'s and ``wo``'s stored blocks,
    the 2 KV heads gathered whole over ``model`` and narrowed to the one
    each block reads.  Float32 ``loss_and_grads`` against one device's on
    rank 0 (the loss; the attention leaves and the norms gathered whole,
    every other leaf on rank 0's block), then a bf16 prefill of one
    ``HEADS_PREFILL_S`` sequence (finite logits, collectives by kind);
    both fail if ``wq`` or ``wo`` is all-gathered over ``model``."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import batch_at, for_model
    from repro_torch.models.lm import (cast_params, init_params, prefill,
                                       tree_leaves)
    from repro_torch.serve.decode import cache_pspecs
    from repro_torch.train.step import (loss_and_grads, param_specs,
                                        shardings_for)

    dev, f32, bf16 = mesh.device, torch.float32, torch.bfloat16
    cfg = arch_cfg(HEADS_ARCH, HEADS_LAYERS)
    psh = shardings_for(mesh, param_specs(cfg))
    draw = lambda sh: init_params(cfg, torch.Generator(device=dev)
                                  .manual_seed(seed + 26), device=dev,
                                  shardings=sh)[0]
    params = draw(psh)
    banned = weight_blocks(params, ("wq", "wo"))
    batch = batch_at(for_model(cfg, seq_len=HEADS_F32_S,
                               global_batch=HEADS_F32_BATCH, seed=seed), 0,
                     cfg, device=dev)
    mesh.stats.reset()
    with model_gathers() as shapes:
        (loss, _, grads), secs = wall_s(lambda: loss_and_grads(
            params, cfg, batch, 1, f32, mesh=mesh))
    hits = sorted({banned[x] for x in shapes if x in banned})
    check(not hits, f"heads mesh f32 {cfg.name} rank {mesh.rank}: "
          f"{hits} all-gathered over model")
    kinds = {f"{k}@{n}": list(v) for (k, n), v in mesh.stats.kinds.items()}
    want = want_loss = None
    if mesh.rank == 0:
        full = draw(None)
        want_loss, _, want = loss_and_grads(full, cfg, batch, 1, f32)
        want = dict(tree_leaves(want))
        del full
    shardings = dict(tree_leaves(psh))
    worst = 0.0
    for path, g in tree_leaves(grads):
        whole = path.startswith("/layers/attn/") or "/ln" in path
        got = shardings[path].gather(g) if whole else g
        if want is not None:
            exp = want[path] if whole else shardings[path].shard(want[path])
            worst = max(worst, leaf_close(f"heads mesh f32 {cfg.name} grad "
                                          f"{path}", got, exp,
                                          TRAIN_GRAD_TOL))
        del got
    res = dict(secs=secs, kinds=kinds, worst=worst)
    if mesh.rank == 0:
        check(abs(float(loss) - float(want_loss))
              <= TRAIN_LOSS_RTOL * abs(float(want_loss)),
              f"heads mesh f32 {cfg.name}: loss {float(loss)!r} vs one "
              f"device {float(want_loss)!r}")
        res["loss"] = (float(loss), float(want_loss))
    del params, grads, want
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    params = cast_params(draw(psh), bf16)
    csh = shardings_for(mesh, cache_pspecs(cfg, mesh, 1))
    tokens = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab_size, (1, HEADS_PREFILL_S)).astype(np.int32)).to(dev)
    mesh.stats.reset()
    with model_gathers() as shapes, torch.no_grad():
        (logits, cache), pre_s = wall_s(lambda: prefill(
            params, cfg, tokens, dtype=bf16, mesh=mesh, cache_sh=csh))
    hits = sorted({banned[x] for x in shapes if x in banned})
    check(not hits, f"heads mesh prefill {cfg.name} rank {mesh.rank}: "
          f"{hits} all-gathered over model")
    check(bool(torch.isfinite(logits).all()),
          f"heads mesh prefill {cfg.name} rank {mesh.rank}: non-finite "
          f"logits")
    res.update(prefill_s=pre_s, prefill_kinds={
        f"{k}@{n}": list(v) for (k, n), v in mesh.stats.kinds.items()},
        cache={k: tuple(c.shape) for k, c in cache.items()},
        heads=tuple(shardings["/layers/attn/wq"].local_shape(
            (cfg.num_layers, cfg.d_model,
             cfg.num_heads * cfg.resolved_head_dim)))[2]
        // cfg.resolved_head_dim)
    del params, cache
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return res


def ssm_rank_job(world: int, job: dict) -> dict:
    """Phase 29 on one rank: both models' training steps and the float32
    parity check on ``(data, model) = (2, 2)``, then serving and Hymba's
    prefill on ``(1, 4)``."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(MESH_MODEL_AXIS, device=DEVICE)
    hymba = arch_cfg("hymba_15b").num_heads
    out = dict(mesh=str(mesh))
    for name in SSM_ARCHS:
        with k7_heads() as heads:
            out[name] = mesh_train(mesh, arch_cfg(name, SSM_MESH_LAYERS),
                                   job["seed"], SSM_MESH_SHAPE,
                                   SSM_MESH_WARMUP)
        check_k7_heads(f"ssm mesh train {name}", heads, mesh, hymba)
        out[name]["k7_heads"] = sorted(set(heads["flash_swa"]))
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    out["f32"] = ssm_f32(mesh, job["seed"])
    serve = make_host_mesh(world, device=DEVICE)                # (1, 4)
    out["serve_mesh"] = str(serve)
    out["decode"] = ssm_decode(serve, job["seed"])
    with k7_heads() as heads:
        out["prefill"] = ssm_prefill(serve, job["seed"])
    check_k7_heads("ssm mesh prefill", heads, serve, hymba)
    out["prefill"]["k7_heads"] = sorted(set(heads["flash_swa"]))
    out["glm"] = glm_heads(serve, job["seed"])
    return out


def kinds_text(kinds: dict) -> str:
    return ", ".join(f"{k} {v[0]:.0f} calls {v[1] / 2**20:.2f} MiB "
                     f"{v[2] * 1e3:.1f} ms" for k, v in sorted(kinds.items()))


def phase_ssm_mesh(seed: int, card_line: str) -> tuple:
    """Tensor parallelism of the SSM blocks: each model's training steps
    on one device first (freed), then four spawned ranks sharing this
    card in one gloo group run :func:`ssm_rank_job`.  Returns the ranks'
    K7 launches in the training steps and Hymba's prefill, and the e2e
    seconds."""
    import torch

    seq, batch, micro, steps = SSM_MESH_SHAPE
    tokens = batch * seq
    single = {}
    for name in SSM_ARCHS:
        single[name] = mesh_one_device(arch_cfg(name, SSM_MESH_LAYERS), seed,
                                       SSM_MESH_SHAPE, SSM_MESH_WARMUP)
        for i, (m, secs) in enumerate(single[name]):
            log(f"ssm mesh one device {name} step {i + 1}: loss "
                f"{m['loss']!r}, grad_norm {m['grad_norm']!r}, "
                f"{secs * 1e3:.1f} ms")
    ranks, secs = wall_s(lambda: run_shard_ranks(
        MESH_RANKS, dict(seed=seed), fn="ssm_rank_job",
        timeout_s=MESH_TIMEOUT_S, deadline_s=MESH_DEADLINE_S))
    log(f"ssm mesh: {MESH_RANKS} processes on this card in one gloo group, "
        f"{secs:.1f} s in all; four ranks share one card and gloo moves "
        f"CUDA tensors through the host, so these times are the "
        f"tensor-parallel path's overhead, not its scaling ({card_line})")
    totals = dict.fromkeys(K7_COUNTERS, 0)
    e2e = {}
    for name in SSM_ARCHS:
        cut = arch_cfg(name, SSM_MESH_LAYERS)
        one = statistics.median([s for _, s in single[name][1:]]
                                or [single[name][0][1]])
        for r, res in enumerate(ranks):
            rows = res[name]["steps"]
            for i, (row, (want, _)) in enumerate(zip(rows, single[name])):
                for key in ("loss", "grad_norm"):
                    got = row["metrics"][key]
                    check(abs(got - want[key]) <= MESH_RTOL * abs(want[key]),
                          f"ssm mesh {name} rank {r} step {i + 1}: {key} "
                          f"{got!r} vs one device {want[key]!r} (rtol "
                          f"{MESH_RTOL})")
                for k in totals:
                    totals[k] += row["counts"][k]
            step_s = statistics.median([row["secs"] for row in rows[1:]]
                                       or [rows[0]["secs"]])
            last = rows[-1]
            log(f"ssm mesh train {name} rank {r} ({res['mesh']}): "
                f"{cut.num_layers} layers at full width, S {seq}, global "
                f"batch {batch} in {micro} microbatches; losses "
                f"{[row['metrics']['loss'] for row in rows]}, grad norms "
                f"{[row['metrics']['grad_norm'] for row in rows]}; "
                f"{step_s * 1e3:.1f} ms a step (median of steps 2-{steps}; "
                f"step 1 {rows[0]['secs'] * 1e3:.1f} ms; one device "
                f"{one * 1e3:.1f} ms), {tokens / step_s:.0f} tokens/s (one "
                f"device {tokens / one:.0f}); peak device memory "
                f"{res[name]['peak'] / 2**30:.2f} GiB; collectives a step "
                f"{last['calls']} calls, {last['bytes'] / 2**20:.1f} MiB, "
                f"{last['coll_s'] * 1e3:.1f} ms; by kind: "
                f"{kinds_text(last['kinds'])}; launches a step "
                f"{json.dumps(last['counts'])}"
                + (f" on {res[name]['k7_heads']} query heads"
                   if res[name]["k7_heads"] else ""))
            if r == 0:
                e2e[f"ssm train step[mesh 2x2, {cut.name} x "
                    f"{cut.num_layers}, S {seq}, batch {batch}]"] = step_s
        e2e[f"ssm train step[one device, {cut.name} x {cut.num_layers}, S "
            f"{seq}, batch {batch}]"] = one
    r0 = ranks[0]
    for name, res in r0["f32"].items():
        loss, want_loss = res["loss"]
        log(f"ssm mesh f32 loss_and_grads {name} (2 layers at full width, "
            f"S {SSM_F32_S}, 2 sequences, {r0['mesh']}): loss {loss!r} vs "
            f"one device {want_loss!r}; every gathered gradient leaf and "
            f"the {res['copies']} model ranks' copies of "
            f"{', '.join(p.split('/', 2)[2] for p in res['copied'])} within "
            f"{res['worst']:.3e} of its largest entry (limit "
            f"{TRAIN_GRAD_TOL}); launches {json.dumps(res['counts'])} a "
            f"rank; {res['secs']:.2f} s")
    for name in SSM_ARCHS:
        dec = r0["decode"][name]
        for r, res in enumerate(ranks):
            check(res["decode"][name]["ids"] == dec["ids"],
                  f"ssm mesh decode {name}: rank {r} sampled other ids")
        log(f"ssm mesh decode {name} x {dec['layers']} layers bf16 on "
            f"{r0['serve_mesh']}: batch 1, state blocks "
            f"{json.dumps(dec['cache'])} a rank, {SSM_SERVE_STEPS} greedy "
            f"steps, {dec['ms']:.2f} ms a step (median; first "
            f"{dec['first_ms']:.1f} ms), collectives a step by kind: "
            f"{kinds_text(dec['kinds'])}, no weight all-gathered over "
            f"model; ids {dec['ids'][:8]}...; "
            f"float32 x 2 layers, {SSM_SERVE_CHECK} steps' logits within "
            f"{dec['f32_worst']:.2e} of one device's (limit {LM_TOL}) "
            f"({card_line})")
        e2e[f"ssm decode step[mesh 1x{MESH_RANKS}, {name}, bf16, batch 1]"] \
            = dec["ms"] / 1e3
    for r, res in enumerate(ranks):
        pre = res["prefill"]
        for k in ("flash_swa", "flash_swa_wgmma"):
            totals[k] += pre["counts"][k]
        log(f"ssm mesh prefill hymba_15b rank {r} ({res['serve_mesh']}): "
            f"full depth bf16, S {SSM_PREFILL_S}, {pre['secs']:.2f} s, K7 "
            f"launches {json.dumps(pre['counts'])} on {pre['k7_heads']} "
            f"query heads, h block {pre['h']}, "
            f"collectives {pre['calls']} calls, "
            f"{pre['bytes'] / 2**20:.1f} MiB, {pre['coll_s'] * 1e3:.1f} ms")
    e2e[f"ssm prefill[mesh 1x{MESH_RANKS}, hymba_15b, bf16, S "
        f"{SSM_PREFILL_S}]"] = r0["prefill"]["secs"]
    glm = r0["glm"]
    loss, want_loss = glm["loss"]
    log(f"heads mesh f32 loss_and_grads {HEADS_ARCH} ({HEADS_LAYERS} "
        f"layers at full width, S {HEADS_F32_S}, {HEADS_F32_BATCH} "
        f"sequences, {r0['serve_mesh']}: {glm['heads']} query heads a rank "
        f"on wq's and wo's stored blocks, the 2 KV heads gathered whole "
        f"and narrowed): loss {loss!r} vs one device {want_loss!r}; the "
        f"attention leaves and norms gathered, every other leaf rank 0's "
        f"block, within {glm['worst']:.3e} of its largest entry (limit "
        f"{TRAIN_GRAD_TOL}); {glm['secs']:.2f} s, collectives "
        f"{kinds_text(glm['kinds'])}; wq and wo never all-gathered over "
        f"model ({card_line})")
    for r, res in enumerate(ranks):
        g = res["glm"]
        log(f"heads mesh prefill {HEADS_ARCH} rank {r} ({res['serve_mesh']})"
            f": {HEADS_LAYERS} layers bf16, S {HEADS_PREFILL_S}, "
            f"{g['prefill_s']:.2f} s, cache blocks {json.dumps(g['cache'])},"
            f" collectives {kinds_text(g['prefill_kinds'])}; wq and wo "
            f"never all-gathered over model")
    e2e[f"heads prefill[mesh 1x{MESH_RANKS}, {HEADS_ARCH} x "
        f"{HEADS_LAYERS}, bf16, S {HEADS_PREFILL_S}]"] = glm["prefill_s"]
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return totals, e2e


def phase_parent_decode(parent_src: str) -> None:
    """``tools/time_ssm_decode.py`` on another checkout's ``src`` and on
    this one's, in turns (parent, this, this, parent): the SSM models'
    decode step on the same ``(1, 4)`` mesh, side by side."""
    tool = ROOT / "tools" / "time_ssm_decode.py"
    rows = {}
    for label, src in (("parent", parent_src), ("this", str(SRC)),
                       ("this", str(SRC)), ("parent", parent_src)):
        run_ = subprocess.run([sys.executable, str(tool), "--src", src],
                              capture_output=True, text=True, timeout=600)
        check(run_.returncode == 0, f"time_ssm_decode on {src} failed:\n"
              f"{run_.stderr[-3000:]}")
        res = json.loads(run_.stdout.strip().splitlines()[-1])
        for name, row in res["decode"].items():
            rows.setdefault(name, {}).setdefault(label, []).append(row)
    for name, by in rows.items():
        text = "; ".join(
            f"{label} {', '.join('%.2f' % r['ms'] for r in runs)} ms a step "
            f"(collectives {kinds_text(runs[-1]['kinds'])})"
            for label, runs in by.items())
        log(f"ssm mesh decode {name} on (1, {MESH_RANKS}), parent against "
            f"this tree in turns: {text}")


def dryrun_peak(label: str, t: dict, measured: int) -> None:
    """Log one traced step's peak estimate beside the measured peak and
    hold it within ``DRYRUN_PEAK_TOL``."""
    mem = t["memory"]
    est = mem["peak_estimate_bytes"]
    off = est / measured - 1.0
    log(f"dry-run check {label}: traced on meta in {t['trace_s']:.1f} s, "
        f"peak estimate {est / 2**30:.2f} GiB (arguments "
        f"{mem['argument_size_in_bytes'] / 2**30:.2f} + most live in the "
        f"step {mem['temp_size_in_bytes'] / 2**30:.2f}) vs measured "
        f"max_memory_allocated {measured / 2**30:.2f} GiB: {off:+.3f} (limit "
        f"{DRYRUN_PEAK_TOL}); launches tallied {json.dumps(t['kernels'])}")
    check(abs(off) <= DRYRUN_PEAK_TOL,
          f"dry-run check {label}: peak estimate {est} B is {off:+.3f} off "
          f"the measured {measured} B (limit {DRYRUN_PEAK_TOL})")


def phase_dryrun_check(cfg) -> None:
    """Steps whose peak this run measured, traced on the ``meta`` device
    by the dry run (``launch/dryrun.py``), each peak estimate held to the
    measured one: phase 24's one-device train step (its flop count beside
    6ND), rank 0's step of phase 25's ``(2, 2)`` mesh, rank 0's OLMoE
    step of phase 28's, and each stage's step of phase 26's pipeline."""
    import torch
    from repro_torch.configs import ShapeCase
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dryrun import build_cell, fake_world, trace_step
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.lm import (active_param_count, param_shapes,
                                       tree_map)
    from repro_torch.train.pipeline import block_stage_fn, make_pipeline_apply

    case = train_case()
    step, args = build_cell(cfg, case, make_host_mesh(device="meta"),
                            TRAIN_MICRO)
    t = trace_step(step, args)
    del step, args
    dryrun_peak(f"{cfg.name} train step (full depth, S {TRAIN_SEQ}, batch "
                f"{TRAIN_BATCH} in {TRAIN_MICRO} microbatches, float32 "
                f"masters, bf16 compute, remat; phase 24)", t,
                MEASURED["train_peak"])
    mf = RL.model_flops(cfg, case, active_param_count(cfg))
    log(f"dry-run check flops {t['flops']:.4g} ({t['kernel_flops']:.4g} of "
        f"them K7's and its backward's) vs model_flops 6ND {mf:.4g} (ratio "
        f"{t['flops'] / mf:.3f}); bytes read and written {t['bytes']:.4g}")

    cut = dataclasses.replace(cfg, num_layers=MESH_LAYERS)
    with fake_world(MESH_RANKS):
        mesh = make_host_mesh(MESH_MODEL_AXIS, device="meta")
        step, args = build_cell(cut, ShapeCase(f"train_{TRAIN_SEQ}", TRAIN_SEQ,
                                               MESH_BATCH, "train"),
                                mesh, MESH_MICRO)
        t = trace_step(step, args, mesh)
        del step, args
    dryrun_peak(f"mesh rank 0 train step ((data, model) = "
                f"({MESH_RANKS // MESH_MODEL_AXIS}, {MESH_MODEL_AXIS}), "
                f"{cut.num_layers} "
                f"layers, S {TRAIN_SEQ}, global batch {MESH_BATCH} in "
                f"{MESH_MICRO} microbatches; phase 25)", t,
                MEASURED["mesh_peak"])

    cut = arch_cfg(MOE_MESH_ARCH, MOE_MESH_LAYERS)
    with fake_world(MESH_RANKS):
        mesh = make_host_mesh(MESH_MODEL_AXIS, device="meta")
        step, args = build_cell(cut, ShapeCase(
            f"train_{MOE_MESH_SEQ}", MOE_MESH_SEQ, MOE_MESH_BATCH, "train"),
            mesh, MOE_MESH_MICRO)
        t = trace_step(step, args, mesh)
        del step, args
    dryrun_peak(f"moe mesh rank 0 train step ({cut.name} x {cut.num_layers}"
                f" layers, (data, model) = ({MESH_RANKS // MESH_MODEL_AXIS}, "
                f"{MESH_MODEL_AXIS}), S {MOE_MESH_SEQ}, global batch "
                f"{MOE_MESH_BATCH} in {MOE_MESH_MICRO} microbatches; phase "
                f"28)", t, MEASURED["moe_mesh_peak"])
    log("dry-run check moe mesh collectives traced: " + ", ".join(
        f"{k}@{n} {v[0]} calls {v[1] / 2**20:.1f} MiB"
        for (k, n), v in sorted(t["collectives"].items())))

    cut = dataclasses.replace(cfg, num_layers=PIPE_LAYERS)
    per = PIPE_LAYERS // PIPE_RANKS
    for r, measured in enumerate(MEASURED["pipe_peaks"]):
        with fake_world(PIPE_RANKS, r):
            mesh = make_mesh((PIPE_RANKS, 1), ("pod", "data"), device="meta")
            params = tree_map(
                lambda a: a[None].detach().requires_grad_(),
                param_shapes(dataclasses.replace(
                    cfg, num_layers=per))["layers"])
            xs = torch.empty((PIPE_MICRO, 1, TRAIN_SEQ, cfg.d_model),
                             dtype=torch.bfloat16, device="meta")
            apply = make_pipeline_apply(block_stage_fn(cut, TRAIN_SEQ), mesh,
                                        PIPE_RANKS, PIPE_MICRO)
            t = trace_step(lambda p, x: pipe_step(apply, p, x),
                           (params, xs), mesh)
            del params, xs, apply
        dryrun_peak(f"pipeline stage {r} step ({per} layers, {PIPE_MICRO} "
                    f"microbatches of S {TRAIN_SEQ}; phase 26)", t, measured)


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
    parser.add_argument("--parent-src", default=None,
                        help="another checkout's src (e.g. the parent "
                             "commit's): phase 29 also times its SSM "
                             "decode step on the same (1, 4) mesh")
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by operation for one "
                             "bfs, pagerank, served query stream, "
                             "bfs_multi, MoE layer, TreeLSTM evaluation, "
                             "Danube prefill, Danube decode and Danube "
                             "train step")
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
    # every "auto" selection of this run reads and writes a fresh cache
    cache_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        pathlib.Path(cache_dir.name) / "autotune.json")
    os.environ.pop("REPRO_AUTOTUNE_MEASURE", None)
    try:
        return run(args, t_start)
    finally:
        cache_dir.cleanup()


def run(args, t_start: float) -> int:
    from repro_torch.launch import roofline as RL
    import torch

    card_line, sms = phase_card()
    phase_build()
    num_blocks = BLOCKS_PER_SM * sms
    A, g, x, source = phase_data(args.seed, num_blocks)
    plans = build_plans(g, num_blocks)
    rows = phase_parity_and_times(A, x, g, plans, num_blocks, args.seed)
    launches, e2e, answers = phase_main(A, x, g, plans, num_blocks, source)
    phase_auto(g, num_blocks, source)
    e2e.update(phase_determinism(A, x, g, plans, num_blocks, args.seed))
    # slice 8: the served stream and bfs_multi on the chunked_lpt plan,
    # then measured autotuning
    plan = plans["chunked_lpt"][0]
    serve_counts, serve_e2e = phase_graph_serving(g, plan, args.seed)
    multi_counts, multi_e2e, sources, multi_want = phase_bfs_multi(
        g, plan, args.seed, source)
    e2e.update(serve_e2e)
    e2e.update(multi_e2e)
    log(f"main-path launches chunk_walk_tiles: {launches['chunk_walk_tiles']}"
        f" (graph drivers) + {serve_counts['chunk_walk_tiles']} (serving) + "
        f"{multi_counts['chunk_walk_tiles']} (bfs_multi)")
    launches["chunk_walk_tiles"] += (serve_counts["chunk_walk_tiles"]
                                     + multi_counts["chunk_walk_tiles"])
    for name in ("segment_sum_sorted", "segment_sum_fixup"):
        log(f"main-path launches {name}: {launches[name]} (graph drivers) + "
            f"{serve_counts[name]} (serving) + {multi_counts[name]} "
            f"(bfs_multi)")
        launches[name] += serve_counts[name] + multi_counts[name]
    # slice 9: the sharded traversal at S = 1 and on four ranks
    shard_counts = phase_sharded(g, plans["chunked_lpt"], num_blocks, source,
                                 sources, answers["chunked_lpt"], multi_want)
    for name in SHARD_KERNELS:
        log(f"main-path launches {name}: + {shard_counts[name]} (sharded "
            f"phase, every rank)")
        launches[name] += shard_counts[name]
    phase_measured_autotune(A, x, g, num_blocks)
    if args.profile:
        from repro_torch.sparse import bfs, bfs_multi, pagerank
        phase_profile([("bfs[chunked_lpt]",
                        lambda: bfs(g, source, plan=plan)),
                       ("pagerank[chunked_lpt]",
                        lambda: pagerank(g, plan=plan)),
                       (f"graph serving [{SERVE_QUERIES} queries, "
                        f"{SERVE_LANES} lanes]",
                        lambda: serve_stream(g, plan, args.seed)),
                       (f"bfs_multi[{MULTI_SOURCES} sources]",
                        lambda: bfs_multi(g, sources, plan=plan))])
    for name, secs in e2e.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")
    for name, row in rows.items():
        row["bound_ms"] = row["bytes"] / RL.HBM_BW * 1e3
        row["bound_by"] = "bytes"
    del A, g, x, plans, plan
    torch.cuda.empty_cache()

    # slice 2: the segmented-GEMM kernels under the MoE layer and the
    # TreeLSTM wavefront
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    moe = phase_moe_data(args.seed)
    forest = phase_forest_data(args.seed)
    cases = segmm_cases(moe, forest, args.seed)
    route_errs, prepared = phase_segmm_parity(cases)
    e2e2 = {}
    moe_counts = phase_moe(moe, e2e2)
    wave_counts, forest_dag = phase_wavefront(forest, args.seed, e2e2)
    sum_rows = phase_k2_forest(forest, forest_dag, args.seed)
    del forest_dag
    for name in ("segment_sum_sorted", "segment_sum_fixup"):
        rows[name] = sum_rows[name]
        log(f"main-path launches {name}: + {wave_counts[name]} (wavefront)")
        launches[name] += wave_counts[name]
    seg_rows = phase_segmm_times(cases, prepared)
    for name, row in seg_rows.items():
        row["err"] = route_errs.get(name, route_errs["segmm_fma"])
        rows[name] = row
        launches[name] = moe_counts[name] + wave_counts[name]
        log(f"main-path launches {name}: {moe_counts[name]} (moe) + "
            f"{wave_counts[name]} (wavefront)")
    if args.profile:
        from repro_torch.models.treelstm import treelstm_forest
        layer = moe["layers"][0.0]
        layer.schedule, layer.execution_path = "chunked_lpt", "native"
        layer_bf16 = moe["layers_bf16"][0.0]
        layer_bf16.schedule = "chunked_lpt"
        layer_bf16.execution_path = "native"
        x_bf16 = moe["x"].to(torch.bfloat16)
        wave_x = torch.from_numpy(forest["x"]).cuda()
        wave_ops = torch.from_numpy(forest["ops"]).cuda()
        from repro_torch.interop import treelstm_params_from_arrays
        wave_params = treelstm_params_from_arrays(
            {"w": forest["w"], "b": forest["b"]}, device="cuda")
        phase_profile([
            ("moe[skew 0, chunked_lpt@native]", lambda: layer(moe["x"])),
            ("moe bf16[skew 0, chunked_lpt@native]",
             lambda: layer_bf16(x_bf16)),
            ("treelstm_forest[chunked_lpt]", lambda: treelstm_forest(
                wave_params, forest["trees"], wave_x, wave_ops,
                schedule="chunked_lpt", activation=clip16))])
        # the layer's 1.5 GiB of experts would stay on the card through
        # the training phases
        del layer, layer_bf16, x_bf16, wave_x, wave_ops, wave_params
    for name, secs in e2e2.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")
    del moe, forest, cases, prepared
    torch.cuda.empty_cache()

    # slice 3: the banded attention kernel under H2O-Danube3-4B serving
    rows["flash_swa"], prefill_launches, e2e3 = run_slice3(args.seed,
                                                           args.profile)
    launches.update(prefill_launches)
    launches.update(flash_swa_bwd=0, flash_swa_bwd_wgmma=0)
    log(f"main-path launches flash_swa: {launches['flash_swa']} (prefill; "
        f"{launches['flash_swa_wgmma']} on the wgmma kernel)")
    for name, secs in e2e3.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")

    # slice 10: Danube training steps through K7 and its backward
    rows["flash_swa_bwd"], train, e2e4 = run_slice10(args.seed,
                                                     args.profile)
    log(f"main-path launches flash_swa: {launches['flash_swa']} (prefill) "
        f"+ {train['flash_swa']} (training steps)")
    for name in K7_COUNTERS:
        launches[name] += train[name]
    for name, secs in e2e4.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")

    # the LM on a (data, model) mesh of four ranks on this card
    from repro_torch.configs import get_config
    mesh_counts, e2e5 = phase_lm_mesh(get_config(LM_ARCH), args.seed)
    log(f"main-path launches flash_swa: {launches['flash_swa']} (prefill, "
        f"training steps) + {mesh_counts['flash_swa']} (mesh training, "
        f"every rank); flash_swa_bwd: {launches['flash_swa_bwd']} + "
        f"{mesh_counts['flash_swa_bwd']}")
    for name in K7_COUNTERS:
        launches[name] += mesh_counts[name]
    for name, secs in e2e5.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")

    # the GPipe pipeline over four ranks on this card, then the dry run's
    # estimates of the steps of phases 24-26 against their measurements
    pipe_launches, e2e6 = phase_pipeline(get_config(LM_ARCH), args.seed)
    log(f"main-path launches flash_swa: {launches['flash_swa']} (prefill, "
        f"training steps, mesh training) + {pipe_launches['flash_swa']} "
        f"(pipeline, every rank); flash_swa_bwd: {launches['flash_swa_bwd']}"
        f" + {pipe_launches['flash_swa_bwd']}")
    for name in K7_COUNTERS:
        launches[name] += pipe_launches[name]
    for name, secs in e2e6.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")

    # expert parallelism: OLMoE and DeepSeek-MoE on the (2, 2) mesh, K5 on
    # each rank's own experts; then the dry run's estimates of the steps
    # of phases 24-26 and 28 against their measurements
    moe_mesh_counts, e2e7 = phase_moe_mesh(args.seed)
    for name, n in moe_mesh_counts.items():
        log(f"main-path launches {name}: {launches[name]} + {n} (moe mesh: "
            f"sorted prefill and decode, every rank)")
        launches[name] += n
    for name, secs in e2e7.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")

    # tensor parallelism of the SSM blocks: RWKV6-3B and Hymba-1.5B on the
    # (2, 2) and (1, 4) meshes, K7 and its backward under Hymba's band on
    # every rank
    ssm_counts, e2e8 = phase_ssm_mesh(args.seed, card_line)
    if args.parent_src:
        phase_parent_decode(args.parent_src)
    for name, n in ssm_counts.items():
        log(f"main-path launches {name}: {launches[name]} + {n} (ssm mesh: "
            f"Hymba's training steps and prefill, every rank)")
        launches[name] += n
    for name, secs in e2e8.items():
        log(f"e2e {name}: {secs * 1e3:.1f} ms")
    phase_dryrun_check(get_config(LM_ARCH))

    # every main-path launch of K7 and its backward is on the wgmma kernels
    # (each phase checks its route counters): the routes' rows are K7's
    rows["flash_swa_wgmma"] = rows["flash_swa"]
    rows["flash_swa_bwd_wgmma"] = rows["flash_swa_bwd"]
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
