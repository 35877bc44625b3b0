"""Serving launcher: build a decode step for an (arch, batch, cache length)
and run a batched decode loop from token 0 — or, with ``--graph``, a
continuous-batching graph-query serving loop.

    python -m repro_torch.launch.serve --arch h2o_danube3_4b --batch 4 \
        --seq 1024 --tokens 16
    python -m repro_torch.launch.serve --arch rwkv6_3b --reduced \
        --tokens 32 --device cpu
    python -m repro_torch.launch.serve --graph --queries 32 --lanes 8

Weights are drawn from ``--seed`` on the device and cast once to the
serving dtype (bfloat16; float32 with ``--reduced``); the graph is drawn
from ``--seed`` too.  ``--mesh host|single|multi`` as ``launch.train``
builds them (``torchrun`` with ``WORLD_SIZE`` above 1 joins an NCCL
group when there is a card for every rank, else a ``gloo`` one; one
process is the one-device path): each rank draws its blocks of
the weights, holds its blocks of the cache, and every rank samples the
same tokens from the same logits.  Graph serving runs on one device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.mesh import launcher_mesh, sharded
from repro_torch.models.lm import cast_params, init_params
from repro_torch.serve.decode import make_serve_step, sample_logits


def run_graph_serving(args) -> None:
    """Drive a synthetic arrival stream through :class:`GraphServer`:
    Poisson arrivals (``--arrival-rate`` per tick), kinds uniform over
    BFS/SSSP/PageRank, sources uniform, all from ``--seed``."""
    from repro_torch.serve.graph import GraphServer
    from repro_torch.sparse import CSR, Graph, random_csr

    device = resolve_device(args.device)
    A = random_csr(args.graph_vertices, args.graph_vertices,
                   args.graph_edges, skew=1.3, empty_frac=0.1,
                   seed=args.seed, device=device)
    g = Graph(CSR(A.row_offsets, A.col_indices, A.values.abs() + 0.05,
                  A.shape, A.nnz))
    srv = GraphServer(g, lanes=args.lanes, direction=args.direction)
    rng = np.random.default_rng(args.seed)
    kinds = ["bfs", "sssp", "pagerank"]

    results = []
    submitted = 0
    t0 = time.perf_counter()
    while submitted < args.queries or srv.queued or srv.in_flight:
        if submitted < args.queries:
            for _ in range(min(int(rng.poisson(args.arrival_rate)),
                               args.queries - submitted)):
                kind = kinds[int(rng.integers(len(kinds)))]
                srv.submit(kind, source=int(rng.integers(g.num_vertices)))
                submitted += 1
        results.extend(srv.tick())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    lat = sorted(r.latency * 1e3 for r in results)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(np.ceil(0.99 * len(lat))) - 1)]
    by_kind = {k: sum(r.kind == k for r in results) for k in kinds}
    print(f"{len(results)} queries ({by_kind}) on V={g.num_vertices} "
          f"E={g.num_edges} through {args.lanes} lanes in {dt:.2f}s "
          f"({len(results)/dt:.1f} q/s)")
    print(f"latency p50={p50:.1f}ms p99={p99:.1f}ms | "
          f"steps={srv.steps} step_traces={srv.step_traces} "
          f"admit_traces={srv.admit_traces}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", help="LM architecture (decode mode)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024, help="KV cache length")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks on the model axis of --mesh host (the "
                         "reference has no such flag)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--graph", action="store_true",
                    help="serve graph queries instead of LM decode")
    ap.add_argument("--graph-vertices", type=int, default=600)
    ap.add_argument("--graph-edges", type=int, default=4000)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--queries", type=int, default=24)
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="mean query arrivals per serving tick")
    ap.add_argument("--direction", choices=["auto", "pull", "push"],
                    default="pull")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.graph:
        if args.mesh != "host" or args.model_axis != 1:
            raise ValueError("--graph serves on one device; --mesh and "
                             "--model-axis apply to LM decode")
        run_graph_serving(args)
        return
    if args.arch is None:
        ap.error("--arch is required unless --graph is given")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        args.seq = min(args.seq, 64)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    mesh = launcher_mesh(args.mesh, args.model_axis, args.device)
    device = mesh.device
    step, psh, _, cache = make_serve_step(cfg, sharded(mesh),
                                          batch=args.batch,
                                          seq_len=args.seq, dtype=dtype,
                                          device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = cast_params(init_params(cfg, gen, device=device,
                                     shardings=psh)[0], dtype)

    sampler = torch.Generator(device=device).manual_seed(args.seed + 1)
    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    outs = []
    for t in range(args.tokens):
        logits, cache = step(params, tok, t, cache)
        tok = sample_logits(sampler, logits, args.temperature,
                            vocab_size=cfg.vocab_size)
        outs.append(tok)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"{args.tokens} tokens x {args.batch} batch in {dt:.2f}s "
          f"({args.tokens * args.batch / dt:.1f} tok/s)")
    print("sample:", torch.cat(outs, 1)[0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
