#!/usr/bin/env python3
"""Time the sharded decode step of the SSM models on one CUDA card, for
the port whose sources are under ``--src``.

Four spawned ranks share the card in one gloo group on a ``(data, model)
= (1, 4)`` mesh (NCCL takes one rank a card).  For RWKV6-3B and
Hymba-1.5B at full width and depth in bfloat16 (each rank draws its
blocks of the weights from seed 0), ``serve.decode.make_serve_step``
runs 8 greedy steps of batch 1 (Hymba with its 1,024-slot window ring);
each rank reports the median wall time of a step after the
first and the collectives of a step by kind (``mesh.stats``: calls, MiB,
ms).  Rank 0's numbers are printed, with every rank's step time, and one
JSON line.

``--src`` may point at another checkout's ``src`` (for instance a parent
commit unpacked with ``git archive``), so two versions are timed in one
call, on one card: run parent, change, change, parent.  Four ranks on one
card measure the sharded path's overhead (gloo moves CUDA tensors through
the host), not its scaling.  Exits 2 without a card.

    python3 tools/time_ssm_decode.py [--src DIR]
"""
from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing as mp
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("rwkv6_3b", "hymba_15b")
WORLD = 4
STEPS = 8
TIMEOUT_S = 300


def decode_times(src: str) -> dict:
    """This rank's decode steps for every model of :data:`ARCHS`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import cast_params, init_params
    from repro_torch.serve.decode import make_serve_step, sample_logits

    mesh = make_host_mesh(WORLD, device="cuda")
    dev, bf16 = mesh.device, torch.bfloat16
    out = {"mesh": str(mesh), "port": src}
    for name in ARCHS:
        cfg = get_config(name)
        step, psh, _, cache = make_serve_step(
            cfg, mesh, batch=1, seq_len=cfg.sliding_window or STEPS,
            dtype=bf16)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = cast_params(init_params(cfg, gen, device=dev,
                                         shardings=psh)[0], bf16)
        tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        times, kinds = [], {}
        for t in range(STEPS):
            mesh.stats.reset()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            logits, cache = step(params, tok, t, cache)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
            tok = sample_logits(None, logits, 0.0, vocab_size=cfg.vocab_size)
            if t:
                for (k, n), v in mesh.stats.kinds.items():
                    row = kinds.setdefault(f"{k}@{n}", [0, 0, 0.0])
                    for j in range(3):
                        row[j] += v[j] / (STEPS - 1)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{name}: non-finite logits")
        out[name] = dict(ms=statistics.median(times[1:]) * 1e3,
                         first_ms=times[0] * 1e3, kinds=kinds,
                         layers=cfg.num_layers, last_id=int(tok))
        del params, cache
        torch.cuda.empty_cache()
    return out


def rank_main(rank: int, port: int, args: dict, out_q) -> None:
    sys.path.insert(0, args["src"])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORLD))
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out_q.put((rank, "ok", decode_times(args["src"])))
    except BaseException:                  # reported to the parent
        out_q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="the port's source root (holds repro_torch)")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_ssm_decode: no CUDA device", file=sys.stderr)
        return 2
    src = str(pathlib.Path(args.src).resolve())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    job = dict(src=src)
    procs = [ctx.Process(target=rank_main, args=(r, port, job, out_q),
                         daemon=True) for r in range(WORLD)]
    t0 = time.perf_counter()
    deadline = t0 + 2 * TIMEOUT_S
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < WORLD and time.perf_counter() < deadline:
            try:
                rank, status, res = out_q.get(timeout=5)
            except Exception:
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
    bad = {r: v for r, v in results.items() if v[0] != "ok"}
    if bad or len(results) < WORLD:
        print(f"time_ssm_decode: ranks failed or missing: "
              f"{sorted(set(range(WORLD)) - set(results))}\n"
              + "\n".join(f"rank {r}:\n{v[1]}" for r, v in bad.items()),
              file=sys.stderr)
        return 1
    ranks = [results[r][1] for r in range(WORLD)]
    r0 = ranks[0]
    for name in ARCHS:
        row = r0[name]
        kinds = ", ".join(f"{k} {v[0]:.0f} calls {v[1] / 2**20:.2f} MiB "
                          f"{v[2] * 1e3:.1f} ms"
                          for k, v in sorted(row["kinds"].items()))
        print(f"decode {name} x {row['layers']} layers bf16 on {r0['mesh']} "
              f"(port {src}): {row['ms']:.2f} ms a step (median of steps "
              f"2-{STEPS}; first {row['first_ms']:.1f} ms; ranks "
              f"{[round(r[name]['ms'], 2) for r in ranks]}); collectives "
              f"a step: {kinds} ({card})", flush=True)
    print(json.dumps({"port": src, "card": card, "steps": STEPS,
                      "decode": {n: r0[n] for n in ARCHS},
                      "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
