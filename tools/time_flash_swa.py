#!/usr/bin/env python3
"""Time K7 (``flash_swa``) and its backward on one CUDA card at the main
paths' shapes, for this port and another tree's, in turns in one call.

Cases (bfloat16, batch 1):

* ``serving``: the forward at Danube's prefill launch, S 32,768, 32/8
  heads of 120, window 4,096, no log-sum-exp;
* ``training``: the forward with the log-sum-exp and the backward at
  Danube's training launch, S 8,192, the same heads and window;
* ``hymba rank``: the forward with the log-sum-exp and the backward at a
  ``(1, 4)`` rank's Hymba-1.5B launch, 7 heads of 64 with K/V repeated a
  query head (7 KV heads), window 1,024, S 4,096.

Each case is timed with CUDA events (``chip_smoke.cuda_ms``) and printed
beside its bound (useful flop at 989 TFLOP/s bf16, or bytes at 3.35 TB/s,
the larger), the flop the route executes (``chip_smoke``'s
``wgmma_executed_flop`` / ``mma_executed_flop`` and their backward
twins) and ``scaled_dot_product_attention`` with the band mask on cuDNN
(its backward alone for the backward), timed once.  With ``--src DIR``
the turns are DIR / this / this / DIR (a parent commit unpacked with ``git
archive`` under ``build/``, say), each a subprocess, since two trees'
packages cannot share a process; the last lines compare the turns.  Exits
2 without a card.

    python3 tools/time_flash_swa.py [--src DIR] [--seed N]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (name, S, H, Hkv, hd, window, kernels timed)
CASES = [("serving", 32768, 32, 8, 120, 4096, ("fwd",)),
         ("training", 8192, 32, 8, 120, 4096, ("fwd_lse", "bwd")),
         ("hymba rank", 4096, 7, 7, 64, 1024, ("fwd_lse", "bwd"))]


def one_turn(src: str, seed: int, library: bool) -> int:
    """Time every case on the port under ``src``; one ``RESULT`` JSON line
    each."""
    import torch
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as C
    from repro_torch.kernels.flash_swa import kernel as FK
    from repro_torch.launch import roofline as RL

    FK.build()
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, s, h, hkv, hd, window, kinds in CASES:
        q, k, v, dout = (torch.randn((1, s, n, hd), generator=gen,
                                     device="cuda").to(bf16)
                         for n in (h, hkv, hkv, h))
        out, lse = FK.flash_swa(q, k, v, window=window, qc=128,
                                return_lse=True)
        pairs = C.band_pairs(s, window)
        fwd_route = FK.kernel_for(bf16, hd)
        bwd_route = FK.bwd_kernel_for(bf16, hd)
        for kind in kinds:
            if kind == "bwd":
                fn = lambda: FK.flash_swa_bwd(q, k, v, out, lse, dout,
                                              window=window, qc=128)
                flops = 10 * hd * h * pairs
                nbytes = (2 * s * hd * (3 * h + 2 * hkv) + 4 * h * s
                          + 2 * s * hd * (h + 2 * hkv))
                executed = (C.bwd_wgmma_executed_flop(s, window, h, hd)
                            if bwd_route.endswith("wgmma") else
                            C.bwd_mma_executed_flop(s, window, h, hkv, hd))
                route = bwd_route
            else:
                with_lse = kind == "fwd_lse"
                fn = lambda: FK.flash_swa(q, k, v, window=window, qc=128,
                                          return_lse=with_lse)
                flops = 4 * hd * h * pairs
                nbytes = 2 * s * hd * (2 * h + 2 * hkv) + 4 * h * s * with_lse
                executed = (C.wgmma_executed_flop(s, window, h, hd)
                            if fwd_route.endswith("wgmma") else
                            C.mma_executed_flop(s, window, h, hd))
                route = fwd_route
            ms = C.cuda_ms(fn, warmup=2, iters=10)
            bound_ops = flops / RL.PEAK_FLOPS_BF16 * 1e3
            bound_bytes = nbytes / RL.HBM_BW * 1e3
            lib_ms = None
            if library:
                lib_ms = library_ms(C, q, k, v, dout, s, window, kind)
            print("RESULT " + json.dumps(dict(
                case=name, kind=kind, route=route, ms=ms, flops=flops,
                executed=executed, bound_ms=max(bound_ops, bound_bytes),
                bound_by="operations" if bound_ops >= bound_bytes
                else "bytes", library_ms=lib_ms, S=s, H=h, Hkv=hkv, hd=hd,
                window=window)), flush=True)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return 0


def library_ms(C, q, k, v, dout, s, window, kind):
    """SDPA with the band mask (cuDNN): the forward, or its backward alone
    with the forward's graph kept."""
    import torch
    i = torch.arange(s, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    if kind != "bwd":
        call, _ = C.sdpa_call(q, k, v, band)
        return C.cuda_ms(call, warmup=1, iters=3)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    call, _ = C.sdpa_call(*leaves, band)
    try:
        lib_out = call()
        return C.cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True), warmup=1, iters=3)
    except RuntimeError:           # a backend that refuses the mask
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=None,
                        help="another tree's source root (holds "
                             "repro_torch), timed in turns with this one")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--one", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--library", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_flash_swa: no CUDA device", file=sys.stderr)
        return 2
    if args.one is not None:
        return one_turn(args.one, args.seed, args.library)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    C.phase_card()
    this = str(ROOT / "src")
    turns = ([("this", this)] if args.src is None else
             [("other", args.src), ("this", this), ("this", this),
              ("other", args.src)])
    rows = []
    for i, (tag, src) in enumerate(turns):
        cmd = [sys.executable, __file__, "--one", src, "--seed",
               str(args.seed)] + (["--library"] if i == 1 or len(turns) == 1
                                  else [])
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
        if proc.returncode != 0:
            print(proc.stdout)
            print(f"time_flash_swa: turn {i} ({src}) failed with "
                  f"{proc.returncode}", file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if not line.startswith("RESULT "):
                continue
            r = json.loads(line[len("RESULT "):])
            r["turn"], r["tree"] = i, tag
            rows.append(r)
            C.log(f"turn {i} [{tag}: {src}] {r['case']} {r['kind']} "
                  f"(S {r['S']}, {r['H']}/{r['Hkv']} heads of {r['hd']}, "
                  f"window {r['window']}) on {r['route']}: {r['ms']:.4f} ms,"
                  f" {r['executed'] / r['ms'] / 1e9:.1f} TFLOP/s executed "
                  f"({r['executed'] / r['flops']:.3f}x the useful "
                  f"{r['flops']} flop), {r['bound_ms'] / r['ms']:.1%} of "
                  f"the bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  + (f"; library {r['library_ms']:.4f} ms" if
                     r["library_ms"] else ""))
    for name, *_, kinds in CASES:
        for kind in kinds:
            mine = [r for r in rows if (r["case"], r["kind"]) == (name, kind)]
            times = " / ".join(f"{r['tree']} {r['ms']:.4f}" for r in mine)
            C.log(f"{name} {kind}: {times} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
