"""Serving launcher: build a decode step for an (arch, batch, cache length)
and run a batched decode loop from token 0.

    python -m repro_torch.launch.serve --arch h2o_danube3_4b --batch 4 \
        --seq 1024 --tokens 16
    python -m repro_torch.launch.serve --arch rwkv6_3b --reduced \
        --tokens 32 --device cpu

One device only.  Weights are drawn from ``--seed`` on the device and cast
once to the serving dtype (bfloat16; float32 with ``--reduced``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.lm import DecoderLM
from repro_torch.serve.decode import make_serve_step, sample_logits


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", help="LM architecture (decode mode)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024, help="KV cache length")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--mesh", choices=["host"], default="host",
                    help="one device; the production meshes wait for "
                         "sharding (ROADMAP.md, queue 1, item 13)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--graph", action="store_true",
                    help="serve graph queries (not ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.graph:
        raise NotImplementedError(
            "--graph: graph-query serving (serve/graph.py) is not ported "
            "yet (ROADMAP.md, queue 1, item 12)")
    if args.arch is None:
        ap.error("--arch is required")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        args.seq = min(args.seq, 64)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    step, cache = make_serve_step(cfg, batch=args.batch, seq_len=args.seq,
                                  dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = DecoderLM.from_config(cfg, gen, device=device,
                                   dtype=dtype).params()

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
