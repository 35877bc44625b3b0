"""Training launcher (the reference's ``launch/train.py``).

    python -m repro_torch.launch.train --arch qwen15_05b --reduced \
        --steps 2 --device cpu
    python -m repro_torch.launch.train --arch h2o_danube3_4b --steps 3 \
        --seq 8192 --global-batch 2 --microbatches 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch h2o_danube3_4b --mesh host --model-axis 2 --steps 3

Weights are drawn from ``--seed`` on the device (float32 master weights
and AdamW state); batches come from :func:`data.synthetic.batch_at`, a
pure function of ``(seed, step)``, so a run resumed from ``--ckpt`` (the
newest committed checkpoint) sees the batches it would have seen.
Compute is bfloat16, float32 with ``--reduced``, which also caps the
sequence at 128, the batch at 8 and the microbatches at 2.

``--mesh host`` lays the processes out as ``(data, model)`` with
``--model-axis`` ranks on ``model``; one process is the one-device path.
``single``/``multi`` are the reference's production meshes (256 and 512
ranks).  Started by ``torchrun`` (``WORLD_SIZE`` above 1), the processes
join one group: NCCL when the host has a card for every rank, else
``gloo``, so that ranks may share a card (NCCL takes one rank a card; gloo
moves CUDA tensors through the host).  The first line names the backend.
Each rank draws only
its blocks of the weights and keeps its blocks of the AdamW state; rank 0
writes the checkpoints.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import batch_at, for_model
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.models.lm import init_params, param_count, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.step import (make_train_step, opt_shardings,
                                    param_specs, shardings_for)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks on the model (tensor-parallel) axis of "
                         "--mesh host (the reference has no such flag: its "
                         "host mesh puts every device on data)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression (the wire format)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the loop; returns the last step's metrics as floats."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        args.seq = min(args.seq, 128)
        args.global_batch = min(args.global_batch, 8)
        args.microbatches = min(args.microbatches, 2)
    mesh = launcher_mesh(args.mesh, args.model_axis, args.device)
    device = mesh.device
    print(f"arch={cfg.name} params={param_count(cfg) / 1e9:.2f}B "
          f"mesh={mesh.shape} backend={mesh.backend} device={device}",
          flush=True)

    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps)
    grad_compress = None
    if args.compress_grads:
        from repro_torch.train.compress import compress_roundtrip

        def grad_compress(grads):
            return tree_map(compress_roundtrip, grads)

    step = make_train_step(
        cfg, opt_cfg, mesh, num_microbatches=args.microbatches,
        dtype=torch.float32 if args.reduced else torch.bfloat16,
        grad_compress=grad_compress)
    psh = osh = None
    if mesh.size > 1:
        psh = shardings_for(mesh, param_specs(cfg))
        osh = opt_shardings(mesh, psh)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, _ = init_params(cfg, gen, device=device, shardings=psh)
    opt_state = init_opt_state(params)
    start = 0
    if args.ckpt:
        restored = ckpt.restore_latest(args.ckpt, params, opt_state,
                                       param_sh=psh, opt_sh=osh)
        if restored is not None:
            params, opt_state, meta = restored
            start = meta["step"]
            print(f"resumed @ step {start}", flush=True)

    dcfg = for_model(cfg, seq_len=args.seq, global_batch=args.global_batch,
                     seed=args.seed)
    t0 = time.time()
    metrics = {}
    for i in range(start, args.steps):
        batch = batch_at(dcfg, i, cfg, device=device)
        params, opt_state, m = step(params, opt_state, batch)
        metrics = {k: float(v) for k, v in m.items()}
        if (i + 1) % 10 == 0 or i == start:
            toks = (i + 1 - start) * args.global_batch * args.seq
            print(f"step {i + 1} loss={metrics['loss']:.4f} "
                  f"lr={metrics['lr']:.2e} "
                  f"tok/s={toks / max(time.time() - t0, 1e-9):,.0f}",
                  flush=True)
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt, i + 1, params, opt_state,
                      extra={"arch": cfg.name}, keep=args.keep,
                      param_sh=psh, opt_sh=osh)
    print(f"finished {args.steps - start} steps in {time.time() - t0:.0f}s",
          flush=True)
    return metrics


if __name__ == "__main__":
    main()
