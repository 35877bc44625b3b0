#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors on this card, and how long a
sharded-traversal-sized ``all_gather`` takes.

Besides the sharded traversal's collectives it tries those of the LM's
``(data, model)`` mesh: bfloat16 gathers and sums, ``reduce_scatter_tensor``
(the FSDP gradient) in float32 and bfloat16, and a sum over a sub-group
made with ``new_group``.

Run on a machine with a card: ``python3 tools/probe_gloo_cuda.py``.  For 2
and then 4 spawned ranks sharing ``cuda:0`` in one ``gloo`` group, it tries
each collective the sharded traversal (``repro_torch.launch.mesh``) uses
on CUDA tensors and prints ``ok`` or the error, then times three
``all_gather_into_tensor`` calls of a ``[2**22 + 8]`` float32 tensor (one
rank's slice of the LiveJournal cell's state at S = 4) between two
synchronizes.  The card's name and power limit come first.
"""
import datetime
import subprocess
import sys
import time


def run(rank, world, port, out_q):
    import torch
    import torch.distributed as dist
    out = {}
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        dev = torch.device("cuda:0")
        # every rank makes every sub-group, in one order
        pairs = [dist.new_group([2 * i, 2 * i + 1])
                 for i in range(world // 2)]
        f32 = lambda n, v=1.0: torch.full((n,), float(v), device=dev)
        cases = {
            "all_gather_into_tensor float32": lambda: (
                dist.all_gather_into_tensor(f32(world * 4), f32(4, rank))),
            "all_gather_into_tensor uint8": lambda: (
                dist.all_gather_into_tensor(
                    torch.empty(world * 4, dtype=torch.uint8, device=dev),
                    torch.ones(4, dtype=torch.uint8, device=dev))),
            "all_gather_into_tensor int64": lambda: (
                dist.all_gather_into_tensor(
                    torch.empty(world * 4, dtype=torch.int64, device=dev),
                    torch.ones(4, dtype=torch.int64, device=dev))),
            "all_reduce SUM float32": lambda: dist.all_reduce(f32(4)),
            "all_reduce MIN float32": lambda: dist.all_reduce(
                f32(4), dist.ReduceOp.MIN),
            "broadcast_object_list": lambda: dist.broadcast_object_list(
                ["x"], src=0),
            "all_gather_into_tensor bfloat16": lambda: (
                dist.all_gather_into_tensor(
                    f32(world * 4).bfloat16(), f32(4, rank).bfloat16())),
            "all_reduce SUM bfloat16": lambda: dist.all_reduce(
                f32(4).bfloat16()),
            "reduce_scatter_tensor float32": lambda: (
                dist.reduce_scatter_tensor(f32(4), f32(world * 4))),
            "reduce_scatter_tensor bfloat16": lambda: (
                dist.reduce_scatter_tensor(f32(4).bfloat16(),
                                           f32(world * 4).bfloat16())),
            "all_reduce SUM on a new_group sub-group": lambda: (
                dist.all_reduce(f32(4), group=pairs[rank // 2])),
        }
        for name, call in cases.items():
            try:
                call()
                torch.cuda.synchronize()
                out[name] = "ok"
            except Exception as exc:           # reported, not raised
                out[name] = repr(exc)[:200]
            dist.barrier()
        x = f32(2 ** 22 + 8)
        gathered = f32(world * x.numel())
        for k in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_gather_into_tensor(gathered, x)
            torch.cuda.synchronize()
            out[f"gather of {world} x 16.8 MB, call {k}, ms"] = (
                time.perf_counter() - t0) * 1e3
    except Exception as exc:                   # reported to the parent
        out["error"] = repr(exc)[:300]
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    out_q.put((rank, out))


def main() -> int:
    import multiprocessing as mp
    import socket
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    ctx = mp.get_context("spawn")
    for world in (2, 4):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        out_q = ctx.Queue()
        procs = [ctx.Process(target=run, args=(r, world, port, out_q))
                 for r in range(world)]
        for p in procs:
            p.start()
        results = dict(out_q.get(timeout=180) for _ in procs)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        print(f"{world} ranks on cuda:0, rank 0:")
        for name, value in results[0].items():
            print(f"  {name}: {value}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
