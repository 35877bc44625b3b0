"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the
``meta`` device (the reference's ``launch/dryrun.py``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --mesh both [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun

The reference forces 512 host devices and lowers and compiles each cell's
jitted step against sharded stand-ins.  The port runs each cell's step as
rank 0 of a fake process group (``torch.testing``'s ``fake`` backend: no
peers, collectives return at once) of 256 ranks (the ``(16, 16)`` mesh) or
512 (``(2, 16, 16)``), on ``meta`` tensors from :mod:`.specs`, so nothing
is allocated and no kernel runs.  Per cell it records the reference's
keys, with the port's measures in place of XLA's:

* ``flops``: ``FlopCounterMode``'s count plus the kernels' own
  (:mod:`repro_torch.kernels.tally`: on ``meta`` tensors K7, its backward
  and K5/K6 launch nothing and tally their useful work);
* ``bytes``: what each operation reads and writes (views and bare
  allocations excluded), plus the kernels' tallied bytes;
* ``memory.peak_estimate_bytes``: the step's arguments plus the most bytes
  of storage live at once during the step (:class:`StepTracer` follows
  every storage an operation creates until it is freed);
* the mesh's collective record by kind and group size
  (``launch.mesh.CollectiveStats``), which ``roofline.stats_wire_bytes``
  turns into wire bytes;
* ``trace_s`` in place of ``lower_s`` and ``compile_s``.

On the single-pod mesh the units of one and two layers (one microbatch)
are traced too and composed by ``roofline.compose``, as the reference
does.  A cell that raises is recorded (``error``) and the sweep goes on:
the MoE configs on a split batch raise ``NotImplementedError``, naming
ROADMAP.md queue 3a (expert parallelism).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, cells_for, get_config
from repro_torch.kernels import tally
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import NamedSharding, make_production_mesh
from repro_torch.launch.specs import (decode_input_specs, pick_microbatches,
                                      prefill_input_specs, train_input_specs)
from repro_torch.models.lm import active_param_count, param_count
from repro_torch.train.optimizer import OptConfig

DEFAULT_OUT = "build/dryrun"


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


#: Operations that allocate and write nothing.
_ALLOCATE_ONLY = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided"}


def _moves_bytes(func) -> bool:
    """False for views (they alias their input) and bare allocations."""
    if func._overloadpacket.__name__ in _ALLOCATE_ONLY:
        return False
    rets = func._schema.returns
    return not (rets and all(r.alias_info is not None
                             and not r.alias_info.is_write for r in rets))


class StepTracer(TorchDispatchMode):
    """Follows every storage an operation creates (a weak reference with a
    finalizer each): ``live`` bytes now, ``peak`` the most at once; and
    ``bytes``, what each operation that is neither a view nor a bare
    allocation reads and writes (each tensor operand and result once).
    Storages made before the tracer started are not counted: add the
    step's arguments, and pass them as ``outside`` so that their views and
    in-place updates count as nothing new."""

    def __init__(self, outside=()):
        super().__init__()
        self.live = self.peak = self.bytes = 0
        self._alive = {}
        # storages of ``outside`` (the step's arguments): an operation
        # that returns one of them (a view, an in-place update) creates
        # nothing
        self._outside = {id(t.untyped_storage())
                         for t in tree_flatten(outside)[0]
                         if isinstance(t, torch.Tensor)}

    def _created(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._alive or key in self._outside:
            return
        n = st.nbytes()

        def freed(key=key, n=n):
            if self._alive.pop(key, None) is not None:
                self.live -= n
        self._alive[key] = weakref.finalize(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self._created(t)
        if _moves_bytes(func):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        return out


def trace_step(step, args, mesh=None) -> dict:
    """Run ``step(*args)`` under a ``FlopCounterMode`` and a
    :class:`StepTracer`: ``{"flops", "bytes", "memory", "collectives",
    "kernels", "kernel_flops", "trace_s"}`` (the kernels' tally included in
    the flops and bytes; ``collectives`` the mesh's record of this call,
    ``{(kind, group size): [calls, bytes, seconds]}``)."""
    tally.reset()
    if mesh is not None:
        mesh.stats.reset()
    arg_bytes = _storage_bytes(args)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, StepTracer(args) as tr:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    out_bytes = _storage_bytes(out)
    alias = _storage_bytes([t for t in tree_flatten(out)[0]
                            if isinstance(t, torch.Tensor)
                            and id(t.untyped_storage()) in
                            {id(a.untyped_storage()) for a in
                             tree_flatten(args)[0]
                             if isinstance(a, torch.Tensor)}])
    kinds = {} if mesh is None else dict(mesh.stats.kinds)
    return {
        "flops": float(fc.get_total_flops() + tally.TALLY["flops"]),
        "bytes": float(tr.bytes + tally.TALLY["bytes"]),
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "alias_size_in_bytes": alias,
                   "temp_size_in_bytes": tr.peak,
                   "peak_estimate_bytes": arg_bytes + tr.peak},
        "collectives": kinds,
        "kernels": dict(tally.TALLY["calls"]),
        "kernel_flops": float(tally.TALLY["flops"]),
        "trace_s": trace_s,
    }


def build_cell(cfg, case, mesh, n_micro):
    """``(step, args)`` for one cell: the port's step on ``mesh`` and its
    stand-ins (:mod:`.specs`)."""
    if case.kind == "train":
        from repro_torch.train.step import make_train_step
        step = make_train_step(cfg, OptConfig(), mesh,
                               num_microbatches=n_micro)
        return step, train_input_specs(cfg, case, mesh)[0]
    if case.kind == "prefill":
        from repro_torch.models.lm import prefill
        from repro_torch.serve.decode import _data_axes, cache_pspecs
        from repro_torch.train.step import shardings_for
        args, _ = prefill_input_specs(cfg, case, mesh)
        cache_sh = shardings_for(mesh, cache_pspecs(cfg, mesh,
                                                    case.global_batch))
        daxes = _data_axes(mesh, case.global_batch) or None
        rows = NamedSharding(mesh, (daxes, None))
        rows3 = NamedSharding(mesh, (daxes, None, None))

        @torch.no_grad()
        def step(params, tokens, prefix=None):
            logits, cache = prefill(
                params, cfg, rows.shard(tokens),
                None if prefix is None else rows3.shard(prefix),
                dtype=torch.bfloat16, mesh=mesh, cache_sh=cache_sh)
            return rows3.gather(logits), cache
        return step, args
    from repro_torch.serve.decode import make_serve_step
    step, _, _, _ = make_serve_step(cfg, mesh, batch=case.global_batch,
                                    seq_len=case.seq_len)
    return step, decode_input_specs(cfg, case, mesh)[0]


def unit_cfg(cfg, num_layers):
    return dataclasses.replace(cfg, num_layers=num_layers,
                               scan_layers=False, unroll_inner_scans=True)


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as ``rank`` of a fake process group of ``world`` ranks
    (collectives return at once), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _write(rec: dict, out_dir: str, tag: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             do_roofline: bool, out_dir: str, cfg=None,
             case=None) -> dict:
    """Trace one cell on the fake group and write its record
    (``out_dir/<arch>__<shape>__<single|multi>.json``).  ``cfg`` and
    ``case`` replace the registry's config and shape (tests pass reduced
    ones).  A cell that raises is recorded with its ``error`` and the
    exception re-raised."""
    cfg = get_config(arch) if cfg is None else cfg
    case = SHAPES[shape_name] if case is None else case
    suffix = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{suffix}"
    rec = {"arch": arch, "shape": shape_name,
           "mesh": [2, 16, 16] if multi_pod else [16, 16],
           "multi_pod": multi_pod, "kind": case.kind,
           "params": param_count(cfg),
           "params_active": active_param_count(cfg)}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        n_micro = pick_microbatches(cfg, case, mesh)
        rec["num_microbatches"] = n_micro
        try:
            # --- the production step (the dry run's deliverable) --------
            step, args = build_cell(cfg, case, mesh, n_micro)
            t = trace_step(step, args, mesh)
            del step, args
            rec["trace_s"] = round(t["trace_s"], 1)
            rec["memory"] = t["memory"]
            rec["cost_analysis_raw"] = {"flops": t["flops"],
                                        "bytes": t["bytes"],
                                        "kernel_flops": t["kernel_flops"]}
            rec["kernels"] = t["kernels"]
            rec["collectives"] = {f"{kind}@{n}": v for (kind, n), v
                                  in t["collectives"].items()}
            if do_roofline:
                rec["roofline"] = _roofline(cfg, case, mesh, n_micro, rec)
        except Exception as e:             # recorded; the caller goes on
            rec["error"] = f"{type(e).__name__}: {e}"
            _write(rec, out_dir, tag)
            raise
    _write(rec, out_dir, tag)
    return rec


def _roofline(cfg, case, mesh, n_micro: int, rec: dict) -> dict:
    """The L = 1 and L = 2 units (one microbatch), composed."""
    case_unit = case
    if case.kind == "train":
        case_unit = dataclasses.replace(
            case, global_batch=case.global_batch // n_micro)
    units = []
    for nl in (1, 2):
        ustep, uargs = build_cell(unit_cfg(cfg, nl), case_unit, mesh, 1)
        u = trace_step(ustep, uargs, mesh)
        del ustep, uargs
        units.append(RL.unit_metrics(u["flops"], u["bytes"],
                                     u["collectives"]))
    total = RL.compose(units[0], units[1], cfg.num_layers, n_micro)
    mf = RL.model_flops(cfg, case, rec["params_active"])
    flops_global = total.flops * mesh.size
    return {
        "flops_per_device": total.flops,
        "hbm_bytes_per_device": total.hbm_bytes,
        "wire_bytes_per_device": total.wire_bytes,
        "wire_by_kind": total.wire_by_kind,
        **{k: float(v) for k, v in total.terms().items()},
        "bottleneck": total.bottleneck(),
        "model_flops_global": mf,
        "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([n for n, _ in cells_for(cfg)] if args.shape == "all"
                  else args.shape.split(","))
        for shape_name in shapes:
            for multi in meshes:
                suffix = "multi" if multi else "single"
                tag = f"{arch}__{shape_name}__{suffix}"
                path = os.path.join(args.out, f"{tag}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                # roofline only on the single-pod mesh, as the reference
                do_roof = (not multi) and (not args.no_roofline)
                print(f"[cell] {tag} ...", flush=True)
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape_name, multi_pod=multi,
                                   do_roofline=do_roof, out_dir=args.out)
                    extra = ""
                    if "roofline" in rec:
                        r = rec["roofline"]
                        extra = (f" bottleneck={r['bottleneck']}"
                                 f" compute={r['compute_s']:.4f}s"
                                 f" mem={r['memory_s']:.4f}s"
                                 f" coll={r['collective_s']:.4f}s")
                    peak = rec["memory"]["peak_estimate_bytes"] / 2 ** 30
                    print(f"[ok]   {tag} ({time.time() - t0:.0f}s)"
                          f" peak={peak:.2f}GiB" + extra, flush=True)
                except Exception as e:  # record and continue
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    if not isinstance(e, NotImplementedError):
                        traceback.print_exc()
    print(f"\n{len(failures)} failures")
    for tag, err in failures:
        print(f"  {tag}: {err}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
