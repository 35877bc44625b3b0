"""Spawned ``torch.distributed`` groups for the sharded traversal's and
the sharded LM's tests.

:func:`run_group` starts ``world`` processes (the ``spawn`` start method),
joins them into a ``gloo`` group on the CPU with a timeout of its own, runs
one job of :data:`JOBS` on every rank and returns every rank's result.  The
ranks import only torch and the port; the test hands them their inputs as
numpy arrays.  A rank that raises, or a group that outlives its deadline,
fails the call, and no rank is left running.

The jobs run SPMD, as a user of the sharded drivers would: every rank
makes the same calls and returns the global answers (numpy), plus its own
shard's plan arrays where a job asks for them.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import socket
import time
import traceback

import numpy as np

#: A group's own collective timeout (``init_process_group(timeout=)``).
GROUP_TIMEOUT_S = 60

#: Schedule x path cases of the reference's acceptance matrix
#: (``_conformance.SCHEDULE_PATH_CASES``, repeated here: the ranks do not
#: import JAX).
SCHEDULE_PATH_CASES = tuple(
    (s, p) for s in ("thread_mapped", "group_mapped", "nonzero_split",
                     "merge_path", "chunked", "adaptive")
    for p in ("pure", "native"))

BOUNDARIES = ("edge_balanced", "equal_width", "lpt_contiguous")
MB = dict(schedule="merge_path", path="pure", num_blocks=4)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, job, payload, timeout_s, out_q):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        out_q.put((rank, "ok", JOBS[job](world, payload)))
    except BaseException:                    # reported to the parent
        out_q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_group(world: int, job: str, payload=None, *,
              timeout_s: float = GROUP_TIMEOUT_S,
              deadline_s: float | None = None) -> list:
    """Every rank's result of ``JOBS[job](world, payload)``, in rank order.
    Raises ``RuntimeError`` with the failing ranks' tracebacks, or
    ``TimeoutError`` past ``deadline_s`` (default: the group timeout plus
    a minute); either way every rank has ended when it returns."""
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, job, payload, timeout_s,
                               out_q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + (deadline_s or timeout_s + 60)
    results = {}
    try:
        while len(results) < world:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"{job}: {world - len(results)} of "
                                   f"{world} ranks still running")
            try:
                rank, status, out = out_q.get(timeout=min(remaining, 1.0))
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and \
                        not any(p.is_alive() for p in procs):
                    break
                continue
            results[rank] = (status, out)
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = {r: out for r, (status, out) in results.items()
              if status != "ok"}
    missing = sorted(set(range(world)) - set(results))
    if errors or missing:
        raise RuntimeError(f"{job} on {world} ranks: missing ranks "
                           f"{missing}; " + "\n".join(
                               f"rank {r}:\n{tb}" for r, tb in
                               sorted(errors.items())))
    return [results[r][1] for r in range(world)]


# ---------------------------------------------------------------------------
# jobs (run on every rank)
# ---------------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy()


def _graph(w):
    from repro_torch.sparse import Graph
    return Graph.from_dense(np.asarray(w, np.float32), device="cpu")


def _plan_arrays(splan) -> dict:
    """This rank's shard of the plan, as the reference stacks it."""
    lp = splan.plan
    out = {"pull_offsets": _np(lp.spec.tile_offsets),
           "push_offsets": _np(lp.push_spec.tile_offsets),
           "src": _np(lp.src), "weight": _np(lp.weight), "dst": _np(lp.dst),
           "push_weight": _np(lp.push_weight), "push_src": _np(lp.push_src),
           "out_degrees": _np(lp.out_degrees),
           "pull_valid": _np(splan.pull_valid),
           "push_valid": _np(splan.push_valid),
           "glob2pad": _np(splan.glob2pad), "pad2glob": _np(splan.pad2glob),
           "boundaries": np.asarray(splan.boundaries),
           "shard_size": splan.shard_size,
           "e_pull": lp.spec.num_atoms, "e_push": lp.push_spec.num_atoms,
           "threshold": splan.direction_threshold,
           "compact_capacity": lp.compact_capacity,
           "pull_spans": (lp.part.atom_span, lp.part.tile_span),
           "push_spans": (lp.push_part.atom_span, lp.push_part.tile_span)}
    if lp.delta is not None:
        out.update(delta=lp.delta, light_mask=_np(lp.light_mask),
                   push_light_mask=_np(lp.push_light_mask),
                   light_out_degrees=_np(lp.light_out_degrees))
    return out


def matrix_job(S: int, data: dict) -> dict:
    """Every case of ``tests/test_torch_shard.py`` that needs ``S`` ranks:
    ``{case: result}``."""
    # the "auto" case writes the port's autotune cache: the test's file
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = data["autotune_cache"]
    import repro_torch.sparse as TS
    from repro_torch.launch.mesh import make_graph_mesh

    mesh = make_graph_mesh(S, device="cpu")
    g, gd = _graph(data["graph"]), _graph(data["dyadic"])
    out = {"mesh": str(mesh)}

    def build(graph, **kw):
        kw.setdefault("shard_schedule", "equal_width")
        return TS.build_sharded_advance(graph, mesh, **kw)

    def bfs_pair(splan, **kw):
        d, p = TS.sharded_bfs(splan, 0, return_parents=True, **kw)
        return _np(d), _np(p)

    for sched, path in SCHEDULE_PATH_CASES:
        kw = dict(schedule=sched, path=path, num_blocks=4)
        sp = build(g, **kw)
        out[f"bfs/{sched}/{path}"] = bfs_pair(sp)
        out[f"sssp/{sched}/{path}"] = _np(TS.sharded_sssp(sp, 0))
        out[f"pr_dyadic/{sched}/{path}"] = _np(TS.sharded_pagerank(
            build(gd, **kw), damping=0.5, num_iters=3, tol=0.0))
    sp = build(g, **MB)
    out["plan/equal_width"] = _plan_arrays(sp)
    for d in ("auto", "pull", "push"):
        out[f"dir_bfs/{d}"] = _np(TS.sharded_bfs(sp, 0, direction=d))
        out[f"dir_sssp/{d}"] = _np(TS.sharded_sssp(sp, 0, direction=d))
    out["bfs_plain"] = _np(TS.sharded_bfs(sp, 0))
    out["pr12"] = _np(TS.sharded_pagerank(sp, num_iters=12))
    out["pr20"] = _np(TS.sharded_pagerank(sp, num_iters=20))
    out["pr_push"] = _np(TS.sharded_pagerank(sp, num_iters=12,
                                             direction="push"))
    out["multi"] = _np(TS.sharded_bfs_multi(sp, [0, 5, 11]))
    out["multi_auto"] = _np(TS.sharded_bfs_multi(sp, [0, 5, 11],
                                                 direction="auto"))
    out["with_delta"] = (sp.delta, _np(TS.sharded_delta_stepping(
        sp.with_delta(None), 0)))
    for sched, path in (("merge_path", "pure"), ("chunked", "native"),
                        ("group_mapped", "pure")):
        spd = build(g, schedule=sched, path=path, num_blocks=4,
                    delta="auto")
        out[f"delta/{sched}/{path}"] = _np(TS.sharded_delta_stepping(spd, 0))
    sp3 = build(g, delta=3.0, **MB)
    out["delta3"] = _np(TS.sharded_delta_stepping(sp3, 0, delta=3.0))
    for name, compact in (("auto", True), ("fraction", 0.25),
                          ("explicit", 17)):
        out[f"capacity/{name}"] = build(
            g, compact=compact, **MB).template.compact_capacity
    spc = build(g, delta="auto", compact=True, **MB)
    out["plan/compact_delta"] = _plan_arrays(spc)
    d, c = TS.sharded_delta_stepping(spc, 0, return_direction_counts=True)
    out["delta_compact"] = (_np(d), _np(c))
    for b in BOUNDARIES:
        spb = TS.build_sharded_advance(g, mesh, shard_schedule=b,
                                       delta="auto", **MB)
        out[f"plan/{b}"] = _plan_arrays(spb)
        out[f"boundary/{b}"] = (spb.shard_schedule, bfs_pair(spb),
                                _np(TS.sharded_sssp(spb, 0)),
                                _np(TS.sharded_delta_stepping(spb, 0)))
    spe = TS.build_sharded_advance(g, mesh, shard_schedule="edge_balanced",
                                   **MB)
    out["uneven"] = (_np(TS.sharded_bfs_multi(spe, [0, 5, 11])),
                     _np(TS.sharded_pagerank(spe, num_iters=8)))
    auto = TS.build_sharded_advance(g, None, schedule="auto")
    out["auto"] = (auto.num_shards, str(auto.schedule.value),
                   str(auto.path.value), auto.boundaries,
                   _np(TS.sharded_bfs(auto, 0)))
    if S == 2:
        out["driver"] = {
            "bfs": _np(TS.bfs(g, 0, mesh=mesh, **MB)),
            "bfs_int": _np(TS.bfs(g, 0, mesh=2, **MB)),
            "sssp_plan": _np(TS.sssp(g, 0, plan=build(g, **MB))),
            "pagerank": _np(TS.pagerank(g, num_iters=8, mesh=mesh, **MB)),
            "delta": _np(TS.delta_stepping(g, 0, mesh=mesh, compact=None,
                                           **MB)),
            "bfs_multi": _np(TS.bfs_multi(g, [0, 5, 11], mesh=mesh, **MB))}
        for b in ("edge_balanced", "lpt_contiguous"):
            out["driver"][f"bfs/{b}"] = _np(TS.bfs(g, 0, mesh=mesh,
                                                   shard_schedule=b, **MB))
            out["driver"][f"sssp/{b}"] = _np(TS.sssp(g, 0, mesh=mesh,
                                                     shard_schedule=b, **MB))
        single = _graph(np.zeros((1, 1), np.float32))
        out["single_vertex"] = _np(TS.sharded_bfs(
            TS.build_sharded_advance(single, mesh, **MB), 0))
    if S == 4:
        for name, w in data["adversarial"].items():
            ga = _graph(w)
            spa = TS.build_sharded_advance(ga, mesh, schedule="group_mapped",
                                           path="pure", num_blocks=4)
            out[f"adversarial/{name}"] = (_np(TS.sharded_bfs(spa, 0)),
                                          _np(TS.sharded_sssp(spa, 0)))
    if S == 8:
        tiny = _graph(data["tiny"])
        spt = TS.build_sharded_advance(tiny, mesh, schedule="merge_path",
                                       path="pure")
        out["tiny"] = (spt.num_shards, _np(TS.sharded_bfs(spt, 0)),
                       _np(TS.sharded_sssp(spt, 0)))
        errors = []
        for b in ("edge_balanced", "lpt_contiguous"):
            try:
                TS.build_sharded_advance(tiny, mesh, schedule="merge_path",
                                         path="pure", shard_schedule=b)
            except ValueError as e:
                errors.append(str(e))
        out["tiny_rejects"] = errors
    return out


def nan_job(S: int, data: dict) -> dict:
    """The push ``min`` combine with NaN in one rank's partial, beside the
    collective ``all_reduce(MIN)`` on the same partials; and sharded push
    SSSP over a graph with a NaN weight."""
    import torch
    import torch.distributed as dist
    import repro_torch.sparse as TS
    from repro_torch.core import (WorkSpec, execute_sharded_scatter_reduce,
                                  make_partition)
    from repro_torch.core.execute import COMBINER_COLLECTIVE
    from repro_torch.launch.mesh import make_graph_mesh

    mesh = make_graph_mesh(S, device="cpu")
    # one atom a tile, scattered to its own output; rank r's value at
    # output r is NaN, every other value finite
    n_out = 2 * S
    spec = WorkSpec.from_segment_offsets(
        torch.arange(n_out + 1, dtype=torch.int32), num_atoms=n_out)
    part = make_partition(spec, "merge_path", 2)
    vals = torch.full((n_out,), 10.0 + mesh.rank)
    vals[mesh.rank] = float("nan")
    combined = execute_sharded_scatter_reduce(
        spec, part, lambda e: vals[e], torch.arange(n_out), n_out,
        mesh=mesh, path="pure", combiner="min")
    partial = vals.clone()
    dist.all_reduce(partial, op=COMBINER_COLLECTIVE["min"])
    gw = _graph(data["nan_graph"])
    sp = TS.build_sharded_advance(gw, mesh, **MB)
    return {"combined": _np(combined), "collective_min": _np(partial),
            "sssp_push": _np(TS.sharded_sssp(sp, 0, direction="push")),
            "sssp_pull": _np(TS.sharded_sssp(sp, 0, direction="pull"))}


def failing_job(S: int, data: dict) -> dict:
    """Rank 1 raises before the first collective; the others wait in it."""
    import torch
    from repro_torch.launch.mesh import make_graph_mesh

    mesh = make_graph_mesh(S, device="cpu")
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return {"gathered": _np(mesh.all_gather(torch.ones(3)))}


def _tensors(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return _np(tree)


def lm_train_job(world: int, data: dict) -> dict:
    """The sharded train step on ``(world // m, m)`` meshes, every case of
    ``data["cases"]``: ``loss_and_grads`` on each batch (the gradients
    gathered whole), then ``make_train_step`` twice (the parameters
    gathered whole).  With ``data["ckpt_dir"]`` the last case's trained
    state is saved from its mesh and restored onto ``(1, world)`` and
    ``(world, 1)``.  Rank 0 returns the arrays; every rank its losses."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import (lm_params_from_arrays,
                                     opt_state_from_arrays)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (gather_tree, loss_and_grads,
                                        make_train_step, opt_shardings,
                                        param_specs, shardings_for)

    out = {}
    for name, case in data["cases"].items():
        cfg = get_config(case["arch"]).reduced(**case["overrides"])
        mesh = make_host_mesh(case["model_axis"], device="cpu")
        psh = shardings_for(mesh, param_specs(cfg))
        osh = opt_shardings(mesh, psh)
        n = case["microbatches"]
        res = {"mesh": str(mesh), "shape": mesh.shape}
        for key, batch in case["batches"].items():
            params = lm_params_from_arrays(case["params"], device="cpu",
                                           shardings=psh)
            loss, metrics, grads = loss_and_grads(
                params, cfg, _tensors(batch), n, torch.float32, mesh=mesh)
            whole = _numpy(gather_tree(grads, psh))
            res[f"loss/{key}"] = (float(loss), float(metrics["ntokens"]))
            if mesh.rank == 0:
                res[f"grads/{key}"] = whole
        params = lm_params_from_arrays(case["params"], device="cpu",
                                       shardings=psh)
        opt = opt_state_from_arrays(case["opt"], device="cpu",
                                    shardings=osh)
        step = make_train_step(cfg, OptConfig(**data["opt_cfg"]), mesh,
                               num_microbatches=n, dtype=torch.float32)
        res["metrics"] = []
        for batch in case["steps"]:
            params, opt, m = step(params, opt, _tensors(batch))
            res["metrics"].append({k: float(v) for k, v in m.items()})
        trained = _numpy(gather_tree(params, psh))
        if mesh.rank == 0:
            res["params"] = trained
        ckpt_dir = data.get("ckpt_dir")
        if ckpt_dir and name == list(data["cases"])[-1]:
            ckpt.save(ckpt_dir, 2, params, opt, param_sh=psh, opt_sh=osh)
            full_opt = _numpy(gather_tree(opt, osh))
            for m in (1, world):
                other = make_host_mesh(m, device="cpu")
                psh2 = shardings_for(other, param_specs(cfg))
                osh2 = opt_shardings(other, psh2)
                p2, o2, meta = ckpt.restore(ckpt_dir, 2, params, opt,
                                            param_sh=psh2, opt_sh=osh2)
                local_shapes = {k: tuple(v.shape) for k, v in
                                _flat(p2).items()}
                back = (_numpy(gather_tree(p2, psh2)),
                        _numpy(gather_tree(o2, osh2)))
                if mesh.rank == 0:
                    res[f"restored/{other.shape['data']}x"
                        f"{other.shape['model']}"] = (
                        _same(back[0], trained) and _same(back[1], full_opt),
                        meta["step"], local_shapes)
        out[name] = res
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _same(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
        and fa[k].tobytes() == fb[k].tobytes()
        for k in fa)


def lm_serve_job(world: int, data: dict) -> dict:
    """``make_serve_step`` on ``(world // m, m)`` meshes for every case of
    ``data["cases"]``: the prompt's tokens fed one a step, every step's
    logits (rank 0 returns them; every rank its last ones' checksum);
    then ``launch.serve --mesh host`` (and ``launch.train --mesh host``)
    on the launcher arguments of ``data``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_from_arrays
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.decode import make_serve_step

    out = {}
    for name, case in data["cases"].items():
        cfg = get_config(case["arch"]).reduced(**case["overrides"])
        mesh = make_host_mesh(case["model_axis"], device="cpu")
        tokens = case["tokens"]                     # [B, steps]
        step, psh, csh, cache = make_serve_step(
            cfg, mesh, batch=tokens.shape[0], seq_len=case["seq_len"],
            dtype=torch.float32)
        params = lm_params_from_arrays(case["params"], device="cpu",
                                       shardings=psh)
        logits = []
        for t in range(tokens.shape[1]):
            lg, cache = step(params, torch.from_numpy(tokens[:, t:t + 1]),
                             t, cache)
            logits.append(_np(lg))
        res = {"specs": {k: sh.spec for k, sh in csh.items()},
               "cache_shapes": {k: tuple(c.shape) for k, c in cache.items()},
               "checksum": float(np.abs(logits[-1]).sum())}
        if mesh.rank == 0:
            res["logits"] = np.stack(logits)
        out[name] = res
    if data.get("serve_argv"):
        import contextlib
        import io
        from repro_torch.launch import serve, train
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(data["serve_argv"])
            metrics = train.main(data["train_argv"])
        out["launchers"] = (buf.getvalue(), metrics)
    return out


def lm_prefill_job(world: int, data: dict) -> dict:
    """``prefill(mesh=)`` on ``(world // m, m)`` meshes for every case of
    ``data``: this rank's rows of the prompt and blocks of the weights in,
    the logits gathered over the batch axes and the caches gathered whole
    out (rank 0 returns them)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_from_arrays
    from repro_torch.launch.mesh import NamedSharding, make_host_mesh
    from repro_torch.models.lm import prefill
    from repro_torch.serve.decode import _data_axes, cache_pspecs
    from repro_torch.train.step import param_specs, shardings_for

    out = {}
    for name, case in data.items():
        cfg = get_config(case["arch"]).reduced(**case["overrides"])
        mesh = make_host_mesh(case["model_axis"], device="cpu")
        tokens = torch.from_numpy(case["tokens"])
        b = tokens.shape[0]
        psh = shardings_for(mesh, param_specs(cfg))
        csh = shardings_for(mesh, cache_pspecs(cfg, mesh, b))
        daxes = _data_axes(mesh, b) or None
        rows = NamedSharding(mesh, (daxes, None))
        rows3 = NamedSharding(mesh, (daxes, None, None))
        params = lm_params_from_arrays(case["params"], device="cpu",
                                       shardings=psh)
        prefix = case.get("prefix")
        with torch.no_grad():
            logits, cache = prefill(
                params, cfg, rows.shard(tokens),
                None if prefix is None else rows3.shard(
                    torch.from_numpy(prefix)),
                dtype=torch.float32, mesh=mesh, cache_sh=csh)
            whole = {k: _np(csh[k].gather(c)) for k, c in cache.items()}
            logits = _np(rows3.gather(logits))
        if mesh.rank == 0:
            out[name] = {"logits": logits, "cache": whole}
    return out


def pipe_hop_job(world: int, data: dict) -> dict:
    """The pipeline's point-to-point hop and output broadcast on
    ``data["device"]`` tensors (CUDA ones go through host memory under
    gloo), both ways in float32 and bfloat16; then :func:`pipeline_job` on
    ``data["cases"]``."""
    import torch
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world, 1), ("pod", "data"), device=data["device"])
    ax, dev, r = mesh.axis("pod"), mesh.device, mesh.rank
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((3, 5), float(r + 1), dtype=dtype, device=dev)
        up, down = ax.shift(x, 1), ax.shift(x, -1)
        ok &= bool((up == (r if r > 0 else 0)).all())
        ok &= bool((down == (r + 2 if r + 1 < world else 0)).all())
        ok &= up.device == dev and up.dtype == dtype
        ok &= bool((ax.broadcast(x, world - 1) == world).all())
    return {"ok": bool(ok), "cases": pipeline_job(world, data["cases"])}


def pipeline_job(world: int, data: dict) -> dict:
    """``make_pipeline_apply`` on every case of ``data`` whose ``(pod,
    data)`` mesh has ``world`` ranks: ``tanh(x W + b)`` stages (the
    reference test's), or reduced Danube blocks (``"danube"``: the
    config's overrides, ``block_stage_fn``), on ``case["device"]`` (default
    the CPU).  Each rank returns the output, its stage's gradients of
    ``sum(y ** 2)`` and its ``pod`` coordinate."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import tree_map
    from repro_torch.train.pipeline import (block_stage_fn,
                                            make_pipeline_apply,
                                            split_stages)

    def tanh_stages(p, x):
        for i in range(p["w"].shape[0]):
            x = torch.tanh(x @ p["w"][i] + p["b"][i])
        return x

    out = {}
    for name, case in data.items():
        p_size, d_size = case["mesh"]
        if p_size * d_size != world:
            continue
        mesh = make_mesh((p_size, d_size), ("pod", "data"),
                         device=case.get("device", "cpu"))
        xs = torch.from_numpy(case["xs"]).to(mesh.device)
        if "danube" in case:
            cfg = get_config("h2o_danube3_4b").reduced(**case["danube"])
            stage_fn = block_stage_fn(cfg, xs.shape[2])
        else:
            stage_fn = tanh_stages
        stages = split_stages(tree_map(lambda a: a.to(mesh.device),
                                       _tensors(case["layers"])), p_size)
        c = mesh.coord("pod")
        mine = tree_map(lambda a: a[c:c + 1].clone().requires_grad_(),
                        stages)
        apply = make_pipeline_apply(stage_fn, mesh, p_size, xs.shape[0])
        y = apply(mine, xs)
        (y ** 2).sum().backward()
        out[name] = {"y": _np(y), "coord": c,
                     "grads": tree_map(lambda a: _np(a.grad[0]), mine),
                     "kinds": {f"{k}@{n}": v[:2] for (k, n), v
                               in mesh.stats.kinds.items()}}
    return out


JOBS = {"matrix": matrix_job, "nan": nan_job, "failing": failing_job,
        "lm_train": lm_train_job, "lm_serve": lm_serve_job,
        "pipe_hop": pipe_hop_job, "pipeline": pipeline_job,
        "lm_prefill": lm_prefill_job}
