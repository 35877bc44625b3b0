"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload kron22_pagerank --seed 7 \
        --seconds 40 --trace 0

One process is one run.  It makes its inputs on the card from ``--seed``,
sets the cell up (counted in ``setup_s``, from the start of this script),
measures for ``--seconds`` (``--trace 0``: the end-to-end metrics) or
profiles a few units (``--trace 1``: the per-layer metrics), then, once
the program's state is freed, decides ``correct`` against the plain
reference.  The last line of standard output is one JSON object; the last
lines of standard error are the numbers compared, each with its limit.

Exit codes other than 0 print no result: 2 a name that ``BENCHMARK.json``
or the files under ``portbench/`` do not resolve, 3 no port beside the
benchmark (``src/repro_torch``), 4 no card or too few cards, 5 ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` loaded in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "src"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

#: Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc builds already go to ``build/kernels``)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("REPRO_AUTOTUNE_MEASURE", None)


def power_limit() -> str:
    """``nvidia-smi``'s power limit of the first card, or ""."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else ""


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config_override=None,
             traffic_override=None, t_start: float = T_START,
             log=print) -> dict:
    """Set up, measure and judge one cell; returns the result's object
    (``checks`` last).  ``device`` and the overrides let the tests drive a
    run on the CPU at a small size."""
    import torch
    from portbench.harness import spec
    from portbench.harness import trace as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.workload(bench, name)
    config = dict(spec.config(bench, cell["config"]), **(config_override or {}))
    traffic = dict(spec.traffic(cell["traffic"]), **(traffic_override or {}))
    wanted = spec.reported(bench, name, trace)
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in wanted}
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.zeros(1, device=device)
        log(f"setup: card ready at {time.perf_counter() - t_start!r} s")
    driver = spec.driver(traffic["driver"]).Driver(config, traffic, seed,
                                                   device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"setup: {driver.describe()}; setup_s {setup_s!r}")
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    records, summary = [], None
    t0 = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for _ in range(int(traffic["trace_units"])):
                with record_function(tr.UNIT_SPAN):
                    records.append(driver.run_unit())
        window_s = time.perf_counter() - t0
        summary = tr.reduce_profile(prof)
        del prof
    else:
        while time.perf_counter() - t0 < seconds:
            records.append(driver.run_unit())
        window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0

    # what the metric readers see of the run
    run = types.SimpleNamespace(
        cell=name, config=config, traffic=traffic, records=records,
        window_s=window_s, setup_s=setup_s, trace=summary,
        window_peak_bytes=window_peak, context=driver.context(),
        peaks=spec.peaks(), kernels=spec.kernels())
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, bad = driver.judge(records)
    log(f"judged against the reference in {time.perf_counter() - t!r} s")
    failed = sum(bad)
    correct = (bool(records) and failed == 0
               and all(c["value"] <= c["limit"] for c in checks))
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device,
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else device),
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": max(setup_peak, window_peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = {
            "device_ops": summary.top(summary.device_ops),
            "idle_gaps": summary.top(summary.idle_gaps)}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench.harness import spec
    try:
        bench = spec.benchmark(ROOT)
        cell = spec.workload(bench, args.workload)
    except spec.SpecError as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: the port is not under {ROOT / 'src'}; nothing "
              f"to measure", file=sys.stderr)
        return 3
    cache_dirs(ROOT)        # before torch starts the CUDA driver, which reads them
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 4
    tmp = tempfile.mkdtemp(prefix="portbench_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        pathlib.Path(tmp) / "autotune.json")
    try:
        result = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace),
                          log=lambda s: print(s, file=sys.stderr, flush=True))
    except spec.SpecError as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 5
    limit = power_limit()
    if limit:
        result["device"]["power_limit"] = limit
    for check, c in result["checks"].items():
        print(f"check {check}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
