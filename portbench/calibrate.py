"""Read a cell's compared numbers over many seeds in one process: the
program's (the lower readings of its limits) and, with ``--control``, the
control's (the reference in the next precision below the configuration's,
put in the program's place: the upper readings).

    python3 portbench/calibrate.py --workload kron22_pagerank \
        --seeds 101 102 103 --units 2 --control

One JSON line a seed.  The benchmark's own runs never run this.
"""
import argparse
import contextlib
import gc
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "src"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))


def calibrate(workload: str, seeds, units: int, control: bool,
              device: str = "cuda", config_override=None,
              traffic_override=None, fault=None):
    """Yield one dict a seed: the program's checks after ``units`` timed
    units (the set-up's warm-up units before them), with the driver's
    ``fault`` planted in the program if one is named, and the
    control's."""
    import torch
    from portbench.harness import spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = spec.benchmark(ROOT)
    cell = spec.workload(bench, workload)
    config = dict(spec.config(bench, cell["config"]),
                  **(config_override or {}))
    traffic = dict(spec.traffic(cell["traffic"]), **(traffic_override or {}))
    module = spec.driver(traffic["driver"])
    planted = (lambda: module.fault(fault)) if fault else contextlib.nullcontext
    on_card = torch.device(device).type == "cuda"
    for seed in seeds:
        t = time.perf_counter()
        with planted():
            driver = module.Driver(config, traffic, seed, device)
            records = [driver.run_unit() for _ in range(units)]
        driver.release()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        checks, bad = driver.judge(records)
        out = {"seed": seed, "fault": fault, "setup": driver.describe(),
               "program": {c["name"]: c["value"] for c in checks},
               "limits": {c["name"]: c["limit"] for c in checks},
               "failed": sum(bad)}
        if hasattr(driver, "detail"):
            out["program_detail"] = driver.detail
        if control:
            out["control"] = driver.control_reading()
            if hasattr(driver, "detail"):
                out["control_detail"] = driver.detail
        out["seconds"] = time.perf_counter() - t
        del driver, records
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None,
                    help="plant one of the driver's FAULTS in the program")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 4
    tmp = tempfile.mkdtemp(prefix="portbench_calibrate_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        pathlib.Path(tmp) / "autotune.json")
    os.environ.pop("REPRO_AUTOTUNE_MEASURE", None)
    try:
        for out in calibrate(args.workload, args.seeds, args.units,
                             args.control, fault=args.fault):
            print(json.dumps(out), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
