"""The harness end to end on the CPU: a run's result, the faults that
must make ``correct`` false, the controls, the modules a run loads, the
exits without a card or without the port, and the trace reduction."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from _portbench import ROOT, SMALL, small_run, spec

CELLS = sorted(SMALL)


def _driver(cell):
    bench = spec.benchmark(ROOT)
    return spec.driver(spec.traffic(spec.workload(bench, cell)["traffic"])
                       ["driver"])


FAULTS = [(cell, fault) for cell in CELLS for fault in _driver(cell).FAULTS]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_small_run_is_correct_and_reports_its_metrics(cell):
    result = small_run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    bench = spec.benchmark(ROOT)
    wanted = {m["name"] for m in spec.reported(bench, cell, False)}
    assert set(result["metrics"]) == wanted
    assert list(result)[-1] == "checks"
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_in_the_timed_path_makes_correct_false(cell, fault):
    with _driver(cell).fault(fault):
        result = small_run(cell)
    assert not result["correct"], (fault, result["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_above_the_limits(cell):
    """The reference in the next precision below the configuration's, put
    in the program's place, fails at least one limit."""
    from portbench import calibrate as cal
    small_config, small_traffic = SMALL[cell]
    out = next(cal.calibrate(cell, [9], 1, True, device="cpu",
                             config_override=small_config,
                             traffic_override=small_traffic))
    control = out["control"]
    control = control if isinstance(control, dict) else {
        next(iter(out["limits"])): control}
    assert any(control[n] > out["limits"][n] for n in control), out


def test_a_traced_small_run_reduces_its_window():
    result = small_run("kron22_pagerank", trace=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


_LOADS = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib.util
spec_ = importlib.util.spec_from_file_location("pbrun", {run!r})
run = importlib.util.module_from_spec(spec_); spec_.loader.exec_module(run)
sys.path.insert(0, {tests!r})
from _portbench import small_run
for cell in {cells!r}:
    small_run(cell, seconds=0.05)
print(json.dumps(run.forbidden_modules()))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_and_no_reference_package():
    code = _LOADS.format(root=str(ROOT), src=str(ROOT / "src"),
                         run=str(ROOT / "portbench" / "run.py"),
                         tests=str(ROOT / "portbench" / "tests"), cells=CELLS)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    forbidden, loaded = (json.loads(line) for line in
                         out.stdout.strip().splitlines()[-2:])
    assert forbidden == []
    assert "repro_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "repro"} & set(loaded)


def _main(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "portbench/run.py", *args], capture_output=True,
        text=True, timeout=120, cwd=cwd,
        env=dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES=""))


def test_a_run_without_a_card_exits_without_a_result():
    out = _main("--workload", "kron22_pagerank", "--seed", "1", "--seconds",
                "1", "--trace", "0")
    assert out.returncode == 4 and out.stdout == ""


def test_an_unknown_workload_exits_without_a_result():
    out = _main("--workload", "nope", "--seed", "1", "--seconds", "1")
    assert out.returncode == 2 and out.stdout == ""


def test_a_checkout_without_the_port_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _main("--workload", "kron22_pagerank", "--seed", "1", "--seconds",
                "1", cwd=tmp_path)
    assert out.returncode == 3 and out.stdout == ""


def test_trace_reduction_busy_gaps_and_groups():
    from portbench.harness import trace as tr
    host = [(0.0, 1.0, tr.UNIT_SPAN), (1.0, 2.0, tr.UNIT_SPAN),
            (0.1, 0.3, "aten::nonzero"), (0.15, 0.2, "aten::item"),
            (1.5, 1.6, "aten::searchsorted")]
    device = [(0.05, 0.1, "void chunk_walk_tiles_kernel<0, false>(int)"),
              (0.3, 0.9, "void at::native::gemm(float)"),
              (0.8, 1.0, "void segsum_kernel<float>(Args)"),
              (1.2, 1.4, "void at::native::gemm(float)"),
              (2.5, 2.6, "outside the window")]
    t = tr.reduce_events(device, host)
    assert t.window_s == pytest.approx(2.0)
    assert t.busy_s == pytest.approx(0.05 + 0.7 + 0.2)
    assert t.idle_gaps == pytest.approx({
        "host: before aten::nonzero": 0.05,        # 0.0-0.05
        "aten::item": 0.2,                         # 0.1-0.3, innermost
        "host: before aten::searchsorted": 0.2,    # 1.0-1.2
        "host: between operations": 0.6})          # 1.4-2.0
    secs, n = t.device_time(["chunk_walk_tiles_kernel", "segsum_kernel"])
    assert secs == pytest.approx(0.25) and n == 2
    assert "outside the window" not in t.device_ops
    assert t.top(t.device_ops, 1)[0][0] == "void at::native::gemm(float)"
