"""Finding a cell's files by the names in ``BENCHMARK.json``."""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from typing import Dict, List

#: The folder of the benchmark (``portbench/``) and the checkout's root.
BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class SpecError(ValueError):
    """A name or file that ``BENCHMARK.json`` points at is missing or
    malformed."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise SpecError(f"{what} {name!r} is not a valid name")
    return name


def load_json(path: pathlib.Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{path} is missing") from None
    except json.JSONDecodeError as err:
        raise SpecError(f"{path} is not JSON: {err}") from None


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    """The configuration's file, as it is run."""
    for entry in bench["configs"]:
        if entry["name"] == name:
            return load_json(ROOT / entry["file"])
    raise SpecError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    data = load_json(BENCH_DIR / "traffic" / f"{check_name(name, 'traffic')}"
                                             f".json")
    check_name(data.get("driver", ""), "driver")
    return data


def reported(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    ``--trace``, the per-layer ones with it; each kept where it has no
    ``workloads`` key or names the cell there."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _load_file(path: pathlib.Path, module_name: str):
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    """``drivers/<name>.py``: the general code that reads a traffic file."""
    check_name(name, "driver")
    return _load_file(BENCH_DIR / "drivers" / f"{name}.py",
                      f"portbench_driver_{name}")


def generator(name: str):
    """``generators/<name>.py``: builds a configuration's data."""
    check_name(name, "generator")
    return _load_file(BENCH_DIR / "generators" / f"{name}.py",
                      f"portbench_generator_{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``: a module with ``read(run)``."""
    check_name(name, "metric")
    safe = name.replace(".", "_").replace("-", "_")
    return _load_file(BENCH_DIR / "metrics" / f"{name}.py",
                      f"portbench_metric_{safe}")


def peaks() -> Dict[str, float]:
    return load_json(BENCH_DIR / "peaks.json")


def kernels() -> Dict[str, List[str]]:
    return load_json(BENCH_DIR / "kernels.json")

