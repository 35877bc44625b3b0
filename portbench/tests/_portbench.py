"""Shared helpers of the benchmark's CPU tests: the paths, and a cell run
at a small size on the CPU through the harness's own ``run_cell``."""
from __future__ import annotations

import importlib.util
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _path in (ROOT, ROOT / "src"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

import torch  # noqa: E402

from portbench.harness import spec  # noqa: E402

# small shapes, several test processes: one thread each
torch.set_num_threads(1)

#: The graph cell at 2^10 vertices.
SMALL_GRAPH = {"kron22_pagerank": ({"scale": 10}, {})}

#: The training cell's model at d_model 64, 2 layers, S 64 (the banded
#: path: S > query chunk + window), computed in float32: at this width bf16
#: rounding reads as large as the limits set at the cell's own size, and
#: the tests are about the harness's verdicts, not about bf16.
TINY_MODEL = {"family": "dense", "num_layers": 2, "d_model": 64,
              "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 96,
              "vocab_size": 256, "activation": "silu_glu", "rms_eps": 1e-6,
              "rope_theta": 10000.0, "sliding_window": 16,
              "tie_embeddings": False}
SMALL_TRAIN = {"danube_train_8k": (
    {"model": TINY_MODEL, "precision": {"compute": "float32"},
     "program": {"attn_query_chunk": 8, "swa_banded": True, "remat": True}},
    {"seq_len": 64})}

SMALL = {**SMALL_GRAPH, **SMALL_TRAIN}


def load(name: str, path: pathlib.Path):
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def run_module():
    return load("portbench_run", ROOT / "portbench" / "run.py")


def small_run(cell: str, seed: int = 5, seconds: float = 0.3, *,
              config=None, traffic=None, trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU at its small size."""
    small_config, small_traffic = SMALL[cell]
    return run_module().run_cell(
        spec.benchmark(ROOT), cell, seed, seconds, trace, device="cpu",
        config_override={**small_config, **(config or {})},
        traffic_override={**small_traffic, **(traffic or {})},
        log=lambda s: None)
