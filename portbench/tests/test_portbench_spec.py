"""``BENCHMARK.json`` and every file it names: found by name, well formed,
and the roofline formulas at the numbers the cells use."""
from __future__ import annotations

import json
import re

import pytest

from _portbench import ROOT, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_are_the_contracts():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_keys():
    names = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in names


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_is_found_and_states_its_cuts(entry):
    config = spec.config(BENCH, entry["name"])
    assert config["name"] == entry["name"]
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert set(entry["reduced"]) == set(config["reduced"])
    for key in entry["reduced"]:
        assert key in config, key
    assert config["assumed"] and config["precision"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves_its_traffic_driver_and_metrics(cell):
    traffic = spec.traffic(cell["traffic"])
    driver = spec.driver(traffic["driver"])
    assert hasattr(driver, "Driver") and driver.FAULTS
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    for trace in (False, True):
        reported = spec.reported(BENCH, cell["name"], trace)
        assert reported, (cell["name"], trace)
        for m in reported:
            assert callable(spec.metric_reader(m["name"]).read)
    e2e = {m["name"] for m in spec.reported(BENCH, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(traffic["limits"])


def test_every_metric_file_is_named_in_the_benchmark():
    files = {p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    named = {m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]}
    assert files == named


def test_roofline_formulas_give_the_cells_numbers():
    from portbench.harness import roofline as R
    model = spec.config(BENCH, "danube3-4b-swa4k")["model"]
    assert R.lm_params(model) == 3_961_839_360
    assert R.band_pairs(8192, 4096) == 25_167_872
    assert R.lm_step_flop(model, 2, 8192) == 433_052_366_929_920
    assert R.k7_fwd_flop(model, 8192) == 386_578_513_920
    assert R.k7_bwd_flop(model, 8192) == 966_446_284_800
    assert R.pagerank_iteration_bytes(10, 100) == 4 * 11 + 400 + 120
    assert R.k2_advance_bytes(10, 100) == 840


def test_danube_sizes_match_the_ports_config():
    from repro_torch.configs import get_config
    port = get_config("h2o_danube3_4b")
    model = spec.config(BENCH, "danube3-4b-swa4k")["model"]
    for key in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                "vocab_size", "head_dim", "rope_theta", "sliding_window",
                "activation"):
        assert model[key] == getattr(port, key), key
