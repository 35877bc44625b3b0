"""Aggregate the dry run's records into tables (the reference's
``launch/report.py``)::

    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun

The dry-run table gives a cell a row, its two meshes side by side, and
lists the cells that raised under it.  The memory budget is the card's:
79.2 GiB, the H100 80GB HBM3's (700 W) ``total_memory`` as
``chip_smoke.py``'s first phase prints it (``PERF.md`` §6), in place of
the reference's 16 GiB v5e.  The numbers are the dry run's counts and
roofline terms at the H100's datasheet constants (``roofline.py``),
traced on the ``meta`` device: none is a time.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

GIB = 2 ** 30
HBM_BUDGET = 79.2 * GIB  # H100 80GB HBM3's total_memory


def load(dirname: str) -> List[Dict]:
    recs = []
    for name in sorted(os.listdir(dirname)):
        if name.endswith(".json"):
            with open(os.path.join(dirname, name)) as f:
                rec = json.load(f)
                rec["_file"] = name
                recs.append(rec)
    return recs


def fmt_bytes(b: float) -> str:
    return f"{b / GIB:.2f}"


def _mesh(r: Dict) -> str:
    return "x".join(str(n) for n in r["mesh"])


def dryrun_table(recs: List[Dict]) -> str:
    """One row an (arch, shape) cell, its meshes side by side (``16x16 /
    2x16x16``); the cells that raised are listed under the table, grouped
    by their error."""
    rows = ["| arch | shape | kind | mb | peak GiB/card | fits 79.2G | "
            "trace s |",
            "|---|---|---|---|---|---|---|"]
    cells: Dict[tuple, Dict[str, Dict]] = {}
    failed: Dict[str, List[str]] = {}
    for r in recs:
        if "error" in r:
            failed.setdefault(r["error"], []).append(
                f"{r['arch']} {r['shape']} {_mesh(r)}")
            continue
        cells.setdefault((r["arch"], r["shape"]), {})[_mesh(r)] = r
    for (arch, shape), by_mesh in cells.items():
        ms = [by_mesh[m] for m in sorted(by_mesh, key=len)]  # 16x16 first
        peaks = [r["memory"]["peak_estimate_bytes"] for r in ms]
        rows.append(" | ".join([
            f"| {arch}", shape, ms[0]["kind"],
            " / ".join(str(r["num_microbatches"]) for r in ms),
            " / ".join(fmt_bytes(p) for p in peaks),
            " / ".join("yes" if p <= HBM_BUDGET else "NO" for p in peaks),
            " / ".join(f"{r['trace_s']:.0f}" for r in ms)]) + " |")
    if failed:
        rows.append("")
    for error, tags in failed.items():
        rows.append(f"- failed ({len(tags)}): {', '.join(tags)}: {error}")
    return "\n".join(rows)


def _single(recs: List[Dict]):
    return [r for r in recs if not r["multi_pod"] and "roofline" in r]


def roofline_table(recs: List[Dict]) -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "bottleneck | MODEL_FLOPS | useful ratio |",
            "|---|---|---|---|---|---|---|---|"]
    for r in _single(recs):
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.4g} | "
            f"{rf['memory_s']:.4g} | {rf['collective_s']:.4g} | "
            f"{rf['bottleneck'].replace('_s', '')} | "
            f"{rf['model_flops_global']:.3g} | "
            f"{rf['useful_flops_ratio']:.2f} |")
    return "\n".join(rows)


def collective_detail(recs: List[Dict]) -> str:
    rows = ["| arch | shape | all-reduce GiB | all-gather GiB | "
            "reduce-scatter GiB | all-to-all GiB | permute GiB |",
            "|---|---|---|---|---|---|---|"]
    for r in _single(recs):
        w = r["roofline"]["wire_by_kind"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{fmt_bytes(w['all-reduce'])} | {fmt_bytes(w['all-gather'])} | "
            f"{fmt_bytes(w['reduce-scatter'])} | "
            f"{fmt_bytes(w['all-to-all'])} | "
            f"{fmt_bytes(w['collective-permute'])} |")
    return "\n".join(rows)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "build/dryrun"
    recs = load(d)
    print("## Dry-run table\n")
    print(dryrun_table(recs))
    print("\n## Roofline table (single-pod 16x16)\n")
    print(roofline_table(recs))
    print("\n## Collective wire bytes per device (single-pod)\n")
    print(collective_detail(recs))


if __name__ == "__main__":
    main()
