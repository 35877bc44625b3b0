"""Reductions that more than one metric reader makes."""
from __future__ import annotations

from typing import Optional


def traced(run) -> bool:
    """A traced window in which the device ran something (a run without
    a card has none, and its readers return nothing)."""
    return run.trace is not None and run.trace.busy_s > 0


def idle_share_pct(run) -> Optional[float]:
    """1 minus the union of device activity over the traced window, in %."""
    if not traced(run):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def peak_gib(run) -> Optional[float]:
    """The device allocator's peak over the window (reset at its start)."""
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30


def advances(run) -> int:
    return sum(r["advances"] for r in run.records)


def unit_seconds(run) -> float:
    """The traced units' spans, summed."""
    return sum(end - start for start, end in run.trace.units)


def group_time(run, group: str):
    """Device seconds and launches of ``kernels.json``'s ``group``."""
    return run.trace.device_time(run.kernels[group])


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile, linear between order statistics (numpy's
    default); ``None`` for no values."""
    data = sorted(values)
    if not data:
        return None
    pos = (len(data) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(data) - 1)
    return data[lo] + (data[hi] - data[lo]) * (pos - lo)
