"""A traced window reduced in memory: device operations by name, the
device's busy time, and its idle gaps by what the host was doing.

Every unit of a traced window runs inside a ``record_function`` span named
:data:`UNIT_SPAN` and ends with a device synchronize, so the window (from
the first span's start to the last one's end) holds all of its device
work.  The device's busy time is the union of its operations' intervals in
that window; the rest are idle gaps.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import Dict, List, Sequence, Tuple

UNIT_SPAN = "portbench.unit"

#: Host events of the span and of the profiler itself, never the cause of
#: an idle gap.
_PROFILER_OWN = (UNIT_SPAN, "Activity Buffer Request")

#: How far back from a gap to look for the host operation that was running.
_LOOKBACK = 400


@dataclasses.dataclass
class Trace:
    """One traced window; times in seconds."""

    window_s: float
    busy_s: float
    units: List[Tuple[float, float]]          # each unit's span
    device_ops: Dict[str, float]              # device seconds by name
    device_counts: Dict[str, int]             # launches by name
    idle_gaps: Dict[str, float]               # idle seconds by host op

    def device_time(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose names hold
        one of ``patterns`` as a whole word."""
        rx = re.compile(r"\b(?:" + "|".join(map(re.escape, patterns))
                        + r")\b")
        secs = sum(t for n, t in self.device_ops.items() if rx.search(n))
        count = sum(c for n, c in self.device_counts.items() if rx.search(n))
        return secs, count

    def top(self, table: Dict[str, float], k: int = 10) -> list:
        return [[name[:200], secs] for name, secs in
                sorted(table.items(), key=lambda kv: -kv[1])[:k]]


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float
           ) -> Tuple[float, List[Tuple[float, float]]]:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``, and
    the gaps between them there."""
    busy, gaps, cursor = 0.0, [], lo
    for start, end in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if hi > cursor:
        gaps.append((cursor, hi))
    return busy, gaps


def _host_at(host: List[Tuple[float, float, str]], starts: List[float],
             t: float) -> str:
    """The innermost host operation running at ``t`` (an ``aten::`` one
    before any other), else ``host: before <next operation>``."""
    i = bisect.bisect_right(starts, t)
    best, best_len = None, None
    for j in range(i - 1, max(i - 1 - _LOOKBACK, -1), -1):
        start, end, name = host[j]
        if end >= t and (best is None or end - start < best_len):
            if name.startswith("aten::") or best is None \
                    or not best.startswith("aten::"):
                best, best_len = name, end - start
    if best is not None:
        return best
    for start, end, name in host[i:i + _LOOKBACK]:
        if name.startswith("aten::"):
            return f"host: before {name}"
    return "host: between operations"


def reduce_events(device: Sequence[Tuple[float, float, str]],
                  host: Sequence[Tuple[float, float, str]]) -> Trace:
    """``device``/``host`` are ``(start_s, end_s, name)``; the host's
    :data:`UNIT_SPAN` events mark the window."""
    units = sorted((s, e) for s, e, n in host if n == UNIT_SPAN)
    if not units:
        raise ValueError(f"no {UNIT_SPAN} span in the trace")
    lo, hi = units[0][0], units[-1][1]
    ops: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, int] = collections.defaultdict(int)
    inside = []
    for start, end, name in device:
        if end <= lo or start >= hi:
            continue
        ops[name] += end - start
        counts[name] += 1
        inside.append((start, end))
    busy, gaps = _union(inside, lo, hi)
    others = sorted((s, e, n) for s, e, n in host
                    if n not in _PROFILER_OWN
                    and not n.startswith("ProfilerStep"))
    starts = [s for s, _, _ in others]
    idle: Dict[str, float] = collections.defaultdict(float)
    for start, end in gaps:
        idle[_host_at(others, starts, (start + end) / 2)] += end - start
    return Trace(window_s=hi - lo, busy_s=busy, units=units,
                 device_ops=dict(ops), device_counts=dict(counts),
                 idle_gaps=dict(idle))


def reduce_profile(prof) -> Trace:
    """A finished ``torch.profiler.profile`` (CPU and CUDA activities)."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        rng = (e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
        if e.device_type != DeviceType.CUDA:
            host.append(rng)
        elif e.name != UNIT_SPAN and not getattr(e, "is_user_annotation",
                                                  False):
            device.append(rng)     # not the spans' copies on the device
    return reduce_events(device, host)
