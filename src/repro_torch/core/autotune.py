"""Cost-model schedule autotuner (model-only).

Selection is the argmin of the registered plans' modeled costs
(:mod:`repro_torch.core.balance`).  Choices are memoised in memory under
the reference's quantised shape fingerprint (log2 size buckets + rounded
skew statistics + ``num_blocks``), so a recurring workload shape is scored
once per process.  With the reference's coefficients this picks the same
:class:`Plan` as the reference for the same WorkSpec.  The reference's
persistent cache and measured mode are not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

from repro_torch.core.balance import (ADVANCE_ATOM_WORK,
                                      ADVANCE_DELTA_ATOM_WORK,
                                      ADVANCE_DELTA_PUSH_ATOM_WORK,
                                      ADVANCE_PUSH_ATOM_WORK, ImbalanceStats,
                                      WAVEFRONT_ATOM_WORK,
                                      WAVEFRONT_PUSH_ATOM_WORK, modeled_cost)
from repro_torch.core.execute import ExecutionPath
from repro_torch.core.schedules import Schedule
from repro_torch.core.work import WorkSpec

#: Candidate schedules, in tie-break priority order (earlier wins ties).
REGISTERED_SCHEDULES: Sequence[Schedule] = (
    Schedule.THREAD_MAPPED,
    Schedule.GROUP_MAPPED,
    Schedule.NONZERO_SPLIT,
    Schedule.MERGE_PATH,
    Schedule.ADAPTIVE,
    Schedule.CHUNKED,
)


@dataclasses.dataclass(frozen=True)
class Plan:
    """An autotuner decision: which schedule, on which execution path."""

    schedule: Schedule
    path: ExecutionPath = ExecutionPath.PURE

    def encode(self) -> str:
        return f"{self.schedule}@{self.path}"

    @classmethod
    def decode(cls, value: str) -> "Plan":
        name, _, path = value.partition("@")
        return cls(Schedule(name),
                   ExecutionPath(path) if path else ExecutionPath.PURE)


#: Candidate (schedule, path) plans in tie-break order.  Only the chunked
#: queue's model tells the paths apart, so it alone is listed twice.
REGISTERED_PLANS: Sequence[Plan] = tuple(
    [Plan(s) for s in REGISTERED_SCHEDULES if s != Schedule.CHUNKED]
    + [Plan(Schedule.CHUNKED, ExecutionPath.NATIVE),
       Plan(Schedule.CHUNKED, ExecutionPath.PURE)])

#: Per-atom work weight of each workload family the planner scores.
WORKLOAD_ATOM_WORK = {"reduce": 1, "advance": ADVANCE_ATOM_WORK,
                      "advance_push": ADVANCE_PUSH_ATOM_WORK,
                      "advance_delta": ADVANCE_DELTA_ATOM_WORK,
                      "advance_delta_push": ADVANCE_DELTA_PUSH_ATOM_WORK,
                      "wavefront": WAVEFRONT_ATOM_WORK,
                      "wavefront_push": WAVEFRONT_PUSH_ATOM_WORK}


def shape_key(spec: WorkSpec, num_blocks: int,
              stats: Optional[ImbalanceStats] = None) -> str:
    """Quantised workload fingerprint: sizes by log2, skew statistics to
    one decimal."""
    if stats is None:
        stats = ImbalanceStats.measure(spec)
    lg = lambda n: int(math.log2(n)) if n > 0 else -1
    return (f"b{num_blocks}|t{lg(spec.num_tiles)}|a{lg(spec.num_atoms)}"
            f"|cv{stats.cv_atoms_per_tile:.1f}|g{stats.gini:.1f}"
            f"|e{stats.empty_tile_fraction:.1f}")


#: The process's choice table: ``{namespaced shape key: Plan or Schedule}``.
_DEFAULT_MEMO: Dict[str, object] = {}


def score_schedules(spec: WorkSpec, num_blocks: int,
                    schedules: Sequence[Schedule] = REGISTERED_SCHEDULES
                    ) -> Dict[Schedule, float]:
    """Modeled lockstep cost of each candidate schedule."""
    return {s: modeled_cost(spec, s, num_blocks) for s in schedules}


def _check_workload(workload: str) -> None:
    if workload not in WORKLOAD_ATOM_WORK:
        raise ValueError(f"unknown workload family: {workload!r} "
                         f"(expected one of {sorted(WORKLOAD_ATOM_WORK)})")


def score_plans(spec: WorkSpec, num_blocks: int,
                plans: Sequence[Plan] = REGISTERED_PLANS,
                workload: str = "reduce") -> Dict[Plan, float]:
    """Modeled lockstep cost of each (schedule, execution path) plan."""
    _check_workload(workload)
    atom_work = WORKLOAD_ATOM_WORK[workload]
    return {p: modeled_cost(spec, p.schedule, num_blocks, path=str(p.path),
                            atom_work=atom_work)
            for p in plans}


def select_plan(spec: WorkSpec, num_blocks: int, *,
                cache: Optional[dict] = _DEFAULT_MEMO,
                plans: Sequence[Plan] = REGISTERED_PLANS,
                workload: str = "reduce") -> Plan:
    """The cheapest (schedule, execution path) plan; earlier plans win
    ties.  ``cache=None`` scores every call."""
    _check_workload(workload)
    key = None
    if cache is not None:
        key = shape_key(spec, num_blocks) + "|plan"
        if workload != "reduce":
            key += f".{workload}"
        hit = cache.get(key)
        if isinstance(hit, Plan) and hit in plans:
            return hit
    scores = score_plans(spec, num_blocks, plans, workload)
    best = min(plans, key=lambda p: (scores[p], list(plans).index(p)))
    if cache is not None:
        cache[key] = best
    return best


def select_schedule(spec: WorkSpec, num_blocks: int, *,
                    cache: Optional[dict] = _DEFAULT_MEMO,
                    schedules: Sequence[Schedule] = REGISTERED_SCHEDULES
                    ) -> Schedule:
    """The cheapest schedule by modeled cost (memoised per shape)."""
    key = None
    if cache is not None:
        key = shape_key(spec, num_blocks)
        hit = cache.get(key)
        if isinstance(hit, Schedule) and hit in schedules:
            return hit
    scores = score_schedules(spec, num_blocks, schedules)
    best = min(schedules, key=lambda s: (scores[s],
                                         list(schedules).index(s)))
    if cache is not None:
        cache[key] = best
    return best
