"""Cost-model schedule autotuner, with a persistent cache and measured mode.

Selection is the argmin of the registered plans' modeled costs
(:mod:`repro_torch.core.balance`).  Choices are cached under the
reference's quantised shape fingerprint (log2 size buckets + rounded skew
statistics + ``num_blocks``) at two levels: an in-process dict and a JSON
file (``REPRO_TORCH_AUTOTUNE_CACHE``, default
``~/.cache/repro_torch/autotune.json``; never the reference's file).  The
file format is the reference's, so each package reads the other's:

* **v1** — a bare ``"schedule@path"`` string (model-only choices);
* **v2** — ``{"v": 2, "plan": "schedule@path", "measured_us": {"schedule@
  path": us, ...}, "features": {"schedule@path": [base, {coef: count}],
  ...}}``.  Corrupt sub-fields are dropped, never raised.

With the reference's coefficients the model-only pick is the reference's
plan for the same WorkSpec.

**Measured mode:** with ``REPRO_AUTOTUNE_MEASURE=1`` and a ``measure=``
callable from the call site, :func:`select_plan` times the top-k
(``REPRO_AUTOTUNE_TOPK``, default 3) model-ranked candidates once,
persists their medians, and ranks by measurement as posterior over the
model as prior (:func:`blend_scores`).  A reloaded cache re-ranks without
measuring again (:func:`repro_torch.core.measure.measurement_count`).  The
measured records feed :func:`repro_torch.core.balance.fit_coefficients`
through :func:`collect_fit_samples`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import tempfile
import threading
from typing import Callable, ClassVar, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.balance import (ADVANCE_ATOM_WORK,
                                      ADVANCE_DELTA_ATOM_WORK,
                                      ADVANCE_DELTA_PUSH_ATOM_WORK,
                                      ADVANCE_PUSH_ATOM_WORK, ImbalanceStats,
                                      WAVEFRONT_ATOM_WORK,
                                      WAVEFRONT_PUSH_ATOM_WORK,
                                      cost_features, modeled_cost,
                                      modeled_sharded_cost)
from repro_torch.core.execute import ExecutionPath
from repro_torch.core.measure import geomean
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


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """An autotuner decision one level up: schedule, path, shard count and
    the shard boundary schedule (``repro_torch.sparse.shard.
    SHARD_SCHEDULES``).  Every shard runs the same (schedule, path).
    Encoded ``"schedule@path@sN@bNAME"``; the reference's legacy
    ``"schedule@path@sN"`` decodes with boundary ``equal_width``.  The
    trailing fields keep :class:`Plan` and :class:`ShardedPlan` encodings
    from being read as one another."""

    schedule: Schedule
    path: ExecutionPath = ExecutionPath.PURE
    num_shards: int = 1
    boundary: str = "equal_width"

    def encode(self) -> str:
        return (f"{self.schedule}@{self.path}@s{self.num_shards}"
                f"@b{self.boundary}")

    @classmethod
    def decode(cls, value: str) -> "ShardedPlan":
        fields = value.split("@")
        if len(fields) not in (3, 4) or not fields[2].startswith("s"):
            raise ValueError(f"not a sharded plan encoding: {value!r}")
        boundary = "equal_width"
        if len(fields) == 4:
            if not fields[3].startswith("b"):
                raise ValueError(f"not a sharded plan encoding: {value!r}")
            boundary = fields[3][1:]
        return cls(Schedule(fields[0]), ExecutionPath(fields[1]),
                   int(fields[2][1:]), boundary)


#: Candidate (schedule, path) plans in tie-break order.  Only the chunked
#: queue's model tells the paths apart, so it alone is listed twice.
REGISTERED_PLANS: Sequence[Plan] = tuple(
    [Plan(s) for s in REGISTERED_SCHEDULES if s != Schedule.CHUNKED]
    + [Plan(Schedule.CHUNKED, ExecutionPath.NATIVE),
       Plan(Schedule.CHUNKED, ExecutionPath.PURE)])

#: Per-atom work weight of each workload family the planner scores.  The
#: serving families (:mod:`repro_torch.serve.graph`) charge the plain
#: advance's atoms and keep their own cache namespace, as the reference's
#: do; their default timing closure is the single-query relax, the same
#: one the ``"advance"`` family times.
WORKLOAD_ATOM_WORK = {"reduce": 1, "advance": ADVANCE_ATOM_WORK,
                      "advance_push": ADVANCE_PUSH_ATOM_WORK,
                      "advance_delta": ADVANCE_DELTA_ATOM_WORK,
                      "advance_delta_push": ADVANCE_DELTA_PUSH_ATOM_WORK,
                      # the sharded family: each shard's pull view at the
                      # advance charge, its push view at the push charge;
                      # the shard axis is priced by the comm term of
                      # modeled_sharded_cost
                      "advance_sharded": ADVANCE_ATOM_WORK,
                      "advance_sharded_push": ADVANCE_PUSH_ATOM_WORK,
                      "advance_serve": ADVANCE_ATOM_WORK,
                      "advance_serve_push": ADVANCE_PUSH_ATOM_WORK,
                      "wavefront": WAVEFRONT_ATOM_WORK,
                      "wavefront_push": WAVEFRONT_PUSH_ATOM_WORK}

_ENV_CACHE_PATH = "REPRO_TORCH_AUTOTUNE_CACHE"
_ENV_MEASURE = "REPRO_AUTOTUNE_MEASURE"
_ENV_MEASURE_TOPK = "REPRO_AUTOTUNE_TOPK"

#: How many model-ranked candidates measured mode times (per call:
#: ``select_plan(measure_k=)``; per process: ``REPRO_AUTOTUNE_TOPK``).
DEFAULT_MEASURE_TOPK = 3


def measurement_enabled() -> bool:
    """True when ``REPRO_AUTOTUNE_MEASURE`` opts this process into timing
    candidates (the call sites consult it before building their closures).
    """
    return os.environ.get(_ENV_MEASURE, "").strip().lower() in (
        "1", "true", "on", "yes")


def _measure_topk(override: Optional[int]) -> int:
    if override is not None:
        return max(int(override), 1)
    env = os.environ.get(_ENV_MEASURE_TOPK, "").strip()
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            pass
    return DEFAULT_MEASURE_TOPK


def _default_cache_path() -> pathlib.Path:
    env = os.environ.get(_ENV_CACHE_PATH)
    if env:
        return pathlib.Path(env)
    return (pathlib.Path(os.path.expanduser("~")) / ".cache" / "repro_torch"
            / "autotune.json")


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


@dataclasses.dataclass(frozen=True)
class CacheRecord:
    """One decoded cache entry: the chosen plan plus any measurements.

    ``measured_us`` maps encoded plans to measured medians (us);
    ``features`` maps encoded plans to their ``(base, {coef: count})``
    decomposition at measure time (:func:`~repro_torch.core.balance.
    cost_features`).  A v1 string decodes to a record with no measurements.
    """

    plan: Optional[Plan] = None
    measured_us: Dict[str, float] = dataclasses.field(default_factory=dict)
    features: Dict[str, Tuple[float, Dict[str, float]]] = \
        dataclasses.field(default_factory=dict)

    _PLAN_CODEC: ClassVar[type] = Plan

    @property
    def is_measured(self) -> bool:
        return bool(self.measured_us)

    def encode(self):
        """JSON value: bare v1 string when unmeasured, v2 dict otherwise."""
        plan = self.plan.encode() if self.plan else None
        if not self.measured_us and not self.features:
            return plan
        out = {"v": 2, "plan": plan,
               "measured_us": {k: round(float(v), 3)
                               for k, v in self.measured_us.items()}}
        if self.features:
            out["features"] = {k: [float(b), {n: float(c)
                                              for n, c in f.items()}]
                               for k, (b, f) in self.features.items()}
        return out

    @classmethod
    def decode(cls, value) -> "CacheRecord":
        """Best-effort decode of a v1 string or v2 dict: a torn sub-field
        is dropped (the entry degrades to model-only), an unparseable plan
        leaves ``plan=None`` so the caller selects again."""
        if isinstance(value, str):
            try:
                return cls(plan=cls._PLAN_CODEC.decode(value))
            except ValueError:            # stale schedule name
                return cls()
        if not isinstance(value, dict):
            return cls()
        plan = None
        raw_plan = value.get("plan")
        if isinstance(raw_plan, str):
            try:
                plan = cls._PLAN_CODEC.decode(raw_plan)
            except ValueError:
                plan = None
        measured: Dict[str, float] = {}
        raw_m = value.get("measured_us")
        if isinstance(raw_m, dict):
            for k, v in raw_m.items():
                try:
                    cls._PLAN_CODEC.decode(str(k))
                    us = float(v)
                except (ValueError, TypeError):
                    continue              # torn entry: skip, keep the rest
                if math.isfinite(us) and us > 0:
                    measured[str(k)] = us
        feats: Dict[str, Tuple[float, Dict[str, float]]] = {}
        raw_f = value.get("features")
        if isinstance(raw_f, dict):
            for k, v in raw_f.items():
                try:
                    base = float(v[0])
                    fd = {str(n): float(c) for n, c in v[1].items()}
                except (ValueError, TypeError, IndexError, KeyError,
                        AttributeError):
                    continue
                feats[str(k)] = (base, fd)
        return cls(plan=plan, measured_us=measured, features=feats)


@dataclasses.dataclass(frozen=True)
class ShardedCacheRecord(CacheRecord):
    """Cache entry of the ``advance_sharded`` family: the storage format
    and merge rule of :class:`CacheRecord`, with the :class:`ShardedPlan`
    codec, so neither family's entries read as the other's."""

    plan: Optional[ShardedPlan] = None

    _PLAN_CODEC: ClassVar[type] = ShardedPlan


class AutotuneCache:
    """Two-level (memory + JSON file) plan cache.

    The file path is resolved at each use, so ``REPRO_TORCH_AUTOTUNE_CACHE``
    set after import is honoured.  Writes re-read the file, merge, and
    replace it atomically (tempfile + ``os.replace``), so concurrent
    writers never corrupt it; a corrupt or missing file reads as empty, and
    a read-only one leaves the cache memory-only.
    """

    def __init__(self, path: Optional[pathlib.Path] = None):
        self._explicit_path = pathlib.Path(path) if path else None
        # raw JSON values: v1 "schedule@path" strings or v2 record dicts
        self._mem: Dict[str, object] = {}
        self._loaded = False
        self._lock = threading.Lock()

    @property
    def path(self) -> pathlib.Path:
        return self._explicit_path or _default_cache_path()

    def _read_disk(self) -> Dict[str, object]:
        """Best-effort parse of the on-disk table; corrupt/missing -> {}."""
        try:
            on_disk = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return {}
        if not isinstance(on_disk, dict):
            return {}
        return {str(k): v for k, v in on_disk.items()
                if isinstance(v, (str, dict))}

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        # memory wins on conflict (fresher within this process)
        self._mem = {**self._read_disk(), **self._mem}

    def get(self, key: str) -> Optional[Schedule]:
        plan = self.get_plan(key)
        return plan.schedule if plan else None

    def get_plan(self, key: str) -> Optional[Plan]:
        record = self.get_record(key)
        return record.plan if record else None

    def get_record(self, key: str) -> Optional[CacheRecord]:
        """Decoded record (v1 or v2) for ``key``; ``None`` when absent."""
        with self._lock:
            self._load()
            value = self._mem.get(key)
        return CacheRecord.decode(value) if value is not None else None

    def get_sharded_record(self, key: str) -> Optional[ShardedCacheRecord]:
        """Like :meth:`get_record`, decoded with the sharded plan codec."""
        with self._lock:
            self._load()
            value = self._mem.get(key)
        return (ShardedCacheRecord.decode(value) if value is not None
                else None)

    def records(self) -> Dict[str, CacheRecord]:
        """Every decoded entry (memory + disk): the fit's view."""
        with self._lock:
            self._load()
            snapshot = dict(self._mem)
        return {k: CacheRecord.decode(v) for k, v in snapshot.items()}

    def put(self, key: str, schedule: Schedule) -> None:
        self.put_plan(key, Plan(schedule))

    def put_plan(self, key: str, plan: Plan) -> None:
        self.put_record(key, CacheRecord(plan=plan))

    def put_record(self, key: str, record: CacheRecord) -> None:
        """Store a record, merged with the key's prior one: measurements
        already held survive a write that carries fewer (a model-only
        selection never erases them); on a per-plan conflict the incoming
        measurement wins.  The record's own class (plain or
        :class:`ShardedCacheRecord`) decodes the prior, so each family
        merges against itself."""
        record_cls = type(record)
        with self._lock:
            self._load()
            prior = record_cls.decode(self._mem.get(key)) \
                if key in self._mem else None
            if prior is not None and (prior.is_measured or prior.features):
                record = record_cls(
                    plan=record.plan or prior.plan,
                    measured_us={**prior.measured_us, **record.measured_us},
                    features={**prior.features, **record.features})
            self._mem[key] = record.encode()
            snapshot = dict(self._mem)
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # merge with the current file so a concurrent writer's keys
            # survive this replace
            merged = {**self._read_disk(), **snapshot}
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(merged, f, indent=0, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            pass                    # read-only file system: memory only


_DEFAULT_CACHE = AutotuneCache()


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


def blend_scores(scores: Dict[Plan, float],
                 measured: Dict[Plan, float]) -> Dict[Plan, float]:
    """Measurement as posterior over the model as prior, in wall-clock
    units: a measured plan scores its median; an unmeasured one its modeled
    cost times the geometric-mean measured/modeled ratio of the measured
    set.  With no measurements this is the identity."""
    if not measured:
        return dict(scores)
    alpha = geomean([us / max(scores[p], 1e-9)
                     for p, us in measured.items() if p in scores])
    return {p: measured[p] if p in measured else alpha * c
            for p, c in scores.items()}


def _plan_features(spec: WorkSpec, num_blocks: int, plan: Plan,
                   workload: str):
    try:
        return cost_features(spec, plan.schedule, num_blocks,
                             path=str(plan.path), workload=workload)
    except ValueError:               # family without a feature story
        return None


def select_plan(spec: WorkSpec, num_blocks: int, *,
                cache: Optional[AutotuneCache] = _DEFAULT_CACHE,
                plans: Sequence[Plan] = REGISTERED_PLANS,
                workload: str = "reduce",
                measure: Optional[Callable[[Plan], float]] = None,
                measure_k: Optional[int] = None) -> Plan:
    """The cheapest (schedule, execution path) plan; earlier plans win
    ties.  Cached under ``<shape_key>|plan`` (plus ``.<workload>`` for the
    non-reduce families); ``cache=None`` selects every call.

    **Measured mode:** when ``measure`` (``Plan -> median us`` on the
    caller's own workload, built with
    :func:`repro_torch.core.measure.time_fn`) is given *and*
    ``REPRO_AUTOTUNE_MEASURE`` is on, the ``measure_k`` model-ranked
    cheapest candidates not yet measured are timed once, persisted with
    their cost features, and the pick is the argmin of
    :func:`blend_scores`.  A record that already holds the needed
    measurements is reused without timing anything.
    """
    _check_workload(workload)
    measuring = measure is not None and measurement_enabled()
    key = None
    record = None
    if cache is not None:
        key = shape_key(spec, num_blocks) + "|plan"
        if workload != "reduce":
            key += f".{workload}"
        record = cache.get_record(key)
    measured: Dict[Plan, float] = {}
    if record is not None:
        for enc, us in record.measured_us.items():
            try:
                p = Plan.decode(enc)
            except ValueError:
                continue
            if p in plans:
                measured[p] = us
    if record is not None and record.plan is not None \
            and record.plan in plans and not measuring:
        # model-only fast path (a measured record's plan is the blended
        # decision)
        return record.plan
    scores = score_plans(spec, num_blocks, plans, workload)
    new_measurements: Dict[Plan, float] = {}
    if measuring:
        k = min(_measure_topk(measure_k), len(plans))
        # stable model ranking: plan order breaks ties, like the argmin
        ranked = sorted(plans, key=lambda p: (scores[p],
                                              list(plans).index(p)))
        for p in ranked[:k]:
            if p not in measured:
                us = float(measure(p))
                if math.isfinite(us) and us > 0:
                    measured[p] = us
                    new_measurements[p] = us
        if record is not None and record.plan is not None \
                and record.plan in plans and not new_measurements:
            # every needed candidate was measured already: reuse
            return record.plan
    blended = blend_scores(scores, measured)
    best = min(plans, key=lambda p: (blended[p], list(plans).index(p)))
    if cache is not None:
        feats = {}
        for p in new_measurements:
            f = _plan_features(spec, num_blocks, p, workload)
            if f is not None:
                feats[p.encode()] = f
        cache.put_record(key, CacheRecord(
            plan=best,
            measured_us={p.encode(): us
                         for p, us in new_measurements.items()},
            features=feats))
    return best


def select_sharded_plan(global_spec: WorkSpec, shard_specs_by_count,
                        num_blocks: int, *,
                        push_spec: Optional[WorkSpec] = None,
                        cache: Optional[AutotuneCache] = _DEFAULT_CACHE,
                        plans: Sequence[Plan] = REGISTERED_PLANS,
                        halo_elems: Optional[int] = None,
                        elem_bytes: int = 4,
                        measure: Optional[Callable[[ShardedPlan],
                                                   float]] = None,
                        measure_k: Optional[int] = None) -> ShardedPlan:
    """The cheapest (shard count, boundary, schedule, path) tuple.

    ``shard_specs_by_count`` maps each candidate shard count to either
    ``{boundary_name: [S+1] boundaries}`` (scored by slicing the global
    views, :func:`~repro_torch.core.balance.shard_specs_from_boundaries`)
    or a sequence of per-shard pull WorkSpecs (one ``equal_width``
    candidate scored on them).  Candidates are that cross ``plans``;
    scoring is :func:`~repro_torch.core.balance.modeled_sharded_cost`
    with ``halo_elems`` (default one element a global tile), plus the push
    view's at the push charge when ``push_spec`` is given.  Cached under
    ``<shape_key>|plan.advance_sharded.b`` as a
    :class:`ShardedCacheRecord`; measured mode is :func:`select_plan`'s.
    """
    counts = sorted(int(s) for s in shard_specs_by_count)
    if not counts:
        raise ValueError("shard_specs_by_count must name at least one "
                         "candidate shard count")
    bounds_by_cand: Dict[Tuple[int, str], object] = {}
    for c in counts:
        entry = shard_specs_by_count[c]
        if isinstance(entry, dict):
            if not entry:
                raise ValueError(f"count {c}: no boundary candidates")
            for bname, bounds in entry.items():
                bounds_by_cand[(c, str(bname))] = bounds
        else:
            bounds_by_cand[(c, "equal_width")] = None
    candidates: Tuple[ShardedPlan, ...] = tuple(
        ShardedPlan(p.schedule, p.path, c, bname)
        for (c, bname) in bounds_by_cand for p in plans)
    if halo_elems is None:
        halo_elems = global_spec.num_tiles
    atom_work = WORKLOAD_ATOM_WORK["advance_sharded"]
    push_atom_work = WORKLOAD_ATOM_WORK["advance_sharded_push"]
    measuring = measure is not None and measurement_enabled()
    key = None
    record = None
    if cache is not None:
        key = shape_key(global_spec, num_blocks) + "|plan.advance_sharded.b"
        record = cache.get_sharded_record(key)
    measured: Dict[ShardedPlan, float] = {}
    if record is not None:
        for enc, us in record.measured_us.items():
            try:
                sp = ShardedPlan.decode(enc)
            except ValueError:
                continue
            if sp in candidates:
                measured[sp] = us
    if record is not None and record.plan is not None \
            and record.plan in candidates and not measuring:
        return record.plan

    def _score(sp: ShardedPlan) -> float:
        bounds = bounds_by_cand[(sp.num_shards, sp.boundary)]
        if bounds is None:
            return modeled_sharded_cost(
                shard_specs_by_count[sp.num_shards], sp.schedule,
                num_blocks, path=str(sp.path), atom_work=atom_work,
                halo_elems=halo_elems, elem_bytes=elem_bytes)
        cost = modeled_sharded_cost(
            global_spec, sp.schedule, num_blocks, path=str(sp.path),
            atom_work=atom_work, halo_elems=halo_elems,
            elem_bytes=elem_bytes, boundaries=bounds)
        if push_spec is not None:
            cost += modeled_sharded_cost(
                push_spec, sp.schedule, num_blocks, path=str(sp.path),
                atom_work=push_atom_work, halo_elems=halo_elems,
                elem_bytes=elem_bytes, boundaries=bounds)
        return cost

    scores = {sp: _score(sp) for sp in candidates}
    new_measurements: Dict[ShardedPlan, float] = {}
    if measuring:
        k = min(_measure_topk(measure_k), len(candidates))
        ranked = sorted(candidates,
                        key=lambda p: (scores[p], candidates.index(p)))
        for p in ranked[:k]:
            if p not in measured:
                us = float(measure(p))
                if math.isfinite(us) and us > 0:
                    measured[p] = us
                    new_measurements[p] = us
        if record is not None and record.plan is not None \
                and record.plan in candidates and not new_measurements:
            return record.plan
    blended = blend_scores(scores, measured)
    best = min(candidates, key=lambda p: (blended[p], candidates.index(p)))
    if cache is not None:
        cache.put_record(key, ShardedCacheRecord(
            plan=best,
            measured_us={p.encode(): us
                         for p, us in new_measurements.items()}))
    return best


def collect_fit_samples(cache: AutotuneCache,
                        ) -> List[Tuple[float, Dict[str, float], float]]:
    """``(base, feats, measured_us)`` samples from a cache: one per plan of
    every record that has both a measured median and a feature
    decomposition (what :func:`~repro_torch.core.balance.fit_coefficients`
    consumes)."""
    samples: List[Tuple[float, Dict[str, float], float]] = []
    for record in cache.records().values():
        for enc, us in record.measured_us.items():
            if enc in record.features:
                base, feats = record.features[enc]
                samples.append((base, dict(feats), float(us)))
    return samples


def select_schedule(spec: WorkSpec, num_blocks: int, *,
                    cache: Optional[AutotuneCache] = _DEFAULT_CACHE,
                    schedules: Sequence[Schedule] = REGISTERED_SCHEDULES
                    ) -> Schedule:
    """The cheapest schedule by modeled cost (cached per shape)."""
    key = None
    if cache is not None:
        key = shape_key(spec, num_blocks)
        hit = cache.get(key)
        if hit is not None and hit in schedules:
            return hit
    scores = score_schedules(spec, num_blocks, schedules)
    best = min(schedules, key=lambda s: (scores[s],
                                         list(schedules).index(s)))
    if cache is not None:
        cache.put(key, best)
    return best
