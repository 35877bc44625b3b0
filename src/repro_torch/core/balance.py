"""Imbalance metrics, per-schedule cost models, and the paper's heuristic.

The models charge the *lockstep cost* of each schedule: a block of
``LANES`` parallel lanes pays the ``max`` over its lanes, not the mean.
The coefficients are the reference's, unchanged (its TPU-flavoured
``LANES = 8 * 128`` included), so ``schedule="auto"`` picks the same plan
as the reference for the same workload.  Recalibrating them for Hopper is
ROADMAP work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.schedules import Schedule, make_partition
from repro_torch.core.work import WorkSpec

LANES = 8 * 128          # parallel lanes per block (the reference's VPU tile)
SEARCH_OVERHEAD = 32     # per-block partition/search setup cost (work items)
PREFIX_OVERHEAD = 8      # group-mapped per-tile prefix-sum cost
CHUNK_OVERHEAD = 2       # chunked queue on the pure path, per chunk
NATIVE_CHUNK_OVERHEAD = 1  # chunked queue on the native kernel, per pop
INSPECT_OVERHEAD = 2     # adaptive: per-block share of the inspector pass
FIXUP_OVERHEAD = 4       # adaptive: boundary fixup when tiles were split
ADVANCE_ATOM_WORK = 2    # masked pull advance: mask load + select per atom
ADVANCE_PUSH_ATOM_WORK = 4  # push advance: value + destination gather +
                         # scatter-combine share, per *active* out-edge
ADVANCE_DELTA_ATOM_WORK = 3  # bucketed pull advance: + bucket-mask select
ADVANCE_DELTA_PUSH_ATOM_WORK = ADVANCE_PUSH_ATOM_WORK + 1  # bucketed push
WAVEFRONT_ATOM_WORK = 3  # wavefront dependency combine: resolved-mask load
                         # + select + feature-row gather share per in-edge
WAVEFRONT_PUSH_ATOM_WORK = ADVANCE_PUSH_ATOM_WORK + 1  # wavefront push
COMPACT_GATHER_WORK = 1  # compacted push windows: one extra indirection
COMPACT_BUILD_OVERHEAD = 8  # per-block share of building the compact index
HALO_BYTE_COST = 1 / 512  # work units per byte a sharded iteration moves
                         # (the frontier/state all_gather, the push
                         # partials' combine): small graphs collapse to 1
                         # shard
SHARD_SYNC_OVERHEAD = 48  # per-iteration collective latency charge, paid
                         # once a mesh axis is involved


def _ceil_lanes(x: torch.Tensor) -> torch.Tensor:
    """``ceil(x / LANES)`` for non-negative integer tensors."""
    return torch.div(x + (LANES - 1), LANES, rounding_mode="floor")


@dataclasses.dataclass(frozen=True)
class ImbalanceStats:
    max_atoms_per_tile: int
    mean_atoms_per_tile: float
    cv_atoms_per_tile: float          # coefficient of variation
    empty_tile_fraction: float
    gini: float                       # work concentration

    @classmethod
    def measure(cls, spec: WorkSpec) -> "ImbalanceStats":
        sizes = spec.atoms_per_tile().cpu().numpy()
        if sizes.size == 0:
            return cls(0, 0.0, 0.0, 0.0, 0.0)
        mean = float(sizes.mean())
        cv = float(sizes.std() / mean) if mean > 0 else 0.0
        srt = np.sort(sizes).astype(np.float64)
        n = srt.size
        csum = srt.cumsum()
        gini = (float((n + 1 - 2 * (csum / csum[-1]).sum()) / n)
                if csum[-1] > 0 else 0.0)
        return cls(int(sizes.max()), mean, cv,
                   float((sizes == 0).mean()), gini)


def modeled_block_cost(spec: WorkSpec, schedule: Schedule | str,
                       num_blocks: int, *, path: str = "pure",
                       atom_work: float = 1) -> torch.Tensor:
    """Lockstep cost (work-item steps) each block pays, ``[num_blocks]``.

    ``atom_work`` scales the atom-proportional term only (never the
    per-block overheads); fractional values model density-scaled push
    advances.  ``path`` moves the chunked queue's per-pop overhead.
    """
    atom_units, overhead = block_cost_terms(spec, schedule, num_blocks,
                                            path=path)
    if isinstance(atom_work, (int, np.integer)):
        atom_work = max(int(atom_work), 1)   # integer requests: exact ints
    else:
        atom_work = max(float(atom_work), 0.0)
    return atom_units * atom_work + overhead


def block_cost_terms(spec: WorkSpec, schedule: Schedule | str,
                     num_blocks: int, *, path: str = "pure",
                     part=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block ``(atom_units, overhead)``: the cost is
    ``atom_units * atom_work + overhead`` for any per-atom weight.  ``part``
    reuses a Partition already built for this (spec, schedule, blocks)."""
    schedule = Schedule(schedule)
    if spec.num_tiles == 0:      # empty tile set: nothing to schedule
        zero = torch.zeros(num_blocks, dtype=torch.int32, device=spec.device)
        return zero, zero
    if part is None:
        part = make_partition(spec, schedule, num_blocks)
    sizes = spec.atoms_per_tile()
    atoms_in_block = part.atom_starts[1:] - part.atom_starts[:-1]
    tiles_in_block = part.tile_starts[1:] - part.tile_starts[:-1]
    if schedule == Schedule.THREAD_MAPPED:
        # one tile per lane: a block pays its largest tile per wave
        tiles_per_block = max(part.items_per_block, 1)
        starts = part.tile_starts
        idx = starts[:-1, None] + torch.arange(
            tiles_per_block, dtype=torch.int32, device=spec.device)[None, :]
        valid = idx < starts[1:, None]
        span = torch.where(
            valid, sizes[torch.clamp(idx, max=spec.num_tiles - 1).long()], 0)
        per_block_max = span.max(dim=1).values
        waves = -(-tiles_per_block // LANES)
        return per_block_max * waves, torch.zeros_like(per_block_max)
    if schedule in (Schedule.GROUP_MAPPED, Schedule.WARP_MAPPED,
                    Schedule.BLOCK_MAPPED):
        return (_ceil_lanes(atoms_in_block),
                PREFIX_OVERHEAD * _ceil_lanes(tiles_in_block))
    if schedule == Schedule.NONZERO_SPLIT:
        units = _ceil_lanes(atoms_in_block)
        return units, torch.full_like(units, SEARCH_OVERHEAD)
    if schedule == Schedule.MERGE_PATH:
        units = torch.full((num_blocks,), -(-part.items_per_block // LANES),
                           dtype=torch.int32, device=spec.device)
        return units, torch.full_like(units, SEARCH_OVERHEAD)
    if schedule == Schedule.CHUNKED:
        # a physical block pays the sum over its chunks of the chunk's
        # lockstep steps plus the queue-pop overhead
        pop = NATIVE_CHUNK_OVERHEAD if path == "native" else CHUNK_OVERHEAD
        phys = part.num_physical_blocks or num_blocks
        owner = part.block_map.long()
        units = torch.zeros(phys, dtype=torch.int32, device=spec.device)
        units.index_add_(0, owner, _ceil_lanes(atoms_in_block))
        pops = torch.zeros(phys, dtype=torch.int32, device=spec.device)
        pops.index_add_(0, owner, torch.ones_like(atoms_in_block))
        return units, pop * pops
    if schedule == Schedule.ADAPTIVE:
        fixup = 0 if part.tile_aligned else FIXUP_OVERHEAD
        return (_ceil_lanes(atoms_in_block),
                PREFIX_OVERHEAD * _ceil_lanes(tiles_in_block)
                + INSPECT_OVERHEAD + fixup)
    raise ValueError(schedule)


def modeled_cost(spec: WorkSpec, schedule: Schedule | str,
                 num_blocks: int, *, path: str = "pure",
                 atom_work: float = 1) -> float:
    """Modeled time: the bottleneck block's cost."""
    costs = modeled_block_cost(spec, schedule, num_blocks, path=path,
                               atom_work=atom_work)
    return float(costs.max())


def shard_specs_from_boundaries(spec: WorkSpec, boundaries):
    """Per-shard real (unpadded) sub-views of a *global* work view: rows
    ``[b[s], b[s+1])`` of its offsets, rebased to atom 0, for a ``[S+1]``
    non-decreasing split ``boundaries`` of ``[0, num_tiles]``.  A boundary
    schedule is scored on these, its real max-over-shards work."""
    off = spec.tile_offsets.cpu().numpy()
    bounds = [int(b) for b in boundaries]
    if not bounds or bounds[0] != 0 or bounds[-1] != spec.num_tiles \
            or any(b > a for b, a in zip(bounds, bounds[1:])):
        raise ValueError(
            f"boundaries must be a non-decreasing [S+1] split of "
            f"[0, {spec.num_tiles}], got {bounds}")
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sub = (off[lo:hi + 1] - off[lo]).astype(np.int32)
        out.append(WorkSpec.from_segment_offsets(
            torch.from_numpy(sub).to(spec.device), num_atoms=int(sub[-1]),
            num_tiles=hi - lo))
    return out


def modeled_sharded_cost(shard_specs, schedule: Schedule | str,
                         num_blocks: int, *, path: str = "pure",
                         atom_work: float = 1, halo_elems: int = 0,
                         elem_bytes: int = 4, boundaries=None) -> float:
    """Modeled per-iteration cost of an advance sharded over a mesh: the
    max over the shards' own :func:`modeled_cost` (shards run concurrently
    like blocks do), plus, above one shard, ``SHARD_SYNC_OVERHEAD`` and
    ``HALO_BYTE_COST`` per byte of the ``halo_elems``-element halo.

    With ``boundaries=`` the first argument is one global
    :class:`~repro_torch.core.work.WorkSpec`, sliced by
    :func:`shard_specs_from_boundaries`.  Empty shards cost nothing.
    """
    if boundaries is not None:
        shard_specs = shard_specs_from_boundaries(shard_specs, boundaries)
    shard_specs = list(shard_specs)
    if not shard_specs:
        return 0.0
    compute = max((modeled_cost(s, schedule, num_blocks, path=path,
                                atom_work=atom_work)
                   for s in shard_specs if s.num_tiles > 0), default=0.0)
    if len(shard_specs) <= 1:
        return float(compute)
    comm = SHARD_SYNC_OVERHEAD + HALO_BYTE_COST * float(
        max(halo_elems, 0) * elem_bytes)
    return float(compute + comm)


def modeled_advance_cost(spec: WorkSpec, schedule: Schedule | str,
                         num_blocks: int, *, path: str = "pure",
                         direction: str = "pull",
                         density: float = 1.0,
                         window_mode: str = "masked") -> float:
    """Modeled cost of a frontier-masked graph advance over ``spec`` (the
    direction's own work view).

    Pull streams every in-edge (``1 + density * (ADVANCE_ATOM_WORK - 1)``
    per atom); push pays only active out-edges
    (``density * ADVANCE_PUSH_ATOM_WORK``).  ``window_mode="compact"``
    (push only) charges the mean active load per block plus the gather and
    index-build terms: compaction flattens frontier skew.
    """
    if direction not in ("pull", "push"):
        raise ValueError(f"unknown direction: {direction!r}")
    if window_mode not in ("masked", "compact"):
        raise ValueError(f"unknown window mode: {window_mode!r}")
    density = min(max(float(density), 0.0), 1.0)
    if window_mode == "compact":
        if direction != "push":
            raise ValueError("compacted windows are a push-direction mode "
                             "(pull streams its combine, nothing to compact)")
        active = int(np.ceil(density * spec.num_atoms))
        per_block = -(-max(active, 0) // max(num_blocks, 1))
        units = -(-per_block // LANES)
        return float(units * (ADVANCE_PUSH_ATOM_WORK + COMPACT_GATHER_WORK)
                     + COMPACT_BUILD_OVERHEAD)
    if direction == "pull":
        atom_work = 1.0 + density * (ADVANCE_ATOM_WORK - 1)
    else:
        atom_work = density * ADVANCE_PUSH_ATOM_WORK
    return modeled_cost(spec, schedule, num_blocks, path=path,
                        atom_work=atom_work)


def estimate_direction_threshold(pull_spec: WorkSpec, push_spec: WorkSpec,
                                 num_blocks: int, *,
                                 pull_schedule: Schedule | str,
                                 push_schedule: Schedule | str,
                                 pull_path: str = "pure",
                                 push_path: str = "pure",
                                 pull_part=None, push_part=None,
                                 samples: int = 17) -> float:
    """Smallest of ``samples`` frontier densities in [0, 1] at which the
    modeled pull advance is no dearer than push (1.0 if push always wins).
    Each direction is partitioned once: the cost is affine in the atom
    weight, so the sweep is arithmetic."""
    pull_units, pull_over = block_cost_terms(pull_spec, pull_schedule,
                                             num_blocks, path=pull_path,
                                             part=pull_part)
    push_units, push_over = block_cost_terms(push_spec, push_schedule,
                                             num_blocks, path=push_path,
                                             part=push_part)
    for i in range(samples):
        d = i / (samples - 1)
        pull = float((pull_units * (1.0 + d * (ADVANCE_ATOM_WORK - 1))
                      + pull_over).max())
        push = float((push_units * (d * ADVANCE_PUSH_ATOM_WORK)
                      + push_over).max())
        if pull <= push:
            return d
    return 1.0


def estimate_compact_capacity(num_edges: int, direction_threshold: float, *,
                              slack: float = 1.25, floor: int = 32) -> int:
    """Static slot count for the gather-compacted push windows:
    ``threshold * num_edges`` (with ``slack``) bounds the active edges of
    every push iteration.  Overflow is safe: the executor falls back to
    masked windows."""
    frac = min(max(float(direction_threshold), 0.0), 1.0)
    want = int(np.ceil(frac * max(num_edges, 0) * max(slack, 1.0)))
    return int(min(max(want, floor), max(num_edges, 1)))


#: The tunable coefficients the measured-cost loop can re-fit
#: (:func:`fit_coefficients`), with their current values.  The other
#: constants (LANES, the search/prefix/chunk/inspect/fixup overheads) are
#: treated as known and folded into each sample's base term.
def _fit_targets() -> Dict[str, float]:
    return {
        "ADVANCE_ATOM_WORK": float(ADVANCE_ATOM_WORK),
        "ADVANCE_PUSH_ATOM_WORK": float(ADVANCE_PUSH_ATOM_WORK),
        "ADVANCE_DELTA_ATOM_WORK": float(ADVANCE_DELTA_ATOM_WORK),
        "ADVANCE_DELTA_PUSH_ATOM_WORK": float(ADVANCE_DELTA_PUSH_ATOM_WORK),
        "WAVEFRONT_ATOM_WORK": float(WAVEFRONT_ATOM_WORK),
        "WAVEFRONT_PUSH_ATOM_WORK": float(WAVEFRONT_PUSH_ATOM_WORK),
        "NATIVE_CHUNK_OVERHEAD": float(NATIVE_CHUNK_OVERHEAD),
        "COMPACT_GATHER_WORK": float(COMPACT_GATHER_WORK),
        "COMPACT_BUILD_OVERHEAD": float(COMPACT_BUILD_OVERHEAD),
    }


#: Workload family -> the fit-target coefficient its atom term carries
#: (``None``: the plain tile-reduce, whose atom weight is the fixed 1).
WORKLOAD_ATOM_COEF = {"reduce": None,
                      "advance": "ADVANCE_ATOM_WORK",
                      "advance_push": "ADVANCE_PUSH_ATOM_WORK",
                      "advance_delta": "ADVANCE_DELTA_ATOM_WORK",
                      "advance_delta_push": "ADVANCE_DELTA_PUSH_ATOM_WORK",
                      "advance_sharded": "ADVANCE_ATOM_WORK",
                      "advance_sharded_push": "ADVANCE_PUSH_ATOM_WORK",
                      "advance_serve": "ADVANCE_ATOM_WORK",
                      "advance_serve_push": "ADVANCE_PUSH_ATOM_WORK",
                      "wavefront": "WAVEFRONT_ATOM_WORK",
                      "wavefront_push": "WAVEFRONT_PUSH_ATOM_WORK"}


def cost_features(spec: WorkSpec, schedule: Schedule | str, num_blocks: int,
                  *, path: str = "pure", workload: str = "reduce",
                  window_mode: str = "masked",
                  part=None) -> Tuple[float, Dict[str, float]]:
    """Decompose one plan's modeled cost over the tunable coefficients.

    Returns ``(base, feats)`` with ``modeled cost == base + sum(feats[n] *
    coefficient[n])`` at the bottleneck block under the current values
    (the max over blocks is linearised there).  ``base`` holds every
    non-tunable term.  ``window_mode="compact"`` (push families) decomposes
    the gather-compacted window model, which has no per-schedule max.
    """
    if workload not in WORKLOAD_ATOM_COEF:
        raise ValueError(f"unknown workload family: {workload!r} "
                         f"(expected one of {sorted(WORKLOAD_ATOM_COEF)})")
    targets = _fit_targets()
    atom_coef = WORKLOAD_ATOM_COEF[workload]
    if window_mode == "compact":
        if atom_coef not in ("ADVANCE_PUSH_ATOM_WORK",
                             "ADVANCE_DELTA_PUSH_ATOM_WORK"):
            raise ValueError("compact window features are a push-family "
                             "mode (window_mode='masked' for pull/reduce)")
        per_block = -(-max(spec.num_atoms, 0) // max(num_blocks, 1))
        units = float(-(-per_block // LANES))
        return 0.0, {atom_coef: units, "COMPACT_GATHER_WORK": units,
                     "COMPACT_BUILD_OVERHEAD": 1.0}
    schedule = Schedule(schedule)
    atom_units, overhead = block_cost_terms(spec, schedule, num_blocks,
                                            path=path, part=part)
    atom_units = atom_units.cpu().numpy()
    overhead = overhead.cpu().numpy()
    atom_work = 1.0 if atom_coef is None else targets[atom_coef]
    costs = atom_units * atom_work + overhead
    if costs.size == 0:
        return 0.0, {}
    b = int(np.argmax(costs))
    units = float(atom_units[b])
    over = float(overhead[b])
    feats: Dict[str, float] = {}
    base = 0.0
    if atom_coef is None:
        base += units
    else:
        feats[atom_coef] = units
    if schedule == Schedule.CHUNKED and path == "native":
        # the native pop charge is a fit target: overhead = pop * chunks
        feats["NATIVE_CHUNK_OVERHEAD"] = over / max(
            float(NATIVE_CHUNK_OVERHEAD), 1e-12)
    else:
        base += over
    return base, feats


@dataclasses.dataclass(frozen=True)
class FitResult:
    """Report of a measured-cost least-squares re-fit (report-only)."""

    coefficients: Dict[str, float]    # fitted values, current ones if unseen
    current: Dict[str, float]         # the values being judged
    scale_us_per_step: float          # wall-us per modeled lockstep step
    residual_rel: float               # ||r|| / ||t|| of the LS solve
    num_samples: int
    constrained: Tuple[str, ...]      # coefficients the samples actually hit

    def report(self) -> str:
        lines = [f"fit over {self.num_samples} measured samples: "
                 f"scale {self.scale_us_per_step:.3g} us/step, "
                 f"relative residual {self.residual_rel:.3f}",
                 f"{'coefficient':32s} {'current':>10s} {'fitted':>10s}"]
        for name, cur in sorted(self.current.items()):
            fit = self.coefficients[name]
            mark = "" if name in self.constrained else "  (unconstrained)"
            lines.append(f"{name:32s} {cur:10.3g} {fit:10.3g}{mark}")
        return "\n".join(lines)


def fit_coefficients(samples: Sequence[Tuple[float, Dict[str, float], float]],
                     *, min_scale: float = 1e-9) -> FitResult:
    """Least-squares re-fit of the tunable coefficients from measurements.

    ``samples`` are ``(base, feats, measured_us)`` triples
    (:func:`cost_features` plus a wall-clock median of the same plan; the
    autotuner's measured cache records carry them, see
    :func:`repro_torch.core.autotune.collect_fit_samples`).  The model
    ``measured_us ~= s * (base + sum_j feats[j] * c_j)`` is linear in ``s``
    and ``w_j = s * c_j``: solve by ordinary least squares, then ``c_j =
    w_j / s``.  Coefficients no sample exercises keep their current value;
    fitted values are floored at 1e-3.  Report-only: no constant changes.
    """
    samples = list(samples)
    current = _fit_targets()
    if not samples:
        raise ValueError("fit_coefficients needs at least one measured "
                         "sample (run the autotuner with "
                         "REPRO_AUTOTUNE_MEASURE=1 first)")
    names = sorted({n for _, feats, _ in samples for n in feats
                    if n in current})
    A = np.zeros((len(samples), 1 + len(names)))
    t = np.zeros(len(samples))
    for i, (base, feats, us) in enumerate(samples):
        A[i, 0] = float(base)
        for j, n in enumerate(names):
            A[i, 1 + j] = float(feats.get(n, 0.0))
        t[i] = float(us)
    sol, *_ = np.linalg.lstsq(A, t, rcond=None)
    s = float(sol[0])
    if not s > min_scale:
        # no sample carried base weight (or the solve degenerated): anchor
        # the scale on the median measured-us per modeled step instead
        steps = A[:, 0] + A[:, 1:] @ np.asarray(
            [current[n] for n in names]) if names else A[:, 0]
        steps = np.where(steps > 0, steps, 1.0)
        s = float(np.median(t / steps))
        s = max(s, min_scale)
    fitted = dict(current)
    for j, n in enumerate(names):
        fitted[n] = max(float(sol[1 + j]) / s, 1e-3)
    resid = A @ sol - t
    denom = float(np.linalg.norm(t))
    return FitResult(coefficients=fitted, current=current,
                     scale_us_per_step=s,
                     residual_rel=float(np.linalg.norm(resid)) /
                     max(denom, 1e-12),
                     num_samples=len(samples),
                     constrained=tuple(names))


def choose_schedule(num_tiles: int, num_atoms: int, *, alpha: int = 500,
                    beta: int = 10_000) -> Schedule:
    """The paper's §6.2 heuristic: merge-path unless the matrix is small."""
    if num_tiles < alpha and num_atoms < beta:
        if num_atoms <= num_tiles * 2:       # near-uniform, tiny tiles
            return Schedule.THREAD_MAPPED
        return Schedule.GROUP_MAPPED
    return Schedule.MERGE_PATH


def landscape(spec: WorkSpec, num_blocks: int, *,
              include_dynamic: bool = False) -> Dict[str, float]:
    """Modeled cost of every schedule for one workload (Fig. 3 datapoint)."""
    scheds = [Schedule.THREAD_MAPPED, Schedule.GROUP_MAPPED,
              Schedule.NONZERO_SPLIT, Schedule.MERGE_PATH]
    if include_dynamic:
        scheds += [Schedule.CHUNKED, Schedule.ADAPTIVE]
    return {str(s): modeled_cost(spec, s, num_blocks) for s in scheds}
