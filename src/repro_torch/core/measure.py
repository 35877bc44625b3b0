"""Wall-clock measurement for the measured-cost feedback loop.

The cost models in :mod:`repro_torch.core.balance` count lockstep steps of
the reference's TPU-flavoured block; on the card the only ground truth is
a wall clock.  The autotuner's measured mode
(:func:`repro_torch.core.autotune.select_plan` with ``measure=``) times its
candidates here, so every recorded microsecond obeys the same warmup /
median discipline and bumps the same counter.

``time_fn`` enforces ``warmup >= 1`` and ``iters >= 1``: the first call of
a candidate pays its one-time costs (a kernel library's first load, the
allocator's first blocks), which must not pollute the steady-state median.
PyTorch returns before the card finishes, so when the callable gives CUDA
tensors the clock is bracketed by ``torch.cuda.synchronize()`` (the
reference's ``jax.block_until_ready``); on CPU tensors nothing is
synchronized.

Every ``time_fn`` call bumps :func:`measurement_count`, the hook the tests
use to assert that a reloaded cache re-ranks without measuring again.
"""
from __future__ import annotations

import math
import time
from typing import Iterable

import torch

_measurement_count = 0


def measurement_count() -> int:
    """Total ``time_fn`` invocations in this process."""
    return _measurement_count


def _on_card(out) -> bool:
    """True when ``out`` (a tensor or a nest of tuples, lists and dicts)
    holds a CUDA tensor."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_card(o) for o in out)
    if isinstance(out, dict):
        return any(_on_card(o) for o in out.values())
    return False


def time_fn(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median steady-state wall time (us) of ``fn(*args)``.

    ``warmup`` calls run first and are discarded; the result is the median
    of ``iters`` timed calls.  When the calls give CUDA tensors, the card
    is synchronized before the clock starts and before it stops.
    """
    if warmup < 1:
        raise ValueError(
            f"time_fn needs warmup >= 1 (got {warmup}): the first call pays "
            f"one-time costs, which must not pollute the steady-state "
            f"median")
    if iters < 1:
        raise ValueError(f"time_fn needs iters >= 1 (got {iters})")
    global _measurement_count
    _measurement_count += 1
    for _ in range(warmup):
        out = fn(*args)
    sync = _on_card(out)
    times = []
    for _ in range(iters):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def geomean(xs: Iterable[float]) -> float:
    """Geometric mean of positive samples (floored at 1e-12); an empty
    input is an error."""
    xs = list(xs)
    if not xs:
        raise ValueError("geomean of an empty sequence is undefined "
                         "(empty benchmark sweep?)")
    xs = [max(float(x), 1e-12) for x in xs]
    return math.exp(sum(math.log(x) for x in xs) / len(xs))
