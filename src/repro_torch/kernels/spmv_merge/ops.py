"""Public wrapper: CSR in, dense y out, merge-path balanced."""
from __future__ import annotations

import torch

from repro_torch.core.execute import (ExecutionPath, choose_execution_path,
                                      execute_tile_reduce)
from repro_torch.core.schedules import Schedule, make_partition
from repro_torch.kernels.spmv_merge import kernel as _kernel

#: Grid the autotuner scores against when no explicit num_blocks is given.
DEFAULT_NUM_BLOCKS = 64

#: Accepted ``schedule=`` spellings for the dynamic queue policies.
_CHUNK_POLICIES = {"chunked": "lpt", "chunked_lpt": "lpt",
                   "chunked_rr": "round_robin"}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def merge_block_items(A, num_blocks: int) -> int:
    """Stream items per block that cut ``A``'s merged (rows + nnz) stream
    into ``num_blocks`` blocks (a multiple of 128)."""
    return max(_round_up(-(-(A.shape[0] + A.nnz) // num_blocks), 128), 128)


def _spmv_measure(A, x: torch.Tensor, nb: int):
    """Measured-mode timing closure: one candidate plan on this very
    SpMV."""
    from repro_torch.core.measure import time_fn
    spec = A.workspec()
    vals, cols = A.values, A.col_indices

    def run(plan) -> float:
        part = make_partition(spec, plan.schedule, nb)
        f = lambda xv: execute_tile_reduce(
            spec, part, lambda nz: vals[nz] * xv[cols[nz]], path=plan.path)
        return time_fn(f, x, warmup=1, iters=3)
    return run


def spmv_merge_path(A, x: torch.Tensor, *, num_blocks: int | None = None,
                    block_items: int = 512,
                    schedule: Schedule | str | None = None,
                    execution_path: ExecutionPath | str = ExecutionPath.AUTO,
                    measure=None) -> torch.Tensor:
    """Merge-path SpMV ``y = A @ x`` for a :class:`repro_torch.sparse.CSR`.

    ``schedule=None`` runs the merge-path kernel over the CSR.
    ``block_items``, or ``num_blocks`` (which overrides it to target that
    grid), cuts the blocks of the plain version — the CPU path, the
    reference's blocked formulation; on the card the kernel cuts the merge
    path into its own tiles.

    ``schedule`` set runs the chunk-walk executor over a Partition instead:
    ``"auto"`` asks the cost-model autotuner for a (schedule, path) plan;
    ``"chunked"``/``"chunked_lpt"``/``"chunked_rr"``/``"adaptive"`` build
    that dynamic partition.  With ``execution_path="auto"`` or
    ``"native"`` they run on the chunk-walk kernel; ``"pure"`` keeps the
    reference's fallback, the merge-path SpMV on the chunk-level grid.
    Other explicit schedules set that grid to ``num_blocks``.

    ``measure`` is the measured-cost knob of ``schedule="auto"``: ``None``
    times the top model-ranked candidates on this matrix and vector when
    ``REPRO_AUTOTUNE_MEASURE=1``, ``False`` stays model-only, a callable
    ``(plan) -> median_us`` is used as given.
    """
    if schedule is not None:
        policy = _CHUNK_POLICIES.get(str(schedule))
        sched = Schedule.CHUNKED if policy else Schedule(schedule)
        nb = num_blocks or DEFAULT_NUM_BLOCKS
        if sched == Schedule.AUTO:
            from repro_torch.core.autotune import (measurement_enabled,
                                                   select_plan)
            if callable(measure):
                m = measure
            elif measure is not False and measurement_enabled():
                m = _spmv_measure(A, x, nb)
            else:
                m = None
            plan = select_plan(A.workspec(), nb, measure=m)
            sched = plan.schedule
            policy = "lpt" if sched == Schedule.CHUNKED else None
            if ExecutionPath(execution_path) == ExecutionPath.AUTO:
                execution_path = plan.path
        num_blocks = nb
        if sched in (Schedule.CHUNKED, Schedule.ADAPTIVE):
            # an explicit "pure" request never consults the partition
            path = ExecutionPath(execution_path)
            if path != ExecutionPath.PURE:
                spec = A.workspec()
                part = make_partition(spec, sched, nb,
                                      chunk_policy=policy or "lpt")
                path = choose_execution_path(part, execution_path)
            if path == ExecutionPath.NATIVE:
                vals, cols = A.values, A.col_indices
                return execute_tile_reduce(
                    spec, part, lambda nz: vals[nz] * x[cols[nz]], path=path)
            if sched == Schedule.CHUNKED:
                from repro_torch.core.dynamic import DEFAULT_CHUNK_FACTOR
                num_blocks = min(DEFAULT_CHUNK_FACTOR * nb, max(A.nnz, 1))
    if num_blocks is not None:
        block_items = merge_block_items(A, num_blocks)
    return _kernel.spmv_merge_csr(
        A.row_offsets, A.col_indices, A.values.float().contiguous(),
        x.float().contiguous(), num_rows=A.shape[0], num_cols=A.shape[1],
        block_items=block_items)
