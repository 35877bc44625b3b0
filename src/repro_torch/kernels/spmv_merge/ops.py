"""Public wrapper: CSR in, dense y out, merge-path balanced."""
from __future__ import annotations

import torch

from repro_torch.core.execute import (ExecutionPath, choose_execution_path,
                                      execute_tile_reduce)
from repro_torch.core.schedules import Schedule, make_partition
from repro_torch.kernels.spmv_merge import kernel as _kernel
from repro_torch.kernels.spmv_merge import ref as _ref

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


def merge_stream_operands(A, x: torch.Tensor, *, block_items: int):
    """``(stream_vals, stream_rows, row_base)``: the merge-path block
    kernel's operands for ``y = A @ x``, as :func:`spmv_merge_path` builds
    them."""
    num_rows = A.shape[0]
    total = _round_up(max(num_rows + A.nnz, 1), block_items)
    stream_vals, stream_rows = _ref.merge_stream_ref(
        A.row_offsets, A.col_indices, A.values, x, num_rows, A.nnz, total)
    grid = total // block_items
    row_base = stream_rows[::block_items][:grid]
    # a block may begin on padding (row == num_rows): clamp its base so
    # its bins stay in range (its values are all zero regardless)
    row_base = torch.clamp(row_base, max=max(num_rows - 1, 0)).contiguous()
    return stream_vals, stream_rows, row_base


def spmv_merge_path(A, x: torch.Tensor, *, num_blocks: int | None = None,
                    block_items: int = 512,
                    schedule: Schedule | str | None = None,
                    execution_path: ExecutionPath | str = ExecutionPath.AUTO
                    ) -> torch.Tensor:
    """Merge-path SpMV ``y = A @ x`` for a :class:`repro_torch.sparse.CSR`.

    ``schedule=None`` runs the merge-path block kernel over the merged
    (rows + nnz) stream; ``num_blocks`` (if given) overrides
    ``block_items`` to target that grid.

    ``schedule`` set runs the chunk-walk executor over a Partition instead:
    ``"auto"`` asks the cost-model autotuner for a (schedule, path) plan;
    ``"chunked"``/``"chunked_lpt"``/``"chunked_rr"``/``"adaptive"`` build
    that dynamic partition.  With ``execution_path="auto"`` or
    ``"native"`` they run on the chunk-walk kernel; ``"pure"`` keeps the
    reference's fallback, the merge-stream kernel at chunk granularity.
    Other explicit schedules set the merge-stream grid to ``num_blocks``.
    """
    if schedule is not None:
        policy = _CHUNK_POLICIES.get(str(schedule))
        sched = Schedule.CHUNKED if policy else Schedule(schedule)
        nb = num_blocks or DEFAULT_NUM_BLOCKS
        if sched == Schedule.AUTO:
            from repro_torch.core.autotune import select_plan
            plan = select_plan(A.workspec(), nb)
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
    return _kernel.spmv_merge_stream(
        *merge_stream_operands(A, x, block_items=block_items),
        num_rows=A.shape[0], block_items=block_items)
