"""repro_torch.core — the paper's load-balancing abstraction in PyTorch.

Pipeline (paper Fig. 1): sparse input -> :class:`WorkSpec` (atoms/tiles) ->
:class:`Partition` via a :class:`Schedule` -> work execution (the executors
here, CUDA kernels in :mod:`repro_torch.kernels`).
"""
from repro_torch.core.work import WorkSpec, validate_workspec
from repro_torch.core.schedules import (
    Partition,
    Schedule,
    group_mapped_partition,
    invert_block_map,
    make_partition,
    merge_path_partition,
    nonzero_split_partition,
    partition_build_count,
    tile_mapped_partition,
)
from repro_torch.core.execute import (
    COMBINER_IDENTITY,
    ExecutionPath,
    blocked_compact_value_windows,
    blocked_tile_reduce,
    blocked_value_windows,
    choose_execution_path,
    compact_active_atoms,
    compact_chunk_starts,
    execute_scatter_reduce,
    execute_tile_reduce,
    native_chunk_tile_reduce,
    native_chunk_value_windows,
    native_compact_value_windows,
    resolve_execution_path,
    scatter_compact_windows,
    scatter_value_windows,
    supports_native_execution,
    tile_reduce,
)
from repro_torch.core.balance import (
    ADVANCE_ATOM_WORK,
    ADVANCE_DELTA_ATOM_WORK,
    ADVANCE_DELTA_PUSH_ATOM_WORK,
    ADVANCE_PUSH_ATOM_WORK,
    COMPACT_GATHER_WORK,
    WAVEFRONT_ATOM_WORK,
    WAVEFRONT_PUSH_ATOM_WORK,
    ImbalanceStats,
    block_cost_terms,
    choose_schedule,
    estimate_compact_capacity,
    estimate_direction_threshold,
    landscape,
    modeled_advance_cost,
    modeled_block_cost,
    modeled_cost,
)
from repro_torch.core.dynamic import (
    adaptive_inspection_count,
    adaptive_partition,
    assign_chunks,
    chunked_partition,
    clear_adaptive_cache,
)
from repro_torch.core.autotune import (
    Plan,
    REGISTERED_PLANS,
    REGISTERED_SCHEDULES,
    WORKLOAD_ATOM_WORK,
    score_plans,
    score_schedules,
    select_plan,
    select_schedule,
)
from repro_torch.core import segops

__all__ = [
    "WorkSpec", "validate_workspec", "Partition", "Schedule",
    "make_partition", "merge_path_partition", "nonzero_split_partition",
    "tile_mapped_partition", "group_mapped_partition", "invert_block_map",
    "partition_build_count",
    "chunked_partition", "adaptive_partition", "assign_chunks",
    "adaptive_inspection_count", "clear_adaptive_cache",
    "tile_reduce", "blocked_tile_reduce", "execute_tile_reduce",
    "native_chunk_tile_reduce", "ExecutionPath", "choose_execution_path",
    "resolve_execution_path", "supports_native_execution",
    "COMBINER_IDENTITY",
    "blocked_value_windows", "native_chunk_value_windows",
    "scatter_value_windows", "execute_scatter_reduce",
    "blocked_compact_value_windows", "native_compact_value_windows",
    "scatter_compact_windows", "compact_active_atoms", "compact_chunk_starts",
    "ImbalanceStats", "ADVANCE_ATOM_WORK", "ADVANCE_PUSH_ATOM_WORK",
    "ADVANCE_DELTA_ATOM_WORK", "ADVANCE_DELTA_PUSH_ATOM_WORK",
    "COMPACT_GATHER_WORK", "WAVEFRONT_ATOM_WORK", "WAVEFRONT_PUSH_ATOM_WORK",
    "estimate_compact_capacity",
    "modeled_advance_cost", "block_cost_terms",
    "estimate_direction_threshold",
    "choose_schedule", "landscape", "modeled_block_cost", "modeled_cost",
    "Plan", "REGISTERED_PLANS", "REGISTERED_SCHEDULES",
    "WORKLOAD_ATOM_WORK", "score_plans", "score_schedules", "select_plan",
    "select_schedule",
    "segops",
]
