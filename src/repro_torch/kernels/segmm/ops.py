"""Public wrapper: unsorted routed tokens in, expert outputs out.

The "work definition" stage for the MoE workload: atoms = routed tokens,
tiles = experts.  :func:`segmm_operands` builds the sorted, group-padded
layout and the block -> expert map (the schedule) plus the queue view of
the chosen policy, and the balanced GEMM kernels of
:mod:`repro_torch.kernels.segmm.kernel` run on it.  The padded capacity is
the worst case ``T + E * (bm - 1)`` rounded up to ``bm``, as in the
reference.

Schedule policies: ``"group_mapped"`` keeps expert order; ``"chunked_rr"``
deals M-blocks round-robin across :data:`NUM_QUEUES` physical queues;
``"chunked_lpt"`` deals them heaviest-expert-first (greedy LPT).  All
policies give the same bits (the kernels compute every output element as
one ascending-k FMA chain), which is the paper's schedule/execution
separation.

Execution paths: ``"native"`` (and ``"auto"``) walk the chunked policies'
queues inside the chunk-walking kernel (K6) with no permutation; ``"pure"``
realises the queue as a block permutation of the operand feeding the
one-block-per-CTA kernel (K5), as the reference's fallback does.
``group_mapped`` always runs K5.  The reference's measured autotuning
(``measure=``) is not ported: ``"auto"`` is model-only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.execute import ExecutionPath, resolve_execution_path
from repro_torch.kernels.segmm import kernel as _kernel

SCHEDULE_POLICIES = ("group_mapped", "chunked_rr", "chunked_lpt")

#: Physical-block pool the chunked policies drain their M-block queues with.
NUM_QUEUES = 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_schedule(expert_of_token: torch.Tensor, num_experts: int,
                     num_blocks: int = 64) -> str:
    """Map the autotuner's model-only choice onto a segmm block-order
    policy (inspects the concrete routing: one host read)."""
    from repro_torch.core.autotune import select_schedule
    from repro_torch.core.schedules import Schedule
    from repro_torch.core.work import WorkSpec

    counts = torch.bincount(expert_of_token.long(),
                            minlength=num_experts)[:num_experts]
    spec = WorkSpec.from_segment_sizes(counts, num_atoms=int(counts.sum()))
    chosen = select_schedule(spec, num_blocks)
    return "chunked_lpt" if chosen == Schedule.CHUNKED else "group_mapped"


def plan_policy(plan) -> tuple[str, str]:
    """(schedule policy, path) a core (schedule, path) plan maps onto for
    segmm: only the chunked schedule has a native queue discipline here;
    every other core schedule runs as the group-mapped baseline."""
    policy = ("chunked_lpt" if str(plan.schedule) == "chunked"
              else "group_mapped")
    path = "native" if (policy != "group_mapped"
                        and str(plan.path) == "native") else "pure"
    return policy, path


@dataclasses.dataclass(frozen=True)
class SegmmOperands:
    """What the kernels are fed for one grouped matmul.

    ``lhs``/``block_expert`` are the kernel operands: the sorted,
    group-padded tokens and their M-block -> expert map, with the blocks in
    execution order on the pure path (a permutation of the padded order).
    ``queue`` is ``(block_chunks_flat, chunk_counts, max_chunks)`` on the
    native path of a chunked policy, else ``None``.  ``rows`` is the
    kernel-output row that holds each token's result.
    """

    lhs: torch.Tensor                 # [M_pad, K], tokens' dtype
    block_expert: torch.Tensor        # int32 [M_pad // bm]
    queue: Optional[tuple]            # (int32 [P*cmax], int32 [P], cmax)
    rows: torch.Tensor                # int64 [T]
    bm: int

    @property
    def num_blocks(self) -> int:
        return int(self.block_expert.shape[0])


def segmm_operands(tokens: torch.Tensor, expert_of_token: torch.Tensor, *,
                   num_experts: int, bm: int, schedule: str,
                   path: str) -> SegmmOperands:
    """Sort atoms by expert, pad each group to whole M-blocks, map blocks
    to experts, and lay out the policy's pop order (``path`` is a
    concrete ``"native"``/``"pure"``).  Stable sorts throughout, as
    ``jnp.argsort``."""
    if schedule not in SCHEDULE_POLICIES:
        raise ValueError(f"unknown segmm schedule: {schedule}")
    device = tokens.device
    t_dim, k_dim = tokens.shape
    e_dim = num_experts
    m_pad = _round_up(t_dim + e_dim * (bm - 1), bm)
    nblk = m_pad // bm
    eot = expert_of_token.long()

    # --- schedule construction (group-mapped prefix-sum binning) ----------
    order = torch.argsort(eot, stable=True)
    sorted_e = eot[order]
    sizes = torch.bincount(eot, minlength=e_dim)[:e_dim]
    zero = sizes.new_zeros(1)
    offsets = torch.cat([zero, torch.cumsum(sizes, 0)])
    padded_offsets = torch.cat(
        [zero, torch.cumsum((sizes + bm - 1) // bm * bm, 0)])
    rank = torch.arange(t_dim, device=device) - offsets[sorted_e]
    pos_sorted = padded_offsets[sorted_e] + rank
    lhs_padded = tokens.new_zeros((m_pad, k_dim))
    lhs_padded[pos_sorted] = tokens[order]
    block_start = torch.arange(nblk, device=device) * bm
    block_expert = (torch.searchsorted(padded_offsets, block_start,
                                       right=True) - 1).clamp(0, e_dim - 1)

    # --- queue discipline: M-block pop order -------------------------------
    blocks = torch.arange(nblk, device=device)
    if schedule == "chunked_lpt":
        pop_order = torch.argsort(-sizes[block_expert], stable=True)
    else:
        pop_order = blocks
    pos_orig = torch.empty_like(pos_sorted)
    pos_orig[order] = pos_sorted

    if path == "native" and schedule != "group_mapped":
        # deal the pop order round-robin onto the physical pool; queue p
        # walks its M-blocks inside the kernel
        phys = min(NUM_QUEUES, nblk)
        cmax = -(-nblk // phys)
        slot = (torch.arange(phys, device=device)[:, None]
                + torch.arange(cmax, device=device)[None, :] * phys)
        counts = (slot < nblk).sum(1).to(torch.int32)
        chunks = pop_order[slot.clamp(max=nblk - 1).reshape(-1)]
        return SegmmOperands(
            lhs=lhs_padded, block_expert=block_expert.to(torch.int32),
            queue=(chunks.to(torch.int32), counts, cmax), rows=pos_orig,
            bm=bm)
    # pure: realise the queue as a block permutation of the operand
    if schedule == "chunked_rr":
        perm = torch.argsort(blocks % min(NUM_QUEUES, nblk), stable=True)
    else:
        perm = pop_order
    if schedule == "group_mapped":
        lhs_exec, be_exec, rows = lhs_padded, block_expert, pos_orig
    else:
        lhs_exec = lhs_padded.view(nblk, bm, k_dim)[perm].view(m_pad, k_dim)
        be_exec = block_expert[perm]
        inv = torch.empty_like(perm)
        inv[perm] = blocks
        rows = inv[pos_orig // bm] * bm + pos_orig % bm
    return SegmmOperands(lhs=lhs_exec, block_expert=be_exec.to(torch.int32),
                         queue=None, rows=rows, bm=bm)


def run_segmm(ops: SegmmOperands, rhs: torch.Tensor, *, bn: int,
              bk: int) -> torch.Tensor:
    """The kernel output ``[M_pad, N]`` for prepared operands."""
    if ops.queue is not None:
        chunks, counts, cmax = ops.queue
        return _kernel.segmented_matmul_chunked(
            ops.lhs, rhs, ops.block_expert, chunks, counts, bm=ops.bm,
            bn=bn, bk=bk, max_chunks=cmax)
    return _kernel.segmented_matmul(ops.lhs, rhs, ops.block_expert,
                                    bm=ops.bm, bn=bn, bk=bk)


def _grouped_matmul(tokens: torch.Tensor, expert_of_token: torch.Tensor,
                    rhs: torch.Tensor, *, num_experts: int, bm: int,
                    bn: int, bk: int, schedule: str,
                    path: str) -> torch.Tensor:
    ops = segmm_operands(tokens, expert_of_token, num_experts=num_experts,
                         bm=bm, schedule=schedule, path=path)
    return run_segmm(ops, rhs.contiguous(), bn=bn, bk=bk)[ops.rows]


def level_grouped_matmul(tokens: torch.Tensor, op_of_token: torch.Tensor,
                         rhs: torch.Tensor, *, num_ops: int, plan=None,
                         schedule: Optional[str] = None,
                         path: Optional[str] = None, bm: int = 8,
                         bn: int = 128, bk: int = 512) -> torch.Tensor:
    """Per-level dense evaluation entry of the wavefront scheduler: the
    level's nodes as tokens, operator types as experts.  ``plan`` (a core
    (schedule, path) object such as an ``AdvancePlan``) maps onto the
    segmm policies through :func:`plan_policy`; explicit ``schedule``/
    ``path`` override it.  Every output row depends only on its own token
    row, so the result is bitwise the same across policies and paths."""
    if plan is not None:
        p_sched, p_path = plan_policy(plan)
        schedule = schedule or p_sched
        path = path or p_path
    return _grouped_matmul(tokens, op_of_token, rhs, num_experts=num_ops,
                           bm=bm, bn=bn, bk=bk,
                           schedule=schedule or "group_mapped",
                           path=path or "pure")


def grouped_matmul(tokens: torch.Tensor, expert_of_token: torch.Tensor,
                   rhs: torch.Tensor, *, num_experts: int, bm: int = 128,
                   bn: int = 128, bk: int = 512,
                   schedule: str = "group_mapped",
                   execution_path: ExecutionPath | str = ExecutionPath.AUTO
                   ) -> torch.Tensor:
    """``out[t] = tokens[t] @ rhs[expert_of_token[t]]`` for ragged groups.

    ``tokens``: ``[T, K]`` f32/bf16; ``expert_of_token``: int ``[T]`` in
    ``[0, num_experts)``; ``rhs``: ``[num_experts, K, N]``.  Returns f32
    ``[T, N]``.  ``schedule``: one of :data:`SCHEDULE_POLICIES` or
    ``"auto"`` (model-only); ``execution_path``: native chunk-walking
    kernel vs permuted-block fallback for the chunked policies.
    """
    if schedule == "auto":
        schedule = resolve_schedule(expert_of_token, num_experts)
    path = resolve_execution_path(execution_path, native_supported=True)
    return _grouped_matmul(tokens, expert_of_token, rhs,
                           num_experts=num_experts, bm=bm, bn=bn, bk=bk,
                           schedule=schedule, path=str(path))
