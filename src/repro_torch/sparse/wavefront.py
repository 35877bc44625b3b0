"""Topological wavefront scheduling: DAG/tree evaluation as a balanced
frontier workload.

Dependency-ordered computation over trees and DAGs (TreeLSTM-style
recursive evaluation, expression forests, task graphs) is the frontier
abstraction with the roles recast — **tiles = nodes, atoms = dependency
in-edges**.  A wavefront level is a frontier; the per-node work is a dense
segmented GEMM (:func:`repro_torch.kernels.segmm.ops.level_grouped_matmul`)
instead of a scalar relax.

A node enters the ready set when its **in-degree counter** — decremented by
an ordinary ``advance`` over the dependency edges resolved each level —
reaches zero.  Per level of the host loop in :func:`wavefront_eval`:

1. ``ready = (indeg == 0) & ~resolved`` — the current wavefront level;
2. the **dependency combine**: a pull advance (frontier = the resolved set)
   sums each node's already-evaluated predecessor states, one advance per
   feature column (the reference's ``vmap`` over columns, as a loop);
3. the **level GEMM**: every node's combined state hits its operator's
   weight matrix in ONE segmented matmul grouped by operator, committed
   under the ready mask;
4. the **counter decrement**: a unit-valued advance over the out-edges of
   the nodes that just resolved.

The dependency CSR is inspected **once** by the ordinary
:func:`~repro_torch.sparse.advance.build_advance` (``schedule="auto"``
scores the ``workload="wavefront"`` family); acyclicity and the level count
are validated on the host at build time, so the loop needs no cycle guard
and runs exactly ``num_levels`` times with no host read.  Ragged forests
batch through :mod:`repro_torch.data.packing` into one block-diagonal DAG
(:func:`pack_forest`).

Edge orientation: an edge ``u -> v`` means *u must be evaluated before v*
(for trees: children point at their parent).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import ExecutionPath, Schedule
from repro_torch.kernels.segmm.ops import level_grouped_matmul
from repro_torch.sparse.advance import AdvancePlan, advance, build_advance
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.graph import Graph

#: Named activations (strings resolve here; callables pass through).
#: ``relu`` and ``identity`` are exact on every device — the bitwise
#: conformance tests use them (and bounded clips); ``tanh`` is the model's
#: choice and matches other implementations only to a few ULP.
ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "identity": lambda z: z,
}


def _resolve_activation(activation) -> Callable[[torch.Tensor],
                                                torch.Tensor]:
    if callable(activation):
        return activation
    try:
        return ACTIVATIONS[activation]
    except KeyError:
        raise ValueError(
            f"unknown activation: {activation!r} (expected a callable or "
            f"one of {sorted(ACTIVATIONS)})") from None


def topological_levels(row_offsets: np.ndarray, col_indices: np.ndarray,
                       num_nodes: int) -> np.ndarray:
    """Kahn-style level assignment over a dependency CSR (host-side).

    ``level_of[v]`` = length of the longest dependency chain ending at
    ``v`` (sources are level 0).  Raises :class:`ValueError` on cycles.
    """
    row_offsets = np.asarray(row_offsets, np.int64)
    col_indices = np.asarray(col_indices, np.int64)
    indeg = np.zeros(num_nodes, np.int64)
    np.add.at(indeg, col_indices, 1)
    level_of = np.full(num_nodes, -1, np.int32)
    frontier = np.flatnonzero(indeg == 0)
    level = 0
    placed = 0
    while frontier.size:
        level_of[frontier] = level
        placed += frontier.size
        # the out-edges of this level, gathered in CSR order
        starts, ends = row_offsets[frontier], row_offsets[frontier + 1]
        sizes = ends - starts
        within = np.arange(int(sizes.sum())) - np.repeat(
            np.cumsum(sizes) - sizes, sizes)
        nxt = col_indices[np.repeat(starts, sizes) + within]
        np.subtract.at(indeg, nxt, 1)
        # a successor enters the next level when its LAST in-edge resolves
        cand = np.unique(nxt)
        frontier = cand[indeg[cand] == 0]
        level += 1
    if placed != num_nodes:
        stuck = np.flatnonzero(level_of < 0)
        raise ValueError(
            f"dependency graph has a cycle: {stuck.size} of {num_nodes} "
            f"nodes can never become ready (e.g. nodes "
            f"{stuck[:8].tolist()}); wavefront scheduling needs a DAG")
    return level_of


@dataclasses.dataclass(frozen=True)
class WavefrontPlan:
    """One-time inspector product for a dependency DAG: the
    :class:`~repro_torch.sparse.advance.AdvancePlan` pair over the
    dependency CSR (pull view: tiles = nodes, atoms = in-edges) plus the
    host-side Kahn products (level of each node, level count, nodes per
    level)."""

    plan: AdvancePlan
    num_levels: int
    level_of: np.ndarray      # [V] int32 (host)
    level_counts: np.ndarray  # [num_levels] int64 nodes per level

    @property
    def num_nodes(self) -> int:
        return self.plan.num_vertices

    @property
    def num_dependencies(self) -> int:
        return self.plan.num_edges

    def in_degrees(self) -> torch.Tensor:
        """Dependency fan-in per node — the ready counters (the pull
        view's atoms per tile)."""
        return self.plan.spec.atoms_per_tile().to(torch.int32)


def build_wavefront(dag: Graph, *, schedule: Schedule | str = "auto",
                    num_blocks: Optional[int] = None,
                    path: ExecutionPath | str = ExecutionPath.AUTO,
                    workload: str = "wavefront") -> WavefrontPlan:
    """Inspect a dependency DAG into a :class:`WavefrontPlan`: host-side
    Kahn leveling (a cycle raises here) and the dependency CSR's plan
    pair through :func:`~repro_torch.sparse.advance.build_advance`."""
    level_of = topological_levels(dag.csr.row_offsets.cpu().numpy(),
                                  dag.csr.col_indices.cpu().numpy(),
                                  dag.num_vertices)
    num_levels = int(level_of.max()) + 1 if level_of.size else 0
    plan = build_advance(dag, schedule=schedule, num_blocks=num_blocks,
                         path=path, workload=workload)
    counts = (np.bincount(level_of, minlength=max(num_levels, 1))
              if level_of.size else np.zeros(0, np.int64))
    return WavefrontPlan(plan=plan, num_levels=num_levels,
                         level_of=level_of,
                         level_counts=counts[:num_levels].astype(np.int64))


def _validate_ops(op_of_node, num_ops: int, num_nodes: int) -> None:
    """Reject out-of-range operator ids (the level GEMM's block -> op map
    clips, so a bad id would evaluate the wrong operator)."""
    arr = (op_of_node.cpu().numpy() if isinstance(op_of_node, torch.Tensor)
           else np.asarray(op_of_node))
    if arr.shape != (num_nodes,):
        raise ValueError(f"op_of_node must have shape ({num_nodes},), "
                         f"got {arr.shape}")
    if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= num_ops):
        bad = arr[(arr < 0) | (arr >= num_ops)]
        raise ValueError(
            f"op_of_node out of range for {num_ops} operators: "
            f"{bad.reshape(-1)[:8].tolist()} (valid range "
            f"[0, {num_ops - 1}])")


def _as_tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def wavefront_eval(wplan: WavefrontPlan, x, op_of_node, weights, *,
                   bias=None, activation="relu", bm: int = 8,
                   bn: int = 128, bk: int = 512,
                   segmm_schedule: Optional[str] = None,
                   segmm_path: Optional[str] = None,
                   return_levels: bool = False):
    """Evaluate every node of the DAG in dependency order, level by level.

    Per node ``v`` with operator ``o = op_of_node[v]``::

        h[v] = act((x[v] + sum of h[u] over dependency edges u -> v)
                   @ weights[o] + bias[o])

    ``x``: ``[V, K]``; ``weights``: ``[O, K, K]`` (square: outputs feed back
    through the combine); ``bias``: optional ``[O, K]``; ``activation``: a
    name from :data:`ACTIVATIONS` or a callable.  Returns ``[V, K]`` f32 on
    the plan's device (and the level count run, ``wplan.num_levels``, when
    ``return_levels``).  The combine rides the plan's (schedule, path); the
    level GEMM maps the same plan onto the segmm policies (override with
    ``segmm_schedule``/``segmm_path``).  With integer-valued f32 data and
    an exact activation the result is bitwise the same on every schedule
    and path, and equal to the sequential per-node evaluation.
    """
    plan = wplan.plan
    V = plan.num_vertices
    device = plan.src.device
    x = _as_tensor(x, device, torch.float32)
    weights = _as_tensor(weights, device, torch.float32)
    if x.dim() != 2 or x.shape[0] != V:
        raise ValueError(f"x must be [num_nodes={V}, K], got "
                         f"{tuple(x.shape)}")
    if weights.dim() != 3 or weights.shape[1] != weights.shape[2]:
        raise ValueError(
            f"weights must be [num_ops, K, K] (square per-op matrices: "
            f"node outputs feed back through the combine), got "
            f"{tuple(weights.shape)}")
    K = x.shape[1]
    num_ops = weights.shape[0]
    if weights.shape[1] != K:
        raise ValueError(f"weights feature width {weights.shape[1]} != "
                         f"input width {K}")
    if bias is not None:
        bias = _as_tensor(bias, device, torch.float32)
        if tuple(bias.shape) != (num_ops, K):
            raise ValueError(f"bias must be [num_ops={num_ops}, K={K}], "
                             f"got {tuple(bias.shape)}")
    _validate_ops(op_of_node, num_ops, V)
    op_of_node = _as_tensor(op_of_node, device, torch.int32)
    act = _resolve_activation(activation)
    h = torch.zeros((V, K), dtype=torch.float32, device=device)
    if V == 0:
        return (h, 0) if return_levels else h

    src = plan.src
    unit = lambda e: torch.ones(e.shape, dtype=torch.float32,
                                device=e.device)
    node_bias = None if bias is None else bias[op_of_node.long()]

    def combine(h, resolved):
        # one balanced advance per feature column (the reference's vmap)
        cols = h.t().contiguous()
        return torch.stack(
            [advance(plan, resolved, lambda e, col=col: col[src[e]],
                     combiner="sum") for col in cols], dim=1)

    indeg = wplan.in_degrees()
    resolved = torch.zeros(V, dtype=torch.bool, device=device)
    # Kahn levels are non-empty up to num_levels, so the reference's
    # all-resolved test first holds after exactly num_levels iterations
    for _ in range(wplan.num_levels):
        ready = (indeg == 0) & ~resolved
        combined = x + combine(h, resolved)
        z = level_grouped_matmul(combined, op_of_node, weights,
                                 num_ops=num_ops, plan=plan,
                                 schedule=segmm_schedule, path=segmm_path,
                                 bm=bm, bn=bn, bk=bk)
        if node_bias is not None:
            z = z + node_bias
        # each output row depends only on its own combined row: the masked
        # commit keeps non-ready rows' discarded work out of the result
        h = torch.where(ready[:, None], act(z), h)
        resolved = resolved | ready
        dec = advance(plan, ready, unit, combiner="sum")
        indeg = indeg - dec.to(torch.int32)
    return (h, wplan.num_levels) if return_levels else h


# ---------------------------------------------------------------------------
# Ragged-forest batching (data/packing.py applied to trees).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedForest:
    """A ragged forest packed into one block-diagonal dependency DAG.

    ``dag`` unions every tree (node ids offset by ``node_offsets``), so
    level ``l`` holds the level-``l`` nodes of every tree.  ``row_*`` are
    the balanced batch-row boundaries from
    :func:`repro_torch.data.packing.pack_documents` (atoms = nodes, tiles =
    trees, processors = rows).
    """

    dag: Graph
    node_offsets: np.ndarray       # [T+1] node id base of each tree
    row_node_starts: torch.Tensor  # [R+1] balanced node split across rows
    row_tree_starts: torch.Tensor  # [R+1] tree split across rows
    num_rows: int

    @property
    def num_trees(self) -> int:
        return len(self.node_offsets) - 1

    def tree_slice(self, t: int) -> slice:
        """Node-id range of tree ``t`` inside the packed DAG."""
        return slice(int(self.node_offsets[t]), int(self.node_offsets[t + 1]))


def pack_forest(trees: Sequence[Union[Graph, CSR]],
                num_rows: Optional[int] = None) -> PackedForest:
    """Batch a ragged forest of dependency DAGs into one DAG on the trees'
    device (the first tree's).  The row split is
    :func:`~repro_torch.data.packing.pack_documents`'s, whose guards reject
    zero-node trees; an empty forest raises here."""
    from repro_torch.data.packing import pack_documents
    trees = list(trees)
    if not trees:
        raise ValueError("pack_forest needs at least one tree "
                         "(got an empty forest)")
    csrs = [t.csr if isinstance(t, Graph) else t for t in trees]
    device = csrs[0].device
    counts = np.asarray([c.shape[0] for c in csrs], np.int64)
    if num_rows is None:
        num_rows = min(len(trees), 8)
    node_starts, tree_starts = pack_documents(
        torch.as_tensor(counts, dtype=torch.int32, device=device), num_rows)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    row_offsets = [torch.zeros(1, dtype=torch.int64, device=device)]
    cols, vals = [], []
    edge_base = 0
    for t, c in enumerate(csrs):
        row_offsets.append(c.row_offsets[1:].to(device, torch.int64)
                           + edge_base)
        cols.append(c.col_indices.to(device, torch.int64) + int(offsets[t]))
        vals.append(c.values.to(device, torch.float32))
        edge_base += c.nnz
    total = int(offsets[-1])
    dag = Graph(CSR(torch.cat(row_offsets).to(torch.int32),
                    torch.cat(cols).to(torch.int32), torch.cat(vals),
                    (total, total), edge_base))
    return PackedForest(dag=dag, node_offsets=offsets.astype(np.int64),
                        row_node_starts=node_starts,
                        row_tree_starts=tree_starts, num_rows=int(num_rows))
