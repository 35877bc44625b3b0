"""TreeLSTM-lite: recursive tree evaluation as wavefront-scheduled GEMMs.

Each node waits for its children, then runs a small dense cell; that
recursion is the workload :mod:`repro_torch.sparse.wavefront` schedules:
children point at their parent in the dependency CSR, every tree level is
a frontier, and the whole forest's cells at one level run as ONE balanced
segmented matmul grouped by operator.  A gated-combine cell, as in the
reference:

    h[v] = tanh((x[v] + sum of h[children]) @ W[op[v]] + b[op[v]])

Ops distinguish node types (leaf token vs internal composition); widths
stay square so composition feeds back through the same combine.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.sparse.wavefront import (WavefrontPlan, build_wavefront,
                                          pack_forest, wavefront_eval)


def init_treelstm(generator: torch.Generator, feat: int, num_ops: int = 2,
                  *, device=None) -> dict:
    """Per-op square weight stack + bias drawn from ``generator``, scaled
    for tanh stability; ``device=None`` means the card."""
    dev = resolve_device(device)
    scale = 1.0 / np.sqrt(feat)
    draw = lambda shape: torch.randn(shape, generator=generator,
                                     device=generator.device).to(dev)
    return {"w": draw((num_ops, feat, feat)) * scale,
            "b": draw((num_ops, feat)) * 0.1}


def treelstm_embed(params: dict, wplan: WavefrontPlan, x, op_of_node, *,
                   activation="tanh") -> torch.Tensor:
    """Every node's embedding, children before parents, level-batched
    (:func:`~repro_torch.sparse.wavefront.wavefront_eval` on the plan's
    schedule); ``activation`` is swappable so tests can pin an exact one."""
    return wavefront_eval(wplan, x, op_of_node, params["w"],
                          bias=params["b"], activation=activation)


def tree_roots(wplan: WavefrontPlan) -> np.ndarray:
    """Node ids with no outgoing dependency edge — each tree's root for
    child -> parent trees (host-side)."""
    out_deg = wplan.plan.out_degrees.cpu().numpy()
    return np.flatnonzero(out_deg == 0)


def treelstm_forest(params: dict, trees: Sequence, x, op_of_node, *,
                    schedule="auto", num_rows: Optional[int] = None,
                    activation="tanh"):
    """Embed a ragged forest in one wavefront: pack, inspect, evaluate.

    ``x``/``op_of_node`` are concatenated over the forest in
    :func:`~repro_torch.sparse.wavefront.pack_forest`'s node order.
    Returns ``(root_embeddings [T, F], packed)``.
    """
    packed = pack_forest(trees, num_rows=num_rows)
    wplan = build_wavefront(packed.dag, schedule=schedule)
    h = treelstm_embed(params, wplan, x, op_of_node, activation=activation)
    roots = tree_roots(wplan)
    if roots.size != packed.num_trees:
        raise ValueError(
            f"forest has {roots.size} dependency sinks for "
            f"{packed.num_trees} trees; treelstm_forest expects "
            f"child->parent trees (exactly one root each)")
    return h[torch.as_tensor(roots, device=h.device)], packed
