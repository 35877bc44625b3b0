"""Plain power-iteration PageRank over a CSR, and the comparison that
decides a PageRank cell's ``correct``.

It follows the port's definition (``sparse/graph.py::pagerank``): each
vertex's rank is split evenly over its out-edges, dangling vertices'
rank is spread uniformly, and

    new[v] = (1 - damping) / V + damping * (sum_{u -> v} share[u] + dangling / V)

The reference adds in float64.  :func:`pagerank_tf32` is the control: the
same iteration in float32 with the shares rounded to TF32 (10 mantissa
bits) before the sum, as a TF32 tensor-core SpMV of the 0/1 adjacency
would take them.  Plain PyTorch only: nothing of the port is imported.
"""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to the nearest TF32 value (ties to even):
    the 13 low mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def pagerank(row_offsets: torch.Tensor, col_indices: torch.Tensor, *,
             damping: float, num_iters: int, dtype=torch.float64,
             share_round=None) -> torch.Tensor:
    """Ranks ``[V]`` in ``dtype`` after ``num_iters`` iterations."""
    device = row_offsets.device
    V = int(row_offsets.shape[0]) - 1
    offsets = row_offsets.long()
    outdeg = (offsets[1:] - offsets[:-1]).to(dtype)
    src = torch.repeat_interleave(torch.arange(V, device=device),
                                  offsets[1:] - offsets[:-1])
    dst = col_indices.long()
    pr = torch.full((V,), 1.0 / V, dtype=dtype, device=device)
    for _ in range(num_iters):
        share = torch.where(outdeg > 0, pr / outdeg.clamp(min=1), 0.0)
        if share_round is not None:
            share = share_round(share)
        contrib = torch.zeros(V, dtype=dtype, device=device)
        contrib.index_add_(0, dst, share[src])
        dangling = torch.where(outdeg > 0, 0.0, pr).sum()
        pr = (1.0 - damping) / V + damping * (contrib + dangling / V)
    return pr


def pagerank_tf32(row_offsets, col_indices, *, damping: float,
                  num_iters: int) -> torch.Tensor:
    """The control: float32 with TF32 shares."""
    return pagerank(row_offsets, col_indices, damping=damping,
                    num_iters=num_iters, dtype=torch.float32,
                    share_round=round_tf32)


def rank_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest relative gap ``max_v |got[v] - want[v]| / want[v]``
    (every reference rank is at least ``(1 - damping) / V``); ``inf``
    for a wrong shape or a rank that is not finite."""
    if got.shape != want.shape:
        return float("inf")
    got = got.to(torch.float64)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(((got - want).abs() / want).max())
