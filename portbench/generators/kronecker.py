"""Graph500's Kronecker graph, built on the device from a seed.

Every edge tuple descends ``scale`` levels of the 2 x 2 initiator
``[[a, b], [c, d]]`` (graph500.org's specification; the GAP Benchmark
Suite's ``kron``): at each level one uniform draw picks a quadrant, whose
row bit goes to the source and column bit to the destination.  Vertex ids
are then permuted from the seed.  As GAP's builder does, the edge list is
symmetrized and self-loops and duplicates are removed; the CSR's rows are
sorted by destination.  A uniform initiator (all four 0.25) gives GAP's
``urand`` graph from the same code.

The configuration's ``graph_seed`` draws one graph, as GAP draws its
graphs from one fixed seed, and the run's seed relabels it: every
vertex goes to a vertex of the same degree drawn from the seed.  So each
seed gives the same row offsets (the same sizes, hence the same advance
plan) with the columns in another order.

Everything runs on ``device`` in a few large calls, each draw from a
``torch.Generator`` of its own seed, so the same seed gives the same graph.
"""
from __future__ import annotations

import torch


def make(config: dict, seed: int, device) -> dict:
    """``{"row_offsets": int32 [V + 1], "col_indices": int32 [E],
    "num_vertices": V, "num_edges": E, "edge_tuples": n}`` of the graph
    that ``config`` (``scale``, ``edge_factor``, ``initiator``,
    ``graph_seed``) names, relabelled by ``seed``."""
    return relabel(draw(config, int(config["graph_seed"]), device), seed,
                   device)


def draw(config: dict, seed: int, device) -> dict:
    """The Kronecker graph drawn from ``seed``, as :func:`make` returns it."""
    scale = int(config["scale"])
    a, b, c, d = (float(p) for p in config["initiator"])
    if abs(a + b + c + d - 1.0) > 1e-9:
        raise ValueError(f"initiator {config['initiator']} does not sum to 1")
    if not 1 <= scale <= 30:
        raise ValueError(f"scale {scale} outside [1, 30] (int32 vertex ids)")
    V = 1 << scale
    n = int(config["edge_factor"]) * V
    gen = torch.Generator(device=device).manual_seed(int(seed))
    src = torch.zeros(n, dtype=torch.int32, device=device)
    dst = torch.zeros(n, dtype=torch.int32, device=device)
    for _ in range(scale):
        u = torch.rand(n, generator=gen, device=device)
        row = u >= a + b                                  # quadrant c or d
        col = ((u >= a) & (u < a + b)) | (u >= a + b + c)  # quadrant b or d
        src.mul_(2).add_(row)
        dst.mul_(2).add_(col)
        del u, row, col
    perm = torch.randperm(V, generator=gen, device=device,
                          dtype=torch.int64)
    src = perm[src.long()]
    dst = perm[dst.long()]
    del perm
    # symmetrize, drop self-loops, sort by (source, destination), dedupe
    keys = torch.cat([src * V + dst, dst * V + src])
    del src, dst
    keys = keys[keys // V != keys % V]
    keys = torch.unique(keys, sorted=True)
    rows = keys // V
    cols = (keys % V).to(torch.int32)
    del keys
    counts = torch.bincount(rows, minlength=V)
    del rows
    offsets = torch.zeros(V + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return {"row_offsets": offsets.to(torch.int32), "col_indices": cols,
            "num_vertices": V, "num_edges": int(cols.shape[0]),
            "edge_tuples": n}


def relabel(graph: dict, seed: int, device) -> dict:
    """``graph`` with every vertex mapped to a vertex of the same degree,
    drawn from ``seed``: the row offsets stay, the columns move."""
    offsets, cols = graph["row_offsets"], graph["col_indices"]
    V = graph["num_vertices"]
    deg = (offsets[1:] - offsets[:-1]).long()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draws = torch.rand(V, generator=gen, device=device, dtype=torch.float64)
    # the k-th vertex of a degree, by id, goes to the k-th by the draws
    by_id = torch.argsort(deg, stable=True)
    by_draw = torch.argsort(deg.double() + draws, stable=True)
    del draws
    sigma = torch.empty(V, dtype=torch.int64, device=device)
    sigma[by_id] = by_draw
    del by_id, by_draw
    rows = torch.repeat_interleave(sigma, deg)
    keys = rows.mul_(V).add_(sigma[cols.long()])
    del rows, sigma
    keys = torch.sort(keys).values
    return dict(graph, col_indices=(keys % V).to(torch.int32))
