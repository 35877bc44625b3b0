"""Pipeline parallelism over the ``pod`` axis (GPipe schedule), the
reference's ``train/pipeline.py``.

The layer stack runs as P stages, one a ``pod`` coordinate: activations
stream stage to stage over point-to-point sends, and only microbatch
activations (never weights or gradients) cross stages.

Schedule: classic GPipe.  ``T = num_micro + P - 1`` ticks; at tick ``t``
stage ``s`` runs ``stage_fn`` on microbatch ``t - s`` (stage 0 reads
``xs[clip(t)]``, the others the activation they received; bubble ticks
compute masked garbage, the utilisation cost ``(P-1)/T``).  After each tick
but the last, stage ``s`` sends its output to ``s + 1``
(:class:`_Hop`, the reference's ``ppermute``); the hop's backward sends
the gradient from ``s + 1`` back to ``s`` (the ``ppermute`` transpose), so
``.backward()`` through :func:`make_pipeline_apply`'s ``apply`` is
pipeline-parallel training with no hand-written backward schedule.

SPMD over ``torch.distributed``, as the reference's ``shard_map``: every
rank of the mesh calls ``apply`` with the same ``xs`` and holds only its
own stage's parameters (``P('pod')`` on the stacked stage dimension:
leaves ``[1, L/P, ...]``, cut by ``NamedSharding(mesh, ("pod",))`` from
:func:`split_stages`' ``[P, L/P, ...]``).  Ranks that share a ``pod``
coordinate but not a ``data`` one run the same pipeline on their own
``pod`` sub-group.

Two things keep the ranks in step.  Each hop posts its send and its
receive together and then waits (:meth:`GraphMesh.shift`), in the forward
and in the backward, so neighbours cannot deadlock.  And every rank's
autograd graph reaches every hop it took part in: :class:`_Last`, which
broadcasts the last stage's outputs to every rank, takes each rank's tick
outputs and hop outputs as inputs.  So the backward walks all of a rank's
hops in reverse tick order, whatever the rank, and stage 0 (whose hops'
outputs it never reads) still receives its outputs' gradients.  The
gradient of ``apply``'s result enters on the last stage alone: every rank
computes the same loss from the same result, and it counts once.  A
``stage_fn`` that checkpoints its layers keeps the hops outside the
recomputed region (they are not in ``stage_fn``).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from repro_torch.models.lm import tree_leaves, tree_map

AXIS = "pod"

__all__ = ["AXIS", "block_stage_fn", "make_pipeline_apply", "reference_apply",
           "split_stages"]


def split_stages(layer_params, num_stages: int):
    """Reshape stacked layer params ``[L, ...]`` -> ``[P, L//P, ...]``."""
    def r(x):
        n = x.shape[0]
        assert n % num_stages == 0, (n, num_stages)
        return x.reshape((num_stages, n // num_stages) + tuple(x.shape[1:]))
    return tree_map(r, layer_params)


class _Hop(torch.autograd.Function):
    """Stage ``s`` sends ``y`` to ``s + 1`` and returns what ``s - 1`` sent
    (zeros on stage 0); the backward sends the gradient of the received
    activation back to ``s - 1`` and returns what ``s + 1`` sent back."""

    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis = axis
        return axis.shift(y, 1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return ctx.axis.shift(g, -1), None


class _Last(torch.autograd.Function):
    """The last stage's valid outputs ``[num_micro, mb, ...]`` on every
    rank of the axis.  Inputs: the rank's tick outputs, then its hops'
    outputs (only so that the backward reaches every hop).  The gradient
    goes to the last stage's valid tick outputs; every other tick output
    gets zeros, so that each tick's backward runs on every stage, bubble
    ticks included, as the transpose of the reference's scan does."""

    @staticmethod
    def forward(ctx, axis, num_micro, *tensors):
        ticks = num_micro + axis.num_shards - 1
        ctx.axis, ctx.num_micro = axis, num_micro
        ctx.n_ys, ctx.n_in = ticks, len(tensors)
        last = axis.num_shards - 1
        y = tensors[last]
        if axis.rank == last:
            out = torch.stack(tensors[last:last + num_micro])
        else:   # only the shape and type count: the broadcast fills it
            out = y.new_empty((num_micro,) + tuple(y.shape))
        return axis.broadcast(out, last)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        axis, num_micro = ctx.axis, ctx.num_micro
        last = axis.num_shards - 1
        zero = torch.zeros_like(g[0])
        grads = [zero] * ctx.n_ys + [None] * (ctx.n_in - ctx.n_ys)
        if axis.rank == last:
            for i in range(num_micro):
                grads[last + i] = g[i]
        return (None, None, *grads)


def block_stage_fn(cfg, seq_len: int):
    """A ``stage_fn`` of decoder blocks: ``stage_fn(p, x)`` runs the layers
    of ``p`` (leaves ``[L/P, ...]``, ``params["layers"]``'s structure) over
    ``x`` ``[mb, seq_len, d_model]`` at positions ``0 .. seq_len - 1``,
    each layer ``models.lm._block`` (its MoE aux loss dropped), under
    non-reentrant checkpoint with ``cfg.remat`` while autograd records.
    The weights are cast to ``x``'s type at use (float32 masters, bf16
    compute)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.lm import _block

    def layer(p, x, positions):
        return _block(cfg, p, x, positions, with_state=False)[0]

    def stage_fn(p, x):
        positions = torch.arange(seq_len, dtype=torch.int32,
                                 device=x.device)[None].expand(
                                     x.shape[0], seq_len)
        n = next(leaf for _, leaf in tree_leaves(p)).shape[0]
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(n):
            pi = tree_map(lambda a: a[i], p)
            if remat:
                x = checkpoint(layer, pi, x, positions, use_reentrant=False)
            else:
                x = layer(pi, x, positions)
        return x

    return stage_fn


def make_pipeline_apply(stage_fn: Callable, mesh, num_stages: int,
                        num_micro: int):
    """Build ``apply(stage_params, xs) -> ys``.

    ``stage_fn(params_stage, x) -> y`` applies one stage's layers to one
    microbatch activation ``[mb, ...]`` (same shape and type in and out).
    ``mesh`` is an :class:`~repro_torch.launch.mesh.LMMesh` whose ``pod``
    axis has ``num_stages`` ranks.  ``stage_params``: this rank's stage,
    leaves ``[1, L/P, ...]``; ``xs``: ``[num_micro, mb, ...]``, the same on
    every rank.  Returns the last stage's ``[num_micro, mb, ...]`` on
    every rank.
    """
    assert num_micro >= 1 and num_stages >= 1
    axis = mesh.axis(AXIS)
    if axis.num_shards != num_stages:
        raise ValueError(f"the mesh's {AXIS!r} axis has {axis.num_shards} "
                         f"ranks for {num_stages} stages")
    ticks = num_micro + num_stages - 1
    stage = axis.rank

    def apply(stage_params, xs):
        local = tree_map(lambda p: p[0], stage_params)
        act = torch.zeros_like(xs[0])
        ys, acts = [], []
        for t in range(ticks):
            x_t = xs[min(max(t, 0), num_micro - 1)] if stage == 0 else act
            y = stage_fn(local, x_t)
            ys.append(y)
            if t + 1 < ticks and num_stages > 1:
                act = _Hop.apply(y, axis)
                acts.append(act)
        if num_stages == 1:
            return torch.stack(ys)
        return _Last.apply(axis, num_micro, *ys, *acts)

    return apply


def reference_apply(stage_fn, stage_params, xs, num_stages: int):
    """Sequential oracle: run every stage in order on each microbatch
    (``stage_params`` the whole ``[P, L/P, ...]`` tree, on one device)."""
    outs = []
    for x in xs:
        for s in range(num_stages):
            x = stage_fn(tree_map(lambda a: a[s], stage_params), x)
        outs.append(x)
    return torch.stack(outs)
