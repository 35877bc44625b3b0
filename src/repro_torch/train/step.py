"""The train step: FSDP x TP sharding, microbatch accumulation, remat,
AdamW (the reference's ``train/step.py``).

``make_train_step`` builds ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``:

* **sharding** (``mesh``, an :class:`~repro_torch.launch.mesh.LMMesh`):
  each rank holds its blocks of the parameters and of the AdamW state, as
  :func:`shardings_for` places them from :func:`param_specs`, and every
  rank calls the step with the same global batch; the step takes this
  rank's rows (:func:`_constrain_batch`, split over ``("pod", "data")``).
  FSDP over ``data`` and tensor parallelism over ``model`` run inside the
  model (:mod:`repro_torch.models.layers`): weight blocks are all-gathered
  right before use and the gathered weights' gradients reduce-scattered.
  After the backward, each leaf's gradient is summed over the batch axes
  it is not cut on (``pod``, and ``data`` for the replicated leaves), so
  every rank holds its block of the whole batch's gradient.  With
  ``mesh=None`` or a one-rank mesh none of this runs;
* **gradients**: the stacked float32 parameter tree stays the state (as
  the reference's, for interop and checkpoints); for autograd each
  top-level leaf, and each layer's slice of a stacked leaf, becomes a
  detached view that requires grad, with a view of one stacked float32
  gradient buffer as its ``.grad``.  Autograd then accumulates each
  layer's gradient in place into its slice, and never builds a zero
  tensor of a whole stack per layer (indexing's backward would: 3.77 GB
  for Danube's ``layers/mlp/w1``, 24 times a backward);
* **microbatching**: ``.backward()`` per microbatch accumulates into the
  buffer (float32, or a bfloat16 accumulator with ``cfg.grad_accum_bf16``,
  as the reference), then the sum is scaled by ``1 / n``;
* **remat**: per-layer checkpoint inside the model (``cfg.remat``);
* **update**: :func:`optimizer.adamw_update`, in place, its gradient norm
  over every rank's blocks.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.launch.mesh import NamedSharding, sharded
from repro_torch.models.lm import (check_moe_mesh, lm_loss, param_specs,
                                   tree_leaves, tree_map)
from repro_torch.train.optimizer import OptConfig, adamw_update

METRIC_KEYS = ("loss", "ntokens", "grad_norm", "lr")

BATCH_AXES = ("pod", "data")  # batch shards over every data-parallel axis


def batch_pspec(mesh) -> tuple:
    """The batch dimension's spec: every batch axis the mesh has."""
    axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    if not axes:
        return ()
    return (axes if len(axes) > 1 else axes[0],)


def _fix(mesh, spec) -> tuple:
    """``spec`` without the axes ``mesh`` lacks, as the reference's
    ``shardings_for`` cleans it (a tuple keeps its remaining axes as a
    tuple)."""
    cleaned = []
    for a in spec:
        if a is None:
            cleaned.append(None)
        elif isinstance(a, tuple):
            keep = tuple(x for x in a if x in mesh.axis_names)
            cleaned.append(keep if keep else None)
        else:
            cleaned.append(a if a in mesh.axis_names else None)
    return tuple(cleaned)


def shardings_for(mesh, specs):
    """Spec tree -> :class:`NamedSharding` tree, dropping axes the mesh
    does not have (so the same specs serve single- and multi-pod
    meshes)."""
    return tree_map(lambda spec: NamedSharding(mesh, _fix(mesh, spec)),
                    specs)


def opt_shardings(mesh, param_sh) -> Dict[str, object]:
    return {"mu": param_sh, "nu": param_sh,
            "step": NamedSharding(mesh, ())}


def shard_tree(tree, shardings):
    """This rank's block of every leaf of a full ``tree``."""
    return tree_map(lambda t, sh: sh.shard(t), tree, shardings)


def gather_tree(tree, shardings):
    """Every leaf whole again (a collective: every rank calls it)."""
    return tree_map(lambda t, sh: sh.gather(t), tree, shardings)


def _constrain_batch(batch: Dict[str, torch.Tensor], mesh):
    """This rank's rows of a (micro)batch: the reference re-pins the batch
    dimension's sharding there (GSPMD loses it after the microbatch
    slice)."""
    if mesh is None:
        return batch
    spec = batch_pspec(mesh)
    if spec == ():
        return batch
    sh = NamedSharding(mesh, spec)
    return {k: sh.shard(v) for k, v in batch.items()}


def _sum_over_batch(grads, cfg, mesh) -> None:
    """Each gradient leaf summed, in place, over the batch axes its spec
    does not cut it on (those it is cut on were summed by the gathers'
    backward)."""
    specs = dict(tree_leaves(param_specs(cfg)))
    for path, g in tree_leaves(grads):
        cut = {a for axes in specs[path] if axes is not None
               for a in ((axes,) if isinstance(axes, str) else axes)}
        axes = tuple(a for a in BATCH_AXES if a not in cut)
        summed = mesh.all_reduce(g, axes)
        if summed is not g:
            g.copy_(summed)


def _trainable(params, grads):
    """The tree :func:`lm_loss` differentiates: detached views of
    ``params`` that require grad, each with its view of ``grads`` as
    ``.grad``; ``layers`` becomes a list of per-layer trees."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    out = {}
    for name, value in params.items():
        if name == "layers":
            n = next(leaf for _, leaf in tree_leaves(value)).shape[0]
            out[name] = [tree_map(lambda p, g: leaf(p[i], g[i]), value,
                                  grads[name]) for i in range(n)]
        elif isinstance(value, dict):
            out[name] = tree_map(leaf, value, grads[name])
        else:
            out[name] = leaf(value, grads[name])
    return out


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"global batch {b} is not a multiple of "
                         f"{n} microbatches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def loss_and_grads(params, cfg, batch, num_microbatches: int,
                   dtype: torch.dtype = torch.bfloat16, mesh=None):
    """``(total, {"loss", "ntokens"}, grads)`` over ``num_microbatches``
    slices of the batch, ``grads`` float32 shaped like ``params`` (the
    mean of the microbatches' gradients).  As the reference: with one
    microbatch ``total`` is :func:`lm_loss`'s total and ``"loss"`` its
    cross-entropy; with more, both are the mean of the microbatches'
    totals.

    On ``mesh`` (see the module's docstring) ``params`` and the returned
    ``grads`` are this rank's blocks, ``batch`` the global batch, and the
    losses and ``"ntokens"`` the whole batch's."""
    mesh = sharded(mesh)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    leaves = _trainable(params, grads)
    n = max(int(num_microbatches), 1)
    acc = None
    if n > 1 and cfg.grad_accum_bf16:
        acc = tree_map(lambda g: torch.zeros_like(g, dtype=torch.bfloat16),
                       grads)
    if n == 1:
        total, metrics = lm_loss(leaves, cfg, _constrain_batch(batch, mesh),
                                 dtype=dtype, mesh=mesh)
        total.backward()
        if mesh is not None:
            _sum_over_batch(grads, cfg, mesh)
        return (total.detach(), {"loss": metrics["loss"].detach(),
                                 "ntokens": metrics["ntokens"].detach()},
                grads)
    # as the reference: the microbatches' totals (aux included) averaged
    total_sum = ntok = 0.0
    for mb in _microbatches(batch, n):
        total, metrics = lm_loss(leaves, cfg, _constrain_batch(mb, mesh),
                                 dtype=dtype, mesh=mesh)
        total.backward()
        total_sum = total_sum + total.detach()
        ntok = ntok + metrics["ntokens"].detach()
        if acc is not None:
            with torch.no_grad():
                for (_, a), (_, g) in zip(tree_leaves(acc),
                                          tree_leaves(grads)):
                    a.add_(g.to(torch.bfloat16))
                    g.zero_()
    with torch.no_grad():
        if acc is not None:
            for (_, g), (_, a) in zip(tree_leaves(grads), tree_leaves(acc)):
                g.copy_(a)
        if mesh is not None:
            _sum_over_batch(grads, cfg, mesh)
        for _, g in tree_leaves(grads):
            g.mul_(1.0 / n)
    loss = total_sum * (1.0 / n)
    return loss, {"loss": loss, "ntokens": ntok}, grads


def make_train_step(cfg, opt_cfg: OptConfig, mesh=None, *,
                    num_microbatches: int = 1,
                    dtype: torch.dtype = torch.bfloat16,
                    grad_compress: Optional[Callable] = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with ``metrics`` keyed by :data:`METRIC_KEYS`.  ``params`` and
    ``opt_state`` are updated in place and returned (the reference donates
    them).  ``grad_compress`` (see :mod:`repro_torch.train.compress`)
    maps the accumulated gradients before the optimizer.

    On a ``mesh`` of more than one rank ``params`` and ``opt_state`` are
    this rank's blocks, placed by :func:`shardings_for` and
    :func:`opt_shardings` (:func:`shard_tree` cuts them from full trees),
    and every rank calls the step with the same global batch.  Where the
    ``model`` axis does not divide the query and KV heads, attention runs
    whole on every rank of it (``layers.heads_split``; the reference's
    GSPMD pads the heads)."""
    param_sh = None
    mesh = sharded(mesh)
    if mesh is not None:
        check_moe_mesh(cfg, mesh)
        param_sh = shardings_for(mesh, param_specs(cfg))

    def step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(params, cfg, batch,
                                              num_microbatches, dtype, mesh)
        if grad_compress is not None:
            grads = grad_compress(grads)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg, shardings=param_sh)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return step
