"""The train step: microbatch accumulation, remat, AdamW (the reference's
``train/step.py`` on one device).

``make_train_step`` builds ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``:

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
* **update**: :func:`optimizer.adamw_update`, in place.

The reference also shards parameters and optimizer state over a mesh
(``param_specs``/``shardings_for``); here a mesh of more than one device
raises ``NotImplementedError`` until the LM's sharding is ported.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.models.lm import init_params, lm_loss, tree_leaves, tree_map
from repro_torch.train.optimizer import OptConfig, adamw_update

METRIC_KEYS = ("loss", "ntokens", "grad_norm", "lr")


def param_specs(cfg):
    """The partition-spec tree of ``cfg``'s parameters (from the reduced
    structural twin on the ``meta`` device: specs depend only on the
    tree's structure)."""
    _, specs = init_params(cfg.reduced(), torch.Generator(), device="meta")
    return specs


def check_mesh(mesh) -> None:
    """Accept no mesh or a one-shard one (``launch.mesh.GraphMesh``);
    raise for more devices."""
    if mesh is None:
        return
    size = mesh.num_shards
    if size != 1:
        raise NotImplementedError(
            f"training over a mesh of {size} devices needs the LM's "
            f"sharding (param_specs/shardings_for, ROADMAP queue 1 item 4, "
            f"its sharding half), which is not ported; pass mesh=None")


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
    totals."""
    check_mesh(mesh)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    leaves = _trainable(params, grads)
    n = max(int(num_microbatches), 1)
    acc = None
    if n > 1 and cfg.grad_accum_bf16:
        acc = tree_map(lambda g: torch.zeros_like(g, dtype=torch.bfloat16),
                       grads)
    if n == 1:
        total, metrics = lm_loss(leaves, cfg, batch, dtype=dtype)
        total.backward()
        return (total.detach(), {"loss": metrics["loss"].detach(),
                                 "ntokens": metrics["ntokens"].detach()},
                grads)
    # as the reference: the microbatches' totals (aux included) averaged
    total_sum = ntok = 0.0
    for mb in _microbatches(batch, n):
        total, metrics = lm_loss(leaves, cfg, mb, dtype=dtype)
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
    maps the accumulated gradients before the optimizer."""
    check_mesh(mesh)

    def step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(params, cfg, batch,
                                              num_microbatches, dtype)
        if grad_compress is not None:
            grads = grad_compress(grads)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return step
