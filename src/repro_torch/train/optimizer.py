"""AdamW + clipping + LR schedules, the reference's formulas in its order
(``train/optimizer.py``).

The optimizer state is float32 ``{"mu": tree, "nu": tree, "step": int32
scalar}``.  Unlike the reference, :func:`adamw_update` updates the
parameters and ``mu``/``nu`` **in place** and uses the gradients as its
scratch: at 3.96e9 parameters a leaf of 3.77 GB float32 leaves no room for
the reference's new ``g``, ``m``, ``v`` and ``update`` arrays.

On a mesh every rank updates its blocks of the parameters and the state
(the update is elementwise); the gradient norm, and so the clipping, is
the whole tree's (see :func:`global_norm`).  Weight decay keeps to leaves
of two or more dimensions, which a block has as its whole leaf does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.lm import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr``, in float32 as
    the reference computes it; ``step`` an int or a scalar tensor.  A CPU
    scalar tensor."""
    step = np.float32(int(step))
    f32 = np.float32
    warm = f32(cfg.lr) * step / f32(max(cfg.warmup_steps, 1))
    prog = np.clip((step - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = (f32(cfg.min_lr_frac * cfg.lr)
           + f32((1 - cfg.min_lr_frac) * cfg.lr) * f32(0.5)
           * (f32(1) + np.cos(f32(np.pi) * prog, dtype=np.float32)))
    lr = warm if step < cfg.warmup_steps else cos
    return torch.tensor(np.float32(lr))


def init_opt_state(params) -> Dict[str, Any]:
    """Zero float32 ``mu``/``nu`` shaped like ``params`` on their devices,
    and ``step`` 0 (int32, on the first leaf's device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = next(leaf for _, leaf in tree_leaves(params)).device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, shardings=None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, float32, taken one leaf at
    a time without a squared copy (a dot product of the flattened leaf
    with itself).

    ``shardings`` (a tree of ``NamedSharding`` like ``tree``): ``tree``
    holds this rank's blocks; each block's squares count on one rank of
    the ranks that hold the same block (a leaf replicated over an axis
    counts once, not once a rank), and the sum is taken over the whole
    mesh."""
    total = None
    shs = dict(tree_leaves(shardings)) if shardings is not None else None
    for path, g in tree_leaves(tree):
        flat = g.reshape(-1).float()
        sq = torch.dot(flat, flat)
        if shs is not None and not shs[path].primary:
            sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    if shs is not None:
        mesh = next(iter(shs.values())).mesh
        total = mesh.all_reduce(total, mesh.axis_names)
    return torch.sqrt(total)


def adamw_update(params, grads, opt_state, cfg: OptConfig, *,
                 shardings=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping and decoupled weight decay
    on matrices only (``ndim >= 2``): ``(params, opt_state, {"grad_norm",
    "lr"})``, the reported norm taken before clipping.  ``params``,
    ``mu``, ``nu`` are updated in place and returned; ``grads`` (float32
    or not) are overwritten with scratch.  One host read (the clip
    scale).  ``shardings``: the trees are this rank's blocks, placed so
    (see :func:`global_norm`)."""
    step = int(opt_state["step"]) + 1
    gnorm = global_norm(grads, shardings)
    scale = min(1.0, cfg.clip_norm / max(float(gnorm), 1e-9))
    scale = float(np.float32(scale))
    lr_t = lr_at(cfg, step)
    lr = float(lr_t)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))

    flat_p = [p for _, p in tree_leaves(params)]
    flat_g = [g for _, g in tree_leaves(grads)]
    flat_m = [m for _, m in tree_leaves(opt_state["mu"])]
    flat_v = [v for _, v in tree_leaves(opt_state["nu"])]
    with torch.no_grad():
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g = g if g.dtype == torch.float32 else g.float()
            if scale != 1.0:
                g.mul_(scale)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            # update = (m / bc1) / (sqrt(v / bc2) + eps), built in g
            torch.div(v, bc2, out=g)
            g.sqrt_().add_(cfg.eps)
            torch.div(m, g, out=g)
            g.div_(bc1)
            if p.ndim >= 2:   # decoupled weight decay on matrices only
                g.add_(p, alpha=cfg.weight_decay)
            p.sub_(g.to(p.dtype) if p.dtype != torch.float32 else g,
                   alpha=lr)
    opt_state["step"] = torch.full_like(opt_state["step"], step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr_t}
