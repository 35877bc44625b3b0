"""Int8 blockwise-quantized Adam state (the reference's
``train/quantized_opt.py``, bitsandbytes-style).

* ``m``: signed absmax int8 per 256-value block;
* ``v``: a per-block affine int8 code over ``log(v)`` (uniform relative
  error, which the ``1/sqrt(v)`` of the update needs; ``log(1e-12)`` is
  the "v == 0" code point).

State leaves are ``{"q": int8 [blocks, 256], "s": f32 scales, "m": f32
mids}``.  Rounding is half to even, as ``jnp.round``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.lm import tree_leaves, tree_map
from repro_torch.train.optimizer import OptConfig, global_norm, lr_at

BLOCK = 256

_LOG_TINY = -27.6  # log(1e-12): the "v == 0" codepoint


def _pad_len(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def quantize_blockwise(x: torch.Tensor, log_space: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """``linear``: signed absmax int8 per block (for m).  ``log_space``:
    per-block affine int8 over log(x) (for v)."""
    flat = x.reshape(-1).float()
    pad = _pad_len(flat.shape[0]) - flat.shape[0]
    if not log_space:
        blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
        scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
        q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-20)),
                        -127, 127).to(torch.int8)
        return {"q": q, "s": scale[:, 0], "m": torch.zeros_like(scale[:, 0])}
    y = torch.log(torch.clamp(flat, min=1e-12))
    blocks = torch.nn.functional.pad(y, (0, pad), value=_LOG_TINY).reshape(
        -1, BLOCK)
    lo = blocks.amin(dim=1, keepdim=True)
    hi = blocks.amax(dim=1, keepdim=True)
    mid = (hi + lo) / 2.0
    scale = torch.clamp((hi - lo) / 2.0 / 127.0, min=1e-8)
    q = torch.clamp(torch.round((blocks - mid) / scale), -127, 127).to(
        torch.int8)
    return {"q": q, "s": scale[:, 0], "m": mid[:, 0]}


def dequantize_blockwise(state: Dict[str, torch.Tensor], shape,
                         log_space: bool = False) -> torch.Tensor:
    size = 1
    for d in shape:
        size *= d
    if not log_space:
        flat = (state["q"].float() * state["s"][:, None]).reshape(-1)
        return flat[:size].reshape(shape)
    y = (state["q"].float() * state["s"][:, None]
         + state["m"][:, None]).reshape(-1)[:size]
    out = torch.exp(y)
    return torch.where(y <= _LOG_TINY + 1e-3, 0.0, out).reshape(shape)


def init_opt_state_int8(params) -> Dict[str, Any]:
    def zq(p):
        n_blocks = _pad_len(p.numel()) // BLOCK
        return {"q": torch.zeros((n_blocks, BLOCK), dtype=torch.int8,
                                 device=p.device),
                "s": torch.zeros((n_blocks,), dtype=torch.float32,
                                 device=p.device),
                "m": torch.full((n_blocks,), _LOG_TINY, dtype=torch.float32,
                                device=p.device)}
    device = next(leaf for _, leaf in tree_leaves(params)).device
    return {"mu": tree_map(zq, params), "nu": tree_map(zq, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _is_state(tree) -> bool:
    return isinstance(tree, dict) and set(tree) == {"q", "s", "m"}


def _state_leaves(tree):
    """The ``{"q", "s", "m"}`` leaves of a quantized-state tree, in the
    order of the parameter tree's leaves."""
    if _is_state(tree):
        return [tree]
    return [leaf for v in tree.values() for leaf in _state_leaves(v)]


def _rebuild(like, leaves):
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return next(it)
    return go(like)


def adamw_update_int8(params, grads, opt_state, cfg: OptConfig
                      ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """AdamW with int8 blockwise m/v.  Same contract as the reference's
    (new parameter and state trees; nothing is updated in place)."""
    step = int(opt_state["step"]) + 1
    gnorm = global_norm(grads)
    scale = float(np.float32(min(1.0, cfg.clip_norm
                                 / max(float(gnorm), 1e-9))))
    lr_t = lr_at(cfg, step)
    lr = float(lr_t)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))

    def upd(p, g, mq, vq):
        g = g.float() * scale
        m = dequantize_blockwise(mq, p.shape)
        v = dequantize_blockwise(vq, p.shape, log_space=True)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:
            update = update + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * update).to(p.dtype)
        return new_p, quantize_blockwise(m), quantize_blockwise(
            v, log_space=True)

    flat_p = [p for _, p in tree_leaves(params)]
    flat_g = [g for _, g in tree_leaves(grads)]
    new = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, flat_g, _state_leaves(opt_state["mu"]),
        _state_leaves(opt_state["nu"]))]
    return (_rebuild(params, [t[0] for t in new]),
            {"mu": _rebuild(params, [t[1] for t in new]),
             "nu": _rebuild(params, [t[2] for t in new]),
             "step": torch.full_like(opt_state["step"], step)},
            {"grad_norm": gnorm, "lr": lr_t})


def state_bytes(params, int8: bool) -> int:
    """Optimizer-state bytes (for the memory table)."""
    total = 0
    for _, p in tree_leaves(params):
        n = p.numel()
        if int8:
            nb = _pad_len(n) // BLOCK
            total += 2 * (nb * BLOCK + 2 * nb * 4)  # q + scale/mid, m and v
        else:
            total += 2 * n * 4
    return total
