"""Mixture-of-Experts with load-balanced dispatch.

Routing is the canonical irregular workload inside an LM: after top-k, the
(token, expert) pairs are **atoms** and experts are **tiles** of wildly
different sizes.  Dispatch executors, same router:

* ``dispatch="capacity"`` — sort-based capacity dispatch (atoms sorted by
  expert, ranks past the capacity drop) into a static ``[E, C, D]`` buffer;
* ``dispatch="grouped"`` — the same per batch row;
* ``dispatch="sorted"`` — the paper's schedule: sort atoms by tile, pad
  groups to M-blocks, run the balanced segmented GEMM kernels
  (:mod:`repro_torch.kernels.segmm`).  No token dropping; equal to the
  capacity path when nothing drops;

plus :func:`moe_capacity_einsum`, the dense one-hot specification.

Every per-token combine sums a token's ``k`` atoms in atom order (each
token has exactly ``k``), never with float atomics, so the bits do not
change from run to run.  Aux loss: load-balancing (mean gate fraction x
mean route fraction) + router z-loss.  The reference's ``ep_pins`` and
measured ``"auto"`` are not ported (one device, model-only autotune).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.models.layers import (BATCH, FSDP, TP, _uniform, gather_in,
                                       gather_out, maybe_constrain)

Params = Dict[str, Any]

# Expert-parallel axis: experts live on the TP axis of the mesh.
EP = TP


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, num_shared: int, activation: str, *,
             device=None):
    """``(params, specs)``: router and expert weights drawn from
    ``generator``; ``specs`` name each weight's sharding axes as plain
    tuples (``None`` = replicated).  ``device=None`` means the card."""
    dev = resolve_device(device)
    scale = (3.0 / d_model) ** 0.5
    fscale = (3.0 / d_ff) ** 0.5
    draw = lambda shape, s: _uniform(generator, shape, s, device=dev)
    params: Params = {
        "router": draw((d_model, num_experts), scale),
        "w1": draw((num_experts, d_model, d_ff), scale),
        "w3": draw((num_experts, d_model, d_ff), scale),
        "w2": draw((num_experts, d_ff, d_model), fscale),
    }
    specs = {
        "router": (None, None),
        "w1": (EP, FSDP, None), "w3": (EP, FSDP, None),
        "w2": (EP, None, FSDP),
    }
    if num_shared > 0:
        params.update({
            "sw1": draw((d_model, num_shared * d_ff), scale),
            "sw3": draw((d_model, num_shared * d_ff), scale),
            "sw2": draw((num_shared * d_ff, d_model), fscale),
        })
        specs.update({"sw1": (FSDP, TP), "sw3": (FSDP, TP),
                      "sw2": (TP, FSDP)})
    del activation  # experts are silu_glu in both MoE archs
    return params, specs


def _router(params: Params, x2d: torch.Tensor, num_experts: int,
            top_k: int):
    """Returns ``(topk_idx [T, k] int32, topk_w [T, k], aux_loss scalar)``;
    ``topk_idx`` lists each token's experts by falling probability."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.topk(probs, top_k, dim=-1)
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)

    # load-balance loss (Switch): E * sum_e f_e * p_e
    atoms = topk_idx.numel()
    route_frac = torch.bincount(topk_idx.reshape(-1),
                                minlength=num_experts).float() / atoms
    gate_frac = probs.mean(dim=0)
    lb_loss = num_experts * torch.sum(route_frac * gate_frac)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return topk_idx.to(torch.int32), topk_w, lb_loss + 1e-3 * z_loss


def _expert_ffn(w1, w3, w2, h):
    """Batched over experts: ``h [E, C, D]``, ``w1/w3 [E, D, F]``,
    ``w2 [E, F, D]``."""
    return (F.silu(h @ w1) * (h @ w3)) @ w2


def _sum_atoms(out_atoms: torch.Tensor, top_k: int) -> torch.Tensor:
    """``[..., T * k, D]`` token-major atoms -> ``[..., T, D]``: each
    token's ``k`` atoms added in order, from zero (the reference's
    ``segment_sum``), with no atomics."""
    *lead, ta, d = out_atoms.shape
    atoms = out_atoms.reshape(*lead, ta // top_k, top_k, d)
    out = torch.zeros_like(atoms[..., 0, :])
    for j in range(top_k):
        out = out + atoms[..., j, :]
    return out


def moe_capacity_einsum(params: Params, x: torch.Tensor, *,
                        num_experts: int, top_k: int,
                        capacity_factor: float = 1.25
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense one-hot/einsum dispatch (Shazeer-style reference).

    O(T * E * C) memory — only viable at smoke scale; kept as the
    executable specification the sort-based dispatch is tested against.
    """
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    topk_idx, topk_w, aux = _router(params, x2d, num_experts, top_k)

    capacity = max(int(capacity_factor * t * top_k / num_experts), 1)
    onehot = F.one_hot(topk_idx.long(), num_experts).to(torch.int32)
    flat = onehot.reshape(t * top_k, num_experts)
    pos_in_expert = (torch.cumsum(flat, dim=0, dtype=torch.int32)
                     - flat).reshape(t, top_k, num_experts)
    within = pos_in_expert < capacity
    slot = torch.sum(pos_in_expert * onehot, dim=-1)
    pos_oh = (slot[..., None] == torch.arange(
        capacity, device=x.device)).to(x.dtype)                 # [T, k, C]
    keep = (torch.sum(onehot * within, dim=-1) > 0).to(x.dtype)  # [T, k]
    oh = onehot.to(x.dtype)
    disp = torch.einsum("tke,tkc,tk->tec", oh, pos_oh, keep)
    comb = torch.einsum("tke,tkc,tk,tk->tec", oh, pos_oh, keep,
                        topk_w.to(x.dtype))

    xe = torch.einsum("td,tec->ecd", x2d, disp)                  # [E, C, D]
    he = _expert_ffn(params["w1"].to(x.dtype), params["w3"].to(x.dtype),
                     params["w2"].to(x.dtype), xe)
    out = torch.einsum("ecd,tec->td", he, comb)
    return out.reshape(b, s, d), aux


def moe_capacity(params: Params, x: torch.Tensor, *, num_experts: int,
                 top_k: int, capacity_factor: float = 1.25
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch: atoms sorted by tile (one stable
    argsort), each atom's rank within its expert from the tile offsets,
    scattered into the static ``[E, C, D]`` expert buffer; rank >= C
    drops.  O(T*D + E*C*D) memory, no ``[T, E, C]`` one-hot."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    topk_idx, topk_w, aux = _router(params, x2d, num_experts, top_k)
    capacity = max(int(capacity_factor * t * top_k / num_experts), 1)

    ta = t * top_k
    atom_expert = topk_idx.reshape(ta).long()
    atom_token = torch.arange(t, device=x.device).repeat_interleave(top_k)
    atom_w = topk_w.reshape(ta)

    order = torch.argsort(atom_expert, stable=True)    # sort atoms by tile
    sizes = torch.bincount(atom_expert, minlength=num_experts)
    offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    sorted_e = atom_expert[order]
    rank = torch.arange(ta, device=x.device) - offsets[sorted_e]
    kept = rank < capacity
    slot = torch.where(kept, sorted_e * capacity + rank,
                       num_experts * capacity)

    xe_flat = x.new_zeros((num_experts * capacity + 1, d))
    xe_flat[slot] = x2d[atom_token[order]]
    xe = xe_flat[:-1].reshape(num_experts, capacity, d)

    he = _expert_ffn(params["w1"].to(x.dtype), params["w3"].to(x.dtype),
                     params["w2"].to(x.dtype), xe)
    he_flat = torch.cat([he.reshape(num_experts * capacity, d),
                         he.new_zeros((1, d))], dim=0)
    out_sorted = he_flat[slot] * (atom_w[order] * kept)[:, None].to(he.dtype)
    out_atoms = torch.empty_like(out_sorted)
    out_atoms[order] = out_sorted                      # back to token-major
    out = _sum_atoms(out_atoms, top_k)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_sorted(params: Params, x: torch.Tensor, *, num_experts: int,
               top_k: int, bm: int = 128, schedule: str = "group_mapped",
               execution_path: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's load-balanced dispatch: sort atoms by tile, pad to
    M-blocks, balanced segmented GEMM (three per call: w1, w3, w2).
    Drop-free.

    ``schedule``: segmm block-order policy (``"group_mapped"``,
    ``"chunked_rr"``, ``"chunked_lpt"``) or ``"auto"`` (the model-only
    autotuner inspects the routing once for all three GEMMs).
    ``execution_path``: ``"native"``/``"auto"`` walk the chunked policies'
    queues inside the chunk-walking kernel, ``"pure"`` permutes blocks.
    """
    from repro_torch.kernels.segmm import ops as segmm_ops

    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    topk_idx, topk_w, aux = _router(params, x2d, num_experts, top_k)

    # atoms = (token, k) pairs, token-major
    atom_expert = topk_idx.reshape(t * top_k)
    atom_token = torch.arange(t, device=x.device).repeat_interleave(top_k)
    atoms_in = x2d[atom_token]                              # [T*k, D]

    if schedule == "auto":
        schedule = segmm_ops.resolve_schedule(atom_expert, num_experts)
    gmm = lambda lhs, w: segmm_ops.grouped_matmul(
        lhs, atom_expert, w, num_experts=num_experts, bm=bm,
        schedule=schedule, execution_path=execution_path)
    h1 = gmm(atoms_in, params["w1"])
    h3 = gmm(atoms_in, params["w3"])
    h = F.silu(h1) * h3
    out_atoms = gmm(h.to(x.dtype), params["w2"])
    weighted = out_atoms * topk_w.reshape(t * top_k, 1)
    out = _sum_atoms(weighted, top_k)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_capacity_grouped(params: Params, x: torch.Tensor, *,
                         num_experts: int, top_k: int,
                         capacity_factor: float = 1.25
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (grouped) capacity dispatch: each batch row sorts its own
    atoms (tiles = experts per row); capacity is per row
    (``cf * S * k / E``); drop-free at ``cf -> inf`` like the flat one."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    topk_idx, topk_w, aux = _router(params, x2d, num_experts, top_k)
    capacity = max(int(capacity_factor * s * top_k / num_experts), 1)

    sk = s * top_k
    atom_expert = topk_idx.reshape(b, sk).long()
    atom_w = topk_w.reshape(b, sk)
    atom_token = torch.arange(s, device=x.device).repeat_interleave(top_k)

    order = torch.argsort(atom_expert, dim=1, stable=True)
    sorted_e = torch.gather(atom_expert, 1, order)
    sizes = torch.stack([torch.bincount(e, minlength=num_experts)
                         for e in atom_expert])                  # [B, E]
    offsets = torch.cat([sizes.new_zeros((b, 1)),
                         torch.cumsum(sizes, dim=1)], dim=1)
    rank = (torch.arange(sk, device=x.device)[None]
            - torch.gather(offsets, 1, sorted_e))
    kept = rank < capacity
    slot = torch.where(kept, sorted_e * capacity + rank,
                       num_experts * capacity)                   # [B, Sk]

    x3d = x2d.reshape(b, s, d)
    tok_sorted = atom_token[order]                               # [B, Sk]
    gathered = torch.gather(x3d, 1, tok_sorted[..., None].expand(b, sk, d))
    buf = x.new_zeros((b, num_experts * capacity + 1, d))
    buf.scatter_(1, slot[..., None].expand(b, sk, d), gathered)
    xe = buf[:, :-1].reshape(b, num_experts, capacity, d)
    xe = maybe_constrain(xe, BATCH, EP, None, None)

    w1 = params["w1"].to(x.dtype)
    w3 = params["w3"].to(x.dtype)
    w2 = params["w2"].to(x.dtype)
    h = F.silu(torch.einsum("becd,edf->becf", xe, w1)) * torch.einsum(
        "becd,edf->becf", xe, w3)
    he = torch.einsum("becf,efd->becd", h, w2)                   # [B,E,C,D]
    he = maybe_constrain(he, BATCH, EP, None, None)

    he_flat = torch.cat([he.reshape(b, num_experts * capacity, d),
                         he.new_zeros((b, 1, d))], dim=1)
    out_sorted = torch.gather(he_flat, 1, slot[..., None].expand(b, sk, d))
    w_sorted = torch.gather(atom_w, 1, order)
    out_sorted = out_sorted * (w_sorted * kept)[..., None].to(he.dtype)
    out_atoms = torch.empty_like(out_sorted)
    out_atoms.scatter_(1, order[..., None].expand(b, sk, d), out_sorted)
    return _sum_atoms(out_atoms, top_k).to(x.dtype), aux


def moe_shared(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Shared experts (DeepSeekMoE): a dense gated MLP every token visits."""
    h = F.silu(x @ gather_in(params["sw1"], x.dtype)) * (
        x @ gather_in(params["sw3"], x.dtype))
    return h @ gather_out(params["sw2"], x.dtype)


def moe(params: Params, x: torch.Tensor, *, num_experts: int, top_k: int,
        num_shared: int, dispatch: str = "capacity",
        capacity_factor: float = 1.25, schedule: str = "group_mapped",
        execution_path: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE layer: ``(out [B, S, D], aux_loss)``."""
    if dispatch == "capacity":
        out, aux = moe_capacity(params, x, num_experts=num_experts,
                                top_k=top_k, capacity_factor=capacity_factor)
    elif dispatch == "grouped":
        out, aux = moe_capacity_grouped(params, x, num_experts=num_experts,
                                        top_k=top_k,
                                        capacity_factor=capacity_factor)
    elif dispatch == "sorted":
        out, aux = moe_sorted(params, x, num_experts=num_experts,
                              top_k=top_k, schedule=schedule,
                              execution_path=execution_path)
    else:
        raise ValueError(dispatch)
    if num_shared > 0:
        out = out + moe_shared(params, x)
    return out, aux


class MoELayer(torch.nn.Module):
    """An MoE layer holding its weights; ``forward(x)`` calls :func:`moe`.

    The weights are buffers-like parameters (``requires_grad=False``: the
    segmented-GEMM kernels have no backward yet).  Build with
    :meth:`from_config` (weights drawn from a generator) or from a
    parameter dict (e.g. ``interop.moe_params_from_arrays``).
    """

    def __init__(self, params: Params, *, num_experts: int, top_k: int,
                 num_shared: int = 0, dispatch: str = "sorted",
                 capacity_factor: float = 1.25,
                 schedule: str = "group_mapped",
                 execution_path: str = "auto"):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(
                name, torch.nn.Parameter(value, requires_grad=False))
        self.num_experts = num_experts
        self.top_k = top_k
        self.num_shared = num_shared
        self.dispatch = dispatch
        self.capacity_factor = capacity_factor
        self.schedule = schedule
        self.execution_path = execution_path

    @classmethod
    def from_config(cls, cfg, generator: torch.Generator, *, device=None,
                    **kwargs) -> "MoELayer":
        """A layer at ``cfg``'s widths (a ``ModelConfig`` of an MoE
        family), weights drawn from ``generator``."""
        params, _ = moe_init(generator, cfg.d_model, cfg.d_ff,
                             cfg.num_experts, cfg.num_shared_experts,
                             cfg.activation, device=device)
        kwargs.setdefault("capacity_factor", cfg.capacity_factor)
        return cls(params, num_experts=cfg.num_experts, top_k=cfg.top_k,
                   num_shared=cfg.num_shared_experts, **kwargs)

    def params(self) -> Params:
        return {name: p for name, p in self.named_parameters()}

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe(self.params(), x, num_experts=self.num_experts,
                   top_k=self.top_k, num_shared=self.num_shared,
                   dispatch=self.dispatch,
                   capacity_factor=self.capacity_factor,
                   schedule=self.schedule,
                   execution_path=self.execution_path)
