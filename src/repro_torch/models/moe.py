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
mean route fraction) + router z-loss.

**Expert parallelism** (:func:`moe` with ``mesh=``, an
:class:`~repro_torch.launch.mesh.LMMesh`): rank ``m`` of ``model`` holds
experts ``[m E / tp, (m + 1) E / tp)`` (``moe_init``'s ``EP`` dim), their
``data`` blocks gathered at use (FSDP).  The activations are already
copied on every rank of ``model`` (Megatron's f/g, :mod:`layers`), so no
token moves: each rank sends the atoms routed to its own experts through
them and the partial outputs are summed over ``model``.  ``to_tp`` sits on
the experts' tokens and on the combine weights, after the router, whose
weight is copied on every rank: each rank of ``model`` then computes the
same whole router gradient (the combine part summed over ``model``, the
aux part once).  The shared experts run column-parallel like
:func:`layers.mlp`, their partial added before the one sum.  The aux loss
and the ``capacity`` dispatch's global ranks are the whole batch's (the
reference's under GSPMD): router statistics summed and per-expert counts
gathered over the batch axes.  The experts' placement is explicit, so the
reference's ``ep_pins`` (pins of the expert buffers to the expert axis,
which change no number) is accepted and does nothing.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.models.layers import (BATCH, FSDP, TP, _uniform, axis_size,
                                       from_tp, gather, gather_in,
                                       gather_out, maybe_constrain, psum,
                                       to_tp)

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


def _bincount(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` over the last dimension (each
    row of a 2-D ``ids`` counted apart), as an integer scatter-add, which
    the ``meta`` device also runs."""
    ids = ids.long()
    counts = torch.zeros((*ids.shape[:-1], n), dtype=torch.int64,
                         device=ids.device)
    return counts.scatter_add_(-1, ids, torch.ones_like(ids))


def _router(params: Params, x2d: torch.Tensor, num_experts: int,
            top_k: int, mesh=None, axes: Tuple[str, ...] = ()):
    """Returns ``(topk_idx [T, k] int32, topk_w [T, k], aux_loss scalar)``;
    ``topk_idx`` lists each token's experts by falling probability.

    ``axes`` (on ``mesh``): the batch axes this rank's ``T`` tokens are cut
    over.  The aux loss is then the whole batch's, as the reference's
    under GSPMD: the gate sums and the z-loss sum are summed over ``axes``
    with their gradient passed through (each rank's is its own tokens'
    term), the route counts with no gradient, and both divided by the
    global token count."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.topk(probs, top_k, dim=-1)
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)

    # load-balance loss (Switch): E * sum_e f_e * p_e
    counts = _bincount(topk_idx.reshape(-1), num_experts)
    lse2 = torch.square(torch.logsumexp(logits, dim=-1))
    if not axes:
        route_frac = counts.float() / topk_idx.numel()
        gate_frac = probs.mean(dim=0)
        z_loss = torch.mean(lse2)
    else:
        t = x2d.shape[0] * math.prod(mesh.axis_size(a) for a in axes)
        route_frac = mesh.all_reduce(counts, axes).float() / (t * top_k)
        sums = psum(torch.cat([probs.sum(dim=0), lse2.sum()[None]]), mesh,
                    axes) / t
        gate_frac, z_loss = sums[:num_experts], sums[num_experts]
    lb_loss = num_experts * torch.sum(route_frac * gate_frac)
    return topk_idx.to(torch.int32), topk_w, lb_loss + 1e-3 * z_loss


def _expert_ffn(w1, w3, w2, h):
    """Batched over experts: ``h [E, C, D]``, ``w1/w3 [E, D, F]``,
    ``w2 [E, F, D]``."""
    return (F.silu(h @ w1) * (h @ w3)) @ w2


def _grouped_ffn(w1, w3, w2, xe):
    """:func:`_expert_ffn` per batch row: ``xe [B, E, C, D]``."""
    h = F.silu(torch.einsum("becd,edf->becf", xe, w1)) * torch.einsum(
        "becd,edf->becf", xe, w3)
    return torch.einsum("becf,efd->becd", h, w2)


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


def _atoms(x: torch.Tensor, top_k: int) -> torch.Tensor:
    """``[..., T, D]`` tokens -> ``[..., T * k, D]`` token-major atoms (each
    token copied ``k`` times).  Its gradient sums each token's ``k`` copies
    in order, where indexing's would scatter-add them (atomic on the
    card)."""
    *lead, t, d = x.shape
    return x.unsqueeze(-2).expand(*lead, t, top_k, d).reshape(
        *lead, t * top_k, d)


def _local_experts(params: Params, mesh, dtype=None):
    """``(w1, w3, w2, first)``: this rank's experts ``[first, first +
    E / tp)`` (all ``E`` without a mesh), cast to ``dtype`` (kept when
    ``None``), their ``data`` blocks gathered (dim 1 of ``w1``/``w3``, dim
    2 of ``w2``: ``moe_init``'s ``FSDP`` dims; the gradient is
    reduce-scattered back over ``data``)."""
    cast = (lambda w: w) if dtype is None else (lambda w: w.to(dtype))
    w1, w3, w2 = (cast(params[n]) for n in ("w1", "w3", "w2"))
    if mesh is None:
        return w1, w3, w2, 0
    w1 = gather(w1, mesh, FSDP, 1)
    w3 = gather(w3, mesh, FSDP, 1)
    w2 = gather(w2, mesh, FSDP, 2)
    return w1, w3, w2, mesh.coord(EP) * w1.shape[0]


def _counts_before(sizes: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Each expert's atoms on the batch shards before this rank's in row
    order: every shard's counts ``[E]`` gathered over ``axes`` (minor axis
    first, so the shards lie as the batch is cut: ``pod`` before
    ``data``), summed over those before this one."""
    every, index = sizes[None], 0
    for a in reversed(axes):
        every = mesh.all_gather(every, a)
    for a in axes:
        index = index * mesh.axis_size(a) + mesh.coord(a)
    return every[:index].sum(dim=0)


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
                 top_k: int, capacity_factor: float = 1.25,
                 ep_pins: bool = False, xt=None, mesh=None,
                 axes: Tuple[str, ...] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch: atoms sorted by tile (one stable
    argsort), each atom's rank within its expert from the tile offsets,
    scattered into the static ``[E, C, D]`` expert buffer; rank >= C
    drops.  O(T*D + E*C*D) memory, no ``[T, E, C]`` one-hot.

    On ``mesh`` (as :func:`moe` calls it): ``x`` feeds the router, ``xt``
    (the same tokens through ``to_tp``; ``x`` when ``None``) this rank's
    experts, and the output is their partial.  The capacity is the global
    batch's; an atom's rank within its expert counts the atoms of the
    batch shards before this one (over ``axes``) first, so the same atoms
    drop as on one device."""
    del ep_pins                   # placement is explicit (module docstring)
    xt = x if xt is None else xt
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    topk_idx, topk_w, aux = _router(params, x2d, num_experts, top_k, mesh,
                                    axes)
    t_all = t * math.prod(mesh.axis_size(a) for a in axes)
    capacity = max(int(capacity_factor * t_all * top_k / num_experts), 1)
    w1, w3, w2, first = _local_experts(params, mesh, x.dtype)
    n_loc = w1.shape[0]

    ta = t * top_k
    atom_expert = topk_idx.reshape(ta).long()
    atom_w = to_tp(topk_w, mesh).reshape(ta)

    order = torch.argsort(atom_expert, stable=True)    # sort atoms by tile
    sizes = _bincount(atom_expert, num_experts)
    offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    sorted_e = atom_expert[order]
    rank = torch.arange(ta, device=x.device) - offsets[sorted_e]
    if axes:
        rank = rank + _counts_before(sizes, mesh, axes)[sorted_e]
    kept = rank < capacity
    if n_loc < num_experts:                  # only this rank's experts
        kept = kept & (sorted_e >= first) & (sorted_e < first + n_loc)
    slot = torch.where(kept, (sorted_e - first) * capacity + rank,
                       n_loc * capacity)

    xe_flat = x.new_zeros((n_loc * capacity + 1, d))
    xe_flat[slot] = _atoms(xt.reshape(t, d), top_k)[order]
    xe = xe_flat[:-1].reshape(n_loc, capacity, d)

    he = _expert_ffn(w1, w3, w2, xe)
    he_flat = torch.cat([he.reshape(n_loc * capacity, d),
                         he.new_zeros((1, d))], dim=0)
    out_sorted = he_flat[slot] * (atom_w[order] * kept)[:, None].to(he.dtype)
    out_atoms = torch.empty_like(out_sorted)
    out_atoms[order] = out_sorted                      # back to token-major
    out = _sum_atoms(out_atoms, top_k)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_sorted(params: Params, x: torch.Tensor, *, num_experts: int,
               top_k: int, bm: int = 128, schedule: str = "group_mapped",
               execution_path: str = "auto", xt=None, mesh=None,
               axes: Tuple[str, ...] = ()
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's load-balanced dispatch: sort atoms by tile, pad to
    M-blocks, balanced segmented GEMM (three per call: w1, w3, w2).
    Drop-free.

    ``schedule``: segmm block-order policy (``"group_mapped"``,
    ``"chunked_rr"``, ``"chunked_lpt"``) or ``"auto"`` (the autotuner
    inspects the routing once for all three GEMMs; with
    ``REPRO_AUTOTUNE_MEASURE=1`` it times the candidate policies on the
    first GEMM's operands, which share the others' routing).
    ``execution_path``: ``"native"``/``"auto"`` walk the chunked policies'
    queues inside the chunk-walking kernel, ``"pure"`` permutes blocks.

    On ``mesh`` (``x``, ``xt``, ``axes`` as in :func:`moe_capacity`) the
    grouped GEMMs take only the atoms routed to this rank's ``E / tp``
    experts, their ids shifted to ``[0, E / tp)``; the other atoms'
    outputs are zero here (their experts' ranks add them).
    """
    from repro_torch.kernels.segmm import ops as segmm_ops

    xt = x if xt is None else xt
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    topk_idx, topk_w, aux = _router(params, x2d, num_experts, top_k, mesh,
                                    axes)
    w1, w3, w2, first = _local_experts(params, mesh)
    n_loc = w1.shape[0]

    # atoms = (token, k) pairs, token-major
    ta = t * top_k
    atom_expert = topk_idx.reshape(ta)
    atoms_in = _atoms(xt.reshape(t, d), top_k)                  # [T*k, D]
    mine = None
    if n_loc < num_experts:
        mine = torch.nonzero((atom_expert >= first)
                             & (atom_expert < first + n_loc))[:, 0]
        atom_expert = atom_expert[mine] - first
        atoms_in = atoms_in[mine]

    if schedule == "auto":
        measure = None
        from repro_torch.core.autotune import measurement_enabled
        if measurement_enabled():
            from repro_torch.core.measure import time_fn

            def measure(plan):
                policy, p = segmm_ops.plan_policy(plan)
                f = lambda *a: segmm_ops.grouped_matmul(
                    *a, num_experts=n_loc, bm=bm, schedule=policy,
                    execution_path=p)
                return time_fn(f, atoms_in, atom_expert, w1, warmup=1,
                               iters=3)
        schedule = segmm_ops.resolve_schedule(atom_expert, n_loc,
                                              measure=measure)
    gmm = lambda lhs, w: segmm_ops.grouped_matmul(
        lhs, atom_expert, w, num_experts=n_loc, bm=bm, schedule=schedule,
        execution_path=execution_path)
    h1 = gmm(atoms_in, w1)
    h3 = gmm(atoms_in, w3)
    h = F.silu(h1) * h3
    out_atoms = gmm(h.to(x.dtype), w2)
    if mine is not None:              # back to every atom, zero elsewhere
        out_atoms = out_atoms.new_zeros((ta, d)).index_copy_(0, mine,
                                                              out_atoms)
    weighted = out_atoms * to_tp(topk_w, mesh).reshape(ta, 1)
    out = _sum_atoms(weighted, top_k)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_capacity_grouped(params: Params, x: torch.Tensor, *,
                         num_experts: int, top_k: int,
                         capacity_factor: float = 1.25, xt=None, mesh=None,
                         axes: Tuple[str, ...] = ()
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (grouped) capacity dispatch: each batch row sorts its own
    atoms (tiles = experts per row); capacity is per row
    (``cf * S * k / E``); drop-free at ``cf -> inf`` like the flat one.

    On ``mesh`` (``x``, ``xt``, ``axes`` as in :func:`moe_capacity`) the
    expert buffer is ``[B, E / tp, C, D]`` (only this rank's experts'
    slots) and the output their partial; only the aux statistics cross
    ranks."""
    xt = x if xt is None else xt
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    topk_idx, topk_w, aux = _router(params, x2d, num_experts, top_k, mesh,
                                    axes)
    capacity = max(int(capacity_factor * s * top_k / num_experts), 1)
    w1, w3, w2, first = _local_experts(params, mesh, x.dtype)
    n_loc = w1.shape[0]

    sk = s * top_k
    atom_expert = topk_idx.reshape(b, sk).long()
    atom_w = to_tp(topk_w, mesh).reshape(b, sk)

    order = torch.argsort(atom_expert, dim=1, stable=True)
    sorted_e = torch.gather(atom_expert, 1, order)
    sizes = _bincount(atom_expert, num_experts)                  # [B, E]
    offsets = torch.cat([sizes.new_zeros((b, 1)),
                         torch.cumsum(sizes, dim=1)], dim=1)
    rank = (torch.arange(sk, device=x.device)[None]
            - torch.gather(offsets, 1, sorted_e))
    kept = rank < capacity
    if n_loc < num_experts:                  # only this rank's experts
        kept = kept & (sorted_e >= first) & (sorted_e < first + n_loc)
    slot = torch.where(kept, (sorted_e - first) * capacity + rank,
                       n_loc * capacity)                         # [B, Sk]

    gathered = torch.gather(_atoms(xt.reshape(b, s, d), top_k), 1,
                            order[..., None].expand(b, sk, d))
    buf = x.new_zeros((b, n_loc * capacity + 1, d))
    buf.scatter_(1, slot[..., None].expand(b, sk, d), gathered)
    xe = buf[:, :-1].reshape(b, n_loc, capacity, d)
    xe = maybe_constrain(xe, BATCH, EP, None, None)

    he = _grouped_ffn(w1, w3, w2, xe)                            # [B,E,C,D]
    he = maybe_constrain(he, BATCH, EP, None, None)

    he_flat = torch.cat([he.reshape(b, n_loc * capacity, d),
                         he.new_zeros((b, 1, d))], dim=1)
    out_sorted = torch.gather(he_flat, 1, slot[..., None].expand(b, sk, d))
    w_sorted = torch.gather(atom_w, 1, order)
    out_sorted = out_sorted * (w_sorted * kept)[..., None].to(he.dtype)
    out_atoms = torch.empty_like(out_sorted)
    out_atoms.scatter_(1, order[..., None].expand(b, sk, d), out_sorted)
    return _sum_atoms(out_atoms, top_k).to(x.dtype), aux


def moe_shared(params: Params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Shared experts (DeepSeekMoE): a dense gated MLP every token visits.
    On ``mesh``, this rank's ``num_shared * d_ff / tp`` columns (as
    :func:`layers.mlp`, without its f/g): the partial output."""
    h = F.silu(x @ gather_in(params["sw1"], x.dtype, mesh)) * (
        x @ gather_in(params["sw3"], x.dtype, mesh))
    return h @ gather_out(params["sw2"], x.dtype, mesh)


def moe(params: Params, x: torch.Tensor, *, num_experts: int, top_k: int,
        num_shared: int, dispatch: str = "capacity",
        capacity_factor: float = 1.25, schedule: str = "group_mapped",
        execution_path: str = "auto", ep_pins: bool = False, mesh=None,
        batch_axes: Tuple[str, ...] = BATCH
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE layer: ``(out [B, S, D], aux_loss)``.

    On ``mesh`` (see the module's docstring) ``x`` is this rank's rows,
    cut over ``batch_axes`` (those with more than one rank), and
    ``params`` this rank's blocks; ``out`` is these rows' whole output on
    every rank of ``model``, ``aux`` the whole batch's."""
    del ep_pins                   # placement is explicit (module docstring)
    axes = tuple(a for a in batch_axes if axis_size(mesh, a) > 1)
    xt = to_tp(x, mesh)           # the experts' tokens (f)
    kw = dict(num_experts=num_experts, top_k=top_k, xt=xt, mesh=mesh,
              axes=axes)
    if dispatch == "capacity":
        out, aux = moe_capacity(params, x, capacity_factor=capacity_factor,
                                **kw)
    elif dispatch == "grouped":
        out, aux = moe_capacity_grouped(
            params, x, capacity_factor=capacity_factor, **kw)
    elif dispatch == "sorted":
        out, aux = moe_sorted(params, x, schedule=schedule,
                              execution_path=execution_path, **kw)
    else:
        raise ValueError(dispatch)
    if num_shared > 0:
        out = out + moe_shared(params, xt, mesh)
    return from_tp(out, mesh), aux   # the partial outputs summed (g)


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
