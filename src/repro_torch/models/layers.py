"""Transformer building blocks: norms, RoPE, GQA attention, MLP variants.

Pure-function style, as the reference's ``models/layers.py``: parameters
are nested dicts of tensors, every block is ``apply(params, x, ...) -> y``,
and initialisers return ``(params, specs)`` where ``specs`` names each
weight's sharding axes as a plain tuple.  Weights are drawn from an
explicit ``torch.Generator``; the tests carry the reference's weights in
through :mod:`repro_torch.interop` instead.

On an :class:`~repro_torch.launch.mesh.LMMesh` (``mesh=``) each rank holds
its block of every weight, as ``specs`` place it, and the blocks run what
GSPMD derives from the reference's pins:

* **FSDP over ``data``**: :func:`gather_in`/:func:`gather_out` all-gather a
  weight's ``data`` blocks right before its matmul (in the activations'
  dtype); the gradient of the gathered weight is summed over ``data`` and
  cut back to this rank's block (a reduce-scatter);
* **tensor parallelism over ``model``**: :func:`attention` runs this rank's
  ``H / tp`` query and ``Hkv / tp`` KV heads (Q/K/V column-parallel, ``wo``
  row-parallel), :func:`mlp` its ``d_ff / tp`` columns; the input passes
  through :func:`to_tp` (identity, gradient summed over ``model``) and the
  row-parallel output through :func:`from_tp` (summed over ``model``,
  gradient passed through): Megatron's f/g pair.

With ``mesh=None``, or a mesh whose axes are all of size 1, none of this
runs: no collective and no copy.  :func:`maybe_constrain` stays the
identity (the placements above are explicit), and its call sites keep
their specs.  The banded branch of :func:`attention` runs the K7 kernel
(:func:`repro_torch.kernels.flash_swa.ops.flash_swa_gqa`) on the rank's own
heads, where the reference computes the same band in jnp.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_swa.ops import flash_swa_gqa

Params = Dict[str, Any]

# Sharding axis names (the reference's mesh): "data" = FSDP axis, "model" =
# tensor-parallel axis, "pod" only shards the batch.
FSDP = "data"
TP = "model"
BATCH = ("pod", "data")


def maybe_constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference pins ``x`` to the ambient mesh; the port places its
    tensors explicitly (see the module's docstring), so this is the
    identity (``spec`` is kept for the call sites)."""
    del spec
    return x


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.axis_size(axis)


class _Gather(torch.autograd.Function):
    """All-gather over ``axis`` along ``dim``.  Backward: on a batch axis
    (``pod``/``data``: the ranks' gradients differ) the sum over the axis,
    this rank's block of it; on ``model`` (the ranks compute the same
    thing) this rank's block alone."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        if axis in BATCH:
            return mesh.reduce_scatter(g, axis, dim), None, None, None
        n = g.shape[dim] // mesh.axis_size(axis)
        return g.narrow(dim, mesh.coord(axis) * n, n), None, None, None


def gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """:class:`_Gather` where ``axis`` has more than one rank, else ``x``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim)


class _ToTP(torch.autograd.Function):
    """Megatron's f: identity; the gradient summed over ``model``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, TP), None


class _Sum(torch.autograd.Function):
    """The sum over ``axes``; the gradient passed through (Megatron's g
    over ``model``).  Right where what follows is the same on every rank
    of ``axes``, so each rank needs only its own term's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """:class:`_Sum` over the axes of ``axes`` that have more than one
    rank; ``x`` where there are none."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    return _Sum.apply(x, mesh, axes) if axes else x


def to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of column-parallel matmuls (f)."""
    return x if axis_size(mesh, TP) == 1 else _ToTP.apply(x, mesh)


def from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of row-parallel partial outputs (g)."""
    return psum(x, mesh, TP)


def gather_whole(w: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """``w``'s blocks gathered over every axis ``spec`` cuts it on: the
    whole weight, for code that runs it whole on every rank."""
    for i, axes in enumerate(spec):
        for a in reversed((axes,) if isinstance(axes, str) else axes or ()):
            w = gather(w, mesh, a, i)
    return w


def heads_split(num_heads: int, num_kv_heads: int, mesh) -> bool:
    """Whether ``model`` divides both head counts, so that attention runs
    tensor-parallel on ``mesh``.  Where it does not (Danube's 8 KV heads
    on the production mesh's 16), the reference's GSPMD pads the heads;
    the port runs that layer's attention whole on every rank of ``model``
    (its weights gathered whole, as ``models.lm`` does for the SSM
    blocks)."""
    tp = axis_size(mesh, TP)
    return num_heads % tp == 0 and num_kv_heads % tp == 0


def local_heads(num_heads: int, num_kv_heads: int, mesh) -> Tuple[int, int]:
    """This rank's query and KV head counts (``H / tp``, ``Hkv / tp``);
    raises where they do not split (see :func:`heads_split`)."""
    tp = axis_size(mesh, TP)
    if num_heads % tp or num_kv_heads % tp:
        raise ValueError(
            f"{num_heads} query / {num_kv_heads} KV heads do not split over "
            f"a model axis of {tp}; use a model axis that divides both")
    return num_heads // tp, num_kv_heads // tp


def _uniform(generator: torch.Generator, shape: Tuple[int, ...],
             scale: float, dtype: torch.dtype = torch.float32,
             device=None) -> torch.Tensor:
    """U(-scale, scale) drawn from ``generator`` (on its device), then moved
    to ``device`` (``None``: where the generator is).  On the ``meta``
    device nothing is drawn (shapes only, for parameter counts)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    u = u * (2.0 * scale) - scale
    return u if device is None else u.to(device)


def gather_in(w: torch.Tensor, dtype: torch.dtype,
              mesh=None) -> torch.Tensor:
    """ZeRO-3 gather-at-use of an ``[in, out]`` matrix placed ``(FSDP,
    TP)``: in the activations' dtype, its ``data`` blocks all-gathered
    right before the matmul (the reference pins ``(None, TP)`` there)."""
    return maybe_constrain(gather(w.to(dtype), mesh, FSDP, 0), None, TP)


def gather_out(w: torch.Tensor, dtype: torch.dtype,
               mesh=None) -> torch.Tensor:
    """Same for ``[in, out]`` matrices placed ``(TP, FSDP)``."""
    return maybe_constrain(gather(w.to(dtype), mesh, FSDP, 1), TP, None)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, *, device=None):
    return ({"scale": torch.ones((d,), dtype=torch.float32, device=device)},
            {"scale": (None,)})


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * params["scale"]
    return out.to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: ``[B, S, H, hd]``; positions: ``[B, S]`` (int).  Rotates the
    first half of the head dimension against the second (not interleaved
    pairs), as the reference does."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)           # [hd/2]
    angles = positions[..., None].float() * freqs            # [B,S,hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (full / sliding-window, optional QKV bias, KV cache decode)
# ---------------------------------------------------------------------------

def attention_init(generator: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, qkv_bias: bool, *,
                   device=None):
    scale = (3.0 / d_model) ** 0.5
    draw = lambda shape: _uniform(generator, shape, scale, device=device)
    params = {
        "wq": draw((d_model, num_heads * head_dim)),
        "wk": draw((d_model, num_kv_heads * head_dim)),
        "wv": draw((d_model, num_kv_heads * head_dim)),
        "wo": draw((num_heads * head_dim, d_model)),
    }
    specs = {"wq": (FSDP, TP), "wk": (FSDP, TP), "wv": (FSDP, TP),
             "wo": (TP, FSDP)}
    if qkv_bias:
        dev = params["wq"].device
        for name, width in (("bq", num_heads), ("bk", num_kv_heads),
                            ("bv", num_kv_heads)):
            params[name] = torch.zeros((width * head_dim,),
                                       dtype=torch.float32, device=dev)
            specs[name] = (TP,)
    return params, specs


def _proj(params: Params, x: torch.Tensor, mesh=None):
    """``x`` through ``wq``/``wk``/``wv`` (and their biases), this rank's
    columns: ``[B, S, width / tp]`` each."""
    q = x @ gather_in(params["wq"], x.dtype, mesh)
    k = x @ gather_in(params["wk"], x.dtype, mesh)
    v = x @ gather_in(params["wv"], x.dtype, mesh)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def _qkv(params: Params, x: torch.Tensor, num_heads: int, num_kv_heads: int,
         head_dim: int, mesh=None):
    """Q/K/V heads (this rank's, on a mesh)."""
    b, s, _ = x.shape
    q, k, v = _proj(params, x, mesh)
    return (q.reshape(b, s, num_heads, head_dim),
            k.reshape(b, s, num_kv_heads, head_dim),
            v.reshape(b, s, num_kv_heads, head_dim))


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    return k if groups == 1 else k.repeat_interleave(groups, dim=2)


_NEG = -1e30


def _attend(q, k, v, qpos, kpos, scale, sliding_window):
    """Masked softmax attention core. q: ``[B,Sq,H,hd]``, k/v:
    ``[B,Sk,H,hd]``; materialises the ``[B, H, Sq, Sk]`` scores."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    i = qpos[:, None, :, None]
    j = kpos[:, None, None, :]
    mask = j <= i
    if sliding_window is not None:
        mask = mask & (j > i - sliding_window)
    logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(params: Params, x: torch.Tensor, positions: torch.Tensor, *,
              num_heads: int, num_kv_heads: int, head_dim: int,
              rope_theta: float, sliding_window: Optional[int] = None,
              query_chunk: Optional[int] = None, swa_banded: bool = False,
              return_kv: bool = False, mesh=None,
              unroll_chunks: bool = False):
    """Training/prefill causal self-attention. x: ``[B, S, D]``.

    Three branches, on the reference's conditions:

    * full: one ``[B, H, S, S]`` score block (``query_chunk`` unset or
      ``S <= query_chunk``);
    * query-chunked: one ``[B, H, qc, S]`` block at a time;
    * banded (``swa_banded`` and ``sliding_window`` and ``query_chunk``,
      ``S > query_chunk + sliding_window``): each query chunk against its
      window band only — the K7 kernel
      (``flash_swa_gqa(q, k, v, window=sliding_window, qc=query_chunk)``),
      which assumes positions 0..S-1, as ``forward`` and ``prefill`` pass.

    ``return_kv`` also returns the roped ``(k, v)`` (``[B, S, Hkv, hd]``)
    for prefill cache emission.  On ``mesh`` every branch runs this rank's
    heads (``num_heads`` and ``num_kv_heads`` are the model's; the GQA group
    is unchanged) and the output is summed over ``model``.

    ``unroll_chunks`` is there for name parity with the reference only,
    where it switches between a ``lax.scan`` over the query chunks and an
    unrolled loop (for its cost analysis).  No code of the port passes it,
    and it changes nothing: the port's chunk loop is a Python loop, always
    unrolled.
    """
    del unroll_chunks
    b, s, _ = x.shape
    num_heads, num_kv_heads = local_heads(num_heads, num_kv_heads, mesh)
    x = to_tp(x, mesh)
    q, k, v = _qkv(params, x, num_heads, num_kv_heads, head_dim, mesh)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    groups = num_heads // num_kv_heads
    scale = head_dim ** -0.5

    banded = (swa_banded and sliding_window is not None
              and query_chunk is not None
              and s > query_chunk + sliding_window)
    if banded:
        out = flash_swa_gqa(q, k, v, window=sliding_window, qc=query_chunk)
    else:
        kk = _repeat_kv(k, groups)
        vv = _repeat_kv(v, groups)
        if query_chunk is None or s <= query_chunk:
            out = _attend(q, kk, vv, positions, positions, scale,
                          sliding_window)
        else:
            assert s % query_chunk == 0, (s, query_chunk)
            out = torch.cat([
                _attend(q[:, i:i + query_chunk], kk, vv,
                        positions[:, i:i + query_chunk], positions, scale,
                        sliding_window)
                for i in range(0, s, query_chunk)], dim=1)

    out = from_tp(out.reshape(b, s, num_heads * head_dim) @ gather_out(
        params["wo"], x.dtype, mesh), mesh)
    if return_kv:
        return out, k, v
    return out


def attention_decode(params: Params, x: torch.Tensor, pos: int,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     rope_theta: float, sliding_window: Optional[int] = None,
                     mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step with a static-length KV cache.

    x: ``[B, 1, D]``; pos: the current position (an int, the same for the
    batch); cache_k/v: ``[B, S_cache, Hkv, hd]``, a ring buffer indexed by
    ``pos % S_cache`` (for SWA the caller sizes it ``min(S, window)``).
    Writes this position's k/v into the caches **in place** (the reference
    returns new arrays) and returns ``(out [B, 1, D], cache_k, cache_v)``.

    On ``mesh`` the caches are this rank's block, placed as
    ``serve.decode.cache_pspecs`` says: this rank's ``Hkv / tp`` KV heads
    when ``model`` divides them (the heads run as in :func:`attention`), or
    else this rank's ``S_cache / tp`` ring slots of every head, which
    :func:`_decode_seq_split` attends to with the flash-decode combine.
    """
    if axis_size(mesh, TP) > 1 and num_kv_heads % axis_size(mesh, TP):
        return _decode_seq_split(params, x, pos, cache_k, cache_v,
                                 num_heads=num_heads,
                                 num_kv_heads=num_kv_heads,
                                 head_dim=head_dim, rope_theta=rope_theta,
                                 mesh=mesh)
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    pos = int(pos)
    num_heads, num_kv_heads = local_heads(num_heads, num_kv_heads, mesh)
    q, k, v = _qkv(params, x, num_heads, num_kv_heads, head_dim, mesh)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    slot = pos % s_cache
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    groups = num_heads // num_kv_heads
    kk = _repeat_kv(cache_k.to(x.dtype), groups)          # [B, Sc, H, hd]
    vv = _repeat_kv(cache_v.to(x.dtype), groups)
    scale = head_dim ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
    logits = torch.where(_written(pos, s_cache, 0, s_cache, x.device),
                         logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    out = from_tp(out.reshape(b, 1, num_heads * head_dim) @ gather_out(
        params["wo"], x.dtype, mesh), mesh)
    return out, cache_k, cache_v


def _written(pos: int, s_cache: int, first: int, n: int,
             device) -> torch.Tensor:
    """``[1, 1, 1, n]``: whether ring slots ``first .. first + n - 1`` of
    ``s_cache`` hold a position yet.  Slot j holds absolute position
    ``pos - ((pos - j) mod s_cache)``: valid once written (>= 0); with SWA
    the cache is at most the window."""
    jslots = torch.arange(first, first + n, device=device)
    abs_pos = pos - torch.remainder(pos - jslots + s_cache, s_cache)
    return (abs_pos >= 0)[None, None, None, :]


def _decode_seq_split(params: Params, x: torch.Tensor, pos: int,
                      cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                      num_heads: int, num_kv_heads: int, head_dim: int,
                      rope_theta: float, mesh):
    """:func:`attention_decode` when ``model`` does not divide the KV heads
    (GLM-4-9B's 2 on a wider axis): the caches hold this rank's ring slots
    of every head.  The token's Q/K/V columns are gathered over ``model``
    (every head), K/V land in the rank that holds slot ``pos % S_cache``,
    and each rank attends every query head to its slots.  The flash-decode
    combine joins them: the global max (the ranks' maxima gathered, so a
    NaN on any rank stays), then the rescaled sum-exp and weighted values
    summed over ``model``.  ``wo`` stays row-parallel: each rank projects
    its own heads' rows of the combined output (where ``model`` does not
    divide the query heads either, every rank projects all of them with
    ``wo`` gathered whole)."""
    b = x.shape[0]
    pos = int(pos)
    tp, rank = mesh.axis_size(TP), mesh.coord(TP)
    n_loc = cache_k.shape[1]
    s_cache = n_loc * tp
    q, k, v = (mesh.all_gather(t, TP, dim=2) for t in _proj(params, x, mesh))
    q = q.reshape(b, 1, num_heads, head_dim)
    k = k.reshape(b, 1, num_kv_heads, head_dim)
    v = v.reshape(b, 1, num_kv_heads, head_dim)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    slot = pos % s_cache
    if slot // n_loc == rank:
        cache_k[:, slot - rank * n_loc] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot - rank * n_loc] = v[:, 0].to(cache_v.dtype)

    groups = num_heads // num_kv_heads
    kk = _repeat_kv(cache_k.to(x.dtype), groups)        # [B, n_loc, H, hd]
    vv = _repeat_kv(cache_v.to(x.dtype), groups)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * (
        head_dim ** -0.5)
    logits = torch.where(_written(pos, s_cache, rank * n_loc, n_loc,
                                  x.device), logits, _NEG)
    top = mesh.all_gather(logits.amax(dim=-1, keepdim=True)[None], TP)
    p = torch.exp(logits - top.amax(dim=0))                  # [B, H, 1, n]
    part = torch.cat([torch.einsum("bhqk,bkhd->bhqd", p, vv.float()),
                      p.sum(dim=-1, keepdim=True)], dim=-1)
    part = mesh.all_reduce(part, TP)
    out = (part[..., :head_dim] / part[..., head_dim:]).to(x.dtype)
    if num_heads % tp:      # the query heads do not split: wo runs whole
        wo = gather_whole(params["wo"].to(x.dtype), (TP, FSDP), mesh)
        out = out.transpose(1, 2).reshape(b, 1, num_heads * head_dim) @ wo
        return out, cache_k, cache_v
    h_loc = num_heads // tp
    out = out[:, rank * h_loc:(rank + 1) * h_loc].transpose(1, 2)
    out = from_tp(out.reshape(b, 1, h_loc * head_dim) @ gather_out(
        params["wo"], x.dtype, mesh), mesh)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             activation: str, *, device=None):
    scale = (3.0 / d_model) ** 0.5
    fscale = (3.0 / d_ff) ** 0.5
    draw = lambda shape, sc: _uniform(generator, shape, sc, device=device)
    params = {"w1": draw((d_model, d_ff), scale)}
    specs = {"w1": (FSDP, TP)}
    if activation == "silu_glu":
        params["w3"] = draw((d_model, d_ff), scale)
        specs["w3"] = (FSDP, TP)
    params["w2"] = draw((d_ff, d_model), fscale)
    specs["w2"] = (TP, FSDP)
    return params, specs


def mlp(params: Params, x: torch.Tensor, activation: str,
        mesh=None) -> torch.Tensor:
    """The MLP; on ``mesh`` this rank's ``d_ff / tp`` columns, the output
    summed over ``model``."""
    x = to_tp(x, mesh)
    w1 = gather_in(params["w1"], x.dtype, mesh)
    if activation == "silu_glu":
        h = F.silu(x @ w1) * (x @ gather_in(params["w3"], x.dtype, mesh))
    elif activation == "sq_relu":
        h = torch.square(F.relu(x @ w1))
    elif activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ w1, approximate="tanh")
    else:
        raise ValueError(activation)
    return from_tp(h @ gather_out(params["w2"], x.dtype, mesh), mesh)
