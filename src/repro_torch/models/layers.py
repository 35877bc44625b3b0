"""Transformer building blocks: norms, RoPE, GQA attention, MLP variants.

Pure-function style, as the reference's ``models/layers.py``: parameters
are nested dicts of tensors, every block is ``apply(params, x, ...) -> y``,
and initialisers return ``(params, specs)`` where ``specs`` names each
weight's sharding axes as a plain tuple (the port runs on one device, so
:func:`maybe_constrain` is the identity).  Weights are drawn from an
explicit ``torch.Generator``; the tests carry the reference's weights in
through :mod:`repro_torch.interop` instead.

The banded branch of :func:`attention` runs the K7 kernel
(:func:`repro_torch.kernels.flash_swa.ops.flash_swa_gqa`) where the
reference computes the same band in jnp.
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
    """The reference pins ``x`` to the ambient mesh; the port runs on one
    device, so this is the identity (``spec`` is kept for the call sites)."""
    del spec
    return x


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


def gather_in(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An ``[in, out]`` matrix in the activations' dtype, right before the
    matmul (the reference also pins its sharding there)."""
    return maybe_constrain(w.to(dtype), None, TP)


def gather_out(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Same for ``[in, out]`` matrices sharded the other way."""
    return maybe_constrain(w.to(dtype), TP, None)


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


def _qkv(params: Params, x: torch.Tensor, num_heads: int, num_kv_heads: int,
         head_dim: int):
    b, s, _ = x.shape
    q = x @ gather_in(params["wq"], x.dtype)
    k = x @ gather_in(params["wk"], x.dtype)
    v = x @ gather_in(params["wv"], x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
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
              return_kv: bool = False):
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
    for prefill cache emission.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, num_heads, num_kv_heads, head_dim)
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

    out = out.reshape(b, s, num_heads * head_dim) @ gather_out(
        params["wo"], x.dtype)
    if return_kv:
        return out, k, v
    return out


def attention_decode(params: Params, x: torch.Tensor, pos: int,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     rope_theta: float, sliding_window: Optional[int] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step with a static-length KV cache.

    x: ``[B, 1, D]``; pos: the current position (an int, the same for the
    batch); cache_k/v: ``[B, S_cache, Hkv, hd]``, a ring buffer indexed by
    ``pos % S_cache`` (for SWA the caller sizes it ``min(S, window)``).
    Writes this position's k/v into the caches **in place** (the reference
    returns new arrays) and returns ``(out [B, 1, D], cache_k, cache_v)``.
    """
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    pos = int(pos)
    q, k, v = _qkv(params, x, num_heads, num_kv_heads, head_dim)
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
    # ring slot j holds absolute position pos - ((pos - j) mod S_cache):
    # valid once written (>= 0); with SWA the cache is at most the window
    jslots = torch.arange(s_cache, device=x.device)
    abs_pos = pos - torch.remainder(pos - jslots + s_cache, s_cache)
    logits = torch.where((abs_pos >= 0)[None, None, None, :], logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    out = out.reshape(b, 1, num_heads * head_dim) @ gather_out(
        params["wo"], x.dtype)
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


def mlp(params: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu_glu":
        h = F.silu(x @ gather_in(params["w1"], x.dtype)) * (
            x @ gather_in(params["w3"], x.dtype))
    elif activation == "sq_relu":
        h = torch.square(F.relu(x @ gather_in(params["w1"], x.dtype)))
    elif activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ gather_in(params["w1"], x.dtype), approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ gather_out(params["w2"], x.dtype)
