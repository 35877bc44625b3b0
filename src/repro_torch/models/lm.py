"""Decoder LM assembly: init, forward, prefill, decode step — all 10 families.

Structure, as the reference's ``models/lm.py``: embedding -> ``num_layers``
blocks -> final norm -> untied LM head.  Block internals by family:

* ``dense`` / ``vlm`` / ``audio``: GQA attention + MLP variant;
* ``moe``: GQA attention + routed experts (+ shared experts);
* ``ssm``: RWKV6 time-mix + RWKV channel-mix;
* ``hybrid``: parallel attention (SWA) + mamba heads, then MLP.

``vlm``/``audio`` take precomputed frontend embeddings (the stub), projected
and prepended to the token embeddings.

Layer parameters are stacked ``[L, ...]`` like the reference's, and the
layers run in a Python loop over them (the reference's ``lax.scan`` and
remat only matter to a compiler and to training).  On the sliding-window
configs (H2O-Danube3-4B, Hymba-1.5B) a prompt longer than ``query_chunk +
window`` takes the banded branch of :func:`layers.attention`: the K7
kernel.  :func:`decode_step` updates the cache it is given in place and
returns it.  ``lm_loss`` and the chunked cross-entropy come with training.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

Params = Dict[str, Any]

ATTENTION_FAMILIES = ("dense", "vlm", "audio", "moe", "hybrid")


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {name: tree_map(fn, *(t[name] for t in trees))
                for name in first}
    return fn(*trees)


def tree_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict, paths joined with ``/``."""
    if isinstance(tree, dict):
        for name, value in tree.items():
            yield from tree_leaves(value, f"{prefix}/{name}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(cfg, generator: torch.Generator, device) -> Tuple[Params,
                                                                  Params]:
    params: Params = {}
    specs: Params = {}
    hd = cfg.resolved_head_dim
    params["ln1"], specs["ln1"] = L.rmsnorm_init(cfg.d_model, device=device)
    params["ln2"], specs["ln2"] = L.rmsnorm_init(cfg.d_model, device=device)
    if cfg.family in ATTENTION_FAMILIES:
        params["attn"], specs["attn"] = L.attention_init(
            generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd,
            cfg.qkv_bias, device=device)
    if cfg.family in ("dense", "vlm", "audio", "hybrid"):
        params["mlp"], specs["mlp"] = L.mlp_init(
            generator, cfg.d_model, cfg.d_ff, cfg.activation, device=device)
    if cfg.family == "moe":
        params["moe"], specs["moe"] = M.moe_init(
            generator, cfg.d_model, cfg.d_ff, cfg.num_experts,
            cfg.num_shared_experts, cfg.activation, device=device)
    if cfg.family == "ssm":
        params["tmix"], specs["tmix"] = S.rwkv6_init(
            generator, cfg.d_model, cfg.rwkv_num_heads, cfg.rwkv_head_dim,
            device=device)
        params["cmix"], specs["cmix"] = S.rwkv_cmix_init(
            generator, cfg.d_model, cfg.d_ff, device=device)
    if cfg.family == "hybrid":
        params["mamba"], specs["mamba"] = S.mamba_init(
            generator, cfg.d_model, cfg.num_heads * hd, cfg.ssm_state,
            device=device)
    return params, specs


def init_params(cfg, generator: torch.Generator, *,
                device=None) -> Tuple[Params, Params]:
    """``(params, specs)``: the reference's tree, shapes and ``U(-scale,
    scale)`` scales, float32, layer parameters stacked ``[L, ...]``, drawn
    from ``generator`` (on its device) and placed on ``device`` (``None``:
    the card; ``"meta"``: shapes only).  Layers are drawn one at a time
    into the stacked tensors, so the peak is the model plus one layer."""
    dev = resolve_device(device)
    scale = (3.0 / cfg.d_model) ** 0.5
    params: Params = {
        "embed": L._uniform(generator, (cfg.padded_vocab, cfg.d_model),
                            scale, device=dev),
        "lm_head": L._uniform(generator, (cfg.d_model, cfg.padded_vocab),
                              scale, device=dev),
    }
    specs: Params = {"embed": ("model", "data"), "lm_head": ("data", "model")}
    params["ln_f"], specs["ln_f"] = L.rmsnorm_init(cfg.d_model, device=dev)

    layer, layer_specs = _layer_init(cfg, generator, dev)
    stacked = tree_map(lambda p: torch.empty((cfg.num_layers, *p.shape),
                                             dtype=p.dtype, device=p.device),
                       layer)
    for i in range(cfg.num_layers):
        if i:
            layer, _ = _layer_init(cfg, generator, dev)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
    del layer
    params["layers"] = stacked
    specs["layers"] = tree_map(lambda spec: (None, *spec), layer_specs)

    if cfg.frontend is not None:
        params["frontend_proj"] = L._uniform(
            generator, (cfg.d_model, cfg.d_model), scale, device=dev)
        specs["frontend_proj"] = ("data", "model")
    return params, specs


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """float32 leaves cast to ``dtype`` (others kept), as the reference's
    serving launcher does once; the input's float32 leaves are dropped from
    ``params`` as they are cast, so the peak is one leaf above the model."""
    out: Params = {}
    for name in list(params):
        value = params.pop(name)
        if isinstance(value, dict):
            out[name] = cast_params(value, dtype)
        else:
            out[name] = (value.to(dtype) if value.dtype == torch.float32
                         else value)
    return out


def param_shapes(cfg) -> Params:
    """The parameter tree on the ``meta`` device (no allocation)."""
    return init_params(cfg, torch.Generator(), device="meta")[0]


def param_count(cfg) -> int:
    return sum(math.prod(p.shape) for _, p in tree_leaves(param_shapes(cfg)))


def active_param_count(cfg) -> int:
    """MoE: routed experts count at top_k/E; everything else fully."""
    total = 0
    for path, leaf in tree_leaves(param_shapes(cfg)):
        n = math.prod(leaf.shape)
        if "/moe/w" in path:  # routed expert tensors [L, E, ...]
            n = n * cfg.top_k // max(cfg.num_experts, 1)
        total += n
    return total


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_kwargs(cfg) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                sliding_window=cfg.sliding_window)


def _moe(cfg, params: Params, h: torch.Tensor):
    return M.moe(params, h, num_experts=cfg.num_experts, top_k=cfg.top_k,
                 num_shared=cfg.num_shared_experts, dispatch=cfg.moe_dispatch,
                 capacity_factor=cfg.capacity_factor)


def _block(cfg, params: Params, x: torch.Tensor, positions: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder block over a whole sequence: ``(x, aux_loss, state)``,
    ``state`` holding the roped ``k``/``v`` and the SSM states that
    :func:`prefill` turns into this layer's decode cache."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    state: Dict[str, torch.Tensor] = {}
    h = L.rmsnorm(params["ln1"], x)
    if cfg.family in ATTENTION_FAMILIES:
        attn_out, state["k"], state["v"] = L.attention(
            params["attn"], h, positions, query_chunk=cfg.attn_query_chunk,
            swa_banded=cfg.swa_banded, return_kv=True, **_attn_kwargs(cfg))
    if cfg.family == "ssm":
        tout, (state["xprev_t"], state["wkv"]) = S.rwkv6_block(
            params["tmix"], h, num_heads=cfg.rwkv_num_heads,
            head_dim=cfg.rwkv_head_dim, chunk=cfg.ssm_chunk,
            return_state=True)
        x = x + tout
    elif cfg.family == "hybrid":
        mout, state["h"] = S.mamba_block(params["mamba"], h,
                                         chunk=cfg.ssm_chunk,
                                         return_state=True)
        x = x + 0.5 * (attn_out + mout)   # parallel heads, mean-fused
    elif cfg.family in ATTENTION_FAMILIES:
        x = x + attn_out
    else:
        raise ValueError(cfg.family)

    h2 = L.rmsnorm(params["ln2"], x)
    if cfg.family == "moe":
        out, aux = _moe(cfg, params["moe"], h2)
        x = x + out
    elif cfg.family == "ssm":
        cout, state["xprev_c"] = S.rwkv_cmix(params["cmix"], h2,
                                             return_state=True)
        x = x + cout
    else:
        x = x + L.mlp(params["mlp"], h2, cfg.activation)
    return x, aux, state


def _layer(params: Params, i: int) -> Params:
    return tree_map(lambda p: p[i], params["layers"])


def _embed(params: Params, cfg, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor],
           dtype: torch.dtype) -> torch.Tensor:
    """Token embeddings, with the projected frontend prefix in front."""
    x = params["embed"][tokens.long()].to(dtype)
    if cfg.frontend is not None:
        assert prefix_embeds is not None, f"{cfg.name} needs frontend stub"
        pre = prefix_embeds.to(dtype) @ params["frontend_proj"].to(dtype)
        x = torch.cat([pre, x], dim=1)
    return x


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def forward_hidden(params: Params, cfg, tokens: torch.Tensor,
                   prefix_embeds: Optional[torch.Tensor] = None,
                   dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward: ``(final-norm hidden [B,S,D], aux loss)``."""
    x = _embed(params, cfg, tokens, prefix_embeds, dtype)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a, _ = _block(cfg, _layer(params, i), x, positions)
        aux = aux + a
    return L.rmsnorm(params["ln_f"], x), aux


def forward(params: Params, cfg, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward. tokens: ``[B, S_tok]``; returns
    ``(logits [B, S, padded_vocab], aux)``."""
    x, aux = forward_hidden(params, cfg, tokens, prefix_embeds, dtype)
    return x @ params["lm_head"].to(dtype), aux


# ---------------------------------------------------------------------------
# prefill: forward + cache emission
# ---------------------------------------------------------------------------

def _emit_kv_cache(k: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Ring-align prefill K (or V) ``[B, S, H, hd]`` into a ``[B,
    cache_len, ...]`` decode cache: position p lives at slot p % cache_len."""
    s = k.shape[1]
    if cache_len >= s:  # identity slots, zero-pad the unwritten tail
        pad = k.new_zeros((k.shape[0], cache_len - s, *k.shape[2:]))
        return torch.cat([k, pad], dim=1)
    tail = k[:, s - cache_len:]          # positions s-cache_len .. s-1
    return torch.roll(tail, s % cache_len, dims=1)


def prefill(params: Params, cfg, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            dtype: torch.dtype = torch.bfloat16,
            cache_len: Optional[int] = None):
    """Inference prefill: consume the prompt, return ``(last-position
    logits [B, 1, V], stacked decode caches sized for cache_len total
    positions)``.  Only the final position's logits are computed."""
    x = _embed(params, cfg, tokens, prefix_embeds, dtype)
    b, s, _ = x.shape
    if cache_len is None:
        cache_len = s
    positions = _positions(b, s, x.device)
    win = min(cache_len, cfg.sliding_window or cache_len)
    caches = []
    for i in range(cfg.num_layers):
        x, _, cache = _block(cfg, _layer(params, i), x, positions)
        for name in ("k", "v"):
            if name in cache:
                cache[name] = _emit_kv_cache(cache[name], win)
        caches.append({name: c if c.dtype == torch.float32 else c.to(dtype)
                       for name, c in cache.items()})
    cache = tree_map(lambda *cs: torch.stack(cs), *caches)
    del caches
    x = L.rmsnorm(params["ln_f"], x[:, -1:])
    return x @ params["lm_head"].to(dtype), cache


# ---------------------------------------------------------------------------
# decode: cache init + one-token step
# ---------------------------------------------------------------------------

def cache_shape(cfg, batch: int, seq_len: int,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of the stacked KV/state cache."""
    hd = cfg.resolved_head_dim
    n = cfg.num_layers
    shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.family in ATTENTION_FAMILIES:
        s_cache = min(seq_len, cfg.sliding_window or seq_len)
        shape = (n, batch, s_cache, cfg.num_kv_heads, hd)
        shapes["k"] = (shape, dtype)
        shapes["v"] = (shape, dtype)
    if cfg.family == "ssm":
        h, k = cfg.rwkv_num_heads, cfg.rwkv_head_dim
        shapes["wkv"] = ((n, batch, h, k, k), torch.float32)
        shapes["xprev_t"] = ((n, batch, 1, cfg.d_model), dtype)
        shapes["xprev_c"] = ((n, batch, 1, cfg.d_model), dtype)
    if cfg.family == "hybrid":
        shapes["h"] = ((n, batch, cfg.num_heads * hd, cfg.ssm_state),
                       torch.float32)
    return shapes


def init_cache(cfg, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16, *,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in cache_shape(cfg, batch, seq_len,
                                                 dtype).items()}


def _block_decode(cfg, params: Params, x: torch.Tensor, pos: int,
                  cache: Dict[str, torch.Tensor]):
    new_cache: Dict[str, torch.Tensor] = {}
    h = L.rmsnorm(params["ln1"], x)
    if cfg.family in ATTENTION_FAMILIES:
        attn_out, new_cache["k"], new_cache["v"] = L.attention_decode(
            params["attn"], h, pos, cache["k"], cache["v"],
            **_attn_kwargs(cfg))
    if cfg.family == "ssm":
        tout, (xp, wkv) = S.rwkv6_block(
            params["tmix"], h, num_heads=cfg.rwkv_num_heads,
            head_dim=cfg.rwkv_head_dim, use_chunked=False,
            x_prev=cache["xprev_t"], state=cache["wkv"], return_state=True)
        new_cache["wkv"], new_cache["xprev_t"] = wkv, xp
        x = x + tout
    elif cfg.family == "hybrid":
        mout, new_cache["h"] = S.mamba_block(
            params["mamba"], h, use_chunked=False, state=cache["h"],
            return_state=True)
        x = x + 0.5 * (attn_out + mout)
    else:
        x = x + attn_out

    h2 = L.rmsnorm(params["ln2"], x)
    if cfg.family == "moe":
        out, _ = _moe(cfg, params["moe"], h2)
        x = x + out
    elif cfg.family == "ssm":
        cout, new_cache["xprev_c"] = S.rwkv_cmix(
            params["cmix"], h2, x_prev=cache["xprev_c"], return_state=True)
        x = x + cout
    else:
        x = x + L.mlp(params["mlp"], h2, cfg.activation)
    return x, new_cache


def decode_step(params: Params, cfg, tokens: torch.Tensor, pos: int,
                cache: Dict[str, torch.Tensor],
                dtype: torch.dtype = torch.bfloat16):
    """One-token decode. tokens: ``[B, 1]``; pos: an int (batch-synced).
    Updates ``cache`` (stacked ``[L, ...]``) in place and returns
    ``(logits [B, 1, V], cache)``."""
    x = params["embed"][tokens.long()].to(dtype)
    for i in range(cfg.num_layers):
        layer_cache = {name: c[i] for name, c in cache.items()}
        x, new = _block_decode(cfg, _layer(params, i), x, int(pos),
                               layer_cache)
        for name, value in new.items():
            if value is not layer_cache[name]:
                layer_cache[name].copy_(value)
    x = L.rmsnorm(params["ln_f"], x)
    return x @ params["lm_head"].to(dtype), cache


# ---------------------------------------------------------------------------
# the model as a module
# ---------------------------------------------------------------------------

class _ParamTree(torch.nn.Module):
    """A nested parameter dict as a module tree (``requires_grad=False``:
    the K7 kernel has no backward)."""

    def __init__(self, tree: Params):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _ParamTree(value))
            else:
                self.register_parameter(
                    name, torch.nn.Parameter(value, requires_grad=False))

    def tree(self) -> Params:
        out: Params = dict(self.named_parameters(recurse=False))
        out.update((name, child.tree())
                   for name, child in self.named_children())
        return out


class DecoderLM(torch.nn.Module):
    """A decoder LM holding its weights; its methods call :func:`forward`,
    :func:`prefill` and :func:`decode_step` on them.  Build with
    :meth:`from_config` (weights drawn from a generator) or from a
    parameter tree (e.g. ``interop.lm_params_from_arrays``)."""

    def __init__(self, cfg, params: Params):
        super().__init__()
        self.cfg = cfg
        self.weights = _ParamTree(params)

    @classmethod
    def from_config(cls, cfg, generator: torch.Generator, *, device=None,
                    dtype: Optional[torch.dtype] = None) -> "DecoderLM":
        """Weights from :func:`init_params`, cast once to ``dtype`` when
        given (float32 leaves only)."""
        params, _ = init_params(cfg, generator, device=device)
        if dtype is not None:
            params = cast_params(params, dtype)
        return cls(cfg, params)

    def params(self) -> Params:
        return self.weights.tree()

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.bfloat16):
        return forward(self.params(), self.cfg, tokens, prefix_embeds, dtype)

    def prefill(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.bfloat16,
                cache_len: Optional[int] = None):
        return prefill(self.params(), self.cfg, tokens, prefix_embeds, dtype,
                       cache_len)

    def decode_step(self, tokens: torch.Tensor, pos: int,
                    cache: Dict[str, torch.Tensor],
                    dtype: torch.dtype = torch.bfloat16):
        return decode_step(self.params(), self.cfg, tokens, pos, cache, dtype)

    def init_cache(self, batch: int, seq_len: int,
                   dtype: torch.dtype = torch.bfloat16):
        device = self.weights.tree()["embed"].device
        return init_cache(self.cfg, batch, seq_len, dtype, device=device)
