"""Serving: a one-token decode step over the KV cache, and sampling.

Decode sharding policy, as the reference's ``serve/decode.py``:

* the batch over the data-parallel axes when they divide it;
* KV heads over ``model`` when ``model`` divides them, else the cache's
  sequence axis over ``model`` (GLM-4-9B's 2 KV heads on a wider axis),
  where each rank's softmax over its slots needs the flash-decode combine
  (``models.layers.attention_decode``; GSPMD emits it in the reference);
* attention on this rank's block of query heads where ``model`` divides
  the KV heads (``models.layers.head_block``), else every query head
  against this rank's ring slots, ``wo`` on this rank's stored rows
  either way: no weight is gathered over ``model``;
* the SSM states as the reference places them (``wkv``'s K and hybrid
  ``h``'s inner width over ``model``); RWKV6's time mix runs on this
  rank's block of heads, ``wkv`` resharded to them around each layer's
  step (``models.lm.decode_step``), and its channel mix and Hymba's mamba
  heads on this rank's channels where ``model`` divides them
  (``models.lm._ssm_mesh``), ``h`` as stored;
* MoE layers expert-parallel over ``model``, their router statistics (and
  the ``capacity`` dispatch's ranks) over the rows of every batch shard
  (``models.moe``).

Every rank of the mesh calls the step with the same global tokens and
gets the same global logits.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import NamedSharding
from repro_torch.models.lm import (ATTENTION_FAMILIES, cache_shape,
                                   decode_step, init_cache)


def _data_axes(mesh, batch: int) -> tuple:
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    size = math.prod(mesh.shape[a] for a in axes)
    if axes and batch % size == 0 and batch >= size:
        return tuple(axes)
    return ()


def cache_pspecs(cfg, mesh, batch: int) -> Dict[str, tuple]:
    """Partition specs per cache leaf: ``[L, B, S, Hkv, hd]`` etc."""
    daxes = _data_axes(mesh, batch)
    b_ax = daxes if daxes else None
    tp = "model" if "model" in mesh.axis_names else None
    specs: Dict[str, tuple] = {}
    if cfg.family in ATTENTION_FAMILIES:
        # prefer sharding KV heads over TP (local ring updates); fall back
        # to the sequence axis when kv_heads < TP width (e.g. glm4's kv=2)
        tp_width = mesh.shape.get("model", 1) if tp else 1
        if tp and cfg.num_kv_heads % tp_width == 0:
            specs["k"] = (None, b_ax, None, tp, None)
            specs["v"] = (None, b_ax, None, tp, None)
        else:
            specs["k"] = (None, b_ax, tp, None, None)
            specs["v"] = (None, b_ax, tp, None, None)
    if cfg.family == "ssm":
        # [L, B, H, K, V]: H (e.g. 40) need not divide TP; shard K instead
        specs["wkv"] = (None, b_ax, None, tp, None)
        specs["xprev_t"] = (None, b_ax, None, None)
        specs["xprev_c"] = (None, b_ax, None, None)
    if cfg.family == "hybrid":
        specs["h"] = (None, b_ax, tp, None)             # d_inner over TP
    return specs


def make_serve_step(cfg, mesh=None, *, batch: int, seq_len: int,
                    dtype: torch.dtype = torch.bfloat16, device=None
                    ) -> Tuple[Callable, Any, Any, Dict[str, torch.Tensor]]:
    """``(step, param_sh, cache_sh, cache)``: ``step(params, tokens [B,1],
    pos, cache) -> (logits [B, 1, V], cache)`` (the cache is updated in
    place; no autograd graph is recorded, even for weights that require
    grad) and a zeroed cache of ``seq_len`` positions.

    Without a mesh ``param_sh`` and ``cache_sh`` are ``None`` and the cache
    lies on ``device`` (``None``: the card).  On ``mesh`` (an
    :class:`~repro_torch.launch.mesh.LMMesh`) they are the placements of
    the parameters (``train.step.shard_tree`` cuts a full tree by them) and
    of the cache, the cache is this rank's blocks on the mesh's device,
    and every rank calls ``step`` with the global tokens.  Attention, the
    MLP and the SSM blocks run tensor-parallel over ``model`` (attention
    and RWKV6's time mix on this rank's block of heads, for any head
    count; the channel mix and mamba whole, their weights gathered each
    step, where ``model`` does not divide their channels), MoE layers
    expert-parallel."""
    if mesh is None:
        cache = init_cache(cfg, batch, seq_len, dtype, device=device)

        @torch.no_grad()
        def step(params, tokens, pos, cache):
            return decode_step(params, cfg, tokens, pos, cache, dtype=dtype)

        return step, None, None, cache

    from repro_torch.train.step import param_specs, shardings_for

    daxes = _data_axes(mesh, batch)
    param_sh = shardings_for(mesh, param_specs(cfg))
    cache_sh = shardings_for(mesh, cache_pspecs(cfg, mesh, batch))
    tok_sh = NamedSharding(mesh, (daxes if daxes else None, None))
    cache = {name: torch.zeros(cache_sh[name].local_shape(shape),
                               dtype=dt, device=mesh.device)
             for name, (shape, dt) in cache_shape(cfg, batch, seq_len,
                                                  dtype).items()}

    @torch.no_grad()
    def step(params, tokens, pos, cache):
        logits, cache = decode_step(params, cfg, tok_sh.shard(tokens), pos,
                                    cache, dtype=dtype, mesh=mesh,
                                    cache_sh=cache_sh)
        return tok_sh.gather(logits), cache

    return step, param_sh, cache_sh, cache


def sample_logits(generator: Optional[torch.Generator], logits: torch.Tensor,
                  temperature: float = 1.0,
                  vocab_size: Optional[int] = None) -> torch.Tensor:
    """Greedy (T=0) or temperature sampling. logits: ``[B, 1, V]`` ->
    int32 ``[B, 1]``.

    ``vocab_size`` masks the vocab-padding columns to ``-inf`` so that
    neither argmax nor sampling can emit an out-of-vocab id.  Sampling
    draws from ``generator`` (on the logits' device); its stream is not the
    reference's ``jax.random`` one.
    """
    last = logits[:, -1].float()
    if vocab_size is not None and vocab_size < last.shape[-1]:
        keep = torch.arange(last.shape[-1], device=last.device) < vocab_size
        last = torch.where(keep, last, torch.tensor(float("-inf"),
                                                    device=last.device))
    if temperature == 0.0:
        return torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    probs = torch.softmax(last / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


@torch.no_grad()
def generate(params, cfg, prompt: torch.Tensor, *, steps: int, cache,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0,
             dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, Any]:
    """Simple autoregressive loop (the prompt fed through repeated decode
    steps, no autograd graph) for tests and examples.  Returns ``(tokens [B, steps], cache)``;
    ``steps=0`` gives ``[B, 0]``."""
    b, plen = prompt.shape
    out = []
    tok = prompt[:, :1]
    for t in range(plen + steps - 1):
        logits, cache = decode_step(params, cfg, tok, t, cache, dtype=dtype)
        if t + 1 < plen:
            tok = prompt[:, t + 1:t + 2]
        else:
            tok = sample_logits(generator, logits, temperature,
                                vocab_size=cfg.vocab_size)
            out.append(tok)
    if not out:  # steps == 0: nothing sampled, [B, 0] keeps callers total
        return torch.zeros((b, 0), dtype=torch.int32,
                           device=prompt.device), cache
    return torch.cat(out, dim=1), cache
