"""Serving: a one-token decode step over the KV cache, and sampling.

Single device: the reference's sharded step (``cache_pspecs``, the mesh's
batch and sequence axes) waits for the port's sharding.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.lm import decode_step, init_cache


def make_serve_step(cfg, *, batch: int, seq_len: int,
                    dtype: torch.dtype = torch.bfloat16, device=None
                    ) -> Tuple[Callable, Dict[str, torch.Tensor]]:
    """``(step, cache)``: ``step(params, tokens [B,1], pos, cache) ->
    (logits, cache)`` (the cache is updated in place) and a zeroed cache of
    ``seq_len`` positions on ``device`` (``None``: the card)."""
    cache = init_cache(cfg, batch, seq_len, dtype, device=device)

    def step(params, tokens, pos, cache):
        return decode_step(params, cfg, tokens, pos, cache, dtype=dtype)

    return step, cache


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


def generate(params, cfg, prompt: torch.Tensor, *, steps: int, cache,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0,
             dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, Any]:
    """Simple autoregressive loop (the prompt fed through repeated decode
    steps) for tests and examples.  Returns ``(tokens [B, steps], cache)``;
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
