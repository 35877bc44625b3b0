"""Deterministic synthetic LM data: a batch is a pure function of ``(seed,
step)`` (the reference's ``data/synthetic.py``).

:func:`batch_at` draws from an explicit CPU ``torch.Generator`` seeded
from ``(seed, step)`` alone, then moves the batch to the device: a
restarted (or replaced) host regenerates exactly the batch it would have
seen, on any device.  Tokens are Zipf-ish ids (inverse CDF of uniforms);
document boundaries fall with probability ``1 / mean_doc_len`` a position,
and the label across a boundary, and the last label of each row, is -1.
The reference draws with ``jax.random``, so the two packages give other
numbers from the same seed, with the same distributions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 512
    global_batch: int = 8
    mean_doc_len: int = 256
    zipf_alpha: float = 1.1


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for ``(seed, step)``: the pair mixed into one 63-bit
    seed (splitmix64's multiplier), so neighbouring steps and seeds give
    unrelated streams."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9
             + 0x94D049BB133111EB) % (1 << 63)
    return torch.Generator().manual_seed(mixed)


def _zipf_tokens(gen: torch.Generator, shape, vocab: int,
                 alpha: float) -> torch.Tensor:
    """Zipf-ish ids via the inverse CDF of uniforms on [1e-6, 1)."""
    u = torch.rand(shape, generator=gen) * (1.0 - 1e-6) + 1e-6
    ids = torch.floor(torch.exp(torch.log(u) / (1.0 - alpha))) - 1.0
    return torch.clamp(ids, 0, vocab - 1).to(torch.int32)


def batch_at(cfg: DataConfig, step: int, model_cfg=None, *,
             device=None) -> Dict[str, torch.Tensor]:
    """Batch for ``step``: ``tokens``/``labels`` int32 ``[B, S]`` (and
    ``prefix_embeds`` float32 ``[B, frontend_len, d_model]`` for a model
    with a frontend), on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    gen = _generator(cfg.seed, step)
    b, s = cfg.global_batch, cfg.seq_len
    tokens = _zipf_tokens(gen, (b, s), cfg.vocab_size, cfg.zipf_alpha)
    # document boundaries (power-law lengths): mask loss across them
    boundary = torch.rand((b, s), generator=gen) < (1.0 / cfg.mean_doc_len)
    labels = torch.where(boundary[:, 1:], -1, tokens[:, 1:])
    labels = torch.cat([labels, torch.full((b, 1), -1, dtype=torch.int32)],
                       dim=1).to(torch.int32)
    batch = {"tokens": tokens, "labels": labels}
    if model_cfg is not None and model_cfg.frontend is not None:
        batch["prefix_embeds"] = 0.02 * torch.randn(
            (b, model_cfg.frontend_len, model_cfg.d_model), generator=gen)
    return {name: t.to(dev) for name, t in batch.items()}


def for_model(model_cfg, *, seq_len: int, global_batch: int,
              seed: int = 0) -> DataConfig:
    return DataConfig(seed=seed, vocab_size=model_cfg.vocab_size,
                      seq_len=seq_len, global_batch=global_batch)
