"""Synthetic language-model batches: a batch is a pure function of
``(seed, step)``.

A copy of ``repro_torch.data.synthetic.batch_at`` (the benchmark makes its
own inputs): Zipf-ish token ids from the inverse CDF of uniforms, document
boundaries with probability ``1 / mean_doc_len`` a position, and the label
across a boundary and the last label of each row set to -1.  Drawn from a
CPU generator seeded from ``(seed, step)`` alone, then moved to the device.
"""
from __future__ import annotations

from typing import Dict

import torch


def _generator(seed: int, step: int) -> torch.Generator:
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9
             + 0x94D049BB133111EB) % (1 << 63)
    return torch.Generator().manual_seed(mixed)


def batch_at(seed: int, step: int, *, batch: int, seq_len: int, vocab: int,
             mean_doc_len: int, zipf_alpha: float,
             device) -> Dict[str, torch.Tensor]:
    """``tokens``/``labels`` int32 ``[batch, seq_len]`` on ``device``."""
    gen = _generator(seed, step)
    u = torch.rand((batch, seq_len), generator=gen) * (1.0 - 1e-6) + 1e-6
    ids = torch.floor(torch.exp(torch.log(u) / (1.0 - zipf_alpha))) - 1.0
    tokens = torch.clamp(ids, 0, vocab - 1).to(torch.int32)
    boundary = torch.rand((batch, seq_len), generator=gen) < (
        1.0 / mean_doc_len)
    labels = torch.where(boundary[:, 1:], -1, tokens[:, 1:])
    labels = torch.cat([labels, torch.full((batch, 1), -1,
                                           dtype=torch.int32)],
                       dim=1).to(torch.int32)
    return {"tokens": tokens.to(device), "labels": labels.to(device)}
