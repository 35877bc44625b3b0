"""Modality frontend STUBS, as in the reference: the transformer backbone is
the deliverable, and the frontends are precomputed embeddings.

* ``vision_stub`` (internvl2-1b) stands in for InternViT: ``frontend_len``
  patch embeddings at ``d_model``;
* ``audio_stub`` (musicgen-large) stands in for the EnCodec conditioning
  encoder: conditioning frame embeddings (the decoded stream is EnCodec
  tokens and goes through the normal embedding).
"""
from __future__ import annotations

import torch


def frontend_embed_shape(cfg, batch: int,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The frontend activations' stand-in: an empty ``[batch,
    frontend_len, d_model]`` tensor on the ``meta`` device (the
    reference's ``jax.ShapeDtypeStruct``; nothing is allocated)."""
    assert cfg.frontend is not None
    return torch.empty((batch, cfg.frontend_len, cfg.d_model), dtype=dtype,
                       device="meta")


def make_frontend_embeds(cfg, batch: int, generator: torch.Generator,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Random stand-in for precomputed frontend activations ``[batch,
    frontend_len, d_model]`` (tests), drawn from ``generator`` on its
    device."""
    sd = frontend_embed_shape(cfg, batch, dtype)
    return (torch.randn(sd.shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * 0.02).to(sd.dtype)
