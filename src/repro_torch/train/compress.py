"""Int8 error-feedback gradient compression for the cross-pod reduction
(the reference's ``train/compress.py``).

Per-chunk symmetric int8 quantization of each gradient (2,048 values a
chunk, absmax / 127 scale, round half to even as ``jnp.round``) with an
error-feedback residual carried into the next step (Karimireddy et al.,
2019).  Here the quantize -> dequantize pair is the wire format a
compressed all-reduce would move.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.lm import tree_map

CHUNK = 2048  # quantization group size


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % CHUNK
    chunks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, CHUNK)
    scale = chunks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(chunks / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    size = 1
    for d in shape:
        size *= d
    return flat[:size].reshape(shape)


def compress_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """quantize -> dequantize (the wire format both pods agree on), float32
    shaped like ``g``."""
    q, s = _quantize(g.float())
    return _dequantize(q, s, g.shape)


def init_error_state(params):
    """Zero float32 residuals shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress(grads, error_state):
    """Error-feedback compression: ``(compressed_grads, new_error)`` with
    ``compressed = Q(g + e)`` and ``e' = (g + e) - compressed``."""
    def one(g, e):
        corrected = g.float() + e
        sent = compress_roundtrip(corrected)
        return sent, corrected - sent

    pairs = tree_map(lambda g, e: one(g, e), grads, error_state)
    return _split(pairs, 0), _split(pairs, 1)


def _split(tree, i):
    """Entry ``i`` of every (sent, error) leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    return tree[i]
