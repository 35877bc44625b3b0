"""The pieces of the reference's ``models/layers.py`` that the MoE layer
uses: the sharding axis names, the sharding pin (the identity until the
port shards), the dtype casts at the dense matmuls, and the uniform
initialiser.  The rest of the module (norms, RoPE, attention, MLPs) comes
with the LM slice."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

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
    to ``device`` (``None``: where the generator is)."""
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
