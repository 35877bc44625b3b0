"""The port's one device rule: ``None`` means the card, and there is no
silent CPU fallback."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device=None`` -> ``cuda``; raise when a card is asked for and absent.

    Constructors and generators call this; functions that take tensors run
    on those tensors' device instead.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build on the "
            "CPU explicitly (the port never falls back on its own)")
    return dev


def as_int32(x, device=None) -> torch.Tensor:
    """A contiguous int32 tensor: tensors keep their device unless
    ``device`` is given; anything else lands on :func:`resolve_device`."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=torch.int32).contiguous()
    import numpy as np
    return torch.from_numpy(np.array(x, np.int32)).to(resolve_device(device))
