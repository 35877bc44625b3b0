"""Full-materialisation oracle for the banded SWA flash kernel."""
from __future__ import annotations

import torch


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int) -> torch.Tensor:
    """Causal SWA over the whole ``[S, S]`` score matrix. q/k/v:
    ``[B, S, H, hd]``; positions 0..S-1; out in ``q.dtype``."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
