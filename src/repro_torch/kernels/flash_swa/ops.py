"""Public wrappers: GQA-aware banded SWA flash attention."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_swa import kernel as _kernel


def flash_swa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int, qc: int = 256) -> torch.Tensor:
    """Causal sliding-window attention, q/k/v ``[B, S, H, hd]`` with the
    same head count: the reference's entry for that case, kept so its
    callers port unchanged.  It refuses GQA, as the reference's kernel
    does; :func:`flash_swa_gqa` takes both."""
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_swa takes as many KV heads as query heads "
                         f"({k.shape[2]} vs {q.shape[2]}); use "
                         f"flash_swa_gqa")
    return flash_swa_gqa(q, k, v, window=window, qc=qc)


def flash_swa_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, qc: int = 256) -> torch.Tensor:
    """GQA: q ``[B,S,H,hd]``, k/v ``[B,S,Hkv,hd]`` with ``H % Hkv == 0``.
    The kernel reads KV head ``h // (H // Hkv)`` for query head ``h``; no
    repeated copy of k/v is made (the reference repeats before its
    kernel)."""
    return _kernel.flash_swa(q.contiguous(), k.contiguous(), v.contiguous(),
                             window=window, qc=qc)
