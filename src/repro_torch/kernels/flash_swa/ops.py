"""Public wrappers: GQA-aware banded SWA flash attention, with its gradient.

Both entries go through :class:`BandedAttention` whenever autograd will
need a gradient (grad mode on and an input that requires grad): its
forward launches K7 with the row log-sum-exp, its backward the K7
backward kernel (on the CPU, their plain versions).  Otherwise they call
the forward alone, which writes no log-sum-exp, as serving does.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_swa import kernel as _kernel


class BandedAttention(torch.autograd.Function):
    """``flash_swa`` as an autograd function: the forward saves ``q, k, v,
    out`` and the row log-sum-exp; the backward returns ``(dq, dk, dv)``
    from :func:`kernel.flash_swa_bwd`.  Under non-reentrant checkpointing
    the saved tensors are those of the recomputed forward."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, qc: int):
        out, lse = _kernel.flash_swa(q, k, v, window=window, qc=qc,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.qc = window, qc
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _kernel.flash_swa_bwd(q, k, v, out, lse,
                                           dout.contiguous(),
                                           window=ctx.window, qc=ctx.qc)
        return dq, dk, dv, None, None


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
    kernel).  Differentiable in q, k and v."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return BandedAttention.apply(q, k, v, window, qc)
    return _kernel.flash_swa(q, k, v, window=window, qc=qc)
