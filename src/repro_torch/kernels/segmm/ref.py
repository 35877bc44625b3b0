"""Plain PyTorch oracles of the segmented matmul (the reference's
``segmm/ref.py``): every row times its own expert's matrix, in float32."""
from __future__ import annotations

import torch


def segmented_matmul_ref(lhs_padded: torch.Tensor, rhs: torch.Tensor,
                         block_expert: torch.Tensor, *,
                         bm: int) -> torch.Tensor:
    """Row-level oracle: every row multiplies its block's expert matrix
    (gathers an ``[M_pad, K, N]`` operand: small shapes only)."""
    m_pad = lhs_padded.shape[0]
    row_expert = torch.repeat_interleave(block_expert.long(), bm)[:m_pad]
    gathered = rhs[row_expert]
    return torch.einsum("mk,mkn->mn", lhs_padded.float(), gathered.float())


def grouped_matmul_ref(tokens: torch.Tensor, expert_of_token: torch.Tensor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """End-to-end oracle: ``out[t] = tokens[t] @ rhs[expert_of_token[t]]``."""
    return torch.einsum("tk,tkn->tn", tokens.float(),
                        rhs[expert_of_token.long()].float())
