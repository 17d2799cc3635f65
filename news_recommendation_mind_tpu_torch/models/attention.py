"""Attention primitives (news_recommendation_mind_tpu/models/attention.py:
24-58): the masked softmax every attention path shares, and the scaled
dot-product attention the pooling user encoders use."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def masked_softmax(scores: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis with a 0/1 mask: masked positions get
    exactly-zero probability, and fully-masked rows come out all-zero
    instead of NaN."""
    if mask is None:
        return torch.softmax(scores, dim=-1)
    mask = mask.to(scores.dtype)
    probs = torch.softmax(
        torch.where(mask > 0, scores, torch.full_like(scores, NEG_INF)),
        dim=-1)
    return probs * mask


def scaled_dp_attention(query: torch.Tensor, key: torch.Tensor,
                        value: torch.Tensor,
                        attn_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v with broadcastable leading dims.

    query [..., Q, D], key [..., K, D], value [..., K, V],
    attn_mask broadcastable to [..., Q, K]. √d is taken in the query's
    dtype, as the JAX package takes it.
    """
    d = torch.tensor(query.shape[-1], dtype=query.dtype, device=query.device)
    scores = torch.matmul(query, key.transpose(-1, -2)) / torch.sqrt(d)
    probs = masked_softmax(scores, attn_mask)
    return torch.matmul(probs, value)
