"""User encoders: history news reprs [B, N, H] (+ his_mask [B, N],
user_id [B]) → user representation [B, 1, H].

The port of ``AttentionPooling`` and ``make_user_encoder``
(news_recommendation_mind_tpu/models/user_encoders.py:136-150, 171-184).
The recurrent, LSTUR, MHA and average encoders come with the TwoTower
slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .attention import scaled_dp_attention


class AttentionPooling(nn.Module):
    """Learned-query attention pooling over history reprs."""

    def __init__(self, hidden_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        # flax xavier_normal on [1, H]: fan_in 1, fan_out H
        std = math.sqrt(2.0 / (1 + hidden_dim))
        self.query_news = nn.Parameter(
            torch.empty(1, hidden_dim).normal_(0.0, std, generator=generator))

    def forward(self, news_repr: torch.Tensor,
                his_mask: Optional[torch.Tensor] = None,
                user_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        query = self.query_news.to(self.dtype)
        x = news_repr.to(self.dtype)
        pool_mask = his_mask[:, None, :] if his_mask is not None else None
        return scaled_dp_attention(query, x, x, pool_mask)


def make_user_encoder(name: str, *, hidden_dim: int,
                      dtype: torch.dtype = torch.float32,
                      generator: Optional[torch.Generator] = None
                      ) -> nn.Module:
    """Factory keyed by the --encoderU flag."""
    if name in ("attn", "attention"):
        return AttentionPooling(hidden_dim, dtype=dtype, generator=generator)
    if name in ("lstm", "gru", "lstur", "mha", "avg", "average"):
        raise NotImplementedError(
            f"user encoder {name} comes with the TwoTower slice")
    raise ValueError(f"unknown user encoder {name}")
