"""PLM model family: a BERT-style encoder as the news encoder.

The port of news_recommendation_mind_tpu/models/plm.py:25-89 for serving:
``encode_news`` pushes [B, N, S] articles through the encoder as one
[B·N, S] batch and returns the pooled outputs, ``encode_user_from_reprs``
runs the user encoder over history reprs taken from the news table, and
``compute_score`` is the scaled dot product. The live training forward
comes with the training slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .bert import BertModel


class PLM(nn.Module):
    """PLM news encoder + configurable user encoder."""

    def __init__(self, bert: BertModel, user_encoder: nn.Module,
                 hidden_dim: int, debias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bert = bert
        self.user_encoder = user_encoder
        self.hidden_dim = hidden_dim
        self.debias = debias
        if debias:
            # flax xavier_normal on [1, H]
            std = math.sqrt(2.0 / (1 + hidden_dim))
            self.user_bias = nn.Parameter(torch.empty(1, hidden_dim).normal_(
                0.0, std, generator=generator))

    def encode_news(self, tokens: torch.Tensor,
                    attn_mask: torch.Tensor) -> torch.Tensor:
        """[B, N, S] → [B, N, H] pooled encoder outputs."""
        B, N, S = tokens.shape
        _, pooled = self.bert(tokens.reshape(B * N, S),
                              attn_mask.reshape(B * N, S))
        return pooled.reshape(B, N, self.hidden_dim)

    def encode_user_from_reprs(self, his_repr: torch.Tensor,
                               his_mask: torch.Tensor,
                               user_id: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        """History reprs [B, N, H] from the news table → user [B, 1, H]."""
        user_repr = self.user_encoder(his_repr, his_mask=his_mask,
                                      user_id=user_id)
        if not self.debias:
            return user_repr
        return user_repr + self.user_bias.to(user_repr.dtype)[None]

    def compute_score(self, cdd_repr: torch.Tensor,
                      user_repr: torch.Tensor) -> torch.Tensor:
        """[B, C, H] · [B, 1, H] → [B, C] logits, / √H in the candidates'
        dtype; mixed dtypes promote, as jnp.einsum promotes them."""
        dt = torch.promote_types(cdd_repr.dtype, user_repr.dtype)
        d = torch.tensor(cdd_repr.shape[-1], dtype=cdd_repr.dtype,
                         device=cdd_repr.device)
        return torch.einsum("bch,buh->bc", cdd_repr.to(dt),
                            user_repr.to(dt)) / torch.sqrt(d)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "the PLM training forward comes with the training slice")
