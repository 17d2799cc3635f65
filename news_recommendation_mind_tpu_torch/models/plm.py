"""PLM model family: a BERT-style encoder as the news encoder.

The port of news_recommendation_mind_tpu/models/plm.py:25-89:
``encode_news`` pushes [B, N, S] articles through the encoder as one
[B·N, S] batch and returns the pooled outputs, ``encode_user`` encodes the
history articles live, ``encode_user_from_reprs`` runs the user encoder
over history reprs taken from the news table, ``compute_score`` is the
scaled dot product, and ``forward`` is the full training forward over a
batch dict. ``deterministic=False`` turns the encoder's dropouts on, drawn
from the 64-bit ``seed`` of the call.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.dropout_bits import fold_seed
from .bert import BertModel

Batch = Dict[str, torch.Tensor]


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

    def encode_news(self, tokens: torch.Tensor, attn_mask: torch.Tensor,
                    deterministic: bool = True, seed: int = 0
                    ) -> torch.Tensor:
        """[B, N, S] → [B, N, H] pooled encoder outputs."""
        B, N, S = tokens.shape
        _, pooled = self.bert(tokens.reshape(B * N, S),
                              attn_mask.reshape(B * N, S),
                              deterministic=deterministic, seed=seed)
        return pooled.reshape(B, N, self.hidden_dim)

    def _user_bias(self, user_repr: torch.Tensor) -> torch.Tensor:
        if not self.debias:
            return user_repr
        return user_repr + self.user_bias.to(user_repr.dtype)[None]

    def encode_user(self, his_tokens: torch.Tensor, his_attn: torch.Tensor,
                    his_mask: torch.Tensor,
                    user_id: Optional[torch.Tensor] = None,
                    deterministic: bool = True, seed: int = 0
                    ) -> torch.Tensor:
        """Live path: one encoder pass per history article, batched as
        [B·his, S]."""
        his_repr = self.encode_news(his_tokens, his_attn, deterministic,
                                    seed)
        return self._user_bias(self.user_encoder(
            his_repr, his_mask=his_mask, user_id=user_id))

    def encode_user_from_reprs(self, his_repr: torch.Tensor,
                               his_mask: torch.Tensor,
                               user_id: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        """History reprs [B, N, H] from the news table → user [B, 1, H]."""
        return self._user_bias(self.user_encoder(
            his_repr, his_mask=his_mask, user_id=user_id))

    def compute_score(self, cdd_repr: torch.Tensor,
                      user_repr: torch.Tensor) -> torch.Tensor:
        """[B, C, H] · [B, 1, H] → [B, C] logits, / √H in the candidates'
        dtype; mixed dtypes promote, as jnp.einsum promotes them."""
        dt = torch.promote_types(cdd_repr.dtype, user_repr.dtype)
        d = torch.tensor(cdd_repr.shape[-1], dtype=cdd_repr.dtype,
                         device=cdd_repr.device)
        return torch.einsum("bch,buh->bc", cdd_repr.to(dt),
                            user_repr.to(dt)) / torch.sqrt(d)

    def forward(self, batch: Batch, deterministic: bool = True,
                seed: int = 0) -> torch.Tensor:
        """Full forward: batch dict → scores [B, C] (pre-activation). The
        candidate pass and the history pass fold their own dropout seeds
        from ``seed``."""
        cdd_repr = self.encode_news(batch["cdd_token"], batch["cdd_attn"],
                                    deterministic, fold_seed(seed, 0))
        user_repr = self.encode_user(batch["his_token"], batch["his_attn"],
                                     batch["his_mask"], batch.get("user_id"),
                                     deterministic, fold_seed(seed, 1))
        return self.compute_score(cdd_repr, user_repr)
