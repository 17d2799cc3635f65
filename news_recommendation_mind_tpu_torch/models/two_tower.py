"""The deduplicated forward and the training loss shared by the news-tower
model families.

The port of ``forward_from_unique`` and ``train_loss``
(news_recommendation_mind_tpu/models/two_tower.py:87-131). The ``TwoTower``
module itself comes with the TwoTower slice; ``PLM`` has the same duck
type (``encode_news``, ``encode_user_from_reprs``, ``compute_score``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Batch = Dict[str, torch.Tensor]


def take_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` along axis 0 with out-of-range indices clamped, as
    ``jnp.take(..., mode="clip")`` clamps them (torch indexing would
    raise, or fault on the card)."""
    return table[index.long().clamp(0, table.shape[0] - 1)]


def forward_from_unique(mdl, batch: Batch, deterministic: bool = True,
                        seed: int = 0) -> torch.Tensor:
    """Forward pass over batch-deduplicated news → scores [B, C].

    The host loader emits the batch's unique news (``uniq_token`` /
    ``uniq_attn`` [U, S]) plus per-slot indices (``cdd_pos`` [B, C],
    ``his_pos`` [B, N] into U); this encodes U articles instead of
    B·(C+N) and gathers representations per slot. Mathematically identical
    to the plain forward (the gather's backward sums duplicate-slot
    gradients); the one behavioural difference is that encoder dropout is
    shared across duplicate occurrences.
    """
    reprs = mdl.encode_news(batch["uniq_token"][None],
                            batch["uniq_attn"][None],
                            deterministic, seed)[0]          # [U, H]
    cdd_repr = take_rows(reprs, batch["cdd_pos"])
    his_repr = take_rows(reprs, batch["his_pos"])
    user_repr = mdl.encode_user_from_reprs(his_repr, batch["his_mask"],
                                           batch.get("user_id"))
    return mdl.compute_score(cdd_repr, user_repr)


def train_loss(scores: torch.Tensor, label: torch.Tensor,
               cdd_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-impression sampled-softmax cross-entropy.

    scores [B, C], label [B] = index of the positive candidate, cdd_mask
    [B, C] marks real (non-padded) candidates, which alone enter the
    partition function (padded ones are set to −1e9).
    """
    if cdd_mask is not None:
        scores = torch.where(cdd_mask > 0, scores,
                             torch.full_like(scores, -1e9))
    logp = F.log_softmax(scores, dim=-1)
    nll = -torch.gather(logp, 1, label.long()[:, None])[:, 0]
    return nll.mean()
