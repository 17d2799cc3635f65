"""Tokenized news table with row 0 as the all-pad article.

The port's own copy of ``NewsCache`` (news_recommendation_mind_tpu/
data/cache.py:60-86). Parsing ``news.tsv`` and building the cache with a
tokenizer come with a later slice; a caller builds the arrays itself.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class NewsCache:
    """Tokenized news table. Row 0 is the all-pad article."""
    tokens: np.ndarray       # [n_news+1, max_token_length] int32
    attn_mask: np.ndarray    # [n_news+1, max_token_length] uint8
    nid2idx: Dict[str, int]  # news id -> row (1-based; 0 = pad)
    sep_token_id: int

    def truncated(self, signal_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """Truncate to signal_length, forcing the last kept token to [SEP].

        Any article longer than signal_length gets its final kept position
        overwritten with [SEP]; shorter articles are untouched.
        """
        toks = self.tokens[:, :signal_length].copy()
        attn = self.attn_mask[:, :signal_length].copy()
        full = self.attn_mask[:, signal_length:].any(axis=1) if \
            self.attn_mask.shape[1] > signal_length else \
            np.zeros(len(toks), dtype=bool)
        toks[full, signal_length - 1] = self.sep_token_id
        return toks, attn
