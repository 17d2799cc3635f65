"""Tokenized news table with row 0 as the all-pad article, and the parsed
behaviors of one split.

The port's own copies of ``NewsCache`` and ``Behaviors``
(news_recommendation_mind_tpu/data/cache.py:60-86, 156-194). Parsing
``news.tsv`` / ``behaviors.tsv`` and building the caches with a tokenizer
come with a later slice; a caller builds the arrays itself.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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


@dataclasses.dataclass
class Behaviors:
    """Parsed behaviors for one split.

    train mode (one record per positive click):
      pos[i], impr_idx[i], uindex[i], his_flat/his_offsets (ragged history,
      most-recent-last as in the file), neg_flat/neg_offsets (per-record
      negative pool — shared across records of the same impression).
    dev/test mode (impression chunks of <= impr_size candidates):
      impr_idx[j], uindex[j], his_* ragged per chunk, cdd_flat/cdd_offsets,
      labels_flat (dev only).
    """
    mode: str
    impr_idx: np.ndarray
    uindex: np.ndarray
    his_flat: np.ndarray
    his_offsets: np.ndarray
    pos: Optional[np.ndarray] = None
    neg_flat: Optional[np.ndarray] = None
    neg_offsets: Optional[np.ndarray] = None
    cdd_flat: Optional[np.ndarray] = None
    cdd_offsets: Optional[np.ndarray] = None
    labels_flat: Optional[np.ndarray] = None
    uid2idx: Optional[Dict[str, int]] = None

    def __len__(self) -> int:
        return len(self.impr_idx)

    def history(self, i: int) -> np.ndarray:
        return self.his_flat[self.his_offsets[i]:self.his_offsets[i + 1]]

    def negatives(self, i: int) -> np.ndarray:
        return self.neg_flat[self.neg_offsets[i]:self.neg_offsets[i + 1]]
