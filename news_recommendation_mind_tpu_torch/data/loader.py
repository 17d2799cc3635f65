"""Fixed-shape host batchers.

The port's own copy of ``NewsLoader`` and ``_bucket_for``
(news_recommendation_mind_tpu/data/loader.py:262-309). The train, eval
and history loaders come with the training slice.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Sequence

import numpy as np

from .cache import NewsCache

Batch = Dict[str, np.ndarray]


class NewsLoader:
    """Fixed-shape sweep over the whole news table (row 0 included).

    Emits {news_id [bs], token [bs,sl], attn [bs,sl], valid [bs]}; the last
    batch is padded with row 0 and masked via `valid`.
    """

    def __init__(self, news: NewsCache, *, batch_size: int,
                 signal_length: int):
        self.tokens, self.attn = news.truncated(signal_length)
        self.attn = self.attn.astype(np.float32)
        self.batch_size = batch_size
        self.n = self.tokens.shape[0]

    def __len__(self) -> int:
        return math.ceil(self.n / self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        for s in range(0, self.n, self.batch_size):
            ids = np.arange(s, min(s + self.batch_size, self.n),
                            dtype=np.int32)
            pad = self.batch_size - len(ids)
            valid = np.concatenate([np.ones(len(ids), np.float32),
                                    np.zeros(pad, np.float32)])
            ids = np.concatenate([ids, np.zeros(pad, np.int32)])
            yield {"news_id": ids, "token": self.tokens[ids],
                   "attn": self.attn[ids], "valid": valid}


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
