"""Experiment configuration: the frozen ``Config`` dataclass.

The port's own copy of the JAX package's ``Config``
(news_recommendation_mind_tpu/config.py:20-157), trimmed to the fields
the ported slices read; each later slice adds the fields it reads, with
the JAX package's names and defaults. The command-line parser comes with
the CLI slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class Config:
    model: str = "twotower"          # twotower | plm | xformer

    # ---- data --------------------------------------------------------------
    signal_length: int = 30          # tokens kept per article at load
    his_size: int = 50               # history length

    # ---- model dimensions ---------------------------------------------------
    encoderU: str = "lstm"           # lstm | gru | lstur | mha | attn | avg
    bert_dim: int = 768
    head_num: int = 12
    vocab_size: int = 30522          # set from tokenizer at data build
    bert: str = "bert"               # PLM variant for plm/xformer models
    bert_layers: int = 0             # override PLM depth (0 = variant default)
    debias: bool = False             # learned per-user bias on user repr

    # ---- execution ----------------------------------------------------------
    batch_size_news: int = 500       # news-encoding batch (table sweep)
    seed: int = 42
    dtype: str = "bfloat16"          # compute dtype (params stay float32)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)
