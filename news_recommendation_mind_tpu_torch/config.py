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
    npratio: int = 4                 # negatives per positive (train)
    shuffle_pos: bool = False        # shuffle candidate positions in train
    descend_history: bool = False    # reverse history order

    # ---- model dimensions ---------------------------------------------------
    encoderU: str = "lstm"           # lstm | gru | lstur | mha | attn | avg
    bert_dim: int = 768
    head_num: int = 12
    vocab_size: int = 30522          # set from tokenizer at data build
    bert: str = "bert"               # PLM variant for plm/xformer models
    bert_layers: int = 0             # override PLM depth (0 = variant default)
    debias: bool = False             # learned per-user bias on user repr

    # ---- training -----------------------------------------------------------
    batch_size: int = 32
    batch_size_news: int = 500       # news-encoding batch (table sweep)
    epochs: int = 10
    lr: float = 1e-4
    bert_lr: float = 6e-6
    scheduler: str = "none"          # none | linear
    warmup: int = 100
    step_budget: int = 0             # optional hard cap on train steps (0 = off)
    checkpoint: int = 0              # resume-from step (-1 = newest)
    seed: int = 42
    interval: int = 10               # progress-log interval (steps)

    # ---- execution ----------------------------------------------------------
    dtype: str = "bfloat16"          # compute dtype (params stay float32)
    prefetch: int = 2                # host→device prefetch depth
    remat: bool = False              # recompute the forward in the backward
    fused_adam: bool = True          # one fused Adam launch over all leaves
                                     # (train/state.py optimizer_for)
    device_gather: bool = True       # keep the token table on the card,
                                     # ship ids only
    dedup_news: bool = True          # encode each distinct news once per
                                     # step (device_gather; plm)
    steps_per_call: int = 1          # fuse K train steps per device call
    grad_norm: bool = False          # report per-step global grad norm

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)
