"""Experiment wiring: build the configured model and its train loader.

The port of ``DataBundle``, ``build_model`` and ``build_train_loader``
(news_recommendation_mind_tpu/experiment.py:40-46, 129-158, 355-373) for
``model="plm"``; the TwoTower and XFormer families come with their slices,
``build_data`` (tsv parsing, tokenizers) and the HF weight loaders with
theirs, so a caller fills the ``DataBundle`` itself and a model starts
from its seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .config import Config
from .data.cache import Behaviors, NewsCache
from .data.loader import TrainLoader
from .device import DeviceLike, resolve_device
from .models.bert import BertModel, bert_variant
from .models.plm import PLM
from .models.user_encoders import make_user_encoder


def build_model(cfg: Config, vocab_size: int,
                device: DeviceLike = "cuda") -> PLM:
    """The PLM of ``cfg``, freshly initialised from ``cfg.seed``, in eval
    mode on ``device``."""
    dev = resolve_device(device)
    if cfg.model != "plm":
        raise NotImplementedError(
            f"model family {cfg.model} comes with a later slice")
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    variant = bert_variant(cfg.bert, vocab_size=vocab_size,
                           num_layers=cfg.bert_layers or None)
    if cfg.bert_dim != 768 and cfg.bert_dim != variant.hidden_size:
        # width override (--bert-dim): scale FFN and heads with it
        variant = variant.replace(hidden_size=cfg.bert_dim,
                                  intermediate_size=4 * cfg.bert_dim,
                                  num_heads=cfg.head_num)
    g = torch.Generator().manual_seed(cfg.seed)
    bert = BertModel(variant, dtype=dtype, generator=g)
    user_enc = make_user_encoder(cfg.encoderU,
                                 hidden_dim=variant.hidden_size,
                                 dtype=dtype, generator=g)
    model = PLM(bert, user_enc, hidden_dim=variant.hidden_size,
                debias=cfg.debias, generator=g)
    return model.to(dev).eval()


@dataclass
class DataBundle:
    tokenizer: object
    news: Dict[str, NewsCache]          # per split
    behaviors: Dict[str, Behaviors]     # per split
    user_num: int
    vocab_size: int


def build_train_loader(cfg: Config, data: DataBundle,
                       emit_tokens: Optional[bool] = None) -> TrainLoader:
    if emit_tokens is None:
        emit_tokens = not cfg.device_gather
    # news-level dedup applies to the news-tower families
    dedup = cfg.dedup_news and cfg.model in ("twotower", "plm")
    return TrainLoader(
        data.news["train"], data.behaviors["train"],
        batch_size=cfg.batch_size, npratio=cfg.npratio,
        his_size=cfg.his_size, signal_length=cfg.signal_length,
        shuffle_pos=cfg.shuffle_pos, descend_history=cfg.descend_history,
        seed=cfg.seed,
        emit_tokens=emit_tokens, dedup=dedup)
