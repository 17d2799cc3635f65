"""Experiment wiring: build the configured model.

The port of ``build_model`` (news_recommendation_mind_tpu/experiment.py:
129-158) for ``model="plm"``; the TwoTower and XFormer families come with
their slices.
"""
from __future__ import annotations

import torch

from .config import Config
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
