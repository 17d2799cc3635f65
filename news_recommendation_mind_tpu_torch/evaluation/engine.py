"""Phase 1 of fast evaluation: the news table sweep.

The port of ``encode_all_news`` (news_recommendation_mind_tpu/evaluation/
engine.py:36-59), single process. Impression scoring, slow eval and
metrics come with the training slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.loader import NewsLoader
from ..device import DeviceLike, resolve_device


def encode_all_news(model, news_loader: NewsLoader, hidden_dim: int,
                    device: DeviceLike = "cuda") -> torch.Tensor:
    """Encode every news article once → float32 [news_num+1, H] table on
    ``device``; the loader's padded rows (``valid`` = 0) are dropped."""
    dev = resolve_device(device)
    table = torch.zeros((news_loader.n, hidden_dim), dtype=torch.float32,
                        device=dev)
    with torch.inference_mode():
        for batch in news_loader:
            token = torch.from_numpy(batch["token"]).to(dev)
            attn = torch.from_numpy(batch["attn"]).to(dev)
            reprs = model.encode_news(token[:, None, :],
                                      attn[:, None, :])[:, 0, :]
            valid = np.flatnonzero(batch["valid"] > 0)
            rows = torch.from_numpy(batch["news_id"][valid]).to(dev).long()
            table[rows] = reprs[torch.from_numpy(valid).to(dev)].float()
    return table
