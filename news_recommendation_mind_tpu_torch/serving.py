"""Online serving: an encoded news table → low-latency scoring.

The port of ``Recommender`` (news_recommendation_mind_tpu/serving.py:
28-171): the news table is encoded once at construction, candidate and
history representations are table lookups, and only the user encoder runs
per request. Candidate lists are padded to bucket widths as in the JAX
package, so each request shape is one of a few fixed ones.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .data.cache import NewsCache
from .data.loader import NewsLoader, _bucket_for
from .device import DeviceLike, resolve_device
from .evaluation.engine import encode_all_news
from .experiment import build_model
from .weights import jax_params_to_torch


class Recommender:
    """Serves rankings from the news table of one model.

    ``params`` is a flax parameter tree with numpy leaves (the JAX
    package's layout); None serves fresh parameters from ``cfg.seed``, as
    the JAX package does when it finds no checkpoint.
    """

    def __init__(self, cfg: Config, news: NewsCache, params=None,
                 buckets: Sequence[int] = (8, 32, 128, 512),
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.news = news
        self.nid2idx = news.nid2idx
        top = int(news.tokens.max()) if news.tokens.size else 0
        if top >= cfg.vocab_size:
            raise ValueError(f"news tokens hold id {top} >= vocab_size "
                             f"{cfg.vocab_size}")
        self.model = build_model(cfg, cfg.vocab_size, device=self.device)
        if params is not None:
            self.model.load_state_dict(jax_params_to_torch(params))
        self.hidden_dim = self.model.hidden_dim
        self.his_size = cfg.his_size
        self.buckets = sorted(buckets)
        news_loader = NewsLoader(news, batch_size=cfg.batch_size_news,
                                 signal_length=cfg.signal_length)
        self.table = encode_all_news(self.model, news_loader,
                                     self.hidden_dim, device=self.device)
        self.idx2nid = {v: k for k, v in self.nid2idx.items()}

    def _user(self, history_nids: Sequence[str],
              user_id: Optional[int]) -> torch.Tensor:
        """User repr [1, 1, H] from the first his_size history articles;
        an empty history attends to the pad row."""
        his = np.zeros(self.his_size, np.int64)
        his_mask = np.zeros(self.his_size, np.float32)
        kept = [self.nid2idx.get(n, 0) for n in history_nids][:self.his_size]
        his[:len(kept)] = kept
        his_mask[:max(len(kept), 1)] = 1.0
        dev = self.device
        his_repr = self.table[torch.from_numpy(his).to(dev)][None]
        uid = torch.tensor([user_id or 0], dtype=torch.int64, device=dev)
        return self.model.encode_user_from_reprs(
            his_repr, torch.from_numpy(his_mask).to(dev)[None], uid)

    def _scaled(self, logits: torch.Tensor) -> torch.Tensor:
        d = torch.tensor(self.hidden_dim, dtype=self.table.dtype,
                         device=self.device)
        return torch.sigmoid(logits / torch.sqrt(d))

    def score(self, history_nids: Sequence[str],
              candidate_nids: Sequence[str],
              user_id: Optional[int] = None) -> np.ndarray:
        """Click probabilities for candidates given a click history."""
        width = _bucket_for(len(candidate_nids), self.buckets)
        cdd = np.zeros(width, np.int64)
        ids = [self.nid2idx.get(n, 0) for n in candidate_nids]
        cdd[:len(ids)] = ids
        with torch.inference_mode():
            user = self._user(history_nids, user_id).float()      # [1,1,H]
            cdd_repr = self.table[torch.from_numpy(cdd).to(self.device)]
            scores = self._scaled(
                torch.einsum("bwh,buh->bw", cdd_repr[None], user))[0]
            return scores.cpu().numpy()[:len(candidate_nids)]

    def rank(self, history_nids: Sequence[str],
             candidate_nids: Sequence[str],
             user_id: Optional[int] = None,
             top_k: Optional[int] = None) -> List[Tuple[str, float]]:
        """Candidates sorted by click probability (descending)."""
        scores = self.score(history_nids, candidate_nids, user_id)
        order = np.argsort(-scores, kind="stable")
        ranked = [(candidate_nids[i], float(scores[i])) for i in order]
        return ranked[:top_k] if top_k else ranked

    def retrieve(self, history_nids: Sequence[str], k: int = 10,
                 user_id: Optional[int] = None,
                 exclude_history: bool = True) -> List[Tuple[str, float]]:
        """Candidate generation: top-k articles from the whole corpus, by
        the same scaled dot product + sigmoid as ``rank``."""
        # exclusion covers the FULL click history, not just the his_size
        # items the user encoder consumes
        skip = (set(self.nid2idx.get(n, 0) for n in history_nids) - {0}
                if exclude_history else set())
        n_real = self.table.shape[0] - 1
        with torch.inference_mode():
            user = self._user(history_nids, user_id).float()
            scores = self._scaled(
                torch.einsum("nh,buh->bn", self.table, user)[0])
            scores[0] = -torch.inf  # row 0 = pad article
            # over-fetch by his_size first; an exact width only when a
            # history longer than his_size exhausts the margin
            for fetch in (min(k + (self.his_size if exclude_history else 0),
                              n_real),
                          min(k + len(skip), n_real)):
                vals, idx = (t.cpu().numpy()
                             for t in torch.topk(scores, fetch))
                out = [(self.idx2nid.get(int(i), str(int(i))), float(v))
                       for i, v in zip(idx, vals) if int(i) not in skip]
                if len(out) >= k or fetch >= n_real:
                    break
        return out[:k]
