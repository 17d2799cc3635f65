"""Fixed-shape host batchers.

The port's own copies of ``_pad_histories``, ``TrainLoader``,
``NewsLoader``, ``_bucket_for`` and ``ensure_tokens``
(news_recommendation_mind_tpu/data/loader.py:36-309, 430-441), with the
numpy batch assembly only: the native C++ batcher, the eval and history
loaders come with later slices. Every batch a loader emits has a static
shape per loader (the dedup pool width takes one of a few bucket widths).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Sequence

import numpy as np

from .cache import Behaviors, NewsCache

Batch = Dict[str, np.ndarray]


def _pad_histories(behaviors: Behaviors, his_size: int, descend: bool,
                   chunk: int = 1 << 20):
    """Vectorized history truncate/pad: returns ids [n, his_size] int32 and
    mask [n, his_size] float32 (empty history gets mask[0]=1).

    Ragged→dense numpy pass with no per-row Python loop, processed in row
    chunks so the index temporaries stay bounded. Each row i takes its
    first min(len, his_size) history ids (reversed when ``descend``:
    truncate, then reverse)."""
    n = len(behaviors)
    offs = behaviors.his_offsets
    flat = behaviors.his_flat
    ids = np.zeros((n, his_size), dtype=np.int32)
    mask = np.zeros((n, his_size), dtype=np.float32)
    col = np.arange(his_size, dtype=np.int32)[None, :]         # [1, his]
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        lens = np.minimum(np.diff(offs[s:e + 1]),
                          his_size).astype(np.int32)           # [m]
        valid = col < lens[:, None]                            # [m, his]
        base = offs[s:e, None].astype(np.int64)
        if descend:
            src = base + (lens[:, None] - 1 - col)
        else:
            src = base + col
        src = np.where(valid, src, 0)
        if flat.size:
            np.copyto(ids[s:e], np.where(valid, flat[src], 0),
                      casting="unsafe")
        mask[s:e] = col < np.maximum(lens, 1)[:, None]
    return ids, mask


class TrainLoader:
    """Iterable over fixed-shape training batches.

    Batch keys:
      user_id [bs], cdd_id [bs,cdd], his_id [bs,his],
      cdd_token/cdd_attn [bs,cdd,sl], his_token/his_attn [bs,his,sl],
      cdd_mask [bs,cdd], his_mask [bs,his], label [bs].
    """

    def __init__(self, news: NewsCache, behaviors: Behaviors, *,
                 batch_size: int, npratio: int, his_size: int,
                 signal_length: int, shuffle_pos: bool = False,
                 descend_history: bool = False, seed: int = 42,
                 drop_last: bool = True, emit_tokens: bool = True,
                 dedup: bool = False):
        if behaviors.mode != "train":
            raise ValueError(f"TrainLoader takes train behaviors, "
                             f"got {behaviors.mode}")
        # emit_tokens=False: device-gather mode — batches carry ids only;
        # the token table lives on the device and the train step gathers
        # there (see train/step.py news_table)
        self.emit_tokens = emit_tokens
        # dedup: additionally emit the batch's unique news ids plus
        # per-slot indices so the device encodes each distinct article
        # once (models/two_tower.py forward_from_unique); ids-only mode
        self.dedup = dedup and not emit_tokens
        self.news_tokens, self.news_attn = news.truncated(signal_length)
        self.news_attn = self.news_attn.astype(np.float32)
        self.b = behaviors
        self.batch_size = batch_size
        self.npratio = npratio
        self.cdd_size = npratio + 1
        self.shuffle_pos = shuffle_pos
        self.seed = seed
        self.drop_last = drop_last
        self.his_ids, self.his_mask = _pad_histories(
            behaviors, his_size, descend_history)
        self.n = len(behaviors)
        self.epoch = 0
        if self.dedup:
            # static unique-pool width: a batch can't contain more
            # distinct news than slots or than the corpus
            cap = min(self.news_tokens.shape[0],
                      batch_size * (self.cdd_size + his_size))
            self.u_pad = -(-cap // 256) * 256
            # bucketed padding: batches usually touch far fewer distinct
            # articles than the cap (popularity skew), and the news tower
            # pays for every padded row — quantise to at most 8 bucket
            # widths
            self.u_quantum = max(256, -(-self.u_pad // 8 // 256) * 256)

    def _dedupify(self, batch: Batch) -> Batch:
        """ids-only batch → + uniq_id [U_pad], cdd_pos/his_pos (see
        forward_from_unique), by per-batch np.unique (sorted order).
        Padding id 0 maps extra rows to the pad article; duplicate pad
        rows only add masked work. uniq_id[cdd_pos] == cdd_id."""
        cdd, his = batch["cdd_id"], batch["his_id"]
        ids = np.concatenate([cdd.ravel(), his.ravel()])
        uniq, inv = np.unique(ids, return_inverse=True)
        if len(uniq) > self.u_pad:      # can't happen by construction
            return batch
        width = min(self.u_pad,
                    -(-len(uniq) // self.u_quantum) * self.u_quantum)
        uniq_pad = np.zeros(width, np.int32)
        uniq_pad[:len(uniq)] = uniq
        out = dict(batch)
        out["uniq_id"] = uniq_pad
        out["cdd_pos"] = inv[:cdd.size].reshape(cdd.shape).astype(np.int32)
        out["his_pos"] = inv[cdd.size:].reshape(his.shape).astype(np.int32)
        return out

    def __len__(self) -> int:
        return self.n // self.batch_size if self.drop_last else \
            math.ceil(self.n / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _sample_negatives(self, idx: np.ndarray,
                          rng: np.random.Generator) -> tuple:
        """Without replacement, zero-pad short pools. Returns
        (neg_ids [bs,npratio], neg_num [bs])."""
        bs = len(idx)
        neg = np.zeros((bs, self.npratio), dtype=np.int32)
        neg_num = np.zeros(bs, dtype=np.int32)
        offs = self.b.neg_offsets
        flat = self.b.neg_flat
        for i, s in enumerate(idx):
            pool = flat[offs[s]:offs[s + 1]]
            k = len(pool)
            if k <= self.npratio:
                neg[i, :k] = pool
                neg_num[i] = k
            else:
                pick = rng.choice(k, size=self.npratio, replace=False)
                neg[i] = pool[pick]
                neg_num[i] = self.npratio
        return neg, neg_num

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed + 1000 * self.epoch)
        order = rng.permutation(self.n)
        nb = len(order) // self.batch_size if self.drop_last else \
            math.ceil(len(order) / self.batch_size)
        for bi in range(nb):
            idx = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            batch = self._make_batch(idx, rng)
            if not self.emit_tokens:
                for k in ("cdd_token", "cdd_attn", "his_token", "his_attn"):
                    del batch[k]
            yield self._dedupify(batch) if self.dedup else batch

    def _make_batch(self, idx: np.ndarray, rng: np.random.Generator) -> Batch:
        bs = len(idx)
        neg, neg_num = self._sample_negatives(idx, rng)
        cdd_ids = np.concatenate(
            [self.b.pos[idx, None], neg], axis=1)          # [bs, cdd]
        label = np.zeros(bs, dtype=np.int32)               # positive at col 0
        cdd_mask = (np.arange(self.cdd_size)[None, :]
                    <= neg_num[:, None]).astype(np.float32)
        if self.shuffle_pos:
            # per-row candidate permutation; label follows the positive
            perm = np.argsort(rng.random((bs, self.cdd_size)), axis=1)
            rows = np.arange(bs)[:, None]
            cdd_ids = cdd_ids[rows, perm]
            cdd_mask = cdd_mask[rows, perm]
            label = np.argmax(perm == 0, axis=1).astype(np.int32)
        his_ids = self.his_ids[idx]
        return {
            "user_id": self.b.uindex[idx],
            "cdd_id": cdd_ids,
            "his_id": his_ids,
            "cdd_token": self.news_tokens[cdd_ids],
            "cdd_attn": self.news_attn[cdd_ids],
            "his_token": self.news_tokens[his_ids],
            "his_attn": self.news_attn[his_ids],
            "cdd_mask": cdd_mask,
            "his_mask": self.his_mask[idx],
            "label": label,
        }


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


def ensure_tokens(batch: Batch, loader: TrainLoader) -> Batch:
    """Host-side token gather for an ids-only batch (device-gather mode);
    used where a token-ful batch is needed once."""
    if "cdd_token" in batch:
        return batch
    batch = dict(batch)
    batch["cdd_token"] = loader.news_tokens[batch["cdd_id"]]
    batch["cdd_attn"] = loader.news_attn[batch["cdd_id"]]
    batch["his_token"] = loader.news_tokens[batch["his_id"]]
    batch["his_attn"] = loader.news_attn[batch["his_id"]]
    return batch
