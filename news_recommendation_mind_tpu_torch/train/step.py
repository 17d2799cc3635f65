"""The train step: token gather, forward, loss, backward, fused Adam.

The port of ``make_train_step`` (news_recommendation_mind_tpu/train/
step.py:23-149). There is no ``jit``, mesh or donation here: the step is
eager PyTorch on one device, and it updates the parameters and the Adam
moments in place (the JAX step returns a new state; this one returns the
same ``TrainState`` object, advanced). ``make_train_multistep`` and
``make_eval_score_fn`` come with a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..models.two_tower import forward_from_unique, take_rows, train_loss
from ..ops.dropout_bits import fold_seed
from .state import FusedAdam, TrainState

Batch = Dict[str, torch.Tensor]


def make_train_step(model: torch.nn.Module, optimizer: FusedAdam, *,
                    remat: bool = False,
                    news_table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                    with_grad_norm: bool = False,
                    device: DeviceLike = "cuda") -> Callable:
    """Build the train step: (state, batch, seed) → (state, metrics).

    ``batch`` holds tensors on ``device``; ``seed`` is the run's dropout
    seed, folded with ``state.step`` so dropout differs per step while the
    run stays reproducible from one seed. ``metrics["loss"]`` is a float32
    scalar tensor left on the device (reading it waits for the step).

    news_table: optional (tokens [n_news+1, sl], attn [n_news+1, sl])
    arrays. When given, they stay resident on the device, batches carry
    only candidate/history *ids*, and the token matrices are gathered
    there inside the step. A batch with ``uniq_id`` takes the dedup
    branch (each distinct article encoded once, ``forward_from_unique``).

    remat: recompute the forward during the backward instead of saving
    activations (``torch.utils.checkpoint``); the dropout masks are a
    function of (seed, coordinates), so the recomputation draws the same
    bits.
    """
    dev = resolve_device(device)
    derive_attn = False
    tok_table = attn_table = None
    if news_table is not None:
        tok_np = np.asarray(news_table[0])
        attn_np = np.asarray(news_table[1])
        # attention masks are usually exactly (token != PAD) thanks to the
        # cache's forced-final-SEP invariant; when that holds, gather only
        # tokens and derive masks on the device (half the gather traffic)
        derive_attn = bool(np.array_equal(attn_np > 0, tok_np != 0))
        tok_table = torch.from_numpy(np.ascontiguousarray(tok_np)).to(dev)
        if not derive_attn:
            attn_table = torch.from_numpy(
                attn_np.astype(np.float32)).to(dev)

    def gather(batch: Batch, ids: str, token: str, attn: str) -> None:
        batch[token] = take_rows(tok_table, batch[ids])
        if derive_attn:
            batch[attn] = (batch[token] != 0).float()
        else:
            batch[attn] = take_rows(attn_table, batch[ids])

    def step_fn(state: TrainState, batch: Batch, seed: int):
        dedup = "uniq_id" in batch and news_table is not None
        if news_table is not None:
            batch = dict(batch)
            if dedup:
                gather(batch, "uniq_id", "uniq_token", "uniq_attn")
            else:
                gather(batch, "cdd_id", "cdd_token", "cdd_attn")
                gather(batch, "his_id", "his_token", "his_attn")
        step_seed = fold_seed(seed, state.step)

        def forward():
            if dedup:
                return forward_from_unique(model, batch, False, step_seed)
            return model(batch, deterministic=False, seed=step_seed)

        scores = checkpoint(forward, use_reentrant=False) if remat \
            else forward()
        loss = train_loss(scores, batch["label"], batch.get("cdd_mask"))
        names = list(state.params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [state.params[k] for k in names], materialize_grads=True)))
        optimizer.fused_apply(state.params, state.opt_state, grads)
        state.step += 1
        metrics = {"loss": loss.detach().float()}
        if with_grad_norm:
            # a full extra read of every gradient leaf; opt-in diagnostics
            metrics["grad_norm"] = torch.sqrt(sum(
                (g.float() ** 2).sum() for g in grads.values()))
        return state, metrics

    return step_fn
