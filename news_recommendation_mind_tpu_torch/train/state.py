"""Train state and the two-LR-group fused Adam.

The port of news_recommendation_mind_tpu/train/state.py: one Adam whose
parameters split by name into two learning-rate groups ("bert" in the
parameter's name → ``bert_lr``, everything else → ``lr``), an optional
linear warmup/decay schedule, and ``fused_apply``, which updates
parameters and moments through ``ops.fused_adam`` (one kernel launch over
all leaves on the card). Unlike the JAX pytrees, the state is updated in
place: ``TrainState.params`` are the model's own ``nn.Parameter``s.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from ..ops.fused_adam import MultiTensorAdam

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FusedAdamState:
    count: int                         # steps taken
    mu: Params                         # per-leaf first moments
    nu: Params                         # per-leaf second moments
    kernel: MultiTensorAdam            # bound to params, mu and nu


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params                     # name → the model's parameter
    opt_state: FusedAdamState


def _schedule(base: float, scheduler: str, warmup: int,
              total_steps: int) -> Callable[[int], float]:
    """Learning rate at a step count, in float32 arithmetic as
    train/state.py:105-116: linear warmup to ``base`` then linear decay to
    0 (HF get_linear_schedule_with_warmup), or the constant ``base``."""
    f32 = np.float32
    if scheduler == "linear":
        w = f32(max(warmup, 1))
        d = f32(max(total_steps - warmup, 1))

        def fn(count: int) -> float:
            c = f32(count)
            up = f32(base) * c / w
            down = f32(base) * np.maximum(f32(1.0) - (c - w) / d, f32(0.0))
            return float(up if c < w else down)
        return fn
    if scheduler != "none":
        raise ValueError(f"unknown scheduler {scheduler}")
    return lambda _: float(f32(base))


class FusedAdam:
    """``make_optimizer``'s math with a fused apply path: ``init(params)``
    → state, ``fused_apply(params, state, grads)`` → (params, state),
    both updated in place."""

    def __init__(self, lr: float, bert_lr: float, *, scheduler: str = "none",
                 warmup: int = 0, total_steps: int = 10000,
                 bert_key: str = "bert", b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lrs = {"main": _schedule(lr, scheduler, warmup, total_steps),
                    "bert": _schedule(bert_lr, scheduler, warmup,
                                      total_steps)}
        self.bert_key, self.b1, self.b2, self.eps = bert_key, b1, b2, eps

    def leaf_group(self, name: str) -> str:
        return "bert" if self.bert_key in name.lower() else "main"

    def init(self, params: Params) -> FusedAdamState:
        mu = {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()}
        nu = {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()}
        names = list(params)
        kernel = MultiTensorAdam(
            [params[k] for k in names], [mu[k] for k in names],
            [nu[k] for k in names],
            [int(self.leaf_group(k) == "bert") for k in names],
            b1=self.b1, b2=self.b2, eps=self.eps)
        return FusedAdamState(count=0, mu=mu, nu=nu, kernel=kernel)

    def fused_apply(self, params: Params, state: FusedAdamState,
                    grads: Params):
        """One Adam step in place. The bias corrections use the
        incremented count; the learning rates are the schedule at the old
        count (train/state.py:164-172)."""
        if list(grads) != list(params):
            raise ValueError("gradients and parameters differ in names")
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        state.kernel.step(list(grads.values()),
                          self.lrs["main"](state.count),
                          self.lrs["bert"](state.count), bc1, bc2)
        state.count = count
        return params, state


def make_fused_optimizer(lr: float, bert_lr: float, **kw) -> FusedAdam:
    return FusedAdam(lr, bert_lr, **kw)


def optimizer_for(cfg, total_steps: int = 10000) -> FusedAdam:
    """The optimizer a Config trains with."""
    if not cfg.fused_adam:
        raise NotImplementedError(
            "the unfused optax Adam (fused_adam=False) is not ported; it "
            "computes the same update")
    return make_fused_optimizer(cfg.lr, cfg.bert_lr, scheduler=cfg.scheduler,
                                warmup=cfg.warmup, total_steps=total_steps)


def create_train_state(model: torch.nn.Module,
                       optimizer: FusedAdam) -> TrainState:
    """The state over ``model``'s own parameters, which every later step
    updates in place."""
    params = dict(model.named_parameters())
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params))
