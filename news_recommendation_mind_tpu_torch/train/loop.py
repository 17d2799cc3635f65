"""Training orchestration: epochs over the train loader, one step each.

The port of ``Trainer.__init__`` and ``train()`` / ``_train_epochs``
(news_recommendation_mind_tpu/train/loop.py:46-137, 238-299): the
optimizer, the train state over the model's own parameters, the token
table resident on the device, the step, and loss logging every
``cfg.interval`` steps. Batches go to the device from pinned host memory,
``cfg.prefetch`` batches ahead of the step, in place of
``prefetch_to_device``. Checkpoints and resume, the evaluation hooks, NaN
recovery, the SIGTERM drain and ``steps_per_call > 1`` are not ported yet
and raise.
"""
from __future__ import annotations

import collections
import logging
import math
import time
from typing import Dict, Iterator, List, Tuple

import torch

from ..config import Config
from ..data.loader import Batch, TrainLoader
from ..device import DeviceLike, resolve_device
from .state import create_train_state, optimizer_for
from .step import make_train_step

logger = logging.getLogger("train")


def to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``; to a card through pinned
    memory, so the copies do not wait for the step that is running."""
    out = {}
    for key, arr in batch.items():
        t = torch.from_numpy(arr)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def prefetch_to_device(batches: Iterator[Batch], device: torch.device,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Keeps ``size`` batches on their way to the device ahead of the
    consumer."""
    queue: collections.deque = collections.deque()
    for batch in batches:
        queue.append(to_device(batch, device))
        if len(queue) > max(size, 0):
            yield queue.popleft()
    while queue:
        yield queue.popleft()


class Trainer:
    """Drives one experiment: the train state over ``model``'s parameters
    and the step, over the epochs of ``train_loader``."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 train_loader: TrainLoader, news_loader=None,
                 eval_loader=None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if news_loader is not None or eval_loader is not None:
            raise NotImplementedError(
                "evaluation during training comes with the eval engine")
        if cfg.checkpoint:
            raise NotImplementedError(
                "checkpoints and resume come with train/checkpoint.py")
        if cfg.steps_per_call > 1:
            raise NotImplementedError(
                "steps_per_call > 1 comes with make_train_multistep")
        self.cfg = cfg
        self.model = model.to(self.device)
        self.train_loader = train_loader
        total_steps = cfg.epochs * max(len(train_loader), 1)
        self.optimizer = optimizer_for(cfg, total_steps=total_steps)
        self.state = create_train_state(self.model, self.optimizer)
        news_table = None
        if cfg.device_gather and not train_loader.emit_tokens:
            news_table = (train_loader.news_tokens, train_loader.news_attn)
        self.train_step = make_train_step(
            self.model, self.optimizer, remat=cfg.remat,
            news_table=news_table, with_grad_norm=cfg.grad_norm,
            device=self.device)
        self.seed = cfg.seed
        self.history: List[Tuple[int, float]] = []   # (step, logged loss)

    def train(self) -> Dict[str, float]:
        """Runs ``cfg.epochs`` epochs (or ``cfg.step_budget`` steps) and
        returns the final evaluation's metrics: none, as long as the
        evaluation hooks are not ported. The logged losses are in
        ``self.history``."""
        cfg = self.cfg
        steps_done = 0
        examples = 0
        t0 = time.time()
        for epoch in range(cfg.epochs):
            self.train_loader.set_epoch(epoch)
            for batch in prefetch_to_device(iter(self.train_loader),
                                            self.device, cfg.prefetch):
                self.state, metrics = self.train_step(self.state, batch,
                                                      self.seed)
                steps_done += 1
                examples += cfg.batch_size
                if steps_done % cfg.interval == 0:
                    loss = float(metrics["loss"])
                    self.history.append((self.state.step, loss))
                    logger.info("epoch %d step %d loss %.4f (%.0f ex/s)",
                                epoch, self.state.step, loss,
                                examples / (time.time() - t0))
                    if not math.isfinite(loss):
                        raise FloatingPointError(
                            "non-finite training loss")
                if cfg.step_budget and steps_done >= cfg.step_budget:
                    return {}
        return {}
