"""Fused in-place Adam over every parameter leaf of a model.

``MultiTensorAdam`` is the port of news_recommendation_mind_tpu/ops/
pallas_adam.py::adam_leaf_update and of the loop around it in
train/state.py::fused_apply: per element, in fp32,

    mu = b1·mu + (1 − b1)·g;   nu = b2·nu + (1 − b2)·g²
    p += ((mu / bc1) / (√(nu / bc2) + eps)) · (−lr)

with the bias corrections ``bc1``, ``bc2`` and the learning rates passed in
per step, in the operation order of train/state.py:130-137. ``p``, ``mu``
and ``nu`` are updated in place. On CUDA leaves one launch of
``csrc/fused_adam.cu`` updates all of them (a multi-tensor launch over a
table of leaf addresses kept on the card); on CPU leaves
``fused_adam_plain`` runs the same arithmetic leaf by leaf in PyTorch. The
Pallas eligibility rule (pallas_adam.py:45-56) is TPU tiling and is not
carried over: every float32 leaf takes the kernel.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from . import _build

CHUNK = 32_768           # elements one thread block updates


def fused_adam_plain(params: Sequence[torch.Tensor],
                     mus: Sequence[torch.Tensor],
                     nus: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor], lrs: Sequence[float],
                     bc1: float, bc2: float, *, b1: float, b2: float,
                     eps: float) -> None:
    """One Adam step on each leaf, in place, as separate fp32 tensor ops
    (each rounds once, as the kernel's explicit intrinsics do). ``lrs``
    holds one learning rate per leaf. The square root is taken in float64
    and rounded to float32, which is the correctly rounded float32 root
    (53 bits cover 2·24 + 2): ``torch.sqrt`` on a CPU float32 tensor may
    be one ulp off, and the kernel's ``__fsqrt_rn`` is not."""
    with torch.no_grad():
        for p, mu, nu, g, lr in zip(params, mus, nus, grads, lrs):
            def f32(v):
                return torch.tensor(v, dtype=torch.float32, device=p.device)
            g = g.float()
            mu.copy_(f32(b1) * mu + f32(1.0 - b1) * g)
            nu.copy_(f32(b2) * nu + f32(1.0 - b2) * (g * g))
            mu_hat = mu / f32(bc1)
            nu_hat = nu / f32(bc2)
            root = torch.sqrt(nu_hat.double()).float()
            upd = (mu_hat / (root + f32(eps))) * f32(-lr)
            p.add_(upd)


class MultiTensorAdam:
    """Adam over one fixed set of float32 leaves ``params`` with moments
    ``mus`` and ``nus``; ``groups[i]`` (0 or 1) picks which of the step's
    two learning rates leaf i takes."""

    def __init__(self, params: Sequence[torch.Tensor],
                 mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                 groups: Sequence[int], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params, self.mus, self.nus = list(params), list(mus), list(nus)
        self.groups = [int(g) for g in groups]
        self.b1, self.b2, self.eps = b1, b2, eps
        n = len(self.params)
        if not (len(self.mus) == len(self.nus) == len(self.groups) == n):
            raise ValueError("params, mus, nus and groups differ in length")
        if any(g not in (0, 1) for g in self.groups):
            raise ValueError("a leaf's learning-rate group is 0 or 1")
        devices = {t.device for t in (*self.params, *self.mus, *self.nus)}
        if len(devices) > 1:
            raise ValueError(f"Adam leaves span devices {devices}")
        self.device = devices.pop() if devices else torch.device("cpu")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"Adam runs on cuda or cpu, not {self.device}")
        for p, mu, nu in zip(self.params, self.mus, self.nus):
            if not (p.dtype == mu.dtype == nu.dtype == torch.float32):
                raise TypeError("Adam leaves and moments are float32")
            if mu.shape != p.shape or nu.shape != p.shape:
                raise ValueError("a moment's shape differs from its leaf's")
            if not (p.is_contiguous() and mu.is_contiguous()
                    and nu.is_contiguous()):
                raise ValueError("Adam leaves and moments are contiguous")
        self._grad_ptrs: List[int] = []
        if self.device.type == "cuda":
            self._build_table()

    def _build_table(self) -> None:
        """The kernel's tables on the card: leaf addresses and sizes, the
        leaves' groups, and each chunk's leaf and offset."""
        dev = self.device
        sizes = [p.numel() for p in self.params]
        rows = [[t.data_ptr() for t in ts]
                for ts in (self.params, self.mus, self.nus)]
        rows += [[0] * len(sizes), sizes]
        self._leaves = torch.tensor(rows, dtype=torch.int64,
                                    device=dev).reshape(5, len(sizes))
        self._leaf_group = torch.tensor(self.groups, dtype=torch.int32,
                                        device=dev)
        chunk_leaf, chunk_start = [], []
        for i, size in enumerate(sizes):
            starts = range(0, size, CHUNK)
            chunk_leaf += [i] * len(starts)
            chunk_start += list(starts)
        self._n_chunks = len(chunk_leaf)
        self._chunk_leaf = torch.tensor(chunk_leaf, dtype=torch.int32,
                                        device=dev)
        self._chunk_start = torch.tensor(chunk_start, dtype=torch.int64,
                                         device=dev)

    def step(self, grads: Sequence[torch.Tensor], lr0: float, lr1: float,
             bc1: float, bc2: float) -> None:
        """One in-place Adam step: group 0 leaves at ``lr0``, group 1 at
        ``lr1``. The leaves' device decides the route: CUDA leaves launch
        the kernel once for all of them, CPU leaves take the plain
        version."""
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} leaves")
        for p, g in zip(self.params, grads):
            if g.shape != p.shape or g.dtype != torch.float32 or \
                    g.device != p.device:
                raise ValueError("a gradient differs from its leaf in "
                                 "shape, dtype or device")
        if self.device.type == "cpu":
            fused_adam_plain(self.params, self.mus, self.nus, grads,
                             [lr1 if g else lr0 for g in self.groups],
                             bc1, bc2, b1=self.b1, b2=self.b2, eps=self.eps)
            return
        if not grads:
            return
        if not all(g.is_contiguous() for g in grads):
            raise ValueError("the Adam kernel takes contiguous gradients")
        ptrs = [g.data_ptr() for g in grads]
        if ptrs != self._grad_ptrs:
            # autograd hands out new buffers each step: one small copy
            self._leaves[3].copy_(torch.tensor(ptrs, dtype=torch.int64))
            self._grad_ptrs = ptrs
        lib = _build.load_library()
        with torch.cuda.device(self.device):
            code = lib.nrmt_fused_adam(
                self._leaves.data_ptr(), self._leaf_group.data_ptr(),
                self._chunk_leaf.data_ptr(), self._chunk_start.data_ptr(),
                len(self.params), self._n_chunks, CHUNK, self.b1, self.b2,
                1.0 - self.b1, 1.0 - self.b2, self.eps, bc1, bc2, lr0, lr1,
                _build.stream_of(self._leaves))
        _build.check(lib, code, "fused_adam")
        _build.LAUNCHES["fused_adam"] += 1
