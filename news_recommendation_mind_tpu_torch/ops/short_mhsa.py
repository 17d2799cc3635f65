"""Fused multi-head self-attention for short articles (S ≤ 64), with
attention-prob dropout and a hand-written backward.

``short_mhsa`` is the port of news_recommendation_mind_tpu/ops/
pallas_mhsa.py::short_mhsa with the same layouts: q/k/v as [U, S, H], or
pre-flattened as [U·S, H] with ``seq_len=S`` (the BERT encoder's 2-D
residual stream). It is a ``torch.autograd.Function`` like the JAX
``custom_vjp``: the forward saves ``q, k, v, key_mask, seed`` and the
backward recomputes the probabilities from them. On CUDA tensors the
forward launches ``csrc/short_mhsa.cu`` (``_mhsa_fwd_impl``) and the
backward ``csrc/short_mhsa_bwd.cu`` (``_mhsa_bwd``); on CPU tensors both
run the plain versions below, the same functions written out step by step
in PyTorch. The plain versions are the CPU tests' path and the reference
the kernels are held against on the card. The dropout mask is
``dropout_bits.attn_keep_mask(seed, U, heads, S, p_drop)`` on either
route.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from .dropout_bits import attn_keep_mask_plain, drop_args, keep_threshold

NEG_INF = -1e9
MAX_SEQ = 64
_MAX_SMEM = 227 * 1024


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[U, S, H] → fp32 [U, nh, S, hd]."""
    U, S, H = t.shape
    return t.float().reshape(U, S, n_heads, H // n_heads).transpose(1, 2)


def _probs(q, k, key_mask, p_drop, seed):
    """(sig, pd, mf, keep, kp): the fp32 softmax over masked scores, the
    masked and dropped probabilities, the key mask as [U, 1, 1, S] floats,
    and the dropout mask and divisor (None without dropout) — the
    kernels' arithmetic (pallas_mhsa.py:68-71, 105-123)."""
    U, nh, S, hd = q.shape
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    valid = (key_mask.float() > 0)[:, None, None, :]       # [U, 1, 1, S]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    sig = torch.softmax(scores, dim=-1)
    mf = valid.float()
    pd = sig * mf
    if p_drop <= 0.0:
        return sig, pd, mf, None, None
    keep = attn_keep_mask_plain(seed, U, nh, S, p_drop, q.device)
    kp = torch.tensor(1.0 - p_drop, dtype=torch.float32, device=q.device)
    return sig, torch.where(keep, pd / kp, torch.zeros_like(pd)), mf, keep, kp


def short_mhsa_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                     key_mask: torch.Tensor, n_heads: int,
                     p_drop: float = 0.0, seed: int = 0) -> torch.Tensor:
    """[U, S, H] q/k/v + key mask [U, S] → [U, S, H] context in q's dtype.

    fp32 scores scaled by 1/√hd, ``where(mask, s, -1e9)``, softmax, times
    the mask (masked keys → exactly 0, fully-masked articles → all 0),
    inverted dropout of those probabilities, then P·V."""
    U, S, H = q3.shape
    q, k, v = (_heads(t, n_heads) for t in (q3, k3, v3))
    pd = _probs(q, k, key_mask, p_drop, seed)[1]
    out = torch.matmul(pd, v)                              # [U, nh, S, hd]
    return out.transpose(1, 2).reshape(U, S, H).to(q3.dtype)


def short_mhsa_bwd_plain(q3: torch.Tensor, k3: torch.Tensor,
                         v3: torch.Tensor, key_mask: torch.Tensor,
                         do3: torch.Tensor, n_heads: int,
                         p_drop: float = 0.0, seed: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) [U, S, H] in q's dtype from the output gradient, the
    arithmetic of the JAX backward kernel (pallas_mhsa.py:126-166)."""
    U, S, H = q3.shape
    scale = 1.0 / math.sqrt(H // n_heads)
    q, k, v, do = (_heads(t, n_heads) for t in (q3, k3, v3, do3))
    sig, pd, mf, keep, kp = _probs(q, k, key_mask, p_drop, seed)
    dv = torch.matmul(pd.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    if keep is not None:
        dp = torch.where(keep, dp / kp, torch.zeros_like(dp))
    dsig = dp * mf
    ds = sig * (dsig - (sig * dsig).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return tuple(t.transpose(1, 2).reshape(U, S, H).to(q3.dtype)
                 for t in (dq, dk, dv))


def _short_mhsa_cuda(q, k, v, key_mask, n_heads, p_drop=0.0, seed=0):
    U, S, H = q.shape
    out = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        code = lib.nrmt_short_mhsa(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            out.data_ptr(), U, S, H, n_heads, *drop_args(p_drop, seed),
            _build.DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(lib, code, "short_mhsa")
    _build.LAUNCHES["short_mhsa"] += 1
    return out


def _short_mhsa_bwd_cuda(q, k, v, key_mask, do, n_heads, p_drop=0.0, seed=0):
    U, S, H = q.shape
    hd = H // n_heads
    smem = 4 * (4 * S * (hd + 1) + 3 * S * (S + 1) + S)
    if smem > _MAX_SMEM:
        raise ValueError(f"short_mhsa's backward kernel stages {smem} bytes "
                         f"of shared memory at S = {S}, head width {hd}, "
                         f"over {_MAX_SMEM}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        code = lib.nrmt_short_mhsa_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            U, S, H, n_heads, *drop_args(p_drop, seed),
            _build.DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(lib, code, "short_mhsa_bwd")
    _build.LAUNCHES["short_mhsa_bwd"] += 1
    return dq, dk, dv


class _ShortMHSA(torch.autograd.Function):
    """On contiguous [U, S, H] q/k/v and a float32 [U, S] key mask, which
    ``short_mhsa`` checked; forward and backward each pick their route
    from the tensors' device."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, n_heads, p_drop, seed):
        impl = short_mhsa_plain if q.device.type == "cpu" \
            else _short_mhsa_cuda
        out = impl(q, k, v, key_mask, n_heads, p_drop, seed)
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.n_heads, ctx.p_drop, ctx.seed = n_heads, p_drop, seed
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask = ctx.saved_tensors
        impl = short_mhsa_bwd_plain if q.device.type == "cpu" \
            else _short_mhsa_bwd_cuda
        dq, dk, dv = impl(q, k, v, key_mask, do.contiguous(), ctx.n_heads,
                          ctx.p_drop, ctx.seed)
        return dq, dk, dv, None, None, None, None


def short_mhsa(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
               key_mask: torch.Tensor, n_heads: int, p_drop: float = 0.0,
               seq_len: int = 0, seed: int = 0) -> torch.Tensor:
    """Fused short-sequence MHSA: q/k/v [U, S, H] (or [U·S, H] with
    ``seq_len=S``) + key mask [U, S] → context in the inputs' layout,
    differentiable in q, k and v.

    q/k/v are float32 or bfloat16, contiguous, of one dtype; S ≤ 64.
    ``p_drop`` > 0 applies inverted dropout to the masked probabilities
    with the mask ``attn_keep_mask(seed, U, n_heads, S, p_drop)``;
    ``seed`` is a 64-bit unsigned integer. The inputs' device decides the
    route: CUDA tensors launch the kernels, CPU tensors take the plain
    versions.
    """
    if q3.dim() == 2:
        if seq_len <= 0 or q3.shape[0] % seq_len:
            raise ValueError(f"flat q of shape {tuple(q3.shape)} needs a "
                             f"seq_len dividing its rows, got {seq_len}")
        S = seq_len
        U, H = q3.shape[0] // S, q3.shape[1]
    elif q3.dim() == 3:
        U, S, H = q3.shape
    else:
        raise ValueError(f"short_mhsa takes [U, S, H] or [U·S, H], "
                         f"got {tuple(q3.shape)}")
    if k3.shape != q3.shape or v3.shape != q3.shape:
        raise ValueError("q, k and v must share one shape")
    if key_mask.shape != (U, S):
        raise ValueError(f"key_mask must be [{U}, {S}], "
                         f"got {tuple(key_mask.shape)}")
    if n_heads <= 0 or H % n_heads:
        raise ValueError(f"{n_heads} heads do not divide H = {H}")
    if S > MAX_SEQ:
        raise ValueError(f"short_mhsa takes S ≤ {MAX_SEQ}, got {S}")
    if q3.dtype not in _build.DTYPE_CODES or \
            k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise TypeError(f"short_mhsa takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q3.dtype}, {k3.dtype}, {v3.dtype}")
    keep_threshold(p_drop)        # raises on a rate outside [0, 1)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"the seed must fit 64 unsigned bits, got {seed}")
    devices = {t.device for t in (q3, k3, v3, key_mask)}
    if len(devices) != 1:
        raise ValueError(f"short_mhsa inputs span devices {devices}")
    if q3.device.type not in ("cuda", "cpu"):
        raise ValueError(f"short_mhsa runs on cuda or cpu, not {q3.device}")
    if q3.device.type == "cuda" and \
            not all(t.is_contiguous() for t in (q3, k3, v3)):
        raise ValueError("short_mhsa's kernel takes contiguous q, k and v")
    mask = key_mask.detach().to(torch.float32).contiguous()
    out = _ShortMHSA.apply(q3.reshape(U, S, H), k3.reshape(U, S, H),
                           v3.reshape(U, S, H), mask, n_heads,
                           float(p_drop), int(seed))
    return out.reshape(q3.shape)
