"""Fused multi-head self-attention for short articles (S ≤ 64).

``short_mhsa`` is the port of news_recommendation_mind_tpu/ops/
pallas_mhsa.py::short_mhsa (forward, ``_mhsa_fwd_impl``) with the same
public signature and layouts: q/k/v as [U, S, H], or pre-flattened as
[U·S, H] with ``seq_len=S`` (the BERT encoder's 2-D residual stream). On a
CUDA tensor it launches the hand-written kernel in ``csrc/short_mhsa.cu``;
on a CPU tensor it runs ``short_mhsa_plain``, the same function written
out step by step in PyTorch. The plain version is the CPU tests' path and
the reference the kernel is held against on the card.
"""
from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e9
MAX_SEQ = 64


def short_mhsa_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                     key_mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[U, S, H] q/k/v + key mask [U, S] → [U, S, H] context in q's dtype.

    fp32 scores scaled by 1/√hd, ``where(mask, s, -1e9)``, softmax, times
    the mask (masked keys → exactly 0, fully-masked articles → all 0),
    then P·V — the kernel's arithmetic (pallas_mhsa.py:105-123)."""
    U, S, H = q3.shape
    hd = H // n_heads

    def heads(t):
        return t.float().reshape(U, S, n_heads, hd).transpose(1, 2)

    q, k, v = heads(q3), heads(k3), heads(v3)            # [U, nh, S, hd]
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    keep = (key_mask.float() > 0)[:, None, None, :]        # [U, 1, 1, S]
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1) * keep.float()
    out = torch.matmul(probs, v)                           # [U, nh, S, hd]
    return out.transpose(1, 2).reshape(U, S, H).to(q3.dtype)


def _short_mhsa_cuda(q, k, v, key_mask, n_heads, U, S, H):
    out = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        code = lib.nrmt_short_mhsa(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            out.data_ptr(), U, S, H, n_heads, _build.DTYPE_CODES[q.dtype],
            _build.stream_of(q))
    _build.check(lib, code, "short_mhsa")
    _build.LAUNCHES["short_mhsa"] += 1
    return out


def short_mhsa(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
               key_mask: torch.Tensor, n_heads: int, p_drop: float = 0.0,
               seq_len: int = 0) -> torch.Tensor:
    """Fused short-sequence MHSA: q/k/v [U, S, H] (or [U·S, H] with
    ``seq_len=S``) + key mask [U, S] → context in the inputs' layout.

    q/k/v are float32 or bfloat16, contiguous, of one dtype; S ≤ 64. The
    inputs' device decides the route: CUDA tensors launch the kernel, CPU
    tensors take the plain version. Prob dropout (``p_drop`` > 0) belongs
    to the training slice and raises here.
    """
    if p_drop > 0.0:
        raise NotImplementedError(
            "short_mhsa with dropout comes with the training slice")
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
    devices = {t.device for t in (q3, k3, v3, key_mask)}
    if len(devices) != 1:
        raise ValueError(f"short_mhsa inputs span devices {devices}")
    if q3.device.type == "cpu":
        out = short_mhsa_plain(q3.reshape(U, S, H), k3.reshape(U, S, H),
                               v3.reshape(U, S, H), key_mask, n_heads)
        return out.reshape(q3.shape)
    if q3.device.type != "cuda":
        raise ValueError(f"short_mhsa runs on cuda or cpu, not {q3.device}")
    if not all(t.is_contiguous() for t in (q3, k3, v3)):
        raise ValueError("short_mhsa's kernel takes contiguous q, k and v")
    mask = key_mask.to(torch.float32).contiguous()
    return _short_mhsa_cuda(q3, k3, v3, mask, n_heads, U, S, H)
