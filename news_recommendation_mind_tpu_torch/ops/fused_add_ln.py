"""Fused residual-add + LayerNorm over the rows of the [N, H] stream, with
residual dropout and a hand-written backward.

``fused_add_ln`` is the port of news_recommendation_mind_tpu/ops/
pallas_ln.py::fused_add_ln: ``LN(x + dropout(res))·scale + bias``. It is a
``torch.autograd.Function`` like the JAX ``custom_vjp``: the forward saves
``x, res, scale, seed`` and the fp32 row stats, the backward rebuilds the
dropped sum from them. On CUDA tensors the forward launches
``csrc/fused_add_ln.cu`` (``_add_ln_fwd_impl``) and the backward
``csrc/fused_add_ln_bwd.cu`` (``_add_ln_bwd``); on CPU tensors both run
the plain versions below, the same functions written out step by step in
PyTorch. The plain versions are the CPU tests' path and the reference the
kernels are held against on the card. The dropout mask is
``dropout_bits.ln_keep_mask(seed, N, H, p_drop)`` on either route.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .dropout_bits import drop_args, keep_threshold, ln_keep_mask_plain

# thread blocks the backward spreads the rows over: eight per SM of an
# H100, each leaving one partial row of dscale and dbias
_BWD_MAX_BLOCKS = 1056
_BWD_WARPS = 4
_MAX_SMEM = 227 * 1024


def _dropped(res: torch.Tensor, p_drop: float, seed: int
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                        Optional[torch.Tensor]]:
    """(dropout(res) in fp32, keep mask, keep_prob) — inverted dropout as
    pallas_ln.py:54-58; the divisor is an fp32 tensor so the division is a
    true division on every device."""
    r = res.float()
    if p_drop <= 0.0:
        return r, None, None
    keep = ln_keep_mask_plain(seed, res.shape[0], res.shape[1], p_drop,
                              res.device)
    kp = torch.tensor(1.0 - p_drop, dtype=torch.float32, device=res.device)
    return torch.where(keep, r / kp, torch.zeros_like(r)), keep, kp


def fused_add_ln_plain(x: torch.Tensor, res: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       eps: float = 1e-12, p_drop: float = 0.0,
                       seed: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) with y = LN(x + dropout(res))·scale + bias in x's
    dtype and the fp32 row stats [N, 1]; var = E[s²] − mean², as the kernel
    and the JAX reference (pallas_ln.py:223-237) compute it."""
    s = x.float() + _dropped(res, p_drop, seed)[0]
    mean = s.mean(dim=-1, keepdim=True)
    var = (s * s).mean(dim=-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = (s - mean) * rstd
    y = xhat * scale.float() + bias.float()
    return y.to(x.dtype), mean, rstd


def fused_add_ln_bwd_plain(dy: torch.Tensor, x: torch.Tensor,
                           res: torch.Tensor, scale: torch.Tensor,
                           mean: torch.Tensor, rstd: torch.Tensor,
                           p_drop: float = 0.0, seed: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """(dx, dres, dscale, dbias) from the saved row stats, the arithmetic
    of the JAX backward kernel (pallas_ln.py:77-109): dx and dres in x's
    dtype, dscale and dbias in fp32. Without dropout dres is dx itself."""
    r, keep, kp = _dropped(res, p_drop, seed)
    g = dy.float()
    xhat = (x.float() + r - mean) * rstd
    dxhat = g * scale.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx32 = rstd * (dxhat - m1 - xhat * m2)
    dx = dx32.to(x.dtype)
    dres = dx if keep is None else torch.where(
        keep, dx32 / kp, torch.zeros_like(dx32)).to(x.dtype)
    return dx, dres, (g * xhat).sum(dim=0), g.sum(dim=0)


def _fused_add_ln_cuda(x, res, scale, bias, eps, p_drop=0.0, seed=0):
    N, H = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        code = lib.nrmt_fused_add_ln(
            x.data_ptr(), res.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), N, H, float(eps),
            *drop_args(p_drop, seed), _build.DTYPE_CODES[x.dtype],
            _build.stream_of(x))
    _build.check(lib, code, "fused_add_ln")
    _build.LAUNCHES["fused_add_ln"] += 1
    return y, mean, rstd


def _fused_add_ln_bwd_cuda(dy, x, res, scale, mean, rstd, p_drop=0.0,
                           seed=0):
    N, H = x.shape
    hpad = (H + 3) // 4 * 4
    if _BWD_WARPS * 2 * hpad * 4 > _MAX_SMEM:
        raise ValueError(f"fused_add_ln's backward kernel keeps "
                         f"{_BWD_WARPS * 2 * hpad * 4} bytes of column sums "
                         f"in shared memory at H = {H}, over {_MAX_SMEM}")
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if p_drop > 0.0 else dx
    sums = torch.zeros((2, H), dtype=torch.float32, device=x.device)
    if N == 0:
        return dx, dres, sums[0], sums[1]
    blocks = min(-(-N // _BWD_WARPS), _BWD_MAX_BLOCKS)
    partials = torch.empty((2, blocks, H), dtype=torch.float32,
                           device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        code = lib.nrmt_fused_add_ln_bwd(
            dy.data_ptr(), x.data_ptr(), res.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), scale.data_ptr(), dx.data_ptr(),
            dres.data_ptr(), partials.data_ptr(), sums.data_ptr(), N, H,
            blocks, *drop_args(p_drop, seed), _build.DTYPE_CODES[x.dtype],
            _build.stream_of(x))
    _build.check(lib, code, "fused_add_ln_bwd")
    _build.LAUNCHES["fused_add_ln_bwd"] += 1
    return dx, dres, sums[0], sums[1]


class _FusedAddLN(torch.autograd.Function):
    """Forward and backward each pick their route from the tensors'
    device; the inputs were checked by ``fused_add_ln``."""

    @staticmethod
    def forward(ctx, x, res, scale, bias, eps, p_drop, seed):
        impl = fused_add_ln_plain if x.device.type == "cpu" \
            else _fused_add_ln_cuda
        y, mean, rstd = impl(x, res, scale, bias, eps, p_drop, seed)
        ctx.save_for_backward(x, res, scale, mean, rstd)
        ctx.p_drop, ctx.seed = p_drop, seed
        return y

    @staticmethod
    def backward(ctx, dy):
        x, res, scale, mean, rstd = ctx.saved_tensors
        impl = fused_add_ln_bwd_plain if x.device.type == "cpu" \
            else _fused_add_ln_bwd_cuda
        dx, dres, dscale, dbias = impl(dy.contiguous(), x, res, scale, mean,
                                       rstd, ctx.p_drop, ctx.seed)
        return dx, dres, dscale, dbias, None, None, None


def fused_add_ln(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, eps: float = 1e-12,
                 p_drop: float = 0.0, seed: int = 0) -> torch.Tensor:
    """``LayerNorm(x + dropout(res)) * scale + bias`` over rows of [N, H],
    differentiable in x, res, scale and bias.

    x and res: [N, H], float32 or bfloat16, contiguous; scale and bias:
    float32 [H]. The result has x's dtype. ``p_drop`` > 0 applies inverted
    dropout to ``res`` with the mask ``ln_keep_mask(seed, N, H, p_drop)``;
    ``seed`` is a 64-bit unsigned integer. The inputs' device decides the
    route: CUDA tensors launch the kernels, CPU tensors take the plain
    versions.
    """
    if x.dim() != 2 or res.shape != x.shape:
        raise ValueError(f"fused_add_ln takes x and res of one [N, H] shape, "
                         f"got {tuple(x.shape)} and {tuple(res.shape)}")
    H = x.shape[1]
    if scale.shape != (H,) or bias.shape != (H,):
        raise ValueError(f"scale and bias must be [{H}], got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if x.dtype not in _build.DTYPE_CODES or res.dtype != x.dtype:
        raise TypeError(f"fused_add_ln takes float32 or bfloat16 x and res "
                        f"of one dtype, got {x.dtype} and {res.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("fused_add_ln keeps scale and bias in float32")
    keep_threshold(p_drop)        # raises on a rate outside [0, 1)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"the seed must fit 64 unsigned bits, got {seed}")
    devices = {t.device for t in (x, res, scale, bias)}
    if len(devices) != 1:
        raise ValueError(f"fused_add_ln inputs span devices {devices}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_add_ln runs on cuda or cpu, not {x.device}")
    if x.device.type == "cuda" and \
            not all(t.is_contiguous() for t in (x, res, scale, bias)):
        raise ValueError("fused_add_ln's kernel takes contiguous tensors")
    return _FusedAddLN.apply(x, res, scale, bias, float(eps), float(p_drop),
                             int(seed))
