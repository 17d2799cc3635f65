"""Fused residual-add + LayerNorm over the rows of the [N, H] stream.

``fused_add_ln`` is the port of news_recommendation_mind_tpu/ops/
pallas_ln.py::fused_add_ln (forward, ``_add_ln_fwd_impl``): on a CUDA
tensor it launches the hand-written kernel in ``csrc/fused_add_ln.cu``;
on a CPU tensor it runs ``fused_add_ln_plain``, the same function written
out step by step in PyTorch. The plain version is the CPU tests' path and
the reference the kernel is held against on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build


def fused_add_ln_plain(x: torch.Tensor, res: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       eps: float = 1e-12
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) with y = LN(x + res)·scale + bias in x's dtype and
    the fp32 row stats [N, 1]; var = E[s²] − mean², as the kernel and the
    JAX reference (pallas_ln.py:223-237) compute it."""
    s = x.float() + res.float()
    mean = s.mean(dim=-1, keepdim=True)
    var = (s * s).mean(dim=-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = (s - mean) * rstd
    y = xhat * scale.float() + bias.float()
    return y.to(x.dtype), mean, rstd


def _fused_add_ln_cuda(x, res, scale, bias, eps):
    N, H = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        code = lib.nrmt_fused_add_ln(
            x.data_ptr(), res.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), N, H, float(eps),
            _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
    _build.check(lib, code, "fused_add_ln")
    _build.LAUNCHES["fused_add_ln"] += 1
    return y, mean, rstd


def fused_add_ln(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, eps: float = 1e-12,
                 p_drop: float = 0.0) -> torch.Tensor:
    """``LayerNorm(x + res) * scale + bias`` over rows of [N, H].

    x and res: [N, H], float32 or bfloat16, contiguous; scale and bias:
    float32 [H]. The result has x's dtype. The inputs' device decides the
    route: CUDA tensors launch the kernel, CPU tensors take the plain
    version. Residual dropout (``p_drop`` > 0) belongs to the training
    slice and raises here.
    """
    if p_drop > 0.0:
        raise NotImplementedError(
            "fused_add_ln with dropout comes with the training slice")
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
    devices = {t.device for t in (x, res, scale, bias)}
    if len(devices) != 1:
        raise ValueError(f"fused_add_ln inputs span devices {devices}")
    if x.device.type == "cpu":
        return fused_add_ln_plain(x, res, scale, bias, eps)[0]
    if x.device.type != "cuda":
        raise ValueError(f"fused_add_ln runs on cuda or cpu, not {x.device}")
    if not all(t.is_contiguous() for t in (x, res, scale, bias)):
        raise ValueError("fused_add_ln's kernel takes contiguous tensors")
    return _fused_add_ln_cuda(x, res, scale, bias, eps)[0]
