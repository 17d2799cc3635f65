"""The dropout keep masks of the training kernels, from Philox4x32-10.

``ln_keep_mask`` and ``attn_keep_mask`` are the ports of the TPU probes
news_recommendation_mind_tpu/ops/pallas_ln.py::ln_dropout_keep_bits and
pallas_mhsa.py::dropout_keep_bits: they return, as a bool tensor, the mask
that ``fused_add_ln`` draws over a whole [N, H] residual stream and that
``short_mhsa`` draws over a whole [U, heads, S, S] probability tensor for
one seed. On a CUDA device they launch the kernels in
``csrc/dropout_bits.cu``; on the CPU they run the plain versions below,
the same Philox in int64 tensor ops. Both draw the same bits, so a CPU run
and a card run with one seed drop the same elements. The TPU generator's
own bits are a different stream and are not reproduced.

The counter of an element is made of its coordinates (``csrc/philox.cuh``):
(col // 4, row low, row high, 0) for the residual stream and
(key col // 4, query row, head, article) for attention; the element takes
word ``col % 4`` of the call, and is kept when that word is
<= round((1 − p)·(2³² − 1)), the JAX kernels' threshold
(pallas_ln.py:45-46).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ..device import DeviceLike

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fold_seed(seed: int, data: int) -> int:
    """A new 64-bit seed from ``seed`` and an integer (a step count, a call
    site's index): the splitmix64 finalizer of their sum-product, in place
    of ``jax.random.fold_in``."""
    z = (seed + 0x9E3779B97F4A7C15 * (data + 1)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def keep_threshold(p_drop: float) -> int:
    """The largest 32-bit word that keeps an element at drop rate p."""
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {p_drop}")
    return int(round((1.0 - p_drop) * float(2 ** 32 - 1)))


def drop_args(p_drop: float, seed: int) -> Tuple[int, int, int, float]:
    """(drop flag, seed, keep threshold, keep_prob) as the training
    kernels' C entries take them."""
    return int(p_drop > 0.0), seed, keep_threshold(p_drop), 1.0 - p_drop


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product m·x, for int64 lanes
    holding 32-bit values: by 16-bit halves, so no int64 overflows."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    mid = mh * xl + ml * xh                               # < 2^33
    low = ml * xl + ((mid & 0xFFFF) << 16)                # < 2^33
    high = mh * xh + (mid >> 16) + (low >> 32)
    return high, low & _MASK32


def philox4x32_10(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                  c3: torch.Tensor, seed: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Philox4x32 with ten rounds on int64 lanes holding 32-bit counter
    words (broadcastable); the key is ``seed``'s low and high words."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def ln_keep_mask_plain(seed: int, n: int, h: int, p_drop: float,
                       device: DeviceLike = "cpu") -> torch.Tensor:
    """bool [n, h]: the residual-dropout mask, in integer tensor ops."""
    groups = (h + 3) // 4
    row = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    group = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    words = philox4x32_10(group, row & _MASK32, row >> 32,
                          torch.zeros_like(group), seed)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return (bits <= keep_threshold(p_drop)).reshape(n, groups * 4)[:, :h]


def attn_keep_mask_plain(seed: int, u: int, n_heads: int, s: int,
                         p_drop: float, device: DeviceLike = "cpu"
                         ) -> torch.Tensor:
    """bool [u, n_heads, s, s]: the attention-prob dropout mask, in
    integer tensor ops."""
    groups = (s + 3) // 4

    def axis(size, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = size
        return torch.arange(size, dtype=torch.int64,
                            device=device).reshape(shape)

    words = philox4x32_10(axis(groups, 3), axis(s, 2), axis(n_heads, 1),
                          axis(u, 0) & _MASK32, seed)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return (bits <= keep_threshold(p_drop)).reshape(
        u, n_heads, s, groups * 4)[..., :s]


def _check(seed: int, device: DeviceLike) -> torch.device:
    if not 0 <= seed <= _MASK64:
        raise ValueError(f"the seed must fit 64 unsigned bits, got {seed}")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the masks are drawn on cuda or cpu, not {dev}")
    return dev


def ln_keep_mask(seed: int, n: int, h: int, p_drop: float,
                 device: DeviceLike = "cuda") -> torch.Tensor:
    """bool [n, h]: True where ``fused_add_ln(..., p_drop, seed)`` keeps
    the residual addend. ``device`` decides the route: a CUDA device
    launches the kernel, the CPU takes the plain version."""
    dev = _check(seed, device)
    if n < 0 or h <= 0:
        raise ValueError(f"ln_keep_mask takes n >= 0 and h > 0, got {n}, {h}")
    thresh = keep_threshold(p_drop)
    if dev.type == "cpu":
        return ln_keep_mask_plain(seed, n, h, p_drop, dev)
    out = torch.empty((n, h), dtype=torch.bool, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.nrmt_ln_keep_mask(out.data_ptr(), n, h, seed, thresh,
                                     _build.stream_of(out))
    _build.check(lib, code, "ln_keep_mask")
    _build.LAUNCHES["ln_keep_mask"] += 1
    return out


def attn_keep_mask(seed: int, u: int, n_heads: int, s: int, p_drop: float,
                   device: DeviceLike = "cuda") -> torch.Tensor:
    """bool [u, n_heads, s, s]: True where ``short_mhsa(..., p_drop,
    seed)`` keeps the probability of (article, head, query row, key col).
    ``device`` decides the route, as for ``ln_keep_mask``."""
    dev = _check(seed, device)
    if u < 0 or n_heads <= 0 or s <= 0 or u >= 2 ** 32:
        raise ValueError(f"attn_keep_mask takes 0 <= u < 2^32 and positive "
                         f"n_heads and s, got {u}, {n_heads}, {s}")
    thresh = keep_threshold(p_drop)
    if dev.type == "cpu":
        return attn_keep_mask_plain(seed, u, n_heads, s, p_drop, dev)
    out = torch.empty((u, n_heads, s, s), dtype=torch.bool, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.nrmt_attn_keep_mask(out.data_ptr(), u, n_heads, s, seed,
                                       thresh, _build.stream_of(out))
    _build.check(lib, code, "attn_keep_mask")
    _build.LAUNCHES["attn_keep_mask"] += 1
    return out
