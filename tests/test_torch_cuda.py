"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at edge shapes the serving path does not reach (S = 1 and 64, a
head width whose staging needs over 48 KB of shared memory, H not a
multiple of 32, a ragged last block of rows).

Marked ``cuda``: they skip without a card. On a machine with one, run
them without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from news_recommendation_mind_tpu_torch.ops import _build  # noqa: E402
from news_recommendation_mind_tpu_torch.ops.fused_add_ln import (  # noqa: E402
    _fused_add_ln_cuda, fused_add_ln, fused_add_ln_plain,
)
from news_recommendation_mind_tpu_torch.ops.short_mhsa import (  # noqa: E402
    short_mhsa, short_mhsa_plain,
)

pytestmark = pytest.mark.cuda

# |kernel - plain| <= ATOL + RTOL·|plain|: float32 differs by summation
# order; bfloat16 by one rounding of the output
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, dtype):
    tol = TOL[dtype]
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    assert (err <= tol + tol * want.abs()).all(), err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("U,S,H,NH", [(9, 13, 32, 4), (3, 64, 768, 12),
                                      (5, 1, 64, 2), (4, 64, 256, 2),
                                      (7, 30, 96, 3)])
def test_short_mhsa_kernel_matches_plain(dev, dtype, U, S, H, NH):
    g = torch.Generator(device=dev).manual_seed(U * S + H)
    q, k, v = (torch.randn(U, S, H, generator=g, device=dev).to(dtype)
               for _ in range(3))
    mask = (torch.rand(U, S, generator=g, device=dev) > 0.3).float()
    mask[:, 0] = 1.0
    mask[U // 2] = 0.0
    _build.reset_launches()
    got = short_mhsa(q, k, v, mask, NH)
    flat = short_mhsa(q.view(U * S, H), k.view(U * S, H), v.view(U * S, H),
                      mask, NH, seq_len=S)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["short_mhsa"] == 2
    want = short_mhsa_plain(q, k, v, mask, NH)
    _close(got, want, dtype)
    assert torch.equal(flat.view(U, S, H), got)
    assert got[U // 2].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H", [(64, 128), (13, 48), (1, 768),
                                 (15_001, 768)])
def test_fused_add_ln_kernel_matches_plain(dev, dtype, N, H):
    g = torch.Generator(device=dev).manual_seed(N + H)
    x, res = (torch.randn(N, H, generator=g, device=dev).to(dtype)
              for _ in range(2))
    scale = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    bias = 0.1 * torch.randn(H, generator=g, device=dev)
    _build.reset_launches()
    y = fused_add_ln(x, res, scale, bias)
    y2, mean, rstd = _fused_add_ln_cuda(x, res, scale, bias, 1e-12)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_add_ln"] == 2
    want, want_mean, want_rstd = fused_add_ln_plain(x, res, scale, bias)
    assert y.dtype == dtype and torch.equal(y, y2)
    _close(y, want, dtype)
    _close(mean, want_mean, torch.float32)
    _close(rstd, want_rstd, torch.float32)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(8, 16, device=dev)
    with pytest.raises(ValueError, match="devices"):
        fused_add_ln(x, x.cpu(), torch.ones(16, device=dev),
                     torch.zeros(16, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fused_add_ln(x.t().contiguous().t(), x, torch.ones(16, device=dev),
                     torch.zeros(16, device=dev))
    q = torch.zeros(2, 4, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        short_mhsa(q.transpose(0, 1).contiguous().transpose(0, 1), q, q,
                   torch.ones(2, 4, device=dev), 2)
