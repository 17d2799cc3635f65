"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at edge shapes the main paths do not reach (S = 1 and 64, a head
width whose staging needs over 48 KB of shared memory, H not a multiple
of 32 or of 4, a single row, a ragged last block of rows): forward and
backward, with and without dropout, the two keep-mask probes, the fused
Adam, and finite differences through both autograd functions.

Marked ``cuda``: they skip without a card. On a machine with one, run
them without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from news_recommendation_mind_tpu_torch.ops import _build  # noqa: E402
from news_recommendation_mind_tpu_torch.ops.dropout_bits import (  # noqa: E402
    attn_keep_mask, attn_keep_mask_plain, ln_keep_mask, ln_keep_mask_plain,
)
from news_recommendation_mind_tpu_torch.ops.fused_adam import (  # noqa: E402
    MultiTensorAdam,
)
from news_recommendation_mind_tpu_torch.ops.fused_add_ln import (  # noqa: E402
    _fused_add_ln_cuda, fused_add_ln, fused_add_ln_bwd_plain,
    fused_add_ln_plain,
)
from news_recommendation_mind_tpu_torch.ops.short_mhsa import (  # noqa: E402
    short_mhsa, short_mhsa_bwd_plain, short_mhsa_plain,
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


SEED = 0x9E3779B97F4A7C15          # a seed with both 32-bit halves set


@pytest.mark.parametrize("N,H", [(1, 768), (13, 50), (1000, 768), (7, 3)])
def test_ln_keep_mask_kernel_draws_the_plain_bits(dev, N, H):
    _build.reset_launches()
    got = ln_keep_mask(SEED, N, H, 0.1, dev)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ln_keep_mask"] == 1
    assert got.dtype == torch.bool and got.shape == (N, H)
    assert torch.equal(got.cpu(), ln_keep_mask_plain(SEED, N, H, 0.1))
    assert torch.equal(got, ln_keep_mask_plain(SEED, N, H, 0.1, dev))


@pytest.mark.parametrize("U,NH,S", [(9, 4, 13), (3, 12, 64), (5, 2, 1),
                                    (300, 12, 30)])
def test_attn_keep_mask_kernel_draws_the_plain_bits(dev, U, NH, S):
    _build.reset_launches()
    got = attn_keep_mask(SEED, U, NH, S, 0.1, dev)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["attn_keep_mask"] == 1
    assert got.dtype == torch.bool and got.shape == (U, NH, S, S)
    assert torch.equal(got.cpu(), attn_keep_mask_plain(SEED, U, NH, S, 0.1))


@pytest.mark.parametrize("p_drop", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H", [(64, 128), (13, 50), (1, 768),
                                 (5_001, 768)])
def test_fused_add_ln_backward_kernel_matches_plain(dev, dtype, N, H,
                                                    p_drop):
    g = torch.Generator(device=dev).manual_seed(N + H)
    x, res, dy = (torch.randn(N, H, generator=g, device=dev).to(dtype)
                  for _ in range(3))
    scale = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    bias = 0.1 * torch.randn(H, generator=g, device=dev)
    leaves = [t.requires_grad_() for t in (x, res, scale, bias)]
    _build.reset_launches()
    y = fused_add_ln(*leaves, p_drop=p_drop, seed=SEED)
    dx, dres, dscale, dbias = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_add_ln"] == 1
    assert _build.LAUNCHES["fused_add_ln_bwd"] == 1
    with torch.no_grad():
        want_y, mean, rstd = fused_add_ln_plain(x, res, scale, bias, 1e-12,
                                                p_drop, SEED)
        want = fused_add_ln_bwd_plain(dy, x, res, scale, mean, rstd, p_drop,
                                      SEED)
    _close(y, want_y, dtype)
    _close(dx, want[0], dtype)
    _close(dres, want[1], dtype)
    # column sums over N rows in another order: the error grows with N
    for got_sum, want_sum in ((dscale, want[2]), (dbias, want[3])):
        assert got_sum.dtype == torch.float32
        err = (got_sum - want_sum).abs().max().item()
        assert err <= 1e-5 * N + 1e-4, err
    if p_drop > 0:
        keep = ln_keep_mask(SEED, N, H, p_drop, dev)
        assert keep.all() or dres[~keep].abs().max().item() == 0.0
    # the same call again gives the same bits: no atomics
    y2 = fused_add_ln(*leaves, p_drop=p_drop, seed=SEED)
    again = torch.autograd.grad(y2, leaves, dy)
    assert all(torch.equal(a, b) for a, b in
               zip(again, (dx, dres, dscale, dbias)))


@pytest.mark.parametrize("p_drop", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("U,S,H,NH", [(9, 13, 32, 4), (3, 64, 256, 2),
                                      (5, 1, 64, 2), (7, 30, 96, 3),
                                      (40, 30, 768, 12)])
def test_short_mhsa_backward_kernel_matches_plain(dev, dtype, U, S, H, NH,
                                                  p_drop):
    g = torch.Generator(device=dev).manual_seed(U * S + H)
    q, k, v, do = (torch.randn(U, S, H, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    mask = (torch.rand(U, S, generator=g, device=dev) > 0.3).float()
    mask[:, 0] = 1.0
    mask[U // 2] = 0.0
    leaves = [t.requires_grad_() for t in (q, k, v)]
    _build.reset_launches()
    out = short_mhsa(*leaves, mask, NH, p_drop=p_drop, seed=SEED)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["short_mhsa"] == 1
    assert _build.LAUNCHES["short_mhsa_bwd"] == 1
    with torch.no_grad():
        want_out = short_mhsa_plain(q, k, v, mask, NH, p_drop, SEED)
        want = short_mhsa_bwd_plain(q, k, v, mask, do, NH, p_drop, SEED)
    _close(out, want_out, dtype)
    for got_g, want_g in zip(grads, want):
        _close(got_g, want_g, dtype)
        assert got_g[U // 2].abs().max().item() == 0.0
    assert out[U // 2].abs().max().item() == 0.0


def test_short_mhsa_backward_refuses_what_exceeds_shared_memory(dev):
    q = torch.zeros(1, 64, 256, device=dev, requires_grad=True)
    out = short_mhsa(q, q, q, torch.ones(1, 64, device=dev), 1)
    with pytest.raises(ValueError, match="shared memory"):
        out.sum().backward()


def _finite_difference(fn, t, idx, eps=1e-2):
    """Central difference of the float64 scalar ``fn()`` in ``t[idx]``."""
    old = t[idx].item()
    with torch.no_grad():
        t[idx] = old + eps
        up = fn()
        t[idx] = old - eps
        down = fn()
        t[idx] = old
    return (up - down) / (2 * eps)


@pytest.mark.parametrize("op", ["fused_add_ln", "short_mhsa"])
def test_backward_kernels_match_finite_differences(dev, op):
    """fp32, tiny, dropout off: the kernels' gradients against central
    differences of the forward kernel (eps 1e-2; the difference carries
    eps² curvature and 1e-7/eps rounding, so 2e-3 of the largest
    gradient)."""
    g = torch.Generator(device=dev).manual_seed(5)
    if op == "fused_add_ln":
        leaves = [torch.randn(6, 20, generator=g, device=dev),
                  torch.randn(6, 20, generator=g, device=dev),
                  1.0 + 0.1 * torch.randn(20, generator=g, device=dev),
                  0.1 * torch.randn(20, generator=g, device=dev)]
        w = torch.randn(6, 20, generator=g, device=dev)

        def forward():
            return fused_add_ln(*leaves, eps=1e-5)
    else:
        leaves = [torch.randn(2, 5, 8, generator=g, device=dev)
                  for _ in range(3)]
        mask = torch.ones(2, 5, device=dev)
        mask[1, 3:] = 0.0
        w = torch.randn(2, 5, 8, generator=g, device=dev)

        def forward():
            return short_mhsa(*leaves, mask, 2)

    def loss():
        return (forward().double() * w.double()).sum().item()

    for t in leaves:
        t.requires_grad_()
    grads = torch.autograd.grad((forward() * w).sum(), leaves)
    for t, grad in zip(leaves, grads):
        flat_t, flat_g = t.detach().view(-1), grad.reshape(-1)
        tol = 2e-3 * max(grad.abs().max().item(), 1.0)
        for idx in range(0, flat_t.numel(), max(flat_t.numel() // 7, 1)):
            fd = _finite_difference(loss, flat_t, idx)
            assert abs(fd - flat_g[idx].item()) <= tol, (op, idx, fd)


def test_fused_adam_kernel_matches_plain(dev):
    """Leaves of odd sizes (one element, not a multiple of the chunk, two
    dimensions) in both learning-rate groups, five steps: the kernel's
    explicit round-to-nearest operations against the plain version's
    separate tensor ops, within one float32 ulp of the parameters."""
    shapes = [(1,), (768,), (33, 77), (40_000,), (3, 32_768), (70_001,)]
    groups = [0, 1, 0, 1, 1, 0]
    g = torch.Generator(device=dev).manual_seed(11)

    def state():
        gg = torch.Generator(device=dev).manual_seed(12)
        ps = [torch.randn(s, generator=gg, device=dev) for s in shapes]
        return ps, [torch.zeros_like(p) for p in ps], \
            [torch.zeros_like(p) for p in ps]

    kp, kmu, knu = state()
    pp, pmu, pnu = (([t.cpu() for t in ts]) for ts in state())
    kernel = MultiTensorAdam(kp, kmu, knu, groups)
    plain = MultiTensorAdam(pp, pmu, pnu, groups)
    _build.reset_launches()
    for step in range(1, 6):
        grads = [torch.randn(s, generator=g, device=dev) * 10 ** (step - 3)
                 for s in shapes]
        bc1, bc2 = 1 - 0.9 ** step, 1 - 0.999 ** step
        kernel.step(grads, 1e-2, 6e-4, bc1, bc2)
        plain.step([t.cpu() for t in grads], 1e-2, 6e-4, bc1, bc2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_adam"] == 5
    for got, want in zip(kmu + knu, pmu + pnu):
        assert torch.equal(got.cpu(), want)
    for got, want in zip(kp, pp):
        want = want.to(dev)
        ulp = torch.finfo(torch.float32).eps * want.abs().clamp_min(1e-30)
        assert ((got - want).abs() <= ulp).all(), \
            ((got - want).abs() / ulp).max().item()
