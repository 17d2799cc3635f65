"""The port's dropout: Philox4x32-10 keep masks (ops/dropout_bits.py) and
the two training ops that draw them, on the CPU.

The TPU generator's bits cannot be reproduced, so dropout is checked as
the JAX tests check it (tests/test_pallas_ln.py, tests/test_pallas_mhsa.py
``test_dropout_matches_extracted_bits_oracle``): the probe returns the
mask, and output and gradients must equal a reference that the test builds
from that mask with the JAX kernels' formulas. The generator itself is
held to its published known-answer vectors, and the masks to their keep
rate, their seeding and their independence of how they are asked for.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from news_recommendation_mind_tpu_torch.ops.dropout_bits import (  # noqa: E402
    attn_keep_mask, fold_seed, keep_threshold, ln_keep_mask, philox4x32_10,
)
from news_recommendation_mind_tpu_torch.ops.fused_add_ln import (  # noqa: E402
    fused_add_ln,
)
from news_recommendation_mind_tpu_torch.ops.short_mhsa import (  # noqa: E402
    short_mhsa,
)

P = 0.1
SEED = 0xC0FFEE1234567890

# Random123's kat_vectors for philox4x32 with 10 rounds:
# (counter words, key words) -> output words
PHILOX_VECTORS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("case", range(len(PHILOX_VECTORS)))
def test_philox_known_answers(case):
    counter, key, want = PHILOX_VECTORS[case]
    words = philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                            for c in counter), key[0] | (key[1] << 32))
    assert tuple(int(w) for w in words) == want


def test_keep_threshold_is_the_jax_kernels():
    # pallas_ln.py:45-46: round((1 - p) * (2^32 - 1)) as an unsigned word
    assert keep_threshold(0.1) == int(round(0.9 * float(2 ** 32 - 1)))
    assert keep_threshold(0.0) == 2 ** 32 - 1
    with pytest.raises(ValueError):
        keep_threshold(1.0)


@pytest.mark.parametrize("which", ["ln", "attn"])
def test_keep_rate_seeds_and_repeatability(which):
    """Over at least 10^6 bits the keep rate lies within 4 sigma of 1 - p;
    one seed repeats; two seeds differ in about 2p(1-p) of the bits."""
    def draw(seed):
        if which == "ln":
            return ln_keep_mask(seed, 1400, 768, P, "cpu")
        return attn_keep_mask(seed, 100, 12, 30, P, "cpu")

    a, again, b = draw(SEED), draw(SEED), draw(fold_seed(SEED, 1))
    n = a.numel()
    assert n >= 10 ** 6 and a.dtype == torch.bool
    sigma = math.sqrt(P * (1 - P) / n)
    assert abs(a.float().mean().item() - (1 - P)) < 4 * sigma
    assert torch.equal(a, again)
    differ = (a != b).float().mean().item()
    assert abs(differ - 2 * P * (1 - P)) < 0.01


def test_masks_do_not_depend_on_the_extent_asked_for():
    """An element's bit is a function of the seed and its own coordinates:
    a larger tensor starts with the smaller one's mask."""
    small = ln_keep_mask(SEED, 5, 50, P, "cpu")
    large = ln_keep_mask(SEED, 9, 50, P, "cpu")
    assert torch.equal(large[:5], small)
    a_small = attn_keep_mask(SEED, 2, 3, 7, P, "cpu")
    a_large = attn_keep_mask(SEED, 4, 3, 7, P, "cpu")
    assert torch.equal(a_large[:2], a_small)
    # rows beyond 2^32 are counted in the third counter word
    assert fold_seed(SEED, 0) != fold_seed(SEED, 1) != fold_seed(SEED, 2)
    assert 0 <= fold_seed(2 ** 64 - 1, 2 ** 40) < 2 ** 64


def _ln_inputs(n=24, h=40, seed=0):
    rng = np.random.default_rng(seed)
    x, res, w = (torch.from_numpy(rng.standard_normal((n, h))
                                  .astype(np.float32)) for _ in range(3))
    scale = torch.from_numpy((rng.standard_normal(h) * 0.1 + 1.0)
                             .astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(h) * 0.1)
                            .astype(np.float32))
    return x, res, scale, bias, w


def test_fused_add_ln_dropout_matches_mask_reference():
    """y, dx, dres, dscale, dbias with p_drop = 0.1 against LN(x + where(
    keep, res / (1 - p), 0)) differentiated by autograd (pallas_ln.py:49-58
    forward, :77-109 backward); float32, summation order only: 1e-5."""
    x, res, scale, bias, w = _ln_inputs()
    n, h = x.shape
    keep = ln_keep_mask(SEED, n, h, P, "cpu")
    assert 0 < (~keep).sum() < keep.numel()
    leaves = [t.clone().requires_grad_() for t in (x, res, scale, bias)]
    y = fused_add_ln(*leaves, eps=1e-6, p_drop=P, seed=SEED)
    got = torch.autograd.grad((y * w).sum(), leaves)

    ref = [t.clone().requires_grad_() for t in (x, res, scale, bias)]
    s = ref[0] + torch.where(keep, ref[1] / (1 - P), torch.zeros(()))
    mean = s.mean(-1, keepdim=True)
    var = (s * s).mean(-1, keepdim=True) - mean * mean
    y_ref = (s - mean) * torch.rsqrt(var + 1e-6) * ref[2] + ref[3]
    want = torch.autograd.grad((y_ref * w).sum(), ref)
    np.testing.assert_allclose(y.detach().numpy(), y_ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # dropped elements of res get no gradient; kept ones dx / (1 - p)
    assert got[1][~keep].abs().max().item() == 0.0
    np.testing.assert_allclose(got[1][keep].numpy(),
                               (got[0][keep] / (1 - P)).numpy(), rtol=1e-6)


def test_short_mhsa_dropout_matches_mask_reference():
    """out, dq, dk, dv with p_drop = 0.1 against the dense formula with
    the probe's mask on the masked probabilities (pallas_mhsa.py:118-121),
    differentiated by autograd; a fully-masked article stays exactly 0."""
    U, S, H, NH = 6, 11, 24, 3
    rng = np.random.default_rng(1)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((U, S, H))
                                   .astype(np.float32)) for _ in range(4))
    mask = torch.from_numpy((rng.random((U, S)) > 0.25).astype(np.float32))
    mask[:, 0] = 1.0
    mask[4] = 0.0
    keep = attn_keep_mask(SEED, U, NH, S, P, "cpu")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = short_mhsa(*leaves, mask, NH, p_drop=P, seed=SEED)
    got = torch.autograd.grad((out * w).sum(), leaves)

    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    hd = H // NH
    q4, k4, v4 = (t.reshape(U, S, NH, hd).transpose(1, 2) for t in ref)
    m = mask[:, None, None, :]
    scores = q4 @ k4.transpose(-1, -2) / math.sqrt(hd)
    sig = torch.softmax(torch.where(m > 0, scores, torch.tensor(-1e9)), -1)
    pd = torch.where(keep, sig * m / (1 - P), torch.zeros(()))
    out_ref = (pd @ v4).transpose(1, 2).reshape(U, S, H)
    want = torch.autograd.grad((out_ref * w).sum(), ref)
    np.testing.assert_allclose(out.detach().numpy(),
                               out_ref.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert g[4].abs().max().item() == 0.0
    assert out[4].abs().max().item() == 0.0
    # the flat layout draws the same mask
    flat = short_mhsa(q.reshape(U * S, H), k.reshape(U * S, H),
                      v.reshape(U * S, H), mask, NH, p_drop=P, seq_len=S,
                      seed=SEED)
    assert torch.equal(flat.reshape(U, S, H), out.detach())


@pytest.mark.parametrize("op", ["ln", "mhsa"])
def test_dropout_zero_rate_is_the_deterministic_op(op):
    """p_drop = 0 ignores the seed and equals the call without dropout,
    bit for bit; another seed at p_drop > 0 gives another result."""
    if op == "ln":
        x, res, scale, bias, _ = _ln_inputs(seed=2)

        def call(p, seed):
            return fused_add_ln(x, res, scale, bias, p_drop=p, seed=seed)
    else:
        rng = np.random.default_rng(3)
        q, k, v = (torch.from_numpy(rng.standard_normal((4, 9, 16))
                                    .astype(np.float32)) for _ in range(3))
        mask = torch.ones(4, 9)

        def call(p, seed):
            return short_mhsa(q, k, v, mask, 2, p_drop=p, seed=seed)

    assert torch.equal(call(0.0, SEED), call(0.0, 0))
    assert torch.equal(call(P, SEED), call(P, SEED))
    assert not torch.equal(call(P, SEED), call(P, SEED + 1))
    assert not torch.equal(call(P, SEED), call(0.0, SEED))


@pytest.mark.parametrize("bad", ["rate", "seed"])
def test_dropout_arguments_are_checked(bad):
    x, res, scale, bias, _ = _ln_inputs(seed=4)
    with pytest.raises(ValueError):
        if bad == "rate":
            fused_add_ln(x, res, scale, bias, p_drop=1.0)
        else:
            fused_add_ln(x, res, scale, bias, p_drop=0.1, seed=2 ** 64)
