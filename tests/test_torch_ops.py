"""The PyTorch port's kernel modules (news_recommendation_mind_tpu_torch/
ops) against the JAX kernels they replace, on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
JAX side runs the Pallas kernels in interpret mode, as tests/
test_pallas_mhsa.py and tests/test_pallas_ln.py run them. Everything is
float32, and matmuls are kept out of TF32 on both sides. The CUDA kernels
themselves are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from news_recommendation_mind_tpu.models.attention import (  # noqa: E402
    masked_softmax as jax_masked_softmax,
    scaled_dp_attention as jax_scaled_dp_attention,
)
from news_recommendation_mind_tpu.ops.pallas_ln import (  # noqa: E402
    _jnp_reference, fused_add_ln as jax_fused_add_ln,
)
from news_recommendation_mind_tpu.ops.pallas_mhsa import (  # noqa: E402
    short_mhsa as jax_short_mhsa,
)
from news_recommendation_mind_tpu_torch.models.attention import (  # noqa: E402
    masked_softmax, scaled_dp_attention,
)
from news_recommendation_mind_tpu_torch.ops import _build  # noqa: E402
from news_recommendation_mind_tpu_torch.ops.fused_add_ln import (  # noqa: E402
    fused_add_ln, fused_add_ln_plain,
)
from news_recommendation_mind_tpu_torch.ops.short_mhsa import (  # noqa: E402
    short_mhsa,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

U, S, H, NH = 9, 13, 32, 4        # the Pallas tests' shape
FULLY_MASKED = 3


def _mhsa_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((U, S, H)).astype(np.float32)
               for _ in range(3))
    mask = (rng.random((U, S)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    mask[FULLY_MASKED] = 0.0
    return q, k, v, mask


@pytest.mark.parametrize("layout", ["3d", "flat"])
def test_short_mhsa_matches_pallas(layout):
    q, k, v, mask = _mhsa_inputs()
    if layout == "flat":
        q, k, v = (t.reshape(U * S, H) for t in (q, k, v))
        kw = {"seq_len": S}
    else:
        kw = {}
    want = np.asarray(jax_short_mhsa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        NH, interpret=True, force_kernel=True, **kw))
    _build.reset_launches()
    got = short_mhsa(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), torch.from_numpy(mask), NH, **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got3 = got.numpy().reshape(U, S, H)
    assert np.abs(got3[FULLY_MASKED]).max() == 0.0
    assert np.isfinite(got3).all()
    assert _build.LAUNCHES == {"fused_add_ln": 0, "short_mhsa": 0}


@pytest.mark.parametrize("n,h,oracle", [(64, 128, "kernel"),
                                        (40, 48, "jnp")])
def test_fused_add_ln_matches_jax(n, h, oracle):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, h)).astype(np.float32)
    res = rng.standard_normal((n, h)).astype(np.float32)
    scale = (rng.standard_normal(h) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(h) * 0.1).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, res, scale, bias)]
    if oracle == "kernel":
        # H % 128 == 0 and N % 8 == 0: the Pallas kernel's shape rule
        want = jax_fused_add_ln(*args, eps=1e-12, force_kernel=True,
                                interpret=True)
    else:
        want = _jnp_reference(*args, 1e-12)
    _build.reset_launches()
    got = fused_add_ln(*(torch.from_numpy(a) for a in (x, res, scale, bias)),
                       eps=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert _build.LAUNCHES == {"fused_add_ln": 0, "short_mhsa": 0}


def test_fused_add_ln_plain_stats():
    """The plain version's side outputs are the fp32 row stats the
    training slice's backward reads."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((6, 20)).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((6, 20)).astype(np.float32))
    y, mean, rstd = fused_add_ln_plain(x.bfloat16(), res.bfloat16(),
                                       torch.ones(20), torch.zeros(20))
    s = x.bfloat16().float() + res.bfloat16().float()
    assert y.dtype == torch.bfloat16
    assert mean.shape == rstd.shape == (6, 1)
    assert mean.dtype == rstd.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), s.mean(-1, keepdim=True).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        rstd.numpy(), (1.0 / s.var(-1, unbiased=False, keepdim=True).sqrt())
        .numpy(), rtol=1e-4)


@pytest.mark.parametrize("call", ["mhsa", "ln"])
def test_dropout_raises(call):
    t = torch.zeros(4, 8)
    with pytest.raises(NotImplementedError, match="training slice"):
        if call == "mhsa":
            short_mhsa(t, t, t, torch.ones(2, 2), 2, p_drop=0.1, seq_len=2)
        else:
            fused_add_ln(t, t, torch.ones(8), torch.zeros(8), p_drop=0.1)


@pytest.mark.parametrize("bad", ["long_seq", "heads", "mask_shape",
                                 "ln_dtype"])
def test_wrappers_reject_bad_inputs(bad):
    if bad == "long_seq":
        t = torch.zeros(2, 65, 8)
        with pytest.raises(ValueError, match="S ≤ 64"):
            short_mhsa(t, t, t, torch.ones(2, 65), 2)
    elif bad == "heads":
        t = torch.zeros(2, 4, 9)
        with pytest.raises(ValueError, match="heads"):
            short_mhsa(t, t, t, torch.ones(2, 4), 2)
    elif bad == "mask_shape":
        t = torch.zeros(8, 6)
        with pytest.raises(ValueError, match="key_mask"):
            short_mhsa(t, t, t, torch.ones(2, 5), 2, seq_len=4)
    else:
        t = torch.zeros(4, 8, dtype=torch.float16)
        with pytest.raises(TypeError):
            fused_add_ln(t, t, torch.ones(8), torch.zeros(8))


def test_attention_primitives_match_jax():
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((3, 2, 5, 7)).astype(np.float32)
    mask = (rng.random((3, 1, 1, 7)) > 0.4).astype(np.float32)
    mask[1] = 0.0
    got = masked_softmax(torch.from_numpy(scores), torch.from_numpy(mask))
    want = jax_masked_softmax(jnp.asarray(scores), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert np.abs(got.numpy()[1]).max() == 0.0
    q = rng.standard_normal((1, 16)).astype(np.float32)
    kv = rng.standard_normal((3, 6, 16)).astype(np.float32)
    m = (rng.random((3, 1, 6)) > 0.3).astype(np.float32)
    got = scaled_dp_attention(torch.from_numpy(q), torch.from_numpy(kv),
                              torch.from_numpy(kv), torch.from_numpy(m))
    want = jax_scaled_dp_attention(jnp.asarray(q), jnp.asarray(kv),
                                   jnp.asarray(kv), jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
