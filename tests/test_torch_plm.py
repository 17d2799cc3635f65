"""The PyTorch port's PLM (BERT news encoder + attention-pooling user
encoder) against the JAX PLM on the same weights, on the CPU.

The JAX model is initialised with PRNGKey(0), its parameter tree is
carried across by ``weights.jax_params_to_torch``, and both models see the
same numpy inputs: ragged masks and one all-pad article. float32 agrees
within 1e-4 (sums taken in another order through two layers); a bfloat16
run of both agrees within 3e-2 (the two frameworks round bf16 at other
places: the JAX CPU path runs attention in bf16, the port's attention
computes in fp32 as the TPU kernel does).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_recommendation_mind_tpu.models.bert import (  # noqa: E402
    BertModel as JaxBertModel, bert_variant as jax_bert_variant,
)
from news_recommendation_mind_tpu.models.plm import PLM as JaxPLM  # noqa: E402
from news_recommendation_mind_tpu.models.user_encoders import (  # noqa: E402
    AttentionPooling as JaxAttentionPooling,
)
from news_recommendation_mind_tpu_torch.models.bert import (  # noqa: E402
    BertModel, bert_variant,
)
from news_recommendation_mind_tpu_torch.models.plm import PLM  # noqa: E402
from news_recommendation_mind_tpu_torch.models.user_encoders import (  # noqa: E402
    AttentionPooling,
)
from news_recommendation_mind_tpu_torch.weights import (  # noqa: E402
    jax_params_to_torch,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, HEADS, FFN, VOCAB, LAYERS, S = 64, 4, 128, 300, 2, 12
B, N, HIS = 3, 4, 6
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _variant(bert_variant_fn):
    return bert_variant_fn("newsbert", vocab_size=VOCAB,
                           num_layers=LAYERS).replace(
        hidden_size=H, num_heads=HEADS, intermediate_size=FFN)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB, (B, N, S)).astype(np.int32)
    lens = rng.integers(1, S + 1, (B, N))
    lens[0, 0] = S
    attn = (np.arange(S)[None, None, :] < lens[..., None]).astype(np.float32)
    tokens = tokens * attn.astype(np.int32)
    tokens[1, 2] = 0              # the all-pad article (news row 0)
    attn[1, 2] = 0.0
    his_repr = rng.standard_normal((B, HIS, H)).astype(np.float32)
    his_mask = (np.arange(HIS)[None, :]
                < np.array([HIS, 2, 1])[:, None]).astype(np.float32)
    return tokens, attn, his_repr, his_mask


@pytest.fixture(scope="module")
def jax_params():
    model = _jax_model(jnp.float32)
    tokens, attn, _, his_mask = _inputs()
    batch = {"cdd_token": tokens, "cdd_attn": attn, "his_token": tokens,
             "his_attn": attn, "his_mask": his_mask[:, :N]}
    variables = model.init(jax.random.PRNGKey(0),
                           jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, variables)


def _jax_model(dtype):
    return JaxPLM(bert=JaxBertModel(_variant(jax_bert_variant), dtype=dtype),
                  user_encoder=JaxAttentionPooling(H, dtype=dtype),
                  hidden_dim=H)


def _torch_model(dtype, params):
    model = PLM(BertModel(_variant(bert_variant), dtype=dtype),
                AttentionPooling(H, dtype=dtype), hidden_dim=H)
    model.load_state_dict(jax_params_to_torch(params))
    return model.eval()


def test_weight_bridge_layout(jax_params):
    sd = jax_params_to_torch(jax_params)
    bert = jax_params["params"]["bert"]
    k = bert["layer_1"]["ffn_in"]["kernel"]
    assert k.shape == (H, FFN)
    np.testing.assert_array_equal(
        sd["bert.layers.1.ffn_in.weight"].numpy(), k.T)
    np.testing.assert_array_equal(
        sd["bert.word_embeddings.weight"].numpy(),
        bert["word_embeddings"]["embedding"])
    np.testing.assert_array_equal(sd["bert.layers.0.attn_norm.weight"].numpy(),
                                  bert["layer_0"]["attn_norm"]["scale"])
    assert sd["user_encoder.query_news"].shape == (1, H)
    # strict load: every name and shape of the tree matches the model
    _torch_model(torch.float32, jax_params)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_news_matches_jax(jax_params, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    tokens, attn, _, _ = _inputs()
    jmodel = _jax_model(jdt)
    flat_t, flat_a = tokens.reshape(B * N, S), attn.reshape(B * N, S)
    j_hidden, j_pooled = jmodel.apply(
        jax_params, jnp.asarray(flat_t), jnp.asarray(flat_a),
        method=lambda m, t, a: m.bert(t, a))
    j_news = jmodel.apply(jax_params, jnp.asarray(tokens), jnp.asarray(attn),
                          method=JaxPLM.encode_news)
    model = _torch_model(tdt, jax_params)
    with torch.inference_mode():
        hidden, pooled = model.bert(torch.from_numpy(flat_t),
                                    torch.from_numpy(flat_a))
        news = model.encode_news(torch.from_numpy(tokens),
                                 torch.from_numpy(attn))
    assert hidden.dtype == pooled.dtype == news.dtype == tdt
    for got, want in ((hidden, j_hidden), (pooled, j_pooled), (news, j_news)):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_user_from_reprs_matches_jax(jax_params, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    _, _, his_repr, his_mask = _inputs(seed=1)
    want = _jax_model(jdt).apply(
        jax_params, jnp.asarray(his_repr), jnp.asarray(his_mask),
        method=JaxPLM.encode_user_from_reprs)
    model = _torch_model(tdt, jax_params)
    with torch.inference_mode():
        got = model.encode_user_from_reprs(torch.from_numpy(his_repr),
                                           torch.from_numpy(his_mask))
    assert got.shape == (B, 1, H) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_forward_and_live_user_encoding_match_jax(jax_params):
    """The training forward over a batch dict (candidates and history
    encoded live) and ``encode_user``, deterministic, float32."""
    tokens, attn, _, his_mask = _inputs()
    batch = {"cdd_token": tokens, "cdd_attn": attn, "his_token": tokens,
             "his_attn": attn, "his_mask": his_mask[:, :N]}
    jmodel = _jax_model(jnp.float32)
    jbatch = jax.tree.map(jnp.asarray, batch)
    want = jmodel.apply(jax_params, jbatch)
    want_user = jmodel.apply(jax_params, jbatch["his_token"],
                             jbatch["his_attn"], jbatch["his_mask"],
                             method=JaxPLM.encode_user)
    model = _torch_model(torch.float32, jax_params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = model(tbatch)
        got_user = model.encode_user(tbatch["his_token"], tbatch["his_attn"],
                                     tbatch["his_mask"])
    assert got.shape == (B, N) and got_user.shape == (B, 1, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_user.numpy(), np.asarray(want_user),
                               rtol=1e-4, atol=1e-4)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="XFormer slice"):
        bert_variant("longformer")
    model = BertModel(_variant(bert_variant))
    ids = torch.zeros(1, 65, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="XFormer slice"):
        model(ids, torch.ones(1, 65))


@pytest.mark.parametrize("variant,debias", [("distill", False),
                                            ("newsbert", True)])
def test_variant_and_debias_match_jax(variant, debias):
    """distill (gelu_cls pooler, no token-type table) and the learned
    user bias, in float32, on their own JAX-initialised weights."""
    def make(fn):
        return fn(variant, vocab_size=VOCAB, num_layers=LAYERS).replace(
            hidden_size=H, num_heads=HEADS, intermediate_size=FFN)

    tokens, attn, his_repr, his_mask = _inputs(seed=2)
    jmodel = JaxPLM(bert=JaxBertModel(make(jax_bert_variant)),
                    user_encoder=JaxAttentionPooling(H), hidden_dim=H,
                    debias=debias)
    batch = {"cdd_token": tokens, "cdd_attn": attn, "his_token": tokens,
             "his_attn": attn, "his_mask": his_mask[:, :N]}
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), jax.tree.map(jnp.asarray, batch)))
    j_news = jmodel.apply(params, jnp.asarray(tokens), jnp.asarray(attn),
                          method=JaxPLM.encode_news)
    j_user = jmodel.apply(params, jnp.asarray(his_repr),
                          jnp.asarray(his_mask),
                          method=JaxPLM.encode_user_from_reprs)
    model = PLM(BertModel(make(bert_variant)), AttentionPooling(H),
                hidden_dim=H, debias=debias)
    model.load_state_dict(jax_params_to_torch(params))
    with torch.inference_mode():
        news = model.encode_news(torch.from_numpy(tokens),
                                 torch.from_numpy(attn))
        user = model.encode_user_from_reprs(torch.from_numpy(his_repr),
                                            torch.from_numpy(his_mask))
    np.testing.assert_allclose(news.numpy(), np.asarray(j_news),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(user.numpy(), np.asarray(j_user),
                               rtol=1e-4, atol=1e-4)
