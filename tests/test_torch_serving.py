"""The PyTorch port's serving slice against the JAX package, on the CPU.

A 60-article news table made from a numpy seed is served at a small
width (H = 64, 4 heads, 2 layers, float32) from the same JAX-initialised
weights on both sides. The port's ``encode_all_news`` table equals the
JAX ``encode_all_news`` over the JAX ``NewsLoader`` (padded last batch
included); the port's ``Recommender`` answers ``score``, ``rank`` and
``retrieve`` as the JAX formulas (news_recommendation_mind_tpu/serving.py:
72-80, 120-129) answer on the JAX table. The JAX ``Recommender`` itself
needs ``build_data``, so its formulas are applied directly here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_recommendation_mind_tpu.config import Config as JaxConfig  # noqa: E402
from news_recommendation_mind_tpu.data.cache import (  # noqa: E402
    NewsCache as JaxNewsCache,
)
from news_recommendation_mind_tpu.data.loader import (  # noqa: E402
    NewsLoader as JaxNewsLoader,
)
from news_recommendation_mind_tpu.evaluation.engine import (  # noqa: E402
    encode_all_news as jax_encode_all_news,
)
from news_recommendation_mind_tpu.experiment import (  # noqa: E402
    build_model as jax_build_model,
)
from news_recommendation_mind_tpu_torch.config import Config  # noqa: E402
from news_recommendation_mind_tpu_torch.data.cache import NewsCache  # noqa: E402
from news_recommendation_mind_tpu_torch.data.loader import (  # noqa: E402
    NewsLoader,
)
from news_recommendation_mind_tpu_torch.evaluation.engine import (  # noqa: E402
    encode_all_news,
)
from news_recommendation_mind_tpu_torch.experiment import (  # noqa: E402
    build_model,
)
from news_recommendation_mind_tpu_torch.serving import (  # noqa: E402
    Recommender,
)
from news_recommendation_mind_tpu_torch.weights import (  # noqa: E402
    jax_params_to_torch,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_NEWS, VOCAB, SL, MAX_TOK, HIS = 60, 300, 12, 20, 10
FIELDS = dict(model="plm", bert="newsbert", encoderU="attn", bert_dim=64,
              head_num=4, bert_layers=2, signal_length=SL, his_size=HIS,
              batch_size_news=16, dtype="float32", seed=0)
TOL = 1e-5


def _news_arrays(seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((N_NEWS + 1, MAX_TOK), np.int32)
    attn = np.zeros((N_NEWS + 1, MAX_TOK), np.uint8)
    lens = rng.integers(1, MAX_TOK + 1, N_NEWS)   # some exceed SL
    for i, n in enumerate(lens, start=1):
        toks[i, 0] = 101
        toks[i, 1:n] = rng.integers(1, VOCAB, n - 1)
        attn[i, :n] = 1
    nid2idx = {f"N{i}": i for i in range(1, N_NEWS + 1)}
    return toks, attn, nid2idx


@pytest.fixture(scope="module")
def served():
    toks, attn, nid2idx = _news_arrays()
    jcfg = JaxConfig(vocab_size=VOCAB, **FIELDS)
    jmodel = jax_build_model(jcfg, VOCAB, 0)
    sample = {"cdd_token": jnp.asarray(toks[None, 1:3, :SL]),
              "cdd_attn": jnp.asarray(attn[None, 1:3, :SL], jnp.float32),
              "his_token": jnp.asarray(toks[None, 3:5, :SL]),
              "his_attn": jnp.asarray(attn[None, 3:5, :SL], jnp.float32),
              "his_mask": jnp.ones((1, 2), jnp.float32)}
    params = jax.tree.map(np.asarray,
                          jmodel.init(jax.random.PRNGKey(0), sample))
    jnews = JaxNewsCache(toks, attn, nid2idx, 102)
    loader = JaxNewsLoader(jnews, batch_size=16, signal_length=SL)
    jtable = jax_encode_all_news(jmodel, params, loader, 64)
    cfg = Config(vocab_size=VOCAB, **FIELDS)
    rec = Recommender(cfg, NewsCache(toks, attn, nid2idx, 102),
                      params=params, device="cpu")
    return jmodel, params, jtable, rec


def _jax_user(jmodel, params, jtable, history, his_size):
    his = np.zeros(his_size, np.int32)
    his_mask = np.zeros(his_size, np.float32)
    kept = history[:his_size]
    his[:len(kept)] = kept
    his_mask[:max(len(kept), 1)] = 1.0
    table = jnp.asarray(jtable)
    return jmodel.apply(params, jnp.take(table, jnp.asarray(his), axis=0)[None],
                        jnp.asarray(his_mask)[None], jnp.asarray([0]),
                        method=type(jmodel).encode_user_from_reprs)


def _jax_scores(jmodel, params, jtable, history, cdd):
    """serving.py:72-80 on the JAX table."""
    user = _jax_user(jmodel, params, jtable, history, HIS)
    c = jnp.take(jnp.asarray(jtable), jnp.asarray(cdd), axis=0)[None]
    d = jnp.asarray(c.shape[-1], c.dtype)
    return np.asarray(jax.nn.sigmoid(
        jnp.einsum("bwh,buh->bw", c, user) / jnp.sqrt(d))[0])


def test_table_matches_jax_sweep(served):
    _, _, jtable, rec = served
    assert rec.table.dtype == torch.float32
    assert rec.table.shape == jtable.shape == (N_NEWS + 1, 64)
    # 61 rows in batches of 16: the last batch holds 13 rows + 3 pad rows
    assert len(NewsLoader(rec.news, batch_size=16, signal_length=SL)) == 4
    np.testing.assert_allclose(rec.table.numpy(), jtable,
                               rtol=TOL, atol=TOL)


def test_encode_all_news_with_fresh_model():
    """The engine alone, on a model built from ``cfg.seed``: every row is
    written once, padded rows are dropped, and batch size does not
    matter."""
    toks, attn, nid2idx = _news_arrays(seed=1)
    cfg = Config(vocab_size=VOCAB, **FIELDS)
    model = build_model(cfg, VOCAB, device="cpu")
    news = NewsCache(toks, attn, nid2idx, 102)
    a = encode_all_news(model, NewsLoader(news, batch_size=16,
                                          signal_length=SL), 64, device="cpu")
    b = encode_all_news(model, NewsLoader(news, batch_size=61,
                                          signal_length=SL), 64, device="cpu")
    assert np.isfinite(a.numpy()).all()
    assert (a.abs().sum(dim=1) > 0).all()
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_his,n_cdd", [(0, 5), (4, 8), (15, 20)])
def test_score_and_rank_match_jax(served, n_his, n_cdd):
    jmodel, params, jtable, rec = served
    rng = np.random.default_rng(n_his * 100 + n_cdd)
    history = [int(i) for i in rng.choice(np.arange(1, N_NEWS + 1), n_his,
                                          replace=False)]
    cands = [int(i) for i in rng.choice(np.arange(1, N_NEWS + 1), n_cdd,
                                        replace=False)]
    width = 8 if n_cdd <= 8 else 32
    cdd = np.zeros(width, np.int32)
    cdd[:n_cdd] = cands
    want = _jax_scores(jmodel, params, jtable, history, cdd)[:n_cdd]
    got = rec.score([f"N{i}" for i in history], [f"N{i}" for i in cands])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    ranked = rec.rank([f"N{i}" for i in history], [f"N{i}" for i in cands])
    order = np.argsort(-want, kind="stable")
    assert [nid for nid, _ in ranked] == [f"N{cands[i]}" for i in order]


@pytest.mark.parametrize("exclude", [True, False])
def test_retrieve_matches_jax(served, exclude):
    jmodel, params, jtable, rec = served
    history = [5, 17, 33, 41]
    user = _jax_user(jmodel, params, jtable, history, HIS)
    table = jnp.asarray(jtable)
    d = jnp.asarray(table.shape[-1], table.dtype)
    scores = jax.nn.sigmoid(
        jnp.einsum("nh,buh->bn", table, user)[0] / jnp.sqrt(d))
    scores = scores.at[0].set(-jnp.inf)
    vals, idx = jax.lax.top_k(scores, N_NEWS)
    skip = set(history) if exclude else set()
    want = [(f"N{int(i)}", float(v)) for i, v in zip(idx, vals)
            if int(i) not in skip][:10]
    got = rec.retrieve([f"N{i}" for i in history], k=10,
                       exclude_history=exclude)
    assert [nid for nid, _ in got] == [nid for nid, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=TOL, atol=TOL)
    if exclude:
        assert not {f"N{i}" for i in history} & {nid for nid, _ in got}


def test_fresh_recommender_and_weights_bridge(served):
    """params=None serves fresh weights from cfg.seed; loading the JAX
    tree into a fresh model reproduces the served table."""
    _, params, _, rec = served
    toks, attn, nid2idx = _news_arrays()
    cfg = Config(vocab_size=VOCAB, **FIELDS)
    fresh = Recommender(cfg, NewsCache(toks, attn, nid2idx, 102),
                        device="cpu")
    assert not torch.allclose(fresh.table, rec.table)
    model = build_model(cfg, VOCAB, device="cpu")
    model.load_state_dict(jax_params_to_torch(params))
    loader = NewsLoader(rec.news, batch_size=16, signal_length=SL)
    table = encode_all_news(model, loader, 64, device="cpu")
    np.testing.assert_array_equal(table.numpy(), rec.table.numpy())


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    toks, attn, nid2idx = _news_arrays()
    cfg = Config(vocab_size=VOCAB, **FIELDS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Recommender(cfg, NewsCache(toks, attn, nid2idx, 102))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg, VOCAB)
    bad = toks.copy()
    bad[3, 2] = VOCAB
    with pytest.raises(ValueError, match="vocab_size"):
        Recommender(cfg, NewsCache(bad, attn, nid2idx, 102), device="cpu")
