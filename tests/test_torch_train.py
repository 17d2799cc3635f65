"""The port's training path (train/, models/two_tower.py, data/loader.py,
ops/fused_adam.py) against the JAX package's, on the CPU.

Both sides get the same numpy inputs and the same weights (the JAX model's
PRNGKey(0) initialisation, carried over by ``weights.jax_params_to_torch``
and compared back through ``weights.torch_to_jax_tree``). The port runs
its plain versions (CPU tensors); the JAX side runs as its own CPU tests
run it: the jnp references inside the model, and ``fused_apply``'s jnp
leaf math. Everything is float32. The encoder dropouts are off where the
two packages are compared (the TPU generator's bits cannot be matched);
dropout itself is held to its mask in tests/test_torch_dropout.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_recommendation_mind_tpu.data.cache import (  # noqa: E402
    Behaviors as JaxBehaviors, NewsCache as JaxNewsCache,
)
from news_recommendation_mind_tpu.data.loader import (  # noqa: E402
    TrainLoader as JaxTrainLoader,
)
from news_recommendation_mind_tpu.models.bert import (  # noqa: E402
    BertModel as JaxBertModel, bert_variant as jax_bert_variant,
)
from news_recommendation_mind_tpu.models.plm import PLM as JaxPLM  # noqa: E402
from news_recommendation_mind_tpu.models.two_tower import (  # noqa: E402
    forward_from_unique as jax_forward_from_unique,
    train_loss as jax_train_loss,
)
from news_recommendation_mind_tpu.models.user_encoders import (  # noqa: E402
    AttentionPooling as JaxAttentionPooling,
)
from news_recommendation_mind_tpu.ops.pallas_adam import (  # noqa: E402
    adam_leaf_eligible,
)
from news_recommendation_mind_tpu.train.state import (  # noqa: E402
    create_train_state as jax_create_train_state,
    make_fused_optimizer as jax_make_fused_optimizer,
)
from news_recommendation_mind_tpu.train.step import (  # noqa: E402
    make_train_step as jax_make_train_step,
)
from news_recommendation_mind_tpu_torch.config import Config  # noqa: E402
from news_recommendation_mind_tpu_torch.data.cache import (  # noqa: E402
    Behaviors, NewsCache,
)
from news_recommendation_mind_tpu_torch.data.loader import (  # noqa: E402
    TrainLoader, ensure_tokens,
)
from news_recommendation_mind_tpu_torch.experiment import (  # noqa: E402
    DataBundle, build_model, build_train_loader,
)
from news_recommendation_mind_tpu_torch.models.bert import (  # noqa: E402
    BertModel, bert_variant,
)
from news_recommendation_mind_tpu_torch.models.plm import PLM  # noqa: E402
from news_recommendation_mind_tpu_torch.models.two_tower import (  # noqa: E402
    forward_from_unique, take_rows, train_loss,
)
from news_recommendation_mind_tpu_torch.models.user_encoders import (  # noqa: E402,E501
    AttentionPooling,
)
from news_recommendation_mind_tpu_torch.ops import _build  # noqa: E402
from news_recommendation_mind_tpu_torch.train.loop import Trainer  # noqa: E402
from news_recommendation_mind_tpu_torch.train.state import (  # noqa: E402
    create_train_state, make_fused_optimizer, optimizer_for,
)
from news_recommendation_mind_tpu_torch.train.step import (  # noqa: E402
    make_train_step,
)
from news_recommendation_mind_tpu_torch.weights import (  # noqa: E402
    jax_params_to_torch, torch_to_jax_tree,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, HEADS, FFN, VOCAB, LAYERS, S = 64, 4, 128, 300, 2, 12
B, C, HIS, N_NEWS, U_PAD = 4, 3, 5, 14, 16
LR, BERT_LR = 1e-3, 1e-4


# ---- fused Adam (K7) -------------------------------------------------------

def _leaf_names():
    """Names in both learning-rate groups; the [5] and [3, 7] leaves fail
    the Pallas eligibility rule (pallas_adam.py:45-56), [16, 128] passes."""
    return {"bert.layers.0.ffn_in.weight": (16, 128),
            "bert.embed_norm.bias": (5,),
            "user_encoder.query_news": (3, 7),
            "head.weight": (8, 128)}


@pytest.mark.parametrize("scheduler", ["none", "linear"])
def test_fused_adam_matches_fused_apply(scheduler):
    """Five steps of the port's Adam (plain version) against the JAX
    ``fused_apply``: parameters and both moments, for both learning-rate
    groups. Both sides do the same float32 operations in the same order.
    The moments agree within 2 ulp (2·2^-23 relative; XLA may fuse a
    multiply-add where torch rounds twice). The parameters cannot be held
    that tightly against JAX: the bias correction 1 − 0.999^c is a
    difference of nearby numbers, so one ulp of 0.999^c is 6e-5/c of it,
    and JAX's own eager and jitted ``decay ** count`` differ by that ulp
    (the port takes the float32 ``powf``). Through the square root that is
    3e-5/c of an update of about the learning rate (1e-2 here), summed
    over five steps: 6e-7 absolute."""
    shapes = _leaf_names()
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    eligible = {k: adam_leaf_eligible(jnp.asarray(v))
                for k, v in init.items()}
    assert eligible["bert.layers.0.ffn_in.weight"]
    assert not eligible["bert.embed_norm.bias"]
    assert not eligible["user_encoder.query_news"]
    kw = dict(scheduler=scheduler, warmup=2, total_steps=6)

    jparams = torch_to_jax_tree({k: torch.from_numpy(v)
                                 for k, v in init.items()})
    jparams = jax.tree.map(jnp.asarray, jparams)
    jopt = jax_make_fused_optimizer(1e-2, 3e-4, **kw)
    jstate = jopt.init(jparams)

    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = make_fused_optimizer(1e-2, 3e-4, **kw)
    assert opt.leaf_group("bert.layers.0.ffn_in.weight") == "bert"
    assert opt.leaf_group("user_encoder.query_news") == "main"
    state = opt.init(params)

    for step in range(5):
        grads = {k: (rng.standard_normal(s) * 10.0 ** (step - 2))
                 .astype(np.float32) for k, s in shapes.items()}
        jgrads = jax.tree.map(jnp.asarray, torch_to_jax_tree(
            {k: torch.from_numpy(v) for k, v in grads.items()}))
        jparams, jstate = jopt.fused_apply(jparams, jstate, jgrads)
        opt.fused_apply(params, state,
                        {k: torch.from_numpy(v) for k, v in grads.items()})
        assert state.count == int(jstate.count) == step + 1
        for got_tree, want_tree, atol in (
                (torch_to_jax_tree(params), jparams, 6e-7),
                (torch_to_jax_tree(state.mu), jstate.mu, 0.0),
                (torch_to_jax_tree(state.nu), jstate.nu, 0.0)):
            got_leaves = jax.tree_util.tree_leaves_with_path(got_tree)
            want_leaves = jax.tree_util.tree_leaves_with_path(want_tree)
            assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
            for (_, got), (_, want) in zip(got_leaves, want_leaves):
                np.testing.assert_allclose(got, np.asarray(want),
                                           rtol=2 * 2.0 ** -23, atol=atol)
    assert set(_build.LAUNCHES.values()) == {0}


def test_schedule_reads_the_old_count():
    """The learning rate of a step is the schedule at the count before the
    step, the bias corrections use the count after it (train/state.py:
    164-172): with linear warmup from 0 the first step moves nothing."""
    opt = make_fused_optimizer(1e-2, 1e-3, scheduler="linear", warmup=4,
                               total_steps=10)
    assert opt.lrs["main"](0) == 0.0
    assert opt.lrs["main"](4) == pytest.approx(1e-2)
    assert opt.lrs["bert"](7) == pytest.approx(1e-3 * 0.5)
    assert opt.lrs["main"](10) == 0.0
    p = {"w": torch.ones(3)}
    state = opt.init(p)
    opt.fused_apply(p, state, {"w": torch.ones(3)})
    assert torch.equal(p["w"], torch.ones(3)) and state.count == 1
    opt.fused_apply(p, state, {"w": torch.ones(3)})
    np.testing.assert_allclose(p["w"].numpy(), 1.0 - 1e-2 / 4, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_fused_optimizer(1e-2, 1e-3, scheduler="cosine")
    with pytest.raises(NotImplementedError, match="fused_adam=False"):
        optimizer_for(Config(fused_adam=False))


# ---- one model, one batch, both packages -----------------------------------

def _variant(fn):
    return fn("newsbert", vocab_size=VOCAB, num_layers=LAYERS).replace(
        hidden_size=H, num_heads=HEADS, intermediate_size=FFN,
        hidden_dropout=0.0, attention_dropout=0.0)


def _jax_model():
    return JaxPLM(bert=JaxBertModel(_variant(jax_bert_variant)),
                  user_encoder=JaxAttentionPooling(H), hidden_dim=H)


def _torch_model(params):
    model = PLM(BertModel(_variant(bert_variant)), AttentionPooling(H),
                hidden_dim=H)
    model.load_state_dict(jax_params_to_torch(params))
    return model


def _news_table(derive_attn: bool, seed=0):
    """[N_NEWS + 1, S] tokens and masks, row 0 the pad article. With
    ``derive_attn`` the masks equal ``token != 0``; otherwise one article
    masks out a non-pad token, so the step must gather the mask table."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, S + 1, N_NEWS + 1)
    attn = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    toks = rng.integers(1, VOCAB, (N_NEWS + 1, S)).astype(np.int32)
    toks = toks * attn.astype(np.int32)
    toks[0], attn[0] = 0, 0.0
    if not derive_attn:
        attn[3, lens[3] - 1] = 0.0
    return toks, attn


def _batch(seed=1):
    """ids-only batch with its dedup keys (sorted unique ids, padded with
    the pad article to U_PAD), ragged histories, one padded candidate and
    one user without history."""
    rng = np.random.default_rng(seed)
    cdd = rng.integers(1, N_NEWS + 1, (B, C)).astype(np.int32)
    his = rng.integers(1, N_NEWS + 1, (B, HIS)).astype(np.int32)
    his_len = np.array([HIS, 3, 1, 0])
    his_mask = (np.arange(HIS)[None, :] <
                np.maximum(his_len, 1)[:, None]).astype(np.float32)
    his = his * (np.arange(HIS)[None, :] < his_len[:, None])
    cdd_mask = np.ones((B, C), np.float32)
    cdd[2, 2], cdd_mask[2, 2] = 0, 0.0
    uniq, inv = np.unique(np.concatenate([cdd.ravel(), his.ravel()]),
                          return_inverse=True)
    uniq_id = np.zeros(U_PAD, np.int32)
    uniq_id[:len(uniq)] = uniq
    return {"user_id": np.arange(B, dtype=np.int32),
            "cdd_id": cdd, "his_id": his.astype(np.int32),
            "cdd_mask": cdd_mask, "his_mask": his_mask,
            "label": np.array([0, 2, 1, 0], np.int32),
            "uniq_id": uniq_id,
            "cdd_pos": inv[:cdd.size].reshape(B, C).astype(np.int32),
            "his_pos": inv[cdd.size:].reshape(B, HIS).astype(np.int32)}


def _with_tokens(batch, toks, attn):
    out = dict(batch)
    for side in ("cdd", "his"):
        out[f"{side}_token"] = toks[batch[f"{side}_id"]]
        out[f"{side}_attn"] = attn[batch[f"{side}_id"]]
    out["uniq_token"] = toks[batch["uniq_id"]]
    out["uniq_attn"] = attn[batch["uniq_id"]]
    return out


@pytest.fixture(scope="module")
def jax_params():
    toks, attn = _news_table(True)
    full = _with_tokens(_batch(), toks, attn)
    variables = _jax_model().init(jax.random.PRNGKey(0),
                                  jax.tree.map(jnp.asarray, full))
    return jax.tree.map(np.asarray, variables)


def _assert_trees_close(got_tree, want_tree, tol_of, rtol=0.0):
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        tol = tol_of(jax.tree_util.keystr(path))
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_forward_from_unique_equals_plain_forward(jax_params):
    """Scores of the deduplicated forward equal the plain forward's (the
    same articles through the same encoder, gathered per slot) and the JAX
    ``forward_from_unique``'s: float32, 1e-5."""
    toks, attn = _news_table(True)
    full = _with_tokens(_batch(), toks, attn)
    model = _torch_model(jax_params)
    tb = {k: torch.from_numpy(v) for k, v in full.items()}
    with torch.no_grad():
        plain = model(tb)
        dedup = forward_from_unique(model, tb)
    want = _jax_model().apply(jax_params, jax.tree.map(jnp.asarray, full),
                              True, method=jax_forward_from_unique)
    assert plain.shape == dedup.shape == (B, C)
    np.testing.assert_allclose(dedup.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(dedup.numpy(), np.asarray(want), atol=1e-5)
    # out-of-range slots clamp, as jnp.take(mode="clip") clamps them
    table = torch.arange(6.0).reshape(3, 2)
    got = take_rows(table, torch.tensor([-4, 1, 9]))
    assert torch.equal(got, table[[0, 1, 2]])


def test_train_loss_masks_padded_candidates():
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((B, C)).astype(np.float32)
    label = np.array([0, 2, 1, 0], np.int32)
    mask = np.ones((B, C), np.float32)
    mask[2, 2] = 0.0
    for m in (None, mask):
        want = jax_train_loss(jnp.asarray(scores), jnp.asarray(label),
                              None if m is None else jnp.asarray(m))
        got = train_loss(torch.from_numpy(scores), torch.from_numpy(label),
                         None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_gradients_match_jax(jax_params):
    """Every gradient leaf of the dedup loss, port autograd against
    ``jax.grad``: float32, summation order only, 1e-5 absolute and
    relative on gradients whose largest entries are of order 1."""
    toks, attn = _news_table(True)
    full = _with_tokens(_batch(), toks, attn)
    jbatch = jax.tree.map(jnp.asarray, full)
    jmodel = _jax_model()

    def jax_loss(params):
        scores = jmodel.apply(params, jbatch, False,
                              method=jax_forward_from_unique)
        return jax_train_loss(scores, jbatch["label"], jbatch["cdd_mask"])

    want = jax.grad(jax_loss)(jax.tree.map(jnp.asarray, jax_params))
    model = _torch_model(jax_params)
    tb = {k: torch.from_numpy(v) for k, v in full.items()}
    loss = train_loss(forward_from_unique(model, tb, False, seed=3),
                      tb["label"], tb["cdd_mask"])
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = torch_to_jax_tree(dict(zip(names, grads)))
    _assert_trees_close(got, want, lambda _: 1e-5, rtol=1e-5)
    biggest = max(np.abs(leaf).max()
                  for leaf in jax.tree_util.tree_leaves(got))
    assert biggest > 1e-1


@pytest.mark.parametrize("branch,remat,derive_attn", [
    ("dedup", False, True), ("dedup", True, True),
    ("plain", False, True), ("plain", True, False),
    ("dedup", False, False)])
def test_train_steps_match_jax(jax_params, branch, remat, derive_attn):
    """One ``make_train_step`` step and then three more, port against JAX,
    on bridged weights with the token table resident in the step, both
    learning-rate groups and the linear schedule.

    Tolerances: the loss within 1e-5. A parameter moves by about its
    learning rate per step whatever its gradient's size (Adam normalises),
    so after k steps it is compared within 1e-3 · k · lr of its group
    (measured: at most 2e-4 · k · lr; the schedule's first learning rate is
    0, so the first step moves only the moments). The exception is stated,
    not hidden:
    the key projections' biases have a gradient that is zero in exact
    arithmetic (softmax ignores a shift of all keys), both packages hold
    rounding noise there (about 1e-9), and Adam turns noise of that size
    into updates of either sign up to lr·|g|/(|g| + eps); those leaves are
    compared within k · lr."""
    table = _news_table(derive_attn)
    batch = _batch()
    if branch == "plain":
        batch = {k: v for k, v in batch.items()
                 if k not in ("uniq_id", "cdd_pos", "his_pos")}
    kw = dict(scheduler="linear", warmup=2, total_steps=8)

    jmodel = _jax_model()
    jopt = jax_make_fused_optimizer(LR, BERT_LR, **kw)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, jax_params),
                                    jopt)
    jstep = jax_make_train_step(jmodel, jopt, donate=False, remat=remat,
                                news_table=table)
    jbatch = jax.tree.map(jnp.asarray, batch)
    rng = jax.random.PRNGKey(0)

    model = _torch_model(jax_params)
    opt = make_fused_optimizer(LR, BERT_LR, **kw)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, remat=remat, news_table=table,
                           device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def tol_of(k):
        def tol(path):
            lr = BERT_LR if "bert" in path else LR
            noise_only = "['key']['bias']" in path
            return k * lr * (1.0 if noise_only else 1e-3)
        return tol

    losses = []
    for k in range(1, 5):
        jstate, jmetrics = jstep(jstate, jbatch, rng)
        state, metrics = step(state, tbatch, seed=0)
        assert state.step == int(jstate.step) == k
        assert state.opt_state.count == k
        assert metrics["loss"].dtype == torch.float32
        np.testing.assert_allclose(metrics["loss"].item(),
                                   float(jmetrics["loss"]), atol=1e-5)
        losses.append(metrics["loss"].item())
        _assert_trees_close(torch_to_jax_tree(state.params), jstate.params,
                            tol_of(k))
    # the step updates the model's own parameters in place
    assert state.params["bert.pooler.weight"] is model.bert.pooler.weight
    assert losses[-1] < losses[0]
    assert set(_build.LAUNCHES.values()) == {0}


def test_grad_norm_is_opt_in(jax_params):
    table = _news_table(True)
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    model = _torch_model(jax_params)
    opt = make_fused_optimizer(LR, BERT_LR)
    state = create_train_state(model, opt)
    _, m = make_train_step(model, opt, news_table=table,
                           device="cpu")(state, tbatch, seed=0)
    assert set(m) == {"loss"}
    _, m = make_train_step(model, opt, news_table=table, device="cpu",
                           with_grad_norm=True)(state, tbatch, seed=0)
    assert m["grad_norm"].item() > 0


def test_dropout_step_repeats_from_its_seed_and_remat_draws_the_same_bits(
        jax_params):
    """With dropout on, a step is a function of (weights, batch, seed,
    step count): two runs agree exactly, another seed gives another loss,
    and the recomputed forward of ``remat`` draws the same masks, so its
    parameters equal the stored-activation step's."""
    table = _news_table(True)
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}

    def run(seed, remat):
        model = PLM(BertModel(_variant(bert_variant).replace(
            hidden_dropout=0.1, attention_dropout=0.1)),
            AttentionPooling(H), hidden_dim=H)
        model.load_state_dict(jax_params_to_torch(jax_params))
        opt = make_fused_optimizer(LR, BERT_LR)
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, remat=remat, news_table=table,
                               device="cpu")
        losses = [step(state, tbatch, seed=seed)[1]["loss"].item()
                  for _ in range(2)]
        return losses, {k: v.detach().clone()
                        for k, v in state.params.items()}

    base_losses, base = run(5, False)
    again_losses, again = run(5, False)
    remat_losses, remat = run(5, True)
    other_losses, _ = run(6, False)
    assert base_losses == again_losses
    assert all(torch.equal(base[k], again[k]) for k in base)
    assert base_losses[0] != base_losses[1]      # the step count is folded in
    assert other_losses[0] != base_losses[0]
    np.testing.assert_allclose(remat_losses, base_losses, rtol=1e-6)
    for k in base:
        lr = BERT_LR if "bert" in k else LR
        np.testing.assert_allclose(remat[k].numpy(), base[k].numpy(),
                                   atol=2 * lr * 1e-3, err_msg=k)


# ---- the loader -------------------------------------------------------------

def _behaviors(n=37, n_news=60, seed=3):
    """Train behaviours as arrays: ragged histories (some empty, some over
    his_size), negative pools shorter and longer than npratio."""
    rng = np.random.default_rng(seed)
    his_len = rng.integers(0, 9, n)
    his_len[:2] = 0
    neg_len = rng.integers(0, 8, n)
    fields = dict(
        mode="train", impr_idx=np.arange(n, dtype=np.int32),
        uindex=rng.integers(1, 12, n).astype(np.int32),
        his_flat=rng.integers(1, n_news + 1, his_len.sum()).astype(np.int32),
        his_offsets=np.concatenate([[0], np.cumsum(his_len)]).astype(np.int64),
        pos=rng.integers(1, n_news + 1, n).astype(np.int32),
        neg_flat=rng.integers(1, n_news + 1, neg_len.sum()).astype(np.int32),
        neg_offsets=np.concatenate([[0], np.cumsum(neg_len)]).astype(np.int64))
    lens = rng.integers(3, 21, n_news + 1)
    attn = (np.arange(20)[None, :] < lens[:, None]).astype(np.uint8)
    toks = rng.integers(5, VOCAB, (n_news + 1, 20)).astype(np.int32) * attn
    toks[0], attn[0] = 0, 0
    news = dict(tokens=toks, attn_mask=attn,
                nid2idx={f"N{i}": i for i in range(1, n_news + 1)},
                sep_token_id=102)
    return fields, news


@pytest.mark.parametrize("emit_tokens,dedup,shuffle_pos,descend", [
    (True, False, False, False), (False, True, False, False),
    (False, False, True, True), (True, False, True, False)])
def test_train_loader_batches_equal_jax(emit_tokens, dedup, shuffle_pos,
                                        descend):
    """Key by key, value by value, for one seed over two epochs, against
    ``TrainLoader(backend="numpy")``."""
    fields, news = _behaviors()
    kw = dict(batch_size=8, npratio=4, his_size=6, signal_length=12,
              shuffle_pos=shuffle_pos, descend_history=descend, seed=7,
              emit_tokens=emit_tokens, dedup=dedup)
    want = JaxTrainLoader(JaxNewsCache(**news), JaxBehaviors(**fields),
                          backend="numpy", **kw)
    got = TrainLoader(NewsCache(**news), Behaviors(**fields), **kw)
    assert len(got) == len(want) == 4
    assert got.dedup == want.dedup == (dedup and not emit_tokens)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        batches = list(zip(got, want, strict=True))
        assert len(batches) == 4
        for g, w in batches:
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            if dedup:
                np.testing.assert_array_equal(
                    g["uniq_id"][g["cdd_pos"]], g["cdd_id"])
                np.testing.assert_array_equal(
                    g["uniq_id"][g["his_pos"]], g["his_id"])
            else:
                full = ensure_tokens(g, got)
                np.testing.assert_array_equal(
                    full["his_token"], got.news_tokens[g["his_id"]])
    with pytest.raises(ValueError, match="train behaviors"):
        TrainLoader(NewsCache(**news),
                    Behaviors(**{**fields, "mode": "dev"}), **kw)


# ---- the Trainer ------------------------------------------------------------

def _topic_data(seed=0, n_topics=4, per_topic=10, n_users=96):
    """A learnable set: articles of a topic draw their words from the
    topic's own slice of the vocabulary; a user's history, and the clicked
    candidate, are of one topic, the negatives of the others."""
    rng = np.random.default_rng(seed)
    n_news = n_topics * per_topic
    topic = np.repeat(np.arange(n_topics), per_topic)
    width = (VOCAB - 10) // n_topics
    toks = np.zeros((n_news + 1, S), np.int32)
    attn = np.zeros((n_news + 1, S), np.uint8)
    for i in range(n_news):
        n = rng.integers(5, S + 1)
        toks[i + 1, :n] = 10 + topic[i] * width + rng.integers(0, width, n)
        attn[i + 1, :n] = 1
    his, neg, pos = [], [], []
    for u in range(n_users):
        t = u % n_topics
        own = 1 + np.flatnonzero(topic == t)
        other = 1 + np.flatnonzero(topic != t)
        his.append(rng.choice(own, rng.integers(2, 7), replace=False))
        pos.append(rng.choice(own))
        neg.append(rng.choice(other, 6, replace=False))
    news = NewsCache(toks, attn, {f"N{i}": i for i in range(1, n_news + 1)},
                     102)
    behaviors = Behaviors(
        mode="train", impr_idx=np.arange(n_users, dtype=np.int32),
        uindex=np.arange(1, n_users + 1, dtype=np.int32),
        his_flat=np.concatenate(his).astype(np.int32),
        his_offsets=np.concatenate(
            [[0], np.cumsum([len(h) for h in his])]).astype(np.int64),
        pos=np.array(pos, np.int32),
        neg_flat=np.concatenate(neg).astype(np.int32),
        neg_offsets=np.arange(0, 6 * n_users + 1, 6).astype(np.int64))
    return DataBundle(tokenizer=None, news={"train": news},
                      behaviors={"train": behaviors}, user_num=n_users,
                      vocab_size=VOCAB)


def _small_config(**kw):
    base = dict(model="plm", bert="newsbert", bert_layers=LAYERS,
                bert_dim=H, head_num=HEADS, encoderU="attn",
                vocab_size=VOCAB, signal_length=S, his_size=6, npratio=3,
                batch_size=16, epochs=2, lr=2e-3, bert_lr=1e-3,
                dtype="float32", interval=1, seed=1)
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("device_gather", [True, False])
def test_trainer_lowers_the_training_loss(device_gather):
    """``Trainer.train()`` over two epochs of the topic set, dropout on at
    the variant's 0.1: the second epoch's mean loss is below the first's,
    in device-gather + dedup mode (the default) and with token-carrying
    batches."""
    cfg = _small_config(device_gather=device_gather)
    data = _topic_data()
    loader = build_train_loader(cfg, data)
    assert loader.emit_tokens == (not device_gather)
    assert loader.dedup == device_gather
    model = build_model(cfg, VOCAB, device="cpu")
    assert model.bert.cfg.hidden_dropout == 0.1
    trainer = Trainer(cfg, model, loader, device="cpu")
    assert trainer.train() == {}
    per_epoch = len(loader)
    losses = [loss for _, loss in trainer.history]
    assert len(losses) == 2 * per_epoch == 12
    assert trainer.state.step == trainer.state.opt_state.count == 12
    assert np.isfinite(losses).all()
    first, second = np.mean(losses[:per_epoch]), np.mean(losses[per_epoch:])
    assert second < first - 0.05, (first, second)
    assert set(_build.LAUNCHES.values()) == {0}


def test_trainer_step_budget_and_unported_options():
    data = _topic_data()
    cfg = _small_config(step_budget=3)
    trainer = Trainer(cfg, build_model(cfg, VOCAB, device="cpu"),
                      build_train_loader(cfg, data), device="cpu")
    trainer.train()
    assert trainer.state.step == 3
    for bad, match in ((dict(steps_per_call=2), "steps_per_call"),
                       (dict(checkpoint=-1), "checkpoint")):
        cfg = _small_config(**bad)
        with pytest.raises(NotImplementedError, match=match):
            Trainer(cfg, build_model(cfg, VOCAB, device="cpu"),
                    build_train_loader(cfg, data), device="cpu")
    with pytest.raises(NotImplementedError, match="evaluation"):
        Trainer(_small_config(), build_model(_small_config(), VOCAB,
                                             device="cpu"),
                build_train_loader(_small_config(), data),
                eval_loader=object(), device="cpu")
    with pytest.raises(RuntimeError):
        Trainer(_small_config(), build_model(_small_config(), VOCAB,
                                             device="cpu"),
                build_train_loader(_small_config(), data))
