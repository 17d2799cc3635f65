"""BERT-style encoder for the PLM family, on the 2-D residual stream.

The port of the full-attention path of news_recommendation_mind_tpu/
models/bert.py (:64-192, :564-593, :770-960): embeddings (word, position
``[:S]``, token-type row 0) and a plain LayerNorm, then layers that keep
the residual stream flat as [B·S, H], with ``short_mhsa`` for attention and
``fused_add_ln`` for both residual norms, then the tanh / gelu_cls / cls
pooler. With ``deterministic=False`` the three dropouts of the JAX model
run: hidden dropout on the embeddings (a plain dropout, :903) and on each
sublayer's output inside ``fused_add_ln``, and attention-prob dropout
inside ``short_mhsa``. Where JAX draws ``make_rng("dropout")`` per call
site, each site here gets its own seed, folded from the call's ``seed``
and the site's index, so a recomputed forward (``torch.utils.checkpoint``)
draws the same bits. Parameters are float32; dense layers compute in the
model dtype (bfloat16 by default) and the norms keep float32 scale and
bias, the JAX package's dtype policy. Other attention types and sequences longer than
64 tokens come with the XFormer slice.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout_bits import fold_seed, ln_keep_mask
from ..ops.fused_add_ln import fused_add_ln
from ..ops.short_mhsa import MAX_SEQ, short_mhsa


@dataclass(frozen=True)
class BertVariantConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pooler: str = "tanh"              # tanh | gelu_cls | cls

    def replace(self, **kw) -> "BertVariantConfig":
        return dataclasses.replace(self, **kw)


# the full-attention rows of the JAX variant table (bert.py:120-124)
_VARIANTS = {
    "bert": BertVariantConfig(),
    "newsbert": BertVariantConfig(num_layers=4),
    "distill": BertVariantConfig(num_layers=6, type_vocab_size=0,
                                 pooler="gelu_cls"),
}
# variants whose attention types the XFormer slice ports
_LATER = ("deberta", "funnel", "synthesizer", "longformer", "bigbird",
          "reformer")


def bert_variant(name: str, *, vocab_size: Optional[int] = None,
                 num_layers: Optional[int] = None) -> BertVariantConfig:
    if name in _LATER:
        raise NotImplementedError(
            f"PLM variant {name} comes with the XFormer slice")
    if name not in _VARIANTS:
        raise ValueError(f"unknown PLM variant {name}")
    kw = {}
    if vocab_size is not None:
        kw["vocab_size"] = vocab_size
    if num_layers is not None:
        kw["num_layers"] = num_layers
    return _VARIANTS[name].replace(**kw)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default Dense init: truncated normal (±2σ) with variance
    1/fan_in after truncation; ``w`` is [out, in]."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)``: float32 params, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        lecun_normal_(self.weight.data, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: float32 stats with the fast
    variance E[x²] − E[x]² clipped at 0, float32 scale and bias, output in
    ``dtype``."""

    def __init__(self, hidden: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class _ResidualNorm(nn.Module):
    """``LayerNorm(x + dropout(res))`` through the fused kernel, with the
    same scale/bias parameters as ``LayerNorm``; ``seed`` is None when the
    call is deterministic."""

    def __init__(self, hidden: int, eps: float, p_drop: float = 0.0):
        super().__init__()
        self.eps = eps
        self.p_drop = p_drop
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x: torch.Tensor, res: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        p = 0.0 if seed is None else self.p_drop
        return fused_add_ln(x, res, self.weight, self.bias, eps=self.eps,
                            p_drop=p, seed=seed or 0)


class _SelfAttention(nn.Module):
    """Q/K/V projections of the flat stream, then ``short_mhsa``."""

    def __init__(self, c: BertVariantConfig, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        H = c.hidden_size
        self.num_heads = c.num_heads
        self.p_drop = c.attention_dropout
        self.query = Dense(H, H, dtype, generator)
        self.key = Dense(H, H, dtype, generator)
        self.value = Dense(H, H, dtype, generator)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                seq_len: int, seed: Optional[int] = None) -> torch.Tensor:
        p = 0.0 if seed is None else self.p_drop
        return short_mhsa(self.query(x), self.key(x), self.value(x),
                          attn_mask, self.num_heads, p_drop=p,
                          seq_len=seq_len, seed=seed or 0)


class _Layer(nn.Module):
    def __init__(self, c: BertVariantConfig, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        H, F_ = c.hidden_size, c.intermediate_size
        self.attention = _SelfAttention(c, dtype, generator)
        self.attn_out = Dense(H, H, dtype, generator)
        self.attn_norm = _ResidualNorm(H, c.eps, c.hidden_dropout)
        self.ffn_in = Dense(H, F_, dtype, generator)
        self.ffn_out = Dense(F_, H, dtype, generator)
        self.ffn_norm = _ResidualNorm(H, c.eps, c.hidden_dropout)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                seq_len: int, seed: Optional[int] = None) -> torch.Tensor:
        """``seed``: this layer's dropout seed, None when deterministic;
        its three dropout sites fold their own seeds from it."""
        s0, s1, s2 = ((None,) * 3 if seed is None else
                      (fold_seed(seed, i) for i in range(3)))
        attn = self.attn_out(self.attention(x, attn_mask, seq_len, s0))
        x = self.attn_norm(x, attn, s1)
        # flax nn.gelu is the tanh approximation
        ff = self.ffn_out(F.gelu(self.ffn_in(x), approximate="tanh"))
        return self.ffn_norm(x, ff, s2)


class BertModel(nn.Module):
    """Token ids [B, S] + mask [B, S] → (hidden [B, S, H], pooled [B, H])."""

    def __init__(self, cfg: BertVariantConfig,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        c = self.cfg = cfg
        self.dtype = dtype
        H = c.hidden_size
        self.word_embeddings = nn.Embedding(
            c.vocab_size, H,
            _weight=torch.empty(c.vocab_size, H).normal_(0.0, 0.02,
                                                         generator=g))
        self.position_embeddings = nn.Parameter(
            torch.empty(c.max_position, H).normal_(0.0, 0.02, generator=g))
        self.token_type_embeddings = None
        if c.type_vocab_size:
            self.token_type_embeddings = nn.Parameter(
                torch.empty(c.type_vocab_size, H).normal_(0.0, 0.02,
                                                          generator=g))
        self.embed_norm = LayerNorm(H, c.eps, dtype)
        self.layers = nn.ModuleList(
            [_Layer(c, dtype, g) for _ in range(c.num_layers)])
        self.pooler = Dense(H, H, dtype, g) if c.pooler != "cls" else None

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                deterministic: bool = True, seed: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``deterministic=False`` turns the dropouts on, all drawn from
        the 64-bit ``seed``: site 0 is the embedding dropout, site i + 1
        layer i."""
        c, dt = self.cfg, self.dtype
        B, S = input_ids.shape
        if S > MAX_SEQ:
            raise NotImplementedError(
                f"sequences over {MAX_SEQ} tokens take the XFormer slice's "
                f"attention paths")
        H = c.hidden_size
        emb = self.word_embeddings(input_ids).to(dt)
        emb = emb + self.position_embeddings[:S][None].to(dt)
        if self.token_type_embeddings is not None:
            emb = emb + self.token_type_embeddings[0][None, None].to(dt)
        x = self.embed_norm(emb).reshape(B * S, H)
        attn_mask = attn_mask.to(dt)
        if not deterministic and c.hidden_dropout > 0.0:
            keep = ln_keep_mask(fold_seed(seed, 0), B * S, H,
                                c.hidden_dropout, x.device)
            x = torch.where(keep, x / (1.0 - c.hidden_dropout),
                            torch.zeros_like(x))
        for i, layer in enumerate(self.layers):
            x = layer(x, attn_mask, S,
                      None if deterministic else fold_seed(seed, i + 1))
        x = x.reshape(B, S, H)
        return x, self._pool(x)

    def _pool(self, hidden: torch.Tensor) -> torch.Tensor:
        cls = hidden[:, 0]
        if self.cfg.pooler == "tanh":
            return torch.tanh(self.pooler(cls))
        if self.cfg.pooler == "gelu_cls":
            return F.gelu(self.pooler(cls), approximate="tanh")
        return cls
