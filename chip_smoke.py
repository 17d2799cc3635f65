#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (news_recommendation_mind_tpu_torch)
on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (and so exits non-zero) when it fails:

1. build the CUDA kernels from ``news_recommendation_mind_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version at the serving
   shapes, in bfloat16 and float32, and time kernel, plain version and
   one PyTorch library call with CUDA events;
3. serve at full newsbert width (vocab 30,522, H 768, 4 layers, 12 heads,
   FFN 3,072, S 30, his_size 50, bfloat16) over a synthetic news table of
   42,416 articles (MINDsmall's dev corpus): ``Recommender`` sweeps the
   table through the kernels with the launch counts set to 0 just before,
   then answers ``score`` / ``rank`` / ``retrieve`` requests; the counts
   must equal one launch per layer and batch (``short_mhsa``) and two
   (``fused_add_ln``), and 64 table rows recomputed through the plain path
   on the CPU must agree within the bfloat16 tolerance.

It prints a line per kernel check (error, tolerance, times), a
``serving`` JSON line, a ``kernels`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. The compiler's register
and shared-memory report goes to stderr. With no CUDA device it exits 2
and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by dtype
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# tolerance |kernel - plain| <= ATOL + RTOL * |plain|: float32 differs by
# summation order only; bfloat16 by one rounding of the output (2^-8)
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# table rows, card vs CPU: both encoders run in bf16, but the two devices
# round at other places (the card adds a dense layer's bias inside the
# GEMM before rounding, the CPU after), about one bf16 ulp (2^-8 at 1.0)
# per dense layer, carried through four layers into the tanh-pooled
# outputs; 16 ulps at 1.0 bounds the largest of the 64 x 768 values
TABLE_ATOL = 2.0 ** -4

MIND_SMALL_DEV_ARTICLES = 42_416
SEP, CLS, VOCAB = 102, 101, 30_522


def timed_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device ms per call of ``fn``, averaged over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # keep the device spinning (~50 ms) while the host queues the timed
    # calls: the events then time the kernels back to back, not the
    # host's Python launch rate, which is slower than a 40 us kernel
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def compare(got: torch.Tensor, want: torch.Tensor, dtype, what: str) -> float:
    atol, rtol = TOLERANCE[dtype]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    if (err > atol + rtol * want.abs()).any():
        raise AssertionError(f"{what}: max |kernel - plain| = "
                             f"{err.max().item():.3g} over atol {atol} "
                             f"+ rtol {rtol}")
    return err.max().item()


def check_short_mhsa(dtype, seed: int, dev) -> dict:
    from news_recommendation_mind_tpu_torch.ops.short_mhsa import (
        short_mhsa, short_mhsa_plain)
    U, S, H, NH = 500, 30, 768, 12
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(U * S, H, generator=g, device=dev).to(dtype)
               for _ in range(3))
    lens = torch.randint(1, S + 1, (U,), generator=g, device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).float()
    mask[::50] = 0.0                          # fully-masked articles
    got = short_mhsa(q, k, v, mask, NH, seq_len=S)
    torch.cuda.synchronize()
    want = short_mhsa_plain(q.view(U, S, H), k.view(U, S, H),
                            v.view(U, S, H), mask, NH).view(U * S, H)
    err = compare(got, want, dtype, f"short_mhsa {dtype}")
    if got.view(U, S, H)[::50].abs().max().item() != 0.0:
        raise AssertionError("short_mhsa: a fully-masked article is not 0")
    q4, k4, v4 = (t.view(U, S, NH, H // NH).transpose(1, 2)
                  for t in (q, k, v))
    keep = mask.bool()[:, None, None, :]
    elt = q.element_size()
    nbytes = 4 * U * S * H * elt + U * S * 4
    flops = U * NH * 4 * S * S * (H // NH)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return {
        "max_abs_err": err,
        "ms": timed_ms(lambda: short_mhsa(q, k, v, mask, NH, seq_len=S)),
        "plain_ms": timed_ms(lambda: short_mhsa_plain(
            q.view(U, S, H), k.view(U, S, H), v.view(U, S, H), mask, NH)),
        "library_ms": timed_ms(lambda: torch.nn.functional.
                               scaled_dot_product_attention(
                                   q4, k4, v4, attn_mask=keep)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": [U, S, H, NH], "bytes": nbytes, "flops": flops,
    }


def check_fused_add_ln(dtype, seed: int, dev) -> dict:
    from news_recommendation_mind_tpu_torch.ops.fused_add_ln import (
        _fused_add_ln_cuda, fused_add_ln, fused_add_ln_plain)
    N, H, EPS = 15_000, 768, 1e-12
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x, res = (torch.randn(N, H, generator=g, device=dev).to(dtype)
              for _ in range(2))
    scale = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    bias = 0.1 * torch.randn(H, generator=g, device=dev)
    got = fused_add_ln(x, res, scale, bias, eps=EPS)
    _, mean, rstd = _fused_add_ln_cuda(x, res, scale, bias, EPS)
    torch.cuda.synchronize()
    want, want_mean, want_rstd = fused_add_ln_plain(x, res, scale, bias, EPS)
    err = compare(got, want, dtype, f"fused_add_ln {dtype}")
    compare(mean, want_mean, torch.float32, f"fused_add_ln mean {dtype}")
    compare(rstd, want_rstd, torch.float32, f"fused_add_ln rstd {dtype}")
    elt = x.element_size()
    nbytes = 3 * N * H * elt + 2 * N * 4 + 2 * H * 4
    flops = 9 * N * H
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    sc, bi = scale.to(dtype), bias.to(dtype)
    return {
        "max_abs_err": err,
        "ms": timed_ms(lambda: fused_add_ln(x, res, scale, bias, eps=EPS)),
        "plain_ms": timed_ms(lambda: fused_add_ln_plain(x, res, scale, bias,
                                                        EPS)),
        "library_ms": timed_ms(lambda: torch.nn.functional.layer_norm(
            x + res, (H,), sc, bi, EPS)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": [N, H], "bytes": nbytes, "flops": flops,
    }


def synthetic_news(n_articles: int, seed: int, max_len: int = 64):
    """Token table with MIND's row-0 pad article: [CLS] words [SEP], ragged
    lengths, about half of them longer than the 30-token signal."""
    from news_recommendation_mind_tpu_torch.data.cache import NewsCache
    rng = np.random.default_rng(seed)
    n = n_articles + 1
    lens = rng.integers(4, max_len + 1, n)
    attn = (np.arange(max_len)[None, :] < lens[:, None]).astype(np.uint8)
    toks = rng.integers(1000, VOCAB, (n, max_len)).astype(np.int32) * attn
    toks[:, 0] = CLS
    toks[np.arange(n), lens - 1] = SEP
    toks[0], attn[0] = 0, 0
    nid2idx = {f"N{i}": i for i in range(1, n)}
    return NewsCache(toks, attn, nid2idx, SEP)


def timed_call(fn, *args):
    """(result, host ms) of one call; the serving calls end in a copy to
    the host, which waits for the device."""
    t0 = time.perf_counter()
    result = fn(*args)
    return result, (time.perf_counter() - t0) * 1e3


def newsbert_config(seed: int):
    """The documented PLM serving configuration (README `--bert newsbert
    --encoderU attn`) at full width, in bfloat16."""
    from news_recommendation_mind_tpu_torch.config import Config
    return Config(model="plm", bert="newsbert", encoderU="attn",
                  vocab_size=VOCAB, signal_length=30, his_size=50,
                  batch_size_news=500, dtype="bfloat16", seed=seed)


def serve(cfg, dev, n_articles: int = MIND_SMALL_DEV_ARTICLES,
          reps: int = 30) -> dict:
    from news_recommendation_mind_tpu_torch.data.loader import NewsLoader
    from news_recommendation_mind_tpu_torch.evaluation.engine import (
        encode_all_news)
    from news_recommendation_mind_tpu_torch.ops import _build
    from news_recommendation_mind_tpu_torch.serving import Recommender

    seed = cfg.seed
    news = synthetic_news(n_articles, seed)
    batches = math.ceil((n_articles + 1) / cfg.batch_size_news)

    _build.reset_launches()
    t0 = time.perf_counter()
    rec = Recommender(cfg, news, device=dev)
    torch.cuda.synchronize(dev)
    construct_s = time.perf_counter() - t0
    layers = rec.model.bert.cfg.num_layers

    rng = np.random.default_rng(seed)
    nids = list(news.nid2idx)

    def history(i, n=None):
        # up to 80 clicks: longer than his_size exercises the truncation
        # and retrieve's exclusion of the full history
        r = np.random.default_rng(seed * 1000 + i)
        return [nids[j] for j in r.choice(len(nids), n or 1 + 7 * i % 80,
                                          replace=False)]

    out = {"articles": n_articles, "batches": batches, "requests": reps}
    for width, n_cdd in ((8, 5), (32, 20)):
        times = []
        for i in range(reps):
            his, cands = history(i), history(10_000 + i, n_cdd)
            s, ms = timed_call(rec.score, his, cands)
            times.append(ms)
            if s.shape != (n_cdd,) or not np.isfinite(s).all() or \
                    ((s <= 0) | (s >= 1)).any():
                raise AssertionError(f"score at width {width}: {s}")
            ranked = rec.rank(his, cands)
            if [c for c, _ in ranked] != [cands[j] for j in
                                          np.argsort(-s, kind="stable")]:
                raise AssertionError("rank disagrees with score")
        out[f"score_p50_ms_w{width}"] = float(np.median(times))
    times = []
    for i in range(reps):
        his = history(i)
        got, ms = timed_call(rec.retrieve, his, 10)
        times.append(ms)
        ids = [nid for nid, _ in got]
        if len(ids) != 10 or set(ids) & set(his):
            raise AssertionError(f"retrieve: {got}")
        again = rec.score(his, ids)
        if np.abs(again - np.array([v for _, v in got])).max() > 1e-5:
            raise AssertionError("retrieve's scores disagree with score")
    out["retrieve_p50_ms"] = float(np.median(times))
    empty = rec.retrieve([], k=10, exclude_history=False)
    if len(empty) != 10 or not all(math.isfinite(v) for _, v in empty):
        raise AssertionError(f"retrieve with no history: {empty}")
    torch.cuda.synchronize(dev)

    launches = dict(_build.LAUNCHES)
    want = {"short_mhsa": batches * layers,
            "fused_add_ln": 2 * batches * layers}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, want {want}")
    out["launches"] = launches
    out["construct_s"] = construct_s
    if not torch.isfinite(rec.table).all():
        raise AssertionError("the news table is not finite")

    # steady-state sweep rate, after the counted run
    loader = NewsLoader(news, batch_size=cfg.batch_size_news,
                        signal_length=cfg.signal_length)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    table = encode_all_news(rec.model, loader, rec.hidden_dim, device=dev)
    torch.cuda.synchronize(dev)
    sweep_s = time.perf_counter() - t0
    out["sweep_s"] = sweep_s
    out["sweep_articles_per_s"] = (n_articles + 1) / sweep_s
    out["sweep_repeat_max_abs_diff"] = (table - rec.table).abs().max().item()

    # 64 rows again through the plain path: the same model on the CPU
    toks, attn = news.truncated(cfg.signal_length)
    long = news.attn_mask[:, cfg.signal_length:].any(1)
    rows = np.concatenate([[0], np.flatnonzero(long)
                           [:31], rng.choice(np.arange(1, n_articles + 1),
                                             32, replace=False)])
    cpu_model = copy.deepcopy(rec.model).cpu()
    with torch.inference_mode():
        plain = cpu_model.encode_news(
            torch.from_numpy(toks[rows])[:, None],
            torch.from_numpy(attn[rows].astype(np.float32))[:, None]
        )[:, 0].float()
    err = (plain - rec.table[torch.from_numpy(rows).to(dev)].cpu()).abs()
    out["plain_rows"] = len(rows)
    out["plain_rows_max_abs_err"] = err.max().item()
    out["plain_rows_mean_abs_err"] = err.mean().item()
    if not torch.isfinite(plain).all() or err.max().item() > TABLE_ATOL:
        raise AssertionError(f"table rows vs plain path: max err "
                             f"{err.max().item():.3g} > {TABLE_ATOL}")
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from news_recommendation_mind_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path, log = _build.build_library()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    print(log, file=sys.stderr)

    checks = {}
    for name, fn in (("short_mhsa", check_short_mhsa),
                     ("fused_add_ln", check_fused_add_ln)):
        for dtype in (torch.bfloat16, torch.float32):
            r = fn(dtype, args.seed, dev)
            checks[f"{name}/{str(dtype).split('.')[-1]}"] = r
            atol, rtol = TOLERANCE[dtype]
            print(f"{name} {dtype}: max_abs_err {r['max_abs_err']:.3g} "
                  f"(atol {atol}, rtol {rtol}); kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")

    serving = serve(newsbert_config(args.seed), dev)
    print("serving: " + json.dumps(serving))

    sources = {
        "short_mhsa": ("news_recommendation_mind_tpu_torch/csrc/short_mhsa.cu",
                       "news_recommendation_mind_tpu/ops/pallas_mhsa.py:195"),
        "fused_add_ln": (
            "news_recommendation_mind_tpu_torch/csrc/fused_add_ln.cu",
            "news_recommendation_mind_tpu/ops/pallas_ln.py:136"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = checks[f"{name}/bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": serving["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
