#!/usr/bin/env python3
"""Where the PyTorch port's news-table sweep spends its time, on one GPU.

    python3 scripts/profile_torch_sweep.py [--seed N] [--batches 10]

Runs the full-width newsbert encoder of chip_smoke.py (bfloat16, 500
articles of 30 tokens per batch) over ``--batches`` batches of the
synthetic table under ``torch.profiler`` after two warm-up batches, and
prints one JSON line: wall ms per batch (host clock around a synchronised
window), device busy ms per batch (the union of kernel intervals), the
idle share, and device ms per batch by kernel group and by kernel name.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import newsbert_config, synthetic_news  # noqa: E402
from news_recommendation_mind_tpu_torch.data.loader import (  # noqa: E402
    NewsLoader,
)
from news_recommendation_mind_tpu_torch.experiment import (  # noqa: E402
    build_model,
)

GROUPS = (("short_mhsa", ("mhsa_fwd",)),
          ("fused_add_ln", ("add_ln_fwd",)),
          ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90")),
          ("gelu", ("gelu",)),
          ("layer_norm_embed", ("reduce", "mean")),
          ("copy_cast", ("copy", "cast", "convert")),
          ("gather_index", ("index", "gather", "embedding")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def busy_us(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = newsbert_config(args.seed)
    model = build_model(cfg, cfg.vocab_size, device=dev)
    news = synthetic_news(cfg.batch_size_news * (args.batches + 2) - 1,
                          args.seed)
    batches = [(torch.from_numpy(b["token"]).to(dev),
                torch.from_numpy(b["attn"]).to(dev))
               for b in NewsLoader(news, batch_size=cfg.batch_size_news,
                                   signal_length=cfg.signal_length)]

    def run(chunk):
        for tok, attn in chunk:
            model.encode_news(tok[:, None], attn[:, None])

    with torch.inference_mode():
        run(batches[:2])
        torch.cuda.synchronize(dev)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run(batches[2:])
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the same window without the profiler, for its overhead
        t0 = time.perf_counter()
        run(batches[2:])
        torch.cuda.synchronize(dev)
        plain_wall_ms = (time.perf_counter() - t0) * 1e3

    n = len(batches) - 2
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    by_group = defaultdict(float)
    for name, ms in by_name.items():
        by_group[group_of(name)] += ms
    busy_ms = busy_us(kernels) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "batches": n,
        "articles_per_batch": cfg.batch_size_news,
        "wall_ms_per_batch": wall_ms / n,
        "wall_ms_per_batch_unprofiled": plain_wall_ms / n,
        "device_busy_ms_per_batch": busy_ms / n,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_batch": len(kernels) / n,
        "group_ms_per_batch": {
            g: ms / n
            for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_batch": {k[:90]: ms / n for k, ms in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
