#!/usr/bin/env python3
"""Where the PyTorch port's PLM train step spends its time, on one GPU.

    python3 scripts/profile_torch_train.py [--seed N] [--steps 6]

Builds the full-width newsbert trainer of chip_smoke.py (bfloat16, 128
impressions a batch over a deduplicated pool, dropout 0.1, fused Adam),
takes three warm-up steps, then ``--steps`` steps under ``torch.profiler``
and the same steps again without it, and prints one JSON line: wall ms per
step (host clock around a synchronised window), device busy ms per step
(the union of kernel intervals), the idle share, and device ms per step by
kernel group and by kernel name.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from chip_smoke import (  # noqa: E402
    MIND_SMALL_DEV_ARTICLES, VOCAB, newsbert_config, train_data,
)
from profile_torch_sweep import busy_us  # noqa: E402
from news_recommendation_mind_tpu_torch.experiment import (  # noqa: E402
    build_model, build_train_loader,
)
from news_recommendation_mind_tpu_torch.train.loop import (  # noqa: E402
    Trainer, to_device,
)

# first match wins: the port's own kernels by their names in csrc/, then
# PyTorch's by what their names contain
GROUPS = (("short_mhsa_bwd (K5)", ("mhsa_bwd",)),
          ("short_mhsa (K4)", ("mhsa_fwd",)),
          ("fused_add_ln_bwd (K2)", ("add_ln_bwd", "reduce_partials")),
          ("fused_add_ln (K1)", ("add_ln_fwd",)),
          ("fused_adam (K7)", ("adam_chunks",)),
          ("ln_keep_mask (K3)", ("ln_keep_mask",)),
          ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90", "cublas")),
          ("gelu", ("gelu",)),
          ("embedding_backward", ("embedding", "index_add", "scatter",
                                  "sort", "radix", "unique")),
          ("copy_cast", ("copy", "cast", "convert")),
          ("reduce", ("reduce",)),
          ("gather_index", ("index", "gather")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other elementwise"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = newsbert_config(args.seed).replace(batch_size=128, epochs=1)
    data = train_data(cfg, MIND_SMALL_DEV_ARTICLES,
                      128 * (args.steps + 3))
    loader = build_train_loader(cfg, data)
    trainer = Trainer(cfg, build_model(cfg, VOCAB, device=dev), loader,
                      device=dev)
    batches = [to_device(b, dev) for b in loader]

    def run(chunk):
        for batch in chunk:
            trainer.state, metrics = trainer.train_step(trainer.state, batch,
                                                        cfg.seed)
        return metrics["loss"].item()          # waits for the last step

    run(batches[:3])
    timed = batches[3:3 + args.steps]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(timed)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loss = run(timed)
    torch.cuda.synchronize(dev)
    plain_wall_ms = (time.perf_counter() - t0) * 1e3

    n = len(timed)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    by_group = defaultdict(float)
    for name, ms in by_name.items():
        by_group[group_of(name)] += ms
    busy_ms = busy_us(kernels) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": card, "steps": n, "impressions_per_step": cfg.batch_size,
        "pool_widths": sorted({len(b["uniq_id"]) for b in timed}),
        "loss": loss,
        "wall_ms_per_step": wall_ms / n,
        "wall_ms_per_step_unprofiled": plain_wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": len(kernels) / n,
        "group_ms_per_step": {
            g: ms / n
            for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {k[:90]: ms / n for k, ms in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
