#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (news_recommendation_mind_tpu_torch)
on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (and so exits non-zero) when it fails:

1. build the CUDA kernels from ``news_recommendation_mind_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card, in
   bfloat16 and float32, and time kernel, plain version and (where one
   PyTorch call computes the same function) that library call with CUDA
   events: K1 ``fused_add_ln`` and K4 ``short_mhsa`` at the serving shapes
   (N 15,000; U 500) and, with dropout 0.1, at the training shapes
   (N 61,440 x 768; U 2,048, S 30, 12 heads), their backward kernels K2
   and K5 there, the two keep-mask probes K3 and K6, and K7 ``fused_adam``
   over the full newsbert parameter set;
3. serve at full newsbert width (vocab 30,522, H 768, 4 layers, 12 heads,
   FFN 3,072, S 30, his_size 50, bfloat16) over a synthetic news table of
   42,416 articles (MINDsmall's dev corpus): ``Recommender`` sweeps the
   table through the kernels with the launch counts set to 0 just before,
   then answers ``score`` / ``rank`` / ``retrieve`` requests; the counts
   must equal one launch per layer and batch (``short_mhsa``) and two
   (``fused_add_ln``), and 64 table rows recomputed through the plain path
   on the CPU must agree within the bfloat16 tolerance;
4. train-step parity: one float32 model at full newsbert width, one batch
   of 8 impressions over a pool of 256 articles, dropout on from one
   seed: loss and every gradient from the card (kernels) against the same
   step through the plain versions on the CPU, and every mask the step
   drew, through the probe kernels, against the plain Philox;
5. train: ``Trainer`` over a ``TrainLoader(dedup=True, emit_tokens=False)``
   on seeded synthetic behaviours, 128 impressions a batch, bfloat16,
   dropout 0.1; the launch counts, set to 0 just before the timed steps,
   must read per step K4 = K5 = layers, K1 = K2 = 2 x layers, K7 = 1 and
   K3 = 1; the loss is finite at every step, and 20 more steps on one
   fixed batch must lower that batch's loss.

It prints a line per kernel check (error, tolerance, times), a
``serving``, a ``parity`` and a ``training`` JSON line, a ``kernels`` JSON
line, the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. The compiler's register and shared-memory report goes to stderr.
With no CUDA device it exits 2 and prints no result.
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


# the training shapes: 128 impressions over a pool of 2,048 distinct
# articles of 30 tokens (the JAX package's newsbert benchmark shape)
TRAIN_U, TRAIN_S, WIDTH, HEADS = 2048, 30, 768, 12
P_DROP = 0.1
KERNEL_SEED = 0x9E3779B97F4A7C15
# dscale and dbias are float32 sums over 61,440 rows taken in another
# order: |sum| is of order 250, one rounding 1.5e-5, a random walk over
# the rows a few 1e-3
SUMS_TOLERANCE = (2e-2, 1e-4)


def compare_sums(got, want, what: str) -> float:
    atol, rtol = SUMS_TOLERANCE
    err = (got - want).abs()
    if not torch.isfinite(got).all() or (err > atol + rtol * want.abs()).any():
        raise AssertionError(f"{what}: max |kernel - plain| = "
                             f"{err.max().item():.3g}")
    return err.max().item()


def check_fused_add_ln_train(dtype, seed: int, dev) -> dict:
    """K1 with dropout and K2 at N = 61,440: {"fwd": ..., "bwd": ...}."""
    import torch.nn.functional as F
    from news_recommendation_mind_tpu_torch.ops.fused_add_ln import (
        _fused_add_ln_bwd_cuda, _fused_add_ln_cuda, fused_add_ln,
        fused_add_ln_bwd_plain, fused_add_ln_plain)
    N, H, EPS = TRAIN_U * TRAIN_S, WIDTH, 1e-12
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    x, res, dy = (torch.randn(N, H, generator=g, device=dev).to(dtype)
                  for _ in range(3))
    scale = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    bias = 0.1 * torch.randn(H, generator=g, device=dev)
    elt = x.element_size()

    # the call the model makes: the public wrapper and, below, autograd
    # through it; the launcher only hands over the saved statistics
    leaves = [t.clone().requires_grad_() for t in (x, res, scale, bias)]
    got = fused_add_ln(*leaves, eps=EPS, p_drop=P_DROP, seed=KERNEL_SEED)
    _, mean, rstd = _fused_add_ln_cuda(x, res, scale, bias, EPS, P_DROP,
                                       KERNEL_SEED)
    torch.cuda.synchronize()
    want, want_mean, want_rstd = fused_add_ln_plain(x, res, scale, bias, EPS,
                                                    P_DROP, KERNEL_SEED)
    err = compare(got, want, dtype, f"fused_add_ln p=0.1 {dtype}")
    compare(mean, want_mean, torch.float32, "fused_add_ln p=0.1 mean")
    compare(rstd, want_rstd, torch.float32, "fused_add_ln p=0.1 rstd")
    nbytes = 3 * N * H * elt + 2 * N * 4 + 2 * H * 4
    bound_ms, bound_by = bound(nbytes, 10 * N * H, dtype)
    sc, bi = scale.to(dtype), bias.to(dtype)
    fwd = {
        "max_abs_err": err,
        "ms": timed_ms(lambda: fused_add_ln(x, res, scale, bias, eps=EPS,
                                            p_drop=P_DROP,
                                            seed=KERNEL_SEED)),
        "ms_p0": timed_ms(lambda: fused_add_ln(x, res, scale, bias,
                                               eps=EPS)),
        "plain_ms": timed_ms(lambda: fused_add_ln_plain(
            x, res, scale, bias, EPS, P_DROP, KERNEL_SEED), iters=5),
        "library_ms": timed_ms(lambda: F.layer_norm(
            x + F.dropout(res, P_DROP), (H,), sc, bi, EPS)),
        "bound_ms": bound_ms, "bound_by": bound_by, "shape": [N, H],
        "bytes": nbytes}

    dx, dres, dscale, dbias = torch.autograd.grad(got, leaves, dy)
    again = _fused_add_ln_bwd_cuda(dy, x, res, scale, mean, rstd, P_DROP,
                                   KERNEL_SEED)
    torch.cuda.synchronize()
    want = fused_add_ln_bwd_plain(dy, x, res, scale, mean, rstd, P_DROP,
                                  KERNEL_SEED)
    err = max(compare(dx, want[0], dtype, f"fused_add_ln_bwd dx {dtype}"),
              compare(dres, want[1], dtype, f"fused_add_ln_bwd dres {dtype}"))
    sums_err = max(compare_sums(dscale, want[2], "fused_add_ln_bwd dscale"),
                   compare_sums(dbias, want[3], "fused_add_ln_bwd dbias"))
    if not all(torch.equal(a, b) for a, b in
               zip(again, (dx, dres, dscale, dbias))):
        raise AssertionError("fused_add_ln_bwd differs from run to run")
    nbytes = 5 * N * H * elt + 2 * N * 4 + 3 * H * 4
    bound_ms, bound_by = bound(nbytes, 16 * N * H, dtype)
    xg, rg = x.clone().requires_grad_(), res.clone().requires_grad_()
    scg, big = sc.clone().requires_grad_(), bi.clone().requires_grad_()
    y_lib = F.layer_norm(xg + F.dropout(rg, P_DROP), (H,), scg, big, EPS)
    bwd = {
        "max_abs_err": err, "sums_max_abs_err": sums_err,
        "ms": timed_ms(lambda: _fused_add_ln_bwd_cuda(
            dy, x, res, scale, mean, rstd, P_DROP, KERNEL_SEED)),
        "ms_p0": timed_ms(lambda: _fused_add_ln_bwd_cuda(
            dy, x, res, scale, mean, rstd)),
        "plain_ms": timed_ms(lambda: fused_add_ln_bwd_plain(
            dy, x, res, scale, mean, rstd, P_DROP, KERNEL_SEED), iters=5),
        "library_ms": timed_ms(lambda: torch.autograd.grad(
            y_lib, (xg, rg, scg, big), dy, retain_graph=True)),
        "bound_ms": bound_ms, "bound_by": bound_by, "shape": [N, H],
        "bytes": nbytes}
    return {"fwd": fwd, "bwd": bwd}


def check_short_mhsa_train(dtype, seed: int, dev) -> dict:
    """K4 with dropout and K5 at U = 2,048: {"fwd": ..., "bwd": ...}."""
    import torch.nn.functional as F
    from news_recommendation_mind_tpu_torch.ops.short_mhsa import (
        _short_mhsa_bwd_cuda, short_mhsa, short_mhsa_bwd_plain,
        short_mhsa_plain)
    U, S, H, NH = TRAIN_U, TRAIN_S, WIDTH, HEADS
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    q, k, v, do = (torch.randn(U, S, H, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    lens = torch.randint(1, S + 1, (U,), generator=g, device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).float()
    mask[::64] = 0.0                          # fully-masked articles
    elt = q.element_size()

    # the call the model makes: the public wrapper and autograd through it
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = short_mhsa(*leaves, mask, NH, p_drop=P_DROP, seed=KERNEL_SEED)
    dq, dk, dv = torch.autograd.grad(got, leaves, do)
    again = _short_mhsa_bwd_cuda(q, k, v, mask, do, NH, P_DROP, KERNEL_SEED)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))):
        raise AssertionError("short_mhsa_bwd differs from run to run")
    want = short_mhsa_plain(q, k, v, mask, NH, P_DROP, KERNEL_SEED)
    want_g = short_mhsa_bwd_plain(q, k, v, mask, do, NH, P_DROP, KERNEL_SEED)
    err = compare(got, want, dtype, f"short_mhsa p=0.1 {dtype}")
    err_g = max(compare(a, b, dtype, f"short_mhsa_bwd {name} {dtype}")
                for a, b, name in zip((dq, dk, dv), want_g, "qkv"))
    for t in (got, dq, dk, dv):
        if t[::64].abs().max().item() != 0.0:
            raise AssertionError("short_mhsa: a fully-masked article is "
                                 "not exactly 0 in output or gradients")

    lib_mask = mask.clone()
    lib_mask[:, 0] = 1.0        # SDPA gives NaN for a fully-masked row
    keep = lib_mask.bool()[:, None, None, :]
    q4, k4, v4, do4 = (t.view(U, S, NH, H // NH).transpose(1, 2)
                       for t in (q, k, v, do))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    out_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep,
                                             dropout_p=P_DROP)
    nbytes = 4 * U * S * H * elt + U * S * 4
    flops = U * NH * 4 * S * S * (H // NH)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    fwd = {
        "max_abs_err": err,
        "ms": timed_ms(lambda: short_mhsa(q, k, v, mask, NH, p_drop=P_DROP,
                                          seed=KERNEL_SEED), iters=20),
        "ms_p0": timed_ms(lambda: short_mhsa(q, k, v, mask, NH), iters=20),
        "plain_ms": timed_ms(lambda: short_mhsa_plain(
            q, k, v, mask, NH, P_DROP, KERNEL_SEED), iters=5),
        "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=keep, dropout_p=P_DROP), iters=20),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": [U, S, H, NH], "bytes": nbytes, "flops": flops}
    nbytes = 7 * U * S * H * elt + U * S * 4
    flops = U * NH * 10 * S * S * (H // NH)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    bwd = {
        "max_abs_err": err_g,
        "ms": timed_ms(lambda: _short_mhsa_bwd_cuda(
            q, k, v, mask, do, NH, P_DROP, KERNEL_SEED), iters=20),
        "ms_p0": timed_ms(lambda: _short_mhsa_bwd_cuda(
            q, k, v, mask, do, NH), iters=20),
        "plain_ms": timed_ms(lambda: short_mhsa_bwd_plain(
            q, k, v, mask, do, NH, P_DROP, KERNEL_SEED), iters=5),
        "library_ms": timed_ms(lambda: torch.autograd.grad(
            out_lib, (qg, kg, vg), do4, retain_graph=True), iters=20),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": [U, S, H, NH], "bytes": nbytes, "flops": flops}
    return {"fwd": fwd, "bwd": bwd}


def check_keep_masks(dev) -> dict:
    """K3 and K6: the probe kernels draw the plain Philox's bits."""
    from news_recommendation_mind_tpu_torch.ops.dropout_bits import (
        attn_keep_mask, attn_keep_mask_plain, ln_keep_mask,
        ln_keep_mask_plain)
    N, H, U, S, NH = TRAIN_U * TRAIN_S, WIDTH, TRAIN_U, TRAIN_S, HEADS
    out = {}
    for name, kernel, plain, args, size in (
            ("ln_keep_mask", ln_keep_mask, ln_keep_mask_plain,
             (KERNEL_SEED, N, H, P_DROP), N * H),
            ("attn_keep_mask", attn_keep_mask, attn_keep_mask_plain,
             (KERNEL_SEED, U, NH, S, P_DROP), U * NH * S * S)):
        got = kernel(*args, dev)
        torch.cuda.synchronize()
        want = plain(*args, dev)
        wrong = (got != want).sum().item()
        if wrong or tuple(got.shape) != tuple(want.shape):
            raise AssertionError(f"{name}: {wrong} of {size} bits differ "
                                 f"from the plain Philox")
        rate = got.float().mean().item()
        sigma = math.sqrt(P_DROP * (1 - P_DROP) / size)
        if abs(rate - (1 - P_DROP)) > 4 * sigma:
            raise AssertionError(f"{name}: keep rate {rate}")
        # one Philox call per four elements: 10 rounds of two 32x32
        # multiplies (low and high word) and three xors, about 110 integer
        # operations; the card's int32 rate is not in the peak table, so
        # the bound is the bytes of the mask alone
        bound_ms, bound_by = bound(size, 0, torch.float32)
        out[name] = {
            "max_abs_err": float(wrong), "keep_rate": rate,
            "ms": timed_ms(lambda: kernel(*args, dev)),
            "plain_ms": timed_ms(lambda: plain(*args, dev), iters=5),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": list(got.shape), "bytes": size}
    return out


def check_fused_adam(cfg, dev) -> dict:
    """K7 over the full newsbert parameter set, from non-zero moments."""
    from news_recommendation_mind_tpu_torch.experiment import build_model
    from news_recommendation_mind_tpu_torch.ops.fused_adam import (
        MultiTensorAdam, fused_adam_plain)
    model = build_model(cfg, VOCAB, device=dev)
    names = [k for k, _ in model.named_parameters()]
    groups = [int("bert" in k.lower()) for k in names]
    g = torch.Generator(device=dev).manual_seed(cfg.seed + 4)

    def leaves(scale, positive=False):
        out = []
        for prm in model.parameters():
            t = torch.randn(prm.shape, generator=g, device=dev) * scale
            out.append(t.abs() if positive else t)
        return out

    params = [prm.detach().clone() for prm in model.parameters()]
    mus, nus, grads = leaves(1e-3), leaves(1e-6, True), leaves(1e-3)
    n = sum(t.numel() for t in params)
    lr0, lr1, bc1, bc2 = 1e-4, 6e-6, 1 - 0.9 ** 7, 1 - 0.999 ** 7
    kernel_set = [[t.clone() for t in ts] for ts in (params, mus, nus)]
    plain_set = [[t.clone() for t in ts] for ts in (params, mus, nus)]
    opt = MultiTensorAdam(*kernel_set, groups)
    opt.step(grads, lr0, lr1, bc1, bc2)
    torch.cuda.synchronize()
    fused_adam_plain(*plain_set, grads, [lr1 if gr else lr0 for gr in groups],
                     bc1, bc2, b1=0.9, b2=0.999, eps=1e-8)
    err, off = 0.0, 0
    eps32 = torch.finfo(torch.float32).eps
    for got, want in zip(sum(kernel_set, []), sum(plain_set, [])):
        d = (got - want).abs()
        if not torch.isfinite(got).all() or \
                (d > eps32 * want.abs()).any():
            raise AssertionError("fused_adam: more than one float32 ulp "
                                 f"from the plain version ({d.max().item()})")
        err = max(err, d.max().item())
        off += (d != 0).sum().item()
    lib_params = [torch.nn.Parameter(t.clone()) for t in params]
    for prm, gr in zip(lib_params, grads):
        prm.grad = gr
    lib = torch.optim.Adam(lib_params, lr=lr0, fused=True)
    nbytes = 28 * n
    bound_ms, bound_by = bound(nbytes, 12 * n, torch.float32)
    return {
        "max_abs_err": err, "elements_not_bitwise": off, "parameters": n,
        "leaves": len(params),
        "ms": timed_ms(lambda: opt.step(grads, lr0, lr1, bc1, bc2),
                       iters=20),
        "plain_ms": timed_ms(lambda: fused_adam_plain(
            *plain_set, grads, [lr1 if gr else lr0 for gr in groups], bc1,
            bc2, b1=0.9, b2=0.999, eps=1e-8), iters=3, warmup=1),
        "library_ms": timed_ms(lib.step, iters=20),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


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
    want = {**dict.fromkeys(launches, 0), "short_mhsa": batches * layers,
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


def synthetic_behaviors(n_articles: int, n_records: int, seed: int):
    """Train behaviours over ``n_articles``: one record per click, ragged
    histories of 0-80 clicks (so some are empty and some longer than
    his_size) and negative pools of 0-20. 85% of all clicks fall on a hot
    set of 1,200 articles, the rest anywhere in the corpus, so a batch of
    128 impressions touches about 1,900 distinct articles of its ~5,000
    slots, as news popularity makes real batches do."""
    from news_recommendation_mind_tpu_torch.data.cache import Behaviors
    rng = np.random.default_rng(seed)

    def draw(n):
        hot = 1 + rng.integers(0, min(1200, n_articles), n)
        tail = 1 + rng.integers(0, n_articles, n)
        return np.where(rng.random(n) < 0.85, hot, tail).astype(np.int32)

    def offsets(lens):
        return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    his_len = rng.integers(0, 81, n_records)
    his_len[:4] = 0
    neg_len = rng.integers(0, 21, n_records)
    return Behaviors(
        mode="train", impr_idx=np.arange(n_records, dtype=np.int32),
        uindex=rng.integers(1, n_records // 4, n_records).astype(np.int32),
        his_flat=draw(his_len.sum()), his_offsets=offsets(his_len),
        pos=draw(n_records), neg_flat=draw(neg_len.sum()),
        neg_offsets=offsets(neg_len))


def train_data(cfg, n_articles: int, n_records: int):
    from news_recommendation_mind_tpu_torch.experiment import DataBundle
    return DataBundle(
        tokenizer=None,
        news={"train": synthetic_news(n_articles, cfg.seed)},
        behaviors={"train": synthetic_behaviors(n_articles, n_records,
                                                cfg.seed + 1)},
        user_num=n_records // 4, vocab_size=VOCAB)


def dropout_sites(seed: int, layers: int):
    """The seeds ``BertModel.forward(..., seed=seed)`` gives its dropout
    sites (models/bert.py): ("ln" | "attn", seed) per site."""
    from news_recommendation_mind_tpu_torch.ops.dropout_bits import fold_seed
    sites = [("ln", fold_seed(seed, 0))]
    for i in range(layers):
        layer_seed = fold_seed(seed, i + 1)
        sites += [("attn", fold_seed(layer_seed, 0)),
                  ("ln", fold_seed(layer_seed, 1)),
                  ("ln", fold_seed(layer_seed, 2))]
    return sites


# card vs CPU, float32, dropout on from one seed: the two devices sum in
# another order through four layers; a gradient leaf is held within 2e-4
# of its own largest entry (plus 1e-6 for leaves whose gradient is
# rounding noise, such as the key biases), the loss within 1e-4
PARITY_RTOL_OF_MAX, PARITY_ATOL, PARITY_LOSS_ATOL = 2e-4, 1e-6, 1e-4


def train_parity(cfg, dev) -> dict:
    """One float32 step's loss and gradients, kernels on the card against
    plain versions on the CPU, and the step's masks through the probes."""
    from news_recommendation_mind_tpu_torch.experiment import (
        build_model, build_train_loader)
    from news_recommendation_mind_tpu_torch.models.two_tower import (
        forward_from_unique, take_rows, train_loss)
    from news_recommendation_mind_tpu_torch.ops import _build
    from news_recommendation_mind_tpu_torch.ops.dropout_bits import (
        attn_keep_mask, attn_keep_mask_plain, fold_seed, ln_keep_mask,
        ln_keep_mask_plain)

    # 8 x (5 + 25) = 240 slots: the pool is 256 wide, which the CPU can
    # take through four full-width float32 layers in seconds
    cfg = cfg.replace(dtype="float32", batch_size=8, his_size=25)
    data = train_data(cfg, n_articles=2000, n_records=64)
    loader = build_train_loader(cfg, data)
    batch = next(iter(loader))
    width = len(batch["uniq_id"])
    toks = torch.from_numpy(loader.news_tokens)
    model = build_model(cfg, VOCAB, device=dev)
    cpu_model = copy.deepcopy(model).cpu()
    step_seed = fold_seed(cfg.seed, 0)

    def loss_and_grads(mdl, device):
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        b["uniq_token"] = take_rows(toks.to(device), b["uniq_id"])
        b["uniq_attn"] = (b["uniq_token"] != 0).float()
        scores = forward_from_unique(mdl, b, False, step_seed)
        loss = train_loss(scores, b["label"], b["cdd_mask"])
        return loss, torch.autograd.grad(loss, list(mdl.parameters()))

    _build.reset_launches()
    loss, grads = loss_and_grads(model, dev)
    torch.cuda.synchronize(dev)
    # what the port's own step launched, read before this script calls a
    # probe itself: the embedding dropout draws its mask through K3; K6 is
    # an oracle that no entry point of the port calls
    layers = model.bert.cfg.num_layers
    launches = dict(_build.LAUNCHES)
    want_launches = {
        "fused_add_ln": 2 * layers, "fused_add_ln_bwd": 2 * layers,
        "short_mhsa": layers, "short_mhsa_bwd": layers, "fused_adam": 0,
        "ln_keep_mask": 1, "attn_keep_mask": 0}
    if launches != want_launches:
        raise AssertionError(f"parity launches {launches}, "
                             f"want {want_launches}")
    t0 = time.perf_counter()
    want_loss, want_grads = loss_and_grads(cpu_model, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    if abs(loss.item() - want_loss.item()) > PARITY_LOSS_ATOL:
        raise AssertionError(f"parity loss {loss.item()} on the card, "
                             f"{want_loss.item()} on the CPU")
    worst, worst_name = 0.0, ""
    for (name, _), got, want in zip(model.named_parameters(), grads,
                                    want_grads):
        got = got.cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"parity: gradient of {name} not finite")
        err = (got - want).abs().max().item()
        tol = PARITY_RTOL_OF_MAX * want.abs().max().item() + PARITY_ATOL
        if err > tol:
            raise AssertionError(f"parity: gradient of {name} off by {err} "
                                 f"(tolerance {tol})")
        if err / tol > worst:
            worst, worst_name = err / tol, name
    # the masks this step drew, through the probe kernels
    _build.reset_launches()
    n_rows = width * cfg.signal_length
    for kind, site_seed in dropout_sites(step_seed, layers):
        if kind == "ln":
            got = ln_keep_mask(site_seed, n_rows, WIDTH, P_DROP, dev)
            want = ln_keep_mask_plain(site_seed, n_rows, WIDTH, P_DROP)
        else:
            got = attn_keep_mask(site_seed, width, HEADS, cfg.signal_length,
                                 P_DROP, dev)
            want = attn_keep_mask_plain(site_seed, width, HEADS,
                                        cfg.signal_length, P_DROP)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"parity: {kind} mask of seed {site_seed} "
                                 f"differs between card and CPU")
    torch.cuda.synchronize(dev)
    probes = {k: v for k, v in _build.LAUNCHES.items() if v}
    if probes != {"ln_keep_mask": 1 + 2 * layers, "attn_keep_mask": layers}:
        raise AssertionError(f"parity probe launches {probes}")
    return {"impressions": cfg.batch_size, "pool": width,
            "loss_card": loss.item(), "loss_cpu": want_loss.item(),
            "gradient_leaves": len(grads),
            "worst_leaf": worst_name, "worst_err_over_tolerance": worst,
            "cpu_step_s": cpu_s, "launches": launches,
            "probe_launches": probes}


def train(cfg, dev, warmup_steps: int = 3, timed_steps: int = 12,
          fixed_steps: int = 20) -> dict:
    """``Trainer.train()`` at the production settings, then more steps on
    one fixed batch."""
    from news_recommendation_mind_tpu_torch.experiment import (
        build_model, build_train_loader)
    from news_recommendation_mind_tpu_torch.models.two_tower import (
        forward_from_unique, take_rows, train_loss)
    from news_recommendation_mind_tpu_torch.ops import _build
    from news_recommendation_mind_tpu_torch.train.loop import (
        Trainer, to_device)
    from news_recommendation_mind_tpu_torch.train.state import (
        create_train_state, make_fused_optimizer)
    from news_recommendation_mind_tpu_torch.train.step import make_train_step

    cfg = cfg.replace(batch_size=128, epochs=1, interval=1)
    data = train_data(cfg, MIND_SMALL_DEV_ARTICLES, 128 * 40)
    loader = build_train_loader(cfg, data)
    if not loader.dedup or loader.emit_tokens:
        raise AssertionError("the production loader dedups and ships ids")
    model = build_model(cfg, VOCAB, device=dev)
    layers = model.bert.cfg.num_layers
    trainer = Trainer(cfg.replace(step_budget=warmup_steps), model, loader,
                      device=dev)
    n_params = sum(p.numel() for p in trainer.state.params.values())
    trainer.train()                                   # warm-up
    torch.cuda.synchronize(dev)
    widths = [len(b["uniq_id"]) for b, _ in zip(iter(loader),
                                                range(timed_steps))]

    trainer.cfg = cfg.replace(step_budget=timed_steps)
    trainer.history.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    per_step = {"short_mhsa": layers, "short_mhsa_bwd": layers,
                "fused_add_ln": 2 * layers, "fused_add_ln_bwd": 2 * layers,
                "fused_adam": 1, "ln_keep_mask": 1, "attn_keep_mask": 0}
    want = {k: v * timed_steps for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    losses = [loss for _, loss in trainer.history]
    if len(losses) != timed_steps or not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    if trainer.state.step != warmup_steps + timed_steps:
        raise AssertionError(f"state.step {trainer.state.step}")
    out = {
        "impressions_per_step": cfg.batch_size, "steps": timed_steps,
        "steps_per_s": timed_steps / seconds,
        "examples_per_s": timed_steps * cfg.batch_size / seconds,
        "step_ms": seconds / timed_steps * 1e3,
        "pool_widths": sorted(set(widths)), "parameters": n_params,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "launches": launches, "launches_per_step": per_step,
        "loss_first": losses[0], "loss_last": losses[-1]}

    # one fixed batch, both learning-rate groups at lr so that twenty
    # steps move the encoder visibly
    print(f"fixed-batch check: bert_lr set to lr = {cfg.lr}")
    batch = to_device(next(iter(loader)), dev)
    opt = make_fused_optimizer(cfg.lr, cfg.lr)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, news_table=(loader.news_tokens,
                                                   loader.news_attn),
                           device=dev)
    tok_table = torch.from_numpy(loader.news_tokens).to(dev)

    def fixed_loss() -> float:
        b = dict(batch)
        b["uniq_token"] = take_rows(tok_table, b["uniq_id"])
        b["uniq_attn"] = (b["uniq_token"] != 0).float()
        with torch.no_grad():
            scores = forward_from_unique(model, b, True)
            return train_loss(scores, b["label"], b["cdd_mask"]).item()

    before = fixed_loss()
    for _ in range(fixed_steps):
        state, metrics = step(state, batch, cfg.seed)
        if not math.isfinite(metrics["loss"].item()):
            raise AssertionError("fixed-batch loss is not finite")
    after = fixed_loss()
    if not after < before:
        raise AssertionError(f"{fixed_steps} steps on one batch moved its "
                             f"loss from {before} to {after}")
    out.update(fixed_batch_steps=fixed_steps, fixed_batch_loss_before=before,
               fixed_batch_loss_after=after)
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

    def report(name, r, dtype):
        atol, rtol = TOLERANCE.get(dtype, (0.0, 0.0))
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"{name} {dtype}: max_abs_err {r['max_abs_err']:.3g} "
              f"(atol {atol}, rtol {rtol}); kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")

    cfg = newsbert_config(args.seed)
    checks = {}
    dtypes = [(dt, str(dt).split(".")[-1])
              for dt in (torch.bfloat16, torch.float32)]
    # the serving slice first, as it ran before the training slice was
    # added: its sweep rate follows the host's state (PERF.md section 5)
    for dtype, tag in dtypes:
        for name, fn in (("short_mhsa", check_short_mhsa),
                         ("fused_add_ln", check_fused_add_ln)):
            r = checks[f"{name}@serving/{tag}"] = fn(dtype, args.seed, dev)
            report(f"{name} (serving shape)", r, dtype)
    serving = serve(cfg, dev)
    print("serving: " + json.dumps(serving))

    for dtype, tag in dtypes:
        for name, fn in (("short_mhsa", check_short_mhsa_train),
                         ("fused_add_ln", check_fused_add_ln_train)):
            r = fn(dtype, args.seed, dev)
            checks[f"{name}/{tag}"] = r["fwd"]
            checks[f"{name}_bwd/{tag}"] = r["bwd"]
            report(f"{name} (training shape, p_drop {P_DROP})", r["fwd"],
                   dtype)
            report(f"{name}_bwd (training shape, p_drop {P_DROP})",
                   r["bwd"], dtype)
            print(f"  without dropout: {name} {r['fwd']['ms_p0']:.4f} ms, "
                  f"{name}_bwd {r['bwd']['ms_p0']:.4f} ms")
    for name, r in check_keep_masks(dev).items():
        checks[f"{name}/bfloat16"] = r
        report(name, r, "bits")
    r = checks["fused_adam/bfloat16"] = check_fused_adam(cfg, dev)
    report(f"fused_adam ({r['parameters']} parameters, {r['leaves']} "
           f"leaves, {r['elements_not_bitwise']} elements not bitwise)", r,
           "float32, tolerance 1 ulp")
    parity = train_parity(cfg, dev)
    print("parity: " + json.dumps(parity))
    training = train(cfg, dev)
    print("training: " + json.dumps(training))

    src = "news_recommendation_mind_tpu_torch/csrc/"
    ops = "news_recommendation_mind_tpu/ops/"
    # name: (source, the TPU kernel it replaces). `launches` is the count
    # from the training run. The attention probe is the oracle of K4/K5's
    # dropout and no entry point of the port calls it: its count is 0 there
    # by design, and `probe_launches` counts this script's own calls in the
    # train-step parity phase, where it rebuilt every mask that step drew
    table = {
        "fused_add_ln": ("fused_add_ln.cu", "pallas_ln.py:136"),
        "fused_add_ln_bwd": ("fused_add_ln_bwd.cu", "pallas_ln.py:182"),
        "ln_keep_mask": ("dropout_bits.cu", "pallas_ln.py:211"),
        "short_mhsa": ("short_mhsa.cu", "pallas_mhsa.py:195"),
        "short_mhsa_bwd": ("short_mhsa_bwd.cu", "pallas_mhsa.py:221"),
        "attn_keep_mask": ("dropout_bits.cu", "pallas_mhsa.py:247"),
        "fused_adam": ("fused_adam.cu", "pallas_adam.py:93"),
    }
    kernels = []
    for name, (source, replaces) in table.items():
        r = checks[f"{name}/bfloat16"]
        entry = {
            "name": name, "route": "cuda", "source": src + source,
            "replaces": ops + replaces,
            "launches": training["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if f"{name}@serving/bfloat16" in checks:
            sv = checks[f"{name}@serving/bfloat16"]
            entry["serving"] = {
                "launches": serving["launches"][name],
                **{k: sv[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")}}
        if name == "attn_keep_mask":
            entry["probe_launches"] = parity["probe_launches"][name]
        elif entry["launches"] < 1:
            raise AssertionError(f"{name} was launched no time in training")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
