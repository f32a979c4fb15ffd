#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (stpy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the hand-written kernels from stpy_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, drives the exact-GP serving
path (GaussianProcess.fit_predict) at n = ntest = 16384, d = 8 with the data
of bench.py in four tiers -- single (SE), double at var_refine=0 (SE),
double at var_refine=1 (SE and Matérn-3/2) and single with the Laplace
kernel -- checks each posterior against a float64 computation by plain
torch.linalg on the card, shows through the launch counters (zeroed just
before each tier's run and read just after) that each tier went through its
kernels, and times every tier and every kernel. With --profile it also
traces one warm fit_predict of the single, double and var_refine tiers with
torch.profiler: device busy time and idle share, host time, peak memory,
and the kernels that take the time. Every phase asserts; any failure exits
non-zero.

The last line of standard output is one JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}; the
line before it is the card's name and power limit as nvidia-smi reports
them, and the line before that the per-kernel JSON record. Without CUDA the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from stpy_tpu_torch import GaussianProcess, KernelFunction, _build
from stpy_tpu_torch.ops import launch_counts, reset_launch_counts
from stpy_tpu_torch.ops.gemv_df import gemv_df, gemv_df_plain
from stpy_tpu_torch.ops.gram import gram_plain, gram_scaled
from stpy_tpu_torch.ops.gram_df import gram_df_plain, gram_df_scaled
from stpy_tpu_torch.ops.gram_l1 import gram_l1, gram_l1_plain
from stpy_tpu_torch.ops.qform_df import qform_df_plain, qform_refined_strip

N = NTEST = 16384
D = 8
GAMMA = 0.5
LAPLACE_GAMMA = 2.0              # exp(-|x-y|_1/4): off-diagonals ~0.26
S = 0.1
RAGGED = (300, 517, 3)           # n, m, d: every tile edge is ragged
QFORM_RAGGED = (300, 517, 211)   # c, n, t: no edge is a multiple of a tile
FAMILIES = (("se", 1.5), ("matern", 1.5))

# Tolerances of the kernel-vs-plain checks:
# gram, absolute error on entries <= kappa = 1. sq = |x|^2 + |y|^2 - 2x.y
# cancels near the diagonal, where |x|^2 reaches ~30 at d = 8, gamma = 0.5,
# and |dK/dsq| reaches 1.5 there for Matern-3/2.
# Against the plain version run in float64 on the same f32 inputs, the error
# is the kernel's own f32 rounding: a few ulps of 30 (~4e-6) in sq.
GRAM_ATOL = 1e-5
# Against the plain version in f32 both sides round: cuBLAS sums x.y and
# torch.sum the norms in other orders than the kernel's one FMA chain, so sq
# on the diagonal is ~2 ulps of 32 (7.6e-6) instead of 0, times 1.5.
GRAM_F32_ATOL = 3e-5
# gram_df: both compute in FP64; hi + lo differs only by the order of the
# squared-distance sum and by the f32 rounding of lo (~eps32^2 relative).
GRAM_DF_RTOL = 1e-12
# gemv_df: both sum in FP64, in different orders; the error is a few f64
# ulps of sum_j |A_ij| |v_j|, against which it is measured.
GEMV_DF_RTOL = 1e-12
# gram_l1, absolute error on entries <= kappa = 1. At d = 8 the f32 L1 sum
# D < 16 rounds d times (relative 6e-8 each) and |dK/dD|·D = u·exp(-u) <= 0.37
# with u = D/gamma^2, so D's rounding moves K by < 1.8e-7; expf adds 2 ulps
# (2.4e-7). Against the plain version in f64 that is < 4.2e-7; against the
# plain version in f32 both sides round, < 8.4e-7.
GRAM_L1_ATOL = 1e-6
# qform_df: both compute in FP64 in different orders (the kernel's k-ordered
# tensor-core FMAs against cuBLAS DGEMM, then the column sums); the error is
# a few f64 ulps of sum_a |W0a| (2|B| + |A||W0k| + s^2|W0a|), against which
# it is measured.
QFORM_RTOL = 1e-12
# posterior against the float64 reference (issue bars; the double tier's
# ROADMAP bar is <= 1e-7 and is recorded beside the measured value). The
# var_refine tier carries the ROADMAP's variance bar: max <= 1e-6 relative.
SINGLE_MEAN_RTOL, DOUBLE_MEAN_RTOL, VAR_MAX_RTOL = 1e-4, 1e-6, 1e-2
REFINED_VAR_MAX_RTOL = 1e-6
# The Laplace Gram at gamma = 2 is far from diagonal (off-diagonals ~0.26,
# lambda_min >= s^2), and the single tier's f32 Cholesky and solves lose
# accuracy with that conditioning. Phase 6 prints that floor: the same f32
# Cholesky and solves by plain torch.linalg on the float64 Gram rounded to
# f32. The SE bar of 1e-4 sits below it at n = 16384; 1e-3 keeps a margin
# above it, and phase 2 holds the kernel itself at 1e-6.
LAPLACE_MEAN_RTOL = 1e-3

REPLACES = {
    "gram": ("stpy_tpu_torch/csrc/gram.cu", "stpy_tpu/ops/pallas_gram.py:63"),
    "gram_df": ("stpy_tpu_torch/csrc/gram_df.cu",
                "stpy_tpu/ops/pallas_gram_df.py:319"),
    "gemv_df": ("stpy_tpu_torch/csrc/gemv_df.cu",
                "stpy_tpu/ops/pallas_gemv_df.py:48"),
    "qform_df": ("stpy_tpu_torch/csrc/qform_df.cu",
                 "stpy_tpu/ops/pallas_qform_df.py:60"),
    "gram_l1": ("stpy_tpu_torch/csrc/gram_l1.cu",
                "stpy_tpu/ops/pallas_gram.py:209"),
}
# H100 SXM data-sheet peaks, dense: HBM3 bytes/s, f32 outside the tensor
# cores, FP64 outside them and FP64 on the tensor cores (flop/s)
HBM_BPS, F32_FLOPS, F64_FLOPS, F64_MMA_FLOPS = 3.35e12, 67e12, 34e12, 67e12
# the cuSOLVER / cuBLAS stages of stpy_tpu_torch/linalg.py (phase 8 split)
LINALG_OPS = ("aten::linalg_cholesky_ex", "aten::cholesky_solve",
              "aten::linalg_solve_triangular")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bench_data(dev):
    """The data of bench.py:32-38 (numpy seed 0), on `dev` in f32."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (N, D)).astype(np.float32)
    y = (np.sin(3 * x[:, :1]) + 0.1 * rng.standard_normal((N, 1))).astype(
        np.float32)
    xt = rng.uniform(-1, 1, (NTEST, D)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in (x, y, xt))


def cuda_ms(fn, reps=5) -> float:
    """Mean device time of `fn` over `reps` runs, by CUDA events."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_pair(kernel_fn, plain_fn, reps=5):
    """(kernel ms, plain ms), run in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes, flops, peak_flops):
    """(least time in ms, what bounds it): the bytes the function must move
    over HBM_BPS against its operations over `peak_flops`."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gram_bounds(n, m, d):
    """gram, gram_df, gemv_df and gram_l1 at an (n, m, d) shape: inputs read
    once, outputs written once; per entry 2d + 5 f32 operations for the SE
    Gram, 3d + 10 FP64 ones for the df Gram, 4 FP64 ones per GEMV term and
    3d + 2 f32 ones for the L1 Gram."""
    return {
        "gram": bound(4 * (n + m) * d + 4 * n * m, (2 * d + 5) * n * m,
                      F32_FLOPS),
        "gram_df": bound(8 * (n + m) * d + 8 * n * m, (3 * d + 10) * n * m,
                         F64_FLOPS),
        "gemv_df": bound(8 * n * m + 8 * m + 8 * n, 4 * n * m, F64_FLOPS),
        "gram_l1": bound(4 * (n + m) * d + 4 * n * m, (3 * d + 2) * n * m,
                         F32_FLOPS),
    }


def qform_bound(c, n, t):
    """qform_df: Th, Tl, W0k, W0a, Bh, Bl read once, (qh, ql) written once;
    2cnt FP64 operations of the product, which the tensor cores could run."""
    return bound(4 * (2 * c * n + n * t + 3 * c * t) + 8 * t,
                 2 * c * n * t + 6 * c * t, F64_MMA_FLOPS)


def kernel_checks(dev):
    """Phase 2a: gram, gram_df, gemv_df and gram_l1 against their plain
    versions, ragged and bench shapes, SE and Matérn-3/2. Returns name ->
    max abs error and the bench-shape timings."""
    rng = np.random.default_rng(1)
    err = {"gram": 0.0, "gram_df": 0.0, "gemv_df": 0.0, "gram_l1": 0.0}
    times = {}
    shapes = [("ragged", RAGGED), ("bench", (N, N, D))]
    inv_g2 = 1.0 / LAPLACE_GAMMA ** 2
    for label, (n, m, d) in shapes:
        xs64 = torch.as_tensor(rng.uniform(-1, 1, (n, d)) / GAMMA, device=dev)
        # bench shape: the fit Gram K(x, x), whose diagonal is the hard case
        ys64 = xs64 if label == "bench" else torch.as_tensor(
            rng.uniform(-1, 1, (m, d)) / GAMMA, device=dev)
        xs, ys = xs64.float(), ys64.float()
        v = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                            device=dev)
        vl = v * torch.as_tensor(rng.uniform(-6e-8, 6e-8, m),
                                 dtype=torch.float32, device=dev)
        # the Laplace Gram of the unscaled coordinates in [-1, 1]
        xu, yu = xs * GAMMA, ys * GAMMA
        K = gram_l1(xu, yu, inv_g2, 1.0)
        e = float((K - gram_l1_plain(xu, yu, inv_g2, 1.0)).abs().max())
        e64 = float((K.double() - gram_l1_plain(
            xu.double(), yu.double(), inv_g2, 1.0)).abs().max())
        print(f"  gram_l1 {label:6s} {n}x{m} d={d}: max abs err {e!r} "
              f"(plain f32), {e64!r} (plain f64)")
        assert e <= GRAM_L1_ATOL and e64 <= GRAM_L1_ATOL, ("gram_l1", label, e, e64)
        err["gram_l1"] = max(err["gram_l1"], e)
        del K
        if label == "bench":
            times["gram_l1"] = timed_pair(
                lambda: gram_l1(xu, yu, inv_g2, 1.0),
                lambda: gram_l1_plain(xu, yu, inv_g2, 1.0))
            times["bounds"] = gram_bounds(n, m, d)
        for fam, nu in FAMILIES:
            K = gram_scaled(xs, ys, 1.0, fam, nu)
            Kp = gram_plain(xs, ys, 1.0, fam, nu)
            e = float((K - Kp).abs().max())
            del Kp
            Kp64 = gram_plain(xs.double(), ys.double(), 1.0, fam, nu)
            e64 = float((K.double() - Kp64).abs().max())
            print(f"  gram    {label:6s} {fam:6s} {n}x{m} d={d}: max abs err "
                  f"{e!r} (plain f32), {e64!r} (plain f64)")
            assert e <= GRAM_F32_ATOL and e64 <= GRAM_ATOL, ("gram", label, fam, e, e64)
            err["gram"] = max(err["gram"], e)
            del K, Kp64

            hi, lo = gram_df_scaled(xs64, ys64, 1.0, fam, nu)
            hp, lp = gram_df_plain(xs64, ys64, 1.0, fam, nu)
            ref = hp.double() + lp.double()
            diff = (hi.double() + lo.double() - ref).abs()
            e = float(diff.max())
            rel = float((diff / ref.abs().clamp_min(1e-300)).max())
            print(f"  gram_df {label:6s} {fam:6s} {n}x{m} d={d}: max abs err "
                  f"{e!r}, max rel err {rel!r}")
            assert rel <= GRAM_DF_RTOL, ("gram_df", label, fam, rel)
            err["gram_df"] = max(err["gram_df"], e)
            del hp, lp, ref, diff

            oh, ol = gemv_df(hi, lo, v, vl)
            ph, pl = gemv_df_plain(hi, lo, v, vl)
            scale = (hi.double() + lo.double()).abs() @ (
                v.double() + vl.double()).abs()
            d_ = (oh.double() + ol.double() - ph.double() - pl.double()).abs()
            e = float(d_.max())
            rel = float((d_ / scale.clamp_min(1e-300)).max())
            print(f"  gemv_df {label:6s} {fam:6s} {n}x{m}: max abs err {e!r}, "
                  f"max err / sum|A||v| {rel!r}")
            assert rel <= GEMV_DF_RTOL, ("gemv_df", label, fam, rel)
            err["gemv_df"] = max(err["gemv_df"], e)

            if label == "bench" and fam == "se":
                times["gram"] = timed_pair(
                    lambda: gram_scaled(xs, ys, 1.0, fam, nu),
                    lambda: gram_plain(xs, ys, 1.0, fam, nu))
                times["gram_df"] = timed_pair(
                    lambda: gram_df_scaled(xs64, ys64, 1.0, fam, nu),
                    lambda: gram_df_plain(xs64, ys64, 1.0, fam, nu))
                times["gemv_df"] = timed_pair(
                    lambda: gemv_df(hi, lo, v, vl),
                    lambda: gemv_df_plain(hi, lo, v, vl))
            del hi, lo
            torch.cuda.empty_cache()
    return err, times


def qform_error(Th, Tl, W0k, W0a, Bh, Bl):
    """(max |Δq|, max |Δq| / scale) of the kernel against its plain version,
    scale = Σ_a |W0a|·(2|B| + |A|·|W0k| + s²|W0a|)."""
    qh, ql = qform_refined_strip(Th, Tl, W0k, W0a, Bh, Bl, S)
    ph, pl = qform_df_plain(Th, Tl, W0k, W0a, Bh, Bl, S * S)
    diff = (qh.double() + ql.double() - ph.double() - pl.double()).abs()
    del qh, ql, ph, pl
    Wa = W0a.double().abs()
    AW = (Th.double() + Tl.double()).abs() @ W0k.double().abs()
    scale = (Wa * (2 * (Bh.double() + Bl.double()).abs() + AW + S * S * Wa)).sum(0)
    return float(diff.max()), float((diff / scale).max())


def qform_checks(dev, x, xt):
    """Phase 2b: qform_df against its plain version on a ragged strip with
    random operands and at the bench shape c = n = t = 16384 on the real SE
    system (df train Gram, df cross Gram, W0 from the f32 Cholesky solve).
    Returns the max abs error and (kernel ms, plain ms, f64 DGEMM ms of the
    same (c, n)·(n, t) product)."""
    rng = np.random.default_rng(2)
    c, n, t = QFORM_RAGGED

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=dev)

    def lo(a):
        return a * torch.as_tensor(rng.uniform(-6e-8, 6e-8, a.shape),
                                   dtype=torch.float32, device=dev)

    Th, W0k, W0a, Bh = f32(c, n), f32(n, t), f32(c, t), f32(c, t)
    e, rel = qform_error(Th, lo(Th), W0k, W0a, Bh, lo(Bh))
    print(f"  qform_df ragged strip c={c} n={n} t={t}: max abs err {e!r}, "
          f"max err / scale {rel!r}")
    assert rel <= QFORM_RTOL, ("qform_df", "ragged", rel)
    err = e

    xs64, xts64 = x.double() / GAMMA, xt.double() / GAMMA
    Th, Tl = gram_df_scaled(xs64, xs64, 1.0, "se")
    Bh, Bl = gram_df_scaled(xs64, xts64, 1.0, "se")       # (n, t)
    A = Th.clone()
    A.diagonal().add_(S * S)
    L, info = torch.linalg.cholesky_ex(A)
    assert int(info) == 0, info
    del A
    W0 = torch.cholesky_solve(Bh, L).contiguous()
    del L
    assert bool(Tl.abs().max() > 0 and Bl.abs().max() > 0)
    e, rel = qform_error(Th, Tl, W0, W0, Bh, Bl)
    print(f"  qform_df bench  c=n=t={N} (SE system): max abs err {e!r}, "
          f"max err / scale {rel!r}")
    assert rel <= QFORM_RTOL, ("qform_df", "bench", rel)
    err = max(err, e)
    torch.cuda.empty_cache()
    k_ms, p_ms = timed_pair(
        lambda: qform_refined_strip(Th, Tl, W0, W0, Bh, Bl, S),
        lambda: qform_df_plain(Th, Tl, W0, W0, Bh, Bl, S * S), reps=2)
    A64 = Th.double() + Tl.double()
    W64 = W0.double()
    g_ms = cuda_ms(lambda: A64 @ W64, reps=2)
    return err, (k_ms, p_ms, g_ms)


def kernel_matrix(family, gamma, a, b):
    """k(a_i, b_j) in float64 by plain torch ops: SE, Matérn-3/2 (γ-scaled
    euclidean distances) or Laplace (L1 distance over γ²)."""
    if family == "laplace":
        return torch.exp(-torch.cdist(a, b, p=1) / gamma ** 2)
    a, b = a / gamma, b / gamma
    sq = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * a @ b.T).clamp_min_(0.0)
    if family == "se":
        return torch.exp(-0.5 * sq)
    r = math.sqrt(3.0) * sq.sqrt_()
    return (1.0 + r) * torch.exp(-r)


def reference_f64(x, y, xt, family="se", gamma=GAMMA, f32_floor=False):
    """Exact posterior mean and variance in float64 by plain torch.linalg
    (no kernels of the port, no jitter). With `f32_floor`, also the max
    relative error of the posterior mean that f32 Cholesky and solves by
    plain torch.linalg reach on the float64 Gram rounded to f32."""
    x64, y64, xt64 = x.double(), y.double(), xt.double()
    K = kernel_matrix(family, gamma, x64, x64)
    K.diagonal().add_(S * S)
    floor = None
    if f32_floor:
        L32 = torch.linalg.cholesky(K.float())
        a32 = torch.cholesky_solve(y, L32)
        del L32
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(y64, L)
    Ks = kernel_matrix(family, gamma, xt64, x64)
    mu = Ks @ alpha
    if f32_floor:
        mu32 = (Ks.float() @ a32).double()
        floor = float((mu32 - mu).abs().max() / mu.abs().max())
    V = torch.linalg.solve_triangular(L, Ks.T, upper=False)
    del Ks, L
    var = 1.0 - V.square_().sum(0)
    return mu[:, 0], var, floor


def posterior_errors(mu, sd, mu64, var64):
    assert mu.shape == (NTEST, 1) and sd.shape == (NTEST, 1), (mu.shape, sd.shape)
    assert bool(torch.isfinite(mu).all() and torch.isfinite(sd).all())
    mean_rel = float((mu[:, 0].double() - mu64).abs().max() / mu64.abs().max())
    vrel = ((sd[:, 0].double() ** 2 - var64).abs() / var64).cpu()
    return mean_rel, float(vrel.max()), float(vrel.median())


def run_tier(kernel, x, y, xt, **gp_kw):
    """One fit_predict of a fresh GP on the card, the launch counters zeroed
    just before and read just after. Returns (gp, mu, sd, counts)."""
    gp = GaussianProcess(kernel=kernel, s=S, **gp_kw)
    reset_launch_counts()
    mu, sd = gp.fit_predict(x, y, xt)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert gp.fit_status["cholesky_ok"], gp.fit_status
    return gp, mu, sd, counts


def wall_median(gp, x, y, xt, reps=3) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp.fit_predict(x, y, xt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def profile_tier(kernel, label, x, y, xt, top=10, **gp_kw):
    """Phase 8 (--profile): one warm fit_predict of a fresh GP under
    torch.profiler. Prints the device busy time (union of all device
    activity), the device span, the idle share of that span, the host time
    until fit_predict returns (before the closing synchronize), the peak
    device memory of the call, the `top` kernels by device time, and the
    device time of each linalg stage (LINALG_OPS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gp = GaussianProcess(kernel=kernel, s=S, **gp_kw)
    gp.fit_predict(x, y, xt)
    torch.cuda.synchronize()
    # the refit releases the previous factors before it allocates (see
    # GaussianProcess._set_data), so the peak is the call's own plus the data
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gp.fit_predict(x, y, xt)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert dev, "torch.profiler recorded no device activity"
    busy, reach = 0.0, float("-inf")
    per_name = {}
    for e in sorted(dev, key=lambda e: e.time_range.start):
        start, end = e.time_range.start, e.time_range.end
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        t, c = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + end - start, c + 1)
    span = reach - min(e.time_range.start for e in dev)
    print(f"  {label}: device busy {busy / 1e3!r} ms of span "
          f"{span / 1e3!r} ms (idle {1 - busy / span!r}), host "
          f"{host_ms!r} ms to return, peak device memory {peak_gib!r} GiB")
    for name, (t, c) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {t / 1e3:10.3f} ms  x{c:<4d} {name[:100]}")
    for kname in REPLACES:
        hits = [tc for name, tc in per_name.items() if f"{kname}_kernel" in name]
        print(f"    hand kernel {kname}: {sum(t for t, _ in hits) / 1e3!r} ms "
              f"over {sum(c for _, c in hits)} launches")
    # device time of every kernel launched inside each linalg op of the path
    for avg in prof.key_averages():
        if avg.key in LINALG_OPS:
            print(f"    {avg.key}: {avg.device_time_total / 1e3!r} ms device "
                  f"over {avg.count} calls")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--profile", action="store_true",
        help="also profile one warm fit_predict per tier (phase 8)")
    profile = parser.parse_args(argv).profile
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print("== phase 1: environment")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build + load: {time.perf_counter() - t0!r} s "
          f"({_build.library_path()})")

    print("== phase 2: kernels against their plain versions")
    errs, ktimes = kernel_checks(dev)
    x, y, xt = bench_data(dev)
    errs["qform_df"], qtimes = qform_checks(dev, x, xt)
    ktimes["qform_df"] = qtimes[:2]
    bounds = ktimes.pop("bounds") | {"qform_df": qform_bound(N, N, NTEST)}

    print("== phase 3: single tier fit_predict, n = ntest = 16384, d = 8")
    mu64, var64, _ = reference_f64(x, y, xt)
    se = KernelFunction(kernel_name="squared_exponential", gamma=GAMMA, d=D,
                        device=dev)
    gp1, mu, sd, single_counts = run_tier(se, x, y, xt)
    single = posterior_errors(mu, sd, mu64, var64)
    print(f"  mean rel err {single[0]!r}, var rel err max {single[1]!r} "
          f"median {single[2]!r}, fit_status {gp1.fit_status}, "
          f"launches {single_counts}")
    assert single[0] <= SINGLE_MEAN_RTOL and single[1] <= VAR_MAX_RTOL, single
    assert single_counts["gram"] > 0, single_counts
    del mu, sd

    print("== phase 4: double tier (var_refine=0) fit_predict, same shape")
    gp2, mu, sd, double_counts = run_tier(se, x, y, xt, precision="double")
    double = posterior_errors(mu, sd, mu64, var64)
    print(f"  mean rel err {double[0]!r} (ROADMAP bar 1e-7), var rel err max "
          f"{double[1]!r} median {double[2]!r}, fit_status {gp2.fit_status}, "
          f"launches {double_counts}")
    assert double[0] <= DOUBLE_MEAN_RTOL and double[1] <= VAR_MAX_RTOL, double
    # the double tier's Grams are all df pairs: it launches no f32 gram
    assert double_counts["gram_df"] > 0 and double_counts["gemv_df"] > 0, \
        double_counts
    del mu, sd

    print("== phase 5: double tier at var_refine=1, SE and Matérn-3/2")
    m32 = KernelFunction(kernel_name="matern", gamma=GAMMA, nu=1.5, d=D,
                         device=dev)
    refined, refined_gp, refined_counts = {}, {}, {}
    for label, kernel, family in (("se", se, "se"), ("matern32", m32, "m32")):
        if label != "se":
            mu64, var64, _ = reference_f64(x, y, xt, family)
        gp, mu, sd, counts = run_tier(kernel, x, y, xt, precision="double",
                                      var_refine=1)
        refined[label] = posterior_errors(mu, sd, mu64, var64)
        refined_gp[label], refined_counts[label] = gp, counts
        m, vmax, vmed = refined[label]
        print(f"  {label}: mean rel err {m!r} (bar 1e-6, ROADMAP bar 1e-7), "
              f"var rel err max {vmax!r} (ROADMAP bar 1e-6) median {vmed!r}, "
              f"fit_status {gp.fit_status}, launches {counts}")
        del gp
        assert m <= DOUBLE_MEAN_RTOL and vmax <= REFINED_VAR_MAX_RTOL, refined[label]
        assert all(counts[k] > 0 for k in ("qform_df", "gram_df", "gemv_df")), \
            counts
        del mu, sd

    print("== phase 6: single tier with the Laplace kernel, gamma = 2")
    mu64, var64, floor = reference_f64(x, y, xt, "laplace", LAPLACE_GAMMA,
                                       f32_floor=True)
    lap = KernelFunction(kernel_name="laplace", gamma=LAPLACE_GAMMA, d=D,
                         device=dev)
    gp3, mu, sd, laplace_counts = run_tier(lap, x, y, xt)
    laplace = posterior_errors(mu, sd, mu64, var64)
    print(f"  mean rel err {laplace[0]!r} (bar {LAPLACE_MEAN_RTOL}; f32 "
          f"Cholesky and solves on the f64 Gram rounded to f32: {floor!r}), "
          f"var rel err max {laplace[1]!r} median {laplace[2]!r}, "
          f"fit_status {gp3.fit_status}, launches {laplace_counts}")
    assert laplace[0] <= LAPLACE_MEAN_RTOL and laplace[1] <= VAR_MAX_RTOL, laplace
    assert laplace_counts["gram_l1"] > 0, laplace_counts
    del mu, sd, mu64, var64
    launches = {"gram": ("single", single_counts["gram"]),
                "gram_df": ("double", double_counts["gram_df"]),
                "gemv_df": ("double", double_counts["gemv_df"]),
                "qform_df": ("var_refine", refined_counts["se"]["qform_df"]),
                "gram_l1": ("laplace", laplace_counts["gram_l1"])}

    print("== phase 7: times on", card)
    walls = {"single": wall_median(gp1, x, y, xt),
             "double": wall_median(gp2, x, y, xt)}
    for label in refined_gp:
        walls[f"var_refine_{label}"] = wall_median(refined_gp[label], x, y, xt)
    walls["laplace"] = wall_median(gp3, x, y, xt)
    print("  fit_predict warm median of 3: "
          + ", ".join(f"{k} {v!r} s" for k, v in walls.items()))
    for name, (k_ms, p_ms) in ktimes.items():
        print(f"  {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms, bound "
              f"{bounds[name][0]!r} ms ({bounds[name][1]}) at the bench shape")
    print(f"  qform_df: cuBLAS f64 DGEMM of the same (c, n)·(n, t) product "
          f"(a library product, not the same function) {qtimes[2]!r} ms")
    print(f"  peak device memory of the whole run "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": REPLACES[name][0],
         "replaces": REPLACES[name][1], "tier": launches[name][0],
         "launches": launches[name][1], "max_abs_err": errs[name],
         "ms": ktimes[name][0], "plain_ms": ktimes[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name in REPLACES
    ], "qform_df_dgemm_ms": qtimes[2], "fit_predict_s": walls,
        "posterior": {"single": single, "double": double,
                      **{f"var_refine_{k}": v for k, v in refined.items()},
                      "laplace": laplace}}
    if profile:
        del gp1, gp2, gp3, refined_gp
        print("== phase 8: one warm fit_predict per tier under torch.profiler")
        profile_tier(se, "single", x, y, xt)
        profile_tier(se, "double", x, y, xt, precision="double")
        profile_tier(se, "var_refine", x, y, xt, precision="double",
                     var_refine=1)
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
