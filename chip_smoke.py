#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (stpy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the hand-written kernels from stpy_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, drives the exact-GP serving
path (GaussianProcess.fit_predict, single and double tier) at n = ntest =
16384, d = 8 with the data of bench.py, checks the posterior against a
float64 computation by plain torch.linalg on the card, shows through the
launch counters (zeroed before each tier) that the path went through the
kernels, and times both tiers and every kernel. With --profile it also
traces one warm fit_predict per tier with torch.profiler: device busy time
and idle share, host time, peak memory, and the kernels that take the time.
Every phase asserts; any failure exits non-zero.

The last line of standard output is one JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}; the
line before it is the card's name and power limit as nvidia-smi reports
them, and the line before that the per-kernel JSON record. Without CUDA the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
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

N = NTEST = 16384
D = 8
GAMMA = 0.5
S = 0.1
RAGGED = (300, 517, 3)           # n, m, d: every tile edge is ragged
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
# posterior against the float64 reference (issue bars; the double tier's
# ROADMAP bar is <= 1e-7 and is recorded beside the measured value)
SINGLE_MEAN_RTOL, DOUBLE_MEAN_RTOL, VAR_MAX_RTOL = 1e-4, 1e-6, 1e-2

REPLACES = {
    "gram": ("stpy_tpu_torch/csrc/gram.cu", "stpy_tpu/ops/pallas_gram.py:63"),
    "gram_df": ("stpy_tpu_torch/csrc/gram_df.cu",
                "stpy_tpu/ops/pallas_gram_df.py:319"),
    "gemv_df": ("stpy_tpu_torch/csrc/gemv_df.cu",
                "stpy_tpu/ops/pallas_gemv_df.py:48"),
}
# the cuSOLVER / cuBLAS stages of stpy_tpu_torch/linalg.py (phase 7 split)
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
    return (torch.as_tensor(a, device=dev) for a in (x, y, xt))


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


def timed_pair(kernel_fn, plain_fn):
    """(kernel ms, plain ms), run in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn)
    k1 = cuda_ms(kernel_fn)
    k2 = cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def kernel_checks(dev):
    """Phase 2: each kernel against its plain version, ragged and bench
    shapes, SE and Matérn-3/2. Returns name -> max abs error and the
    bench-shape timings."""
    rng = np.random.default_rng(1)
    err = {"gram": 0.0, "gram_df": 0.0, "gemv_df": 0.0}
    times = {}
    shapes = [("ragged", RAGGED), ("bench", (N, N, D))]
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


def reference_f64(x, y, xt):
    """Exact posterior mean and variance in float64 by plain torch.linalg
    (no kernels of the port, no jitter)."""
    x64, y64, xt64 = x.double() / GAMMA, y.double(), xt.double() / GAMMA

    def se(a, b):
        sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
        return torch.exp(-0.5 * sq.clamp_min_(0.0))

    K = se(x64, x64)
    K.diagonal().add_(S * S)
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(y64, L)
    Ks = se(xt64, x64)
    mu = Ks @ alpha
    V = torch.linalg.solve_triangular(L, Ks.T, upper=False)
    del Ks, L
    var = 1.0 - V.square_().sum(0)
    return mu[:, 0], var


def posterior_errors(mu, sd, mu64, var64):
    assert mu.shape == (NTEST, 1) and sd.shape == (NTEST, 1), (mu.shape, sd.shape)
    assert bool(torch.isfinite(mu).all() and torch.isfinite(sd).all())
    mean_rel = float((mu[:, 0].double() - mu64).abs().max() / mu64.abs().max())
    vrel = ((sd[:, 0].double() ** 2 - var64).abs() / var64).cpu()
    return mean_rel, float(vrel.max()), float(vrel.median())


def fit_predict_tier(kernel, precision, x, y, xt):
    gp = GaussianProcess(kernel=kernel, s=S, precision=precision,
                         device="cuda")
    mu, sd = gp.fit_predict(x, y, xt)
    torch.cuda.synchronize()
    assert gp.fit_status["cholesky_ok"], gp.fit_status
    return gp, mu, sd


def wall_median(gp, x, y, xt, reps=3) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp.fit_predict(x, y, xt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def profile_tier(kernel, precision, x, y, xt, top=10):
    """Phase 7 (--profile): one warm fit_predict of a fresh GP under
    torch.profiler. Prints the device busy time (union of all device
    activity), the device span, the idle share of that span, the host time
    until fit_predict returns (before the closing synchronize), the peak
    device memory of the call, the `top` kernels by device time, and the
    device time of each linalg stage (LINALG_OPS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gp = GaussianProcess(kernel=kernel, s=S, precision=precision)
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
    print(f"  {precision}: device busy {busy / 1e3!r} ms of span "
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
        help="also profile one warm fit_predict per tier (phase 7)")
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

    print("== phase 3: single tier fit_predict, n = ntest = 16384, d = 8")
    x, y, xt = bench_data(dev)
    mu64, var64 = reference_f64(x, y, xt)
    kernel = KernelFunction(kernel_name="squared_exponential", gamma=GAMMA,
                            d=D, device=dev)
    reset_launch_counts()
    gp1, mu, sd = fit_predict_tier(kernel, "single", x, y, xt)
    single_counts = launch_counts()
    single = posterior_errors(mu, sd, mu64, var64)
    print(f"  mean rel err {single[0]!r}, var rel err max {single[1]!r} "
          f"median {single[2]!r}, fit_status {gp1.fit_status}")
    assert single[0] <= SINGLE_MEAN_RTOL and single[1] <= VAR_MAX_RTOL, single
    del mu, sd

    print("== phase 4: double tier (var_refine=0) fit_predict, same shape")
    reset_launch_counts()
    gp2, mu, sd = fit_predict_tier(kernel, "double", x, y, xt)
    double_counts = launch_counts()
    double = posterior_errors(mu, sd, mu64, var64)
    print(f"  mean rel err {double[0]!r} (ROADMAP bar 1e-7), var rel err max "
          f"{double[1]!r} median {double[2]!r}, fit_status {gp2.fit_status}")
    assert double[0] <= DOUBLE_MEAN_RTOL and double[1] <= VAR_MAX_RTOL, double
    del mu, sd, mu64, var64

    print("== phase 5: launch counts")
    # the double tier's Grams are all df pairs: it launches no f32 gram
    print(f"  single tier {single_counts}, double tier {double_counts}")
    assert single_counts["gram"] > 0, single_counts
    assert double_counts["gram_df"] > 0 and double_counts["gemv_df"] > 0, \
        double_counts
    launches = {"gram": ("single", single_counts["gram"]),
                "gram_df": ("double", double_counts["gram_df"]),
                "gemv_df": ("double", double_counts["gemv_df"])}

    print("== phase 6: times on", card)
    wall1 = wall_median(gp1, x, y, xt)
    wall2 = wall_median(gp2, x, y, xt)
    print(f"  fit_predict warm median of 3: single {wall1!r} s, "
          f"double {wall2!r} s")
    for name, (k_ms, p_ms) in ktimes.items():
        print(f"  {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms (bench shape, SE)")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": REPLACES[name][0],
         "replaces": REPLACES[name][1], "tier": launches[name][0],
         "launches": launches[name][1], "max_abs_err": errs[name],
         "ms": ktimes[name][0], "plain_ms": ktimes[name][1]}
        for name in ("gram", "gram_df", "gemv_df")
    ], "fit_predict_s": {"single": wall1, "double": wall2},
        "posterior": {"single": single, "double": double}}
    if profile:
        del gp1, gp2
        print("== phase 7: one warm fit_predict per tier under torch.profiler")
        for precision in ("single", "double"):
            profile_tier(kernel, precision, x, y, xt)
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
