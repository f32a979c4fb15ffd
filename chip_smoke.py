#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (stpy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the hand-written kernels from stpy_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, drives the exact-GP serving
path (GaussianProcess.fit_predict) at n = ntest = 16384, d = 8 with the data
of bench.py in four tiers -- single (SE), double at var_refine=0 (SE),
double at var_refine=1 (SE and Matérn-3/2) and single with the Laplace
kernel -- checks each posterior against a float64 computation by plain
torch.linalg on the card, then drives the matrix-free large-n path
(parallel.IterativeGP(lazy=True), CG on the gram_matvec / gram_matmat
kernels) on the SE(0.5) + Matérn-3/2(0.8) sum kernel: at n = 32768 against
a dense float64 posterior (single and double precision), and at n = 65536
(benchmarks/exp_r4_65k_var.py) on constructor defaults, then with a
rank-2048 preconditioner held to its float64 residual; then (phase 11) the
fast blocked Cholesky (linalg.chol_dense(fast=True) on the chol_leaf and
syrk_lower kernels) in benchmarks/exp_fastchol.py's three variants at
n = 16384 against the same float64 posterior, and a diagnosis of its
variance (the factor rebuilt with one piece swapped at a time); last
(phase 12) the df-entry stage probe (stpy_tpu_torch/probes/
exp_r3_df_entry.py, the port of
benchmarks/exp_r3_batch_{p,t,u,x}.py) at full size, every stage of the
df Matérn entry held to 1e-13 of host float64 and 40-digit decimal, on the
gram_df_stages kernel and gram_df.cu's stage launch. The launch counters, zeroed
just before each tier's run and read just after, show that each tier went
through its kernels; every tier and every kernel is timed. With --profile
it also traces one warm fit_predict of the single, double and var_refine
tiers, one warm 65k lazy fit and one warm fast factor with torch.profiler
(phase 10): device busy time and idle share, host time, peak memory, and
the kernels that take the time. Every phase asserts; any failure exits
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
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from stpy_tpu_torch import GaussianProcess, KernelFunction, _build, linalg
from stpy_tpu_torch.ops import (
    gram_df_stages, launch_counts, reset_launch_counts,
)
from stpy_tpu_torch.ops.chol_leaf import (
    MAX_LEAF, chol_leaf, chol_leaf_, chol_leaf_grid, chol_leaf_plain,
)
from stpy_tpu_torch.ops.gemv_df import gemv_df, gemv_df_plain
from stpy_tpu_torch.ops.gram import gram_plain, gram_scaled
from stpy_tpu_torch.ops.gram_df import (
    gram_df_plain, gram_df_scaled, scale_coords,
)
from stpy_tpu_torch.ops.gram_df_stages import (
    ENTRY_STAGES, GRAM_STAGES, df_entry_stage, df_entry_stage_plain,
    gram_df_stage, gram_df_stage_plain,
)
from stpy_tpu_torch.ops.gram_l1 import gram_l1, gram_l1_plain
from stpy_tpu_torch.ops.gram_matvec import (
    gram_matmat_plain, gram_matmat_scaled, gram_matvec_plain,
    gram_matvec_scaled,
)
from stpy_tpu_torch.ops.qform_df import qform_df_plain, qform_refined_strip
from stpy_tpu_torch.ops.syrk import (
    _leaf_chol_, syrk_update_lower_, syrk_update_lower_plain_,
)
from stpy_tpu_torch.parallel import IterativeGP
from stpy_tpu_torch.parallel import iterative
from stpy_tpu_torch.probes import exp_r3_df_entry

N = NTEST = 16384
D = 8
GAMMA = 0.5
LAPLACE_GAMMA = 2.0              # exp(-|x-y|_1/4): off-diagonals ~0.26
S = 0.1
RAGGED = (300, 517, 3)           # n, m, d: every tile edge is ragged
# n, m, d: more features than gram_matmat stages in shared memory (384),
# the coordinates scaled by sqrt(D / d) to d = 8's spread of distances
WIDE = (300, 517, 512)
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

# The matrix-free tier (parallel.IterativeGP, lazy=True) on the sum kernel of
# benchmarks/exp_r4_65k_var.py: SE(0.5) + Matérn-3/2(0.8), d = 8, s = 0.2;
# (family, nu, gamma) of each atom, kappa = 1.
LAZY_ATOMS = (("se", 1.5, 0.5), ("matern", 1.5, 0.8))
LAZY_S = 0.2
LAZY_N, LAZY_BIG_N, LAZY_T = 32768, 65536, 1024
MATMAT_R = 128                   # the block CG's right-hand sides
RAGGED_R = (77, 200)             # a partial slab, and a second one
EPS32 = 2.0 ** -23
# gram_matvec / gram_matmat against their plain versions run in float64 on
# the same f32 inputs, error over sum_j |K_ij| |v_j|: the kernel sums m f32
# terms and each term's sq carries a few ulps of |x|^2 + |y|^2, about
# sqrt(m)·eps32 of that scale together; the bar is twice it.
def matvec_rtol(m):
    return 2.0 * math.sqrt(m) * EPS32


# gram_matmat at a handful of y points (an IterativeGP on a few training
# points sends m = n): there the f32 entries' own rounding, a few ulps of
# |x|^2 + |y|^2 in sq in any f32 kernel of these entries, can exceed
# matvec_rtol(m) against float64, so the product with V is held against the
# float64 product of the kernel's own f32 entries (the gram kernel's: the
# same FMA chain, sq_from_chain and shape_fn). The three TF32 passes err by
# at most 3·2⁻²² of |K_ij||V_jc| a term, and the tensor cores' truncating
# f32 sums add an error that grows with m; the bar is 8·eps32 = 4·2⁻²², or
# matvec_rtol(m) where that is larger. The
# IterativeGP on FEW_N training points is held to a float64 posterior at
# the lazy tiers' bars.
FEW_M = (1, 2, 3, 5, 8, 16, 33, 100)
FEW_N, FEW_T = 5, 3


def matmat_product_rtol(m):
    return max(8.0 * EPS32, matvec_rtol(m))


# lazy-tier bars against float64: at n = 32768 the single tier's mean 1e-3
# and variance max 1e-2 (both above the f32 CG floor, ~sqrt(n)·eps32), the
# double tier's mean 1e-6 (the ROADMAP's 1e-7 printed beside); at n = 65536
# the exact relative residual of the fit's alpha, float64, 1e-4.
LAZY_MEAN_RTOL, LAZY_VAR_RTOL, LAZY_DOUBLE_MEAN_RTOL = 1e-3, 1e-2, 1e-6
LAZY_RESIDUAL_MAX = 1e-4
# at n = 65536 mean_std runs on all t = 1024 test points when four times
# its wall on the first 256 stays under this many seconds, else on 256
LAZY_BIG_MEAN_STD_S = 60.0
# At n = 65536 the defaults' rank-512 preconditioner leaves the segmented
# CG at maxiter = 500 with relative residual ~4e-4, above the 1e-4 bar
# (PERF.md §6). Phase 9 runs the defaults once and prints that, then
# serves with the one knob the fit's warning names, precond_rank, at 2048:
# the f32 floor in ~400 iterations, in less time than the defaults' 500.
LAZY_BIG_RANK = 2048

# The fast blocked Cholesky (phase 2d, phase 11): its block size, the
# trailing update's shapes -- ragged, and the first (largest) of the fast
# factor's seven at n = 16384 (benchmarks/exp_chol3.py's probe shape) --
# and the leaf sizes: the largest, a ragged one, and one full panel and a
# one-column one; the launches at the largest that must agree bit for bit
# (a race between the grid's blocks shows as a rare bit difference).
FAST_NB = 2048
SYRK_RAGGED, SYRK_PROBE = (1000, 300), (N - FAST_NB, FAST_NB)
LEAF_SIZES = (1024, 1000, 33)
LEAF_REPEATS = 20
# syrk_lower against its plain version (cuBLAS SGEMM) on the lower
# triangle, error over (|W||W|ᵀ)ᵢⱼ: each side's f32 sum of k products errs
# by at most k·2⁻²⁴ of it, the subtraction from T by one rounding more;
# twice the sum of the two is the bar.
def syrk_rtol(k):
    return 4.0 * k * 2.0 ** -24


# chol_leaf against a float64 factor of the same f32 block, over max|L64|:
# an f32 factorization of the SE Gram's leading block (torch's f32 LAPACK
# factor measures ~3e-6 on such blocks); against its plain version, which
# meets the same bar, twice it.
LEAF_F64_RTOL = 2e-5
LEAF_PLAIN_RTOL = 2 * LEAF_F64_RTOL
# the fast factor's backward error max|tril(LLᵀ − A)|/max|A| against the
# default (cuSOLVER) factor's on the same A
FAST_BACKWARD_RATIO = 4.0

# Phase 12, the df-entry stage probe (stpy_tpu_torch/probes/exp_r3_df_entry):
# gram_df_stages and gram_df[stage] against their plain versions, error of
# the pair value hi + lo over its magnitude. Both evaluate the same FP64
# formulas; they differ by the f32 rounding of lo (at most 2⁻⁴⁸ ≈ 3.6e-15
# relative) and the order of a few roundings, far under the df Gram's bar.
STAGE_RTOL = exp_r3_df_entry.DF_RTOL
STAGE_FAMILIES = (("se", 1.5), ("matern", 0.5), ("matern", 1.5),
                  ("matern", 2.5))
STAGE_KAPPA = 1.3

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
    "gram_matvec": ("stpy_tpu_torch/csrc/gram_matvec.cu",
                    "stpy_tpu/ops/pallas_gram_matvec.py:85"),
    "gram_matmat": ("stpy_tpu_torch/csrc/gram_matmat.cu",
                    "stpy_tpu/ops/pallas_gram_matvec.py:161"),
    "syrk_lower": ("stpy_tpu_torch/csrc/syrk_lower.cu",
                   "stpy_tpu/ops/pallas_syrk.py:46"),
    "chol_leaf": ("stpy_tpu_torch/csrc/chol_leaf.cu",
                  "stpy_tpu/ops/pallas_chol.py:74"),
    "gram_df_stages": ("stpy_tpu_torch/csrc/gram_df_stages.cu",
                       "benchmarks/exp_r3_batch_p.py:40"),
    "gram_df[stage]": ("stpy_tpu_torch/csrc/gram_df.cu",
                       "benchmarks/exp_r3_batch_t.py:79, "
                       "benchmarks/exp_r3_batch_t.py:127, "
                       "benchmarks/exp_r3_batch_u.py:109, "
                       "benchmarks/exp_r3_batch_x.py:48"),
}
# the device kernels phase 10 counts under a name, where not `<name>_kernel`:
# gram_matmat's call runs its two pre-passes too
PROFILE_KERNELS = {"gram_matmat": ("gram_matmat_kernel", "split_v_kernel",
                                   "pad_y_kernel"),
                   "geqrf": ("geqrf",), "orgqr": ("orgqr",)}
# H100 SXM data-sheet peaks, dense: HBM3 bytes/s, f32 outside the tensor
# cores, FP64 outside them, FP64 and TF32 on the tensor cores (flop/s)
HBM_BPS, F32_FLOPS, F64_FLOPS, F64_MMA_FLOPS = 3.35e12, 67e12, 34e12, 67e12
TF32_FLOPS = 495e12
# special-function unit (exp, sqrt): 16 results per clock per SM, 132 SMs at
# the 1.98 GHz boost clock of the SXM part
SFU_OPS = 16 * 132 * 1.98e9
# FP64 instructions per second outside the tensor cores: the data sheet's
# flop rate counts a DFMA as two
F64_INSTR = F64_FLOPS / 2
# the cuSOLVER / cuBLAS stages of the profiled paths (phase 10 split):
# stpy_tpu_torch/linalg.py, and the preconditioner's QR and eigh
LINALG_OPS = ("aten::linalg_cholesky_ex", "aten::cholesky_solve",
              "aten::linalg_solve_triangular", "aten::linalg_qr",
              "aten::linalg_eigh")
# the device-to-host scalar reads of the CG loops (one per iteration)
HOST_READ_OPS = ("aten::_local_scalar_dense",)
# the fast factor's stages around its kernels: the leaf inverses, the panel
# and split products, the copies into the factor
FAST_OPS = ("aten::linalg_solve_triangular", "aten::mm", "aten::addmm",
            "aten::copy_", "aten::tril_")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bench_data(dev, n=N, ntest=NTEST, noise=0.1):
    """The data of bench.py:32-38 (numpy seed 0), on `dev` in f32: x and
    xt ~ U(-1, 1)^d, y = sin(3 x_0) + noise·ε. benchmarks/exp_r4_65k_var.py
    draws the same with noise 0.05."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (n, D)).astype(np.float32)
    y = (np.sin(3 * x[:, :1]) + noise * rng.standard_normal((n, 1))).astype(
        np.float32)
    xt = rng.uniform(-1, 1, (ntest, D)).astype(np.float32)
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


def matvec_bound(n, m, d, family, r=None):
    """gram_matvec (r = None) or gram_matmat with r columns: x, y and the
    right side read once, the output written once; per (i, j) pair 2d f32
    operations for the squared distance, the shape (SE: 2 and one exp;
    Matérn-3/2: 4, one sqrt and one exp) and 2 per column of the product
    over F32_FLOPS, against the exps and sqrts over SFU_OPS; the larger of
    the two is the operations' time."""
    cols = 1 if r is None else r
    shape_ops, sfu = (2, 1) if family == "se" else (4, 2)
    t_bytes = 4 * ((n + m) * d + (n + m) * cols) / HBM_BPS * 1e3
    t_ops = n * m * max((2 * d + shape_ops + 2 * cols) / F32_FLOPS,
                        sfu / SFU_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matmat_tc_bound(n, m, d, family, r):
    """gram_matmat as csrc/gram_matmat.cu computes it: the product with V in
    three TF32 passes on the tensor cores, 3·2·n·m·r operations over
    TF32_FLOPS, against the Gram entries' 2d + shape f32 operations over
    F32_FLOPS, their exps and sqrts over SFU_OPS, and the bytes of
    `matvec_bound`; the largest of these."""
    shape_ops, sfu = (2, 1) if family == "se" else (4, 2)
    t_bytes = 4 * ((n + m) * d + (n + m) * r) / HBM_BPS * 1e3
    t_ops = max(6 * n * m * r / TF32_FLOPS, n * m * (2 * d + shape_ops) / F32_FLOPS,
                n * m * sfu / SFU_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qform_bound(c, n, t):
    """qform_df: Th, Tl, W0k, W0a, Bh, Bl read once, (qh, ql) written once;
    2cnt FP64 operations of the product, which the tensor cores could run."""
    return bound(4 * (2 * c * n + n * t + 3 * c * t) + 8 * t,
                 2 * c * n * t + 6 * c * t, F64_MMA_FLOPS)


def syrk_bound(m, k):
    """syrk_lower: the lower half of T read and written once, W read once;
    m(m+1)/2 entries times 2k f32 operations."""
    return bound(4 * m * (m + 1) + 4 * m * k, m * (m + 1) * k, F32_FLOPS)


def leaf_bound(n):
    """chol_leaf: the lower half of the leaf read once, the whole factor
    (its zero upper triangle too) written once; n³/3 f32 operations."""
    return bound(2 * n * (n + 1) + 4 * n * n, n ** 3 / 3, F32_FLOPS)


def sass_functions() -> dict:
    """kernel symbol -> its instructions, from `cuobjdump -sass` of the built
    library (cuobjdump beside nvcc, else on PATH)."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    assert tool, "cuobjdump not found beside nvcc or on PATH"
    out = subprocess.run([tool, "-sass", str(_build.library_path())],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and ins:
            funcs[name].append(ins.group(1))
    return funcs


def stage_ops(funcs, shape, stage):
    """(FP64 instructions, 64-bit MUFU instructions) per entry of
    gram_df_stages_kernel<shape, stage> as compiled: its loop body, one entry
    a pass, is every instruction up to the kernel's unpredicated EXIT. The
    out-of-line slow paths that sqrt and the division call (CALL.REL, past
    that EXIT) are not counted; exp's inline overflow branch is."""
    key = f"gram_df_stages_kernelILi{shape}ELi{stage}E"
    (body,) = [v for k, v in funcs.items() if key in k]
    fp64 = mufu = 0
    for ins in body:
        op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
        if op == "EXIT" and not ins.startswith("@"):
            break
        base = op.split(".")[0]
        fp64 += base in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
        mufu += base == "MUFU" and op.endswith("64H")
    return fp64, mufu


def stage_bound(entries, nbytes, fp64, mufu):
    """The bytes over HBM_BPS against the FP64 instructions over F64_INSTR
    and the MUFU ones over SFU_OPS, `fp64` and `mufu` per entry."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = entries * max(fp64 / F64_INSTR, mufu / SFU_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def matvec_error(kernel_fn, xs, ys, V, fam, nu):
    """(max |Δ|, max |Δ| / scale) of a matrix-free product against its plain
    version in float64 on the same f32 inputs, scale = K·|V| = Σ_j |K_ij||V_j|
    (K > 0); two launches must give the same bits. V is (m,) or (m, r)."""
    out = kernel_fn(xs, ys, V, 1.0, fam, nu)
    again = kernel_fn(xs, ys, V, 1.0, fam, nu)
    assert torch.equal(out, again), "two launches gave different bits"
    V64 = V.double().reshape(V.shape[0], -1)
    both = gram_matmat_plain(xs.double(), ys.double(),
                             torch.cat([V64, V64.abs()], dim=1), 1.0, fam, nu)
    ref, scale = both[:, :V64.shape[1]], both[:, V64.shape[1]:]
    diff = (out.double().reshape(ref.shape) - ref).abs()
    return float(diff.max()), float((diff / scale).max())


def matvec_checks(dev):
    """Phase 2c: gram_matvec and gram_matmat against their plain versions
    (error over Σ_j |K_ij||v_j|, bar `matvec_rtol`), bitwise repeatable, for
    each atom of the lazy tiers' kernel (SE γ = 0.5, Matérn-3/2 γ = 0.8): a
    ragged shape (r = 77 and 200), the bench shape n = m = 16384 and the
    65k lazy tier's shape, r = 128, on the fit's own operator K(x, x), and
    the ragged shape at d = 512 (WIDE, r = 77).
    Returns name -> max abs error; the SE timings at 16k and 65k (kernel,
    plain f32); cuBLAS SGEMM of the materialised 16k Gram by a 128-column
    block (not the same function)."""
    rng = np.random.default_rng(3)
    err = {"gram_matvec": 0.0, "gram_matmat": 0.0}
    times = {}
    sgemm_ms = None
    for label, (n, m, d) in (("ragged", RAGGED), ("16k", (N, N, D)),
                             ("65k", (LAZY_BIG_N, LAZY_BIG_N, D)),
                             ("wide", WIDE)):
        spread = math.sqrt(D / d) if label == "wide" else 1.0
        x = rng.uniform(-1, 1, (n, d)) * spread
        y = (rng.uniform(-1, 1, (m, d)) * spread
             if label in ("ragged", "wide") else x)
        v = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                            device=dev)
        rs = {"ragged": RAGGED_R, "wide": RAGGED_R[:1]}.get(label,
                                                             (MATMAT_R,))
        Vs = [torch.as_tensor(rng.standard_normal((m, r)), dtype=torch.float32,
                              device=dev) for r in rs]
        for fam, nu, gamma in LAZY_ATOMS:
            xs = torch.as_tensor(x / gamma, dtype=torch.float32, device=dev)
            ys = xs if y is x else torch.as_tensor(
                y / gamma, dtype=torch.float32, device=dev)
            e, rel = matvec_error(gram_matvec_scaled, xs, ys, v, fam, nu)
            print(f"  gram_matvec {label:6s} {fam:6s} {n}x{m} d={d}: max abs "
                  f"err {e!r}, max err / sum|K||v| {rel!r} (bar "
                  f"{matvec_rtol(m)!r}), repeatable")
            assert rel <= matvec_rtol(m), ("gram_matvec", label, fam, rel)
            err["gram_matvec"] = max(err["gram_matvec"], e)
            for V in Vs:
                e, rel = matvec_error(gram_matmat_scaled, xs, ys, V, fam, nu)
                print(f"  gram_matmat {label:6s} {fam:6s} {n}x{m} d={d} "
                      f"r={V.shape[1]}: max abs err {e!r}, max err / "
                      f"sum|K||V| {rel!r} (bar {matvec_rtol(m)!r}), "
                      "repeatable")
                assert rel <= matvec_rtol(m), ("gram_matmat", label, fam, rel)
                err["gram_matmat"] = max(err["gram_matmat"], e)
            if label in ("ragged", "wide") or fam != "se":
                continue
            V = Vs[0]
            times[label] = {
                "gram_matvec": timed_pair(
                    lambda: gram_matvec_scaled(xs, ys, v, 1.0, fam, nu),
                    lambda: gram_matvec_plain(xs, ys, v, 1.0, fam, nu),
                    reps=3),
                "gram_matmat": timed_pair(
                    lambda: gram_matmat_scaled(xs, ys, V, 1.0, fam, nu),
                    lambda: gram_matmat_plain(xs, ys, V, 1.0, fam, nu),
                    reps=3),
            }
            for name, r in (("gram_matvec", None), ("gram_matmat", MATMAT_R)):
                k_ms, p_ms = times[label][name]
                bnd = matvec_bound if r is None else matmat_tc_bound
                b_ms, b_by = bnd(n, m, d, fam, r)
                extra = "" if r is None else (
                    f"; all on the f32 pipes, as matvec_bound: "
                    f"{matvec_bound(n, m, d, fam, r)[0]!r} ms")
                print(f"  {name} {label} SE: kernel {k_ms!r} ms, plain "
                      f"{p_ms!r} ms, bound {b_ms!r} ms ({b_by}; Matérn-3/2: "
                      f"{bnd(n, m, d, 'matern', r)[0]!r} ms{extra})")
            if label == "16k":
                K = gram_scaled(xs, ys, 1.0, fam, nu)
                sgemm_ms = cuda_ms(lambda: K @ V, reps=3)
                print(f"  cuBLAS SGEMM of the materialised {n}x{m} Gram by "
                      f"({m}, {MATMAT_R}) (not the same function): "
                      f"{sgemm_ms!r} ms")
                del K
            torch.cuda.empty_cache()
    return err, times, sgemm_ms


def matmat_few_points_checks(dev):
    """Phase 2c at the fewest y points: gram_matmat at each m of FEW_M, for
    each lazy atom, r = 1 and 77, on the fit's operator K(x, x) (n = m) and
    on 130 other rows, bitwise repeatable, held against the float64 product
    of the gram kernel's f32 entries at `matmat_product_rtol(m)`; its error
    against float64 (bar `matvec_rtol(m)`, out of reach there for f32
    entries) printed beside. Then `IterativeGP(lazy=True)` on FEW_N points,
    its mean_std on FEW_T (gram_matmat at m = FEW_N) against a float64
    posterior. Returns the largest abs error against the product."""
    rng = np.random.default_rng(4)
    worst = 0.0
    for m in FEW_M:
        rel_p = rel_f = 0.0
        for fam, nu, gamma in LAZY_ATOMS:
            y = torch.as_tensor(rng.uniform(-1, 1, (m, D)) / gamma,
                                dtype=torch.float32, device=dev)
            others = torch.as_tensor(rng.uniform(-1, 1, (130, D)) / gamma,
                                     dtype=torch.float32, device=dev)
            for xs in (y, others):
                for r in (1, RAGGED_R[0]):
                    V = torch.as_tensor(rng.standard_normal((m, r)),
                                        dtype=torch.float32, device=dev)
                    _, rel = matvec_error(gram_matmat_scaled, xs, y, V, fam,
                                          nu)
                    out = gram_matmat_scaled(xs, y, V, 1.0, fam, nu).double()
                    K = gram_scaled(xs, y, 1.0, fam, nu).double()
                    diff = (out - K @ V.double()).abs()
                    worst = max(worst, float(diff.max()))
                    rel_p = max(rel_p, float(
                        (diff / (K @ V.double().abs())).max()))
                    rel_f = max(rel_f, rel)
        print(f"  gram_matmat m={m}: max err / sum|K||V| against the float64 "
              f"product of its own f32 entries {rel_p!r} (bar "
              f"{matmat_product_rtol(m)!r}); against float64 {rel_f!r} "
              f"(matvec_rtol {matvec_rtol(m)!r}); repeatable")
        assert rel_p <= matmat_product_rtol(m), ("gram_matmat", m, rel_p)
    x, y, xt = bench_data(dev, FEW_N, FEW_T)
    mu64, var64, _ = reference_f64(x, y, xt, s=LAZY_S, kern=lazy_kernel_matrix,
                                   prior_var=float(len(LAZY_ATOMS)))
    gp = IterativeGP(lazy_kernel(dev), s=LAZY_S, lazy=True)
    gp.fit_gp(x, y)
    (mu, sd), _, counts = counted(lambda: gp.mean_std(xt))
    few = posterior_errors(mu, sd, mu64, var64)
    print(f"  IterativeGP(lazy=True), n = {FEW_N}, t = {FEW_T}: mean rel err "
          f"{few[0]!r} (bar {LAZY_MEAN_RTOL}), var rel err max {few[1]!r} "
          f"(bar {LAZY_VAR_RTOL}); mean_std launches {counts}")
    assert few[0] <= LAZY_MEAN_RTOL and few[1] <= LAZY_VAR_RTOL, few
    assert counts["gram_matmat"] > 0, counts
    return worst


def se_system(x):
    """A = K(x, x) + s²I of the SE tiers (γ = 0.5), by the gram kernel."""
    xs = x / GAMMA
    A = gram_scaled(xs, xs, 1.0, "se")
    A.diagonal().add_(S * S)
    return A


def syrk_error(T, W):
    """syrk_lower on a copy of T against its plain version: (max |Δ|,
    max |Δ| / (|W||W|ᵀ)ᵢⱼ) over the lower triangle. Two launches must give
    the same bits, and T's strict upper triangle must come out untouched."""
    out = syrk_update_lower_(T.clone(), W)
    assert torch.equal(out, syrk_update_lower_(T.clone(), W)), \
        "two launches gave different bits"
    assert torch.equal(out.triu(1), T.triu(1)), "the upper triangle changed"
    diff = (out - syrk_update_lower_plain_(T.clone(), W)).abs_().tril_()
    del out
    rel = diff / (W.abs() @ W.abs().T)
    return float(diff.max()), float(rel.max())


def chol_checks(dev, x):
    """Phase 2d: syrk_lower and chol_leaf against their plain versions. The
    update on a ragged strided view (m = 1000, k = 300, random operands;
    strict upper untouched, the buffer around the view untouched) and at
    the fast factor's first step on the 16k SE system (m = 14336,
    k = 2048: T = A22, W = A21·L11⁻ᵀ); the leaf on the SE system's leading
    1024, 1000 and 33 block against its plain version and a float64
    factor (LEAF_REPEATS launches bitwise equal at 1024, two elsewhere),
    on −I (non-finite out), and in place on a strided view of a larger
    buffer (equal to the copy's factor, nothing outside the view written).
    Returns name -> max abs error, the timed pairs (and the leaf's grid per
    size), bounds and library times: syrk at the probe shape against
    torch.addmm (the full square), the leaf at 1024 against cholesky_ex
    and, printed beside, `_leaf_chol_` at 2048."""
    rng = np.random.default_rng(4)
    err, times, bounds, library = {}, {}, {}, {}
    m, k = SYRK_RAGGED
    buf = torch.as_tensor(rng.standard_normal((m + 24, m + k + 40)),
                          dtype=torch.float32, device=dev)
    before = buf.clone()
    T, W = buf[24:, k + 40:], buf[24:, 8:k + 8]     # strided, disjoint views
    e, rel = syrk_error(T, W)
    want = syrk_update_lower_(T.clone(), W)     # on a contiguous copy
    syrk_update_lower_(T, W)                    # in place on the view
    assert torch.equal(T, want), "the strided update differs from the copy's"
    outside = torch.ones_like(buf, dtype=torch.bool)
    outside[24:, k + 40:] = False
    assert torch.equal(buf[outside], before[outside]), "wrote outside its view"
    print(f"  syrk_lower ragged m={m} k={k} (strided views): max abs err "
          f"{e!r}, max err / (|W||W|ᵀ) {rel!r} (bar {syrk_rtol(k)!r}), "
          "repeatable, upper triangle and the buffer around untouched")
    assert rel <= syrk_rtol(k), ("syrk_lower", "ragged", rel)
    err["syrk_lower"] = e
    del buf, before, T, W, want, outside

    A = se_system(x)
    m, k = SYRK_PROBE
    L11 = torch.linalg.cholesky(A[:k, :k])
    eye = torch.eye(k, dtype=A.dtype, device=dev)
    W = A[k:, :k] @ torch.linalg.solve_triangular(L11, eye, upper=False).T
    T = A[k:, k:].contiguous()
    e, rel = syrk_error(T, W)
    print(f"  syrk_lower probe m={m} k={k} (the 16k fast factor's first "
          f"update): max abs err {e!r}, max err / (|W||W|ᵀ) {rel!r} (bar "
          f"{syrk_rtol(k)!r}), repeatable")
    assert rel <= syrk_rtol(k), ("syrk_lower", "probe", rel)
    err["syrk_lower"] = max(err["syrk_lower"], e)
    scratch = T.clone()     # timed updates run in place, values drifting
    times["syrk_lower"] = timed_pair(lambda: syrk_update_lower_(scratch, W),
                                     lambda: syrk_update_lower_plain_(scratch, W))
    library["syrk_lower"] = cuda_ms(lambda: scratch.addmm_(W, W.T, alpha=-1.0))
    bounds["syrk_lower"] = syrk_bound(m, k)
    del T, W, scratch, L11
    torch.cuda.empty_cache()

    err["chol_leaf"] = 0.0
    grids = {}
    for n in LEAF_SIZES:
        B = A[:n, :n].contiguous()
        L = chol_leaf(B)
        reps = LEAF_REPEATS if n == MAX_LEAF else 2
        assert all(torch.equal(L, chol_leaf(B)) for _ in range(reps - 1)), \
            f"{reps} launches gave different bits"
        grids[n] = chol_leaf_grid(n)
        assert bool((L.triu(1) == 0).all()), "the upper triangle is not 0"
        P = chol_leaf_plain(B)
        L64 = torch.linalg.cholesky(B.double())
        top = float(L64.abs().max())
        e = float((L - P).abs().max())
        e64 = float((L.double() - L64).abs().max()) / top
        p64 = float((P.double() - L64).abs().max()) / top
        print(f"  chol_leaf n={n} (the 16k SE system's leading block; "
              f"cooperative launch of {grids[n]} blocks): max abs err {e!r} "
              f"(plain f32), max err / max|L64| {e64!r} (float64, bar "
              f"{LEAF_F64_RTOL}), plain against float64 {p64!r}, bitwise "
              f"equal over {reps} launches, upper triangle 0")
        assert e64 <= LEAF_F64_RTOL and p64 <= LEAF_F64_RTOL, ("chol_leaf", n, e64, p64)
        assert e / top <= LEAF_PLAIN_RTOL, ("chol_leaf", n, e)
        err["chol_leaf"] = max(err["chol_leaf"], e)
    bad = chol_leaf(-torch.eye(LEAF_SIZES[0], device=dev))
    assert not bool(torch.isfinite(bad).all()), "chol_leaf(-I) came out finite"
    print("  chol_leaf(-I): non-finite, as the jitter ladder needs")
    # in place on a strided view inside a larger buffer, as the fast
    # factor's blocks are factored
    n = LEAF_SIZES[1]
    buf = torch.as_tensor(rng.standard_normal((n + 40, n + 300)),
                          dtype=torch.float32, device=dev)
    view = buf[16:16 + n, 200:200 + n]
    view.copy_(A[:n, :n])
    before = buf.clone()
    chol_leaf_(view)
    assert torch.equal(view, chol_leaf(A[:n, :n].contiguous())), \
        "the strided leaf differs from the copy's"
    outside = torch.ones_like(buf, dtype=torch.bool)
    outside[16:16 + n, 200:200 + n] = False
    assert torch.equal(buf[outside], before[outside]), "wrote outside its view"
    print(f"  chol_leaf n={n} in place on a strided view (row stride "
          f"{view.stride(0)}): equal to the contiguous copy's factor, the "
          "buffer around it untouched")
    times["chol_leaf_grid"] = grids
    del buf, view, before, outside
    n = LEAF_SIZES[0]
    B = A[:n, :n].contiguous()
    times["chol_leaf"] = timed_pair(lambda: chol_leaf(B),
                                    lambda: chol_leaf_plain(B))
    library["chol_leaf"] = cuda_ms(lambda: torch.linalg.cholesky_ex(B))
    bounds["chol_leaf"] = leaf_bound(n)
    B2 = A[:2 * n, :2 * n].contiguous()
    times["leaf_chol_2048"] = (cuda_ms(lambda: _leaf_chol_(B2.clone())),
                               cuda_ms(lambda: torch.linalg.cholesky_ex(B2)))
    del A, B, B2, L, P, L64, bad
    torch.cuda.empty_cache()
    return err, times, bounds, library


def backward_error(L, A, jitter):
    """max|tril(LLᵀ − (A + jitter·I))| / max|A|, in float64."""
    L64 = L.double()
    R = L64 @ L64.T
    del L64
    R -= A.double()
    R.diagonal().sub_(jitter)
    return float(R.tril_().abs_().max() / A.abs().max())


def fast_variant(kernel, x, y, xt, fast, refine, factor=None):
    """benchmarks/exp_fastchol.py's pipeline on the port: A = K + s²I by
    the gram kernel, `safe_cholesky(A, fast=fast)` (or, given, `factor(A)`
    with no jitter), α by cho_solve, with `refine` one α-refinement step on
    the residual y − A·α (torch.matmul, f32), the cross Gram, mean,
    trisolve and variance. Returns (mu (t, 1), var (t,), L, A, jitter)."""
    pd = kernel.params_dict
    A = kernel.eval_params(pd, x, x)
    A.diagonal().add_(S * S)
    if factor is None:
        res = linalg.safe_cholesky(A, fast=fast)
        assert bool(res.ok), "the factorization failed"
        L, jitter = res.L, float(res.jitter)
    else:
        L, jitter = factor(A), 0.0
        assert bool(torch.isfinite(L).all()), "the factorization failed"
    alpha = linalg.cho_solve_blocked(L, y)
    if refine:
        alpha += linalg.cho_solve_blocked(L, y - A @ alpha)
    Ks = kernel.eval_params(pd, xt, x)
    mu = Ks @ alpha
    V = linalg.tri_solve_blocked(L, Ks.T)
    del Ks
    var = kernel.diag(xt) - (V * V).sum(0)
    return mu, var, L, A, jitter


def factor_errors(kernel, x, y, xt, factor, mu64, var64):
    """`fast_variant` with `factor`: its posterior errors against (mu64,
    var64) and its backward error."""
    mu, var, L, A, _ = fast_variant(kernel, x, y, xt, True, False,
                                    factor=factor)
    vrel = ((var.double() - var64).abs() / var64).cpu()
    out = {"mean": mean_error(mu, mu64), "var_max": float(vrel.max()),
           "var_median": float(vrel.median()),
           "backward": backward_error(L, A, 0.0)}
    del mu, var, L, A
    torch.cuda.empty_cache()
    return out


def rebuilt_fast_factor(A, panels="inverse", leaves="kernel", nb=FAST_NB):
    """ops/syrk.chol_blocked_syrk's factor of A (n a multiple of nb, as at
    n = 16384) rebuilt from the port's pieces, for phase 11's diagnosis of
    its variance. panels="inverse" forms each panel as the port does,
    W = B·(L⁻¹)ᵀ with L⁻¹ from a triangular solve against I (ops/syrk.py,
    in `chol_blocked_syrk` and in `_leaf_chol_`'s split of a 2048 block);
    "solve" forms W by torch.linalg.solve_triangular on B itself.
    leaves="kernel" factors each 1024 leaf with chol_leaf_; "cholesky_ex"
    with torch.linalg.cholesky_ex."""
    def leaf(T):
        if leaves == "kernel":
            chol_leaf_(T)
        else:
            T.copy_(torch.linalg.cholesky_ex(T)[0])

    def panel(W, D):   # W ← W·D⁻ᵀ
        if panels == "solve":
            W.copy_(torch.linalg.solve_triangular(D.T, W, upper=True,
                                                  left=False))
        else:
            eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
            W.copy_(W @ torch.linalg.solve_triangular(D, eye, upper=False).T)

    def block(T):      # `_leaf_chol_`
        if T.shape[0] <= MAX_LEAF:
            return leaf(T)
        h = T.shape[0] // 2
        block(T[:h, :h])
        panel(T[h:, :h], T[:h, :h])
        T[h:, h:].addmm_(T[h:, :h], T[h:, :h].T, alpha=-1.0)
        block(T[h:, h:])
        T[:h, h:].zero_()

    L = A.tril()
    for s in range(0, L.shape[0], nb):
        D = L[s:s + nb, s:s + nb]
        block(D)
        if s + nb < L.shape[0]:
            W = L[s + nb:, s:s + nb]
            panel(W, D)
            syrk_update_lower_(L[s + nb:, s + nb:], W)
    return L.tril_()


def kernel_matrix(family, gamma, a, b):
    """k(a_i, b_j) in float64 by plain torch ops: SE, Matérn-3/2 (γ-scaled
    euclidean distances) or Laplace (L1 distance over γ²)."""
    if family == "laplace":
        return torch.exp(-torch.cdist(a, b, p=1) / gamma ** 2)
    a, b = a / gamma, b / gamma
    sq = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * a @ b.T).clamp_min_(0.0)
    if family == "se":
        return sq.mul_(-0.5).exp_()
    r = sq.sqrt_().mul_(math.sqrt(3.0))
    return torch.exp(-r).mul_(r.add_(1.0))


def lazy_kernel_matrix(a, b):
    """The lazy tiers' sum kernel in float64, one atom's Gram at a time."""
    K = None
    for fam, _, gamma in LAZY_ATOMS:
        Ka = kernel_matrix(fam, gamma, a, b)
        K = Ka if K is None else K.add_(Ka)
        del Ka
    return K


def reference_f64(x, y, xt, family="se", gamma=GAMMA, f32_floor=False,
                  s=S, kern=None, prior_var=1.0):
    """Exact posterior mean and variance in float64 by plain torch.linalg
    (no kernels of the port, no jitter) for the kernel `kern(a, b)`, by
    default `kernel_matrix` of `family` and `gamma`. With `f32_floor`, also
    the max relative error of the posterior mean that f32 Cholesky and
    solves by plain torch.linalg reach on the float64 Gram rounded to f32."""
    if kern is None:
        def kern(a, b):
            return kernel_matrix(family, gamma, a, b)
    x64, y64, xt64 = x.double(), y.double(), xt.double()
    K = kern(x64, x64)
    K.diagonal().add_(s * s)
    floor = None
    if f32_floor:
        L32 = torch.linalg.cholesky(K.float())
        a32 = torch.cholesky_solve(y, L32)
        del L32
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(y64, L)
    Ks = kern(xt64, x64)
    mu = Ks @ alpha
    if f32_floor:
        mu32 = (Ks.float() @ a32).double()
        floor = float((mu32 - mu).abs().max() / mu.abs().max())
    V = torch.linalg.solve_triangular(L, Ks.T, upper=False)
    del Ks, L
    var = prior_var - V.square_().sum(0)
    return mu[:, 0], var, floor


def mean_error(mu, mu64):
    assert mu.shape == (mu64.shape[0], 1), mu.shape
    assert bool(torch.isfinite(mu).all())
    return float((mu[:, 0].double() - mu64).abs().max() / mu64.abs().max())


def posterior_errors(mu, sd, mu64, var64):
    assert sd.shape == mu.shape and bool(torch.isfinite(sd).all()), sd.shape
    vrel = ((sd[:, 0].double() ** 2 - var64).abs() / var64).cpu()
    return mean_error(mu, mu64), float(vrel.max()), float(vrel.median())


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


def lazy_kernel(dev):
    """The lazy tiers' KernelFunction: SE(0.5) + Matérn-3/2(0.8), d = 8."""
    (_, _, g_se), (_, nu, g_m) = LAZY_ATOMS
    return (KernelFunction(kernel_name="squared_exponential", gamma=g_se,
                           d=D, device=dev)
            + KernelFunction(kernel_name="matern", gamma=g_m, nu=nu, d=D,
                             device=dev))


def counted(fn):
    """fn() with the launch counters zeroed just before and read just
    after: (result, host wall in s up to the closing synchronize, counts).
    The warnings fn raises (CG at its f32 floor) are printed, not lost."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    for w in caught:
        print(f"  warning: {w.message}")
    return out, wall, counts


def precond_basis_check(kernel, x, matmat, rank=512):
    """The rank-`rank` Rayleigh-Nyström basis of `rayleigh_nystrom_precond`
    on these points, its small eigh once in f32 and once in float64 (what
    `parallel.iterative._eigh64` does): per variant, the orthonormality
    error of U = Q·V and the least u_iᵀM⁻¹u_i over U's columns, which must
    stay > 0 for the apply to be SPD. Returns {variant: (error, least)}."""
    idx = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(0))
    C = kernel.eval_params(kernel.params_dict, x, x[idx[:rank].to(x.device)])
    Q, _ = torch.linalg.qr(C)
    Q, _ = torch.linalg.qr(Q)
    T = Q.T @ iterative._blocked_k_apply(matmat, LAZY_S, 128)(Q)
    T = 0.5 * (T + T.T)
    eye = torch.eye(rank, dtype=torch.float64, device=x.device)
    out = {}
    for label, (lam, V) in (("f32 eigh", torch.linalg.eigh(T)),
                            ("float64 eigh", iterative._eigh64(T))):
        U = Q @ V
        M = iterative._eigenform_apply(U, lam, LAZY_S)
        err = float((U.double().T @ U.double() - eye).abs().max())
        out[label] = (err, float(torch.sum(U * M(U), 0).min()))
    return out


def exact_residual(x, y, alpha):
    """‖y − (K + s²I)α‖/‖y‖ of the lazy tiers' system in float64, K·α by
    the plain matvec one row chunk at a time (never the kernels under test)."""
    a64, y64 = alpha.double().reshape(-1), y.double().reshape(-1)
    r = y64 - LAZY_S * LAZY_S * a64
    for fam, nu, gamma in LAZY_ATOMS:
        xs = x.double() / gamma
        r -= gram_matvec_plain(xs, xs, a64, 1.0, fam, nu)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(y64))


def profile_run(label, run, top=10, ops=LINALG_OPS):
    """Phase 10 (--profile): one warm call of `run` under torch.profiler.
    Prints the device busy time (union of all device activity), the device
    span, the idle share of that span, the host time until `run` returns
    (before the closing synchronize), the peak device memory of the call,
    the `top` kernels by device time, each hand kernel's time and launches,
    the device time of each stage in `ops` (by default the linalg ones,
    LINALG_OPS) and the count and host time of the CG loops' device-to-host
    scalar reads (HOST_READ_OPS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    for kname in (*REPLACES, "geqrf", "orgqr"):
        stems = PROFILE_KERNELS.get(kname, (f"{kname}_kernel",))
        hits = [tc for name, tc in per_name.items()
                if any(stem in name for stem in stems)]
        if hits:
            print(f"    kernel {kname}: {sum(t for t, _ in hits) / 1e3!r}"
                  f" ms over {sum(c for _, c in hits)} launches"
                  + (f" of {', '.join(stems)}" if len(stems) > 1 else ""))
    # device time of every kernel launched inside each linalg op of the path
    for avg in prof.key_averages():
        if avg.key in ops:
            print(f"    {avg.key}: {avg.device_time_total / 1e3!r} ms device "
                  f"over {avg.count} calls")
        if avg.key in HOST_READ_OPS:
            print(f"    {avg.key} (host reads): {avg.count} calls, "
                  f"{avg.cpu_time_total / 1e3!r} ms host")


def profile_tier(kernel, label, x, y, xt, **gp_kw):
    """One warm fit_predict of a fresh GP under `profile_run`. The refit
    releases the previous factors before it allocates (see
    GaussianProcess._set_data), so the peak is the call's own plus the data."""
    gp = GaussianProcess(kernel=kernel, s=S, **gp_kw)
    gp.fit_predict(x, y, xt)
    profile_run(label, lambda: gp.fit_predict(x, y, xt))


def fast_chol_phase(dev, kernel, mu64, var64):
    """Phase 11: benchmarks/exp_fastchol.py's three variants (`fast_variant`
    with the default factor, the fast factor, and the fast factor plus one
    α-refinement step) on bench.py's data, each held to the float64
    posterior (mu64, var64) at the single tier's bars, its factor's
    backward error printed (the fast one held to FAST_BACKWARD_RATIO times
    the default's), its launches counted on its first run (16 chol_leaf and
    7 syrk_lower for the fast factor at n = 16384, none for the default),
    its warm wall the median of 3. Then the diagnosis of the fast factor's
    variance on A without jitter: `rebuilt_fast_factor` as built (held
    bitwise to chol_dense(fast=True)), with its panels by triangular solves
    and with its leaves by cholesky_ex, each one's posterior errors and
    backward error printed (tools/fast_chol_variance.py sweeps the block
    size). Then the two factors alone on A by CUDA events, and the device
    memory each adds at its peak. Returns (per variant results, factor ms,
    peak GiB, the diagnosis)."""
    x, y, xt = bench_data(dev)
    try:
        linalg.chol_dense(torch.eye(8, dtype=torch.float64, device=dev),
                          fast=True)
        raise AssertionError("chol_dense(fast=True) took a float64 K")
    except TypeError as exc:
        print(f"  float64 K with fast=True raises: {exc}")
    fast = {}
    for label, fast_, refine in (("default", False, False),
                                 ("fast", True, False),
                                 ("fast+refine", True, True)):
        (mu, var, L, A, jitter), _, counts = counted(
            lambda: fast_variant(kernel, x, y, xt, fast_, refine))
        vrel = ((var.double() - var64).abs() / var64).cpu()
        errors = (mean_error(mu, mu64), float(vrel.max()),
                  float(vrel.median()))
        backward = backward_error(L, A, jitter)
        del mu, var, L, A
        torch.cuda.empty_cache()
        walls_ = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fast_variant(kernel, x, y, xt, fast_, refine)
            torch.cuda.synchronize()
            walls_.append(time.perf_counter() - t0)
        fast[label] = {"wall_s": float(np.median(walls_)), "mean": errors[0],
                       "var_max": errors[1], "var_median": errors[2],
                       "backward": backward, "launches": counts}
        print(f"  {label}: warm median of 3 {fast[label]['wall_s']!r} s; mean "
              f"rel err {errors[0]!r}, var rel err max {errors[1]!r} median "
              f"{errors[2]!r}; backward error max|tril(LLᵀ − A)|/max|A| "
              f"{backward!r}; launches {counts}")
        assert errors[0] <= SINGLE_MEAN_RTOL and errors[1] <= VAR_MAX_RTOL, \
            (label, errors)
        kernels = (counts["chol_leaf"], counts["syrk_lower"])
        if fast_:
            # 8 blocks of 2048, each two 1024 leaves; 7 trailing updates
            assert kernels == (2 * N // FAST_NB, N // FAST_NB - 1), counts
        else:
            assert kernels == (0, 0) and counts["gram"] > 0, counts
    assert fast["fast"]["backward"] <= (FAST_BACKWARD_RATIO
                                        * fast["default"]["backward"]), fast
    # What puts the fast factor's variance max above the default's at an
    # equal backward error: the fast factor rebuilt from the port's pieces
    # (bitwise chol_dense(fast=True)'s), then with one piece swapped, each
    # on A without the jitter safe_cholesky adds.
    def as_built(A_):
        L = rebuilt_fast_factor(A_)
        assert torch.equal(L, linalg.chol_dense(A_, fast=True)), \
            "the rebuilt fast factor differs from chol_dense(fast=True)"
        return L

    diagnosis = {}
    variants = (
        ("fast factor as built (bitwise chol_dense(fast=True))", as_built),
        ("fast factor, panels by solve_triangular",
         lambda A_: rebuilt_fast_factor(A_, panels="solve")),
        ("fast factor, cholesky_ex leaves",
         lambda A_: rebuilt_fast_factor(A_, leaves="cholesky_ex")))
    for label, factor in variants:
        diagnosis[label] = dg = factor_errors(kernel, x, y, xt, factor,
                                              mu64, var64)
        print(f"  diagnosis, no jitter, {label}: mean rel err "
              f"{dg['mean']!r}, var rel err max {dg['var_max']!r} median "
              f"{dg['var_median']!r}; backward error {dg['backward']!r}")
    A = se_system(x)
    factor_ms = {"fast": cuda_ms(lambda: linalg.chol_dense(A, fast=True), 3),
                 "cholesky_ex": cuda_ms(lambda: torch.linalg.cholesky_ex(A), 3)}
    peaks = {}
    for label, fn in (("fast", lambda: linalg.chol_dense(A, fast=True)),
                      ("cholesky_ex", lambda: torch.linalg.cholesky_ex(A))):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peaks[label] = (torch.cuda.max_memory_allocated() - held) / 2**30
        del out
    print(f"  the factor alone on A (CUDA events, mean of 3): fast "
          f"{factor_ms['fast']!r} ms, cholesky_ex {factor_ms['cholesky_ex']!r}"
          f" ms; device memory it adds at its peak beyond A "
          f"({A.numel() * 4 / 2**30!r} GiB): fast {peaks['fast']!r} GiB, "
          f"cholesky_ex {peaks['cholesky_ex']!r} GiB")
    return fast, factor_ms, peaks, diagnosis


def pair_error(got, want):
    """(max |Δ|, max |Δ| / |want|) of two (hi, lo) pairs' values."""
    g = got[0].double() + got[1].double()
    w = want[0].double() + want[1].double()
    diff = (g - w).abs()
    return float(diff.max()), float((diff / w.abs().clamp_min(1e-300)).max())


def df_stage_phase(dev):
    """Phase 12: the df-entry stage probe (exp_r3_df_entry.run at full size,
    every stage held to DF_RTOL against host float64 and 40-digit decimal),
    its launches counted; then gram_df_stages on P's grid (ν = ½, 3/2, 5/2)
    and gram_df[stage] on X's slice (SE and the three Matérns, κ = 1.3)
    against their plain versions at STAGE_RTOL, gram_df[stage]'s "entry"
    bitwise against the production gram_df; each timed at the probe's
    shape (ν = 5/2, stage "entry") beside its bound, whose FP64 operations
    are counted from the compiled SASS (`stage_ops`). Returns (probe
    results, launch counts, errors, times, bounds)."""
    reset_launch_counts()
    t0 = time.perf_counter()
    results = exp_r3_df_entry.run(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    failed = [k for k, r in results.items() if not r["ok"]]
    print(f"  probe: {len(results) - len(failed)} of {len(results)} stages "
          f"within {exp_r3_df_entry.DF_RTOL}, {wall!r} s, launches {counts}")
    assert not failed, failed
    assert all(counts[k] > 0 for k in
               ("gram_df_stages", "gram_df[stage]", "gram_df")), counts

    err = {"gram_df_stages": 0.0, "gram_df[stage]": 0.0}
    sqh, sql, _ = exp_r3_df_entry.p_grid()
    sqh, sql = (torch.as_tensor(a, device=dev) for a in (sqh, sql))
    worst = 0.0
    for nu in (0.5, 1.5, 2.5):
        for stage in ENTRY_STAGES:
            e, rel = pair_error(df_entry_stage(sqh, sql, nu=nu, stage=stage),
                                df_entry_stage_plain(sqh, sql, nu=nu,
                                                     stage=stage))
            assert rel <= STAGE_RTOL, ("gram_df_stages", nu, stage, rel)
            err["gram_df_stages"] = max(err["gram_df_stages"], e)
            worst = max(worst, rel)
    print(f"  gram_df_stages {tuple(sqh.shape)}, nu 0.5/1.5/2.5, stages "
          f"{ENTRY_STAGES}: max abs err {err['gram_df_stages']!r}, max rel "
          f"err {worst!r} (bar {STAGE_RTOL})")
    rows, cols = exp_r3_df_entry.x_slice()
    xs, ys = (scale_coords(torch.as_tensor(a, device=dev), exp_r3_df_entry.G)
              for a in (rows, cols))
    worst = 0.0
    for fam, nu in STAGE_FAMILIES:
        for stage in GRAM_STAGES:
            kw = {"family": fam, "nu": nu, "stage": stage}
            e, rel = pair_error(gram_df_stage(xs, ys, STAGE_KAPPA, **kw),
                                gram_df_stage_plain(xs, ys, STAGE_KAPPA, **kw))
            assert rel <= STAGE_RTOL, ("gram_df[stage]", fam, nu, stage, rel)
            err["gram_df[stage]"] = max(err["gram_df[stage]"], e)
            worst = max(worst, rel)
        ph, pl = gram_df_scaled(xs, ys, STAGE_KAPPA, fam, nu)
        sh, sl = gram_df_stage(xs, ys, STAGE_KAPPA, family=fam, nu=nu,
                               stage="entry")
        assert torch.equal(ph, sh) and torch.equal(pl, sl), \
            ("stage entry differs from the production gram_df", fam, nu)
    n, m, d = xs.shape[0], ys.shape[0], xs.shape[1]
    print(f"  gram_df[stage] {n}x{m} d={d}, SE and Matérn 0.5/1.5/2.5, "
          f"stages {GRAM_STAGES}: max abs err {err['gram_df[stage]']!r}, max "
          f"rel err {worst!r} (bar {STAGE_RTOL}); stage entry bitwise equal "
          "to the production gram_df")

    times = {
        "gram_df_stages": timed_pair(
            lambda: df_entry_stage(sqh, sql, nu=2.5, stage="entry"),
            lambda: df_entry_stage_plain(sqh, sql, nu=2.5, stage="entry"),
            reps=20),
        "gram_df[stage]": timed_pair(
            lambda: gram_df_stage(xs, ys, 1.0, family="matern", nu=2.5,
                                  stage="entry"),
            lambda: gram_df_stage_plain(xs, ys, 1.0, family="matern", nu=2.5,
                                        stage="entry"), reps=20),
    }
    funcs = sass_functions()
    for stage in ENTRY_STAGES:
        code = gram_df_stages.STAGE_CODES[stage]
        print(f"  SASS of gram_df_stages_kernel<3, {stage}> (Matérn-5/2): "
              "(FP64, 64-bit MUFU) instructions per entry "
              f"{stage_ops(funcs, 3, code)}")
    fp64, mufu = stage_ops(funcs, 3, gram_df_stages.STAGE_CODES["entry"])
    entries = sqh.numel()
    # gram_df[stage]: per pair the d-loop's DADD and DFMA per feature, the
    # entry as in the stage kernel less its input's DADD, and κ's DMUL
    bounds = {"gram_df_stages": stage_bound(entries, 16 * entries, fp64, mufu),
              "gram_df[stage]": stage_bound(n * m, 8 * (n + m) * d + 8 * n * m,
                                            2 * d + fp64, mufu)}
    for name, (k_ms, p_ms) in times.items():
        print(f"  {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms, bound "
              f"{bounds[name][0]!r} ms ({bounds[name][1]})")
    return results, counts, err, times, bounds


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--profile", action="store_true",
        help="also profile one warm fit_predict per dense tier, one warm "
             "65k lazy fit and one warm fast factor (phase 10)")
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
    errs_mv, mv_times, sgemm_ms = matvec_checks(dev)
    errs |= errs_mv
    errs["gram_matmat"] = max(errs["gram_matmat"],
                              matmat_few_points_checks(dev))
    # the record carries the lazy tier's shape (65k, SE), the main path's
    ktimes |= mv_times["65k"]
    bounds |= {"gram_matvec": matvec_bound(LAZY_BIG_N, LAZY_BIG_N, D, "se"),
               "gram_matmat": matmat_tc_bound(LAZY_BIG_N, LAZY_BIG_N, D, "se",
                                              MATMAT_R)}
    matmat_f32_bound = matvec_bound(LAZY_BIG_N, LAZY_BIG_N, D, "se", MATMAT_R)
    errs_chol, chol_times, chol_bounds, library = chol_checks(dev, x)
    errs |= errs_chol
    leaf2048 = chol_times.pop("leaf_chol_2048")
    leaf_grids = chol_times.pop("chol_leaf_grid")
    ktimes |= chol_times
    bounds |= chol_bounds

    print("== phase 3: single tier fit_predict, n = ntest = 16384, d = 8")
    mu64, var64, _ = reference_f64(x, y, xt)
    se_ref = (mu64, var64)           # phase 11 holds the fast factor to it
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
    shapes = {"gram_matvec": "the 65k lazy shape",
              "gram_matmat": "the 65k lazy shape",
              "syrk_lower": f"m = {SYRK_PROBE[0]}, k = {SYRK_PROBE[1]}",
              "chol_leaf": f"n = {LEAF_SIZES[0]}"}
    for name, (k_ms, p_ms) in ktimes.items():
        print(f"  {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms, bound "
              f"{bounds[name][0]!r} ms ({bounds[name][1]}) at "
              f"{shapes.get(name, 'the bench shape')}")
    print(f"  gram_matmat: its bound with the product on the f32 pipes "
          f"(matvec_bound) {matmat_f32_bound[0]!r} ms")
    print(f"  qform_df: cuBLAS f64 DGEMM of the same (c, n)·(n, t) product "
          f"(a library product, not the same function) {qtimes[2]!r} ms")
    print(f"  syrk_lower: torch.addmm(T, W, W.T, alpha=-1) {library['syrk_lower']!r}"
          " ms (not the same function: the full square, twice the work)")
    print(f"  chol_leaf: torch.linalg.cholesky_ex at n = {LEAF_SIZES[0]} "
          f"{library['chol_leaf']!r} ms; at n = {2 * LEAF_SIZES[0]}: "
          f"_leaf_chol_ (two leaves, the split's inverse and products) "
          f"{leaf2048[0]!r} ms, cholesky_ex {leaf2048[1]!r} ms")
    print(f"  peak device memory so far (float64 references included) "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB")
    del gp1, gp2, gp3, refined_gp, x, y, xt
    torch.cuda.empty_cache()

    print(f"== phase 8: IterativeGP(lazy=True), SE(0.5) + Matérn-3/2(0.8), "
          f"n = {LAZY_N}, d = {D}, s = {LAZY_S}, t = {LAZY_T}, against float64")
    xl, yl, xtl = bench_data(dev, LAZY_N, LAZY_T)
    t0 = time.perf_counter()
    mu64, var64, _ = reference_f64(xl, yl, xtl, s=LAZY_S,
                                   kern=lazy_kernel_matrix,
                                   prior_var=float(len(LAZY_ATOMS)))
    print(f"  dense float64 reference (Cholesky of the {LAZY_N}^2 Gram): "
          f"{time.perf_counter() - t0!r} s")
    torch.cuda.empty_cache()
    kl = lazy_kernel(dev)
    gpl = IterativeGP(kl, s=LAZY_S, lazy=True)
    gpl._matvec_factory(xl)
    basis = precond_basis_check(kl, xl, gpl._matmat)
    print("  preconditioner basis, rank 512: " + "; ".join(
        f"{k}: |UᵀU − I| {e!r}, least uᵀM⁻¹u {m!r}"
        for k, (e, m) in basis.items())
        + f" (the deflation cap's margin is 256·eps32 = {256 * EPS32!r})")
    assert basis["float64 eigh"][1] > 0, basis
    _, lazy_fit_s, lazy_fit_counts = counted(lambda: gpl.fit_gp(xl, yl))
    (mu, sd), lazy_ms_s, lazy_ms_counts = counted(lambda: gpl.mean_std(xtl))
    lazy = posterior_errors(mu, sd, mu64, var64)
    print(f"  single: mean rel err {lazy[0]!r} (bar {LAZY_MEAN_RTOL}), var rel "
          f"err max {lazy[1]!r} (bar {LAZY_VAR_RTOL}) median {lazy[2]!r}; "
          f"fit_status {gpl.fit_status}; fit {lazy_fit_s!r} s (cold), "
          f"mean_std {lazy_ms_s!r} s; launches fit {lazy_fit_counts}, "
          f"mean_std {lazy_ms_counts}")
    assert lazy[0] <= LAZY_MEAN_RTOL and lazy[1] <= LAZY_VAR_RTOL, lazy
    # the fit's CG runs gram_matvec, its rank-512 preconditioner gram_matmat
    assert lazy_fit_counts["gram_matvec"] > 0, lazy_fit_counts
    assert lazy_fit_counts["gram_matmat"] > 0, lazy_fit_counts
    assert lazy_ms_counts["gram_matmat"] > 0, lazy_ms_counts
    del mu, sd, gpl
    gpd = IterativeGP(kl, s=LAZY_S, lazy=True, precision="double",
                      var_refine=0)
    _, lazyd_fit_s, lazyd_fit_counts = counted(lambda: gpd.fit_gp(xl, yl))
    mu, lazyd_mean_s, lazyd_mean_counts = counted(lambda: gpd.mean(xtl))
    lazy_double = mean_error(mu, mu64)
    print(f"  double (var_refine=0): mean rel err {lazy_double!r} (bar "
          f"{LAZY_DOUBLE_MEAN_RTOL}, ROADMAP bar 1e-7); fit_status "
          f"{gpd.fit_status}; fit {lazyd_fit_s!r} s, mean {lazyd_mean_s!r} s; "
          f"launches fit {lazyd_fit_counts}, mean {lazyd_mean_counts}")
    assert lazy_double <= LAZY_DOUBLE_MEAN_RTOL, lazy_double
    assert all(lazyd_fit_counts[k] > 0 for k in
               ("gram_matvec", "gram_matmat", "gram_df", "gemv_df")), \
        lazyd_fit_counts
    del mu, gpd, mu64, var64, xl, yl, xtl
    torch.cuda.empty_cache()

    print(f"== phase 9: IterativeGP(lazy=True), n = {LAZY_BIG_N}, d = {D} "
          f"(benchmarks/exp_r4_65k_var.py)")
    xb, yb, xtb = bench_data(dev, LAZY_BIG_N, LAZY_T, noise=0.05)
    base_gib = torch.cuda.memory_allocated() / 2**30
    gps = IterativeGP(kl, s=LAZY_S, lazy=True)
    _, stock_s, stock_counts = counted(lambda: gps.fit_gp(xb, yb))
    stock_status = dict(gps.fit_status)
    stock_resid = exact_residual(xb, yb, gps.A)
    print(f"  constructor defaults (precond_rank 'auto' = 512): fit "
          f"{stock_s!r} s (cold); fit_status {stock_status}; exact relative "
          f"residual (float64) {stock_resid!r}; launches {stock_counts}")
    assert math.isfinite(stock_resid) and stock_counts["gram_matvec"] > 0
    # what the segmentation (a TPU workaround kept for parity) costs: the
    # same defaults with the single-program solver
    segment_above, iterative.SEGMENT_ABOVE = iterative.SEGMENT_ABOVE, LAZY_BIG_N
    try:
        _, unseg_s, _ = counted(lambda: gps.fit_gp(xb, yb))
    finally:
        iterative.SEGMENT_ABOVE = segment_above
    unseg_status = dict(gps.fit_status)
    unseg_resid = exact_residual(xb, yb, gps.A)
    print(f"  the same defaults, CG not segmented: fit {unseg_s!r} s; "
          f"fit_status {unseg_status}; exact relative residual (float64) "
          f"{unseg_resid!r}")
    del gps
    gpb = IterativeGP(kl, s=LAZY_S, lazy=True, precond_rank=LAZY_BIG_RANK)
    torch.cuda.reset_peak_memory_stats()
    _, big_cold_s, big_fit_counts = counted(lambda: gpb.fit_gp(xb, yb))
    status = dict(gpb.fit_status)
    _, big_warm_s, _ = counted(lambda: gpb.fit_gp(xb, yb))
    fit_peak = torch.cuda.max_memory_allocated() / 2**30
    resid = exact_residual(xb, yb, gpb.A)
    print(f"  precond_rank {LAZY_BIG_RANK}: fit cold {big_cold_s!r} s, warm "
          f"{big_warm_s!r} s; fit_status {status}; exact relative residual "
          f"(float64) {resid!r} (bar {LAZY_RESIDUAL_MAX}); launches "
          f"{big_fit_counts}; peak device memory of the fits {fit_peak!r} "
          f"GiB")
    assert resid <= LAZY_RESIDUAL_MAX, resid
    assert big_fit_counts["gram_matvec"] > 0, big_fit_counts
    assert big_fit_counts["gram_matmat"] > 0, big_fit_counts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (mu, sd), big_ms_s, big_ms_counts = counted(
        lambda: gpb.mean_std(xtb[:256]))
    t_used = 256
    if 4 * big_ms_s < LAZY_BIG_MEAN_STD_S:
        why = (f"4x the t = 256 wall ({big_ms_s!r} s) is under "
               f"{LAZY_BIG_MEAN_STD_S} s")
        (mu, sd), big_ms_s, big_ms_counts = counted(lambda: gpb.mean_std(xtb))
        t_used = LAZY_T
    else:
        why = (f"4x the t = 256 wall ({big_ms_s!r} s) is over "
               f"{LAZY_BIG_MEAN_STD_S} s")
    kss_max = math.sqrt(len(LAZY_ATOMS))
    assert mu.shape == sd.shape == (t_used, 1), (mu.shape, sd.shape)
    assert bool(torch.isfinite(mu).all() and torch.isfinite(sd).all())
    sd_min, sd_max = float(sd.min()), float(sd.max())
    assert 0.0 < sd_min and sd_max <= kss_max * (1 + 1e-6), (sd_min, sd_max)
    big_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  mean_std on t = {t_used} ({why}): {big_ms_s!r} s, sd in "
          f"[{sd_min!r}, {sd_max!r}] (0 < sd <= sqrt(k**) = {kss_max!r}), "
          f"launches {big_ms_counts}; peak device memory of mean_std "
          f"{big_peak!r} GiB ({base_gib!r} GiB held before the tier)")
    assert big_ms_counts["gram_matmat"] > 0, big_ms_counts
    del mu, sd
    launches |= {"gram_matvec": ("lazy_65k", big_fit_counts["gram_matvec"]),
                 "gram_matmat": ("lazy_65k", big_fit_counts["gram_matmat"]
                                 + big_ms_counts["gram_matmat"])}
    walls |= {"lazy_32k_fit": lazy_fit_s, "lazy_32k_mean_std": lazy_ms_s,
              "lazy_32k_double_fit": lazyd_fit_s,
              "lazy_65k_defaults_fit": stock_s,
              "lazy_65k_fit_cold": big_cold_s, "lazy_65k_fit_warm": big_warm_s,
              f"lazy_65k_mean_std_t{t_used}": big_ms_s}

    if profile:
        print("== phase 10: under torch.profiler, one warm fit_predict per "
              "dense tier, one warm 65k lazy fit and one warm fast factor")
        x, y, xt = bench_data(dev)
        profile_tier(se, "single", x, y, xt)
        profile_tier(se, "double", x, y, xt, precision="double")
        profile_tier(se, "var_refine", x, y, xt, precision="double",
                     var_refine=1)
        profile_run("lazy_65k fit", lambda: gpb.fit_gp(xb, yb))
        A = se_system(x)
        linalg.chol_dense(A, fast=True)
        profile_run("fast factor (chol_dense(fast=True), n = 16384)",
                    lambda: linalg.chol_dense(A, fast=True), ops=FAST_OPS)
        del x, y, xt, A
    del gpb, xb, yb, xtb
    torch.cuda.empty_cache()

    print(f"== phase 11: the fast factor (chol_dense(fast=True)) in "
          f"benchmarks/exp_fastchol.py's three variants, n = ntest = {N}, "
          f"d = {D}, SE gamma = {GAMMA}, s = {S}, against float64")
    fast, factor_ms, peaks, diagnosis = fast_chol_phase(dev, se, *se_ref)
    launches |= {"syrk_lower": ("fast_chol",
                                fast["fast"]["launches"]["syrk_lower"]),
                 "chol_leaf": ("fast_chol",
                               fast["fast"]["launches"]["chol_leaf"])}
    walls |= {f"fast_chol_{k}": v["wall_s"] for k, v in fast.items()}

    print(f"== phase 12: the df-entry stage probe "
          f"(stpy_tpu_torch/probes/exp_r3_df_entry.py: benchmarks/"
          f"exp_r3_batch_p/t/u/x.py), Matérn-5/2, gamma = "
          f"{exp_r3_df_entry.G}, d = {D}, against float64 and decimal")
    probe, probe_counts, errs_stage, stage_times, stage_bounds = \
        df_stage_phase(dev)
    errs |= errs_stage
    ktimes |= stage_times
    bounds |= stage_bounds
    launches |= {name: ("df_entry_probe", probe_counts[name])
                 for name in stage_times}

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": REPLACES[name][0],
         "replaces": REPLACES[name][1], "tier": launches[name][0],
         "launches": launches[name][1], "max_abs_err": errs[name],
         "ms": ktimes[name][0], "plain_ms": ktimes[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name)}
        for name in REPLACES
    ], "qform_df_dgemm_ms": qtimes[2], "gram_matmat_sgemm_16k_ms": sgemm_ms,
        "gram_matmat_f32_pipe_bound_ms": matmat_f32_bound[0],
        "chol_leaf_grid": leaf_grids,
        "leaf_chol_2048_ms": leaf2048[0],
        "cholesky_ex_2048_ms": leaf2048[1],
        "walls_s": walls,
        "posterior": {"single": single, "double": double,
                      **{f"var_refine_{k}": v for k, v in refined.items()},
                      "laplace": laplace, "lazy_32k": lazy,
                      "lazy_32k_double_mean": lazy_double,
                      "lazy_65k_residual": resid,
                      "lazy_65k_defaults_residual": stock_resid,
                      "lazy_65k_defaults_unsegmented_residual": unseg_resid},
        "lazy_65k_fit_status": status,
        "lazy_65k_defaults_fit_status": stock_status,
        "lazy_65k_defaults_unsegmented_fit_status": unseg_status,
        "lazy_32k_precond_basis": basis,
        "fast_chol": {**fast, "factor_ms": factor_ms,
                      "factor_peak_gib": peaks, "diagnosis": diagnosis},
        "df_entry_probe": probe}
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
