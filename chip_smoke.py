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
(benchmarks/exp_r4_65k_var.py) on constructor defaults, with the public
segmented solvers beside the unsegmented ones on the same systems, then
with a rank-2048 preconditioner held to its float64 residual; then (phase 11) the
fast blocked Cholesky (linalg.chol_dense(fast=True) on the chol_leaf and
syrk_lower kernels) in benchmarks/exp_fastchol.py's three variants at
n = 16384 against the same float64 posterior, and the factor rebuilt
from its pieces, held bit for bit to it; last
(phase 12) the df-entry stage probe (stpy_tpu_torch/probes/
exp_r3_df_entry.py, the port of
benchmarks/exp_r3_batch_{p,t,u,x}.py) at full size, every stage of the
df Matérn entry held to 1e-13 of host float64 and 40-digit decimal, on the
gram_df_stages kernel and gram_df.cu's stage launch, and both kernels held
to their plain versions and timed at bench.py's 16384² beside their bounds
and their launch floor (the probe's toy shapes); then (phase 13) the
matrix-free hyperparameter fit (parallel/bbmm.py, parallel/slq.py): the
evidence gradient at n = 32768 on phase 8's data and kernel, and on an ARD
SE kernel, against the dense float64 gradient within the Hutchinson
estimator's own spread, benchmarks/exp_lazy_hyperfit.py's full 65k fit,
and IterativeGP.optimize_params on phase 9's GP, refitted to its float64
residual; then (phase 14) the exact GP's evidence hyperfit through the
Gram kernels' autograd Functions: benchmarks/run_all.py config 1 (SE, and
again with the Laplace kernel) against the port's own float64 fit on the
CPU, an ARD SE bandwidth+noise fit at n = 4096 on the L-BFGS route, and
sample / log_probability / log_marginal on config 1's fitted GP, with
the hand Grams and their Functions' first and second derivatives held to
float64 where phase 14 launches them; then (phase 15) the rest of the GP
models: bbmm's general tier (the evidence gradient of a product and of a
Laplace kernel at n = 32768 against dense float64, with its peak memory,
and IterativeGP.optimize_params on the product), the df-refined
matrix-free variance at n = 32768 against float64, the robust losses
(fit, serve, MAP evidence) against the float64 model, ucb_optimize, the
gradient helpers, sample_and_max / sample_iteratively_max, volume_mean and
OnlineGP, each sub-phase holding the hand kernels it launched (and the
Gram Functions' derivatives) against their plain versions at its shapes;
then (phase 16) the feature-GP and Nyström slice: benchmarks/run_all.py
config 2 (the exact GP, then HermiteEmbedding + KernelizedFeatures: fit,
mean_std, 64 draws) and config 3 (NystromFeatures at n = 50000 on the
additive Matérn + SE kernel) against the port's float64 models on the same
embedding and landmarks, and IterativeGP.sample_pathwise on a lazy GP at
n = 32768 against its float64 residual and a dense float64 posterior, with
gram, gram_matmat and gram_matvec held at their shapes there; then (phase
17) the Poisson point-process slice: benchmarks/run_all.py config 4
(PoissonRateEstimator on a triangle basis over 16 leaf sets, data drawn by
the port's PoissonPointProcess; fit_gp and ucb_lcb_actions) and the same
model at 1024 leaf sets and 1024 basis functions, against the port's
float64 models on the same rounds and rate, and config 5 (the exact GP's
64-restart bandwidth fit) against the port's float64 fit, with gram held
at each shape it launched there; then (phase 18) the kernel tail and the
general double tier: the Laplace kernel in the double tier on gram_df's
L1 family (held to its plain version in phase 2e) at var_refine 0 and 1,
general-ν Matérn (ν = 1.2) in both tiers with the Bessel Gram's build time
and peak memory, SE + linear in the double tier, all at n = ntest = 16384
against the port's float64 models; the additive-group search at n = 4096
and the full-covariance manifold fits at n = 1024 against the float64
model; and the log-linear, link, MBR and Bernoulli estimators on config
4's setup against the truth and their float64 models; then (phase 19)
approximate inference, MKL and the rest of the point-process stack, each
f32 model against the same port model in float64 on the card:
MultipleKernelLearner (SE + Matérn-3/2 + Laplace, n = 4096, d = 4, y a
draw of the Laplace atom) with gram and gram_l1 held to their plain
versions at its shapes, the group-lasso MKL and PrimalMKL on three RFF
embeddings, the SGCP on a known 2-D sigmoidal Cox rate (its integrated
rate against the truth, its exact and linear-response bands), tmg's
truncated-normal means, EP against the conjugate posterior, the
Dirichlet and categorical mixtures, GammaContProcess at n = 16384,
TraceFeatures, ConvexRKHS and each likelihood's objective and confidence
set; then (phase 20) the library's tail: linalg's remaining functions at
bench.py's workload (chol_recursive against cholesky_ex by backward error,
tri_solve_chunked on the 16384 x 16384 cross block against one
solve_triangular with both peaks, tri_solve_blocked_t, diag_block_invs,
solve_psd, and at n = 4096 chol_rank1_update and schur_complement_extend
against float64), Bayesian optimisation over the test functions
(GPConfig -> CamelbackBenchmark -> GaussianProcess -> UCB, 40 rounds over
10000 candidates, and StybTangBenchmark.optimize) against float64 refits,
and FelSimulator, ProteinBenchmark, the greedy coreset, FeatureRanker,
SRI, the CVAE, save_model / load_model, the OptimalPositiveBasis round
trip and euler_maruyama, with gram and gram_df held at their shapes there;
then (phase 21) the multi-device tier on a one-rank NCCL mesh that
make_mesh starts (sharded_gram bit for bit gram, distributed_evidence
against the exact evidence at config 1, a 64-restart restart_farm,
DistributedExactGP's three factorizations against float64 with per-rank
peaks, IterativeGP's mesh tiers at n = 32768 (lazy bit for bit the
one-device tier without a preconditioner, chunked product and Laplace,
dense block-Jacobi, double), fit_feature_gp_sharded on config 3) and the
exact GP's memory layouts at n = 32768 (fit and predict peaks of the
jitter ladder, fixed jitter, "recompute" and fold_noise), each kernel it
launches held to its plain version at one rank's shapes and at a 4-rank
run's (n/4, n) row block.
Phase 2c
holds both matrix-free kernels in their derivative
shapes ("dk_sq", "dk") too, and gram_matvec's backward against float64
autograd; phase 2d holds syrk_lower against its plain f32 version and
against the model of its TF32 arithmetic (ops.syrk.split_tf32). The launch counters, zeroed just before each tier's run and read
just after, show that each tier went through its kernels (the derivative
shapes counted apart); every tier and every kernel is timed. With
--profile it also traces one warm fit_predict of the single, double and
var_refine tiers, one warm 65k lazy fit, one warm fast factor (phase 10)
and one warm 65k evidence step (phase 13) with torch.profiler: device busy
time and idle share, host time, peak memory, and the kernels and kernel
shapes that take the time. Every phase asserts; any failure exits
non-zero.

The last line of standard output is one JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}; the
line before it is the card's name and power limit as nvidia-smi reports
them, and the line before that the per-kernel JSON record. Without CUDA the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from stpy_tpu_torch import GaussianProcess, KernelFunction, _build, linalg
from stpy_tpu_torch import probability
from stpy_tpu_torch.approx_inference import (
    ExpectedPropagationQuadratic, SGCPVariational,
)
from stpy_tpu_torch.inference import tmg_sample
from stpy_tpu_torch.ops import (
    gram_df_stages, launch_counts, reset_launch_counts,
)
from stpy_tpu_torch.ops.chol_leaf import (
    MAX_LEAF, chol_leaf, chol_leaf_, chol_leaf_grid, chol_leaf_plain,
)
from stpy_tpu_torch.ops.gemv_df import gemv_df, gemv_df_plain
from stpy_tpu_torch.kernels.df_plan import df_atom_desc, df_gram_from_desc
from torch.utils._python_dispatch import TorchDispatchMode

from stpy_tpu_torch.domains import BorelSet, HierarchicalBorelSets
from stpy_tpu_torch.embeddings import (
    HermiteEmbedding, NystromFeatures, RFFEmbedding, TriangleEmbedding,
)
from stpy_tpu_torch.embeddings.nystrom import EIG_CUT
from stpy_tpu_torch.models import (
    MKL, CategoricalMixture, ConvexRKHS, DirichletMixture, GammaContProcess,
    KernelizedFeatures, MultipleKernelLearner, OnlineGP, PrimalMKL,
    TraceFeatures, exact_gp,
)
from stpy_tpu_torch.ops.gram import (
    gram, gram_plain, gram_scaled, gram_se, shape_and_slope,
)
from stpy_tpu_torch.ops.gram_df import (
    gram_df_plain, gram_df_scaled, scale_coords,
)
from stpy_tpu_torch.ops.gram_df_stages import (
    ENTRY_STAGES, GRAM_STAGES, df_entry_stage, df_entry_stage_plain,
    gram_df_stage, gram_df_stage_plain,
)
from stpy_tpu_torch.ops.gram_l1 import gram_l1, gram_l1_plain
from stpy_tpu_torch.ops.gram import SHAPES
from stpy_tpu_torch.ops.gram_matvec import (
    gram_matmat_plain, gram_matmat_scaled, gram_matvec, gram_matvec_plain,
    gram_matvec_scaled, shape_gram_plain,
)
from stpy_tpu_torch.ops.qform_df import qform_df_plain, qform_refined_strip
from stpy_tpu_torch.opt.lbfgs import LBFGSResult
from stpy_tpu_torch.ops.syrk import (
    _leaf_chol_, split_tf32, syrk_update_lower_, syrk_update_lower_plain_,
)
from stpy_tpu_torch.parallel import (
    DistributedExactGP, HostShardedLoader, IterativeGP, distributed_evidence,
    evidence_value_and_grad_lazy, evidence_value_and_grad_sum,
    fit_evidence_lazy, fit_feature_gp_sharded, make_mesh, restart_farm,
    sharded_gram,
)
from stpy_tpu_torch.parallel import bbmm, iterative
from stpy_tpu_torch.parallel.lazy_kernel import (
    atom_params, fast_atoms, make_sum_matmat,
)
from stpy_tpu_torch.parallel.slq import slq_logdet
from stpy_tpu_torch.point_processes import (
    BernoulliPointProcess, BernoulliRateEstimator,
    ExpGaussProcessRateEstimator, LinkBernoulliRateEstimator,
    LogGaussProcessRateEstimator, LogisticGaussProcessRateEstimator,
    LogLinearRateEstimator, MBRPositiveEstimator,
    PermanentalProcessRateEstimator, PoissonPointProcess,
    PoissonRateEstimator,
)
from stpy_tpu_torch.point_processes import (
    poisson_rate_estimator as pre_module,
)
from stpy_tpu_torch.probes import exp_r3_df_entry
from stpy_tpu_torch.utils.groups import generate_groups
from stpy_tpu_torch.configs import GPConfig, KernelConfig
from stpy_tpu_torch.dimred import SRI
from stpy_tpu_torch.embeddings.nystrom import OptimalPositiveBasis
from stpy_tpu_torch.feature_importance import FeatureRanker
from stpy_tpu_torch.generative_models import CVAE
from stpy_tpu_torch.sampling import euler_maruyama
from stpy_tpu_torch.test_functions import (
    CamelbackBenchmark, FelSimulator, ProteinBenchmark, StybTangBenchmark,
)
from stpy_tpu_torch.utils.checkpoint import load_model, save_model
from stpy_tpu_torch.utils.coresets import coreset_leverage_score_greedy

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
# a row strip of the bench system, qform_refined_strip's form (c < n): first
# row and rows c, both off the 128-row tile
QFORM_STRIP = (5000, 3001)
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
# gram_matvec on the fit's operator K(x, x) at n = m points too few for one
# block per SM, where the kernel splits the points into ranges (and at 1, a
# single range): held at matvec_rtol(m), bitwise over two launches
MATVEC_FEW = (1, 5, 100, 1000)
# K(x, x)·e_i at row i is exactly kappa (sq is exactly 0 on the diagonal);
# kappa not a power of two, so a lost bit shows
DIAG_KAPPA = 1.3


def matmat_product_rtol(m):
    return max(8.0 * EPS32, matvec_rtol(m))


# Phase 2c, the derivative shapes "dk_sq" = k'(sq)·sq and "dk" = k'(sq) of
# both matrix-free products, for every fused family (family, nu, gamma):
# against the plain version in float64 on the same f32 inputs, per row
# within matvec_rtol(m) of Σⱼ|Kᵢⱼ||Vⱼc| plus the first-order effect of sq's
# f32 rounding, (d + 4)·eps32·(|x̃ᵢ|² + |ỹⱼ|²) a pair (the FMA chains of the
# norms and the dot, the subtraction, and x/γ's rounding), through
# |∂s/∂sq|: unlike k's, the derivative shapes' slopes grow without bound as
# sq → 0 (Matérn-½ and 3/2 "dk" as 1/r³ and 1/r), so near-coincident
# points amplify sq's rounding in any f32 kernel of these entries. A point
# against itself has sq exactly 0 (checked bit for bit on the diagonal) and
# is left out of that term.
DERIV_FAMILIES = (("se", 1.5, 0.5), ("matern", 0.5, 0.8), ("matern", 1.5, 0.8),
                  ("matern", 2.5, 0.8))
DERIV_SHAPES = SHAPES[1:]
# the ARD trace term's block: 64 probes times 2d + 1 at d = 4
ARD_TRACE_D, ARD_TRACE_R = 4, 64 * (2 * 4 + 1)
# gram_matvec's backward (phase 2c): n = m points, d = 8; the gradients of
# wᵀK(x, y)v against torch.autograd of the plain version in float64 on the
# same f32 inputs, each within twice matvec_rtol(m) of the sum of the
# absolute terms of its formula (`backward_scales`): each gradient combines
# the errors of two products, and x/γ's f32 rounding, which the float64
# reference does not make, adds to sq's
BACKWARD_N = 2048

# Phase 13, the matrix-free hyperparameter fit. 13.1 / 13.4: the evidence
# gradient at n = LAZY_N on phase 8's data and kernel (and an ARD SE kernel
# at d = 8), the probe and alpha CG at 1e-6, against the dense float64
# gradient −½αᵀ∂Aα + ½ tr(A⁻¹∂A): each quadratic part within
# QUAD_RTOL, each full gradient within HUTCH_SIGMAS of the Hutchinson
# estimator's own standard deviation (exact, from the dense A⁻¹∂A) plus
# GRAD_RTOL·|g|, (13.1) the SLQ NLL within NLL_RTOL at EVIDENCE_LANCZOS
# steps (tests/test_parallel.py:270-278's bar and steps), and (both) the
# SLQ log-determinant at EVIDENCE_LANCZOS steps within LOGDET_RTOL of the
# float64 one. 13.4's NLL is printed, not held: there ½yᵀα, ½ log det A and
# (n/2) log 2π nearly cancel (NLL ≈ −6.5e3 against log det A ≈ −7.9e4), so
# a 2 % bar on the NLL would ask 0.2 % of the log-determinant; its
# log-determinant, which does not cancel, is held instead. The SLQ error is
# mostly the Lanczos truncation's bias (the Gauss nodes miss the eigenvalue
# cluster at s²): 0.80 % (13.1) and 1.79 % (13.4) measured at 60 steps on an
# H100 (PERF.md, PR 9), about 8 % at the default 30 steps (printed beside,
# not held); the probes' standard error is printed beside.
EVIDENCE_PROBES, EVIDENCE_LANCZOS = 64, 60
QUAD_RTOL, HUTCH_SIGMAS, GRAD_RTOL, NLL_RTOL = 1e-3, 5.0, 1e-3, 0.02
LOGDET_RTOL = 0.03
ARD_GAMMA = tuple(float(g) for g in np.linspace(0.4, 1.2, D))
# 13.2: benchmarks/exp_lazy_hyperfit.py's workload as written (n = 65536,
# d = 4, SE, numpy seed 0, y = sin(3x₀) + cos(2x₁) + 0.1ε), with the rank-512
# preconditioner of benchmarks/RESULTS.md:380; σ̂ must land in HYPERFIT_S
# (the data's σ is 0.1). The TPU's fit is printed beside, not asserted.
HYPERFIT = dict(gamma0=1.0, noise0=0.3, steps=25, lr=0.15, probes=64,
                cg_tol=1e-5, cg_maxiter=300, probe_tol=1e-2, probe_maxiter=60,
                tol=1e-2, precond_rank=512)
HYPERFIT_D, HYPERFIT_S = 4, (0.08, 0.15)
TPU_HYPERFIT = "gamma 0.999, sigma 0.120 (benchmarks/RESULTS.md:380)"
# 13.3: IterativeGP.optimize_params on phase 9's fitted GP, a few steps
OPTIMIZE_STEPS = 3
# Phase 14: the exact GP's evidence hyperfit. 14.1 is benchmarks/run_all.py
# config 1 (:67-93) as written: n = 1024, x ~ U(-1, 1), y = sin 4x + 0.05ε
# (numpy seed 0), GaussianProcess(gamma=1.0, s=0.05, d=1), 8 restarts of
# 40 iterations: a warm-up, then CONFIG1_REPS fits, each on a fresh GP from
# γ = 1 (cold, as a user fits); 14.2 the same with the Laplace kernel.
# Their reference is the port's own optimizer in float64 on the CPU (plain
# Gram) on the same data: γ within FIT_GAMMA_RTOL (the bar of
# tests/test_exact_gp.py:475-500), and the float64 evidence at the card's γ
# within FIT_EVIDENCE_RTOL of its value at the reference's.
CONFIG1_N, CONFIG1_GP = 1024, dict(gamma=1.0, s=0.05, d=1)
CONFIG1_FIT = dict(type="bandwidth", restarts=8, maxiter=40)
CONFIG1_REPS = 5
FIT_GAMMA_RTOL, FIT_EVIDENCE_RTOL = 1e-3, 1e-6
# The card's evidence (the f32 hand Gram, factored in float64) and its
# gradient in log γ at the fitted γ, against the float64 model's on the
# CPU: a first-order bound on the f32 Gram's rounding, each entry off by
# EVIDENCE_ULPS·2⁻²⁴·|K|(1 + P), P = (|x̃ᵢ| + |x̃ⱼ|)² (the shape's rounding,
# and sq's: a few ulps of |x̃ᵢ|² + |x̃ⱼ|², moved into K by |k'(sq)| ≤ ½k),
# through |∂f/∂K| ≤ ½(|A⁻¹| + |α||α|ᵀ); the gradient's term has
# |K| + |∂K/∂log γ| in place of |K|. It leaves out the change of A⁻¹ with
# the entries (a second-order term), and is loose by the rounding's
# random signs; phase 14 prints the ratio.
EVIDENCE_ULPS = 4
# The hand Grams where the fit launches them, against their plain versions
# in f32 and float64 (phase 2's GRAM_F32_ATOL / GRAM_ATOL, GRAM_L1_ATOL):
# config 1's x (1024², d = 1) at 14.1's and 14.2's fitted γ, and 14.3's
# 4096², d = 8 at its fitted ARD γ. Then the Functions' backward and double
# backward there (`ops.gram._Gram`, `ops.gram_l1._GramL1`): L = Σ W∘K with
# W ~ U(0, 1), its gradient in t = log γ (scalar or per dimension) and κ,
# and its second derivative in t along v ~ N(0, 1), on f32 tensors on the
# card, against autograd of the plain version in float64 on the same
# inputs; each within 2·matvec_rtol(n) of the sum of its terms' absolute
# values (`gram_fn_scales`), as phase 2c holds gram_matvec's backward.
# 14.3: ARD SE bandwidth+noise (9 parameters: L-BFGS, batched line search)
# on the first ARD_FIT_N rows of the bench data, from γ = 1, s = 0.3; the
# float64 evidence at the fit under its start value, and its float64
# gradient in the raw (log) parameters at most ARD_GRAD_CUT of the start's.
ARD_FIT_N, ARD_FIT_S0 = 4096, 0.3
ARD_FIT = dict(type="bandwidth+noise", restarts=1, maxiter=40)
ARD_GRAD_CUT = 1e-2
# 14.4: sample, log_probability and log_marginal on 14.1's fitted GP at
# SAMPLE_T points of [-1, 1], with sample's default jitter. sample factors
# the float64 covariance of `GaussianProcess._moments64` (k** and K* from
# the double-float Gram, gram_df); in f32, k** − VᵀV there is indefinite by
# a fifth of its mean variance (phase 14.4 prints mean_std(full=True)'s
# least eigenvalue), past the ladder's last step. Held: the ladder's jitter
# at most SAMPLE_JITTER_MAX of the mean variance; the draws' mean and
# covariance against the mean and the L Lᵀ that sample factored, within
# SAMPLE_SE standard errors of the draws' own spread (the errors' norms
# against their RMS under sampling); and that covariance against the
# float64 model's on the CPU, within SAMPLE_COV_RTOL in Frobenius norm (the
# f32 fit's factor: 0.87 % measured on the CPU's f32 Cholesky).
SAMPLE_T, SAMPLE_DRAWS, SAMPLE_SE = 256, 4000, 4.0
SAMPLE_JITTER_MAX, SAMPLE_COV_RTOL = 1e-2, 5e-2
SAMPLE_JITTER = 1e-8             # sample's default: the ladder's first step
# log_probability of one draw at LOGPROB_POINTS spread test points (at
# the 256 the covariance is singular to float64's rounding and the density
# is the jitter's): within LOGPROB_RTOL of the same formula in float64 on
# the card's moments, and within LOGPROB_F32_RTOL of the float64
# posterior's (the f32 fit's factor sets that floor). log_marginal within
# LOG_MARGINAL_RTOL of float64.
LOGPROB_POINTS, LOGPROB_RTOL, LOGPROB_F32_RTOL = 8, 1e-4, 1e-2
LOG_MARGINAL_RTOL = 1e-4
# gram_l1 at the bench shape before its redesign onto gram.cu's layout
# (PERF.md §6 row 2); tools/kernel_ab.py times the two kernels in turns
GRAM_L1_BEFORE_MS = 0.6712479829788208
# Phase 2c holds the derivative shapes at the sizes phase 13 launches them
# too, as DERIV_FAMILIES' note says, on K(x, x) of uniform points at each
# cell's n, d and starting lengthscales; a width None is gram_matvec, an
# integer gram_matmat with that many columns (13.3: optimize_params' 64
# probes; 13.4: the ARD quadratic term's d + 1 and the trace term's
# probes·(2d + 1)). (cell, n, d, atoms (family, nu, γ), shape, widths)
FIT_DERIV_SHAPES = (
    ("13.1", LAZY_N, D, LAZY_ATOMS, "dk_sq", (None, EVIDENCE_PROBES)),
    ("13.2", LAZY_BIG_N, HYPERFIT_D, (("se", 1.5, HYPERFIT["gamma0"]),),
     "dk_sq", (None, HYPERFIT["probes"])),
    ("13.3", LAZY_BIG_N, D, LAZY_ATOMS, "dk_sq", (None, 64)),
    ("13.4", LAZY_N, D, (("se", 1.5, ARD_GAMMA),), "dk",
     (D + 1, EVIDENCE_PROBES * (2 * D + 1))),
)


# lazy-tier bars against float64: at n = 32768 the single tier's mean 1e-3
# and variance max 1e-2 (both above the f32 CG floor, ~sqrt(n)·eps32), the
# double tier's mean 1e-6 (the ROADMAP's 1e-7 printed beside); at n = 65536
# the exact relative residual of the fit's alpha, float64, 1e-4.
LAZY_MEAN_RTOL, LAZY_VAR_RTOL, LAZY_DOUBLE_MEAN_RTOL = 1e-3, 1e-2, 1e-6
LAZY_RESIDUAL_MAX = 1e-4
# at n = 65536 mean_std runs on all t = 1024 test points when four times
# its wall on the first 256 stays under this many seconds, else on 256
LAZY_BIG_MEAN_STD_S = 60.0
# At n = 65536 the defaults' rank-512 preconditioner runs the fit's CG (one
# solve, never segmented) to maxiter = 500; its float64 residual is ~1e-5,
# under the 1e-4 bar (PERF.md §6). Phase 9 runs the defaults once and
# prints that, then serves with the one knob the fit's warning names,
# precond_rank, at 2048: the f32 floor in ~300 iterations, in less time.
LAZY_BIG_RANK = 2048
# The segmented solvers (the JAX package's above n = 32768; public in the
# port, run by none of its models): phase 9 calls cg_solve_segmented on the
# defaults' system and cg_solve_block_segmented on the first 128 columns of
# the served GP's exact variance, each beside its unsegmented solve. Their
# float64 residual is held at SEGMENTED_RESIDUAL_MAX: a segment that fails
# to halve the residual ends the solve, so they stop at the f32 floor of a
# restarted CG (~4e-4 for the defaults' system on an H100); the unsegmented
# block at LAZY_RESIDUAL_MAX.
SEGMENTED_RESIDUAL_MAX = 1e-3

# The fast blocked Cholesky (phase 2d, phase 11): its block size, the
# trailing update's shapes -- ragged, and the first (largest) of the fast
# factor's seven at n = 16384 (benchmarks/exp_chol3.py's probe shape) --
# and the leaf sizes: the largest, a ragged one, and one full panel and a
# one-column one; the launches at the largest that must agree bit for bit
# (a race between the grid's blocks shows as a rare bit difference).
FAST_NB = 2048
SYRK_RAGGED, SYRK_PROBE = (1000, 300), (N - FAST_NB, FAST_NB)
# the fast factor's last (smallest) update, timed beside the probe: one
# wave of tiles on the card, where the persistent loop's tail shows
SYRK_TAIL = (FAST_NB, FAST_NB)
LEAF_SIZES = (1024, 1000, 33)
LEAF_REPEATS = 20
# syrk_lower against its plain version (cuBLAS SGEMM) on the lower
# triangle, error over (|W||W|ᵀ)ᵢⱼ: each side's f32 sum of k products errs
# by at most k·2⁻²⁴ of it, the subtraction from T by one rounding more;
# twice the sum of the two is the bar. The kernel's products are three
# TF32 passes (ops.syrk.split_tf32), each off by a few 2⁻²² of |W_ip W_jp|
# in either direction, so over k products their error grows as √k and
# stays far under the bar at the probe's k; phase 2d prints the margin, and
# holds the kernel at the same bar against the model of its own arithmetic
# (the split, then the three products in float64), which leaves only its f32
# sums.
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
# Rule 2 for both stage kernels at a shape where a time is not launch
# overhead: bench.py's x (n = N, d = D, numpy seed 0) over the probe's γ,
# K(x, x) Matérn-5/2, as row 3's production gram_df launch; gram_df_stages
# takes those pairs' squared distances as f32 pairs. Each kernel is timed
# over STAGE_REPS launches there and STAGE_FLOOR_REPS at the probe's toy
# shape (P's grid, X's slice: the launch floor), its plain version over
# STAGE_PLAIN_REPS, and held to it in row blocks of STAGE_BLOCK (the
# float64 plain version of a 16384² stage holds several 2 GiB temporaries).
STAGE_REPS, STAGE_FLOOR_REPS, STAGE_PLAIN_REPS = 20, 200, 2
STAGE_BLOCK = 2048
# gram_df's K(x, x) launch computes its lower half and mirrors it: held
# bitwise to K(x, x') on a copy of x at 16384² and at this n, whose last
# tiles the edge cuts, in every shape code
STAGE_RAGGED_N = 1000

# Phase 15: the rest of the GP models. Sizes follow the repo's workloads.
# 15.1: bbmm's general tier (evidence_value_and_grad_general) on phase 8's
# n = 32768, d = 8 data, on the product SE(0.5)·Matérn-5/2(0.8) and on
# Laplace(γ = 2), 64 probes, row chunks of GENERAL_CHUNK, rank-512
# preconditioner, CG at 1e-6, against the dense float64 gradient at phase
# 13.1's bar (HUTCH_SIGMAS·σ + GRAD_RTOL·|g|); its peak device memory
# above what was held before, at GENERAL_SMALL_N too (the product): a
# graph that kept the (chunk, n) tiles would hold n² (4 GiB a product at
# 32768), the checkpointed chunks hold n·chunk, so the peak may grow at
# most GENERAL_PEAK_GROWTH-fold when n doubles (n² grows 4-fold).
GENERAL_ATOMS = (("se", 2.5, 0.5), ("matern", 2.5, 0.8))
GENERAL_CHUNK, GENERAL_SMALL_N, GENERAL_PEAK_GROWTH = 2048, 16384, 3.0
# 15.2: IterativeGP(lazy=True).optimize_params on 15.1's product kernel at
# n = 32768, GENERAL_FIT_STEPS Adam steps (tol 0: every step runs); the
# dense float64 NLL at the end under its start value, and the refit's
# float64 residual at most LAZY_RESIDUAL_MAX. The GP is precision="double"
# (var_refine=0): at the fitted σ (0.075) an f32 refit's CG reports a
# recurrence residual of 1e-6 while its true float64 residual is 4.0e-4 (an
# H100), the f32 products' floor; the df refinement takes it under the bar.
# The same refit in f32 is held at F32_REFIT_RESIDUAL_MAX, a guard at 2.5x
# that floor, and both its residuals are printed. Then gram_df (each atom)
# and gemv_df (the product's pair) at the refinement's (df_chunk, n) strips.
# 2 steps (10 at first, then 3: 6.4 s a step on an H100). This and the
# other cut depths (DF_VARIANCE_T, VOLUME_BISECTIONS, ONLINE_CAP,
# FEATURE_REPS, ESTIMATOR_REPS) keep the script inside its 1200 s limit on
# a slow host: at the first depths it ran past 1500 s on an H100 whose
# host took 1.6-2.3x as long over the launch-bound phases as others, and
# with phase 20 at the depths before the last cuts it took 1104 s on a
# host 1.5x slower there than another
GENERAL_FIT_STEPS = 2
F32_REFIT_RESIDUAL_MAX = 1e-3
# 15.3 serves DF_VARIANCE_T test points, 128 (1024 at first, then 256)
DF_VARIANCE_T = 128
# 15.3: the df-refined matrix-free variance (precision="double", the
# default var_refine=1) on phase 8's system at t = DF_VARIANCE_T, against the
# dense float64 posterior: mean within LAZY_DOUBLE_MEAN_RTOL, variance max
# within REFINED_VAR_MAX_RTOL (tests/test_parallel.py:552-590's bars).
# 15.4: the robust losses on bench.py's first ROBUST_N rows with
# ROBUST_FRACTION of y shifted by ROBUST_SHIFT (tests/test_exact_gp.py:
# 138-149's outlier, lam = 0.5 as there), SE γ = 0.5, s = 0.1: the f32
# fit's objective at its alpha (in float64) within ROBUST_OBJ_RTOL of the
# float64 model's (the same loss on the plain float64 Gram, on the card);
# neither L-BFGS converges in its 500 iterations here, and on the CPU's
# f32 Gram the gap was −3.3e-5 (huber), −7e-9 (svr), −5.8e-7 (unif): the
# f32 run ends lower. The huber mean must be closer to the clean-data
# float64 posterior than the squared loss's. Then the MAP evidence and its
# γ-derivative at config 1 (n = 1024, d = 1) with huber against the
# float64 model. As called, the inner L-BFGS stops at its 300 iterations
# unconverged, from a different K in each model, at a different α̂: the
# value is held within MAP_RTOL relative (the CPU's f32 Gram: 4.0e-5 /
# 5.3e-5 at γ = 1 / 0.3), the derivative, whose Danskin form holds only at
# the argmin, is printed (the CPU: 5.7 % / 6.7 %). Then both at the float64
# model's α̂, shared (`inner_argmin`): only K(γ) and its gradient differ,
# in f32 against float64, and H = ∂²obj/∂α² is near singular (K + 1e-4 I);
# the value within MAP_RTOL, the derivative within MAP_SHARED_GRAD_RTOL
# (the CPU: 5.1e-7 / 4.0e-5, and 2.6e-5 / 6.8e-3).
ROBUST_N, ROBUST_SHIFT, ROBUST_FRACTION, ROBUST_LAM = 4096, 30.0, 0.01, 0.5
ROBUST_LOSSES = ("huber", "svr", "unif")
ROBUST_OBJ_RTOL = 1e-3
MAP_GAMMAS = (1.0, 0.3)
MAP_RTOL, MAP_SHARED_GRAD_RTOL = 1e-3, 2e-2
# 15.5: ucb_optimize on phase 3's GP (n = 16384, bounds [−1, 1]^8),
# UCB_MULTISTART starts; the float64 model (plain float64 Gram on the card)
# from the same starts: its best value within UCB_RTOL relative of the
# card's, the card's point's float64 acquisition within UCB_RTOL of the
# value the card reports, and at least the best of UCB_RANDOM random points.
UCB_MULTISTART, UCB_RTOL, UCB_RANDOM = 25, 1e-3, 4096
# 15.6: gradient_mean_var and mean_gradient_hessian at GRAD_POINTS test
# points against the float64 model's autograd, each within GRAD_HELPER_RTOL
# of the float64 quantity's largest entry (the CPU's f32 model: at most
# 4.0e-5 for ∇μ, 4.7e-5 for ∇²σ², 1.7e-5 for ∇²μ).
GRAD_POINTS, GRAD_HELPER_RTOL = 8, 1e-3
# 15.7: sample_and_max (grid mode) on 15.5's GP at SAMPLE_MAX_T test
# points, SAMPLE_MAX_SIZE paths, held to `sample` on the same generator
# seed; sample_iteratively_max without a grid at config 1 (multistart 20,
# grid 100), the data and the fit restored afterwards.
SAMPLE_MAX_T, SAMPLE_MAX_SIZE = 1024, 16
# 15.8: volume_mean on config 1's data with two band outliers (VOLUME_BAND),
# both relaxes, at VOLUME_T points of [−1, 1]: as a user calls it (the
# scale by bisection), timed; then at VOLUME_SCALE against the float64
# model's run on the card. Both run in float64 (volume_mean's own policy);
# the Grams differ at 1e-16. relu (FISTA): μ within VOLUME_RELU_RTOL of
# its largest entry (8.6e-8 measured on the CPU). logistic: its L-BFGS
# uses all 1000 iterations unconverged and its iterates are chaotic (on
# the CPU two such runs ended 11 % apart in μ at scale 0.1), so it is held
# by the objective at its fitted β (`inner_argmin` reads it) against the
# float64 run's, one-sided, within VOLUME_OBJ_RTOL relative: on the CPU
# the f32 model ended 3.1e-4 below, and float64 runs on inputs scaled by
# 1 ± 1e-15 spread 3.3e-4. μ's difference is printed.
VOLUME_BAND, VOLUME_T, VOLUME_SCALE = ((100, 3.0), (700, -3.0)), 256, 0.1
VOLUME_RELU_RTOL, VOLUME_OBJ_RTOL = 1e-6, 1e-3
# the scale's bisection steps of the timed call, 1 (volume_mean's default
# 10 at first, then 2; each step is two fits, 1.3 s relu and 2.7 s
# logistic on an H100, twice that on a slow host)
VOLUME_BISECTIONS = 1
# 15.9: OnlineGP, capacity ONLINE_CAP, d = 8, bench rows fed one at a time;
# against the batch GaussianProcess on the same points at 4096 test points:
# mean within ONLINE_MEAN_RTOL of its largest entry, std within
# ONLINE_STD_RTOL entry by entry (the CPU's f32: 2.3e-6 and 5.0e-6).
# 2048 since PR 15 (4096 before, 20 s of the script on an H100)
ONLINE_CAP, ONLINE_MEAN_RTOL, ONLINE_STD_RTOL = 2048, 1e-4, 1e-4

# Phase 16: the feature-GP and Nyström slice (embeddings, KernelizedFeatures,
# NystromFeatures, IterativeGP.sample_pathwise). Its float64 references are
# the port's own models in float64 on the card, on the same embeddings and
# landmarks, their atoms evaluating the plain versions (`plain64_atoms`).
# Each timed call: one warm-up, then FEATURE_REPS runs, median and IQR, as
# benchmarks/run_all.py times them.
FEATURE_REPS = 2          # since PR 16 (3 in PR 15, 5 before)
# 16.1: run_all.py config 2 as written (:94-127): x ~ U(−1, 1)^(512 × 2),
# y = sin 3x₀ · cos 2x₁ (numpy seed 1), 1024 test points; the port's exact
# GP (γ = 0.5, s = 0.05), then HermiteEmbedding(0.5, 512, 2) (484 features)
# with KernelizedFeatures(s = 0.05): fit_gp, mean_std and sample of 64 paths.
# Against the float64 feature GP: the mean within CONFIG2_MEAN_RTOL of
# max|μ64| (the CPU's f32 gap: 2.8e-7, tools/feature_f32_gap.py), the std
# within CONFIG2_STD_RTOL entry by entry (the CPU's f32 gap: 9.7e-5); the
# draws' mean within DRAW_SE standard errors σ64/√64 of μ64 at every point,
# and their covariance against Φ·s²L Lᵀ·Φᵀ of the factor L that sample's
# ladder made of the f32 V⁻¹ within DRAW_SE standard errors in Frobenius
# norm (phase 14.4's measure).
CONFIG2_N, CONFIG2_T, CONFIG2_M, CONFIG2_DRAWS = 512, 1024, 512, 64
CONFIG2_GAMMA, CONFIG2_S = 0.5, 0.05
CONFIG2_MEAN_RTOL, CONFIG2_STD_RTOL, DRAW_SE = 1e-4, 1e-3, 5.0
# 16.2: run_all.py config 3 as written (:130-159): x ~ U(−1, 1)^(50000 × 2)
# in f32, y = sin 3x₀ + x₁ (numpy seed 2), Matérn-3/2(0.4) on x₀ +
# SE(0.6) on x₁, NystromFeatures(m = 512, "uniform", s = 0.05), fit_gp and
# mean_std on the first CONFIG3_HEAD points. Against the float64 model on
# the same landmarks: the mean within CONFIG3_MEAN_RTOL of max|μ64| (the
# CPU's f32 gap at this size: 7.6e-5; the bar is five times it), and
# train_mae_head within CONFIG3_MAE_ATOL of the float64 model's.
CONFIG3_N, CONFIG3_M, CONFIG3_S, CONFIG3_HEAD = 50_000, 512, 0.05, 2048
CONFIG3_ATOMS = (("matern", 1.5, 0.4, 0), ("se", 1.5, 0.6, 1))
CONFIG3_MEAN_RTOL, CONFIG3_MAE_ATOL = 4e-4, 1e-3
# 16.3: IterativeGP(lazy=True) with SE(0.5), s = 0.1 on config 2's function
# at n = PATHWISE_N, d = 2 (numpy seed 1), the largest n whose float64
# dense posterior the card factors (phase 8); sample_pathwise with
# HermiteEmbedding(0.5, 512, 2), 64 paths at 1024 test points. Held: every
# column's float64 residual of its CG correction at most
# PATHWISE_RESIDUAL_MAX; the paths' mean within DRAW_SE standard errors
# (σ64/√64) of the dense float64 mean plus the embedding's kernel error.
# Without a preconditioner each path's CG needs 734-886 iterations here
# (an H100), past the default maxiter of 500: the GP takes PATHWISE_MAXITER.
PATHWISE_N, PATHWISE_T, PATHWISE_DRAWS = 32768, 1024, 64
PATHWISE_GAMMA, PATHWISE_S, PATHWISE_MAXITER = 0.5, 0.1, 2000
PATHWISE_RESIDUAL_MAX = 1e-4

# Phase 17: the Poisson point-process slice (domains, the positive bases,
# PoissonPointProcess, PoissonRateEstimator with its ellipsoid bounds) and
# run_all.py config 5. Its float64 references are the port's own models in
# float64 on the card, on the same rounds, their kernel on the plain Gram
# (`plain64_kernel`). 17.1: run_all.py config 4 as written (:162-215):
# HierarchicalBorelSets(2, [−1, 1]², levels=3) (16 leaf sets), SE
# γ = POISSON_GAMMA, PoissonRateEstimator(m = 8: 64 triangle functions,
# B = 4, s = 1e-3, map_max_iter = 1000), λ(x) = 2.5·exp(−2‖x‖²) + 0.3,
# every leaf sensed for dt = 20, its points drawn by the port's process on
# the leaf's 16-point grid from a generator on the card seeded 0. fit_gp
# timed warm (FEATURE_REPS); the fitted total within POISSON_TRUE_RTOL of
# the process's true total (run_all.py's gate) and within
# POISSON_TOTAL_RTOL of the float64 model's (the f32-to-f64 bar of
# tests/test_point_processes.py:482-541; the CPU's f32 gap: 1.5e-4,
# tools/poisson_f32_gap.py, which prints every CPU gap of this note).
# 17.2: ucb_lcb_actions over 17.1's 16 leaf sets: lcb ≤ map ≤ ucb, every
# bound within POISSON_BOUND_RTOL of the float64 model's on the same rate
# (the CPU's f32 gap: 6.6e-6), each error over the larger of |the float64
# bound| and the set's float64 map (an lcb on the box floor is 0 up to
# rounding: at 17.3's size on the CPU the plain relative error of an lcb
# reaches 8e7, the scaled one 2.0e-5); the scalar route of `ucb` and
# `lcb` on the set of largest ucb against its batched row. 17.3: a 2-D intensity at a size a
# user maps: levels 6 (1024 leaf sets), m = 32 (1024 basis functions),
# dt = 200 per leaf (about 950 points), the same bars, the bounds over the
# 64 sets of level 4; the Γ^½ build alone and the peak memory. Its SE
# bandwidth keeps config 4's ratio to the grid step (0.4 at a step of
# 0.314, 1.27 steps; USER_GAMMA at a step of 0.071, 1.41 steps): with
# γ = 0.4 at 16² nodes the float64 MAP total is 37 % of the truth after
# 1000 L-BFGS iterations and 49 % after 5000 (the CPU). The basis grid's
# Gram is the double-float one (`gram_df`), see embeddings/positive.py.
# 17.4:
# run_all.py config 5 as written (:218-250): GaussianProcess(γ = 1,
# s = 0.05) on n = 256 points of d = 1 (numpy seed 4),
# optimize_params(bandwidth, 64 restarts, maxiter 40), the cold fit and
# FEATURE_REPS warm ones timed; γ within FIT_GAMMA_RTOL of the port's
# float64 fit on the CPU (config 1's bar).
POISSON_GAMMA, USER_GAMMA = 0.4, 0.1
POISSON_EST = dict(d=2, B=4.0, s=1e-3, map_max_iter=1000)
CONFIG4_LEVELS, CONFIG4_M, CONFIG4_DT = 3, 8, 20.0
USER_LEVELS, USER_M, USER_DT, USER_ACTION_LEVEL = 6, 32, 200.0, 4
POISSON_TRUE_RTOL, POISSON_TOTAL_RTOL, POISSON_BOUND_RTOL = 0.10, 5e-3, 1e-3
CONFIG5_N, CONFIG5_GP = 256, dict(gamma=1.0, s=0.05, d=1)
CONFIG5_FIT = dict(type="bandwidth", restarts=64, maxiter=40)

# Phase 18: the kernel tail and the general double tier.
# tools/kernel_ab.py's ragged gram_l1 shapes (n, m, d), for gram_df's L1
# family in phase 2
L1_RAGGED = ((300, 517, 1), (301, 259, 33), (77, 130, 130))
# 18.2: general-ν Matérn; the single tier's mean bar, and its peak device
# memory under 3x phase 3's 3.57 GiB (an (n, m, 384) f32 tensor would be
# 384 GiB at 16384²)
GENERAL_NU, GENERAL_SINGLE_MEAN_RTOL, GENERAL_PEAK_GIB = 1.2, 1e-4, 3 * 3.57
# 18.4: the group search; 18.5: the manifold fits (a full-covariance SE
# from COV0, the float64 evidence at the f32 fit within 1e-3 of the float64
# model's from the same starts)
GROUPS_N, GROUPS_D = 4096, 4
COV_N, COV_D = 1024, 3
COV0 = [[1.0, 0.2, 0.0], [0.0, 0.8, 0.1], [0.1, 0.0, 1.2]]
COV_FIT = dict(restarts=2, maxiter=25)
COV_EVIDENCE_RTOL = 1e-3
# 18.6: the estimators on config 4's setup, each with its bar against the
# true total and its count of warm fits timed, and the Bernoulli draws a
# leaf. run_all.py's truth bar (POISSON_TRUE_RTOL) holds every estimator
# but the log-linear one, which fits φᵀθ to log(o)/τ
# (stpy_tpu/point_processes/loglinear.py:26), not to log(o/τ), so its total
# carries that bias (16 % at config 4 on the CPU, 11 % on an H100, in
# float64 as in f32; the JAX package's θ the same to 1e-6,
# tests/test_torch_port_bernoulli_mbr.py): it is held to LOGLINEAR_TRUE_RTOL,
# over that bias, so that a broken fit still fails. The permanental fit
# (8 L-BFGS runs of 1000 iterations, launch-bound) takes 30 s warm on an
# H100 and 48 s on a slow host, twice that under DeviceOps: its cold fit
# under DeviceOps is its one timed f32 fit (no warm fits; see
# GENERAL_FIT_STEPS on the time limit).
# 2 warm reps since PR 16 (3 before), to pay for phase 19
ESTIMATOR_REPS, LOGLINEAR_TRUE_RTOL = 2, 0.2
PHASE18_ESTIMATORS = (
    ("LogLinearRateEstimator", LogLinearRateEstimator, {},
     LOGLINEAR_TRUE_RTOL, ESTIMATOR_REPS),
    ("PermanentalProcessRateEstimator", PermanentalProcessRateEstimator, {},
     POISSON_TRUE_RTOL, 0),
    ("LogisticGaussProcessRateEstimator", LogisticGaussProcessRateEstimator,
     {}, POISSON_TRUE_RTOL, ESTIMATOR_REPS),
    ("ExpGaussProcessRateEstimator", ExpGaussProcessRateEstimator, {},
     POISSON_TRUE_RTOL, ESTIMATOR_REPS),
    ("LogGaussProcessRateEstimator", LogGaussProcessRateEstimator, {},
     POISSON_TRUE_RTOL, ESTIMATOR_REPS),
    ("MBRPositiveEstimator", MBRPositiveEstimator, {"psd": True},
     POISSON_TRUE_RTOL, ESTIMATOR_REPS),
)
BERNOULLI_DRAWS = 40
ESTIMATOR_SEED = 23      # the estimators' generator seed, reseeded to compare

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
    # the derivative shapes of the two matrix-free kernels (_SHAPES, :111)
    **{f"{name}[{shape}]": (src, f"stpy_tpu/ops/pallas_gram_matvec.py:{line}")
       for name, src, line in (
           ("gram_matvec", "stpy_tpu_torch/csrc/gram_matvec.cu", 85),
           ("gram_matmat", "stpy_tpu_torch/csrc/gram_matmat.cu", 161))
       for shape in ("dk_sq", "dk")},
}
# the device kernels phase 10 counts under a name, where not `<name>_kernel`:
# gram_matmat's, gram_matvec's, qform_df's and syrk_lower's calls run their
# pre-passes and, where they split the sums, their reductions too
PROFILE_KERNELS = {"gram_matmat": ("gram_matmat_kernel", "split_v_kernel",
                                   "pad_y_kernel"),
                   "syrk_lower": ("syrk_lower_kernel", "split_w_kernel"),
                   "gram_matvec": ("gram_matvec_kernel", "pad_points_kernel",
                                   "matvec_reduce_kernel"),
                   "qform_df": ("qform_df_kernel", "pack_a_kernel",
                                "pack_w_kernel", "qform_reduce_kernel"),
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


def timed_pair(kernel_fn, plain_fn, reps=5, plain_reps=None):
    """(kernel ms, plain ms), run in turns plain, kernel, kernel, plain; the
    plain version over `plain_reps` runs (default `reps`)."""
    plain_reps = reps if plain_reps is None else plain_reps
    p1 = cuda_ms(plain_fn, plain_reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, plain_reps)
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


def shape_cost(family, nu=1.5, shape="k"):
    """(f32 operations, special-function results) of one shape entry past
    the squared distance, counted from gram_shape.cuh's shape_exp2: "k" SE
    2 and an exp, Matérn 4, a sqrt and an exp; "dk_sq" / "dk" SE 3 / 2 and
    an exp; Matérn: the sqrt, the exponent's FMUL and the exp, then for
    ½ 2 FMULs / an FMUL, an FMAX and an IEEE division (a reciprocal on the
    SFU and 4 FMAs), 3/2 2 / 1 FMULs, 5/2 an FMA and 3 / 2 FMULs."""
    if shape == "k":
        return (2, 1) if family == "se" else (4, 2)
    if family == "se":
        return (3, 1) if shape == "dk_sq" else (2, 1)
    extra = {0.5: (2, 6), 1.5: (2, 1), 2.5: (4, 3)}[float(nu)]
    sfu = 3 if (float(nu), shape) == (0.5, "dk") else 2
    return 1 + extra[shape == "dk"], sfu


def matvec_bound(n, m, d, family, r=None, nu=1.5, shape="k"):
    """gram_matvec (r = None) or gram_matmat with r columns: x, y and the
    right side read once, the output written once; per (i, j) pair 2d f32
    operations for the squared distance, the shape's (`shape_cost`) and 2
    per column of the product over F32_FLOPS, against the exps and sqrts
    over SFU_OPS; the larger of the two is the operations' time."""
    cols = 1 if r is None else r
    shape_ops, sfu = shape_cost(family, nu, shape)
    t_bytes = 4 * ((n + m) * d + (n + m) * cols) / HBM_BPS * 1e3
    t_ops = n * m * max((2 * d + shape_ops + 2 * cols) / F32_FLOPS,
                        sfu / SFU_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matmat_tc_bound(n, m, d, family, r, nu=1.5, shape="k"):
    """gram_matmat as csrc/gram_matmat.cu computes it: the product with V in
    three TF32 passes on the tensor cores, 3·2·n·m·r operations over
    TF32_FLOPS, against the Gram entries' 2d + shape f32 operations over
    F32_FLOPS, their exps and sqrts over SFU_OPS, and the bytes of
    `matvec_bound`; the largest of these. The entries are counted once,
    though the kernel computes them once per 128-column slab."""
    shape_ops, sfu = shape_cost(family, nu, shape)
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
    """syrk_lower on the f32 pipes: the lower half of T read and written
    once, W read once; m(m+1)/2 entries times 2k f32 operations."""
    return bound(4 * m * (m + 1) + 4 * m * k, m * (m + 1) * k, F32_FLOPS)


def syrk_tc_bound(m, k):
    """syrk_lower's bound as the kernel computes, on gram_matmat's
    yardstick: the same bytes, the m(m+1)k operations in three TF32 passes
    on the tensor cores (the 3xTF32 split keeps f32 accuracy there),
    3·m(m+1)k over TF32_FLOPS."""
    return bound(4 * m * (m + 1) + 4 * m * k, 3 * m * (m + 1) * k, TF32_FLOPS)


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
        err["gram_l1"] = max(err["gram_l1"], gram_l1_check(
            label, xu, yu, LAPLACE_GAMMA))
        if label == "bench":
            times["gram_l1"] = timed_pair(
                lambda: gram_l1(xu, yu, inv_g2, 1.0),
                lambda: gram_l1_plain(xu, yu, inv_g2, 1.0))
            times["bounds"] = gram_bounds(n, m, d)
            t, b = times["gram_l1"][0], times["bounds"]["gram_l1"][0]
            print(f"  gram_l1 bench  {n}x{m} d={d}: kernel {t!r} ms, bound "
                  f"{b!r} ms ({b / t * 100:.1f} % of it reached); before "
                  f"its redesign {GRAM_L1_BEFORE_MS} ms (PERF.md §6)")
        for fam, nu in FAMILIES:
            err["gram"] = max(err["gram"], scaled_gram_check(
                label, xs, ys, fam, nu))
            e, hi, lo = gram_df_check(label, xs64, ys64, fam, nu, 1.0)
            err["gram_df"] = max(err["gram_df"], e)
            err["gemv_df"] = max(err["gemv_df"], gemv_df_check(
                f"{label} {fam}", hi, lo, v, vl))

            if label == "bench" and fam == "se":
                times["gram"] = timed_pair(
                    lambda: gram_scaled(xs, ys, 1.0, fam, nu),
                    lambda: gram_plain(xs, ys, 1.0, fam, nu))
                nbytes = 4 * (n + m) * d + 4 * n * m
                print(f"  gram    bench  {fam:6s} {n}x{m} d={d}: kernel "
                      f"{times['gram'][0]!r} ms, {nbytes / times['gram'][0] / 1e6!r}"
                      f" GB/s of its compulsory bytes ({nbytes / HBM_BPS * 1e3!r}"
                      f" ms at {HBM_BPS / 1e12} TB/s)")
                times["gram_df"] = timed_pair(
                    lambda: gram_df_scaled(xs64, ys64, 1.0, fam, nu),
                    lambda: gram_df_plain(xs64, ys64, 1.0, fam, nu))
                times["gemv_df"] = timed_pair(
                    lambda: gemv_df(hi, lo, v, vl),
                    lambda: gemv_df_plain(hi, lo, v, vl))
            del hi, lo
            torch.cuda.empty_cache()
    return err, times


def qform_error(Th, Tl, W0k, W0a, Bh, Bl, s=S):
    """(max |Δq|, max |Δq| / scale) of the kernel against its plain version,
    scale = Σ_a |W0a|·(2|B| + |A|·|W0k| + s²|W0a|)."""
    qh, ql = qform_refined_strip(Th, Tl, W0k, W0a, Bh, Bl, s)
    ph, pl = qform_df_plain(Th, Tl, W0k, W0a, Bh, Bl, s * s)
    diff = (qh.double() + ql.double() - ph.double() - pl.double()).abs()
    del qh, ql, ph, pl
    Wa = W0a.double().abs()
    AW = (Th.double() + Tl.double()).abs() @ W0k.double().abs()
    scale = (Wa * (2 * (Bh.double() + Bl.double()).abs() + AW + s * s * Wa)).sum(0)
    return float(diff.max()), float((diff / scale).max())


def qform_checks(dev, x, xt):
    """Phase 2b: qform_df against its plain version on a ragged strip with
    random operands, at the bench shape c = n = t = 16384 on the real SE
    system (df train Gram, df cross Gram, W0 from the f32 Cholesky solve)
    and on a row strip of that system (QFORM_STRIP).
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
    r0, c = QFORM_STRIP
    rows = slice(r0, r0 + c)
    e, rel = qform_error(Th[rows], Tl[rows], W0, W0[rows], Bh[rows], Bl[rows])
    print(f"  qform_df strip  rows {r0}..{r0 + c - 1} of the SE system, c={c} "
          f"n=t={N}: max abs err {e!r}, max err / scale {rel!r}")
    assert rel <= QFORM_RTOL, ("qform_df", "strip", rel)
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


def diagonal_rows(n):
    return sorted({0, n // 2, n - 1})


def diagonal_value(fam, nu, shape="k"):
    """κ·s(0) in f32 as the kernels form it: s(0) = 1 for "k", 0 for
    "dk_sq", k'(0) for "dk" (Matérn-½: −½ over the clamp 1e-6, an IEEE f32
    division), times DIAG_KAPPA in f32."""
    f32 = torch.float32
    if shape == "k":
        s0 = torch.tensor(1.0, dtype=f32)
    elif shape == "dk_sq":
        s0 = torch.tensor(0.0, dtype=f32)
    elif fam == "se":
        s0 = torch.tensor(-0.5, dtype=f32)
    elif nu == 0.5:
        s0 = torch.tensor(-0.5, dtype=f32) / torch.tensor(1e-6, dtype=f32)
    else:
        s0 = torch.tensor(-1.5 if nu == 1.5 else -5.0 / 6.0, dtype=f32)
    return torch.tensor(DIAG_KAPPA, dtype=f32) * s0


def matvec_diagonal_check(xs, fam, nu, shape="k"):
    """gram_matvec_scaled(xs, xs, e_i)[i] == `diagonal_value` bit for bit at
    the first, a middle and the last row: the diagonal term is exact."""
    n = xs.shape[0]
    want = diagonal_value(fam, nu, shape)
    for i in diagonal_rows(n):
        e = torch.zeros(n, dtype=torch.float32, device=xs.device)
        e[i] = 1.0
        got = gram_matvec_scaled(xs, xs, e, DIAG_KAPPA, fam, nu, shape)[i].cpu()
        assert torch.equal(got, want), ("gram_matvec diagonal", n, fam, nu,
                                        shape, i, float(got), float(want))


def shape_slope(sq, fam, nu, shape):
    """|∂s/∂sq| of a derivative shape, float64 (ρ = √(sq + 1e-30)):
    SE "dk" e/4, "dk_sq" e|1 − sq/2|/2 (e = exp(−sq/2)); Matérn-½ "dk"
    e(1 + ρ)/(4ρ³), "dk_sq" e|1 − ρ|/(4ρ); 3/2 "dk" 0.75·√3·e/ρ, "dk_sq"
    1.5e|1 − √3ρ/2|; 5/2 "dk" (25/12)e, "dk_sq" |k'(sq)| + sq(25/12)e
    (e = exp(−cρ), c = 1, √3, √5)."""
    if fam == "se":
        e = torch.exp(-0.5 * sq)
        return 0.25 * e if shape == "dk" else 0.5 * e * (1 - 0.5 * sq).abs()
    r = torch.sqrt(sq + 1e-30)
    c = {0.5: 1.0, 1.5: math.sqrt(3.0), 2.5: math.sqrt(5.0)}[nu]
    e = torch.exp(-c * r)
    if nu == 0.5:
        return (e * (1 + r) / (4 * r ** 3) if shape == "dk"
                else e * (1 - r).abs() / (4 * r))
    if nu == 1.5:
        return (0.75 * c * e / r if shape == "dk"
                else 1.5 * e * (1 - 0.5 * c * r).abs())
    slope = 25.0 / 12.0 * e
    return slope if shape == "dk" else (5.0 / 6.0) * (1 + c * r) * e + sq * slope


def deriv_error(kernel_fn, xs, ys, V, fam, nu, shape):
    """A derivative shape of a matrix-free product against its plain version
    in float64 on the same f32 inputs: (max |Δ|, max |Δ| / Σⱼ|Kᵢⱼ||Vⱼc|,
    max |Δ| / bar) with the bar of DERIV_FAMILIES' note; two launches must
    give the same bits."""
    out = kernel_fn(xs, ys, V, 1.0, fam, nu, shape)
    again = kernel_fn(xs, ys, V, 1.0, fam, nu, shape)
    assert torch.equal(out, again), "two launches gave different bits"
    m, d = ys.shape
    V64 = V.double().reshape(m, -1)
    aV = V64.abs()
    x64, y64 = xs.double(), ys.double()
    ny = (y64 * y64).sum(1)
    worst = [0.0, 0.0, 0.0]
    for r0 in range(0, xs.shape[0], 4096):
        xc = x64[r0:r0 + 4096]
        K = shape_gram_plain(xc, y64, 1.0, fam, nu, shape)
        ref, scale = K @ V64, K.abs() @ aV
        del K
        sq = ((xc * xc).sum(1)[:, None] + ny[None, :]
              - 2.0 * xc @ y64.T).clamp_min_(0.0)
        slope = shape_slope(sq, fam, nu, shape)
        del sq
        if ys is xs:     # a point against itself: sq exactly 0 in the kernel
            slope.diagonal(r0).zero_()
        nx = (xc * xc).sum(1)[:, None]
        cond = nx * (slope @ aV) + slope @ (ny[:, None] * aV)
        del slope
        bar = matvec_rtol(m) * scale + (d + 4) * EPS32 * cond
        diff = (out[r0:r0 + 4096].double().reshape(ref.shape) - ref).abs()
        worst = [max(worst[0], float(diff.max())),
                 max(worst[1], float((diff / scale).max())),
                 max(worst[2], float((diff / bar).max()))]
    return tuple(worst)


def deriv_checks(dev):
    """Phase 2c, the derivative shapes: gram_matvec and gram_matmat in
    "dk_sq" and "dk" for every fused family (DERIV_FAMILIES) against their
    plain versions (`deriv_error`), bitwise repeatable, on the ragged shape
    (r = 77), the bench shape n = m = 16384 and the 65k lazy shape (r = 128),
    both on the fit's own operator K(x, x), whose diagonal term is exact
    (`matvec_diagonal_check`); each timed at 65k beside its bound, SE also
    beside its plain version; then gram_matmat "dk" at the ARD trace term's
    r = 576 (d = 4), against r = 128; then each shape at the sizes phase 13
    launches it (FIT_DERIV_SHAPES), held the same way. Returns name[shape]
    -> max abs error, (kernel ms, plain ms) and (bound ms, by) of SE at
    65k, and the r = 576 timings."""
    rng = np.random.default_rng(5)
    err = {f"{k}[{s}]": 0.0 for k in ("gram_matvec", "gram_matmat")
           for s in DERIV_SHAPES}
    times, bounds = {}, {}
    for label, (n, m, d) in (("ragged", RAGGED), ("16k", (N, N, D)),
                             ("65k", (LAZY_BIG_N, LAZY_BIG_N, D))):
        x = rng.uniform(-1, 1, (n, d))
        y = rng.uniform(-1, 1, (m, d)) if label == "ragged" else x
        v = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                            device=dev)
        r = RAGGED_R[0] if label == "ragged" else MATMAT_R
        V = torch.as_tensor(rng.standard_normal((m, r)), dtype=torch.float32,
                            device=dev)
        for fam, nu, gamma in DERIV_FAMILIES:
            xs = torch.as_tensor(x / gamma, dtype=torch.float32, device=dev)
            ys = xs if y is x else torch.as_tensor(
                y / gamma, dtype=torch.float32, device=dev)
            for shape in DERIV_SHAPES:
                if ys is xs:
                    matvec_diagonal_check(xs, fam, nu, shape)
                for name, fn, rhs in (("gram_matvec", gram_matvec_scaled, v),
                                      ("gram_matmat", gram_matmat_scaled, V)):
                    e, rel, of_bar = deriv_error(fn, xs, ys, rhs, fam, nu,
                                                 shape)
                    key = f"{name}[{shape}]"
                    err[key] = max(err[key], e)
                    line = (f"  {key:18s} {label:6s} {fam}-{nu} {n}x{m} d={d}"
                            + ("" if name == "gram_matvec" else f" r={r}")
                            + f": max abs err {e!r}, max err / sum|K||V| "
                            f"{rel!r} (matvec_rtol {matvec_rtol(m)!r}), of the "
                            f"bar {of_bar!r}, repeatable")
                    if ys is xs and name == "gram_matvec":
                        line += (f"; K(x, x)·e_i = "
                                 f"{float(diagonal_value(fam, nu, shape))!r} "
                                 f"exactly at rows {diagonal_rows(n)}")
                    if label == "65k":
                        k_ms = cuda_ms(lambda: fn(xs, ys, rhs, 1.0, fam, nu,
                                                  shape), 3)
                        bnd = (matvec_bound(n, m, d, fam, None, nu, shape)
                               if name == "gram_matvec" else
                               matmat_tc_bound(n, m, d, fam, r, nu, shape))
                        line += f"; kernel {k_ms!r} ms, bound {bnd[0]!r} ms ({bnd[1]})"
                        if fam == "se":
                            plain = (gram_matvec_plain if name == "gram_matvec"
                                     else gram_matmat_plain)
                            p_ms = cuda_ms(lambda: plain(xs, ys, rhs, 1.0, fam,
                                                         nu, shape), 3)
                            k2 = cuda_ms(lambda: fn(xs, ys, rhs, 1.0, fam, nu,
                                                    shape), 3)
                            times[key] = ((k_ms + k2) / 2, p_ms)
                            bounds[key] = bnd
                            line += f", plain {p_ms!r} ms"
                    print(line)
                    assert of_bar <= 1.0, (key, label, fam, nu, rel, of_bar)
        torch.cuda.empty_cache()
    # the ARD trace term's block at d = 4: r = 576 columns, five 128-column
    # slabs, each block computing its entries again
    n, d = LAZY_BIG_N, ARD_TRACE_D
    xs = torch.as_tensor(rng.uniform(-1, 1, (n, d)) / 0.5, dtype=torch.float32,
                         device=dev)
    wide = {}
    for r in (MATMAT_R, ARD_TRACE_R):
        V = torch.as_tensor(rng.standard_normal((n, r)), dtype=torch.float32,
                            device=dev)
        e, rel, of_bar = deriv_error(gram_matmat_scaled, xs, xs, V, "se", 1.5,
                                     "dk")
        assert of_bar <= 1.0, ("gram_matmat[dk]", r, rel, of_bar)
        k_ms = cuda_ms(lambda: gram_matmat_scaled(xs, xs, V, 1.0, "se", 1.5,
                                                  "dk"), 3)
        bnd = matmat_tc_bound(n, n, d, "se", r, shape="dk")
        wide[r] = (k_ms, bnd[0])
        print(f"  gram_matmat[dk] SE {n}x{n} d={d} r={r}: max err / "
              f"sum|K||V| {rel!r}, of the bar {of_bar!r}; kernel {k_ms!r} "
              f"ms, bound {bnd[0]!r} ms ({bnd[1]})")
        del V
    print(f"  gram_matmat[dk] r={ARD_TRACE_R} against r={MATMAT_R}: "
          f"{wide[ARD_TRACE_R][0] / wide[MATMAT_R][0]!r}x the time for "
          f"{ARD_TRACE_R / MATMAT_R!r}x the columns (the entries computed "
          f"once per 128-column slab, {-(-ARD_TRACE_R // MATMAT_R)} times)")
    del xs
    torch.cuda.empty_cache()
    for cell, n, d, atoms, shape, widths in FIT_DERIV_SHAPES:
        x = rng.uniform(-1, 1, (n, d))
        for fam, nu, gamma in atoms:
            xs = torch.as_tensor(x / np.asarray(gamma), dtype=torch.float32,
                                 device=dev)
            for r in widths:
                name, fn = (("gram_matvec", gram_matvec_scaled) if r is None
                            else ("gram_matmat", gram_matmat_scaled))
                rhs = torch.as_tensor(
                    rng.standard_normal(n if r is None else (n, r)),
                    dtype=torch.float32, device=dev)
                if r is None:
                    matvec_diagonal_check(xs, fam, nu, shape)
                e, rel, of_bar = deriv_error(fn, xs, xs, rhs, fam, nu, shape)
                key = f"{name}[{shape}]"
                err[key] = max(err[key], e)
                print(f"  {key:18s} {cell} {fam}-{nu} {n}x{n} d={d}"
                      + ("" if r is None else f" r={r}")
                      + f": max abs err {e!r}, max err / sum|K||V| {rel!r}, "
                      f"of the bar {of_bar!r}, repeatable"
                      + ("; diagonal exact" if r is None else ""))
                assert of_bar <= 1.0, (key, cell, fam, nu, r, rel, of_bar)
                del rhs
            del xs
            torch.cuda.empty_cache()
    return err, times, bounds, wide


def backward_scales(x, y, v, w, g, kappa, fam, nu):
    """Per gradient of L = wᵀK(x, y)v, the sum of the absolute values of
    the terms of its formula (`ops.gram_matvec._GramMatvec`), float64:
    v̄ |K|ᵀ|w|; κ̄ |w|ᵀ|K||v|/κ; scalar γ̄ (2/γ)|w|ᵀ|K_dk_sq||v|; ARD γ̄_c
    (2/γ_c)Σᵢⱼ|wᵢ||K'ᵢⱼ||vⱼ|(|x̃ᵢc| + |ỹⱼc|)²; x̄_ic 2|wᵢ|Σⱼ|K'ᵢⱼ||vⱼ|
    (|x̃ᵢc| + |ỹⱼc|)/γ_c and ȳ likewise (K' the "dk" shape)."""
    g64 = g.double()
    xs, ys = x.double() / g64, y.double() / g64
    aw, av = w.double().abs(), v.double().abs()
    K = shape_gram_plain(xs, ys, kappa, fam, nu).abs()
    Kd = shape_gram_plain(xs, ys, kappa, fam, nu, "dk").abs()
    out = {"v": K.T @ aw, "kappa": aw @ K @ av / kappa}
    ax, ay = xs.abs(), ys.abs()
    Kv, Ktw = Kd @ av, Kd.T @ aw
    gv = g64.reshape(-1) if g64.dim() else g64.expand(x.shape[1])
    out["x"] = 2 * aw[:, None] * (ax * Kv[:, None] + Kd @ (av[:, None] * ay)) / gv
    out["y"] = 2 * av[:, None] * (ay * Ktw[:, None] + Kd.T @ (aw[:, None] * ax)) / gv
    if g64.dim() == 0:
        Ks = shape_gram_plain(xs, ys, kappa, fam, nu, "dk_sq").abs()
        out["gamma"] = 2 / g64 * (aw @ Ks @ av)
    else:
        cross = (aw[:, None] * ax) * (Kd @ (av[:, None] * ay))
        out["gamma"] = 2 / gv * ((aw[:, None] * ax * ax * Kv[:, None]).sum(0)
                                 + 2 * cross.sum(0)
                                 + aw @ (Kd @ (av[:, None] * ay * ay)))
    return out


def backward_check(dev):
    """Phase 2c, gram_matvec's backward: at n = m = BACKWARD_N, d = 8, the
    gradients of wᵀK(x, y)v in x, y, v, γ (SE and Matérn-3/2 with a scalar
    γ, SE with an ARD γ) and κ from `ops.gram_matvec.gram_matvec`'s
    autograd.Function on the card, against torch.autograd of the plain
    version in float64 on the same f32 inputs, each within twice
    matvec_rtol(m) of `backward_scales`. The three backward passes run
    with the launch counters zeroed just before and read just after: the
    training path through gram_matvec. Returns (max error over scale,
    launches)."""
    rng = np.random.default_rng(6)
    n = BACKWARD_N
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, D)), **f32)
    y = torch.as_tensor(rng.uniform(-1, 1, (n, D)), **f32)
    v = torch.as_tensor(rng.standard_normal(n), **f32)
    w = torch.as_tensor(rng.standard_normal(n), **f32)
    cases = (("se", 1.5, 0.5), ("matern", 1.5, 0.8), ("se", 1.5, ARD_GAMMA))
    inputs = [[t.clone().requires_grad_() for t in
               (x, y, v, torch.tensor(g, **f32), torch.tensor(1.3, **f32))]
              for _, _, g in cases]

    def backward():
        for (fam, nu, _), ins in zip(cases, inputs):
            loss = w @ gram_matvec(ins[0], ins[1], ins[2], family=fam,
                                   gamma=ins[3], kappa=ins[4], nu=nu)
            loss.backward()

    _, _, counts = counted(backward)
    worst = 0.0
    for (fam, nu, _), ins in zip(cases, inputs):
        ref = [t.detach().double().requires_grad_() for t in ins]
        K = shape_gram_plain(ref[0] / ref[3], ref[1] / ref[3], ref[4], fam, nu)
        (w.double() @ (K @ ref[2])).backward()
        del K
        scales = backward_scales(*(t.detach() for t in ins[:3]), w,
                                 ins[3].detach(), float(ins[4].detach()), fam, nu)
        errs = {}
        for name, t, r in zip(("x", "y", "v", "gamma", "kappa"), ins, ref):
            errs[name] = float(((t.grad.double() - r.grad).abs()
                                / scales[name]).max())
        ard = "ARD " if ins[3].dim() else ""
        print(f"  gram_matvec backward {fam}-{nu} {ard}γ, n = m = {n}, "
              f"d = {D}: max err / scale " + ", ".join(
                  f"{k} {e!r}" for k, e in errs.items())
              + f" (bar {2 * matvec_rtol(n)!r})")
        assert max(errs.values()) <= 2 * matvec_rtol(n), (fam, errs)
        worst = max(worst, *errs.values())
    print(f"  the three backward passes: launches {counts}")
    assert counts["gram_matvec[dk]"] > 0 and counts["gram_matvec[dk_sq]"] > 0, counts
    torch.cuda.empty_cache()
    return worst, counts


def matvec_checks(dev):
    """Phase 2c: gram_matvec and gram_matmat against their plain versions
    (error over Σ_j |K_ij||v_j|, bar `matvec_rtol`), bitwise repeatable, for
    each atom of the lazy tiers' kernel (SE γ = 0.5, Matérn-3/2 γ = 0.8): a
    ragged shape (r = 77 and 200), the bench shape n = m = 16384 and the
    65k lazy tier's shape, r = 128, on the fit's own operator K(x, x), and
    the ragged shape at d = 512 (WIDE, r = 77); gram_matvec also on
    K(x, x) at the few points of MATVEC_FEW. On every K(x, x), gram_matvec's
    diagonal term is exactly κ (`matvec_diagonal_check`).
    Returns name -> max abs error; the timings at 16k and 65k (kernel,
    plain f32; SE, and gram_matvec's Matérn-3/2 kernel alone); cuBLAS SGEMM
    of the materialised 16k Gram by a 128-column block (not the same
    function)."""
    rng = np.random.default_rng(3)
    err = {"gram_matvec": 0.0, "gram_matmat": 0.0}
    times = {}
    sgemm_ms = None
    few = tuple((f"few{n}", (n, n, D)) for n in MATVEC_FEW)
    for label, (n, m, d) in (("ragged", RAGGED), *few, ("16k", (N, N, D)),
                             ("65k", (LAZY_BIG_N, LAZY_BIG_N, D)),
                             ("wide", WIDE)):
        spread = math.sqrt(D / d) if label == "wide" else 1.0
        x = rng.uniform(-1, 1, (n, d)) * spread
        y = (rng.uniform(-1, 1, (m, d)) * spread
             if label in ("ragged", "wide") else x)
        v = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                            device=dev)
        rs = {"ragged": RAGGED_R, "wide": RAGGED_R[:1]}.get(
            label, () if label.startswith("few") else (MATMAT_R,))
        Vs = [torch.as_tensor(rng.standard_normal((m, r)), dtype=torch.float32,
                              device=dev) for r in rs]
        for fam, nu, gamma in LAZY_ATOMS:
            xs = torch.as_tensor(x / gamma, dtype=torch.float32, device=dev)
            ys = xs if y is x else torch.as_tensor(
                y / gamma, dtype=torch.float32, device=dev)
            e, rel = matvec_error(gram_matvec_scaled, xs, ys, v, fam, nu)
            if ys is xs:
                matvec_diagonal_check(xs, fam, nu)
            print(f"  gram_matvec {label:6s} {fam:6s} {n}x{m} d={d}: max abs "
                  f"err {e!r}, max err / sum|K||v| {rel!r} (bar "
                  f"{matvec_rtol(m)!r}), repeatable"
                  + (f"; K(x, x)·e_i = {DIAG_KAPPA} exactly at rows "
                     f"{diagonal_rows(n)}" if ys is xs else ""))
            assert rel <= matvec_rtol(m), ("gram_matvec", label, fam, rel)
            err["gram_matvec"] = max(err["gram_matvec"], e)
            if label in ("16k", "65k") and fam != "se":
                times[label]["gram_matvec_matern32"] = cuda_ms(
                    lambda: gram_matvec_scaled(xs, ys, v, 1.0, fam, nu), 5)
                print(f"  gram_matvec {label} Matérn-3/2: kernel "
                      f"{times[label]['gram_matvec_matern32']!r} ms, bound "
                      f"{matvec_bound(n, m, d, fam)[0]!r} ms")
            for V in Vs:
                e, rel = matvec_error(gram_matmat_scaled, xs, ys, V, fam, nu)
                print(f"  gram_matmat {label:6s} {fam:6s} {n}x{m} d={d} "
                      f"r={V.shape[1]}: max abs err {e!r}, max err / "
                      f"sum|K||V| {rel!r} (bar {matvec_rtol(m)!r}), "
                      "repeatable")
                assert rel <= matvec_rtol(m), ("gram_matmat", label, fam, rel)
                err["gram_matmat"] = max(err["gram_matmat"], e)
            if label not in ("16k", "65k") or fam != "se":
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


def syrk_model_error(W):
    """syrk_lower on a zero T (so the result is the negated product, with no
    rounding of a sum with T) against the model of its arithmetic: W split
    by `split_tf32`, hi·hiᵀ + hi·loᵀ + lo·hiᵀ in float64. Max |Δ| /
    (|W||W|ᵀ)ᵢⱼ over the lower triangle: what is left is the kernel's f32
    sums on the tensor cores and in its totals."""
    diff = syrk_update_lower_(W.new_zeros((W.shape[0],) * 2), W).double()
    hi, lo = (h.double() for h in split_tf32(W))
    diff.addmm_(hi, hi.T).addmm_(hi, lo.T).addmm_(lo, hi.T)
    del hi, lo
    W64 = W.abs().double()
    rel = diff.abs_().tril_().div_(W64 @ W64.T)
    return float(rel.max())


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
    model = syrk_model_error(W)
    print(f"  syrk_lower probe against the model of its arithmetic (W split "
          f"by split_tf32, three products in float64): max err / (|W||W|ᵀ) "
          f"{model!r}, {model / syrk_rtol(k)!r} of the bar; against the plain "
          f"f32 version {rel / syrk_rtol(k)!r} of it")
    assert model <= syrk_rtol(k), ("syrk_lower", "model", model)
    scratch = T.clone()     # timed updates run in place, values drifting
    times["syrk_lower"] = timed_pair(lambda: syrk_update_lower_(scratch, W),
                                     lambda: syrk_update_lower_plain_(scratch, W))
    library["syrk_lower"] = cuda_ms(lambda: scratch.addmm_(W, W.T, alpha=-1.0))
    bounds["syrk_lower"] = syrk_tc_bound(m, k)
    mt, kt = SYRK_TAIL
    Tt, Wt = scratch[-mt:, -mt:].contiguous(), W[-mt:, :kt].contiguous()
    times["syrk_lower_tail"] = timed_pair(
        lambda: syrk_update_lower_(Tt, Wt),
        lambda: syrk_update_lower_plain_(Tt, Wt))
    print(f"  syrk_lower times (CUDA events, in turns): m={m} k={k} kernel "
          f"{times['syrk_lower'][0]!r} ms, plain {times['syrk_lower'][1]!r} "
          f"ms, tensor-core bound {bounds['syrk_lower'][0]!r} ms; m={mt} "
          f"k={kt} kernel {times['syrk_lower_tail'][0]!r} ms, plain "
          f"{times['syrk_lower_tail'][1]!r} ms, tensor-core bound "
          f"{syrk_tc_bound(mt, kt)[0]!r} ms")
    del T, W, scratch, L11, Tt, Wt
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


def inverse_panel(W, D):
    """W ← W·D⁻ᵀ as the port forms a panel (ops/syrk.py, in
    `chol_blocked_syrk` and in `_leaf_chol_`'s split of a 2048 block):
    W·(L⁻¹)ᵀ with L⁻¹ from a triangular solve against I."""
    eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
    W.copy_(W @ torch.linalg.solve_triangular(D, eye, upper=False).T)


def rebuilt_fast_factor(A, nb=FAST_NB, leaf=chol_leaf_, panel=inverse_panel):
    """ops/syrk.chol_blocked_syrk's factor of A (n a multiple of nb, as at
    n = 16384) rebuilt from the port's pieces: each ≤ 1024 leaf factored in
    place by `leaf`, each panel W ← W·D⁻ᵀ by `panel`, the trailing blocks
    updated by syrk_lower. Phase 11 holds it, as built, bitwise to
    chol_dense(fast=True); tools/fast_chol_variance.py swaps the pieces."""
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


def exact_residual(x, y, alpha, atoms=LAZY_ATOMS, s=LAZY_S):
    """‖y − (K + s²I)α‖/‖y‖ of the lazy tiers' system (atoms (family, nu,
    γ), κ = 1) in float64, the largest over the columns of a block; K·α by
    the plain matmat one row chunk at a time (never the kernels under
    test)."""
    n = x.shape[0]
    a64, y64 = alpha.double().reshape(n, -1), y.double().reshape(n, -1)
    r = y64 - s * s * a64
    for fam, nu, gamma in atoms:
        xs = x.double() / gamma
        r -= gram_matmat_plain(xs, xs, a64, 1.0, fam, nu)
    return float((torch.linalg.vector_norm(r, dim=0)
                  / torch.linalg.vector_norm(y64, dim=0)).max())


def profile_run(label, run, top=10, ops=LINALG_OPS):
    """Phase 10 (--profile): one warm call of `run` under torch.profiler.
    Prints the device busy time (union of all device activity), the device
    span, the idle share of that span, the host time until `run` returns
    (before the closing synchronize), the peak device memory of the call,
    the `top` kernels by device time, each hand kernel's time and launches,
    the device time of each stage in `ops` (by default the linalg ones,
    LINALG_OPS) and the count and host time of the CG loops' device-to-host
    scalar reads (HOST_READ_OPS). Returns (busy ms, span ms)."""
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
    # the matrix-free kernels by shape: the first template argument of
    # gram_matvec_kernel / gram_matmat_kernel is the shape code
    by_shape = {}
    for name, (t, c) in per_name.items():
        hit = (re.search(r"gram_mat(vec|mat)_kernel<(\d+)", name)
               or re.search(r"gram_mat(vec|mat)_kernelILi(\d+)E", name))
        if hit:
            key = f"gram_mat{hit.group(1)}[{SHAPES[int(hit.group(2)) // 4]}]"
            tt, cc = by_shape.get(key, (0.0, 0))
            by_shape[key] = (tt + t, cc + c)
    for key, (t, c) in sorted(by_shape.items()):
        print(f"    shape {key}: {t / 1e3!r} ms over {c} launches "
              f"({t / busy!r} of the busy time)")
    # device time of every kernel launched inside each linalg op of the path
    for avg in prof.key_averages():
        if avg.key in ops:
            print(f"    {avg.key}: {avg.device_time_total / 1e3!r} ms device "
                  f"over {avg.count} calls")
        if avg.key in HOST_READ_OPS:
            print(f"    {avg.key} (host reads): {avg.count} calls, "
                  f"{avg.cpu_time_total / 1e3!r} ms host")
    return busy / 1e3, span / 1e3


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
    its warm wall the median of 3. Then the fast factor on A without
    jitter: `rebuilt_fast_factor` as built, held bitwise to
    chol_dense(fast=True), its posterior errors and backward error printed
    (tools/fast_chol_variance.py swaps its pieces and sweeps the block
    size). Then the two factors alone on A by CUDA events, and the device
    memory each adds at its peak. Returns (per variant results, factor ms,
    peak GiB, the unjittered factor's errors)."""
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
    # the fast factor rebuilt from the port's pieces, on A without the
    # jitter safe_cholesky adds (the baseline of tools/fast_chol_variance.py)
    def as_built(A_):
        L = rebuilt_fast_factor(A_)
        assert torch.equal(L, linalg.chol_dense(A_, fast=True)), \
            "the rebuilt fast factor differs from chol_dense(fast=True)"
        return L

    unjittered = factor_errors(kernel, x, y, xt, as_built, mu64, var64)
    print(f"  no jitter, the fast factor rebuilt from its pieces (bitwise "
          f"chol_dense(fast=True)): mean rel err {unjittered['mean']!r}, var "
          f"rel err max {unjittered['var_max']!r} median "
          f"{unjittered['var_median']!r}; backward error "
          f"{unjittered['backward']!r}")
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
    return fast, factor_ms, peaks, unjittered


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
    shape (ν = 5/2, stage "entry": the launch floor) and, with its checks,
    at bench.py's 16384² (`stage_production_phase`) beside its bound, whose
    FP64 operations are counted from the compiled SASS (`stage_ops`) for
    gram_df_stages. Returns (probe results, launch counts, errors, times and
    bounds at 16384², name -> the record's further keys)."""
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

    # the toy shapes' times: what one launch costs where the work is
    # negligible (the launch floor)
    floor = {
        "gram_df_stages": (cuda_ms(
            lambda: df_entry_stage(sqh, sql, nu=2.5, stage="entry"),
            STAGE_FLOOR_REPS), tuple(sqh.shape)),
        "gram_df[stage]": (cuda_ms(
            lambda: gram_df_stage(xs, ys, 1.0, family="matern", nu=2.5,
                                  stage="entry"), STAGE_FLOOR_REPS), (n, m)),
    }
    funcs = sass_functions()
    for stage in ENTRY_STAGES:
        code = gram_df_stages.STAGE_CODES[stage]
        print(f"  SASS of gram_df_stages_kernel<3, {stage}> (Matérn-5/2): "
              "(FP64, 64-bit MUFU) instructions per entry "
              f"{stage_ops(funcs, 3, code)}")
    fp64, mufu = stage_ops(funcs, 3, gram_df_stages.STAGE_CODES["entry"])
    toy_bounds = {"gram_df_stages": stage_bound(sqh.numel(), 16 * sqh.numel(),
                                                fp64, mufu),
                  "gram_df[stage]": gram_bounds(n, m, d)["gram_df"]}
    t0 = time.perf_counter()
    times, bounds, full_err, stages_ms, big = stage_production_phase(
        dev, fp64, mufu)
    print(f"  the checks and timings at {big}x{big}: "
          f"{time.perf_counter() - t0!r} s")
    extra = {}
    for name, (k_ms, p_ms) in times.items():
        err[name] = max(err[name], full_err[name])
        share = bounds[name][0] / k_ms
        f_ms, f_shape = floor[name]
        extra[name] = {"share_of_bound": share, "launch_floor_ms": f_ms,
                       "launch_floor_shape": f_shape,
                       "launch_floor_bound_ms": toy_bounds[name][0]}
        print(f"  {name} at {big}x{big}: kernel {k_ms!r} ms, plain {p_ms!r} ms, "
              f"bound {bounds[name][0]!r} ms ({bounds[name][1]}), "
              f"{share * 100:.1f} % of it reached: "
              f"{'at least' if share >= 0.5 else 'BELOW'} half (rule 2); "
              f"launch floor {f_ms!r} ms at {f_shape} (bound there "
              f"{toy_bounds[name][0]!r} ms)")
    cross_ms = stages_ms["entry x'"]
    cross_share = bounds["gram_df[stage]"][0] / cross_ms
    extra["gram_df[stage]"] |= {"stages_ms": stages_ms,
                                "cross_share_of_bound": cross_share}
    print(f"  gram_df[stage] on K(x, x') (every tile computed): {cross_ms!r} "
          f"ms, {cross_share * 100:.1f} % of the bound: "
          f"{'at least' if cross_share >= 0.5 else 'BELOW'} half")
    return results, counts, err, times, bounds, extra


def stage_production_phase(dev, fp64, mufu):
    """Phase 12 at bench.py's 16384² (Matérn-5/2, the probe's γ):
    gram_df[stage] in every stage on K(x, x), the fit Gram's launch (lower
    half computed, mirrored), bitwise the same stage on K(x, x') with x' a
    copy of x (every tile computed: a cross Gram's launch; gram_df so in
    every shape code at n = STAGE_RAGGED_N too), "entry" bitwise
    the production gram_df; gram_df_stages in every stage on the "sq" pairs;
    each held to its plain version in row blocks and timed beside its
    bound; `fp64`, `mufu` are the stage kernel's SASS counts per entry
    (`stage_ops`). Returns (name -> (kernel ms, plain ms) on K(x, x), name
    -> bound, name -> max abs error, gram_df[stage]'s ms by stage on K(x, x),
    on K(x, x') ("entry x'") and the production gram_df's on both, n)."""
    x, _, _ = bench_data(dev)
    xs = scale_coords(x.double(), exp_r3_df_entry.G)
    xc = xs.clone()
    del x
    n, d = xs.shape
    kw = {"family": "matern", "nu": 2.5}
    err = {"gram_df_stages": 0.0, "gram_df[stage]": 0.0}
    worst = {"gram_df_stages": 0.0, "gram_df[stage]": 0.0}

    def hold(name, got, plain_rows):
        for r in range(0, n, STAGE_BLOCK):
            e, rel = pair_error((got[0][r:r + STAGE_BLOCK],
                                 got[1][r:r + STAGE_BLOCK]), plain_rows(r))
            assert rel <= STAGE_RTOL, (name, r, rel)
            err[name] = max(err[name], e)
            worst[name] = max(worst[name], rel)

    # the mirrored path where the edge cuts tiles, in every shape code
    xr = xs[:STAGE_RAGGED_N]
    for fam, nu in (*STAGE_FAMILIES, ("laplace", 1.5)):
        pairs = zip(gram_df_scaled(xr, xr, STAGE_KAPPA, fam, nu),
                    gram_df_scaled(xr, xr.clone(), STAGE_KAPPA, fam, nu))
        assert all(torch.equal(a, b) for a, b in pairs), \
            ("gram_df K(x, x) differs from K(x, x')", STAGE_RAGGED_N, fam, nu)
    for stage in GRAM_STAGES:
        out = gram_df_stage(xs, xs, 1.0, stage=stage, **kw)
        hold("gram_df[stage]", out, lambda r: gram_df_stage_plain(
            xs[r:r + STAGE_BLOCK], xs, 1.0, stage=stage, **kw))
        gh, gl = gram_df_stage(xs, xc, 1.0, stage=stage, **kw)
        assert torch.equal(gh, out[0]) and torch.equal(gl, out[1]), \
            ("K(x, x) from its lower half differs from K(x, x')", stage)
        del gh, gl
        if stage == "entry":
            ph, pl = gram_df_scaled(xs, xs, 1.0, "matern", 2.5)
            assert torch.equal(ph, out[0]) and torch.equal(pl, out[1]), \
                "stage entry differs from the production gram_df at 16384²"
            del ph, pl
        if stage == "sq":
            sqh, sql = out
        del out
    for stage in ENTRY_STAGES:
        out = df_entry_stage(sqh, sql, nu=2.5, stage=stage)
        hold("gram_df_stages", out, lambda r: df_entry_stage_plain(
            sqh[r:r + STAGE_BLOCK], sql[r:r + STAGE_BLOCK], nu=2.5,
            stage=stage))
        del out
    torch.cuda.empty_cache()
    print(f"  at {n}x{n} d={d} (bench.py's x over gamma "
          f"{exp_r3_df_entry.G}, Matérn-5/2): gram_df[stage] stages "
          f"{GRAM_STAGES} max abs err {err['gram_df[stage]']!r}, max rel err "
          f"{worst['gram_df[stage]']!r}; gram_df_stages stages {ENTRY_STAGES} "
          f"on its sq pairs max abs err {err['gram_df_stages']!r}, max rel err "
          f"{worst['gram_df_stages']!r} (bar {STAGE_RTOL}); every stage "
          "of K(x, x) bitwise equal to K(x, x'), stage entry to the "
          "production gram_df")

    times = {"gram_df_stages": timed_pair(
        lambda: df_entry_stage(sqh, sql, nu=2.5, stage="entry"),
        lambda: df_entry_stage_plain(sqh, sql, nu=2.5, stage="entry"),
        reps=STAGE_REPS, plain_reps=STAGE_PLAIN_REPS)}
    del sqh, sql
    torch.cuda.empty_cache()
    # every stage and the production launch in turns, forward then back,
    # between two timings of the plain entry
    runs = {stage: functools.partial(gram_df_stage, xs, xs, 1.0, stage=stage,
                                     **kw) for stage in GRAM_STAGES}
    runs["entry x'"] = functools.partial(gram_df_stage, xs, xc, 1.0,
                                         stage="entry", **kw)
    runs["gram_df"] = functools.partial(gram_df_scaled, xs, xs, 1.0,
                                        "matern", 2.5)
    runs["gram_df x'"] = functools.partial(gram_df_scaled, xs, xc, 1.0,
                                           "matern", 2.5)
    plain = functools.partial(gram_df_stage_plain, xs, xs, 1.0,
                              stage="entry", **kw)
    p_ms = cuda_ms(plain, STAGE_PLAIN_REPS)
    stages_ms = dict.fromkeys(runs, 0.0)
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            stages_ms[key] += cuda_ms(runs[key], STAGE_REPS) / 2
    p_ms = (p_ms + cuda_ms(plain, STAGE_PLAIN_REPS)) / 2
    times["gram_df[stage]"] = (stages_ms["entry"], p_ms)
    torch.cuda.empty_cache()

    entries = n * n
    bounds = {"gram_df_stages": stage_bound(entries, 16 * entries, fp64, mufu),
              "gram_df[stage]": gram_bounds(n, n, d)["gram_df"]}
    # the d-loop's DADD and DFMA per feature, the entry as the stage kernel
    # compiles it (less its input's DADD) and κ's DMUL: the FP64
    # instructions as compiled, beside the bound's count of 3d + 10
    compiled_ms = entries * (2 * d + fp64) / F64_INSTR * 1e3
    print(f"  gram_df[stage] at {n}x{n}: ms by stage {stages_ms} (on "
          "K(x, x), x' a copy of x; gram_df: the production launch); bound "
          f"{bounds['gram_df[stage]'][0]!r} ms "
          f"({bounds['gram_df[stage]'][1]}) for every stage (the same "
          f"bytes); the FP64 instructions as compiled over {F64_INSTR:.3g}/s "
          f"{compiled_ms!r} ms")
    return times, bounds, err, stages_ms, n


def atom_k64(x64, fam, gamma, kappa, deriv=None, nu=1.5):
    """One atom of the lazy tiers' kernels in float64 on the card, by plain
    torch ops (no port code), one (n, n) buffer and at most two more:
    κ·K (deriv None), ∂(κK)/∂γ for a scalar γ (deriv "gamma"), or
    ∂(κK)/∂γ_c for an ARD γ (deriv = c). SE: K = e^{−sq/2}, ∂K/∂γ = K·sq/γ,
    ∂K/∂γ_c = K·(x_c − y_c)²/γ_c³; Matérn-3/2: K = (1 + √3ρ)e^{−√3ρ},
    ∂K/∂γ = 3ρ²e^{−√3ρ}/γ; Matérn-5/2 (nu 2.5): K = (1 + √5ρ + 5ρ²/3)
    e^{−√5ρ}, ∂K/∂γ = (5/3)ρ²(1 + √5ρ)e^{−√5ρ}/γ (sq = ρ² the scaled
    squared distance); Laplace: K = e^{−u}, u = ‖·‖₁/γ², ∂K/∂γ = 2uK/γ."""
    if fam == "laplace":
        u = torch.cdist(x64, x64, p=1).div_(gamma * gamma)
        K = torch.exp(-u).mul_(kappa)
        return K.mul_(u).mul_(2.0 / gamma) if deriv == "gamma" else K
    g = torch.as_tensor(gamma, dtype=torch.float64, device=x64.device)
    xs = x64 / g
    n2 = (xs * xs).sum(1)
    sq = xs @ xs.T
    sq.mul_(-2.0).add_(n2[:, None]).add_(n2[None, :]).clamp_min_(0.0)
    if fam == "se":
        if deriv == "gamma":
            out = torch.exp(-0.5 * sq).mul_(sq).mul_(kappa / float(g))
            del sq
            return out
        K = sq.mul_(-0.5).exp_().mul_(kappa)
        if deriv is None:
            return K
        c = int(deriv)
        xc = x64[:, c]
        return K.mul_((xc[:, None] - xc[None, :]).square_()).div_(
            float(g[c]) ** 3)
    rho = sq.sqrt_()
    if nu == 2.5:
        r = rho.mul_(math.sqrt(5.0))                        # √5ρ
        e = torch.exp(-r)
        if deriv == "gamma":
            out = r * r
            return out.mul_(r.add_(1.0)).mul_(e).mul_(
                kappa / (3.0 * float(g)))
        return (r * r).div_(3.0).add_(r).add_(1.0).mul_(e).mul_(kappa)
    e = torch.exp(-math.sqrt(3.0) * rho)
    if deriv == "gamma":
        return rho.square_().mul_(e).mul_(3.0 * kappa / float(g))
    return rho.mul_(math.sqrt(3.0)).add_(1.0).mul_(e).mul_(kappa)


def dense_evidence(x, y, atoms, s, probes):
    """The exact NLL, log det A and, per hyperparameter (each atom's γ, or
    γ_c per dim for an ARD γ, then its κ; last σ), (label, −½αᵀ∂Aα,
    ½tr(A⁻¹∂A), the standard deviation of the port's estimator of
    ½tr(A⁻¹∂A) over `probes` Rademacher probes), in float64 on the card
    from the Cholesky of A = Σ κ_a K_a + σ²I (`dense_evidence_parts`). For
    B = A⁻¹∂A that deviation is ½·√(Var(zᵀBz)/p), Var(zᵀBz) =
    ½Σᵢ≠ⱼ(Bᵢⱼ + Bⱼᵢ)². About 4 (n, n) float64 buffers at a time (35 GB at
    n = 32768)."""
    x64 = x.double()

    def kernel_part():
        A = None
        for fam, gamma, kappa in atoms:
            Ka = atom_k64(x64, fam, gamma, kappa)
            A = Ka if A is None else A.add_(Ka)
            del Ka
        return A

    params = []
    for a, (fam, gamma, kappa) in enumerate(atoms):
        dims = ["gamma"] if np.ndim(gamma) == 0 else list(range(len(gamma)))
        for c in dims:
            params.append((f"gamma{a}" + ("" if c == "gamma" else f"[{c}]"),
                           lambda fam=fam, gamma=gamma, kappa=kappa, c=c:
                           atom_k64(x64, fam, gamma, kappa, c)))
        params.append((f"kappa{a}", lambda fam=fam, gamma=gamma:
                       atom_k64(x64, fam, gamma, 1.0)))
    return dense_evidence_parts(x, y, s, probes, kernel_part, params)


def port_quads(kernel, x, y, atoms, s):
    """The port's quadratic parts −½αᵀ∂Aα, α from IterativeGP(lazy=True)'s
    CG (the evidence body's solve): γ by `bbmm._atom_quad_gamma` ("dk_sq"
    for a scalar γ, "dk" for ARD), κ by gram_matvec, σ as −σαᵀα."""
    gp = IterativeGP(kernel, s=s, lazy=True)
    gp.fit_gp(x, y)
    alpha = gp.A[:, 0]
    out = []
    for fam, gamma, _ in atoms:
        g = (torch.tensor(gamma, dtype=torch.float32, device=x.device)
             if np.ndim(gamma) else gamma)
        q = bbmm._atom_quad_gamma(x, alpha, g, 1.0, fam, 1.5)
        out += [float(t) for t in q.reshape(-1)]
        out.append(float(-0.5 * alpha @ gram_matvec(
            x, x, alpha, family=fam, gamma=g, kappa=1.0, nu=1.5)))
    out.append(float(-s * alpha @ alpha))
    return out, gp.fit_status


def flat_grads(g):
    out = []
    for ga, ka in zip(g["gammas"], g["kappas"]):
        out += [float(t) for t in ga.reshape(-1)] + [float(ka)]
    return out + [float(g["noise"])]


def evidence_check(label, kernel, x, y, atoms, desc, gammas, hold_nll=True):
    """Phase 13.1 / 13.4: `evidence_value_and_grad_sum` on the card (64
    probes, alpha and probe CG at 1e-6, rank-512 preconditioner) against
    `dense_evidence`, the quadratic parts (`port_quads`) too, the SLQ
    log-determinant at EVIDENCE_LANCZOS steps, and with `hold_nll` the NLL;
    the probes drawn on the card. Returns
    (rows of (name, port g, dense g, bar), NLL pair, wall, launches)."""
    (nll, grads), wall, counts = counted(lambda: evidence_value_and_grad_sum(
        x, y, desc, gammas, [1.0] * len(desc), LAZY_S,
        probes=EVIDENCE_PROBES, lanczos_iters=EVIDENCE_LANCZOS, cg_tol=1e-6,
        cg_maxiter=500, probe_tol=1e-6, probe_maxiter=500, precond_rank=512,
        generator=torch.Generator(device=x.device).manual_seed(13)))
    quads, status = port_quads(kernel, x, y, atoms, LAZY_S)
    fast = fast_atoms(kernel)
    gk = [atom_params(kernel, a) for a in fast]
    mm = make_sum_matmat(x, fast, [g for g, _ in gk], [k for _, k in gk],
                         noise=LAZY_S)
    slq = {it: slq_logdet(None, x.shape[0], probes=EVIDENCE_PROBES,
                          lanczos_iters=it, dtype=x.dtype, device=x.device,
                          matmat=mm, generator=torch.Generator(
                              device=x.device).manual_seed(14))
           for it in (30, EVIDENCE_LANCZOS)}
    slq_se = {it: float(v.double().std()) / math.sqrt(EVIDENCE_PROBES)
              for it, (_, v) in slq.items()}
    slq = {it: float(ld) for it, (ld, _) in slq.items()}
    t0 = time.perf_counter()
    nll64, logdet64, exact = dense_evidence(x, y, atoms, LAZY_S,
                                            EVIDENCE_PROBES)
    print(f"  {label}: evidence {wall!r} s (launches {counts}); dense float64 "
          f"reference {time.perf_counter() - t0!r} s; α's CG {status}")
    rows = []
    for (name, quad, half_tr, std), g, q in zip(exact, flat_grads(grads), quads):
        g64 = quad + half_tr
        bar = HUTCH_SIGMAS * std + GRAD_RTOL * abs(g64)
        q_rel = abs(q - quad) / abs(quad)
        print(f"    {name}: gradient {g!r} against {g64!r} (|Δ| "
              f"{abs(g - g64)!r}, bar {bar!r} = {HUTCH_SIGMAS}·{std!r} + "
              f"{GRAD_RTOL}·|g|); quadratic part {q!r} against {quad!r} "
              f"(rel {q_rel!r}, bar {QUAD_RTOL})")
        assert abs(g - g64) <= bar, (label, name, g, g64, bar)
        assert q_rel <= QUAD_RTOL, (label, name, q, quad)
        rows.append((name, g, g64, bar))
    nll_rel = abs(float(nll) - nll64) / abs(nll64)
    print(f"    NLL by SLQ {float(nll)!r} against {nll64!r} (rel {nll_rel!r}, "
          + (f"bar {NLL_RTOL}" if hold_nll else "not held")
          + f"); log det A by SLQ, {EVIDENCE_PROBES} probes: "
          + ", ".join(f"{it} Lanczos steps {ld!r} (rel err "
                      f"{abs(ld - logdet64) / abs(logdet64)!r}, the probes' "
                      f"standard error {slq_se[it]!r})"
                      for it, ld in slq.items())
          + f", exact {logdet64!r} (bar at {EVIDENCE_LANCZOS} steps "
          f"{LOGDET_RTOL})")
    assert nll_rel <= NLL_RTOL or not hold_nll, (label, float(nll), nll64)
    ld_rel = abs(slq[EVIDENCE_LANCZOS] - logdet64) / abs(logdet64)
    assert ld_rel <= LOGDET_RTOL, (label, slq[EVIDENCE_LANCZOS], logdet64)
    return rows, (float(nll), nll64), wall, counts


def hyperfit_data(dev):
    """benchmarks/exp_lazy_hyperfit.py:22-28: x ~ U(-1, 1)^(65536 × 4) in
    f32, y = sin(3x₀) + cos(2x₁) + 0.1ε, numpy seed 0."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (LAZY_BIG_N, HYPERFIT_D)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + np.cos(2 * x[:, 1])
         + 0.1 * rng.standard_normal(LAZY_BIG_N)).astype(np.float32)
    return torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)


def hyperfit_phase(dev):
    """Phase 13.2: fit_evidence_lazy on exp_lazy_hyperfit.py's workload with
    final_value=True, the launch counters zeroed just before and read just
    after; σ̂ in HYPERFIT_S, no closing-SLQ error, and the final NLL under
    the NLL at (γ₀, σ₀) by SLQ on the same generator
    (`bbmm.step_generator(0, 0, dev)`). Returns (data, fit, wall, counts,
    start NLL)."""
    x, y = hyperfit_data(dev)
    fit, wall, counts = counted(lambda: fit_evidence_lazy(
        x, y, final_value=True, seed=0, **HYPERFIT))
    kw = {k: HYPERFIT[k] for k in ("probes", "cg_tol", "cg_maxiter",
                                   "probe_tol", "probe_maxiter",
                                   "precond_rank")}
    nll0, _ = evidence_value_and_grad_lazy(
        x, y, HYPERFIT["gamma0"], 1.0, HYPERFIT["noise0"], compute_value=True,
        generator=bbmm.step_generator(0, 0, dev), **kw)
    shapes = {k: c for k, c in counts.items() if k.startswith("gram_mat")}
    print(f"  fit_evidence_lazy, n = {LAZY_BIG_N}, d = {HYPERFIT_D}, SE: "
          f"{wall!r} s for {fit['steps_run']} steps (with the closing SLQ), "
          f"{wall / fit['steps_run']!r} s a step; γ̂ {fit['gamma']!r}, σ̂ "
          f"{fit['noise']!r} (the reference's TPU fit: {TPU_HYPERFIT}); NLL "
          f"{fit['nll']!r} against {float(nll0)!r} at (γ₀, σ₀); nll_error "
          f"{fit['nll_error']}; history {fit['history']}; launches {shapes}")
    assert fit["nll_error"] is None, fit["nll_error"]
    assert HYPERFIT_S[0] <= fit["noise"] <= HYPERFIT_S[1], fit["noise"]
    assert fit["nll"] < float(nll0), (fit["nll"], float(nll0))
    assert counts["gram_matvec[dk_sq]"] > 0 and counts["gram_matmat[dk_sq]"] > 0, counts
    return (x, y), fit, wall, counts, float(nll0)


def optimize_phase(gp, x, y):
    """Phase 13.3: IterativeGP.optimize_params (OPTIMIZE_STEPS steps of
    `fit_evidence_sum` over the SE + Matérn-3/2 atoms, the model's rank-2048
    preconditioner) on phase 9's fitted GP, counted; the fitted γ_a and σ
    written back, and the refit's float64 residual under the fitted values
    at most LAZY_RESIDUAL_MAX. Returns (out, wall, counts, residual)."""
    before = [float(gp.kernel_object.params_dict[str(i)]["gamma"])
              for i in range(2)]
    s0 = gp.s
    out, wall, counts = counted(lambda: gp.optimize_params(
        steps=OPTIMIZE_STEPS))
    after = [float(gp.kernel_object.params_dict[str(i)]["gamma"])
             for i in range(2)]
    atoms = [(fam, nu, g) for (fam, nu, _), g in zip(LAZY_ATOMS, after)]
    resid = exact_residual(x, y, gp.A, atoms, gp.s)
    print(f"  optimize_params({OPTIMIZE_STEPS} steps), n = {LAZY_BIG_N}: "
          f"{wall!r} s with the refit; γ {before} -> {after}, σ {s0!r} -> "
          f"{gp.s!r}; refit {gp.fit_status}; exact relative residual under "
          f"the fitted values (float64) {resid!r} (bar {LAZY_RESIDUAL_MAX}); "
          f"launches {counts}")
    assert out["steps_run"] == OPTIMIZE_STEPS, out
    assert after == [float(g) for g in out["gammas"]] and gp.s == out["noise"]
    assert after != before and gp.s != s0
    assert resid <= LAZY_RESIDUAL_MAX, resid
    assert counts["gram_matvec[dk_sq]"] > 0 and counts["gram_matmat[dk_sq]"] > 0, counts
    return out, wall, counts, resid


def config1_data():
    """benchmarks/run_all.py:70-73: x ~ U(-1, 1)^(1024 × 1), y = sin 4x +
    0.05ε, numpy seed 0 (float64 numpy; each GP converts to its dtype)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (CONFIG1_N, 1))
    return x, np.sin(4 * x) + 0.05 * rng.standard_normal((CONFIG1_N, 1))


def float64_gp(x, y, **kw):
    """A GaussianProcess in float64 on the CPU (the plain Gram), fitted."""
    gp = GaussianProcess(device="cpu", dtype=torch.float64, **kw)
    gp.fit_gp(x, y)
    return gp


def evidence_and_grad(gp, gamma):
    """The negative log evidence of `gp` at the bandwidth γ and its
    derivative in log γ (float64 values)."""
    t = torch.tensor(math.log(gamma), dtype=torch.float64, device=gp.device,
                     requires_grad=True)
    f = gp.log_marginal_params(gp.kernel_object,
                               {"0": {"gamma": torch.exp(t)}}, gp.s)
    (g,) = torch.autograd.grad(f, t)
    return float(f.detach()), float(g)


def evidence_scales(x, gamma, s, y, laplace):
    """EVIDENCE_CHECK's two scales, float64 on the CPU: Σ|Ḡ|∘|K|(1 + P)
    and Σ|Ḡ|∘(|K| + |∂K/∂log γ|)(1 + P), |Ḡ| = ½(|A⁻¹| + |α||α|ᵀ)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    xs = x / gamma
    P = (xs.abs().sum(1)[:, None] + xs.abs().sum(1)[None, :]) ** 2
    if laplace:
        u = torch.cdist(x, x, p=1) / gamma ** 2
        K, dK = torch.exp(-u), 2 * u * torch.exp(-u)
    else:
        sq = torch.cdist(xs, xs) ** 2
        K, dK = torch.exp(-0.5 * sq), sq * torch.exp(-0.5 * sq)
    A = K + s * s * torch.eye(len(x), dtype=torch.float64)
    Ai = torch.linalg.inv(A)
    a = (Ai @ torch.as_tensor(y, dtype=torch.float64)).abs()
    G = 0.5 * (Ai.abs() + a @ a.T) * (1 + P)
    return float((G * K).sum()), float((G * (K + dK)).sum())


def gram_fn_scales(x, y, t, kappa, W, v, laplace, fam="se", nu=1.5):
    """Per quantity of `gram_fn_check`, the sum of the absolute values of
    its terms, float64, with P_c = (|x̃ᵢc| + |ỹⱼc|)² in place of sq_c where
    the backward forms it by a difference (x̄s = 2(rowsum(W)x̃ − W·ỹ)):
    ∂K/∂t_c = −2k'(sq)·sq_c (SE: K·sq_c), ∂²K/∂t_c∂t_c' = K(sq_c sq_c' −
    2δ sq_c) (SE); Laplace: ∂K/∂t = 2uK, ∂²K/∂t² = (4u² − 4u)K, u = D/γ²."""
    x, y, t, W = x.double(), y.double(), t.double(), W.double().abs()
    g = torch.exp(t)
    if laplace:
        u = torch.cdist(x, y, p=1) / g ** 2
        K = kappa * torch.exp(-u)
        WK = W * K
        return {"value": float(WK.sum()), "kappa": float(WK.sum() / kappa),
                "t": (2 * WK * u).sum().reshape(1),
                "hvp": (WK * (4 * u * u + 4 * u)).sum().reshape(1)
                * v.double().abs()}
    xs, ys = (x / g).abs(), (y / g).abs()
    K, slope = shape_and_slope(torch.cdist(x / g, y / g).square_(), fam, nu)
    WK = W * K.mul_(kappa)
    WS = W * slope.abs_().mul_(2.0 * kappa)                 # SE: WS = WK
    del K, slope

    def P(c):
        return (xs[:, c, None] + ys[None, :, c]) ** 2

    Ps = ([sum(P(c) for c in range(x.shape[1]))] if t.numel() == 1
          else [P(c) for c in range(x.shape[1])])
    out = {"value": float(WK.sum()), "kappa": float(WK.sum() / kappa),
           "t": torch.stack([(WS * Pc).sum() for Pc in Ps])}
    if fam == "se":
        av = v.double().abs()
        Pv = sum(a * Pc for a, Pc in zip(av, Ps))
        out["hvp"] = torch.stack([(WK * Pc * (Pv + 2 * a)).sum()
                                  for a, Pc in zip(av, Ps)])
    return out


def gram_fn_check(label, x, gamma, laplace, seed, y=None, fam="se", nu=1.5):
    """The hand Gram (`gram`: `_Gram` of `fam`, or `_GramL1` where
    `laplace`) at x × y (y = x where None; f32 on the card) and γ, see the
    note above EVIDENCE_ULPS: its entries against the plain version in f32
    and float64 (`gram_l1_check`, `scaled_gram_check`), then its Function's
    gradient of Σ W∘K in t = log γ and κ and, for SE and Laplace, the
    second derivative in t along v against float64 autograd of the plain
    version, each within 2·matvec_rtol(m) of its scale (`gram_fn_scales`)
    for m columns. Returns the largest error over scale."""
    dev = x.device
    y = x if y is None else y
    f32 = dict(dtype=torch.float32, device=dev)
    n, m = x.shape[0], y.shape[0]
    g = torch.as_tensor(gamma, **f32)
    fam = "laplace" if laplace else fam
    with torch.no_grad():
        if laplace:
            gram_l1_check(label, x, y, float(g))
        else:
            scaled_gram_check(label, x / g, y / g, fam, nu)
    second = fam in ("se", "laplace")

    rng = np.random.default_rng(seed)
    W = torch.as_tensor(rng.uniform(0, 1, (n, m)), **f32)
    v = torch.as_tensor(rng.standard_normal(g.numel()), **f32)
    kappa = 1.3

    def derivatives(dtype, plain):
        xd, yd = x.to(dtype), y.to(dtype)
        t = torch.log(g.to(dtype)).clone().requires_grad_()
        k = torch.tensor(kappa, dtype=dtype, device=dev, requires_grad=True)
        gt = torch.exp(t)
        if not plain:
            K = gram(xd, yd, family=fam, gamma=gt, kappa=k, nu=nu)
        elif laplace:
            K = gram_l1_plain(xd, yd, 1.0 / (gt * gt), k)
        else:
            K = gram_plain(xd / gt, yd / gt, k, fam, nu)
        L = (W.to(dtype) * K).sum()
        del K
        d_t, d_k = torch.autograd.grad(L, (t, k), create_graph=second)
        out = {"value": float(L.detach()), "kappa": float(d_k.detach()),
               "t": d_t.detach().double().reshape(-1)}
        if second:
            (h,) = torch.autograd.grad((d_t * v.to(dtype)).sum(), t)
            out["hvp"] = h.double().reshape(-1)
        return out

    got = derivatives(torch.float32, plain=False)
    want = derivatives(torch.float64, plain=True)
    scales = gram_fn_scales(x, y, torch.log(g), kappa, W, v, laplace, fam,
                            nu)
    del W
    torch.cuda.empty_cache()
    bar = 2 * matvec_rtol(m)
    errs = {}
    for q in got:
        d = torch.as_tensor(got[q], dtype=torch.float64) - torch.as_tensor(
            want[q], dtype=torch.float64)
        errs[q] = float((d.abs().cpu() / torch.as_tensor(
            scales[q], dtype=torch.float64).cpu()).max())
    print(f"  {label}: Σ W∘K and its derivatives on f32 against float64 "
          f"autograd, max err / scale: " + ", ".join(
              f"{q} {e!r}" for q, e in errs.items()) + f" (bar {bar!r})")
    assert max(errs.values()) <= bar, (label, errs)
    return max(errs.values())


def exact_hyperfit_phase(dev, kernel_name):
    """14.1 / 14.2: config 1's fit on the card with `kernel_name`: a warm-up
    fit, then CONFIG1_REPS cold fits, each on a fresh GP, their
    optimize_params timed and counted; the same fit in float64 on the CPU;
    the evidence and its gradient at the fitted γ against float64; the hand
    Gram and its Function at that γ (`gram_fn_check`). Returns (the last
    fit's GP, record)."""
    x, y = config1_data()
    laplace = kernel_name == "laplace"

    def cold_fit():
        gp = GaussianProcess(kernel_name=kernel_name, device=dev, **CONFIG1_GP)
        gp.fit_gp(x, y)
        return gp, *counted(lambda: gp.optimize_params(**CONFIG1_FIT))[1:]

    _, first_s, _ = cold_fit()
    fits = [cold_fit() for _ in range(CONFIG1_REPS)]
    gp, _, counts = fits[-1]
    walls = [w for _, w, _ in fits]
    gammas = [float(f[0].kernel_object.params_dict["0"]["gamma"]) for f in fits]
    kernel = "gram_l1" if laplace else "gram"
    launches = [c[kernel] for _, _, c in fits]
    gamma = gammas[-1]
    hm = gp.hyperopt_metrics
    t0 = time.perf_counter()
    ref = float64_gp(x, y, kernel_name=kernel_name, **CONFIG1_GP)
    ref.optimize_params(**CONFIG1_FIT)
    ref_s = time.perf_counter() - t0
    gamma64 = float(ref.kernel_object.params_dict["0"]["gamma"])
    ev = evidence_and_grad(ref, gamma)[0]
    ev64 = evidence_and_grad(ref, gamma64)[0]
    rel_gamma = abs(gamma - gamma64) / gamma64
    rel_ev = abs(ev - ev64) / abs(ev64)
    # the card's evidence and gradient against the float64 model's, at the
    # fitted γ and at the start, where the gradient is far from 0
    evid = {}
    for at in (gamma, CONFIG1_GP["gamma"]):
        sf, sg = (EVIDENCE_ULPS * 2.0 ** -24 * v for v in evidence_scales(
            x, at, CONFIG1_GP["s"], y, laplace))
        evid[at] = (*evidence_and_grad(gp, at), *evidence_and_grad(ref, at),
                    sf, sg)
    q1, q3 = np.percentile(walls, [25, 75])
    out = {"wall_s": float(np.median(walls)), "wall_iqr_s": float(q3 - q1),
           "walls_s": walls, "warmup_s": first_s, "gamma": gamma,
           "gammas": gammas, "gamma64": gamma64, "gamma_rel_err": rel_gamma,
           "evidence64_at_gamma": ev, "evidence64_at_gamma64": ev64,
           "evidence_rel_err": rel_ev, "route": hm["route"],
           "iterations": hm["iterations"].tolist(),
           "converged": hm["converged"].tolist(),
           "launches_per_fit": launches[-1], "reference_s": ref_s,
           "evidence_card_f64_bar_grad_card_f64_bar": {
               str(k): v for k, v in evid.items()}}
    print(f"  {kernel_name}: warm-up fit {first_s!r} s; {CONFIG1_REPS} cold "
          f"fits (fresh GP from γ = 1) median {out['wall_s']!r} s, IQR "
          f"{out['wall_iqr_s']!r} s; route {hm['route']}; γ {gamma!r} (the "
          f"{CONFIG1_REPS} fits: {gammas}) against the float64 fit's "
          f"{gamma64!r} (rel {rel_gamma!r}, bar {FIT_GAMMA_RTOL}); float64 "
          f"evidence there {ev!r} against {ev64!r} (rel {rel_ev!r}, bar "
          f"{FIT_EVIDENCE_RTOL}); iterations {out['iterations']}, converged "
          f"{out['converged']}; {kernel} launches per fit {launches} (all "
          f"{counts}); the float64 CPU fit {ref_s!r} s")
    for at, (f_card, g_card, f_ref, g_ref, sf, sg) in evid.items():
        print(f"  {kernel_name}: at γ = {at!r}, the card's evidence "
              f"{f_card!r} against float64's {f_ref!r} (|Δ| "
              f"{abs(f_card - f_ref)!r}, bar {sf!r}); its derivative in "
              f"log γ {g_card!r} against {g_ref!r} (|Δ| "
              f"{abs(g_card - g_ref)!r}, bar {sg!r})")
    assert all(c > 0 for c in launches), launches
    assert rel_gamma <= FIT_GAMMA_RTOL, (gamma, gamma64)
    assert rel_ev <= FIT_EVIDENCE_RTOL, (ev, ev64)
    for f_card, g_card, f_ref, g_ref, sf, sg in evid.values():
        assert abs(f_card - f_ref) <= sf, (f_card, f_ref, sf)
        assert abs(g_card - g_ref) <= sg, (g_card, g_ref, sg)
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    out["function_max_err_over_scale"] = gram_fn_check(
        f"{kernel_name} at γ", xd, gamma, laplace, seed=7)
    return gp, out


def ard_fit_phase(dev):
    """14.3: an ARD SE bandwidth+noise fit on the first ARD_FIT_N rows of
    the bench data; the float64 evidence and its gradient in the raw (log)
    parameters, on the CPU, at the start and at the fit; then `gram_fn_check`
    at the fitted γ."""
    x, y, _ = bench_data(dev)
    x, y = x[:ARD_FIT_N], y[:ARD_FIT_N]
    gp = GaussianProcess(kernel=KernelFunction(
        kernel_name="ard", ard_gamma=[1.0] * D, d=D, device=dev),
        s=ARD_FIT_S0)
    gp.fit_gp(x, y)
    ref = GaussianProcess(kernel=KernelFunction(
        kernel_name="ard", d=D, device="cpu", dtype=torch.float64), s=1.0)
    ref.load_data((x.cpu(), y.cpu()))

    def value_and_grad64(gammas, s):
        raw = torch.log(torch.tensor([*gammas, s], dtype=torch.float64))
        raw.requires_grad_()
        f = ref.log_marginal_params(
            ref.kernel_object, {"0": {"ard_gamma": torch.exp(raw[:D])}},
            torch.exp(raw[D]))
        (g,) = torch.autograd.grad(f, raw)
        return float(f.detach()), float(torch.linalg.vector_norm(g))

    f0, g0 = value_and_grad64([1.0] * D, ARD_FIT_S0)
    _, wall, counts = counted(lambda: gp.optimize_params(**ARD_FIT))
    gammas = gp.kernel_object.params_dict["0"]["ard_gamma"].tolist()
    f1, g1 = value_and_grad64(gammas, gp.s)
    hm = gp.hyperopt_metrics
    out = {"wall_s": wall, "route": hm["route"],
           "iterations": hm["iterations"].tolist(),
           "converged": hm["converged"].tolist(), "ard_gamma": gammas,
           "noise": gp.s, "evidence64_start": f0, "evidence64_fit": f1,
           "grad64_norm_start": g0, "grad64_norm_fit": g1,
           "launches": counts["gram"]}
    print(f"  ARD SE, n = {ARD_FIT_N}, d = {D}, {ARD_FIT}: {wall!r} s, route "
          f"{hm['route']}, iterations {out['iterations']}, converged "
          f"{out['converged']}; γ {gammas}, s {gp.s!r}; float64 evidence "
          f"{f0!r} -> {f1!r}, its gradient's norm in the raw parameters "
          f"{g0!r} -> {g1!r} (ratio {g1 / g0!r}, bar {ARD_GRAD_CUT}); gram "
          f"launches {counts['gram']}")
    assert hm["route"] == "batched", hm["route"]
    assert f1 < f0, (f0, f1)
    assert g1 <= ARD_GRAD_CUT * g0, (g0, g1)
    assert counts["gram"] > 0, counts
    del gp
    torch.cuda.empty_cache()
    out["function_max_err_over_scale"] = gram_fn_check(
        "ARD SE at the fitted γ", x, gammas, False, seed=8)
    torch.cuda.empty_cache()
    return out


def sample_phase(gp, dev):
    """14.4: sample, log_probability and log_marginal on 14.1's fitted GP
    (see the notes above SAMPLE_T and LOGPROB_POINTS), against float64 on
    the CPU at the card's γ."""
    x, y = config1_data()
    gamma = float(gp.kernel_object.params_dict["0"]["gamma"])
    gp64 = float64_gp(x, y, **{**CONFIG1_GP, "gamma": gamma})
    xt = torch.linspace(-1, 1, SAMPLE_T, device=dev)[:, None]
    gen = torch.Generator(device=dev).manual_seed(0)
    draws, wall, counts = counted(lambda: gp.sample(
        xt, size=SAMPLE_DRAWS, jitter=SAMPLE_JITTER, generator=gen))
    assert draws.shape == (SAMPLE_T, SAMPLE_DRAWS), draws.shape
    assert bool(torch.isfinite(draws).all())
    # what sample factored: the same moments, the same ladder
    mu, cov = gp._moments64(xt)
    res = linalg.safe_cholesky(cov.clone(), jitter=SAMPLE_JITTER)
    C = res.L @ res.L.T
    mean_var = float(cov.diagonal().mean())
    n = SAMPLE_DRAWS
    d64 = draws.double()
    xbar = d64.mean(dim=1, keepdim=True)
    S = (d64 - xbar) @ (d64 - xbar).T / (n - 1)
    tr, fro = float(torch.trace(C)), float(torch.linalg.matrix_norm(C))
    mean_err = float(torch.linalg.vector_norm(xbar - mu))
    mean_se = math.sqrt(tr / n)
    cov_err = float(torch.linalg.matrix_norm(S - C))
    cov_se = math.sqrt((fro ** 2 + tr ** 2) / n)
    _, cov64 = gp64.mean_std(xt.cpu().double(), full=True)
    cov_rel = float(torch.linalg.matrix_norm(cov.cpu() - cov64)
                    / torch.linalg.matrix_norm(cov64))
    _, cov32 = gp.mean_std(xt, full=True)
    eig32 = float(torch.linalg.eigvalsh(cov32.double()).min())
    # log_probability at LOGPROB_POINTS spread points
    idx = torch.arange(0, SAMPLE_T, SAMPLE_T // LOGPROB_POINTS, device=dev)
    xs, draw = xt[idx], draws[idx, 0]
    lp = gp.log_probability(xs, draw)
    mu8, cov8 = gp._moments64(xs)
    r8 = linalg.safe_cholesky(cov8.clone())
    A = cov8 + float(r8.jitter) * torch.eye(len(idx), dtype=torch.float64,
                                            device=dev)
    diff = draw.double()[:, None] - mu8
    L8 = torch.linalg.cholesky(A)
    lp_same = float(-0.5 * (diff.T @ torch.cholesky_solve(diff, L8))[0, 0]
                    - torch.log(torch.diagonal(L8)).sum()
                    - 0.5 * len(idx) * math.log(2 * math.pi))
    lp64 = gp64.log_probability(xs.cpu().double(), draw.cpu().double())
    lm = float(gp.log_marginal(gp.kernel_object, {}))
    lm64 = float(gp64.log_marginal(gp64.kernel_object, {}))
    out = {"sample_s": wall, "mean_err": mean_err,
           "mean_bar": SAMPLE_SE * mean_se, "cov_frobenius_err": cov_err,
           "cov_bar": SAMPLE_SE * cov_se, "ladder_jitter": float(res.jitter),
           "mean_variance": mean_var, "cov_rel_err_vs_f64": cov_rel,
           "f32_cov_eig_min": eig32, "log_probability": lp,
           "log_probability_f64_same_moments": lp_same,
           "log_probability_f64_posterior": lp64, "log_marginal": lm,
           "log_marginal_f64": lm64, "launches": counts["gram_df"]}
    print(f"  sample: {SAMPLE_DRAWS} draws at {SAMPLE_T} points in {wall!r} s "
          f"(gram_df launches {counts['gram_df']}); ladder jitter "
          f"{float(res.jitter)!r} against the mean variance {mean_var!r} "
          f"(bar {SAMPLE_JITTER_MAX} of it; mean_std(full=True)'s f32 "
          f"covariance has least eigenvalue {eig32!r}); |x̄ − μ| "
          f"{mean_err!r} (bar {SAMPLE_SE} × {mean_se!r}), ‖S − L Lᵀ‖_F "
          f"{cov_err!r} (bar {SAMPLE_SE} × {cov_se!r}); the covariance "
          f"against the float64 model's, rel Frobenius {cov_rel!r} (bar "
          f"{SAMPLE_COV_RTOL})")
    print(f"  log_probability at {len(idx)} points: {lp!r}; float64 on the "
          f"same moments {lp_same!r} (rel {abs(lp - lp_same) / abs(lp_same)!r}, "
          f"bar {LOGPROB_RTOL}); the float64 posterior's {lp64!r} (rel "
          f"{abs(lp - lp64) / abs(lp64)!r}, bar {LOGPROB_F32_RTOL}); "
          f"log_marginal {lm!r} against float64 {lm64!r} (rel "
          f"{abs(lm - lm64) / abs(lm64)!r}, bar {LOG_MARGINAL_RTOL})")
    # gram_df where sample launches it: K(x**, x) and K(x**, x**)
    xs64 = xt.double() / gamma
    for label, ys64 in (("x", gp.x.double() / gamma), ("x**", xs64)):
        hi, lo = gram_df_scaled(xs64, ys64, 1.0, "se", 1.0)
        hp, lp_ = gram_df_plain(xs64, ys64, 1.0, "se", 1.0)
        ref_df = hp.double() + lp_.double()
        rel = float(((hi.double() + lo.double() - ref_df).abs()
                     / ref_df.abs().clamp_min(1e-300)).max())
        print(f"  gram_df K(x**, {label}) {tuple(ref_df.shape)}: max rel err "
              f"{rel!r} (bar {GRAM_DF_RTOL})")
        assert rel <= GRAM_DF_RTOL, (label, rel)
    assert counts["gram_df"] > 0, counts
    assert float(res.jitter) <= SAMPLE_JITTER_MAX * mean_var, res.jitter
    assert mean_err <= SAMPLE_SE * mean_se, (mean_err, mean_se)
    assert cov_err <= SAMPLE_SE * cov_se, (cov_err, cov_se)
    assert cov_rel <= SAMPLE_COV_RTOL, cov_rel
    assert abs(lp - lp_same) <= LOGPROB_RTOL * abs(lp_same), (lp, lp_same)
    assert abs(lp - lp64) <= LOGPROB_F32_RTOL * abs(lp64), (lp, lp64)
    assert abs(lm - lm64) <= LOG_MARGINAL_RTOL * abs(lm64), (lm, lm64)
    return out


# ---------------------------------------------------------------------------
# phase 15: the rest of the GP models
# ---------------------------------------------------------------------------

def plain64_atoms(kernel):
    """`kernel` with every atom evaluating its plain torch version
    (`_Atom.plain`: torch ops, differentiable, no hand kernel), so the
    port's own model code runs in float64 around it on the card; also
    after `rebuild()` (the group search rebuilds its atom)."""
    for atom in kernel._atoms:
        rebuild = atom.rebuild

        def plain_rebuild(atom=atom, rebuild=rebuild):
            rebuild()
            atom.fn = atom.plain

        atom.rebuild = plain_rebuild
        atom.fn = atom.plain
    return kernel


def plain64_kernel(dev, name, gamma, d, nu=1.5):
    """The float64 reference model's kernel on the card: one atom in
    float64 on its plain version (`plain64_atoms`)."""
    return plain64_atoms(KernelFunction(kernel_name=name, gamma=gamma, nu=nu,
                                        d=d, device=dev, dtype=torch.float64))


def dense_solve(y, s, kernel_part):
    """(NLL, log det A, L, α) of A = kernel_part() + s²I in float64 by a
    Cholesky."""
    y64 = y.double().reshape(-1)
    n = y64.shape[0]
    A = kernel_part()
    A.diagonal().add_(s * s)
    L, info = torch.linalg.cholesky_ex(A)
    assert int(info) == 0, info
    del A
    alpha = torch.cholesky_solve(y64[:, None], L)[:, 0]
    logdet = 2.0 * float(torch.log(L.diagonal()).sum())
    nll = float(0.5 * y64 @ alpha) + 0.5 * logdet + 0.5 * n * math.log(
        2.0 * math.pi)
    return nll, logdet, L, alpha


def dense_evidence_parts(x, y, s, probes, kernel_part, params):
    """The dense float64 NLL, log det A and, per parameter, (label,
    −½αᵀ∂Aα, ½tr(A⁻¹∂A), the Hutchinson estimator's σ over `probes`
    probes), for A = kernel_part() + s²I; `params` is [(label, fn)] with
    fn() the fresh (n, n) ∂A/∂θ; the noise's row last."""
    nll, logdet, L, alpha = dense_solve(y, s, kernel_part)
    Ainv = torch.cholesky_inverse(L)
    del L
    out = []
    for label, fn in params:
        dA = fn()
        quad = float(-0.5 * alpha @ (dA @ alpha))
        B = Ainv @ dA
        del dA
        half_tr = 0.5 * float(B.diagonal().sum())
        S2 = B + B.T
        del B
        var = 0.5 * (float(torch.linalg.vector_norm(S2)) ** 2
                     - float(S2.diagonal().square().sum()))
        del S2
        out.append((label, quad, half_tr, 0.5 * math.sqrt(var / probes)))
    # σ: ∂A/∂σ = 2σI, so B = 2σA⁻¹ and B + Bᵀ = 4σA⁻¹
    var = 0.5 * 16 * s * s * (float(torch.linalg.vector_norm(Ainv)) ** 2
                              - float(Ainv.diagonal().square().sum()))
    out.append(("noise", float(-s * alpha @ alpha),
                s * float(Ainv.diagonal().sum()),
                0.5 * math.sqrt(var / probes)))
    del Ainv
    torch.cuda.empty_cache()
    return nll, logdet, out


def general_kernel(dev, case):
    """15.1's kernels: the product SE(0.5)·Matérn-5/2(0.8), or Laplace(2)."""
    if case == "laplace":
        return KernelFunction(kernel_name="laplace", gamma=LAPLACE_GAMMA,
                              d=D, device=dev)
    (_, _, g0), (_, nu, g1) = GENERAL_ATOMS
    return (KernelFunction(kernel_name="squared_exponential", gamma=g0, d=D,
                           device=dev)
            * KernelFunction(kernel_name="matern", gamma=g1, nu=nu, d=D,
                             device=dev))


def general_dense(x, case, gammas=None):
    """(kernel_part, params) of `dense_evidence_parts` for 15.1's kernels
    (κ = 1) at `gammas` (default the kernels' own), labels as the port's
    gradient dict ("0.gamma", …)."""
    x64 = x.double()
    if case == "laplace":
        g = LAPLACE_GAMMA if gammas is None else gammas[0]
        return (lambda: atom_k64(x64, "laplace", g, 1.0),
                [("0.gamma", lambda: atom_k64(x64, "laplace", g, 1.0,
                                              "gamma")),
                 ("0.kappa", lambda: atom_k64(x64, "laplace", g, 1.0))])
    (f0, nu0, g0), (f1, nu1, g1) = GENERAL_ATOMS
    if gammas is not None:
        g0, g1 = gammas

    def prod(d0=None, d1=None):
        K = atom_k64(x64, f0, g0, 1.0, d0, nu0)
        return K.mul_(atom_k64(x64, f1, g1, 1.0, d1, nu1))

    return (prod,
            [("0.gamma", lambda: prod(d0="gamma")), ("0.kappa", prod),
             ("1.gamma", lambda: prod(d1="gamma")), ("1.kappa", prod)])


def general_evidence(kernel, x, y, n_label):
    """15.1's call: the general evidence gradient, counted, with the peak
    device memory it adds over what was held before it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (_, grads), wall, counts = counted(
        lambda: bbmm.evidence_value_and_grad_general(
            kernel, x, y, noise=LAZY_S, chunk=GENERAL_CHUNK,
            probes=EVIDENCE_PROBES, cg_tol=1e-6, cg_maxiter=500,
            probe_tol=1e-6, probe_maxiter=500, precond_rank=512,
            compute_value=False,
            generator=torch.Generator(device=x.device).manual_seed(13)))
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    print(f"    {n_label}: {wall!r} s, peak device memory above the "
          f"{held / 2**30!r} GiB held before {peak!r} GiB; launches "
          f"{nonzero(counts)}")
    return grads, wall, counts, peak


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def scaled_gram_check(label, xs, ys, fam, nu):
    """gram at a phase-15 shape (scaled coordinates) against its plain
    version in f32 and float64 (phase 2's bars), the plain versions in row
    blocks of 4096 (a 32768² float64 Matérn holds several n² temporaries).
    Returns the f32 error."""
    K = gram_scaled(xs, ys, 1.0, fam, nu)
    e = e64 = 0.0
    for r in range(0, xs.shape[0], 4096):
        Kr, xr = K[r:r + 4096], xs[r:r + 4096]
        e = max(e, float((Kr - gram_plain(xr, ys, 1.0, fam, nu)).abs().max()))
        e64 = max(e64, float((Kr.double() - gram_plain(
            xr.double(), ys.double(), 1.0, fam, nu)).abs().max()))
    K = Kr = None
    torch.cuda.empty_cache()
    print(f"    gram {fam}{'' if fam == 'se' else nu} {label} "
          f"{xs.shape[0]}x{ys.shape[0]} d={xs.shape[1]}: max abs err {e!r} "
          f"(plain f32), {e64!r} (plain f64); bars {GRAM_F32_ATOL}, "
          f"{GRAM_ATOL}")
    assert e <= GRAM_F32_ATOL and e64 <= GRAM_ATOL, (label, fam, e, e64)
    return e


def gram_l1_check(label, x, y, gamma):
    """gram_l1 at a phase-15 shape against its plain version."""
    inv = 1.0 / gamma ** 2
    K = gram_l1(x, y, inv, 1.0)
    e = float((K - gram_l1_plain(x, y, inv, 1.0)).abs().max())
    e64 = float((K.double() - gram_l1_plain(x.double(), y.double(), inv,
                                            1.0)).abs().max())
    del K
    print(f"    gram_l1 {label} {x.shape[0]}x{y.shape[0]} d={x.shape[1]}: "
          f"max abs err {e!r} (plain f32), {e64!r} (plain f64); bar "
          f"{GRAM_L1_ATOL}")
    assert e <= GRAM_L1_ATOL and e64 <= GRAM_L1_ATOL, (label, e, e64)
    return e


def gram_df_check(label, a64, b64, fam, nu, gamma):
    """gram_df at a shape (coordinates over γ) against its plain version,
    error of the pair value hi + lo over its magnitude (bar GRAM_DF_RTOL).
    Returns (max abs error, hi, lo)."""
    xs, ys = a64 / gamma, b64 / gamma
    hi, lo = gram_df_scaled(xs, ys, 1.0, fam, nu)
    hp, lp = gram_df_plain(xs, ys, 1.0, fam, nu)
    ref = hp.double() + lp.double()
    diff = (hi.double() + lo.double() - ref).abs()
    e, rel = float(diff.max()), float((diff / ref.abs().clamp_min(1e-300))
                                      .max())
    del hp, lp, ref, diff
    torch.cuda.empty_cache()
    print(f"    gram_df {fam}{'' if fam == 'se' else nu} {label} "
          f"{a64.shape[0]}x{b64.shape[0]} d={a64.shape[1]}: max abs err "
          f"{e!r}, max rel err {rel!r} (bar {GRAM_DF_RTOL})")
    assert rel <= GRAM_DF_RTOL, (label, fam, rel)
    return e, hi, lo


def gemv_df_check(label, hi, lo, v, vl):
    """gemv_df on the pair (hi, lo) and (v, vl) against its plain version,
    error over Σ|A||v| (bar GEMV_DF_RTOL). Returns the max abs error."""
    oh, ol = gemv_df(hi, lo, v, vl)
    ph, pl = gemv_df_plain(hi, lo, v, vl)
    scale = (hi.double() + lo.double()).abs() @ (
        v.double() + vl.double()).abs()
    d_ = (oh.double() + ol.double() - ph.double() - pl.double()).abs()
    e, rel = float(d_.max()), float((d_ / scale.clamp_min(1e-300)).max())
    print(f"    gemv_df {label} {hi.shape[0]}x{hi.shape[1]}: max abs err "
          f"{e!r}, max err / sum|A||v| {rel!r} (bar {GEMV_DF_RTOL})")
    assert rel <= GEMV_DF_RTOL, (label, rel)
    return e


def function_x_check(label, xa, xb, gamma, v_seed=5):
    """`_Gram`'s (SE) first and second derivatives of Σ W∘K in the points
    xa (the gradient, and its derivative along v), as ucb_optimize and the
    gradient helpers take them, f32 on the card against float64 autograd of
    the plain version; each entry within 2·matvec_rtol(m) of its terms'
    absolute sum: with k' = −K/2, k'' = K/4 in sq and e = |x̃ᵢ| + |ỹⱼ|,
    Σⱼ|W|2|k'|e_c (first) and Σⱼ|W|(4|k''|e_c Σ_c'e_c'|v_c'| + 2|k'||v_c|)
    (second), over γ and γ²."""
    dev = xa.device
    n, m = xa.shape[0], xb.shape[0]
    gen = torch.Generator(device=dev).manual_seed(v_seed)
    W = torch.rand((n, m), generator=gen, device=dev)
    v = torch.randn(xa.shape, generator=gen, device=dev)

    def derivs(dtype, plain):
        a = xa.to(dtype).clone().requires_grad_()
        b = xb.to(dtype)
        K = (gram_plain(a / gamma, b / gamma, 1.0, "se") if plain
             else gram_se(a, b, gamma, 1.0))
        (g,) = torch.autograd.grad((W.to(dtype) * K).sum(), a,
                                   create_graph=True)
        (h,) = torch.autograd.grad((g * v.to(dtype)).sum(), a)
        return g.detach().double(), h.double()

    (g32, h32), (g64, h64) = derivs(torch.float32, False), derivs(
        torch.float64, True)
    with torch.no_grad():
        a64, b64 = xa.double() / gamma, xb.double() / gamma
        K = torch.exp(-0.5 * torch.cdist(a64, b64).square_())
        WK = W.double() * K
        del K
        e = a64.abs()[:, None, :] + b64.abs()[None, :, :]       # (n, m, d)
        s1 = (WK[:, :, None] * e).sum(1) / gamma                  # 2|k'| = K
        ev = (e * v.double().abs()[:, None, :]).sum(2)            # (n, m)
        s2 = ((WK * ev)[:, :, None] * e).sum(1) + WK.sum(1)[:, None] * \
            v.double().abs()
        s2 = s2 / gamma ** 2
        del e, ev, WK
    e1 = float(((g32 - g64).abs() / s1).max())
    e2 = float(((h32 - h64).abs() / s2).max())
    bar = 2 * matvec_rtol(m)
    print(f"    {label}: _Gram's gradient in the points and its derivative "
          f"along v, f32 against float64 autograd, max |Δ| / scale {e1!r}, "
          f"{e2!r} (bar {bar!r})")
    assert e1 <= bar and e2 <= bar, (label, e1, e2)
    return max(e1, e2)


def product_residual(x, y, alpha, gammas, s, chunk=GENERAL_CHUNK):
    """‖y − (K + s²I)α‖/‖y‖ of 15.2's product kernel in float64, by plain
    ops one row chunk at a time (no kernel under test)."""
    (f0, nu0, _), (f1, nu1, _) = GENERAL_ATOMS
    x64, a64 = x.double(), alpha.double().reshape(-1)
    y64 = y.double().reshape(-1)
    r = y64 - s * s * a64
    for r0 in range(0, x64.shape[0], chunk):
        rows = x64[r0:r0 + chunk]
        K = (gram_plain(rows / gammas[0], x64 / gammas[0], 1.0, f0, nu0)
             * gram_plain(rows / gammas[1], x64 / gammas[1], 1.0, f1, nu1))
        r[r0:r0 + chunk] -= K @ a64
        del K
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(y64))


def general_phase(dev):
    """15.1 and 15.2: bbmm's general tier at n = LAZY_N."""
    out = {}
    xl, yl, _ = bench_data(dev, LAZY_N, LAZY_T)
    print("  15.1 the general evidence gradient (bbmm.evidence_value_and_"
          f"grad_general), n = {LAZY_N}, d = {D}, s = {LAZY_S}, "
          f"{EVIDENCE_PROBES} probes, chunk {GENERAL_CHUNK}, rank 512")
    for case in ("product", "laplace"):
        kernel = general_kernel(dev, case)
        grads, wall, counts, peak = general_evidence(kernel, xl, yl[:, 0],
                                                     f"n = {LAZY_N}")
        t0 = time.perf_counter()
        nll64, _, exact = dense_evidence_parts(
            xl, yl, LAZY_S, EVIDENCE_PROBES, *general_dense(xl, case))
        print(f"    {case}: dense float64 reference "
              f"{time.perf_counter() - t0!r} s, NLL {nll64!r}")
        rows = []
        for label, quad, half_tr, std in exact:
            if label == "noise":
                g = float(grads["noise"])
            else:
                ak, pk = label.split(".")
                g = float(grads["params"][ak][pk])
            g64 = quad + half_tr
            bar = HUTCH_SIGMAS * std + GRAD_RTOL * abs(g64)
            print(f"    {case} {label}: gradient {g!r} against {g64!r} "
                  f"(|Δ| {abs(g - g64)!r}, bar {bar!r} = {HUTCH_SIGMAS}·"
                  f"{std!r} + {GRAD_RTOL}·|g|)")
            assert abs(g - g64) <= bar, (case, label, g, g64, bar)
            rows.append((label, g, g64, bar))
        need = ("gram",) if case == "product" else ("gram_l1",)
        assert all(counts[k] > 0 for k in need), counts
        out[case] = {"rows": rows, "wall_s": wall, "peak_gib": peak,
                     "launches": nonzero(counts)}
    small = GENERAL_SMALL_N
    _, wall_s, _, peak_s = general_evidence(
        general_kernel(dev, "product"), xl[:small], yl[:small, 0],
        f"product at n = {small}")
    growth = out["product"]["peak_gib"] / peak_s
    print(f"    peak growth from n = {small} to {LAZY_N}: {growth!r}x (bar "
          f"{GENERAL_PEAK_GROWTH}x; n² would grow 4x, 4 GiB a (n, n) f32 "
          f"product at {LAZY_N})")
    assert growth <= GENERAL_PEAK_GROWTH, growth
    out["peak_small_gib"], out["peak_growth"] = peak_s, growth
    print("    the hand Grams at the general tier's shapes, chunk rows "
          f"against all {LAZY_N} points:")
    rows, cols = xl[:GENERAL_CHUNK], xl
    out["function_err"] = max(
        gram_fn_check(f"{fam}{'' if fam == 'se' else nu} chunk", rows, g,
                      False, 31 + i, y=cols, fam=fam, nu=nu)
        for i, (fam, nu, g) in enumerate(GENERAL_ATOMS))
    out["function_err"] = max(out["function_err"], gram_fn_check(
        "laplace chunk", rows, LAPLACE_GAMMA, True, 33, y=cols))

    print(f"  15.2 IterativeGP(lazy=True).optimize_params on the product, "
          f"n = {LAZY_N}, {GENERAL_FIT_STEPS} Adam steps")
    kernel = general_kernel(dev, "product")
    gp = IterativeGP(kernel, s=LAZY_S, lazy=True, precision="double",
                     var_refine=0)
    _, fit_s, _ = counted(lambda: gp.fit_gp(xl, yl))
    s0 = gp.s
    nll0 = dense_solve(yl, s0, general_dense(xl, "product")[0])[0]
    torch.cuda.empty_cache()
    fit, wall, counts = counted(lambda: gp.optimize_params(
        steps=GENERAL_FIT_STEPS, tol=0.0))
    gammas = [float(kernel.params_dict[k]["gamma"]) for k in ("0", "1")]
    nll1 = dense_solve(yl, gp.s, general_dense(xl, "product", gammas)[0])[0]
    torch.cuda.empty_cache()
    resid = product_residual(xl, yl, gp._A_df.double().sum(1), gammas, gp.s)
    single = IterativeGP(kernel, s=gp.s, lazy=True)
    single.fit_gp(xl, yl)
    resid_single = product_residual(xl, yl, single.A, gammas, gp.s)
    print(f"    fit {fit_s!r} s; optimize_params {wall!r} s with the refit, "
          f"{wall / GENERAL_FIT_STEPS!r} s a step; γ {[g for *_, g in GENERAL_ATOMS]}"
          f" -> {gammas}, κ -> {[float(kernel.params_dict[k]['kappa']) for k in ('0', '1')]},"
          f" σ {s0!r} -> {gp.s!r}; dense float64 NLL {nll0!r} -> {nll1!r}; "
          f"refit (precision='double') {gp.fit_status}; its float64 "
          f"residual {resid!r} (bar {LAZY_RESIDUAL_MAX}); the same refit in "
          f"f32 {single.fit_status['cg_residual']!r} by its CG, "
          f"{resid_single!r} in float64 (bar {F32_REFIT_RESIDUAL_MAX}); "
          f"launches {nonzero(counts)}")
    assert fit["steps_run"] == GENERAL_FIT_STEPS, fit
    assert nll1 < nll0, (nll0, nll1)
    assert resid <= LAZY_RESIDUAL_MAX, resid
    assert resid_single <= F32_REFIT_RESIDUAL_MAX, resid_single
    assert all(counts[k] > 0 for k in ("gram", "gram_df", "gemv_df")), counts
    print("    the double tier's kernels at the refit's row strips "
          f"({gp.df_chunk} rows against all {LAZY_N} points):")
    x64, c = xl.double(), gp.df_chunk
    for (fam, nu, _), g in zip(GENERAL_ATOMS, gammas):
        gram_df_check("strip", x64[:c], x64, fam, nu, g)
    Kh, Kl = df_gram_from_desc(gp.kernel_object, {}, xl[:c], xl,
                               gp._df_desc())
    vh, vl = gp._A_df[:, 0].contiguous(), gp._A_df[:, 1].contiguous()
    gemv_df_check("product strip", Kh, Kl, vh, vl)
    del Kh, Kl, x64
    out["hyperfit"] = {"wall_s": wall, "step_s": wall / GENERAL_FIT_STEPS,
                       "gammas": gammas, "noise": gp.s, "nll0": nll0,
                       "nll": nll1, "residual": resid,
                       "residual_f32_refit": resid_single,
                       "cg_residual_f32_refit":
                           single.fit_status["cg_residual"],
                       "launches": nonzero(counts)}
    del gp, single, xl, yl
    torch.cuda.empty_cache()
    return out


def df_variance_phase(dev, defaults_residual):
    """15.3: IterativeGP(precision="double") with its default var_refine=1
    on phase 8's system against the dense float64 posterior."""
    xl, yl, xtl = bench_data(dev, LAZY_N, DF_VARIANCE_T)
    mu64, var64, _ = reference_f64(xl, yl, xtl, s=LAZY_S,
                                   kern=lazy_kernel_matrix,
                                   prior_var=float(len(LAZY_ATOMS)))
    torch.cuda.empty_cache()
    gp = IterativeGP(lazy_kernel(dev), s=LAZY_S, lazy=True,
                     precision="double")
    assert gp.var_refine == 1
    _, fit_s, fit_counts = counted(lambda: gp.fit_gp(xl, yl))
    (mu, sd), ms_s, counts = counted(lambda: gp.mean_std(xtl))
    mean_err, vmax, vmed = posterior_errors(mu, sd, mu64, var64)
    print(f"  15.3 df-refined matrix-free variance, n = {LAZY_N}, t = "
          f"{DF_VARIANCE_T}: mean rel err {mean_err!r} (bar "
          f"{LAZY_DOUBLE_MEAN_RTOL}),"
          f" var rel err max {vmax!r} (bar {REFINED_VAR_MAX_RTOL}) median "
          f"{vmed!r}; fit {fit_s!r} s, mean_std {ms_s!r} s; fit_status "
          f"{gp.fit_status}; launches {nonzero(counts)}")
    assert mean_err <= LAZY_DOUBLE_MEAN_RTOL, mean_err
    assert vmax <= REFINED_VAR_MAX_RTOL, vmax
    assert all(counts[k] > 0 for k in ("gram_df", "qform_df", "gram_matmat")), \
        counts
    print("    the kernels at _std_exact_df's shapes:")
    (f0, nu0, g0), (f1, nu1, g1) = LAZY_ATOMS
    c = gp.df_chunk
    x64, xt64 = xl.double(), xtl.double()
    gram_df_check("strip × test", x64[:c], xt64, f0, nu0, g0)
    gram_df_check("strip × train", x64[:c], x64, f1, nu1, g1)
    Th, Tl = df_gram_from_desc(gp.kernel_object, {}, xl[:c], xl,
                               gp._df_desc())
    Bh, Bl = df_gram_from_desc(gp.kernel_object, {}, xl, xtl[:128],
                               gp._df_desc())
    W = 0.5 * Bh                 # the scale of a solve (K + s²I)⁻¹B
    e, rel = qform_error(Th, Tl, W, W[:c], Bh[:c], Bl[:c])
    print(f"    qform_df strip c={min(c, LAZY_N)} n={LAZY_N} t=128: max abs err {e!r}, "
          f"max err / scale {rel!r} (bar {QFORM_RTOL})")
    assert rel <= QFORM_RTOL, rel
    print(f"  15.3 the 65536 defaults fit of phase 9, CG not segmented: "
          f"float64 residual {defaults_residual!r} (bar {LAZY_RESIDUAL_MAX})")
    assert defaults_residual <= LAZY_RESIDUAL_MAX, defaults_residual
    del gp, Th, Tl, Bh, Bl, W, xl, yl, xtl, mu64, var64
    torch.cuda.empty_cache()
    return {"mean": mean_err, "var_max": vmax, "var_median": vmed,
            "fit_s": fit_s, "mean_std_s": ms_s, "launches": nonzero(counts),
            "fit_launches": nonzero(fit_counts),
            "defaults_65k_residual": defaults_residual, "qform_err": rel}


def robust_phase(dev):
    """15.4: the robust losses at n = ROBUST_N on bench rows with outliers,
    then the MAP evidence at config 1."""
    out = {}
    x, y, xt = bench_data(dev)
    x, y_clean = x[:ROBUST_N], y[:ROBUST_N]
    idx = np.random.default_rng(1).choice(
        ROBUST_N, int(ROBUST_FRACTION * ROBUST_N), replace=False)
    y_bad = y_clean.clone()
    y_bad[torch.as_tensor(idx, device=dev)] += ROBUST_SHIFT
    mu_clean, _, _ = reference_f64(x, y_clean, xt)
    gp_kw = dict(gamma=GAMMA, s=S, d=D, lam=ROBUST_LAM)
    sq = GaussianProcess(device=dev, **gp_kw)
    sq.fit_gp(x, y_bad)
    err_sq = float((sq.mean(xt)[:, 0].double() - mu_clean).abs().max())
    print(f"  15.4 robust losses, n = {ROBUST_N}, d = {D}, {len(idx)} targets "
          f"shifted by {ROBUST_SHIFT}, lam = {ROBUST_LAM}; the squared loss's "
          f"mean is {err_sq!r} from the clean-data float64 posterior")
    for loss in ROBUST_LOSSES:
        gp = GaussianProcess(device=dev, loss=loss, **gp_kw)
        _, fit_s, fit_counts = counted(lambda: gp.fit_gp(x, y_bad))
        (mu, sd), ms_s, ms_counts = counted(lambda: gp.mean_std(xt))
        assert mu.shape == sd.shape == (NTEST, 1)
        assert bool(torch.isfinite(mu).all() and torch.isfinite(sd).all())
        gp64 = GaussianProcess(kernel=plain64_kernel(dev, "squared_exponential",
                                                     GAMMA, D),
                               loss=loss, s=S, lam=ROBUST_LAM)
        t0 = time.perf_counter()
        gp64.fit_gp(x, y_bad)
        ref_s = time.perf_counter() - t0
        obj = gp64._loss_objective(gp64.kernel_object.gram(gp64.x), gp64.y)
        v64 = float(obj(gp64.A[:, 0]))
        v32 = float(obj(gp.A[:, 0].double()))
        gap = (v32 - v64) / abs(v64)
        err = float((mu[:, 0].double() - mu_clean).abs().max())
        print(f"    {loss}: fit {fit_s!r} s (L-BFGS {gp.robust_status}), "
              f"mean_std on {NTEST} points {ms_s!r} s; the float64 "
              f"model's fit {ref_s!r} s ({gp64.robust_status}); its objective"
              f" at the f32 alpha {v32!r} against {v64!r} at its own "
              f"(relative {gap!r}, bar {ROBUST_OBJ_RTOL}); mean "
              f"{err!r} from the clean posterior; launches fit "
              f"{nonzero(fit_counts)}, mean_std {nonzero(ms_counts)}")
        assert gap <= ROBUST_OBJ_RTOL, (loss, v32, v64)
        assert fit_counts["gram"] > 0 and ms_counts["gram"] > 0
        if loss == "huber":
            assert err < err_sq, (err, err_sq)
        out[loss] = {"fit_s": fit_s, "mean_std_s": ms_s,
                     "lbfgs": gp.robust_status, "lbfgs64": gp64.robust_status,
                     "objective_gap": gap, "clean_mean_err": err,
                     "launches": nonzero({k: fit_counts[k] + ms_counts[k]
                                          for k in fit_counts})}
        del gp, gp64, mu, sd
    out["squared_clean_mean_err"] = err_sq
    print("    the Gram kernel at the robust fit's shapes:")
    xs, xts = x / GAMMA, xt / GAMMA
    scaled_gram_check("fit", xs, xs, "se", 1.5)
    scaled_gram_check("predict", xts, xs, "se", 1.5)
    del x, y, xt, y_clean, y_bad, mu_clean
    torch.cuda.empty_cache()

    x1, y1 = config1_data()
    gp = GaussianProcess(loss="huber", device=dev, **CONFIG1_GP)
    gp.fit_gp(x1, y1)
    gp64 = GaussianProcess(kernel=plain64_kernel(dev, "squared_exponential",
                                                 CONFIG1_GP["gamma"], 1),
                           loss="huber", s=CONFIG1_GP["s"])
    gp64.fit_gp(x1, y1)
    rows = []
    for gamma in MAP_GAMMAS:
        with inner_argmin() as inner64:
            v64, d64 = map_evidence(gp64, gamma, dev)
        (v, d), wall, counts = counted(lambda: map_evidence(gp, gamma, dev))
        with inner_argmin(inner64.results[0].x):
            (vs, ds), _, shared_counts = counted(
                lambda: map_evidence(gp, gamma, dev))
        rv, rd = abs(v - v64) / abs(v64), abs(d - d64) / abs(d64)
        rvs, rds = abs(vs - v64) / abs(v64), abs(ds - d64) / abs(d64)
        print(f"    MAP evidence (huber), config 1, γ = {gamma}: {v!r} against"
              f" float64 {v64!r} (rel {rv!r}, bar {MAP_RTOL}); d/dγ {d!r} "
              f"against {d64!r} (rel {rd!r}, not held: each at its own "
              f"unconverged α̂); {wall!r} s; at the float64 model's α̂: "
              f"{vs!r} (rel {rvs!r}, bar {MAP_RTOL}), d/dγ {ds!r} (rel "
              f"{rds!r}, bar {MAP_SHARED_GRAD_RTOL}); launches "
              f"{nonzero(counts)}, {nonzero(shared_counts)}")
        assert rv <= MAP_RTOL and rvs <= MAP_RTOL, (gamma, v, vs, v64)
        assert rds <= MAP_SHARED_GRAD_RTOL, (gamma, ds, d64)
        assert counts["gram"] > 0 and shared_counts["gram"] > 0, counts
        rows.append({"gamma": gamma, "value": v, "value64": v64, "grad": d,
                     "grad64": d64, "value_shared": vs, "grad_shared": ds,
                     "wall_s": wall, "launches": nonzero(counts)})
    out["map_evidence"] = rows
    out["map_function_err"] = gram_fn_check(
        "config 1 gram", torch.as_tensor(x1, dtype=torch.float32, device=dev),
        MAP_GAMMAS[-1], False, 34)
    return out


def map_evidence(model, gamma, dev):
    """`log_marginal` of a robust-loss model at the bandwidth γ and its
    derivative in γ (float64 values)."""
    g = torch.tensor(gamma, dtype=torch.float64, device=dev,
                     requires_grad=True)
    v = model.log_marginal(model.kernel_object, {"0": {"gamma": g}})
    (d,) = torch.autograd.grad(v, g)
    return float(v.detach()), float(d)


class inner_argmin:
    """Within the block, the L-BFGS runs of the port's GaussianProcess
    (`exact_gp.minimize_lbfgs`: the robust alpha, the MAP evidence's inner
    argmin, volume_mean's logistic β) are kept in `.results`; with `x`
    given, each returns x (unconverged, 0 iterations) without running."""

    def __init__(self, x=None):
        self.x, self.results = x, []

    def __enter__(self):
        self.real = exact_gp.minimize_lbfgs

        def run(fun, x0, **kw):
            res = (self.real(fun, x0, **kw) if self.x is None else
                   LBFGSResult(self.x.clone(), fun(self.x).detach(), 0,
                               False))
            self.results.append(res)
            return res

        exact_gp.minimize_lbfgs = run
        return self

    def __exit__(self, *exc):
        exact_gp.minimize_lbfgs = self.real


class same_draws:
    """Within the block, `torch.rand` returns `U` (cast to the dtype asked
    for): the float64 reference model's ucb_optimize starts where the
    card's started."""

    def __init__(self, U):
        self.U = U

    def __enter__(self):
        self.real = torch.rand
        U = self.U
        torch.rand = lambda *a, dtype=None, device=None, **k: U.to(
            dtype=dtype or U.dtype, device=device or U.device)

    def __exit__(self, *exc):
        torch.rand = self.real


def bo_phase(dev):
    """15.5-15.7 on phase 3's GP (n = 16384): ucb_optimize, the gradient
    helpers and sample_and_max against the float64 model; then
    sample_iteratively_max without a grid at config 1."""
    out = {}
    x, y, xt = bench_data(dev)
    bounds = [[-1.0, 1.0]] * D
    gp = GaussianProcess(gamma=GAMMA, s=S, d=D, bounds=bounds, device=dev)
    gp.fit_gp(x, y)
    gp64 = GaussianProcess(kernel=plain64_kernel(dev, "squared_exponential",
                                                 GAMMA, D),
                           s=S, bounds=bounds)
    gp64.fit_gp(x, y)
    U = torch.rand((UCB_MULTISTART, D), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    with same_draws(U):
        (pt, val), wall, counts = counted(lambda: gp.ucb_optimize(
            multistart=UCB_MULTISTART))
        t0 = time.perf_counter()
        pt64, val64 = gp64.ucb_optimize(multistart=UCB_MULTISTART)
        wall64 = time.perf_counter() - t0
    with torch.no_grad():
        at_pt = float(gp64._acquisition(pt.double()[None, :], 2.0, 1.0)[0])
        R = torch.rand((UCB_RANDOM, D), generator=torch.Generator(
            device=dev).manual_seed(8), dtype=torch.float64, device=dev)
        best_random = float(gp64._acquisition(R * 2.0 - 1.0, 2.0, 1.0).max())
    rv = abs(float(val) - float(val64)) / abs(float(val64))
    rp = abs(at_pt - float(val)) / abs(at_pt)
    print(f"  15.5 ucb_optimize, n = {N}, multistart {UCB_MULTISTART}: "
          f"{wall!r} s, value {float(val)!r} at {pt.tolist()}; the float64 "
          f"model from the same starts {float(val64)!r} ({wall64!r} s; rel "
          f"{rv!r}, bar {UCB_RTOL}); float64 at the card's point {at_pt!r} "
          f"(rel {rp!r}, bar {UCB_RTOL}); best of {UCB_RANDOM} random points "
          f"{best_random!r}; launches {nonzero(counts)}")
    assert rv <= UCB_RTOL and rp <= UCB_RTOL, (rv, rp)
    assert at_pt >= best_random, (at_pt, best_random)
    assert counts["gram"] > 0, counts
    out["ucb"] = {"wall_s": wall, "value": float(val), "value64": float(
        val64), "at_point64": at_pt, "best_random": best_random,
        "launches": nonzero(counts)}
    print("    the Gram kernel and its Function at ucb_optimize's shape:")
    xs = x / GAMMA
    starts = (U * 2.0 - 1.0)
    scaled_gram_check("ucb", starts / GAMMA, xs, "se", 1.5)
    out["function_x_err"] = function_x_check(
        f"ucb {UCB_MULTISTART}x{N}", starts, x, GAMMA)

    errs = {"grad_mu": 0.0, "hess_var": 0.0, "hess_mu": 0.0}
    reset_launch_counts()
    t0 = time.perf_counter()
    for p in xt[:GRAD_POINTS]:
        got_v = gp.gradient_mean_var(p)
        got_m = gp.mean_gradient_hessian(p, hessian=True)
        want_v = gp64.gradient_mean_var(p.double())
        want_m = gp64.mean_gradient_hessian(p.double(), hessian=True)
        for key, g, w in (("grad_mu", got_v[0], want_v[0]),
                          ("hess_var", got_v[1], want_v[1]),
                          ("grad_mu", got_m[0], want_m[0]),
                          ("hess_mu", got_m[1], want_m[1])):
            assert g.shape == w.shape, (key, g.shape, w.shape)
            e = float((g.double() - w).abs().max() / w.abs().max())
            errs[key] = max(errs[key], e)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    print(f"  15.6 gradient_mean_var and mean_gradient_hessian at "
          f"{GRAD_POINTS} points against the float64 model's autograd, max "
          f"err / max|float64|: {errs} (bar {GRAD_HELPER_RTOL}); {wall!r} s "
          f"with the float64 model's; launches {nonzero(counts)}")
    assert max(errs.values()) <= GRAD_HELPER_RTOL, errs
    assert counts["gram"] > 0, counts
    out["gradient_helpers"] = {"errors": errs, "wall_s": wall,
                               "launches": nonzero(counts)}
    function_x_check(f"gradient helpers 1x{N}", xt[:1], x, GAMMA)
    del gp64
    torch.cuda.empty_cache()

    grid = xt[:SAMPLE_MAX_T]
    (pts, vals), wall, counts = counted(lambda: gp.sample_and_max(
        grid, size=SAMPLE_MAX_SIZE,
        generator=torch.Generator(device=dev).manual_seed(21)))
    paths = gp.sample(grid, size=SAMPLE_MAX_SIZE,
                      generator=torch.Generator(device=dev).manual_seed(21))
    assert torch.allclose(vals, paths.max(dim=0).values, rtol=1e-6, atol=0)
    assert pts.shape == (SAMPLE_MAX_SIZE, D)
    print(f"  15.7 sample_and_max on {SAMPLE_MAX_T} points, "
          f"{SAMPLE_MAX_SIZE} paths: {wall!r} s, maxima in "
          f"[{float(vals.min())!r}, {float(vals.max())!r}], equal to sample's"
          f" on the same seed; launches {nonzero(counts)}")
    assert counts["gram_df"] > 0, counts
    gram_df_check("sample", grid.double(), x.double(), "se", 1.5, GAMMA)
    out["sample_and_max"] = {"wall_s": wall, "launches": nonzero(counts)}
    del gp, x, y, xt
    torch.cuda.empty_cache()

    x1, y1 = config1_data()
    gp = GaussianProcess(device=dev, **CONFIG1_GP)
    gp.fit_gp(x1, y1)
    x_old, A_old = gp.x, gp.A.clone()
    (pt, val), wall, counts = counted(lambda: gp.sample_iteratively_max(
        None, multistart=20, grid=100,
        generator=torch.Generator(device=dev).manual_seed(22)))
    drift = float((gp.A - A_old).abs().max() / A_old.abs().max())
    print(f"    sample_iteratively_max without a grid, config 1 (multistart "
          f"20, grid 100): {wall!r} s, point {pt.tolist()}, value "
          f"{float(val)!r}; data restored ({tuple(gp.x.shape)}), alpha "
          f"{drift!r} from the fit before; launches {nonzero(counts)}")
    assert gp.x is x_old and gp.A.shape == A_old.shape and drift <= 1e-6
    assert pt.shape == (1, 1) and bool(pt.abs().max() <= 1.0)
    assert math.isfinite(float(val)) and counts["gram"] > 0
    assert counts["gram_df"] > 0, counts
    print("    the kernels at its shapes: the fit on the data and one "
          "fantasised line, the line's df Grams")
    g1 = CONFIG1_GP["gamma"]
    line = torch.linspace(-1.0, 1.0, 100, dtype=torch.float64,
                          device=dev)[:, None]
    x64 = torch.as_tensor(x1, device=dev)
    xa = torch.cat([x64, line]).float() / g1
    scaled_gram_check("grid-free fit", xa, xa, "se", 1.5)
    gram_df_check("grid-free line", line, x64, "se", 1.5, g1)
    gram_df_check("grid-free line", line, line, "se", 1.5, g1)
    out["sample_iteratively_max"] = {"wall_s": wall, "value": float(val),
                                     "launches": nonzero(counts)}
    return out


def volume_phase(dev):
    """15.8: volume_mean, relu and logistic, on config 1's data with two
    band outliers, against the float64 model's run on the card."""
    out = {}
    x1, y1 = config1_data()
    y1 = y1.copy()
    for i, shift in VOLUME_BAND:
        y1[i] += shift
    xt = np.linspace(-1.0, 1.0, VOLUME_T)[:, None]
    gp = GaussianProcess(device=dev, **CONFIG1_GP)
    gp.fit_gp(x1, y1)
    gp64 = GaussianProcess(kernel=plain64_kernel(
        dev, "squared_exponential", CONFIG1_GP["gamma"], 1),
        s=CONFIG1_GP["s"])
    gp64.fit_gp(x1, y1)
    for relax in ("relu", "logistic"):
        mu, wall, counts = counted(lambda: gp.volume_mean(
            xt, relax=relax, bisections=VOLUME_BISECTIONS))
        assert mu.shape == (VOLUME_T, 1) and bool(torch.isfinite(mu).all())
        assert counts["gram_df"] > 0, counts
        with inner_argmin() as run:
            fixed = gp.volume_mean(xt, relax=relax, scale=VOLUME_SCALE)
        t0 = time.perf_counter()
        with inner_argmin() as run64:
            mu64 = gp64.volume_mean(xt, relax=relax, scale=VOLUME_SCALE)
        wall64 = time.perf_counter() - t0
        err = float((fixed.double() - mu64).abs().max() / mu64.abs().max())
        if relax == "relu":
            held = f"(bar {VOLUME_RELU_RTOL})"
            assert err <= VOLUME_RELU_RTOL, (relax, err)
        else:
            v, v64 = (float(r.results[-1].value) for r in (run, run64))
            gap = (v - v64) / abs(v64)
            held = (f"(not held); the objective at its fitted β {v!r} "
                    f"against {v64!r} (relative {gap!r}, bar "
                    f"{VOLUME_OBJ_RTOL})")
            assert gap <= VOLUME_OBJ_RTOL, (relax, v, v64)
            out["logistic_objective_gap"] = gap
        print(f"  15.8 volume_mean ({relax}), config 1 with outliers at "
              f"{[i for i, _ in VOLUME_BAND]}: {wall!r} s with the scale's "
              f"bisection ({VOLUME_BISECTIONS} steps), max|μ| "
              f"{float(mu.abs().max())!r}; at scale "
              f"{VOLUME_SCALE} against the float64 model's ({wall64!r} s): "
              f"max |μ − μ64| / max|μ64| {err!r} {held}; launches "
              f"{nonzero(counts)}")
        out[relax] = {"wall_s": wall, "wall64_fixed_scale_s": wall64,
                      "err_fixed_scale": err, "launches": nonzero(counts)}
    gram_df_check("volume_mean", torch.as_tensor(x1, device=dev),
                  torch.as_tensor(x1, device=dev), "se", 1.5,
                  CONFIG1_GP["gamma"])
    return out


def online_phase(dev):
    """15.9: OnlineGP fed ONLINE_CAP bench rows one at a time, against the
    batch GaussianProcess on the same points."""
    x, y, xt = bench_data(dev)
    x, y, xt = x[:ONLINE_CAP], y[:ONLINE_CAP], xt[:ONLINE_CAP]
    kernel = KernelFunction(kernel_name="squared_exponential", gamma=GAMMA,
                            d=D, device=dev)
    og = OnlineGP(kernel, s=S, capacity=ONLINE_CAP, d=D)
    ptrs = [b.data_ptr() for b in (og.x_buf, og.y_buf, og.L, og.alpha)]

    def feed():
        for i in range(ONLINE_CAP):
            og.add_data_point(x[i], y[i])

    _, wall, counts = counted(feed)
    assert [b.data_ptr() for b in (og.x_buf, og.y_buf, og.L, og.alpha)] \
        == ptrs, "an OnlineGP buffer moved"
    gp = GaussianProcess(kernel=kernel, s=S)
    gp.fit_gp(x, y)
    (om, osd), (gm, gsd) = og.mean_std(xt), gp.mean_std(xt)
    em = float((om - gm).abs().max() / gm.abs().max())
    es = float(((osd - gsd).abs() / gsd).max())
    print(f"  15.9 OnlineGP, capacity {ONLINE_CAP}, d = {D}: {ONLINE_CAP} "
          f"add_data_point in {wall!r} s ({wall / ONLINE_CAP * 1e3!r} ms "
          f"each), buffers never moved; against the batch GP: mean "
          f"{em!r} (bar {ONLINE_MEAN_RTOL}), std {es!r} (bar "
          f"{ONLINE_STD_RTOL}); launches {nonzero(counts)}")
    assert em <= ONLINE_MEAN_RTOL and es <= ONLINE_STD_RTOL, (em, es)
    assert counts["gram"] >= ONLINE_CAP, counts
    xs = x / GAMMA
    scaled_gram_check("online column", xs, xs[:1], "se", 1.5)
    return {"adds_s": wall, "add_ms": wall / ONLINE_CAP * 1e3, "mean": em,
            "std": es, "launches": nonzero(counts)}


# ---------------------------------------------------------------------------
# phase 16: the feature-GP and Nyström slice
# ---------------------------------------------------------------------------

def timed_reps(run, reps=FEATURE_REPS):
    """run() once to warm up, then `reps` runs each ended by a synchronize:
    ({wall_s: median, wall_iqr_s, walls_s, warmup_s}, the last output)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    q1, q3 = np.percentile(walls, [25, 75])
    return {"wall_s": float(np.median(walls)), "wall_iqr_s": float(q3 - q1),
            "walls_s": walls, "warmup_s": warm}, out


def config2_data(n=CONFIG2_N, t=CONFIG2_T):
    """run_all.py:99-103 (numpy seed 1): x, xt ~ U(−1, 1)², y = sin 3x₀ ·
    cos 2x₁, float64 numpy (each model converts to its dtype)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (n, 2))
    y = np.sin(3 * x[:, :1]) * np.cos(2 * x[:, 1:])
    return x, y, rng.uniform(-1, 1, (t, 2))


def feature_gp(dev, dtype):
    emb = HermiteEmbedding(gamma=CONFIG2_GAMMA, m=CONFIG2_M, d=2, device=dev,
                           dtype=dtype)
    return KernelizedFeatures(embedding=emb, m=emb.get_m(), s=CONFIG2_S, d=2)


def config2_phase(dev):
    """16.1: run_all.py config 2 as written (see CONFIG2_N's note)."""
    x, y, xt = config2_data()
    gp = GaussianProcess(gamma=CONFIG2_GAMMA, s=CONFIG2_S, d=2, device=dev)
    (mu_e, std_e), exact_s, exact_counts = counted(
        lambda: (gp.fit_gp(x, y), gp.mean_std(xt))[1])
    F = feature_gp(dev, torch.float32)
    gen = torch.Generator(device=dev)

    def run():
        gen.manual_seed(0)
        F.fit_gp(x, y)
        mu, std = F.mean_std(xt)
        return mu, std, F.sample(xt, size=CONFIG2_DRAWS, generator=gen)

    stats, _ = timed_reps(run)
    (mu, std, f), _, counts = counted(run)
    F64 = feature_gp(dev, torch.float64)
    F64.fit_gp(x, y)
    mu64, std64 = F64.mean_std(xt)
    mean_err = float((mu.double() - mu64).abs().max() / mu64.abs().max())
    std_err = float(((std.double() - std64) / std64).abs().max())
    mu_vs_exact = float((mu - mu_e).abs().max())
    std_vs_exact = float((std - std_e).abs().max())
    # the draws: mean against float64, covariance against the factor sample
    # made (the same ladder on the same V⁻¹)
    n = CONFIG2_DRAWS
    fd = f.double()
    se = std64[:, 0] / math.sqrt(n)
    draw_mean = float(((fd.mean(dim=1) - mu64[:, 0]).abs() / se).max())
    res = linalg.safe_cholesky(F.get_invV().clone())
    PL = F.embed(xt).double() @ (res.L.double() * CONFIG2_S)
    C = PL @ PL.T
    dev_ = fd - (F.embed(xt) @ F.theta_mean()).double()
    S_ = dev_ @ dev_.T / n
    cov_err = float(torch.linalg.matrix_norm(S_ - C))
    cov_se = math.sqrt((float(torch.linalg.matrix_norm(C)) ** 2
                        + float(torch.trace(C)) ** 2) / n)
    var_ratio = float((C.diagonal() / std64[:, 0] ** 2).median())
    jitter_rel = float(res.jitter / F.get_invV().diagonal().mean())
    print(f"  16.1 config 2: exact GP fit + mean_std {exact_s!r} s (launches "
          f"{nonzero(exact_counts)}); feature GP (m = {F.m}) fit + mean_std "
          f"+ {n} draws: median {stats['wall_s']!r} s, IQR "
          f"{stats['wall_iqr_s']!r} s (warm-up {stats['warmup_s']!r} s; "
          f"launches {nonzero(counts)}); mu_err_vs_exact {mu_vs_exact!r}, "
          f"std_err_vs_exact {std_vs_exact!r}")
    print(f"    against the float64 feature GP: mean {mean_err!r} of max|μ64| "
          f"(bar {CONFIG2_MEAN_RTOL}), std {std_err!r} (bar "
          f"{CONFIG2_STD_RTOL}); draws: max |x̄ − μ64|/(σ64/√{n}) "
          f"{draw_mean!r} (bar {DRAW_SE}), ‖S − ΦLLᵀΦᵀ‖_F {cov_err!r} (bar "
          f"{DRAW_SE} × {cov_se!r}), ladder jitter {jitter_rel!r} of V⁻¹'s "
          f"mean diagonal, median var(ΦLLᵀΦᵀ)/σ64² {var_ratio!r}")
    assert mean_err <= CONFIG2_MEAN_RTOL, mean_err
    assert std_err <= CONFIG2_STD_RTOL, std_err
    assert draw_mean <= DRAW_SE, draw_mean
    assert cov_err <= DRAW_SE * cov_se, (cov_err, cov_se)
    assert bool(torch.isfinite(f).all()) and f.shape == (CONFIG2_T, n)
    assert exact_counts["gram"] > 0, exact_counts
    xs, xts = gp.x / CONFIG2_GAMMA, gp._tensor(xt) / CONFIG2_GAMMA
    scaled_gram_check("config 2 train", xs, xs, "se", 1.5)
    scaled_gram_check("config 2 test x train", xts, xs, "se", 1.5)
    return {**stats, "mu_err_vs_exact": mu_vs_exact,
            "std_err_vs_exact": std_vs_exact, "exact_s": exact_s,
            "mean_vs_f64": mean_err, "std_vs_f64": std_err,
            "draw_mean_se": draw_mean, "draw_cov_err": cov_err,
            "draw_cov_se": cov_se, "ladder_jitter_rel": jitter_rel,
            "var_ratio_median": var_ratio, "m": F.m,
            "launches": nonzero(counts), "exact_launches": nonzero(exact_counts)}


def config3_data():
    """run_all.py:135-138 (numpy seed 2): x ~ U(−1, 1)^(50000 × 2) and
    y = sin 3x₀ + x₁, float32 numpy."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (CONFIG3_N, 2)).astype(np.float32)
    return x, (np.sin(3 * x[:, :1]) + x[:, 1:]).astype(np.float32)


def config3_kernel(dev, dtype):
    k = None
    for fam, nu, gamma, col in CONFIG3_ATOMS:
        name = "squared_exponential" if fam == "se" else "matern"
        atom = KernelFunction(kernel_name=name, gamma=gamma, nu=nu, d=2,
                              group=[col], device=dev, dtype=dtype)
        k = atom if k is None else k + atom
    return plain64_atoms(k) if dtype == torch.float64 else k


def eig_counts(eigs):
    """(eigenvalues above the cut, of those under 1e-6·λmax)."""
    passed = eigs[eigs > EIG_CUT]
    return int(passed.numel()), int((passed < 1e-6 * eigs.max()).sum())


def config3_phase(dev):
    """16.2: run_all.py config 3 as written (see CONFIG3_N's note)."""
    x, y = (torch.tensor(a, device=dev) for a in config3_data())
    head = x[:CONFIG3_HEAD]
    nf = NystromFeatures(config3_kernel(dev, torch.float32), m=CONFIG3_M,
                         approx="uniform", s=CONFIG3_S)

    def run():
        nf.fit_gp(x, y)
        return nf.mean_std(head)

    stats, _ = timed_reps(run)
    state = nf.generator.get_state()
    (mu, _sd), wall, counts = counted(run)
    nf64 = NystromFeatures(config3_kernel(dev, torch.float64), m=CONFIG3_M,
                           approx="uniform", s=CONFIG3_S)
    nf64.generator.set_state(state)
    nf64.fit_gp(x, y)
    assert torch.equal(nf.C, nf64.C), "the float64 model drew other landmarks"
    mu64 = nf64.mean_std(head)[0]
    mean_err = float((mu.double() - mu64).abs().max() / mu64.abs().max())
    yh = y[:CONFIG3_HEAD].double().reshape(-1, 1)
    mae = float((mu.double() - yh).abs().mean())
    mae64 = float((mu64 - yh).abs().mean())
    e32, e64 = eig_counts(nf.eigs), eig_counts(nf64.eigs)
    print(f"  16.2 config 3: NystromFeatures n = {CONFIG3_N}, m = {CONFIG3_M}"
          f", fit + mean_std on {CONFIG3_HEAD}: median {stats['wall_s']!r} s,"
          f" IQR {stats['wall_iqr_s']!r} s (warm-up {stats['warmup_s']!r} s;"
          f" counted run {wall!r} s, launches {nonzero(counts)}); "
          f"train_mae_head {mae!r} (float64 {mae64!r}, bar ±"
          f"{CONFIG3_MAE_ATOL}); mean against the float64 model on the same "
          f"landmarks {mean_err!r} of max|μ64| (bar {CONFIG3_MEAN_RTOL})")
    print(f"    landmark eigenvalues above the {EIG_CUT} cut / of those under "
          f"1e-6·λmax: f32 Gram {e32}, float64 Gram {e64}")
    assert mean_err <= CONFIG3_MEAN_RTOL, mean_err
    assert abs(mae - mae64) <= CONFIG3_MAE_ATOL, (mae, mae64)
    assert counts["gram"] > 0, counts
    C = nf.C
    for fam, nu, gamma, col in CONFIG3_ATOMS:
        xs = x[:, col:col + 1] / gamma
        scaled_gram_check("config 3 cross", xs, xs[C], fam, nu)
        scaled_gram_check("config 3 landmarks", xs[C], xs[C], fam, nu)
        scaled_gram_check("config 3 serving", xs[:CONFIG3_HEAD], xs[C], fam,
                          nu)
    del nf, nf64
    torch.cuda.empty_cache()
    return {**stats, "train_mae_head": mae, "train_mae_head_f64": mae64,
            "mean_vs_f64": mean_err, "eigs_f32": e32, "eigs_f64": e64,
            "launches": nonzero(counts)}


def pathwise_phase(dev):
    """16.3: IterativeGP.sample_pathwise on a lazy GP (see PATHWISE_N's
    note)."""
    xn, yn, xtn = config2_data(PATHWISE_N, PATHWISE_T)
    kernel = KernelFunction(kernel_name="squared_exponential",
                            gamma=PATHWISE_GAMMA, d=2, device=dev)
    gp = IterativeGP(kernel, s=PATHWISE_S, lazy=True,
                     maxiter=PATHWISE_MAXITER)
    _, fit_s, fit_counts = counted(lambda: gp.fit_gp(xn, yn))
    emb = HermiteEmbedding(gamma=PATHWISE_GAMMA, m=512, d=2, device=dev)
    xt = gp._tensor(xtn)
    gen = torch.Generator(device=dev)

    def draw():
        gen.manual_seed(0)
        return gp.sample_pathwise(xt, emb, size=PATHWISE_DRAWS, generator=gen)

    paths, wall, counts = counted(draw)
    # the correction the paths carry, from the same draws and the same CG
    gen.manual_seed(0)
    theta = torch.randn((emb.get_m(), PATHWISE_DRAWS), generator=gen,
                        device=dev)
    resid = gp.y - emb.embed(gp.x) @ theta
    corr, its, _ = iterative._cg_columns(gp._matmat, resid, iterative._identity,
                                         gp.tol, gp.maxiter, None)
    again = emb.embed(xt) @ theta + kernel.cross(xt, gp.x) @ corr
    same = float((again - paths).abs().max() / paths.abs().max())
    x64, c64, r64 = gp.x.double(), corr.double(), resid.double()
    r = r64 - PATHWISE_S ** 2 * c64
    for r0 in range(0, PATHWISE_N, 4096):
        r[r0:r0 + 4096] -= kernel_matrix("se", PATHWISE_GAMMA,
                                         x64[r0:r0 + 4096], x64) @ c64
    col_resid = torch.linalg.vector_norm(r, dim=0) / torch.linalg.vector_norm(
        r64, dim=0)
    worst = float(col_resid.max())
    del r, r64, c64
    mu64, var64, _ = reference_f64(gp.x, gp.y, xt, family="se",
                                   gamma=PATHWISE_GAMMA, s=PATHWISE_S)
    torch.cuda.empty_cache()
    Pt, Px = emb.embed(xt).double(), emb.embed(gp.x[:4096]).double()
    emb_err = float((Pt @ Px.T - kernel_matrix(
        "se", PATHWISE_GAMMA, xt.double(), x64[:4096])).abs().max())
    pd = paths.double()
    se = torch.sqrt(var64.clamp_min(0.0)) / math.sqrt(PATHWISE_DRAWS)
    excess = float(((pd.mean(dim=1) - mu64).abs()
                    - (DRAW_SE * se + emb_err)).max())
    mean_se = float(((pd.mean(dim=1) - mu64).abs() / se).max())
    var_ratio = float((pd.var(dim=1) / var64).median())
    print(f"  16.3 sample_pathwise, lazy IterativeGP n = {PATHWISE_N}, d = 2, "
          f"SE({PATHWISE_GAMMA}), s = {PATHWISE_S}: fit {fit_s!r} s "
          f"(fit_status {gp.fit_status}; launches {nonzero(fit_counts)}); "
          f"{PATHWISE_DRAWS} paths at {PATHWISE_T} points: {wall!r} s "
          f"(launches {nonzero(counts)}); CG iterations per path min "
          f"{int(its.min())} "
          f"max {int(its.max())}; the paths rebuilt from the same CG within "
          f"{same!r}")
    print(f"    float64 residual of each path's correction: max {worst!r} "
          f"(bar {PATHWISE_RESIDUAL_MAX}); paths' mean against the dense "
          f"float64 mean: max |x̄ − μ64|/(σ64/√{PATHWISE_DRAWS}) {mean_se!r},"
          f" the embedding's kernel error {emb_err!r}, max excess over "
          f"{DRAW_SE}·SE + that error {excess!r} (must be ≤ 0); median "
          f"var(paths)/var64 {var_ratio!r}")
    assert same <= 1e-5, same
    assert worst <= PATHWISE_RESIDUAL_MAX, worst
    assert excess <= 0.0, excess
    assert counts["gram"] > 0 and counts["gram_matmat"] > 0, counts
    assert fit_counts["gram_matvec"] > 0, fit_counts
    xs, xts = gp.x / PATHWISE_GAMMA, xt / PATHWISE_GAMMA
    scaled_gram_check("pathwise K(xtest, x)", xts, xs, "se", 1.5)
    e, rel = matvec_error(gram_matmat_scaled, xs, xs, corr, "se", 1.5)
    print(f"    gram_matmat {PATHWISE_N}x{PATHWISE_N} d=2 r={PATHWISE_DRAWS}: "
          f"max abs err {e!r}, max err / sum|K||V| {rel!r} (bar "
          f"{matvec_rtol(PATHWISE_N)!r}), repeatable")
    assert rel <= matvec_rtol(PATHWISE_N), rel
    e, rel = matvec_error(gram_matvec_scaled, xs, xs, gp.y[:, 0], "se", 1.5)
    print(f"    gram_matvec {PATHWISE_N}x{PATHWISE_N} d=2: max abs err {e!r}, "
          f"max err / sum|K||v| {rel!r} (bar {matvec_rtol(PATHWISE_N)!r}), "
          "repeatable")
    assert rel <= matvec_rtol(PATHWISE_N), rel
    del gp, corr, resid, mu64, var64
    torch.cuda.empty_cache()
    return {"wall_s": wall, "fit_s": fit_s, "residual_max": worst,
            "cg_iterations": [int(its.min()), int(its.max())],
            "mean_se_max": mean_se, "embedding_kernel_err": emb_err,
            "var_ratio_median": var_ratio, "launches": nonzero(counts),
            "fit_launches": nonzero(fit_counts)}


# ---------------------------------------------------------------------------
# phase 17: the Poisson point-process slice, and run_all.py config 5
# ---------------------------------------------------------------------------

def poisson_rate(x, dt=1.0):
    """benchmarks/run_all.py:176-179: λ(x) = 2.5·exp(−2‖x‖²) + 0.3."""
    return (2.5 * torch.exp(-torch.sum(x**2, dim=1, keepdim=True) * 2)
            + 0.3) * dt


def poisson_model(dev, dtype, levels, m, gamma):
    """(hierarchy, process, estimator) of config 4's model with `levels`,
    `m` and SE(γ); in float64 the kernel evaluates its plain version
    (`plain64_kernel`), so the only hand-kernel launches are the f32
    model's."""
    h = HierarchicalBorelSets(2, [[-1.0, 1.0], [-1.0, 1.0]], levels=levels,
                              device=dev, dtype=dtype)
    k = (plain64_kernel(dev, "squared_exponential", gamma, 2)
         if dtype == torch.float64 else
         KernelFunction(kernel_name="squared_exponential", gamma=gamma, d=2,
                        device=dev))
    p = PoissonPointProcess(d=2, B=3.0, rate=poisson_rate)
    return h, p, PoissonRateEstimator(p, h, m=m, kernel_object=k,
                                      device=dev, dtype=dtype, **POISSON_EST)


def poisson_data(p, leaves, dt, seed):
    """Every leaf sensed for dt, its points drawn by the port's process on
    S's 16-point grid (run_all.py:194-198) from a generator on the card
    seeded `seed`; returns the rounds."""
    g = torch.Generator(device=leaves[0].device).manual_seed(seed)
    return [(S, p.sample_discretized(g, S, dt, n=16), dt) for S in leaves]


def _on_card(args, kwargs):
    """Whether an aten call's arguments hold a CUDA tensor: at the top level
    or in a list (Tensor, Tensor? and Tensor[] are aten's only tensor
    arguments), read without flattening them as a pytree, which cost
    ~20 µs an operation (the permanental cold fit runs 1.33 M
    operations)."""
    for a in (*args, *(kwargs or {}).values()):
        if isinstance(a, torch.Tensor):
            if a.is_cuda:
                return True
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor) and b.is_cuda:
                    return True
    return False


class DeviceOps(TorchDispatchMode):
    """Counts the aten operations on CUDA tensors that are not views (each
    launches one kernel or more on the card, or copies to the host), and
    the host reads among them."""

    READS = frozenset((torch.ops.aten._local_scalar_dense.default,
                       torch.ops.aten.equal.default))

    def __init__(self):
        super().__init__()
        self.ops = self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and _on_card(args, kwargs):
            self.ops += 1
            self.reads += func in self.READS
        return out


def device_ops(fn):
    """(fn()'s result, its device operations, its host reads)."""
    with DeviceOps() as c:
        out = fn()
    return out, c.ops, c.reads


def lbfgs_iterations(fn):
    """(fn()'s result, the iterations of each MAP L-BFGS it ran), the
    estimator module's `minimize_lbfgs` wrapped for the call."""
    orig, its = pre_module.minimize_lbfgs, []

    def wrapped(*args, **kwargs):
        res = orig(*args, **kwargs)
        its.append(res.iterations)
        return res

    pre_module.minimize_lbfgs = wrapped
    try:
        return fn(), its
    finally:
        pre_module.minimize_lbfgs = orig


def grid_gram_check(label, est, gamma):
    """gram_df at the basis grid's shape against its plain version, and
    its time there: (max abs error, ms)."""
    t = est.packing.grid_nodes64()
    e = gram_df_check(label, t, t, "se", 1.0, gamma)[0]
    ts = scale_coords(t, gamma)
    ms = cuda_ms(lambda: gram_df_scaled(ts, ts, 1.0, "se", 1.0))
    print(f"    gram_df {label} {t.shape[0]}x{t.shape[0]}: {ms!r} ms")
    return e, ms


def poisson_fit_phase(dev, label, levels, m, gamma, dt, fit_reps):
    """Build the f32 model (its basis grid's double-float Gram is its one
    `gram_df` launch), load its rounds and fit, counted; then the warm
    refit from the cold fit's rate timed `fit_reps` times (`timed_reps`),
    or once where 0, and once more with its device operations counted;
    the float64 model on the same rounds; the totals against each other
    and the truth. Returns ((h, est, h64, est64), record)."""
    (h, p, est), build_s, build_counts = counted(
        lambda: poisson_model(dev, torch.float32, levels, m, gamma))
    leaves = h.get_sets_level(levels)
    data = poisson_data(p, leaves, dt, seed=0)
    n_pts = sum(0 if o is None else o.shape[0] for _, o, _ in data)
    _, cold_s, fit_counts = counted(lambda: (est.load_data(data),
                                             est.fit_gp()))
    counts = {k: build_counts[k] + fit_counts[k] for k in build_counts}
    rate_cold = est.rate.clone()

    def warm_fit():
        # every timed and counted refit is the same work: the warm refit
        # from the cold fit's rate
        est.rate = rate_cold.clone()
        return est.fit_gp()

    if fit_reps:
        stats, _ = timed_reps(warm_fit, fit_reps)
    else:
        _, warm_s, _ = counted(warm_fit)
        stats = {"wall_s": warm_s}
    (_, fit_ops, fit_reads), fit_its = lbfgs_iterations(
        lambda: device_ops(warm_fit))
    h64, _, est64 = poisson_model(dev, torch.float64, levels, m, gamma)
    est64.load_data([(S, None if o is None else o.double(), dt)
                     for S, (_, o, _) in zip(h64.get_sets_level(levels), data)])
    _, fit64_s, _ = counted(est64.fit_gp)
    total = float(est.mean_set(h.top_node)[0])
    total64 = float(est64.mean_set(h64.top_node)[0])
    true = p.rate_volume(h.top_node, dt=1.0)
    gap64, gap_true = abs(total - total64) / total64, abs(total - true) / true
    print(f"  {label}: {len(leaves)} leaf sets, {est.get_m()} basis "
          f"functions, SE γ = {gamma}, dt = {dt} per leaf, {n_pts} points; "
          f"model build (Γ^½ "
          f"and the {len(leaves)} basis integrals) {build_s!r} s; load + "
          f"cold fit {cold_s!r} s (launches {nonzero(counts)}); warm fit_gp "
          f"median {stats['wall_s']!r} s"
          + (f", IQR {stats['wall_iqr_s']!r} s over {fit_reps}" if fit_reps
             else "") + f"; one warm fit: {fit_its} L-BFGS iterations, "
          f"{fit_ops} device operations, {fit_reads} host reads; the float64 "
          f"model's fit {fit64_s!r} s")
    print(f"    fitted total {total!r} against the true {true!r} (rel "
          f"{gap_true!r}, run_all.py's bar {POISSON_TRUE_RTOL}) and the "
          f"float64 model's {total64!r} (rel {gap64!r}, bar "
          f"{POISSON_TOTAL_RTOL})")
    assert counts["gram_df"] > 0, counts
    assert bool(torch.isfinite(est.rate).all()) and est.rate.shape == (
        est.get_m(),)
    assert gap_true <= POISSON_TRUE_RTOL, (total, true)
    assert gap64 <= POISSON_TOTAL_RTOL, (total, total64)
    e, gram_ms = grid_gram_check(f"{label} basis grid", est, gamma)
    return (h, est, h64, est64), {
        **stats, "build_s": build_s, "cold_fit_s": cold_s,
        "fit_device_ops": fit_ops, "fit_host_reads": fit_reads,
        "fit_lbfgs_iterations": fit_its,
        "float64_fit_s": fit64_s, "points": n_pts, "leaf_sets": len(leaves),
        "basis_functions": est.get_m(), "fitted_total": total,
        "true_total": true, "float64_total": total64,
        "total_vs_f64": gap64, "total_vs_true": gap_true,
        "gram_df_max_err": e, "gram_df_ms": gram_ms,
        "launches": nonzero(counts)}


def slice_ops(est, sets):
    """(device operations, host reads) of one `ucb_lcb_actions` call on
    `sets`, counted (`device_ops`) on calls whose ascent is cut to 1 and
    2 steps: every loop of the solve has a fixed length, so each count is
    n(1) + (steps − 1)·(n(2) − n(1)) at the default 150 steps."""
    orig = pre_module.maximize_on_elliptical_slice
    steps = inspect.signature(orig).parameters["max_iter"].default
    n = {}
    try:
        for k in (1, 2):
            pre_module.maximize_on_elliptical_slice = functools.partial(
                orig, max_iter=k)
            n[k] = device_ops(lambda: est.ucb_lcb_actions(sets))[1:]
    finally:
        pre_module.maximize_on_elliptical_slice = orig
    return tuple(n[1][i] + (steps - 1) * (n[2][i] - n[1][i]) for i in (0, 1))


def poisson_bounds_phase(label, models, level, scalar):
    """`ucb_lcb_actions` over the sets of `level` on the f32 fit, timed,
    its device operations counted (`slice_ops`), and on the float64 model
    given the same rate; lcb ≤ map ≤ ucb, and each bound within
    POISSON_BOUND_RTOL of float64's. With `scalar`, the scalar route of
    `ucb` and `lcb` on the set of largest ucb too, against its batched
    row."""
    h, est, h64, est64 = models
    sets, sets64 = h.get_sets_level(level), h64.get_sets_level(level)
    (m32, u32, l32), wall, counts = counted(lambda: est.ucb_lcb_actions(sets))
    ops, reads = slice_ops(est, sets)
    rate64 = est64.rate
    est64.rate = est.rate.double()
    (m64, u64, l64), wall64, _ = counted(lambda: est64.ucb_lcb_actions(sets64))
    est64.rate = rate64
    # each bound's error over the larger of |its float64 value| and the
    # set's float64 map: an lcb on the box floor is 0 up to rounding
    scale = [torch.maximum(b.abs(), m64.abs()) for b in (m64, u64, l64)]
    errs = [float(((a.double() - b).abs() / sc).max())
            for (a, b), sc in zip(((m32, m64), (u32, u64), (l32, l64)), scale)]
    plain = [float(((a.double() - b).abs() / b.abs()).max())
             for a, b in ((m32, m64), (u32, u64), (l32, l64))]
    order_ok = bool((l32 <= m32).all() and (m32 <= u32).all())
    out = {"wall_s": wall, "float64_wall_s": wall64, "device_ops": ops,
           "host_reads": reads, "map_err": errs[0], "ucb_err": errs[1],
           "lcb_err": errs[2], "plain_rel_err": plain,
           "lcb64_min": float(l64.min()),
           "actions": len(sets), "above_map": int((u32 > m32).sum())}
    print(f"  {label}: ucb_lcb_actions over the {len(sets)} sets of level "
          f"{level} ({2 * len(sets)} ellipsoid-slice solves in one batch, "
          f"{out['above_map']} ucb above their map): {wall!r} s, {ops} "
          f"device operations and {reads} host reads; the float64 model on "
          f"the same rate {wall64!r} s; max err over max(|bound64|, map64): "
          f"map {errs[0]!r}, ucb {errs[1]!r}, lcb {errs[2]!r} (bar "
          f"{POISSON_BOUND_RTOL}; plain rel {plain}, smallest float64 lcb "
          f"{out['lcb64_min']!r}); lcb ≤ map ≤ ucb: {order_ok}")
    assert order_ok, (l32, m32, u32)
    assert max(errs) <= POISSON_BOUND_RTOL, errs
    assert not any(counts.values()), counts
    if scalar:
        # the scalar route `ucb` and `lcb` each take: one action's
        # (map, ucb, lcb) by two solves, ±φ
        top = int(torch.argmax(u32))
        est.approx_fit = False
        (_, ucb, lcb), s_wall, _ = counted(lambda: est.mean_var_laplace_set(
            sets[top], 1.0, est.beta(0)))
        sc = max(abs(float(u32[top])), abs(float(m32[top])))
        s_errs = [abs(ucb - float(u32[top])) / sc,
                  abs(lcb - float(l32[top])) / max(abs(float(l32[top])),
                                                   abs(float(m32[top])))]
        print(f"    set {top} (largest ucb): the scalar route's ucb {ucb!r} "
              f"and lcb {lcb!r} ({s_wall!r} s, two solves) against the "
              f"batched row: rel {s_errs} (bar {POISSON_BOUND_RTOL})")
        assert max(s_errs) <= POISSON_BOUND_RTOL, s_errs
        out |= {"scalar_wall_s": s_wall, "scalar_rel_err": s_errs}
    return out


def config4_phase(dev):
    """17.1 and 17.2: run_all.py config 4 as written (see POISSON_GAMMA's
    note)."""
    models, fit = poisson_fit_phase(dev, "17.1 config 4", CONFIG4_LEVELS,
                                    CONFIG4_M, POISSON_GAMMA, CONFIG4_DT,
                                    FEATURE_REPS)
    bounds = poisson_bounds_phase("17.2 config 4 bounds", models,
                                  CONFIG4_LEVELS, scalar=True)
    sampled = poisson_sample_check(models[1])
    del models
    torch.cuda.empty_cache()
    return {"fit": fit, "bounds": bounds, "sample": sampled}


def poisson_sample_check(est):
    """One posterior draw (`sample`, its default proximal Langevin route,
    1000 steps) on the f32 fit: finite, and its w = Γ^{1/2}θ in the box."""
    (theta), wall, counts = counted(est.sample)
    l, _, u = est.get_constraints()
    w = est.cov() @ theta
    slack = 1e-3 * float(u.max())
    ok = bool(torch.isfinite(theta).all() and (w >= l - slack).all()
              and (w <= u + slack).all())
    print(f"    sample ({est.sampling}, 1000 steps): {wall!r} s; θ finite and "
          f"w = Γ^½θ in [l, u] within {slack}: {ok}")
    assert ok and not any(counts.values()), counts
    return {"wall_s": wall, "sampling": est.sampling}


def poisson_user_phase(dev):
    """17.3: the user-sized map (see USER_LEVELS' note)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    emb = TriangleEmbedding(2, USER_M, kernel_object=KernelFunction(
        kernel_name="squared_exponential", gamma=USER_GAMMA, d=2,
        device=dev), B=POISSON_EST["B"], offset=0.1, s=math.sqrt(1e-7),
        device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb.cov()
    torch.cuda.synchronize()
    cov_s = time.perf_counter() - t0
    del emb
    models, fit = poisson_fit_phase(dev, "17.3 user size", USER_LEVELS,
                                    USER_M, USER_GAMMA, USER_DT, 0)
    h, est = models[:2]
    (mean_top,), mean_s, _ = counted(lambda: est.mean_set(h.top_node))
    bounds = poisson_bounds_phase("17.3 user-size bounds", models,
                                  USER_ACTION_LEVEL, scalar=False)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"  17.3: Γ^½ build alone (float64 pinv and symsqrt of "
          f"{USER_M**2}², on the card) {cov_s!r} s; mean_set on the top set "
          f"{float(mean_top)!r} in {mean_s!r} s; peak memory above the start "
          f"{peak!r} GiB")
    del models
    torch.cuda.empty_cache()
    return {"fit": fit, "bounds": bounds, "cov_build_s": cov_s,
            "peak_gib": peak}


def config5_data():
    """run_all.py:222-228 (numpy seed 4): x ~ U(−1, 1)^(256 × 1), y =
    log(2.5·exp(−4x²) + 0.3) + 0.05ε."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (CONFIG5_N, 1))
    return x, np.log(2.5 * np.exp(-4 * x**2) + 0.3) + 0.05 * \
        rng.standard_normal((CONFIG5_N, 1))


def config5_phase(dev):
    """17.4: run_all.py config 5 as written (see CONFIG5_N's note)."""
    x, y = config5_data()
    gp = GaussianProcess(device=dev, **CONFIG5_GP)
    gp.fit_gp(x, y)
    _, cold_s, counts = counted(lambda: gp.optimize_params(**CONFIG5_FIT))
    gamma_cold = float(gp.kernel_object.params_dict["0"]["gamma"])
    stats, _ = timed_reps(lambda: gp.optimize_params(**CONFIG5_FIT))
    gamma = float(gp.kernel_object.params_dict["0"]["gamma"])
    hm = gp.hyperopt_metrics
    t0 = time.perf_counter()
    ref = float64_gp(x, y, **CONFIG5_GP)
    ref.optimize_params(**CONFIG5_FIT)
    ref_s = time.perf_counter() - t0
    gamma64 = float(ref.kernel_object.params_dict["0"]["gamma"])
    rel_cold, rel = (abs(g - gamma64) / gamma64 for g in (gamma_cold, gamma))
    its = np.asarray(hm["iterations"])
    conv = int(np.asarray(hm["converged"]).sum())
    print(f"  17.4 config 5: optimize_params(bandwidth, 64 restarts, maxiter "
          f"40) on n = {CONFIG5_N}: the first (cold) fit {cold_s!r} s "
          f"(launches {nonzero(counts)}), then median {stats['wall_s']!r} s, "
          f"IQR {stats['wall_iqr_s']!r} s over {FEATURE_REPS}; route "
          f"{hm['route']}, chunk {hm.get('chunk')}; γ {gamma!r} (cold fit "
          f"{gamma_cold!r}) against the float64 CPU fit's {gamma64!r} "
          f"({ref_s!r} s): rel {rel!r} / {rel_cold!r} (bar "
          f"{FIT_GAMMA_RTOL}); restarts' iterations mean {its.mean()!r}, max "
          f"{int(its.max())}, converged {conv} of {its.size}")
    assert counts["gram"] > 0, counts
    assert max(rel, rel_cold) <= FIT_GAMMA_RTOL, (gamma, gamma_cold, gamma64)
    xs = gp.x / gamma
    e = scaled_gram_check("config 5 fit", xs, xs, "se", 1.5)
    gram_ms = cuda_ms(lambda: gram_scaled(xs, xs, 1.0, "se", 1.5))
    print(f"    gram config 5 fit {CONFIG5_N}x{CONFIG5_N} d=1: {gram_ms!r} ms")
    return {**stats, "cold_fit_s": cold_s, "gamma": gamma,
            "gamma_cold": gamma_cold, "gamma64": gamma64,
            "gamma_rel_err": rel, "gamma_cold_rel_err": rel_cold,
            "iterations_mean": float(its.mean()),
            "iterations_max": int(its.max()), "converged": conv,
            "route": hm["route"], "reference_s": ref_s, "gram_max_err": e,
            "gram_ms": gram_ms, "launches": nonzero(counts)}


# ---------------------------------------------------------------------------
# phase 18: the kernel tail and the general double tier, the group and
# manifold fits, and the link, log-linear, MBR and Bernoulli estimators
# ---------------------------------------------------------------------------

def float64_model(kernel, **gp_kw):
    """A float64 GaussianProcess on the card around `kernel` (float64,
    plain atoms)."""
    return GaussianProcess(kernel=plain64_atoms(kernel), s=S, **gp_kw)


def f64_posterior(kernel, x, y, xt):
    """(μ64, var64) of the float64 model on `kernel` (1-D tensors)."""
    mu, sd = float64_model(kernel).fit_predict(x.double(), y.double(),
                                               xt.double())
    out = mu[:, 0].clone(), (sd[:, 0] ** 2).clone()
    del mu, sd
    torch.cuda.empty_cache()
    return out


def gram_df_l1_checks(dev):
    """Phase 2: the L1 (Laplace) family of gram_df against its plain
    version at the bench shape (16384², d = 8, γ = 2) and at
    tools/kernel_ab.py's ragged gram_l1 shapes; error of hi + lo over its
    magnitude (GRAM_DF_RTOL). Returns (max abs error, (kernel ms, plain
    ms), bound) at the bench shape."""
    rng = np.random.default_rng(3)
    g2 = LAPLACE_GAMMA ** 2
    err, times = 0.0, None
    for label, (n, m, d) in (("bench", (N, N, D)), *(
            ("ragged", shape) for shape in L1_RAGGED)):
        a = torch.as_tensor(rng.uniform(-1, 1, (n, d)), device=dev) / g2
        b = a if label == "bench" else torch.as_tensor(
            rng.uniform(-1, 1, (m, d)), device=dev) / g2
        hi, lo = gram_df_scaled(a, b, 1.0, "laplace")
        hp, lp = gram_df_plain(a, b, 1.0, "laplace")
        ref = hp.double() + lp.double()
        diff = (hi.double() + lo.double() - ref).abs()
        e, rel = float(diff.max()), float((diff / ref.abs()).max())
        del hi, lo, hp, lp, ref, diff
        torch.cuda.empty_cache()
        print(f"    gram_df l1 {label} {n}x{m} d={d}: max abs err {e!r}, max "
              f"rel err {rel!r} (bar {GRAM_DF_RTOL})")
        assert rel <= GRAM_DF_RTOL, (label, rel)
        err = max(err, e)
        if label == "bench":
            times = timed_pair(lambda: gram_df_scaled(a, b, 1.0, "laplace"),
                               lambda: gram_df_plain(a, b, 1.0, "laplace"))
        del a, b
        torch.cuda.empty_cache()
    bnd = gram_bounds(N, N, D)["gram_df"]
    print(f"  gram_df l1 bench {N}x{N} d={D}: kernel {times[0]!r} ms, plain "
          f"{times[1]!r} ms, bound {bnd[0]!r} ms ({bnd[1]}; gram_df's bytes "
          f"bound)")
    return err, times, bnd


def laplace_double_phase(dev):
    """18.1: the Laplace kernel (γ = 2) in the double tier, the L1 family
    of gram_df, at var_refine 0 and 1, against the port's float64 model on
    the plain L1 Gram."""
    x, y, xt = bench_data(dev)
    kw = dict(kernel_name="laplace", gamma=LAPLACE_GAMMA, d=D, device=dev)
    t0 = time.perf_counter()
    mu64, var64 = f64_posterior(KernelFunction(**kw, dtype=torch.float64),
                                x, y, xt)
    ref_s = time.perf_counter() - t0
    out = {"reference_s": ref_s}
    for vr, var_bar in ((0, VAR_MAX_RTOL), (1, REFINED_VAR_MAX_RTOL)):
        gp, mu, sd, counts = run_tier(KernelFunction(**kw), x, y, xt,
                                      precision="double", var_refine=vr)
        m, vmax, vmed = posterior_errors(mu, sd, mu64, var64)
        wall = wall_median(gp, x, y, xt)
        print(f"  18.1 laplace double, var_refine={vr}: mean rel err {m!r} "
              f"(bar {DOUBLE_MEAN_RTOL}), var rel err max {vmax!r} (bar "
              f"{var_bar}) median {vmed!r}; fit_predict warm median of 3 "
              f"{wall!r} s; launches {nonzero(counts)}; the float64 model "
              f"{ref_s!r} s")
        del gp, mu, sd
        torch.cuda.empty_cache()
        assert m <= DOUBLE_MEAN_RTOL and vmax <= var_bar, (vr, m, vmax)
        assert counts["gram_df"] > 0, counts
        out[f"var_refine_{vr}"] = {"mean_rel_err": m, "var_rel_err_max": vmax,
                                   "var_rel_err_median": vmed, "wall_s": wall,
                                   "launches": nonzero(counts)}
    return out


def general_nu_phase(dev):
    """18.2: general-ν Matérn (ν = GENERAL_NU) at the bench shape, single
    and double tier, against the port's float64 model; the Gram's build
    time and the single tier's peak memory (no (n, m, 384) tensor)."""
    x, y, xt = bench_data(dev)
    kw = dict(kernel_name="matern", nu=GENERAL_NU, gamma=GAMMA, d=D,
              device=dev)
    t0 = time.perf_counter()
    mu64, var64 = f64_posterior(KernelFunction(**kw, dtype=torch.float64),
                                x, y, xt)
    ref_s = time.perf_counter() - t0
    k = KernelFunction(**kw)
    build_ms = cuda_ms(lambda: k.cross(x, x), reps=2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gp, mu, sd, counts = run_tier(k, x, y, xt)
    peak = torch.cuda.max_memory_allocated() / 2**30
    single = posterior_errors(mu, sd, mu64, var64)
    del gp, mu, sd
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gpd, mu, sd, dcounts = run_tier(k, x, y, xt, precision="double")
    double_s = time.perf_counter() - t0
    double = mean_error(mu, mu64)
    del gpd, mu, sd
    torch.cuda.empty_cache()
    print(f"  18.2 Matérn ν = {GENERAL_NU}, γ = {GAMMA}: the f32 Gram "
          f"{x.shape[0]}x{x.shape[0]} built in {build_ms!r} ms (the 384-node "
          f"scan); single "
          f"tier mean rel err {single[0]!r} (bar {GENERAL_SINGLE_MEAN_RTOL}), "
          f"var rel err max {single[1]!r} (bar {VAR_MAX_RTOL}) median "
          f"{single[2]!r}, peak device memory {peak!r} GiB (bar "
          f"{GENERAL_PEAK_GIB} GiB, 3x phase 3's), launches "
          f"{nonzero(counts)}; double tier mean rel err {double!r} (bar "
          f"{DOUBLE_MEAN_RTOL}), cold fit_predict {double_s!r} s, launches "
          f"{nonzero(dcounts)}; the float64 model {ref_s!r} s")
    assert single[0] <= GENERAL_SINGLE_MEAN_RTOL and single[1] <= VAR_MAX_RTOL
    assert peak <= GENERAL_PEAK_GIB, peak
    assert double <= DOUBLE_MEAN_RTOL, double
    assert dcounts["gemv_df"] > 0, dcounts
    return {"gram_build_ms": build_ms, "single": single,
            "single_peak_gib": peak, "double_mean_rel_err": double,
            "double_cold_s": double_s, "reference_s": ref_s,
            "launches": nonzero(counts), "double_launches": nonzero(dcounts)}


def se_linear_kernel(dev, dtype=torch.float32):
    return (KernelFunction(kernel_name="squared_exponential", gamma=GAMMA,
                           d=D, device=dev, dtype=dtype)
            + KernelFunction(kernel_name="linear", d=D, device=dev,
                             dtype=dtype))


def se_linear_double_phase(dev):
    """18.3: SE(γ) + linear in the double tier at the bench shape, against
    the port's float64 model."""
    x, y, xt = bench_data(dev)
    mu64, _ = f64_posterior(se_linear_kernel(dev, torch.float64), x, y, xt)
    gp, mu, sd, counts = run_tier(se_linear_kernel(dev), x, y, xt,
                                  precision="double")
    m = mean_error(mu, mu64)
    wall = wall_median(gp, x, y, xt)
    print(f"  18.3 SE + linear, double tier: mean rel err {m!r} (bar "
          f"{DOUBLE_MEAN_RTOL}); {gp._df_refine_steps_resolved} refinement "
          f"steps; fit_predict warm median of 3 {wall!r} s; launches "
          f"{nonzero(counts)}")
    del gp, mu, sd
    torch.cuda.empty_cache()
    assert m <= DOUBLE_MEAN_RTOL, m
    assert counts["gram_df"] > 0 and counts["gemv_df"] > 0, counts
    return {"mean_rel_err": m, "wall_s": wall, "launches": nonzero(counts)}


def groups_data(n, d, seed):
    """x ~ U(−1, 1)^(n × d), y additive over {0, 1} and {2, ...}."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    y = (np.sin(3 * x[:, 0] * x[:, 1]) + np.cos(2 * x[:, 2:].sum(1)))[:, None]
    return x, y + 0.1 * rng.standard_normal((n, 1))


def groups_phase(dev):
    """18.4: optimize_params(type="groups") with additive ARD over the
    Bell(GROUPS_D) partitions of GROUPS_D coordinates at n = GROUPS_N, the
    f32 model (a gram launch a group) against the float64 model."""
    x, y = groups_data(GROUPS_N, GROUPS_D, seed=5)
    kw = dict(kernel_name="ard", groups=[[i] for i in range(GROUPS_D)],
              ard_gamma=[0.5] * GROUPS_D, d=GROUPS_D, device=dev)
    chosen, walls = {}, {}
    for label, dtype in (("f32", torch.float32), ("float64", torch.float64)):
        k = KernelFunction(**kw, dtype=dtype)
        gp = (GaussianProcess(kernel=k, s=S) if dtype == torch.float32
              else float64_model(k))
        gp.fit_gp(x, y)
        _, walls[label], counts = counted(
            lambda: gp.optimize_params(type="groups"))
        chosen[label] = gp.kernel_object._atoms[0].static["groups"]
        if label == "f32":
            launches = nonzero(counts)
    print(f"  18.4 type='groups', additive ARD, n = {GROUPS_N}, d = "
          f"{GROUPS_D}: {len(generate_groups(GROUPS_D))} partitions; f32 "
          f"model chose {chosen['f32']} in {walls['f32']!r} s (launches "
          f"{launches}), the float64 model {chosen['float64']} in "
          f"{walls['float64']!r} s")
    assert chosen["f32"] == chosen["float64"], chosen
    assert launches.get("gram", 0) > 0, launches
    return {"partitions": len(generate_groups(GROUPS_D)),
            "chosen": chosen["f32"], "wall_s": walls["f32"],
            "float64_wall_s": walls["float64"], "launches": launches}


def cov_phase(dev):
    """18.5: optimize_params(type="covariance" | "rots") of a
    full-covariance SE at n = COV_N, d = COV_D, the f32 model and the
    float64 model from the same starts; the float64 evidence at each fit."""
    x, y = groups_data(COV_N, COV_D, seed=6)
    out = {}
    for kind in ("covariance", "rots"):
        fits = {}
        for label, dtype in (("f32", torch.float32), ("float64", torch.float64)):
            k = KernelFunction(kernel_name="full_covariance_se", d=COV_D,
                               cov=COV0, device=dev, dtype=dtype)
            gp = GaussianProcess(kernel=k, s=S)
            gp.fit_gp(x, y)
            g = torch.Generator(device=dev).manual_seed(3)
            _, wall, _ = counted(lambda: gp.optimize_params(
                type=kind, generator=g, **COV_FIT))
            fits[label] = (gp, wall)
        ref = fits["float64"][0]

        def ev64(C):
            with torch.no_grad():
                return float(ref.log_marginal_params(
                    ref.kernel_object, {"0": {"cov": C}}, S))

        e32 = ev64(fits["f32"][0].kernel_object.params_dict["0"]["cov"])
        e64 = ev64(ref.kernel_object.params_dict["0"]["cov"])
        e0 = ev64(torch.as_tensor(COV0, dtype=torch.float64, device=dev))
        rel = abs(e32 - e64) / abs(e64)
        print(f"  18.5 type={kind!r}, full-covariance SE, n = {COV_N}, d = "
              f"{COV_D}, {COV_FIT}: f32 model {fits['f32'][1]!r} s, float64 "
              f"model {fits['float64'][1]!r} s; float64 evidence at the "
              f"start {e0!r}, at the f32 fit {e32!r}, at the float64 fit "
              f"{e64!r} (rel {rel!r}, bar {COV_EVIDENCE_RTOL})")
        assert rel <= COV_EVIDENCE_RTOL, (kind, e32, e64)
        assert e64 < e0, (kind, e0, e64)
        out[kind] = {"wall_s": fits["f32"][1], "float64_wall_s":
                     fits["float64"][1], "evidence_start": e0,
                     "evidence_f32_fit": e32, "evidence_float64_fit": e64,
                     "rel": rel}
        del fits, ref
    return out


def domain_total(est, S, n=64):
    """∫_S λ̂ by an n-point Gauss-Legendre tensor rule of mean_rate_points
    (every link's own rate)."""
    w, nodes = S.return_legendre_discretization(n)
    lam = est.mean_rate_points(nodes).reshape(-1)
    return float(torch.sum(w.to(lam.dtype) * lam))


def link_models(dev, cls, dtype, **kw):
    """(hierarchy, process, estimator) of config 4's setup for `cls`."""
    h = HierarchicalBorelSets(2, [[-1.0, 1.0], [-1.0, 1.0]],
                              levels=CONFIG4_LEVELS, device=dev, dtype=dtype)
    k = (plain64_atoms(KernelFunction(
        kernel_name="squared_exponential", gamma=POISSON_GAMMA, d=2,
        device=dev, dtype=dtype)) if dtype == torch.float64 else
        KernelFunction(kernel_name="squared_exponential",
                       gamma=POISSON_GAMMA, d=2, device=dev))
    p = PoissonPointProcess(d=2, B=3.0, rate=poisson_rate)
    est = cls(p, h, m=CONFIG4_M, kernel_object=k, device=dev, dtype=dtype,
              **{**POISSON_EST, **kw})
    return h, p, est


def estimator_run(est, fit, total_of, bounds, reps=ESTIMATOR_REPS):
    """The cold fit from the estimator's generator reseeded to
    `ESTIMATOR_SEED` (the float64 model's fit starts from the same draws),
    its launches, device operations and host reads counted (`DeviceOps`),
    its total and one ucb / lcb (timed); then the warm fit_gp median of
    `reps` (None where `reps` is 0)."""
    est.generator.manual_seed(ESTIMATOR_SEED)
    (_, ops, reads), cold_s, counts = counted(lambda: device_ops(fit))
    total = total_of(est)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ucb, lcb = bounds(est)
    torch.cuda.synchronize()
    bound_s = time.perf_counter() - t0
    walls = [counted(fit)[1] for _ in range(reps)]
    q1, q3 = np.percentile(walls, [25, 75]) if walls else (None, None)
    return {"cold_s": cold_s,
            "fit_s": float(np.median(walls)) if walls else None,
            "fit_iqr_s": float(q3 - q1) if walls else None, "device_ops": ops,
            "host_reads": reads, "total": total, "ucb": ucb, "lcb": lcb,
            "ucb_lcb_s": bound_s, "launches": nonzero(counts)}


def poisson_estimators_phase(dev):
    """18.6: each new Poisson-family estimator on config 4's setup
    (levels 3: 16 leaf sets, 64 triangle functions, dt = 20, the port's
    process on the card), f32 and float64 on the same rounds: the fitted
    total ∫λ̂ against the truth and the float64 model's."""
    out = {}
    for name, cls, kw, true_rtol, reps in PHASE18_ESTIMATORS:
        h, p, est = link_models(dev, cls, torch.float32, **kw)
        leaves = h.get_sets_level(CONFIG4_LEVELS)
        data = poisson_data(p, leaves, CONFIG4_DT, seed=0)
        est.load_data(data)
        h64, _, est64 = link_models(dev, cls, torch.float64, **kw)
        est64.load_data([(S_, None if o is None else o.double(), dt)
                         for S_, (_, o, dt) in
                         zip(h64.get_sets_level(CONFIG4_LEVELS), data)])
        top, leaf = h.top_node, leaves[5]

        def bounds(e, leaf=leaf):
            e.approx_fit = False
            return e.ucb(leaf, dt=CONFIG4_DT), e.lcb(leaf, dt=CONFIG4_DT)

        rec = estimator_run(est, est.fit_gp,
                            lambda e: domain_total(e, top), bounds, reps)
        est64.generator.manual_seed(ESTIMATOR_SEED)
        est64.fit_gp()
        total64 = domain_total(est64, h64.top_node)
        true = p.rate_volume(top, dt=1.0)
        gap_true = abs(rec["total"] - true) / true
        gap64 = abs(rec["total"] - total64) / abs(total64)
        warm = (f"warm fit_gp median {rec['fit_s']!r} s (IQR "
                f"{rec['fit_iqr_s']!r} over {reps})" if reps else
                "no warm fit timed")
        print(f"  18.6 {name}: {warm}, cold {rec['cold_s']!r} s under "
              f"DeviceOps; the cold fit "
              f"{rec['device_ops']} device operations, {rec['host_reads']} "
              f"host reads; total {rec['total']!r} against the true {true!r} "
              f"(rel {gap_true!r}, bar {true_rtol}) and "
              f"the float64 model's {total64!r} (rel {gap64!r}, bar "
              f"{POISSON_TOTAL_RTOL}); ucb / lcb of a leaf {rec['ucb']!r} / "
              f"{rec['lcb']!r} in {rec['ucb_lcb_s']!r} s")
        assert gap_true <= true_rtol, (name, rec["total"], true)
        assert gap64 <= POISSON_TOTAL_RTOL, (name, rec["total"], total64)
        out[name] = {**rec, "true_total": true, "float64_total": total64,
                     "total_vs_true": gap_true, "total_vs_f64": gap64}
    return out


def bernoulli_p(S):
    """The known success probability of a leaf: 0.2, or 0.7 right of 0."""
    return 0.2 + 0.5 * float(S.center_point()[0] > 0)


def bernoulli_phase(dev):
    """18.6: BernoulliRateEstimator and LinkBernoulliRateEstimator on
    config 4's hierarchy and basis, BERNOULLI_DRAWS draws a leaf from the
    known p (BernoulliPointProcess on a generator on the card), f32 against
    float64: Σ p̂ over the leaves against Σ p and the float64 model's."""
    out = {}
    for name, cls in (("BernoulliRateEstimator", BernoulliRateEstimator),
                      ("LinkBernoulliRateEstimator",
                       LinkBernoulliRateEstimator)):
        models = {}
        for dtype in (torch.float32, torch.float64):
            h = HierarchicalBorelSets(2, [[-1.0, 1.0], [-1.0, 1.0]],
                                      levels=CONFIG4_LEVELS, device=dev,
                                      dtype=dtype)
            k = KernelFunction(kernel_name="squared_exponential",
                               gamma=POISSON_GAMMA, d=2, device=dev,
                               dtype=dtype)
            if dtype == torch.float64:
                plain64_atoms(k)
            models[dtype] = (h, cls(h, d=2, m=CONFIG4_M, kernel_object=k,
                                    s=0.05, device=dev, dtype=dtype))
        (h, est), (h64, est64) = models[torch.float32], models[torch.float64]
        leaves = h.get_sets_level(CONFIG4_LEVELS)
        proc = BernoulliPointProcess(leaves, d=2, rate=bernoulli_p)
        g = torch.Generator(device=dev).manual_seed(0)
        outcomes = [proc.sample(g, S_, dt=1.0)[1] for S_ in leaves
                    for _ in range(BERNOULLI_DRAWS)]
        for e, hh in ((est, h), (est64, h64)):
            lv = hh.get_sets_level(CONFIG4_LEVELS)
            e.load_data([(lv[i // BERNOULLI_DRAWS], o, 1.0, 1.0, None)
                         for i, o in enumerate(outcomes)])

        def total(e, lv=None):
            lv = lv or leaves
            return sum(e.mean_set(S_) for S_ in lv)

        rec = estimator_run(est, est.fit_gp, total,
                            lambda e: (e.ucb(leaves[5]), e.lcb(leaves[5])))
        est64.generator.manual_seed(ESTIMATOR_SEED)
        est64.fit_gp()
        total64 = total(est64, h64.get_sets_level(CONFIG4_LEVELS))
        true = sum(bernoulli_p(S_) for S_ in leaves)
        gap_true = abs(rec["total"] - true) / true
        gap64 = abs(rec["total"] - total64) / abs(total64)
        print(f"  18.6 {name}: {len(outcomes)} draws; warm fit_gp median "
              f"{rec['fit_s']!r} s (IQR {rec['fit_iqr_s']!r}), one fit "
              f"{rec['device_ops']} device operations, {rec['host_reads']} "
              f"host reads; Σ p̂ {rec['total']!r} against Σ p {true!r} (rel "
              f"{gap_true!r}, bar {POISSON_TRUE_RTOL}) and the float64 "
              f"model's {total64!r} (rel {gap64!r}, bar {POISSON_TOTAL_RTOL});"
              f" ucb / lcb of a leaf {rec['ucb']!r} / {rec['lcb']!r} in "
              f"{rec['ucb_lcb_s']!r} s")
        assert gap_true <= POISSON_TRUE_RTOL, (name, rec["total"], true)
        assert gap64 <= POISSON_TOTAL_RTOL, (name, rec["total"], total64)
        out[name] = {**rec, "true_total": true, "float64_total": total64,
                     "total_vs_true": gap_true, "total_vs_f64": gap64}
    return out


# -- phase 19: approximate inference, MKL and the rest of the point-process
# stack (each f32 model held to the same port model in float64 on the card)
MKL_N, MKL_D, MKL_T = 4096, 4, 1024
# (kernel_name, γ, ν): SE 0.5, Matérn-3/2 0.8, Laplace 1.0
MKL_ATOMS = (("squared_exponential", 0.5, 1.5), ("matern", 0.8, 1.5),
             ("laplace", 1.0, 1.5))
MKL_DRAW = 2             # y: a draw of the Laplace atom, plus noise
MKL_NOISE = 0.1
MKL_ALPHA_ATOL = 1e-3   # CPU rehearsal (tools/phase19_gap.py): 1.4e-98
MKL_MEAN_RTOL = 1e-4     # CPU: 1.5e-5
MKL_FEATURES = 256       # per RFF embedding (SE 0.5, SE 0.8, Laplace 1.0)
MKL_FEATURE_LAM, MKL_FEATURE_S = 1.0, 0.1
MKL_FEATURE_OBJ_RTOL = 0.05  # the group-lasso objective, f32 fit over f64 fit (CPU: 8.5e-3)
MKL_FEATURE_RTOL = 5e-3      # PrimalMKL's mean against float64's (CPU: 5.0e-4)
PRIMAL_OUTER = 3         # PrimalMKL's alternations (10 by default)
PRIMAL_WEIGHT_ATOL = 1e-3    # CPU: 1.1e-150
SGCP_LAM, SGCP_GAMMA = 4000.0, 0.15
SGCP_INDUCING, SGCP_INTEGRATION, SGCP_STEPS, SGCP_T = 256, 4096, 500, 1024
SGCP_NEWTON = 5          # the linear response's Newton steps (20 by default)
SGCP_TRUE_RTOL = 0.1     # the integrated mean rate against the truth (CPU: 3.8e-2)
SGCP_F64_RTOL = 1e-4     # ... against the float64 model's (CPU: 3.1e-6)
SGCP_BAND_RTOL = 0.02    # the bands against the float64 model's (CPU: 2.5e-3)
TMG_D, TMG_SAMPLES = 32, 2000
TMG_F64_SAMPLES = 200    # the float64 run's samples, held to the f32 ones
TMG_MEAN_ATOL = 0.1      # in units of each coordinate's σ
EP_SITES, EP_D, EP_SIGMA, EP_SWEEPS = 512, 16, 0.5, 6
EP_RTOL = 1e-3           # against the conjugate posterior (CPU: f32 1.1e-4, float64 6.3e-5)
MIX_N, MIX_D, MIX_T, MIX_DRAWS = 2048, 2, 256, 20
MIX_GAMMAS = (0.3, 0.6, 1.2)
MIX_MEAN_ATOL = 1e-5      # absolute, |y| ≲ 1.3 (CPU: 2.6e-7)
TRACE_N, TRACE_M = 4096, 8
TRACE_MEAN_RTOL = 1e-4    # CPU: 4.7e-6
TRACE_SD_RTOL = 0.1       # CPU: 2.3e-2 (the f32 V⁻¹ at the ridge λs² = 1e-4)
CONVEX_N, CONVEX_M = 256, 16
CONVEX_RTOL = 0.02        # CPU: 2.9e-3
LIK_N, LIK_D = 4096, 8
LIK_RTOL = 1e-4          # CPU: 3.7e-6


def model_kernel(dev, dtype, name, gamma, d, nu=1.5):
    """A one-atom kernel of `dtype` on `dev`; float64 on its plain atom, as
    the float64 reference models are (`plain64_atoms`)."""
    k = KernelFunction(kernel_name=name, gamma=gamma, nu=nu, d=d, device=dev,
                       dtype=dtype)
    return plain64_atoms(k) if dtype == torch.float64 else k


def synced(fn):
    """(fn(), wall in s up to a synchronize of the card, if any)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mkl_data(dev):
    """19.1's data (numpy seed 19): x, xt uniform in [-1, 1]^4, y a draw of
    MKL_ATOMS[MKL_DRAW] at x (float64 Gram + 1e-8 I, its Cholesky times
    numpy normals) plus N(0, MKL_NOISE²); float64 tensors on `dev`."""
    rng = np.random.default_rng(19)
    x = torch.as_tensor(rng.uniform(-1, 1, (MKL_N, MKL_D)), device=dev)
    xt = torch.as_tensor(rng.uniform(-1, 1, (MKL_T, MKL_D)), device=dev)
    name, g, nu = MKL_ATOMS[MKL_DRAW]
    K = model_kernel(dev, torch.float64, name, g, MKL_D, nu).gram(x)
    K.diagonal().add_(1e-8)
    f = torch.linalg.cholesky(K) @ torch.as_tensor(
        rng.standard_normal(MKL_N), device=dev)
    y = f + MKL_NOISE * torch.as_tensor(rng.standard_normal(MKL_N),
                                        device=dev)
    return x, y[:, None], xt


def mkl_learner(dev, dtype):
    return MultipleKernelLearner(
        [model_kernel(dev, dtype, name, g, MKL_D, nu)
         for name, g, nu in MKL_ATOMS], device=dev, dtype=dtype)


def mkl_embeddings(dev, dtype):
    return [RFFEmbedding(gamma=g, m=MKL_FEATURES, d=MKL_D, kernel=kern,
                         seed=i, device=dev, dtype=dtype)
            for i, (kern, g) in enumerate((("squared_exponential", 0.5),
                                           ("squared_exponential", 0.8),
                                           ("laplace", 1.0)))]


def mkl_fits(dev, x, y, xt):
    """19.1's models in f32 and float64: the learner's α, mean and std on
    xt; the group-lasso MKL's weights and mean; PrimalMKL's weights and
    mean. Returns {dtype: {...}} and the f32 runs' walls and launches."""
    out, runs = {}, {}
    for dt in (torch.float32, torch.float64):
        rec = {}
        lrn = mkl_learner(dev, dt)
        xd, yd, xtd = x.to(dt), y.to(dt), xt.to(dt)
        _, runs_fit = counted_on(dev, lambda: lrn.fit_gp(xd, yd))
        (mu, sd), runs_ms = counted_on(dev, lambda: lrn.mean_std(xtd))
        rec.update(alphas=lrn.alphas.double().cpu(), mu=mu[:, 0].double(),
                   sd=sd[:, 0].double())
        feat = MKL(mkl_embeddings(dev, dt), lam=MKL_FEATURE_LAM,
                   s=MKL_FEATURE_S)
        _, runs_feat = counted_on(dev, lambda: feat.fit_gp(xd, yd))
        rec.update(feature_weights=feat.weights.double().cpu(),
                   feature_theta=feat.theta[:, 0].double(),
                   feature_mu=feat.mean_var(xtd)[0][:, 0].double())
        primal = PrimalMKL(mkl_embeddings(dev, dt), lam=MKL_FEATURE_LAM,
                           s=MKL_FEATURE_S)
        _, runs_primal = counted_on(
            dev, lambda: primal.fit_gp(xd, yd, outer_steps=PRIMAL_OUTER))
        rec.update(primal_weights=primal.weights.double().cpu(),
                   primal_mu=primal.mean_var(xtd)[0][:, 0].double())
        out[dt] = rec
        if dt == torch.float32:
            runs = {"fit": runs_fit, "mean_std": runs_ms,
                    "feature_fit": runs_feat, "primal_fit": runs_primal}
    return out, runs


def counted_on(dev, fn):
    """fn() with the launch counters zeroed before and read after, and its
    wall: (result, {"wall_s", "launches"}); on the CPU the counts stay 0."""
    reset_launch_counts()
    out, wall = synced(fn)
    return out, {"wall_s": wall, "launches": nonzero(launch_counts())}


def rel_gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def group_lasso_objective(dev, x, y, theta):
    """The group-lasso MKL's objective ½‖Qθ − y‖²/s² + λΣ‖θ_g‖ in float64
    (Q of the float64 embeddings)."""
    Q = torch.cat([e.embed(x) for e in mkl_embeddings(dev, torch.float64)],
                  dim=1)
    r = Q @ theta - y[:, 0]
    groups = theta.reshape(len(MKL_ATOMS), MKL_FEATURES)
    return float(0.5 * (r @ r) / MKL_FEATURE_S**2
                 + MKL_FEATURE_LAM * torch.linalg.vector_norm(groups, dim=1)
                 .sum())


def mkl_gaps(fits, dev=None, x=None, y=None):
    f32, f64 = fits[torch.float32], fits[torch.float64]
    obj = {} if dev is None else {"feature_obj_gap": (
        group_lasso_objective(dev, x, y, f32["feature_theta"])
        / group_lasso_objective(dev, x, y, f64["feature_theta"]) - 1.0)}
    return {**obj,
        "alpha_gap": float((f32["alphas"] - f64["alphas"]).abs().max()),
        "mean_gap": rel_gap(f32["mu"], f64["mu"]),
        "feature_gap": rel_gap(f32["feature_mu"], f64["feature_mu"]),
        "primal_weight_gap": float(
            (f32["primal_weights"] - f64["primal_weights"]).abs().max()),
        "primal_gap": rel_gap(f32["primal_mu"], f64["primal_mu"]),
        "choice32": int(torch.argmax(f32["alphas"])),
        "choice64": int(torch.argmax(f64["alphas"])),
    }


def mkl_kernel_checks(x, xt):
    """gram and gram_l1 at 19.1's shapes (its Grams K(x, x) and cross Grams
    K(xt, x), d = 4) against their plain versions, timed in turns against
    their bounds."""
    errs, times, bounds = {"gram": 0.0, "gram_l1": 0.0}, {}, {}
    xf, xtf = x.float(), xt.float()
    for name, g, nu in MKL_ATOMS:
        for label, a in (("K(x, x)", xf), ("K(xt, x)", xtf)):
            if name == "laplace":
                errs["gram_l1"] = max(errs["gram_l1"], gram_l1_check(
                    f"19.1 {label}", a, xf, g))
            else:
                fam = "se" if name == "squared_exponential" else "matern"
                errs["gram"] = max(errs["gram"], scaled_gram_check(
                    f"19.1 {label}", a / g, xf / g, fam, nu))
    n, d = MKL_N, MKL_D
    times["gram"] = timed_pair(
        lambda: gram_scaled(xf / 0.5, xf / 0.5, 1.0, "se"),
        lambda: gram_plain(xf / 0.5, xf / 0.5, 1.0, "se"))
    times["gram_l1"] = timed_pair(lambda: gram_l1(xf, xf, 1.0, 1.0),
                                  lambda: gram_l1_plain(xf, xf, 1.0, 1.0))
    b = gram_bounds(n, n, d)
    bounds = {"gram": b["gram"], "gram_l1": b["gram_l1"]}
    for k in ("gram", "gram_l1"):
        print(f"    {k} at 19.1's K(x, x), {n}x{n} d={d}: kernel "
              f"{times[k][0]!r} ms, plain {times[k][1]!r} ms, bound "
              f"{bounds[k][0]!r} ms ({bounds[k][1]})")
    return errs, times, bounds


def mkl_run(dev):
    """19.1's f32 and float64 models and their gaps (no bars)."""
    x, y, xt = mkl_data(dev)
    fits, runs = mkl_fits(dev, x, y, xt)
    return {"alphas_f32": [float(a) for a in fits[torch.float32]["alphas"]],
            "alphas_f64": [float(a) for a in fits[torch.float64]["alphas"]],
            **mkl_gaps(fits, dev, x, y), **runs}, (x, xt)


def mkl_phase(dev):
    """19.1: MultipleKernelLearner on SE(0.5) + Matérn-3/2(0.8) +
    Laplace(1.0) at n = 4096, d = 4, default lam and s, 300 EG steps, then
    mean_std at 1024 points; the group-lasso MKL and PrimalMKL on three
    RFF embeddings of 256 features; f32 against float64."""
    rec, (x, xt) = mkl_run(dev)
    a32, a64 = rec["alphas_f32"], rec["alphas_f64"]
    print(f"  19.1 MultipleKernelLearner, n = {MKL_N}, d = {MKL_D}, y a draw "
          f"of {MKL_ATOMS[MKL_DRAW][0]}: α f32 {a32} against float64 {a64} "
          f"(max gap {rec['alpha_gap']!r}, bar {MKL_ALPHA_ATOL}); the "
          f"largest α on atom {rec['choice32']} (f32) / {rec['choice64']} "
          f"(float64), drawn from {MKL_DRAW}; mean on {MKL_T} points "
          f"{rec['mean_gap']!r} of max|μ64| (bar {MKL_MEAN_RTOL}); fit "
          f"{rec['fit']['wall_s']!r} s, launches {rec['fit']['launches']}; "
          f"mean_std {rec['mean_std']['wall_s']!r} s, launches "
          f"{rec['mean_std']['launches']}")
    print(f"  19.1 MKL (group lasso, 3 x {MKL_FEATURES} RFF features): its "
          f"objective at the f32 fit {rec['feature_obj_gap']!r} relative "
          f"above the float64 fit's (bar {MKL_FEATURE_OBJ_RTOL}); mean "
          f"{rec['feature_gap']!r} of max|μ64| (printed: FISTA's 1000 "
          f"iterations do not converge here, and its paths part), fit "
          f"{rec['feature_fit']['wall_s']!r} s; PrimalMKL ({PRIMAL_OUTER} "
          f"alternations): weights {rec['primal_weight_gap']!r} (bar "
          f"{PRIMAL_WEIGHT_ATOL}), mean {rec['primal_gap']!r} (bar "
          f"{MKL_FEATURE_RTOL}), fit {rec['primal_fit']['wall_s']!r} s")
    assert rec["choice64"] == MKL_DRAW, a64
    assert rec["alpha_gap"] <= MKL_ALPHA_ATOL, rec
    assert rec["mean_gap"] <= MKL_MEAN_RTOL, rec
    assert abs(rec["feature_obj_gap"]) <= MKL_FEATURE_OBJ_RTOL, rec
    assert rec["primal_weight_gap"] <= PRIMAL_WEIGHT_ATOL, rec
    assert rec["primal_gap"] <= MKL_FEATURE_RTOL, rec
    assert rec["fit"]["launches"].get("gram", 0) > 0, rec["fit"]
    assert rec["fit"]["launches"].get("gram_l1", 0) > 0, rec["fit"]
    assert rec["mean_std"]["launches"].get("gram_l1", 0) > 0, rec["mean_std"]
    errs, times, bounds = mkl_kernel_checks(x, xt)
    return {**rec, "kernels": {
        k: {"max_abs_err": errs[k], "ms": times[k][0],
            "plain_ms": times[k][1], "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1]} for k in errs}}


def sgcp_rate(x):
    """The known sigmoidal Cox rate on the unit square: λ σ(3 sin 2πx₀ ·
    cos 2πx₁), λ = SGCP_LAM (its integral is λ/2)."""
    return SGCP_LAM * torch.sigmoid(3.0 * torch.sin(2 * math.pi * x[:, 0])
                                    * torch.cos(2 * math.pi * x[:, 1]))


def sgcp_model(dev, dt, obs):
    S = BorelSet(2, [[0.0, 1.0], [0.0, 1.0]], device=dev, dtype=dt)
    k = model_kernel(dev, dt, "squared_exponential", SGCP_GAMMA, 2)
    return S, SGCPVariational(k, S, obs.to(dt), num_inducing=SGCP_INDUCING,
                              num_integration=SGCP_INTEGRATION, device=dev)


def sgcp_run(dev):
    """19.2's f32 and float64 fits, bands and gaps (no bars)."""
    S64 = BorelSet(2, [[0.0, 1.0], [0.0, 1.0]], device=dev,
                   dtype=torch.float64)
    proc = PoissonPointProcess(d=2, B=SGCP_LAM, b=0.0, rate=sgcp_rate)
    g = torch.Generator(device=dev).manual_seed(19)
    obs = proc.sample_thinning(g, S64)
    truth = proc.rate_volume(S64)
    xt = S64.return_discretization(32)
    rec, res = {}, {}
    for dt in (torch.float32, torch.float64):
        (S, sg), build = counted_on(dev, lambda: sgcp_model(dev, dt, obs))
        elbo, fit = counted_on(dev, lambda: sg.run(steps=SGCP_STEPS))
        w, nodes = S.return_legendre_discretization(64)
        total = float(w @ sg.mean_rate_points(nodes))
        bands, exact = counted_on(dev, lambda: sg.rate_bands_exact(xt))
        lr, lin = counted_on(dev, lambda: sg.rate_bands_linear_response(
            xt, newton_steps=SGCP_NEWTON))
        res[dt] = {"total": total, "bands": [b.double() for b in bands],
                   "lr": [b.double() for b in lr],
                   "mean": sg.mean_rate_points(xt).double()}
        if dt == torch.float32:
            rec = {"events": int(obs.shape[0]), "elbo": elbo, "build": build,
                   "fit": fit, "exact_bands": exact, "linear_response": lin,
                   "shapes": (obs.double(), sg.int_x.double(),
                              sg.Z.double(), xt.double())}
    f32, f64 = res[torch.float32], res[torch.float64]
    lo, hi = f32["bands"]
    return {**rec, "true_total": truth, "total_f32": f32["total"],
            "total_f64": f64["total"],
            "total_vs_true": abs(f32["total"] - truth) / truth,
            "total_vs_f64": abs(f32["total"] - f64["total"]) / f64["total"],
            "exact_band_gap": max(rel_gap(a, b) for a, b in
                                  zip(f32["bands"], f64["bands"])),
            "lr_band_gap": max(rel_gap(a, b) for a, b in
                               zip(f32["lr"], f64["lr"])),
            "mean_inside_band": bool((lo <= f32["mean"] + 1e-6).all()
                                     and (f32["mean"] <= hi + 1e-6).all())}


def sgcp_phase(dev):
    """19.2: the known sigmoidal Cox rate on the unit square, events by the
    port's PoissonPointProcess (thinning, generator seeded 19), an SGCP with
    16² inducing points and 64² quadrature nodes, 500 Adam steps, then the
    exact and the linear-response bands on a 32² grid; f32 against
    float64, the integrated rate against the truth."""
    rec = sgcp_run(dev)
    print(f"  19.2 SGCP: {rec['events']} events, ∫λ true "
          f"{rec['true_total']!r}, fitted (f32) {rec['total_f32']!r} (rel "
          f"{rec['total_vs_true']!r}, bar {SGCP_TRUE_RTOL}), float64 "
          f"{rec['total_f64']!r} (rel {rec['total_vs_f64']!r}, bar "
          f"{SGCP_F64_RTOL}); {SGCP_STEPS} Adam steps {rec['fit']['wall_s']!r}"
          f" s; exact bands {rec['exact_bands']['wall_s']!r} s, gap "
          f"{rec['exact_band_gap']!r}; linear-response bands "
          f"{rec['linear_response']['wall_s']!r} s, gap {rec['lr_band_gap']!r}"
          f" (bar {SGCP_BAND_RTOL}); mean inside the exact band: "
          f"{rec['mean_inside_band']}; launches {rec['fit']['launches']}")
    assert rec["total_vs_true"] <= SGCP_TRUE_RTOL, rec
    assert rec["total_vs_f64"] <= SGCP_F64_RTOL, rec
    assert rec["exact_band_gap"] <= SGCP_BAND_RTOL, rec
    assert rec["lr_band_gap"] <= SGCP_BAND_RTOL, rec
    assert rec["mean_inside_band"]
    # the f32 model's Grams are its double-float Grams (the f32 factor of
    # Kzz fails): held to their plain version at the build's shapes
    assert rec["build"]["launches"].get("gram_df", 0) > 0, rec["build"]
    assert rec["exact_bands"]["launches"].get("gram_df", 0) > 0, rec
    obs, int_x, Z, xt = rec.pop("shapes")
    err = 0.0
    for label, a in (("K(events, Z)", obs), ("K(nodes, Z)", int_x),
                     ("K(Z, Z)", Z), ("K(xt, Z)", xt)):
        e, hi, lo = gram_df_check(f"19.2 {label}", a, Z, "se", 1.5,
                                  SGCP_GAMMA)
        err = max(err, e)
        del hi, lo
    return {**rec, "gram_df_max_abs_err": err}


def tmg_truth(mu, sd):
    """Means of N(μ, σ²) truncated to [0, ∞): μ + σ φ(α)/(1 − Φ(α)),
    α = −μ/σ (float64)."""
    a = -mu / sd
    phi = torch.exp(-0.5 * a * a) / math.sqrt(2 * math.pi)
    return mu + sd * phi / (1.0 - torch.special.ndtr(a))


def tmg_run(dev):
    """19.3's samples in f32 and float64 and their errors (no bars)."""
    mu = torch.linspace(-1.0, 1.0, TMG_D, dtype=torch.float64, device=dev)
    sd = torch.linspace(0.5, 2.0, TMG_D, dtype=torch.float64, device=dev)
    F, gw = torch.eye(TMG_D), torch.zeros(TMG_D)
    out = {}
    for dt, n in ((torch.float32, TMG_SAMPLES),
                  (torch.float64, TMG_F64_SAMPLES)):
        g = torch.Generator(device=dev).manual_seed(19)
        out[dt] = counted_on(dev, lambda: tmg_sample(
            g, n, mu, torch.diag(sd * sd), F, gw, sd, device=dev, dtype=dt))
    xs, run = out[torch.float32]
    return {"wall_s": run["wall_s"], "min": float(xs.min()),
            "mean_err_sigma": float(((xs.double().mean(0)
                                      - tmg_truth(mu, sd)).abs() / sd).max()),
            "gap_f64": rel_gap(xs[:TMG_F64_SAMPLES].double(),
                               out[torch.float64][0])}


def tmg_phase(dev):
    """19.3: exact-HMC samples of a diagonal Gaussian (d = 32, μ from −1 to
    1, σ from 0.5 to 2) truncated to the positive orthant; the f32 samples'
    marginal means against the closed form, and against the float64 run's
    samples from the same generator."""
    rec = tmg_run(dev)
    print(f"  19.3 tmg: {TMG_SAMPLES} samples, d = {TMG_D}, positive orthant: "
          f"{rec['wall_s']!r} s; marginal means within "
          f"{rec['mean_err_sigma']!r} σ of the truncated normal's (bar "
          f"{TMG_MEAN_ATOL}); least coordinate {rec['min']!r} (bar −1e-9); "
          f"the first {TMG_F64_SAMPLES} f32 samples {rec['gap_f64']!r} from "
          f"the float64 run's (bar 1e-6)")
    assert rec["min"] >= -1e-9, rec     # on a wall, to rounding
    assert rec["mean_err_sigma"] <= TMG_MEAN_ATOL, rec
    assert rec["gap_f64"] <= 1e-6, rec
    return rec


def ep_run(dev):
    """19.4 EP's posteriors in f32 and float64 against the conjugate one
    (no bars)."""
    rng = np.random.default_rng(19)
    A = rng.standard_normal((EP_SITES, EP_D)) / math.sqrt(EP_D)
    theta = rng.standard_normal(EP_D)
    y = A @ theta + EP_SIGMA * rng.standard_normal(EP_SITES)
    S_ref = np.linalg.inv(np.eye(EP_D) + A.T @ A / EP_SIGMA**2)
    m_ref = S_ref @ (A.T @ y / EP_SIGMA**2)

    def site(z, datum):
        return torch.exp(-0.5 * (z - datum) ** 2 / EP_SIGMA**2)

    out = {}
    for dt in (torch.float32, torch.float64):
        ep = ExpectedPropagationQuadratic(np.zeros(EP_D), np.eye(EP_D), site,
                                          list(y), A=A, device=dev, dtype=dt)
        (m, S_), run = counted_on(dev, lambda: ep.fit_gp(iterations=EP_SWEEPS))
        out[dt] = (max(float(np.abs(m.double().cpu().numpy() - m_ref).max()
                             / np.abs(m_ref).max()),
                       float(np.abs(S_.double().cpu().numpy() - S_ref).max()
                             / np.abs(S_ref).max())), run["wall_s"])
    return {"wall_s": out[torch.float32][1], "err_f32": out[torch.float32][0],
            "err_f64": out[torch.float64][0]}


def ep_phase(dev):
    """19.4 EP: 512 Gaussian sites a_iᵀθ in d = 16 (numpy seed 19), prior
    N(0, I), EP_SWEEPS sweeps; f32 and float64 against the conjugate
    posterior."""
    rec = ep_run(dev)
    print(f"  19.4 EP, {EP_SITES} sites, d = {EP_D}, {EP_SWEEPS} sweeps: "
          f"posterior {rec['err_f32']!r} (f32) / {rec['err_f64']!r} (float64)"
          f" from the conjugate one (bar {EP_RTOL}), {rec['wall_s']!r} s")
    assert rec["err_f32"] <= EP_RTOL and rec["err_f64"] <= EP_RTOL, rec
    return rec


def mixtures_run(dev):
    """19.4's mixtures in f32 and float64 on the same draws (no bars)."""
    rng = np.random.default_rng(19)
    x = rng.uniform(-1, 1, (MIX_N, MIX_D))
    y = np.sin(3 * x[:, :1]) * np.cos(2 * x[:, 1:]) \
        + 0.1 * rng.standard_normal((MIX_N, 1))
    xt = rng.uniform(-1, 1, (MIX_T, MIX_D))
    rec = {}
    for cls in (DirichletMixture, CategoricalMixture):
        res = {}
        for dt in (torch.float32, torch.float64):
            gps = [GaussianProcess(kernel=model_kernel(
                dev, dt, "squared_exponential", g, MIX_D), s=0.1, d=MIX_D)
                for g in MIX_GAMMAS]
            mix = cls(gps, generator=torch.Generator(device=dev).manual_seed(
                19), device=dev, dtype=dt)
            mix.fit_gp(x, y)
            (mu, sd), run = counted_on(dev, lambda: mix.mean_var(
                xt, N=MIX_DRAWS))
            choice = mix.map_model() if cls is CategoricalMixture else None
            res[dt] = (mu[:, 0].double(), sd[:, 0].double(), run, choice)
        (mu, sd, run, c32), (mu64, _, _, c64) = res[torch.float32], \
            res[torch.float64]
        rec[cls.__name__] = {
            **run, "mean_gap": float((mu - mu64).abs().max()),
            "finite": bool(torch.isfinite(mu).all() and
                           torch.isfinite(sd).all()),
            "sd_range": [float(sd.min()), float(sd.max())],
            "map_model": [c32, c64]}
    return rec


def mixtures_phase(dev):
    """19.4 mixtures: DirichletMixture and CategoricalMixture of three SE
    GPs at n = 2048, d = 2 (numpy seed 19), MIX_DRAWS draws at 256 points
    from generators seeded 19; f32 against float64 on the same draws."""
    rec = mixtures_run(dev)
    for name, r in rec.items():
        print(f"  19.4 {name}: {MIX_DRAWS} draws at {MIX_T} points "
              f"{r['wall_s']!r} s, launches {r['launches']}; mean "
              f"{r['mean_gap']!r} from float64's on the same draws (bar "
              f"{MIX_MEAN_ATOL}); sd in {r['sd_range']}; map_model (f32, "
              f"float64) {r['map_model']}")
        assert r["finite"] and r["mean_gap"] <= MIX_MEAN_ATOL, r
        assert r["map_model"][0] == r["map_model"][1], r
        # the draws' moments factor in float64 on the f32 model's
        # double-float Grams, held to their plain version at its shapes
        assert r["launches"].get("gram_df", 0) > 0, r
    rng = np.random.default_rng(19)      # mixtures_run's points
    x = torch.as_tensor(rng.uniform(-1, 1, (MIX_N, MIX_D)), device=dev)
    rng.standard_normal((MIX_N, 1))
    xt = torch.as_tensor(rng.uniform(-1, 1, (MIX_T, MIX_D)), device=dev)
    err = 0.0
    for g in MIX_GAMMAS:
        for label, a in (("K(x, x)", x), ("K(xt, x)", xt)):
            e, hi, lo = gram_df_check(f"19.4 mixtures {label}", a, x, "se",
                                      1.5, g)
            err = max(err, e)
            del hi, lo
    return {**rec, "gram_df_max_abs_err": err}


def gamma_phase(dev):
    """19.4 GammaContProcess: bench.py's data (n = ntest = 16384, d = 8, SE
    γ = 0.5, s = 0.1), single tier, against the float64 posterior."""
    x, y, xt = bench_data(dev)
    mu64, var64, _ = reference_f64(x, y, xt)
    gp = GammaContProcess(gamma=GAMMA, s=S, d=D, device=dev)
    (mu, sd), run = counted_on(dev, lambda: (gp.fit_gp(x, y),
                                             gp.mean_var(xt))[1])
    m, vmax, vmed = posterior_errors(mu, sd, mu64, var64)
    rate = gp.get_gamma(N)
    print(f"  19.4 GammaContProcess, n = ntest = {N}: fit + mean_var "
          f"{run['wall_s']!r} s, launches {run['launches']}; mean {m!r} (bar "
          f"{SINGLE_MEAN_RTOL}), var max {vmax!r} (bar {VAR_MAX_RTOL}) median "
          f"{vmed!r}; γ(n) = {rate!r}")
    assert m <= SINGLE_MEAN_RTOL and vmax <= VAR_MAX_RTOL, (m, vmax)
    assert rate > 0 and run["launches"].get("gram", 0) > 0, run
    del x, y, xt, mu64, var64, mu, sd
    torch.cuda.empty_cache()
    return {**run, "mean_err": m, "var_max_err": vmax, "var_median_err": vmed}


def trace_convex_models(dev, dt):
    """TraceFeatures (Hermite m = 8, d = 1, y = ΦᵀAΦ of the reference
    test's A at n = TRACE_N) and ConvexRKHS (Hermite m = 16, y = x², n =
    CONVEX_N), numpy seed 19, fitted; (trace, x_trace, convex, x_convex)."""
    rng = np.random.default_rng(19)
    xa = rng.uniform(-1, 1, (TRACE_N, 1))
    emb = HermiteEmbedding(gamma=0.6, m=TRACE_M, d=1, device=dev, dtype=dt)
    Phi = emb.embed(torch.as_tensor(xa, device=dev, dtype=dt)).double()
    A = torch.diag(torch.tensor([1.0, -0.5] + [0.0] * (TRACE_M - 2),
                                dtype=torch.float64, device=dev))
    ya = torch.einsum("ij,jk,ik->i", Phi, A, Phi)[:, None]
    tf = TraceFeatures(embedding=emb, m=TRACE_M, s=0.1, lam=0.01)
    xc = rng.uniform(-1, 1, (CONVEX_N, 1))
    cr = ConvexRKHS(HermiteEmbedding(gamma=0.8, m=CONVEX_M, d=1, device=dev,
                                     dtype=dt), m=CONVEX_M, lam=1e-3, s=0.1)
    cr.fit_gp(xc, xc**2)
    return tf, xa, ya, cr, xc


def trace_convex_run(dev):
    """19.4's TraceFeatures and ConvexRKHS fits in f32 and float64 and
    their gaps (no bars)."""
    res = {}
    for dt in (torch.float32, torch.float64):
        tf, xa, ya, cr, xc = trace_convex_models(dev, dt)
        _, trun = counted_on(dev, lambda: tf.fit_gp(xa, ya.to(dt)))
        mu_t, sd_t = tf.mean_std(xa)
        _, crun = counted_on(dev, lambda: cr.optimize_params(restarts=2,
                                                             maxiter=30))
        res[dt] = (mu_t[:, 0].double(), sd_t[:, 0].double(),
                   cr.mean(xc)[:, 0].double(), trun, crun)
    (mt, st, mc, trun, crun), (mt64, st64, mc64, _, _) = \
        res[torch.float32], res[torch.float64]
    return {"trace_fit_s": trun["wall_s"], "convex_fit_s": crun["wall_s"],
            "trace_mean_gap": rel_gap(mt, mt64),
            "trace_sd_gap": rel_gap(st, st64),
            "convex_mean_gap": rel_gap(mc, mc64)}


def trace_convex_phase(dev):
    """19.4 TraceFeatures (n = 4096) and ConvexRKHS (n = 256, two metric
    restarts of 30 L-BFGS iterations, generator seeded 1): f32 against
    float64."""
    rec = trace_convex_run(dev)
    print(f"  19.4 TraceFeatures, n = {TRACE_N}, m = {TRACE_M}: fit "
          f"{rec['trace_fit_s']!r} s, mean {rec['trace_mean_gap']!r} (bar "
          f"{TRACE_MEAN_RTOL}), sd {rec['trace_sd_gap']!r} (bar "
          f"{TRACE_SD_RTOL}) of float64's; "
          f"ConvexRKHS, n = {CONVEX_N}: metric fit {rec['convex_fit_s']!r} s,"
          f" mean {rec['convex_mean_gap']!r} of float64's (bar "
          f"{CONVEX_RTOL})")
    assert rec["trace_mean_gap"] <= TRACE_MEAN_RTOL, rec
    assert rec["trace_sd_gap"] <= TRACE_SD_RTOL, rec
    assert rec["convex_mean_gap"] <= CONVEX_RTOL, rec
    return rec


LIKELIHOODS = (
    ("GaussianLikelihood", {"sigma": 0.3}, "real"),
    ("PoissonLikelihoodCanonical", {}, "count"),
    ("BernoulliLikelihoodCanonical", {}, "binary"),
    ("LaplaceLikelihood", {"b": 0.2}, "real"),
    ("HuberLikelihood", {"sigma": 0.1, "delta": 1.0}, "real"),
    ("WeibullLikelihoodCanonical", {"kk": 1.5}, "positive"),
    ("RobustGraphicalLikelihood", {"coin": 0.1, "supp": 2.0, "sigma": 0.2},
     "real"),
)


def likelihood_run(dev):
    """19.4's likelihoods in f32 and float64 and their gaps (no bars)."""
    rng = np.random.default_rng(19)
    X = rng.uniform(-1, 1, (LIK_N, LIK_D)) / math.sqrt(LIK_D)
    th = rng.standard_normal(LIK_D)
    s = X @ th
    ys = {"real": s + 0.1 * rng.standard_normal(LIK_N),
          "count": rng.poisson(np.exp(s)).astype(float),
          "binary": rng.binomial(1, 1 / (1 + np.exp(-s))).astype(float),
          "positive": np.exp(s) * rng.weibull(1.5, LIK_N)}
    gaps = {}
    t0 = time.perf_counter()
    for name, kw, kind in LIKELIHOODS:
        vals = {}
        for dt in (torch.float32, torch.float64):
            lik = getattr(probability, name)(device=dev, dtype=dt, **kw)
            lik.load_data((X, ys[kind]))
            theta = torch.as_tensor(th, device=dev, dtype=dt).requires_grad_()
            f = lik.get_objective()(theta)
            (gr,) = torch.autograd.grad(f, theta)
            cs = lik.get_confidence_set(theta.detach())
            vals[dt] = (f.detach().double(), gr.double(), cs.L.double())
        gaps[name] = max(rel_gap(a, b) for a, b in zip(vals[torch.float32],
                                                       vals[torch.float64]))
    return {"wall_s": time.perf_counter() - t0, "gaps": gaps,
            "worst": max(gaps.values())}


def likelihood_phase(dev):
    """19.4 likelihoods: each likelihood's objective, its gradient (autograd)
    and its default confidence set (√V) at n = 4096, d = 8 (numpy seed 19)
    at the true θ; f32 against float64."""
    rec = likelihood_run(dev)
    print(f"  19.4 likelihoods at n = {LIK_N}, d = {LIK_D}: objective, "
          f"gradient and √V within {rec['worst']!r} of float64's (bar "
          f"{LIK_RTOL}; {rec['gaps']}), {rec['wall_s']!r} s")
    assert rec["worst"] <= LIK_RTOL, rec
    return rec


def phase19(dev):
    """Phase 19's sub-phases: {name: record}, with each one's wall."""
    out, walls = {}, {}
    for name, fn in (("19.1 mkl", mkl_phase), ("19.2 sgcp", sgcp_phase),
                     ("19.3 tmg", tmg_phase), ("19.4 ep", ep_phase),
                     ("19.4 mixtures", mixtures_phase),
                     ("19.4 gamma_process", gamma_phase),
                     ("19.4 trace_convex", trace_convex_phase),
                     ("19.4 likelihoods", likelihood_phase)):
        out[name], walls[name] = synced(lambda: fn(dev))
    print(f"  phase 19 walls (s): {walls}; in all {sum(walls.values())!r} s")
    return out, walls


# phase 20: the library's tail -- linalg's remaining functions at bench.py's
# workload, Bayesian optimisation over the test functions (configs -> test
# function -> GaussianProcess -> UCB), the data benchmarks, the coreset,
# FeatureRanker, SRI, the CVAE, the checkpoints and euler_maruyama
TAIL_CHOL_NB = 2048          # chol_recursive's leaves (the JAX default)
TAIL_CHUNK = 1024            # tri_solve_chunked's columns (the JAX default)
TAIL_BLOCK_NB = 512          # diag_block_invs' blocks
TAIL_BLOCK_COLS = 256        # tri_solve_blocked_t's right-hand side
TAIL_BACKWARD_RATIO = 2.0    # chol_recursive's backward error / cholesky_ex's
# tri_solve_chunked's error against the float64 solve over one f32
# solve_triangular's: cuBLAS's f32 trsm is itself 1.0e-5 from float64 on
# the 16384-wide block and 2.75e-5 at widths 512-8192 (an H100), so
# the two f32 solves part by 2.5e-5, and a bar on their difference (1e-5)
# would hold cuBLAS's rounding, not the chunking
TAIL_SOLVE_RATIO = 4.0
TAIL_TRSM_RTOL = 1e-6        # tri_solve_blocked_t against one solve
# diag_block_invs against the float64 inverses of the 512² blocks: the
# batched trsm is 5.8e-7 from float64 where the per-block trsm is 2.4e-7
# (an H100); 1e-5 is cond(L_bb)·eps32 with room
TAIL_INV_RTOL = 1e-5
TAIL_PSD_RTOL = 1e-4         # solve_psd's relative residual in float64
RANK1_N = 4096
RANK1_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
SCHUR_RTOL = 1e-10
BO_GRID, BO_INIT, BO_ROUNDS, BO_BETA = 100, 10, 40, 2.0
# the kernel's bandwidth on Camelback over [-0.5, 0.5]² (s is GPConfig's
# default 0.1): the default γ = 1 is smoother than the function, and its
# loop ends 0.056 below the maximum (CPU rehearsal)
BO_GAMMA = 0.2
BO_MEAN_RTOL = 1e-4
BO_REGRET_MAX = 0.05         # the JAX package's BO test's bound
OPTIMIZE_N, OPTIMIZE_D, OPTIMIZE_SIGMA = 1024, 4, 0.1
TAIL_FIT_RTOL = 1e-2         # a fitted γ against the float64 fit's
FEL_N, FEL_D = 4096, 5
# the f32 FEL GP's mean against float64's: its fitted s ≈ 0.043 leaves
# K + s²I with a condition number near 1e6 (CPU rehearsal at n = 2048:
# 5.9e-4)
FEL_MEAN_RTOL = 5e-3
PROTEIN_DIM, PROTEIN_N, PROTEIN_HELD = 4, 4096, 1024
PROTEIN_GAMMA, PROTEIN_S = 2.0, 0.1
PROTEIN_RMSE_MAX = 0.2       # held-out RMSE over the truth's std (CPU: 0.082)
CORESET_GRID, CORESET_N, CORESET_GAMMA = 64, 64, 0.2
# each f32 pick's float64 posterior variance (given the picks before it)
# below the grid's float64 maximum: the symmetric grid ties its
# variances, and f32 rounding breaks the ties otherwise than float64
CORESET_SLACK_ATOL = 1e-4
SRI_N, SRI_D = 4096, 8
SRI_COS_MIN = 0.99
CVAE_N, CVAE_FEAT, CVAE_COND, CVAE_LATENT = 4096, 64, 8, 8
CVAE_EPOCHS, CVAE_BATCH, CVAE_LR = 5, 128, 1e-3
EM_PATHS, EM_STEPS, EM_DT = 4096, 1000, 0.05
EM_BURN = 200               # steps before the paths' stationary pool (t = 10)
EM_VAR_RTOL = 0.05
BASIS_M, BASIS_GAMMA = 8, 0.3
RANKER_RTOL = 1e-4          # CPU: 1.6e-6


def backward_error64(L, K):
    """‖K − L Lᵀ‖_F / ‖K‖_F in float64."""
    L64 = L.double()
    R = K.double()
    R.addmm_(L64, L64.T, alpha=-1.0)
    e = float(torch.linalg.matrix_norm(R) / torch.linalg.matrix_norm(
        K.double()))
    del L64, R
    return e


def peak_gib(fn):
    """(fn(), device memory held above what was held before, at its peak,
    GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def rank1_run(dev, K):
    """chol_rank1_update at RANK1_N in float64 and f32 against cholesky_ex
    of L Lᵀ + v vᵀ (float64), with the sweep's device ops and wall;
    schur_complement_extend against the float64 inverse of the extended
    Gram; K is the noise-free Gram, s²I goes onto its corner's copy."""
    n = RANK1_N
    K64 = K[:n + 1, :n + 1].double()
    K64.diagonal().add_(S * S)
    L64 = torch.linalg.cholesky(K64[:n, :n])
    g = torch.Generator(device=dev).manual_seed(20)
    v = 0.1 * torch.randn(n, generator=g, dtype=torch.float64, device=dev)
    ref = torch.linalg.cholesky_ex(L64 @ L64.T + torch.outer(v, v)).L
    out = {}
    for dt in (torch.float64, torch.float32):
        U, wall = synced(lambda: linalg.chol_rank1_update(L64.to(dt),
                                                          v.to(dt)))
        out[str(dt).split(".")[1]] = {
            "rel_err": float((U.double() - ref).abs().max()
                             / ref.abs().max()), "wall_s": wall}
    # the sweep's device operations, counted on a run of its own (the
    # dispatch mode's Python hook costs more than the launches it counts)
    out["device_ops"] = device_ops(lambda: linalg.chol_rank1_update(
        L64.float(), v.float()))[1]
    Kinv = torch.cholesky_inverse(L64)
    E = linalg.schur_complement_extend(Kinv, K64[:n, n], K64[n, n])
    want = torch.linalg.inv(K64)
    out["schur_rel_err"] = float((E - want).abs().max() / want.abs().max())
    return out


def linalg_tail_run(dev):
    """20.1 on bench.py's data: the Gram K + s²I (the gram kernel), then
    chol_recursive against cholesky_ex, tri_solve_chunked on the cross
    block K(xt, x)ᵀ against one solve_triangular, tri_solve_blocked_t,
    diag_block_invs and solve_psd, then the rank-1 updates."""
    x, y, xt = bench_data(dev)
    kern = KernelFunction(kernel_name="squared_exponential", gamma=GAMMA,
                          d=D, device=dev)
    rec = {}
    K, rec["gram"] = counted_on(dev, lambda: kern.gram(x))
    K.diagonal().add_(S * S)
    L_rec = linalg.chol_recursive(K, nb=TAIL_CHOL_NB)
    L_ex = torch.linalg.cholesky_ex(K).L
    rec["chol_recursive_ms"] = cuda_ms(
        lambda: linalg.chol_recursive(K, nb=TAIL_CHOL_NB), reps=3)
    rec["cholesky_ex_ms"] = cuda_ms(lambda: torch.linalg.cholesky_ex(K),
                                    reps=3)
    rec["backward_recursive"] = backward_error64(L_rec, K)
    rec["backward_cholesky_ex"] = backward_error64(L_ex, K)
    del L_rec
    torch.cuda.empty_cache()
    L = L_ex
    B = kern.cross(x, xt)                                   # (n, t)
    X1, rec["single_peak_gib"] = peak_gib(
        lambda: torch.linalg.solve_triangular(L, B, upper=False))
    X2, rec["chunked_peak_gib"] = peak_gib(
        lambda: linalg.tri_solve_chunked(L, B, chunk=TAIL_CHUNK))
    rec["chunked_rel_diff"] = float((X1 - X2).abs().max() / X1.abs().max())
    X64 = torch.linalg.solve_triangular(L.double(), B.double(), upper=False)
    scale = float(X64.abs().max())
    rec["single_err"] = float((X1.double() - X64).abs().max()) / scale
    rec["chunked_err"] = float((X2.double() - X64).abs().max()) / scale
    del X1, X2, X64
    rec["single_ms"] = cuda_ms(
        lambda: torch.linalg.solve_triangular(L, B, upper=False), reps=2)
    rec["chunked_ms"] = cuda_ms(
        lambda: linalg.tri_solve_chunked(L, B, chunk=TAIL_CHUNK), reps=2)
    Bn = B[:, :TAIL_BLOCK_COLS]
    Xt = linalg.tri_solve_blocked_t(L, Bn)
    Xw = torch.linalg.solve_triangular(L.T, Bn, upper=True)
    rec["blocked_t_rel_diff"] = float((Xt - Xw).abs().max()
                                      / Xw.abs().max())
    del B, Bn, Xt, Xw
    torch.cuda.empty_cache()
    Dinv = linalg.diag_block_invs(L, TAIL_BLOCK_NB)
    k = N // TAIL_BLOCK_NB
    err_batched = err_single = 0.0
    for b in range(k):
        blk = L[b * TAIL_BLOCK_NB:(b + 1) * TAIL_BLOCK_NB,
                b * TAIL_BLOCK_NB:(b + 1) * TAIL_BLOCK_NB]
        eye = torch.eye(TAIL_BLOCK_NB, device=dev)
        want = torch.linalg.solve_triangular(blk.double(), eye.double(),
                                             upper=False)
        single = torch.linalg.solve_triangular(blk, eye, upper=False)
        scale = float(want.abs().max())
        err_batched = max(err_batched, float(
            (Dinv[b].double() - want).abs().max()) / scale)
        err_single = max(err_single, float(
            (single.double() - want).abs().max()) / scale)
    rec["diag_block_invs_rel_err"] = err_batched
    rec["per_block_solve_rel_err"] = err_single
    del Dinv
    K.diagonal().sub_(S * S)
    (xs, res), rec["solve_psd"] = counted_on(
        dev, lambda: linalg.solve_psd(kern.gram(x) + S * S * torch.eye(
            N, device=dev), y))
    A64 = K.double()
    A64.diagonal().add_(S * S + float(res.jitter))
    r = A64 @ xs.double() - y.double()
    rec["solve_psd_residual"] = float(torch.linalg.vector_norm(r)
                                      / torch.linalg.vector_norm(y.double()))
    rec["solve_psd_ok"] = bool(res.ok)
    del A64, r, L, L_ex, xs, res
    torch.cuda.empty_cache()
    rec["rank1"] = rank1_run(dev, K)
    xs = x / GAMMA
    rec["gram_err"] = scaled_gram_check("20 K(x, x)", xs, xs, "se", 1.5)
    return rec


def linalg_tail_phase(dev):
    """20.1: stpy_tpu/linalg.py:211-446's functions in the port at bench.py's
    workload (n = 16384, d = 8, SE γ = 0.5, s = 0.1, seed 0)."""
    rec = linalg_tail_run(dev)
    r1 = rec["rank1"]
    print(f"  20.1 chol_recursive(nb={TAIL_CHOL_NB}) at n = {N}: "
          f"{rec['chol_recursive_ms']!r} ms, backward error "
          f"{rec['backward_recursive']!r}; cholesky_ex "
          f"{rec['cholesky_ex_ms']!r} ms, {rec['backward_cholesky_ex']!r} "
          f"(bar: within {TAIL_BACKWARD_RATIO}x)")
    print(f"  20.1 tri_solve_chunked(chunk={TAIL_CHUNK}) on the {N}x{NTEST} "
          f"cross block: {rec['chunked_ms']!r} ms, peak "
          f"{rec['chunked_peak_gib']!r} GiB; one solve_triangular "
          f"{rec['single_ms']!r} ms, peak {rec['single_peak_gib']!r} GiB; "
          f"against the float64 solve {rec['chunked_err']!r} and "
          f"{rec['single_err']!r} (bar: within {TAIL_SOLVE_RATIO}x); max rel "
          f"diff between the two {rec['chunked_rel_diff']!r}")
    print(f"  20.1 tri_solve_blocked_t on {TAIL_BLOCK_COLS} columns: "
          f"{rec['blocked_t_rel_diff']!r} from solve_triangular (bar "
          f"{TAIL_TRSM_RTOL}); diag_block_invs(nb={TAIL_BLOCK_NB}) "
          f"{rec['diag_block_invs_rel_err']!r} from float64 (bar "
          f"{TAIL_INV_RTOL}; per-block solve_triangular "
          f"{rec['per_block_solve_rel_err']!r}); solve_psd residual "
          f"{rec['solve_psd_residual']!r} (bar {TAIL_PSD_RTOL}), launches "
          f"{rec['solve_psd']['launches']}")
    print(f"  20.1 chol_rank1_update at n = {RANK1_N}: float64 "
          f"{r1['float64']['rel_err']!r} (bar {RANK1_RTOL[torch.float64]}), "
          f"{r1['float64']['wall_s']!r} s; f32 {r1['float32']['rel_err']!r} "
          f"(bar {RANK1_RTOL[torch.float32]}), {r1['float32']['wall_s']!r} "
          f"s; {r1['device_ops']} device ops a sweep; "
          f"schur_complement_extend {r1['schur_rel_err']!r} (bar "
          f"{SCHUR_RTOL})")
    assert (rec["backward_recursive"]
            <= TAIL_BACKWARD_RATIO * rec["backward_cholesky_ex"]), rec
    assert rec["chunked_err"] <= TAIL_SOLVE_RATIO * rec["single_err"], rec
    assert rec["chunked_peak_gib"] <= rec["single_peak_gib"], rec
    assert rec["blocked_t_rel_diff"] <= TAIL_TRSM_RTOL, rec
    assert rec["diag_block_invs_rel_err"] <= TAIL_INV_RTOL, rec
    assert rec["solve_psd_ok"] and \
        rec["solve_psd_residual"] <= TAIL_PSD_RTOL, rec
    for dt in (torch.float64, torch.float32):
        assert r1[str(dt).split(".")[1]]["rel_err"] <= RANK1_RTOL[dt], r1
    assert r1["schur_rel_err"] <= SCHUR_RTOL, r1
    assert rec["gram"]["launches"].get("gram", 0) > 0, rec["gram"]
    assert rec["solve_psd"]["launches"].get("gram", 0) > 0, rec
    return rec


def tail_f64_gp(dev, x, y, s, gamma):
    """The float64 reference SE GP on the card (its atom on its plain
    version), fitted on (x, y)."""
    gp = GaussianProcess(kernel=plain64_kernel(dev, "squared_exponential",
                                               gamma, x.shape[1]), s=s)
    gp.fit_gp(x.double(), y.double())
    return gp


def bo_run(dev):
    """20.2's loop: GPConfig(KernelConfig(SE, γ=BO_GAMMA, d=2)).build() on
    CamelbackBenchmark's interval(BO_GRID); BO_INIT random initial points
    (numpy seed 20), then BO_ROUNDS rounds of fit_gp, mean_std over the
    candidates, argmax of μ + BO_BETA·σ and a noisy eval."""
    cfg = GPConfig(kernel=KernelConfig(kernel_name="squared_exponential",
                                       gamma=BO_GAMMA, d=2))
    gp = cfg.build(device=dev)
    bench = CamelbackBenchmark(device=dev)
    xtest = bench.interval(BO_GRID)
    f_max = bench.maximum(xtest)
    idx = np.random.default_rng(20).choice(xtest.shape[0], BO_INIT,
                                           replace=False)
    X = xtest[torch.as_tensor(idx, device=dev)]
    Y = bench.eval(X)

    def loop():
        nonlocal X, Y
        for _ in range(BO_ROUNDS):
            gp.fit_gp(X, Y)
            mu, sd = gp.mean_std(xtest)
            j = int(torch.argmax(mu + BO_BETA * sd))
            X = torch.cat([X, xtest[j:j + 1]])
            Y = torch.cat([Y, bench.eval(xtest[j:j + 1])])
        gp.fit_gp(X, Y)

    _, runs = counted_on(dev, loop)
    mu = gp.mean_std(xtest)[0]
    ref = tail_f64_gp(dev, X, Y, cfg.s, cfg.kernel.gamma)
    mu64 = ref.mean_std(xtest.double())[0]
    regret = f_max - float(torch.max(bench.eval_noiseless(X)))
    return {"regret": regret, "f_max": f_max, "n": int(X.shape[0]),
            "mean_gap": rel_gap(mu.double(), mu64), **runs}, (gp, ref, xtest)


def optimize_run(dev):
    """20.2's hyperfit: StybTangBenchmark(d=4).optimize on OPTIMIZE_N
    uniform points (numpy seed 20) at σ = OPTIMIZE_SIGMA, 2 restarts, and
    the float64 fit of the same ARD GP on the same noisy values."""
    bench = StybTangBenchmark(d=OPTIMIZE_D, device=dev)
    X = torch.as_tensor(np.random.default_rng(20).uniform(
        -0.5, 0.5, (OPTIMIZE_N, OPTIMIZE_D)), dtype=torch.float32,
        device=dev)
    state = bench._generator.get_state()
    gamma32, runs = counted_on(
        dev, lambda: bench.optimize(X, OPTIMIZE_SIGMA, restarts=2))
    bench._generator.set_state(state)
    Y = bench.eval(X, sigma=OPTIMIZE_SIGMA)
    k64 = plain64_atoms(KernelFunction(
        kernel_name="ard", d=OPTIMIZE_D, ard_gamma=np.full(OPTIMIZE_D, 0.1),
        device=dev, dtype=torch.float64))
    gp64 = GaussianProcess(kernel=k64, s=OPTIMIZE_SIGMA)
    gp64.fit_gp(X.double(), Y.double())
    gp64.optimize_params(type="bandwidth", restarts=2)
    gamma64 = float(torch.min(k64.params_dict["0"]["ard_gamma"]))
    return {"gamma_f32": gamma32, "gamma_f64": gamma64,
            "gamma_gap": abs(gamma32 / gamma64 - 1.0), **runs}


def bo_tail_phase(dev):
    """20.2: Bayesian optimisation over the test functions, the slice's
    main path."""
    rec, models = bo_run(dev)
    print(f"  20.2 BO on Camelback ({BO_GRID}² candidates, {BO_INIT} initial "
          f"points + {BO_ROUNDS} rounds of UCB): simple regret "
          f"{rec['regret']!r} of max {rec['f_max']!r} (bar {BO_REGRET_MAX}); "
          f"the final mean {rec['mean_gap']!r} of max|μ64| from the float64 "
          f"refit (bar {BO_MEAN_RTOL}); loop {rec['wall_s']!r} s, launches "
          f"{rec['launches']}")
    assert rec["regret"] <= BO_REGRET_MAX, rec
    assert rec["mean_gap"] <= BO_MEAN_RTOL, rec
    assert rec["launches"].get("gram", 0) > 0, rec
    opt = optimize_run(dev)
    print(f"  20.2 StybTangBenchmark(d={OPTIMIZE_D}).optimize at n = "
          f"{OPTIMIZE_N}: γ {opt['gamma_f32']!r} against the float64 fit's "
          f"{opt['gamma_f64']!r} (gap {opt['gamma_gap']!r}, bar "
          f"{TAIL_FIT_RTOL}); {opt['wall_s']!r} s, launches "
          f"{opt['launches']}")
    assert opt["gamma_gap"] <= TAIL_FIT_RTOL, opt
    assert opt["launches"].get("gram", 0) > 0, opt
    gp, _, xtest = models
    X = gp.x
    Xs, Ts = X / BO_GAMMA, xtest / BO_GAMMA
    Xo = torch.as_tensor(np.random.default_rng(20).uniform(
        -0.5, 0.5, (OPTIMIZE_N, OPTIMIZE_D)), dtype=torch.float32,
        device=dev) / opt["gamma_f32"]
    errs = [scaled_gram_check(f"20 {label}", a, b, "se", 1.5)
            for label, a, b in (("BO K(x, x)", Xs, Xs),
                                ("BO K(xtest, x)", Ts, Xs),
                                ("optimize K(x, x)", Xo, Xo))]
    return {"bo": rec, "optimize": opt, "gram_err": max(errs)}, models


def fel_arrays(n=FEL_N, d=FEL_D):
    """The FEL pipeline's input (numpy seed 20): n rows of d + 1 columns in
    [2, 7], y a smooth response of the first d plus noise, every line id
    below d, y_std ~ |N(0.05, 0.01)|."""
    rng = np.random.default_rng(20)
    x = rng.uniform(2.0, 7.0, (n, d + 1))
    y = (np.sin(x[:, 0]) + 0.5 * np.cos(x[:, 1]) * x[:, 2] / 7.0
         + 0.1 * x[:, 3] - 0.05 * (x[:, 4] - 4.5) ** 2
         + 0.05 * rng.standard_normal(n))
    return x, y, rng.integers(0, d, n), np.abs(rng.normal(0.05, 0.01, n))


def fel_run(dev):
    sims = {}
    for dt in (torch.float32, torch.float64):
        sim = FelSimulator(d=FEL_D, sigma=0.01, device=dev, dtype=dt)
        sim.from_arrays(*fel_arrays())
        kern = (KernelFunction(kernel_name="squared_exponential", gamma=1.0,
                               d=FEL_D, device=dev) if dt == torch.float32
                else plain64_kernel(dev, "squared_exponential", 1.0, FEL_D))
        gp = GaussianProcess(kernel=kern, s=sim.s)
        _, runs = counted_on(
            dev, lambda: sim.fit_simulator(gp, "bandwidth", restarts=2))
        sims[dt] = (sim, runs)
    (s32, runs), (s64, _) = sims[torch.float32], sims[torch.float64]
    g32 = float(s32.GP.kernel_object.params_dict["0"]["gamma"])
    g64 = float(s64.GP.kernel_object.params_dict["0"]["gamma"])
    xt = torch.as_tensor(np.random.default_rng(21).uniform(
        -0.5, 0.5, (1024, FEL_D)), device=dev)
    mu = s32.eval_noiseless(xt.float())
    mu64 = s64.eval_noiseless(xt)
    return {"gamma_f32": g32, "gamma_f64": g64,
            "gamma_gap": abs(g32 / g64 - 1.0),
            "mean_gap": rel_gap(mu.double(), mu64), "s": s32.s, **runs}, s32


def protein_run(dev):
    bench, truth = ProteinBenchmark.synthetic(dim=PROTEIN_DIM, n=PROTEIN_N,
                                              key=20, device=dev)
    X, y = bench.get_data()
    gp = GaussianProcess(gamma=PROTEIN_GAMMA, s=PROTEIN_S,
                         d=X.shape[1], device=dev)
    _, runs = counted_on(dev, lambda: gp.fit_gp(X, y))
    codes = np.random.default_rng(21).integers(0, 20, (PROTEIN_HELD,
                                                       PROTEIN_DIM))
    Xh = bench.op.translate_one_hot(codes)
    mu, mruns = counted_on(dev, lambda: gp.mean_std(Xh)[0])
    want = truth(codes) / bench.y_scale
    ref = tail_f64_gp(dev, X, y, PROTEIN_S, PROTEIN_GAMMA)
    mu64 = ref.mean_std(Xh.double())[0]
    rmse = float(np.sqrt(np.mean((mu.double().cpu().numpy() - want) ** 2)))
    return {"rmse_over_std": rmse / float(np.std(want)),
            "mean_gap": rel_gap(mu.double(), mu64), "fit": runs,
            "mean_std": mruns}, (X, Xh)


def coreset_run(dev):
    """coreset_leverage_score_greedy (noise 1e-3) on a CORESET_GRID² grid
    of [-1, 1]², SE γ = CORESET_GAMMA, CORESET_N picks, f32 on the card;
    then, for each pick in float64, how far its posterior variance given
    the picks before it lies below the grid's largest."""
    box = BorelSet(2, np.array([[-1.0, 1.0], [-1.0, 1.0]]), device=dev)
    k = KernelFunction(kernel_name="squared_exponential",
                       gamma=CORESET_GAMMA, d=2, device=dev)
    picks, runs = counted_on(dev, lambda: coreset_leverage_score_greedy(
        box, k, CORESET_N, grid=CORESET_GRID))
    grid = box.return_discretization(CORESET_GRID).double()
    k64 = plain64_kernel(dev, "squared_exponential", CORESET_GAMMA, 2)
    idx = torch.cdist(picks.double(), grid).argmin(dim=1)
    slack, var = 0.0, torch.ones(grid.shape[0], dtype=torch.float64,
                                 device=dev)
    for i in range(picks.shape[0]):
        if i:
            pts = grid[idx[:i]]
            A = k64.gram(pts) + 1e-3 * torch.eye(i, dtype=torch.float64,
                                                 device=dev)
            V = torch.linalg.solve_triangular(torch.linalg.cholesky(A),
                                              k64.cross(grid, pts).T,
                                              upper=False)
            var = 1.0 - (V * V).sum(0)
        slack = max(slack, float(var.max() - var[idx[i]]))
    return {"n": int(picks.shape[0]), "slack": slack,
            "var_max_after": float(var.max()), **runs}, picks


def ranker_run(dev, gp, ref):
    """FeatureRanker.one_off_importance on 20.2's GP and on its float64
    refit."""
    imp, runs = counted_on(dev, lambda: FeatureRanker(
        gp, gp.x, gp.y).one_off_importance())
    imp64 = FeatureRanker(ref, ref.x, ref.y).one_off_importance()
    return {"importance": imp.tolist(), "importance_f64": imp64.tolist(),
            "gap": float(np.max(np.abs(imp - imp64)) / np.max(np.abs(imp64))),
            **runs}


def sri_run(dev):
    rng = np.random.default_rng(20)
    X = rng.standard_normal((SRI_N, SRI_D))
    beta = rng.standard_normal(SRI_D)
    beta /= np.linalg.norm(beta)
    y = np.tanh(X @ beta) + 0.05 * rng.standard_normal(SRI_N)
    sri = SRI(device=dev)
    (dirs, eig), wall = synced(lambda: sri.fit_sri(X, y))
    ref = SRI(device=dev, dtype=torch.float64)
    _, eig64 = ref.fit_sri(X, y)
    top = dirs[:, 0].double().cpu().numpy()
    return {"cos_top": float(abs(top @ beta) / np.linalg.norm(top)),
            "eig_gap": rel_gap(eig.double(), eig64), "wall_s": wall}


def cvae_run(dev):
    rng = np.random.default_rng(20)
    labels = rng.integers(0, CVAE_COND, CVAE_N)
    p = 0.1 + 0.8 * (np.arange(CVAE_FEAT)[None, :] % CVAE_COND
                     == labels[:, None])
    X = (rng.uniform(size=(CVAE_N, CVAE_FEAT)) < p).astype(np.float32)
    Y = np.eye(CVAE_COND, dtype=np.float32)[labels]
    model = CVAE(CVAE_FEAT, CVAE_LATENT, cond_size=CVAE_COND, device=dev)
    Xt, Yt = (torch.as_tensor(a, device=dev) for a in (X, Y))

    def elbo():
        with torch.no_grad():
            g = torch.Generator(device=dev).manual_seed(21)
            return float(model.elbo_loss(Xt, Yt, generator=g)) / CVAE_N

    before = elbo()
    _, wall = synced(lambda: model.fit(X, Y, epochs=CVAE_EPOCHS,
                                       batch=CVAE_BATCH, lr=CVAE_LR))
    after = elbo()
    s = model.sample(Y[:1], size=16,
                     generator=torch.Generator(device=dev).manual_seed(22))
    return {"loss_before": before, "loss_after": after, "wall_s": wall,
            "sample_in_unit_box": bool((s >= 0).all() and (s <= 1).all())}


def checkpoint_run(dev, sim, tmp):
    """save_model / load_model of the FEL GP: mean_std of the loaded GP
    against the saved one, bit for bit; then the OptimalPositiveBasis round
    trip (f32 on the card: Γ's grid Gram is the double-float one)."""
    gp = sim.GP
    xt = torch.as_tensor(np.random.default_rng(22).uniform(
        -0.5, 0.5, (4096, FEL_D)), dtype=torch.float32, device=dev)
    mu, sd = gp.mean_std(xt)
    path = Path(tmp) / "fel_gp.npz"
    save_model(path, gp)
    fresh = GaussianProcess(gamma=1.0, s=gp.s, d=FEL_D, device=dev)
    load_model(path, fresh)
    mu2, sd2 = fresh.mean_std(xt)
    rec = {"model_bitwise": bool(torch.equal(mu, mu2)
                                 and torch.equal(sd, sd2)),
           "model_bytes": path.stat().st_size}

    def basis(seed):
        k = KernelFunction(kernel_name="squared_exponential",
                           gamma=BASIS_GAMMA, d=1, device=dev)
        return OptimalPositiveBasis(
            1, BASIS_M, kernel_object=k, samples=64, B=4.0, s=1e-3,
            device=dev, generator=torch.Generator(device=dev).manual_seed(
                seed))

    q = torch.linspace(-1, 1, 257, device=dev)[:, None]
    a = basis(0)
    before = a.embed(q)
    a.save_embedding(Path(tmp) / "basis")
    b = basis(1)
    other = rel_gap(b.embed(q).double(), before.double())
    b.load_embedding(Path(tmp) / "basis")
    after, runs = counted_on(dev, lambda: b.embed(q))
    nodes = b.grid_nodes64()
    rec.update(basis_gap_before=other,
               basis_gap=rel_gap(after.double(), before.double()),
               basis_launches=runs["launches"],
               gram_df_err=gram_df_check("20.3 basis grid", nodes, nodes,
                                         "se", 1.0, BASIS_GAMMA)[0])
    return rec


def em_run(dev):
    g = torch.Generator(device=dev).manual_seed(20)
    x0 = torch.zeros(EM_PATHS, device=dev)
    xs, wall = synced(lambda: euler_maruyama(
        g, lambda x: -x, lambda x: 2.0 ** 0.5, x0, dt=EM_DT, steps=EM_STEPS))
    # dx = −x dt + √2 dW: Euler's stationary variance is 1/(1 − dt/2); the
    # states after EM_BURN steps (the start forgotten to e⁻²⁰) pooled
    want = 1.0 / (1.0 - EM_DT / 2)
    var = float(xs[EM_BURN:].var())
    return {"var": var, "var_want": want, "var_gap": abs(var / want - 1.0),
            "shape": list(xs.shape), "wall_s": wall}


def rest_phase(dev, bo_models):
    """20.3: the data benchmarks, the coreset, FeatureRanker, SRI, the CVAE,
    the checkpoints and euler_maruyama."""
    out, walls = {}, {}
    out["fel"], walls["fel"] = synced(lambda: fel_run(dev))
    fel, sim = out["fel"]
    out["fel"] = fel
    print(f"  20.3 FelSimulator.from_arrays (n = {FEL_N}, d = {FEL_D}) + "
          f"fit_simulator(bandwidth, restarts=2): γ {fel['gamma_f32']!r} "
          f"against float64's {fel['gamma_f64']!r} (gap "
          f"{fel['gamma_gap']!r}, bar {TAIL_FIT_RTOL}); mean "
          f"{fel['mean_gap']!r} of max|μ64| (bar {FEL_MEAN_RTOL}); fit "
          f"{fel['wall_s']!r} s, launches {fel['launches']}")
    assert fel["gamma_gap"] <= TAIL_FIT_RTOL, fel
    assert fel["mean_gap"] <= FEL_MEAN_RTOL, fel
    assert fel["launches"].get("gram", 0) > 0, fel
    (prot, (Xp, Xh)), walls["protein"] = synced(lambda: protein_run(dev))
    out["protein"] = prot
    print(f"  20.3 ProteinBenchmark.synthetic(dim={PROTEIN_DIM}, "
          f"n={PROTEIN_N}), a GP on its one-hot codes (d = "
          f"{Xp.shape[1]}): held-out RMSE over the truth's std "
          f"{prot['rmse_over_std']!r} (bar {PROTEIN_RMSE_MAX}); mean "
          f"{prot['mean_gap']!r} of max|μ64| (bar {BO_MEAN_RTOL}); fit "
          f"launches {prot['fit']['launches']}")
    assert prot["rmse_over_std"] <= PROTEIN_RMSE_MAX, prot
    assert prot["mean_gap"] <= BO_MEAN_RTOL, prot
    assert prot["fit"]["launches"].get("gram", 0) > 0, prot
    (core, picks), walls["coreset"] = synced(lambda: coreset_run(dev))
    out["coreset"] = core
    print(f"  20.3 coreset_leverage_score_greedy on a {CORESET_GRID}² grid: "
          f"{core['n']} points, each within {core['slack']!r} of the float64 "
          f"largest posterior variance given the points before it (bar "
          f"{CORESET_SLACK_ATOL}); the largest before the last pick "
          f"{core['var_max_after']!r}; {core['wall_s']!r} s, launches "
          f"{core['launches']}")
    assert core["n"] == CORESET_N, core
    assert core["slack"] <= CORESET_SLACK_ATOL, core
    assert core["launches"].get("gram", 0) > 0, core
    gp, ref, _ = bo_models
    out["ranker"], walls["ranker"] = synced(lambda: ranker_run(dev, gp, ref))
    rk = out["ranker"]
    print(f"  20.3 FeatureRanker.one_off_importance on 20.2's GP: "
          f"{rk['importance']} against float64's {rk['importance_f64']} "
          f"(gap {rk['gap']!r}, bar {RANKER_RTOL})")
    assert rk["gap"] <= RANKER_RTOL, rk
    out["sri"], walls["sri"] = synced(lambda: sri_run(dev))
    sri = out["sri"]
    print(f"  20.3 SRI on {SRI_N} rows, d = {SRI_D}: |cos| of the top "
          f"direction with the index {sri['cos_top']!r} (bar {SRI_COS_MIN}); "
          f"eigenvalues {sri['eig_gap']!r} of float64's (bar "
          f"{BO_MEAN_RTOL})")
    assert sri["cos_top"] >= SRI_COS_MIN and \
        sri["eig_gap"] <= BO_MEAN_RTOL, sri
    out["cvae"], walls["cvae"] = synced(lambda: cvae_run(dev))
    cv = out["cvae"]
    print(f"  20.3 CVAE, {CVAE_EPOCHS} epochs on {CVAE_N} rows (batch "
          f"{CVAE_BATCH}): negative ELBO a row {cv['loss_before']!r} -> "
          f"{cv['loss_after']!r}, {cv['wall_s']!r} s")
    assert cv["loss_after"] < cv["loss_before"] and \
        cv["sample_in_unit_box"], cv
    with tempfile.TemporaryDirectory() as tmp:
        ck, walls["checkpoint"] = synced(lambda: checkpoint_run(dev, sim,
                                                                tmp))
    out["checkpoint"] = ck
    print(f"  20.3 save_model / load_model of the FEL GP "
          f"({ck['model_bytes']} bytes): mean_std bitwise "
          f"{ck['model_bitwise']}; OptimalPositiveBasis round trip: "
          f"{ck['basis_gap']!r} from the saved basis (another basis "
          f"{ck['basis_gap_before']!r}), launches {ck['basis_launches']}")
    assert ck["model_bitwise"], ck
    assert ck["basis_gap"] <= 1e-6 < ck["basis_gap_before"], ck
    assert ck["basis_launches"].get("gram_df", 0) > 0, ck
    out["euler_maruyama"], walls["euler_maruyama"] = synced(
        lambda: em_run(dev))
    em = out["euler_maruyama"]
    print(f"  20.3 euler_maruyama, OU on {EM_PATHS} paths x {EM_STEPS} "
          f"steps: stationary variance {em['var']!r} against "
          f"{em['var_want']!r} (gap {em['var_gap']!r}, bar {EM_VAR_RTOL}), "
          f"{em['wall_s']!r} s")
    assert em["var_gap"] <= EM_VAR_RTOL, em
    gamma_fel = float(sim.GP.kernel_object.params_dict["0"]["gamma"])
    grid = BorelSet(2, np.array([[-1.0, 1.0], [-1.0, 1.0]]), device=dev
                    ).return_discretization(CORESET_GRID)
    shapes = (("FEL K(x, x)", sim.x / gamma_fel, sim.x / gamma_fel),
              ("protein K(x, x)", Xp / PROTEIN_GAMMA, Xp / PROTEIN_GAMMA),
              ("protein K(held, x)", Xh / PROTEIN_GAMMA, Xp / PROTEIN_GAMMA),
              ("coreset K(grid, picks)", grid / CORESET_GAMMA,
               picks / CORESET_GAMMA))
    errs = {"gram": max(scaled_gram_check(f"20 {label}", a, b, "se", 1.5)
                        for label, a, b in shapes),
            "gram_df": ck["gram_df_err"]}
    out["kernel_errs"] = errs
    return out, walls


def phase20(dev):
    """Phase 20's sub-phases: ({name: record}, {name: wall in s}) and the
    launch counts of each counted run."""
    out, walls = {}, {}
    out["20.1 linalg"], walls["20.1 linalg"] = synced(
        lambda: linalg_tail_phase(dev))
    (out["20.2 bo"], models), walls["20.2 bo"] = synced(
        lambda: bo_tail_phase(dev))
    (rest, rest_walls), walls["20.3 rest"] = synced(
        lambda: rest_phase(dev, models))
    out["20.3 rest"] = rest
    walls |= {f"20.3 {k}": v for k, v in rest_walls.items()}
    l1, b2 = out["20.1 linalg"], out["20.2 bo"]
    counts = {"20.1 gram": l1["gram"]["launches"],
              "20.1 solve_psd": l1["solve_psd"]["launches"],
              "20.2 bo loop": b2["bo"]["launches"],
              "20.2 optimize": b2["optimize"]["launches"],
              "20.3 fel": rest["fel"]["launches"],
              "20.3 protein fit": rest["protein"]["fit"]["launches"],
              "20.3 protein mean_std": rest["protein"]["mean_std"][
                  "launches"],
              "20.3 coreset": rest["coreset"]["launches"],
              "20.3 ranker": rest["ranker"]["launches"],
              "20.3 basis": rest["checkpoint"]["basis_launches"]}
    errs = {"gram": max(l1["gram_err"], b2["gram_err"],
                        rest["kernel_errs"]["gram"]),
            "gram_df": rest["kernel_errs"]["gram_df"]}
    total = sum(walls[k] for k in ("20.1 linalg", "20.2 bo", "20.3 rest"))
    print(f"  phase 20 walls (s): {walls}; in all {total!r} s")
    return out, walls, counts, errs


# Phase 21: the multi-device tier (parallel/{mesh, blocked, data}, the mesh
# tiers of IterativeGP and lazy_kernel) on a one-rank mesh whose NCCL group
# make_mesh starts (the card's machine has one GPU), and the exact GP's
# memory modes (fold_noise, strip_fold, jitter_ladder="recompute"). Each
# kernel it launches is held against its plain version at the shapes it
# launches it with on one rank, and at one (n/4, n) row block at a nonzero
# global offset, the shape a 4-rank run hands each rank (MESH_RANKS).
MESH_RANKS = 4
FARM_RESTARTS, FARM_LR = 64, 0.1
# 21.1: the restart farm's vmapped batch against the same steps one by one
# (float64; a batched Cholesky rounds apart from a single one)
FARM_RTOL = 1e-8
# 21.1: distributed_evidence against the port's exact evidence at config 1
# (both factor the f32 Gram in float64)
MESH_EVIDENCE_RTOL = 1e-10
# 21.2: DistributedExactGP, "panels" at bench.py's n, "masked" and "rec" at
# MESH_GP_SMALL_N, MESH_GP_T test points, held at the single tier's bars
MESH_GP_SMALL_N, MESH_GP_T = 8192, 1024
MESH_MEAN_RTOL, MESH_VAR_RTOL = 1e-4, 1e-2
# 21.3 and 21.5: phase 8's n = 32768 data and kernel at MESH_T test points
# (one 128-column block of the exact variance's block CG); the f32 mesh
# tiers' float64 residual (phase 8's lazy fits reach ~1e-5) and the double
# tier's mean against dense float64
MESH_T = 128
MESH_RESIDUAL_MAX = 1e-3
MESH_DOUBLE_MEAN_RTOL = 1e-6
# 21.4: run_all.py config 3's 50 000 rows in batches of DATA_BATCH through
# fit_feature_gp_sharded on the landmark embedding of 16.2's model,
# against the in-memory fit on the same embedding, both over max|μ64|
DATA_BATCH = 10_000
DATA_MEAN_RTOL = 1e-4
# 21.5: the double tier's layouts at n = 32768 (fit and predict peaks); the
# means against dense float64 at the double tier's bar
FOLD_MEAN_RTOL = 1e-6
SINGLE_LAYOUTS = (("ladder", dict()),
                  ("recompute", dict(jitter_ladder="recompute")))
FOLD_LAYOUTS = (("ladder", dict(), (0, 1)),
                ("fixed jitter", dict(jitter_ladder=False), (0,)),
                ("recompute", dict(jitter_ladder="recompute"), (0,)),
                ("fold_noise", dict(jitter_ladder=False, fold_noise=True),
                 (0, 1)))


def row_block(n, ranks=MESH_RANKS):
    """The rows of the second of `ranks` equal blocks: a rank's block at a
    nonzero global offset."""
    nl = n // ranks
    return slice(nl, 2 * nl)


def farm_evidence(x, y, s):
    """Config 1's negative log evidence in float64 as a function of log γ,
    by plain torch ops (the farm vmaps it)."""
    sq = (x - x.T) ** 2
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)

    def nll(log_gamma):
        K = torch.exp(-0.5 * sq / torch.exp(2.0 * log_gamma)) + s * s * eye
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve(y, L)
        return 0.5 * (y.T @ alpha)[0, 0] + torch.sum(
            torch.log(torch.diagonal(L)))

    return nll


def mesh_evidence(kernel, mesh, gamma, s, x, y):
    """distributed_evidence's value and its derivative in log γ."""
    t = torch.tensor(math.log(gamma), dtype=torch.float64,
                     device=kernel.device, requires_grad=True)
    f = distributed_evidence(kernel, mesh)({"0": {"gamma": torch.exp(t)}},
                                           s, x, y)
    (g,) = torch.autograd.grad(f, t)
    return float(f.detach()), float(g)


def mesh_basics_phase(dev, mesh):
    """21.1: sharded_gram bitwise against gram, distributed_evidence
    against the exact evidence, a restart farm of evidence steps."""
    out = {}
    x, _, _ = bench_data(dev)
    k = KernelFunction(kernel_name="squared_exponential", gamma=GAMMA, d=D,
                       device=dev)
    K, wall, counts = counted(lambda: sharded_gram(
        lambda a, b: k.eval_params(k.params_dict, a, b), x, mesh))
    same = torch.equal(K.to_local(), k.eval_params(k.params_dict, x, x))
    del K
    torch.cuda.empty_cache()
    print(f"  21.1 sharded_gram, n = {N}, d = {D}: local rows "
          f"{N}x{N}, bit for bit gram's: {same}; {wall!r} s, launches "
          f"{nonzero(counts)}")
    assert same and counts["gram"] > 0, counts
    out["sharded_gram"] = {"bitwise": same, "wall_s": wall,
                           "launches": nonzero(counts)}
    xc, yc = config1_data()
    gamma, s = CONFIG1_GP["gamma"], CONFIG1_GP["s"]
    kc = KernelFunction(kernel_name="squared_exponential", gamma=gamma, d=1,
                        device=dev)
    xt_, yt_ = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (xc, yc))
    (val, der), wall, counts = counted(
        lambda: mesh_evidence(kc, mesh, gamma, s, xt_, yt_))
    gp = GaussianProcess(kernel=kc, s=s)
    gp.x, gp.y = xt_, yt_.reshape(-1, 1)
    ref = evidence_and_grad(gp, gamma)
    gaps = (abs(val - ref[0]) / abs(ref[0]), abs(der - ref[1]) / abs(ref[1]))
    print(f"  21.1 distributed_evidence at config 1 (n = {CONFIG1_N}, γ = "
          f"{gamma}, s = {s}): {val!r}, d/dlog γ {der!r}; the exact "
          f"evidence {ref[0]!r}, {ref[1]!r}; gaps {gaps} (bar "
          f"{MESH_EVIDENCE_RTOL}); launches {nonzero(counts)}")
    assert max(gaps) <= MESH_EVIDENCE_RTOL and counts["gram"] > 0, gaps
    out["evidence"] = {"value": val, "dlog_gamma": der, "exact": ref,
                       "gaps": gaps, "launches": nonzero(counts)}
    x64, y64 = (torch.as_tensor(a, dtype=torch.float64, device=dev)
                for a in (xc, yc))
    nll = farm_evidence(x64, y64, s)
    grad_value = torch.func.grad_and_value(nll)
    lg = torch.linspace(math.log(0.05), math.log(2.0), FARM_RESTARTS,
                        dtype=torch.float64, device=dev)
    farm = restart_farm(grad_value, FARM_RESTARTS, mesh, "dp")
    (g, v), wall = synced(lambda: farm((lg,)))
    stepped = lg - FARM_LR * g
    one = torch.stack([torch.stack(grad_value(t)) for t in lg])
    gap = float(torch.max((torch.stack([g, v], 1) - one).abs()
                          / one.abs().clamp_min(1e-300)))
    print(f"  21.1 restart_farm: {FARM_RESTARTS} evidence steps of config 1 "
          f"over 'dp' (torch.vmap), {wall!r} s; against the steps one by "
          f"one {gap!r} (bar {FARM_RTOL}); best restart log γ "
          f"{float(stepped[torch.argmin(v)])!r}")
    assert gap <= FARM_RTOL and bool(torch.isfinite(stepped).all()), gap
    out["restart_farm"] = {"wall_s": wall, "gap": gap}
    return out


def mesh_gp_phase(dev, mesh):
    """21.2: DistributedExactGP, each factorization, against float64."""
    out = {}
    x, y, xt = bench_data(dev)
    xt = xt[:MESH_GP_T]
    for fac, n in (("panels", N), ("masked", MESH_GP_SMALL_N),
                   ("rec", MESH_GP_SMALL_N)):
        xs, ys = x[:n], y[:n]
        mu64, var64, _ = reference_f64(xs, ys, xt)
        gp = DistributedExactGP(
            KernelFunction(kernel_name="squared_exponential", gamma=GAMMA,
                           d=D, device=dev), s=S, mesh=mesh, factorization=fac)
        (_, fit_peak), fit_s = synced(lambda: peak_gib(
            lambda: gp.fit_gp(xs, ys)))
        reset_launch_counts()
        ((mu, sd), pred_peak), pred_s = synced(lambda: peak_gib(
            lambda: gp.mean_std(xt)))
        pred_counts = launch_counts()
        errs = posterior_errors(mu, sd, mu64, var64)
        print(f"  21.2 DistributedExactGP({fac!r}), n = {n}, {MESH_GP_T} "
              f"test points, panel {gp._nbe}: fit {fit_s!r} s, peak "
              f"{fit_peak!r} GiB a rank; predict {pred_s!r} s, peak "
              f"{pred_peak!r} GiB; mean {errs[0]!r}, variance max "
              f"{errs[1]!r}, median {errs[2]!r} (bars {MESH_MEAN_RTOL}, "
              f"{MESH_VAR_RTOL}); predict launches {nonzero(pred_counts)}")
        assert errs[0] <= MESH_MEAN_RTOL and errs[1] <= MESH_VAR_RTOL, errs
        assert pred_counts["gram"] > 0, pred_counts
        out[fac] = {"n": n, "fit_s": fit_s, "fit_peak_gib": fit_peak,
                    "predict_s": pred_s, "predict_peak_gib": pred_peak,
                    "errors": errs, "panel": gp._nbe,
                    "predict_launches": nonzero(pred_counts)}
        del gp, mu, sd
        torch.cuda.empty_cache()
    # the fit's launches, on its own counted run
    gp = DistributedExactGP(KernelFunction(
        kernel_name="squared_exponential", gamma=GAMMA, d=D, device=dev),
        s=S, mesh=mesh)
    _, _, counts = counted(lambda: gp.fit_gp(x, y))
    out["panels"]["fit_launches"] = nonzero(counts)
    assert counts["gram"] > 0, counts
    del gp
    torch.cuda.empty_cache()
    return out


def kernel_residual(x, y, alpha, s, kern, chunk=GENERAL_CHUNK):
    """‖y − (K + s²I)α‖/‖y‖ in float64 for `kern(a, b)` (a float64 block of
    plain ops), one row chunk at a time."""
    x64, a64 = x.double(), alpha.double().reshape(-1)
    y64 = y.double().reshape(-1)
    r = y64 - s * s * a64
    for r0 in range(0, x64.shape[0], chunk):
        K = kern(x64[r0:r0 + chunk], x64)
        r[r0:r0 + chunk] -= K @ a64
        del K
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(y64))


def mesh_tier(label, gp, x, y, xt, kern, mean_std=False):
    """Fit (and serve) one IterativeGP tier, counted; its float64 residual."""
    def run():
        gp.fit_gp(x, y)
        return gp.mean_std(xt) if mean_std else (gp.mean(xt), None)

    (mu, sd), wall, counts = counted(run)
    resid = kernel_residual(x, y, gp.A, LAZY_S, kern)
    print(f"  21.3 {label}: {gp.cg_iterations} CG iterations, recurrence "
          f"{gp.cg_residual!r}, float64 residual {resid!r}; {wall!r} s; "
          f"launches {nonzero(counts)}")
    return mu, sd, resid, wall, counts


def mesh_iterative_phase(dev, mesh, data, ref):
    """21.3: the mesh tiers of IterativeGP at n = 32768."""
    xl, yl, xtl = data
    mu64, var64 = ref
    out, counts_out = {}, {}
    mu, sd, resid, wall, counts = mesh_tier(
        "lazy mesh tier (SE + Matérn-3/2, no preconditioner)",
        IterativeGP(lazy_kernel(dev), s=LAZY_S, mesh=mesh, lazy=True),
        xl, yl, xtl, lazy_kernel_matrix, mean_std=True)
    one = IterativeGP(lazy_kernel(dev), s=LAZY_S, lazy=True, precond_rank=0)
    one.fit_gp(xl, yl)
    mu1 = one.mean(xtl)
    diff = float((mu - mu1).abs().max())
    errs = posterior_errors(mu, sd, mu64, var64)
    print(f"    against the one-device lazy tier at precond_rank=0: mean "
          f"{diff!r} apart (bit for bit: {torch.equal(mu, mu1)}); against "
          f"dense float64: mean {errs[0]!r}, variance max {errs[1]!r}")
    assert torch.equal(mu, mu1) and resid <= MESH_RESIDUAL_MAX, (diff, resid)
    assert counts["gram_matvec"] > 0 and counts["gram_matmat"] > 0, counts
    out["lazy"] = {"residual": resid, "wall_s": wall, "one_device_gap": diff,
                   "errors": errs}
    counts_out["21.3 lazy"] = counts
    del one
    for case, kern in (("product", lambda a, b: (
            kernel_matrix("se", GENERAL_ATOMS[0][2], a, b)
            * gram_plain(a / GENERAL_ATOMS[1][2], b / GENERAL_ATOMS[1][2],
                         1.0, "matern", GENERAL_ATOMS[1][1]))),
            ("laplace", lambda a, b: kernel_matrix("laplace", LAPLACE_GAMMA,
                                                   a, b))):
        mu, _, resid, wall, counts = mesh_tier(
            f"chunked mesh tier ({case}, chunk {GENERAL_CHUNK})",
            IterativeGP(general_kernel(dev, case), s=LAZY_S, mesh=mesh,
                        lazy=True, chunk=GENERAL_CHUNK), xl, yl, xtl, kern)
        key = "gram" if case == "product" else "gram_l1"
        assert resid <= MESH_RESIDUAL_MAX and counts[key] > 0, (resid, counts)
        out[case] = {"residual": resid, "wall_s": wall}
        counts_out[f"21.3 {case}"] = counts
        torch.cuda.empty_cache()
    mu, sd, resid, wall, counts = mesh_tier(
        "dense block-Jacobi mesh tier", IterativeGP(
            lazy_kernel(dev), s=LAZY_S, mesh=mesh, lazy=False),
        xl, yl, xtl, lazy_kernel_matrix, mean_std=True)
    errs = posterior_errors(mu, sd, mu64, var64)
    print(f"    against dense float64: mean {errs[0]!r}, variance max "
          f"{errs[1]!r}")
    assert resid <= MESH_RESIDUAL_MAX and counts["gram"] > 0, (resid, counts)
    out["dense"] = {"residual": resid, "wall_s": wall, "errors": errs}
    counts_out["21.3 dense"] = counts
    torch.cuda.empty_cache()
    gp = IterativeGP(lazy_kernel(dev), s=LAZY_S, mesh=mesh, lazy=False,
                     precision="double")
    (_, mu), wall, counts = counted(lambda: (gp.fit_gp(xl, yl),
                                             gp.mean(xtl)))
    err = mean_error(mu, mu64)
    resid = kernel_residual(xl, yl, gp._A_df.double().sum(1), LAZY_S,
                            lazy_kernel_matrix)
    print(f"  21.3 double mesh tier (dense): {gp.cg_iterations} CG "
          f"iterations, df residuals {gp.df_residuals}, float64 residual of "
          f"the df alpha {resid!r}; mean {err!r} of dense float64 (bar "
          f"{MESH_DOUBLE_MEAN_RTOL}); {wall!r} s; launches {nonzero(counts)}")
    assert err <= MESH_DOUBLE_MEAN_RTOL, err
    assert counts["gram_df"] > 0 and counts["gemv_df"] > 0, counts
    out["double"] = {"mean_err": err, "df_residuals": gp.df_residuals,
                     "residual": resid, "wall_s": wall}
    counts_out["21.3 double"] = counts
    del gp
    torch.cuda.empty_cache()
    return out, counts_out


def mesh_data_phase(dev, mesh):
    """21.4: fit_feature_gp_sharded at config 3's n against the in-memory
    fit on the same (landmark) embedding."""
    x, y = (torch.tensor(a, device=dev) for a in config3_data())
    head = x[:CONFIG3_HEAD]
    nf = NystromFeatures(config3_kernel(dev, torch.float32), m=CONFIG3_M,
                         approx="uniform", s=CONFIG3_S)
    nf.fit_gp(x, y)

    def model():
        return KernelizedFeatures(embedding=nf, m=nf.get_m(), s=CONFIG3_S,
                                  lam=1.0, primal=True, d=2)

    mem = model()
    mem.fit_gp(x, y)
    mu_mem = mem.mean_std(head)[0]
    loader = HostShardedLoader(lambda lo, hi: (x[lo:hi], y[lo:hi]),
                               n_local=CONFIG3_N, batch_size=DATA_BATCH,
                               mesh=mesh)
    sharded = model()
    (mu, _), wall, counts = counted(lambda: (
        fit_feature_gp_sharded(sharded, loader), sharded.mean_std(head))[1])
    Q = nf.embed(x).double()
    V = Q.T @ Q + CONFIG3_S ** 2 * torch.eye(Q.shape[1], dtype=Q.dtype,
                                              device=dev)
    theta = torch.linalg.solve(V, Q.T @ y.double().reshape(-1, 1))
    mu64 = (nf.embed(head).double() @ theta)[:, 0]
    errs = (mean_error(mu, mu64), mean_error(mu_mem, mu64))
    print(f"  21.4 fit_feature_gp_sharded, config 3 (n = {CONFIG3_N} in "
          f"{len(loader)} batches of {DATA_BATCH}, m = {nf.get_m()}): "
          f"{wall!r} s; mean {errs[0]!r} of max|μ64| (the in-memory fit "
          f"{errs[1]!r}; bar {DATA_MEAN_RTOL}); model.n {sharded.n}; "
          f"launches {nonzero(counts)}")
    assert max(errs) <= DATA_MEAN_RTOL and sharded.n == CONFIG3_N, errs
    del nf, mem, sharded, Q
    torch.cuda.empty_cache()
    return {"wall_s": wall, "errors": errs, "batches": len(loader)}


def memory_modes_phase(dev, data, ref):
    """21.5: the double tier at n = 32768, d = 8 (SE + Matérn-3/2): fit and
    predict peaks of each layout, and the means against dense float64."""
    xl, yl, xtl = data
    mu64, var64 = ref
    out = {}
    ko = lazy_kernel(dev)
    for label, strip in (("full", None), ("strips of 4096", 4096)):
        (_, peak), wall = synced(lambda: peak_gib(lambda: df_gram_from_desc(
            ko, {}, xl, xl, df_atom_desc(ko), strip_fold=strip)))
        print(f"  21.5 the composite df Gram at n = {LAZY_N}, {label}: "
              f"peak {peak!r} GiB, {wall!r} s")
        out[f"df gram {label}"] = {"peak_gib": peak, "wall_s": wall}
    for label, kw in SINGLE_LAYOUTS:
        gp = GaussianProcess(kernel=lazy_kernel(dev), s=LAZY_S, **kw)
        (_, fit_peak), fit_s = synced(lambda: peak_gib(
            lambda: gp.fit_gp(xl, yl)))
        ((mu, sd), pred_peak), pred_s = synced(lambda: peak_gib(
            lambda: gp.mean_std(xtl)))
        errs = posterior_errors(mu, sd, mu64, var64)
        print(f"  21.5 single tier, {label}, n = {LAZY_N}: fit {fit_s!r} s, "
              f"peak {fit_peak!r} GiB; predict {pred_s!r} s, peak "
              f"{pred_peak!r} GiB; mean {errs[0]!r}, variance max "
              f"{errs[1]!r} (bars {MESH_MEAN_RTOL}, {MESH_VAR_RTOL}); "
              f"jitter {gp.fit_status['jitter_used']!r}")
        assert gp.fit_status["cholesky_ok"], gp.fit_status
        assert errs[0] <= MESH_MEAN_RTOL and errs[1] <= MESH_VAR_RTOL, errs
        out[f"single {label}"] = {
            "fit_s": fit_s, "fit_peak_gib": fit_peak, "predict_s": pred_s,
            "predict_peak_gib": pred_peak, "errors": errs}
        del gp, mu, sd
        torch.cuda.empty_cache()
    for label, kw, refines in FOLD_LAYOUTS:
        for vr in refines:
            gp = GaussianProcess(kernel=lazy_kernel(dev), s=LAZY_S,
                                 precision="double", var_refine=vr, **kw)
            (_, fit_peak), fit_s = synced(lambda: peak_gib(
                lambda: gp.fit_gp(xl, yl)))
            reset_launch_counts()
            ((mu, sd), pred_peak), pred_s = synced(lambda: peak_gib(
                lambda: gp.mean_std(xtl)))
            counts = launch_counts()
            errs = posterior_errors(mu, sd, mu64, var64)
            var_bar = REFINED_VAR_MAX_RTOL if vr else MESH_VAR_RTOL
            print(f"  21.5 double tier, {label}, var_refine={vr}, n = "
                  f"{LAZY_N}: fit {fit_s!r} s, peak {fit_peak!r} GiB; "
                  f"predict ({MESH_T} points) {pred_s!r} s, peak "
                  f"{pred_peak!r} GiB; mean {errs[0]!r} (bar "
                  f"{FOLD_MEAN_RTOL}), variance max {errs[1]!r} (bar "
                  f"{var_bar}); jitter {gp.fit_status['jitter_used']!r}; "
                  f"predict launches {nonzero(counts)}")
            assert gp.fit_status["cholesky_ok"], gp.fit_status
            assert errs[0] <= FOLD_MEAN_RTOL and errs[1] <= var_bar, errs
            qform_err = (folded_qform_check(gp, xl, xtl)
                         if gp._fold_noise and vr else None)
            out[f"{label} var_refine={vr}"] = {
                "fit_s": fit_s, "fit_peak_gib": fit_peak,
                "predict_s": pred_s, "predict_peak_gib": pred_peak,
                "errors": errs, "predict_launches": nonzero(counts),
                "qform_df_max_abs_err": qform_err}
            del gp, mu, sd
            torch.cuda.empty_cache()
    return out


def folded_qform_check(gp, xl, xtl):
    """qform_df at fold_noise's call: the train pair carries s² on its
    diagonal, so the predict passes s = 0; the square (n, n)·(n, t) form at
    the predict's operands, held against its plain version."""
    Kh, Kl = gp._df_gram(xtl, xl)                             # (t, n)
    W0 = torch.cholesky_solve(Kh.T, gp.L).contiguous()        # (n, t)
    Bh, Bl = Kh.T.contiguous(), Kl.T.contiguous()
    del Kh, Kl
    Th, Tl = gp._df_train
    e, rel = qform_error(Th, Tl, W0, W0, Bh, Bl, s=0.0)
    print(f"    qform_df at fold_noise's s = 0 call, c = n = {xl.shape[0]}, "
          f"t = {xtl.shape[0]}: max abs err {e!r}, max err / scale {rel!r} "
          f"(bar {QFORM_RTOL})")
    assert rel <= QFORM_RTOL, ("qform_df", "fold_noise", rel)
    del W0, Bh, Bl, Th, Tl
    torch.cuda.empty_cache()
    return e


def mesh_kernel_checks(dev, data):
    """Each kernel of phase 21 against its plain version at the shapes the
    phase gives it on one rank and at a 4-rank run's (n/4, n) row block at
    a nonzero offset. Returns {kernel: {shape label: max abs error}}."""
    xl, _, _ = data
    x, _, _ = bench_data(dev)
    errs = {k: {} for k in ("gram", "gram_l1", "gram_df", "gemv_df",
                            "gram_matvec", "gram_matmat")}
    gen = torch.Generator(device=dev).manual_seed(21)
    for label, rows, cols in (
            (f"{N}x{N}", x, x),
            (f"rows {row_block(N).start}:{row_block(N).stop} of {N}",
             x[row_block(N)], x),
            (f"{N}x{1024} strip", x, x[:1024])):
        errs["gram"][label] = scaled_gram_check(
            f"21 {label}", rows / GAMMA, cols / GAMMA, "se", 1.5)
    n = LAZY_N
    blk = row_block(n)
    # the dense mesh tier's rows and 21.5's single tier: each atom's Gram
    # at p = 1 and at a 4-rank run's row block
    for label, rows in ((f"{n}x{n}", xl),
                        (f"rows {blk.start}:{blk.stop} of {n}", xl[blk])):
        for fam, nu, gamma in LAZY_ATOMS:
            errs["gram"][f"{fam} {label}"] = scaled_gram_check(
                f"21 {label}", rows / gamma, xl / gamma, fam, nu)
    for label, rows in ((f"{GENERAL_CHUNK}x{n}", xl[:GENERAL_CHUNK]),
                        (f"rows {blk.start}:{blk.stop} of {n}", xl[blk])):
        errs["gram_l1"][label] = gram_l1_check(f"21 {label}", rows, xl,
                                               LAPLACE_GAMMA)
    x64 = xl.double()
    for label, rows in ((f"4096x{n}", x64[:4096]),
                        (f"rows {blk.start}:{blk.start + 4096} of {n}",
                         x64[blk.start:blk.start + 4096])):
        for fam, nu, gamma in LAZY_ATOMS:
            e, hi, lo = gram_df_check(f"21 {label}", rows, x64, fam, nu,
                                      gamma)
            errs["gram_df"][f"{fam} {label}"] = e
            v = torch.randn(n, generator=gen, device=dev)
            errs["gemv_df"][f"{fam} {label}"] = gemv_df_check(
                f"21 {label}", hi, lo, v, v * EPS32)
            del hi, lo
    torch.cuda.empty_cache()
    V = torch.randn((n, MESH_T), generator=gen, device=dev)
    for label, rows in ((f"{n}x{n}", xl),
                        (f"rows {blk.start}:{blk.stop} of {n}", xl[blk])):
        for fam, nu, gamma in LAZY_ATOMS:
            xs, ys = rows / gamma, xl / gamma
            for name, fn, rhs in (("gram_matvec", gram_matvec_scaled, V[:, 0]),
                                  ("gram_matmat", gram_matmat_scaled, V)):
                e, rel = matvec_error(fn, xs, ys, rhs, fam, nu)
                print(f"    {name} {fam} 21 {label}: max abs err {e!r}, "
                      f"max err / sum|K||v| {rel!r} (bar {matvec_rtol(n)!r})")
                assert rel <= matvec_rtol(n), (name, label, rel)
                errs[name][f"{fam} {label}"] = e
    torch.cuda.empty_cache()
    return errs


def phase21(dev):
    """Phase 21 on a one-rank NCCL mesh (make_mesh starts the group and the
    phase destroys it). Returns (record, walls, launch counts, errors)."""
    import torch.distributed as dist

    mesh = make_mesh(device=dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    assert dist.get_backend() == backend and dist.get_world_size() == 1
    out, walls, counts = {}, {}, {}
    try:
        out["21.1 mesh"], walls["21.1 mesh"] = synced(
            lambda: mesh_basics_phase(dev, mesh))
        out["21.2 blocked"], walls["21.2 blocked"] = synced(
            lambda: mesh_gp_phase(dev, mesh))
        data = bench_data(dev, LAZY_N, MESH_T)
        mu64, var64, _ = reference_f64(*data, kern=lazy_kernel_matrix,
                                       s=LAZY_S, prior_var=2.0)
        torch.cuda.empty_cache()
        (out["21.3 iterative"], c3), walls["21.3 iterative"] = synced(
            lambda: mesh_iterative_phase(dev, mesh, data, (mu64, var64)))
        out["21.4 data"], walls["21.4 data"] = synced(
            lambda: mesh_data_phase(dev, mesh))
        out["21.5 memory modes"], walls["21.5 memory modes"] = synced(
            lambda: memory_modes_phase(dev, data, (mu64, var64)))
        errs, walls["21.6 kernels"] = synced(
            lambda: mesh_kernel_checks(dev, data))
    finally:
        dist.destroy_process_group()
    b1, b2 = out["21.1 mesh"], out["21.2 blocked"]
    counts = {"21.1 sharded_gram": b1["sharded_gram"]["launches"],
              "21.1 evidence": b1["evidence"]["launches"],
              "21.2 panels fit": b2["panels"]["fit_launches"],
              **{f"21.2 {fac} predict": b2[fac]["predict_launches"]
                 for fac in ("panels", "masked", "rec")},
              **{k: nonzero(v) for k, v in c3.items()},
              **{f"21.5 {k} predict": v["predict_launches"]
                 for k, v in out["21.5 memory modes"].items()
                 if "predict_launches" in v}}
    total = sum(walls.values())
    print(f"  phase 21 walls (s): {walls}; in all {total!r} s")
    return out, walls, counts, errs


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
    errs_d, deriv_times, deriv_bounds, ard_trace = deriv_checks(dev)
    errs |= errs_d
    ktimes |= deriv_times
    bounds |= deriv_bounds
    backward_err, backward_counts = backward_check(dev)
    matvec_m32_ms = {label: t.pop("gram_matvec_matern32")
                     for label, t in mv_times.items()}
    # the record carries the lazy tier's shape (65k, SE), the main path's
    ktimes |= mv_times["65k"]
    bounds |= {"gram_matvec": matvec_bound(LAZY_BIG_N, LAZY_BIG_N, D, "se"),
               "gram_matmat": matmat_tc_bound(LAZY_BIG_N, LAZY_BIG_N, D, "se",
                                              MATMAT_R)}
    matmat_f32_bound = matvec_bound(LAZY_BIG_N, LAZY_BIG_N, D, "se", MATMAT_R)
    print("  2e: gram_df's L1 (Laplace) family against its plain version")
    l1_err, l1_times, l1_bound = gram_df_l1_checks(dev)
    errs_chol, chol_times, chol_bounds, library = chol_checks(dev, x)
    errs |= errs_chol
    leaf2048 = chol_times.pop("leaf_chol_2048")
    syrk_tail = chol_times.pop("syrk_lower_tail")
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
    refined, refined_gp, refined_counts, refined_peak = {}, {}, {}, {}
    peak_so_far = 0
    for label, kernel, family in (("se", se, "se"), ("matern32", m32, "m32")):
        if label != "se":
            mu64, var64, _ = reference_f64(x, y, xt, family)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2**30
        peak_so_far = max(peak_so_far, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        gp, mu, sd, counts = run_tier(kernel, x, y, xt, precision="double",
                                      var_refine=1)
        refined_peak[label] = torch.cuda.max_memory_allocated() / 2**30
        refined[label] = posterior_errors(mu, sd, mu64, var64)
        refined_gp[label], refined_counts[label] = gp, counts
        m, vmax, vmed = refined[label]
        print(f"  {label}: mean rel err {m!r} (bar 1e-6, ROADMAP bar 1e-7), "
              f"var rel err max {vmax!r} (ROADMAP bar 1e-6) median {vmed!r}, "
              f"fit_status {gp.fit_status}, launches {counts}; peak device "
              f"memory {refined_peak[label]!r} GiB ({held!r} GiB held "
              f"before: the data and the float64 reference)")
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
              **{k: "the 65k lazy shape, SE" for k in deriv_times},
              "syrk_lower": f"m = {SYRK_PROBE[0]}, k = {SYRK_PROBE[1]}",
              "chol_leaf": f"n = {LEAF_SIZES[0]}"}
    for name, (k_ms, p_ms) in ktimes.items():
        print(f"  {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms, bound "
              f"{bounds[name][0]!r} ms ({bounds[name][1]}) at "
              f"{shapes.get(name, 'the bench shape')}")
    m32_bound = matvec_bound(LAZY_BIG_N, LAZY_BIG_N, D, "matern")[0]
    print("  gram_matvec, Matérn-3/2 atom (γ = 0.8): kernel "
          + ", ".join(f"{k} {v!r} ms" for k, v in matvec_m32_ms.items())
          + f"; bound at 65k {m32_bound!r} ms")
    print(f"  gram_matmat: its bound with the product on the f32 pipes "
          f"(matvec_bound) {matmat_f32_bound[0]!r} ms")
    print(f"  qform_df: cuBLAS f64 DGEMM of the same (c, n)·(n, t) product "
          f"(a library product, not the same function) {qtimes[2]!r} ms")
    print(f"  syrk_lower: torch.addmm(T, W, W.T, alpha=-1) {library['syrk_lower']!r}"
          " ms (not the same function: the full square, twice the work); "
          "bound with the product on the f32 pipes "
          f"{syrk_bound(*SYRK_PROBE)[0]!r} ms; at m = {SYRK_TAIL[0]}, k = "
          f"{SYRK_TAIL[1]} kernel {syrk_tail[0]!r} ms, plain {syrk_tail[1]!r}"
          f" ms, tensor-core bound {syrk_tc_bound(*SYRK_TAIL)[0]!r} ms")
    print(f"  chol_leaf: torch.linalg.cholesky_ex at n = {LEAF_SIZES[0]} "
          f"{library['chol_leaf']!r} ms; at n = {2 * LEAF_SIZES[0]}: "
          f"_leaf_chol_ (two leaves, the split's inverse and products) "
          f"{leaf2048[0]!r} ms, cholesky_ex {leaf2048[1]!r} ms")
    print(f"  peak device memory so far (float64 references included) "
          f"{max(peak_so_far, torch.cuda.max_memory_allocated()) / 2**30!r}"
          " GiB")
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
    (a_seg, seg_it, _), seg_s, seg_counts = counted(
        lambda: iterative.cg_solve_segmented(
            gps._matvec, yb.reshape(-1), M_inv=gps._M_inv, tol=gps.tol,
            maxiter=gps.maxiter))
    seg_resid = exact_residual(xb, yb, a_seg)
    print(f"  cg_solve_segmented on the defaults' system: {seg_s!r} s, "
          f"{seg_it} iterations, float64 residual {seg_resid!r} (bar "
          f"{SEGMENTED_RESIDUAL_MAX}) beside the unsegmented fit's "
          f"{stock_resid!r}; launches {nonzero(seg_counts)}")
    assert seg_resid <= SEGMENTED_RESIDUAL_MAX, seg_resid
    assert seg_counts["gram_matvec"] > 0, seg_counts
    del gps, a_seg
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
    blk = gpb.kernel_object.cross(xtb[:128], xb).T.contiguous()
    solves = {}
    for label, solve in (("cg_solve_block", iterative.cg_solve_block),
                         ("cg_solve_block_segmented",
                          iterative.cg_solve_block_segmented)):
        (X, it), wall, counts = counted(lambda: solve(
            gpb._matmat, blk, M_inv=gpb._M_inv, tol=gpb.tol,
            maxiter=gpb.maxiter))
        solves[label] = (exact_residual(xb, blk, X), it, wall)
        assert counts["gram_matmat"] > 0, (label, counts)
        del X
    (blk_resid, blk_it, blk_s), (seg_blk_resid, seg_blk_it, seg_blk_s) = (
        solves.values())
    print(f"  the exact variance's first 128 columns: cg_solve_block "
          f"{blk_s!r} s, {blk_it} iterations, float64 residual (worst "
          f"column) {blk_resid!r} (bar {LAZY_RESIDUAL_MAX}); "
          f"cg_solve_block_segmented {seg_blk_s!r} s, {seg_blk_it} "
          f"iterations, {seg_blk_resid!r} (bar {SEGMENTED_RESIDUAL_MAX})")
    assert blk_resid <= LAZY_RESIDUAL_MAX, blk_resid
    assert seg_blk_resid <= SEGMENTED_RESIDUAL_MAX, seg_blk_resid
    del blk
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
    # phase 13.3 goes on from the fitted gpb
    del xtb
    torch.cuda.empty_cache()

    print(f"== phase 11: the fast factor (chol_dense(fast=True)) in "
          f"benchmarks/exp_fastchol.py's three variants, n = ntest = {N}, "
          f"d = {D}, SE gamma = {GAMMA}, s = {S}, against float64")
    fast, factor_ms, peaks, unjittered = fast_chol_phase(dev, se, *se_ref)
    launches |= {"syrk_lower": ("fast_chol",
                                fast["fast"]["launches"]["syrk_lower"]),
                 "chol_leaf": ("fast_chol",
                               fast["fast"]["launches"]["chol_leaf"])}
    walls |= {f"fast_chol_{k}": v["wall_s"] for k, v in fast.items()}

    print(f"== phase 12: the df-entry stage probe "
          f"(stpy_tpu_torch/probes/exp_r3_df_entry.py: benchmarks/"
          f"exp_r3_batch_p/t/u/x.py), Matérn-5/2, gamma = "
          f"{exp_r3_df_entry.G}, d = {D}, against float64 and decimal")
    probe, probe_counts, errs_stage, stage_times, stage_bounds, stage_extra = \
        df_stage_phase(dev)
    errs |= errs_stage
    ktimes |= stage_times
    bounds |= stage_bounds
    launches |= {name: ("df_entry_probe", probe_counts[name])
                 for name in stage_times}

    print("== phase 13: the matrix-free hyperparameter fit (parallel/bbmm.py, "
          "parallel/slq.py, IterativeGP.optimize_params)")
    torch.cuda.empty_cache()
    xl, yl, _ = bench_data(dev, LAZY_N, LAZY_T)
    sum_atoms = [(fam, gamma, 1.0) for fam, _, gamma in LAZY_ATOMS]
    ev_sum = evidence_check(
        f"13.1 SE(0.5) + Matérn-3/2(0.8), n = {LAZY_N}, d = {D}, s = {LAZY_S}",
        lazy_kernel(dev), xl, yl[:, 0], sum_atoms,
        tuple((fam, nu, None) for fam, nu, _ in LAZY_ATOMS),
        [gamma for _, _, gamma in LAZY_ATOMS])
    hyper_data, hyperfit, hyper_wall, hyper_counts, hyper_nll0 = \
        hyperfit_phase(dev)
    if profile:
        xh, yh = hyper_data
        kw = {k: HYPERFIT[k] for k in ("probes", "cg_tol", "cg_maxiter",
                                       "probe_tol", "probe_maxiter",
                                       "precond_rank")}

        def step(where):
            return lambda: evidence_value_and_grad_lazy(
                xh, yh, hyperfit["gamma"], 1.0, hyperfit["noise"],
                compute_value=False,
                generator=bbmm.step_generator(0, 1, where), **kw)

        # the step as the fit runs it (probes and landmarks drawn on the
        # card), then with them drawn on the host and copied over: the
        # difference in idle time is the host draws' share
        idle = {}
        for where in (dev, "cpu"):
            step(where)()
            busy, span = profile_run(
                f"one warm evidence step of 13.2 (n = {LAZY_BIG_N}, d = "
                f"{HYPERFIT_D}, SE, at the fitted values; random draws on "
                f"{torch.device(where).type})", step(where))
            idle[torch.device(where).type] = span - busy
        print(f"  the host draws' share of that step's idle time: "
              f"{(idle['cpu'] - idle['cuda']) / idle['cpu']!r} ({idle['cpu']!r}"
              f" ms idle with them, {idle['cuda']!r} ms without)")
        del xh, yh
    del hyper_data
    torch.cuda.empty_cache()
    optimized, opt_wall, opt_counts, opt_resid = optimize_phase(gpb, xb, yb)
    del gpb, xb, yb
    torch.cuda.empty_cache()
    ard_kernel = KernelFunction(kernel_name="ard", ard_gamma=list(ARD_GAMMA),
                                d=D, device=dev)
    ev_ard = evidence_check(
        f"13.4 ARD SE, γ = {ARD_GAMMA}, n = {LAZY_N}, d = {D}, s = {LAZY_S}",
        ard_kernel, xl, yl[:, 0], [("se", ARD_GAMMA, 1.0)],
        (("se", 1.5, None),),
        [torch.tensor(ARD_GAMMA, dtype=torch.float32, device=dev)],
        hold_nll=False)
    assert ev_ard[3]["gram_matmat[dk]"] > 0, ev_ard[3]
    del xl, yl
    torch.cuda.empty_cache()
    launches |= {
        "gram_matvec[dk_sq]": ("hyperfit_65k",
                               hyper_counts["gram_matvec[dk_sq]"]),
        "gram_matmat[dk_sq]": ("hyperfit_65k",
                               hyper_counts["gram_matmat[dk_sq]"]),
        "gram_matmat[dk]": ("ard_evidence_32k", ev_ard[3]["gram_matmat[dk]"]),
        "gram_matvec[dk]": ("matvec_backward",
                            backward_counts["gram_matvec[dk]"])}
    walls |= {"evidence_32k_sum": ev_sum[2], "evidence_32k_ard": ev_ard[2],
              "hyperfit_65k": hyper_wall, "optimize_params_65k": opt_wall}

    print("== phase 14: the exact GP's evidence hyperfit (opt/lbfgs.py, "
          "Estimator.optimize_params_general, GaussianProcess.optimize_params"
          " / sample / log_probability / log_marginal)")
    print(f"  14.1 benchmarks/run_all.py config 1: n = {CONFIG1_N}, "
          f"{CONFIG1_GP}, {CONFIG1_FIT}")
    gp_c1, fit_se = exact_hyperfit_phase(dev, "squared_exponential")
    print("  14.2 the same with the Laplace kernel")
    _, fit_laplace = exact_hyperfit_phase(dev, "laplace")
    print("  14.3 an ARD SE bandwidth+noise fit")
    fit_ard = ard_fit_phase(dev)
    print(f"  14.4 sample, log_probability and log_marginal on 14.1's GP")
    sampled = sample_phase(gp_c1, dev)
    del gp_c1
    torch.cuda.empty_cache()
    walls |= {"config1_hyperfit": fit_se["wall_s"],
              "config1_laplace_hyperfit": fit_laplace["wall_s"],
              "ard_4096_hyperfit": fit_ard["wall_s"]}

    print("== phase 15: the rest of the GP models (bbmm's general tier, the "
          "df-refined matrix-free variance, robust losses, the BO helpers, "
          "volume_mean, OnlineGP)")
    phase15 = {"general": general_phase(dev)}
    phase15["df_variance"] = df_variance_phase(dev, stock_resid)
    phase15["robust"] = robust_phase(dev)
    phase15 |= bo_phase(dev)
    phase15["volume_mean"] = volume_phase(dev)
    phase15["online_gp"] = online_phase(dev)
    torch.cuda.empty_cache()
    sub_counts = {
        "15.1 product": phase15["general"]["product"]["launches"],
        "15.1 laplace": phase15["general"]["laplace"]["launches"],
        "15.2": phase15["general"]["hyperfit"]["launches"],
        "15.3": phase15["df_variance"]["launches"],
        "15.3 fit": phase15["df_variance"]["fit_launches"],
        **{f"15.4 {loss}": phase15["robust"][loss]["launches"]
           for loss in ROBUST_LOSSES},
        "15.5": phase15["ucb"]["launches"],
        "15.6": phase15["gradient_helpers"]["launches"],
        "15.7": phase15["sample_and_max"]["launches"],
        "15.7 grid-free": phase15["sample_iteratively_max"]["launches"],
        "15.8 relu": phase15["volume_mean"]["relu"]["launches"],
        "15.8 logistic": phase15["volume_mean"]["logistic"]["launches"],
        "15.9": phase15["online_gp"]["launches"]}

    print("== phase 16: the feature-GP and Nyström slice (embeddings, "
          "KernelizedFeatures, NystromFeatures, IterativeGP.sample_pathwise)")
    phase16 = {"config2": config2_phase(dev), "config3": config3_phase(dev),
               "pathwise": pathwise_phase(dev)}
    sub_counts16 = {
        "16.1 exact GP": phase16["config2"]["exact_launches"],
        "16.2": phase16["config3"]["launches"],
        "16.3 fit": phase16["pathwise"]["fit_launches"],
        "16.3 sample_pathwise": phase16["pathwise"]["launches"]}
    walls |= {"config2_feature_gp": phase16["config2"]["wall_s"],
              "config3_nystrom_50k": phase16["config3"]["wall_s"],
              "pathwise_32k": phase16["pathwise"]["wall_s"]}

    print("== phase 17: the Poisson point-process slice (domains, the "
          "positive bases, PoissonRateEstimator and its ellipsoid bounds) "
          "and run_all.py config 5")
    phase17 = {"config4": config4_phase(dev), "user": poisson_user_phase(dev),
               "config5": config5_phase(dev)}
    sub_counts17 = {"17.1": phase17["config4"]["fit"]["launches"],
                    "17.3": phase17["user"]["fit"]["launches"],
                    "17.4": phase17["config5"]["launches"]}
    walls |= {"config4_fit": phase17["config4"]["fit"]["wall_s"],
              "config4_bounds": phase17["config4"]["bounds"]["wall_s"],
              "poisson_1024_fit": phase17["user"]["fit"]["wall_s"],
              "poisson_1024_bounds": phase17["user"]["bounds"]["wall_s"],
              "config5_hyperfit": phase17["config5"]["wall_s"]}

    print("== phase 18: the kernel tail and the general double tier (the "
          "Laplace L1 family of gram_df, general-ν Matérn, SE + linear), the "
          "group and manifold fits, and the link, log-linear, MBR and "
          "Bernoulli estimators")
    phase18 = {"laplace_double": laplace_double_phase(dev),
               "general_nu": general_nu_phase(dev),
               "se_linear_double": se_linear_double_phase(dev),
               "groups": groups_phase(dev), "manifold": cov_phase(dev),
               "estimators": poisson_estimators_phase(dev)
               | bernoulli_phase(dev)}
    torch.cuda.empty_cache()
    sub_counts18 = {
        **{f"18.1 var_refine={vr}":
           phase18["laplace_double"][f"var_refine_{vr}"]["launches"]
           for vr in (0, 1)},
        "18.2 single": phase18["general_nu"]["launches"],
        "18.2 double": phase18["general_nu"]["double_launches"],
        "18.3": phase18["se_linear_double"]["launches"],
        "18.4": phase18["groups"]["launches"],
        **{f"18.6 {name}": rec["launches"]
           for name, rec in phase18["estimators"].items()}}
    assert sub_counts18["18.1 var_refine=1"]["gram_df"] > 0, sub_counts18
    walls |= {"laplace_double_var_refine_1":
              phase18["laplace_double"]["var_refine_1"]["wall_s"],
              "se_linear_double": phase18["se_linear_double"]["wall_s"],
              "groups_4096": phase18["groups"]["wall_s"],
              **{f"{name}_fit": rec["fit_s"]
                 for name, rec in phase18["estimators"].items()}}

    print("== phase 19: approximate inference, MKL and the rest of the "
          "point-process stack (MultipleKernelLearner, MKL, PrimalMKL, the "
          "SGCP, tmg, EP, the mixtures, GammaContProcess, TraceFeatures, "
          "ConvexRKHS, the likelihoods), f32 against float64 on the card")
    phase19_rec, phase19_walls = phase19(dev)
    torch.cuda.empty_cache()
    mkl19, sgcp19 = phase19_rec["19.1 mkl"], phase19_rec["19.2 sgcp"]
    sub_counts19 = {
        "19.1 fit": mkl19["fit"]["launches"],
        "19.1 mean_std": mkl19["mean_std"]["launches"],
        "19.2 build": sgcp19["build"]["launches"],
        "19.2 exact bands": sgcp19["exact_bands"]["launches"],
        "19.2 linear-response bands": sgcp19["linear_response"]["launches"],
        **{f"19.4 {name}": phase19_rec["19.4 mixtures"][name]["launches"]
           for name in ("DirichletMixture", "CategoricalMixture")},
        "19.4 GammaContProcess": phase19_rec["19.4 gamma_process"]["launches"]}
    walls |= {f"phase19 {k}": v for k, v in phase19_walls.items()}

    print("== phase 20: the library's tail (linalg's remaining functions, "
          "Bayesian optimisation over the test functions through configs, "
          "FelSimulator, ProteinBenchmark, the coreset, FeatureRanker, SRI, "
          "the CVAE, the checkpoints, euler_maruyama)")
    phase20_rec, phase20_walls, sub_counts20, errs20 = phase20(dev)
    torch.cuda.empty_cache()
    walls |= {f"phase20 {k}": v for k, v in phase20_walls.items()}

    print("== phase 21: the multi-device tier on a one-rank NCCL mesh "
          "(sharded_gram, distributed_evidence, restart_farm, "
          "DistributedExactGP, IterativeGP's mesh tiers, "
          "fit_feature_gp_sharded) and the exact GP's memory modes "
          "(fold_noise, strip_fold, jitter_ladder='recompute') at n = 32768")
    phase21_rec, phase21_walls, sub_counts21, errs21 = phase21(dev)
    torch.cuda.empty_cache()
    walls |= {f"phase21 {k}": v for k, v in phase21_walls.items()}

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": REPLACES[name][0],
         "replaces": REPLACES[name][1], "tier": launches[name][0],
         "launches": launches[name][1], "max_abs_err": errs[name],
         "ms": ktimes[name][0], "plain_ms": ktimes[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name),
         **stage_extra.get(name, {}),
         "phase15_launches": {sub: c[name] for sub, c in sub_counts.items()
                              if c.get(name)},
         "phase16_launches": {sub: c[name] for sub, c in sub_counts16.items()
                              if c.get(name)},
         "phase17_launches": {sub: c[name] for sub, c in sub_counts17.items()
                              if c.get(name)},
         "phase18_launches": {sub: c[name] for sub, c in sub_counts18.items()
                              if c.get(name)},
         "phase19_launches": {sub: c[name] for sub, c in sub_counts19.items()
                              if c.get(name)},
         "phase20_launches": {sub: c[name] for sub, c in sub_counts20.items()
                              if c.get(name)},
         **({"phase20_max_abs_err": errs20[name]} if name in errs20 else {}),
         "phase21_launches": {sub: c[name] for sub, c in sub_counts21.items()
                              if c.get(name)},
         **({"phase21_shapes_max_abs_err": errs21[name]}
            if name in errs21 else {}),
         **({"phase19_shapes": mkl19["kernels"][name]}
            if name in mkl19["kernels"] else {}),
         **({"l1_family": {
             "max_abs_err": l1_err, "ms": l1_times[0], "plain_ms": l1_times[1],
             "bound_ms": l1_bound[0], "bound_by": l1_bound[1],
             "launches": phase18["laplace_double"]["var_refine_1"][
                 "launches"]["gram_df"]}} if name == "gram_df" else {})}
        for name in REPLACES
    ], "qform_df_dgemm_ms": qtimes[2], "gram_matmat_sgemm_16k_ms": sgemm_ms,
        "gram_matvec_matern32_ms": matvec_m32_ms,
        "var_refine_peak_gib": refined_peak,
        "gram_matmat_f32_pipe_bound_ms": matmat_f32_bound[0],
        "syrk_lower_f32_pipe_bound_ms": syrk_bound(*SYRK_PROBE)[0],
        "syrk_lower_tail": {"m": SYRK_TAIL[0], "k": SYRK_TAIL[1],
                            "ms": syrk_tail[0], "plain_ms": syrk_tail[1],
                            "bound_ms": syrk_tc_bound(*SYRK_TAIL)[0]},
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
                      "lazy_65k_segmented": {
                          "defaults_fit": seg_resid, "block": seg_blk_resid,
                          "block_unsegmented": blk_resid}},
        "lazy_65k_fit_status": status,
        "lazy_65k_defaults_fit_status": stock_status,
        "lazy_32k_precond_basis": basis,
        "fast_chol": {**fast, "factor_ms": factor_ms,
                      "factor_peak_gib": peaks, "unjittered": unjittered},
        "df_entry_probe": probe,
        "gram_matvec_backward_max_err_over_scale": backward_err,
        "gram_matmat_dk_ard_trace": {
            "r": ARD_TRACE_R, "d": ARD_TRACE_D,
            "ms": ard_trace[ARD_TRACE_R][0],
            "bound_ms": ard_trace[ARD_TRACE_R][1],
            "ms_at_r128": ard_trace[MATMAT_R][0]},
        "evidence_32k": {"sum": ev_sum[:2], "ard": ev_ard[:2]},
        "hyperfit_65k": {k: hyperfit[k] for k in (
            "gamma", "kappa", "noise", "nll", "steps_run")} | {
            "nll_start": hyper_nll0, "launches": hyper_counts},
        "optimize_params_65k": {"gammas": optimized["gammas"],
                                "noise": optimized["noise"],
                                "residual": opt_resid,
                                "launches": opt_counts},
        "exact_hyperfit": {"config1": fit_se, "config1_laplace": fit_laplace,
                           "ard_4096": fit_ard, "sample_256": sampled},
        "phase15": phase15, "phase16": phase16, "phase17": phase17,
        "phase18": phase18, "phase19": phase19_rec, "phase20": phase20_rec,
        "phase21": phase21_rec}
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
