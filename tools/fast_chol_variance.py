#!/usr/bin/env python3
"""The fast factor's posterior variance against its pieces and block size.

`chip_smoke.py` phase 11 finds the fast factor (`chol_dense(fast=True)`,
`ops.syrk.chol_blocked_syrk` at nb = 2048) at about 2.5 times the default
factor's variance max, at an equal backward error. This script factors
phase 11's system (bench.py's data, n = 16384, d = 8, SE gamma = 0.5,
s = 0.1) without jitter: the default (cuSOLVER) factor, the float64 factor
rounded to f32, the fast factor rebuilt from its pieces
(`chip_smoke.rebuilt_fast_factor`) with its panels by triangular solves
and with cholesky_ex leaves, and `chol_blocked_syrk` at nb = 4096, 2048,
1024 and 512. It runs each through phase 11's pipeline
(`chip_smoke.factor_errors`) and prints its posterior errors against
float64 and its backward error. Needs CUDA; about a minute on an H100
with the kernels' build:

    python3 tools/fast_chol_variance.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from stpy_tpu_torch import KernelFunction  # noqa: E402
from stpy_tpu_torch.ops.syrk import chol_blocked_syrk  # noqa: E402

BLOCKS = (4096, 2048, 1024, 512)


def solve_panel(W, D):
    """W ← W·D⁻ᵀ by one triangular solve on W itself."""
    W.copy_(torch.linalg.solve_triangular(D.T, W, upper=True, left=False))


def cholesky_ex_leaf(T):
    T.copy_(torch.linalg.cholesky_ex(T)[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("fast_chol_variance: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.card_line())
    x, y, xt = cs.bench_data(dev)
    mu64, var64, _ = cs.reference_f64(x, y, xt)
    se = KernelFunction(kernel_name="squared_exponential", gamma=cs.GAMMA,
                        d=cs.D, device=dev)
    factors = [("default (cholesky_ex)",
                lambda A: torch.linalg.cholesky_ex(A)[0]),
               ("float64 factor rounded to f32",
                lambda A: torch.linalg.cholesky(A.double()).float()),
               ("fast, panels by solve_triangular",
                lambda A: cs.rebuilt_fast_factor(A, panel=solve_panel)),
               ("fast, cholesky_ex leaves",
                lambda A: cs.rebuilt_fast_factor(A, leaf=cholesky_ex_leaf))]
    factors += [(f"fast, nb = {nb}",
                 lambda A, nb=nb: chol_blocked_syrk(A, nb=nb))
                for nb in BLOCKS]
    for label, factor in factors:
        e = cs.factor_errors(se, x, y, xt, factor, mu64, var64)
        print(f"{label}: mean rel err {e['mean']!r}, var rel err max "
              f"{e['var_max']!r} median {e['var_median']!r}; backward error "
              f"{e['backward']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
