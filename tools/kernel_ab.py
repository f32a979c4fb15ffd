#!/usr/bin/env python3
"""This tree's hand kernels against an earlier tree's, on one card.

    python3 tools/kernel_ab.py BASE [--reps N]

BASE is an unpacked copy of an earlier commit, e.g.
`git archive <commit> | tar -x -C build/base` (a directory .gitignore
lists). Each tree's kernels are built from its own csrc/ into its own
build/ and run on the same inputs, at the shapes `chip_smoke.py` times them:
`gram` (n = m = 16384, d = 8, SE and Matérn-3/2, and a ragged shape),
`gram_l1` (n = m = 16384, d = 8, and ragged shapes at d = 1, 33 and 130),
`gram_df` (every shape code: K(x, x), whose lower half this tree computes
and mirrors, and K(x, x') on a copy x' of x, at n = 300 and 16384, d = 8,
and at n = 1000, d = 33; timed at 16384 for SE and Matérn-5/2) and
`gram_matmat` (n = m = 65536, d = 8, r = 128, and a ragged shape),
whose arithmetic the two trees share, are held bit for bit equal; `syrk_lower`
(m = 14336 and 2048, k = 2048) is compared as max |Δ| / (|W||W|ᵀ). Each is
timed by CUDA events in turns, base, this tree, this tree, base. Beside
them, two yardsticks of what the card reaches at these shapes, used
nowhere in the port: cuBLAS's one-pass TF32 product W·Wᵀ at the first
`syrk_lower` shape (its rate in TFLOP/s) and `fill_` of the 16384² f32
Gram's bytes (its rate in GB/s). Prints a line per kernel and shape, the
card's name and power limit, then one JSON record. Exits non-zero
without CUDA or where a bitwise pair differs.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from stpy_tpu_torch import _build  # noqa: E402
from stpy_tpu_torch.ops.gram import gram_scaled  # noqa: E402
from stpy_tpu_torch.ops.gram_df import gram_df_scaled  # noqa: E402
from stpy_tpu_torch.ops.gram_l1 import gram_l1  # noqa: E402
from stpy_tpu_torch.ops.gram_matvec import gram_matmat_scaled  # noqa: E402
from stpy_tpu_torch.ops.syrk import syrk_update_lower_  # noqa: E402


# gram_l1's ragged shapes: n and m not multiples of 4 or 32, d one, past
# one staged chunk of 32 features, and past four
L1_RAGGED = ((300, 517, 1), (301, 259, 33), (77, 130, 130))
# gram_df's shape codes (ops/gram.py:SHAPE_CODES and L1_CODE) and its
# square shapes (n, d): tiles cut by the edge, more than two staged chunks
# of 16 features, and the benchmark's
DF_FAMILIES = (("se", 1.5), ("matern", 0.5), ("matern", 1.5),
               ("matern", 2.5), ("laplace", 1.5))
DF_SHAPES = ((300, 8), (1000, 33), (cs.N, cs.D))
DF_TIMED = (("se", 1.5), ("matern", 2.5))


def base_library(base: Path):
    """The base tree's kernel library, built by its own _build.py."""
    spec = importlib.util.spec_from_file_location(
        "base_build", base / "stpy_tpu_torch" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


@contextlib.contextmanager
def using(lib):
    """This tree's wrappers launching `lib`'s entry points (same C
    signatures)."""
    saved = _build.library()
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def in_turns(base_fn, new_fn, reps):
    """(base ms, this tree's ms): base, new, new, base."""
    b1 = cs.cuda_ms(base_fn, reps)
    n1 = cs.cuda_ms(new_fn, reps)
    n2 = cs.cuda_ms(new_fn, reps)
    b2 = cs.cuda_ms(base_fn, reps)
    return (b1 + b2) / 2, (n1 + n2) / 2


def same_arithmetic(name, label, fn, base, reps, timed):
    """Run `fn` on both libraries; assert equal bits (of each tensor, where
    `fn` returns a tuple); time if `timed`."""
    with using(base):
        want = fn()
    got = fn()
    got, want = ((r,) if torch.is_tensor(r) else r for r in (got, want))
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"  {name} {label}: bitwise equal to the base tree's: {equal}")
    assert equal, (name, label, max(float((g - w).abs().max())
                                    for g, w in zip(got, want)))
    del got, want
    if not timed:
        return None

    def base_fn():
        with using(base):
            fn()

    ms = in_turns(base_fn, fn, reps)
    print(f"  {name} {label}: base {ms[0]!r} ms, this tree {ms[1]!r} ms "
          f"({(ms[1] / ms[0] - 1) * 100:+.2f} %)")
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    base, new = base_library(args.base.resolve()), _build.library()
    _build._lib = new
    rng = np.random.default_rng(0)
    record = {}

    def coords(n, d):
        return torch.as_tensor(rng.uniform(-1, 1, (n, d)) / cs.GAMMA,
                               dtype=torch.float32, device=dev)

    n, m, d = cs.RAGGED
    x, y = coords(n, d), coords(m, d)
    for fam, nu in cs.FAMILIES:
        same_arithmetic("gram", f"ragged {fam}", lambda: gram_scaled(
            x, y, 1.0, fam, nu), base, args.reps, False)
    V = torch.as_tensor(rng.standard_normal((m, cs.RAGGED_R[0])),
                        dtype=torch.float32, device=dev)
    same_arithmetic("gram_matmat", "ragged", lambda: gram_matmat_scaled(
        x, y, V, 1.3, "se"), base, args.reps, False)
    inv_g2 = 1.0 / cs.LAPLACE_GAMMA ** 2
    for n, m, d in L1_RAGGED:
        xu, yu = coords(n, d) * cs.GAMMA, coords(m, d) * cs.GAMMA
        same_arithmetic("gram_l1", f"ragged {n}x{m} d={d}",
                        lambda xu=xu, yu=yu: gram_l1(xu, yu, inv_g2, 1.3),
                        base, args.reps, False)

    for n, d in DF_SHAPES:
        xs = coords(n, d).double()
        xc = xs.clone()
        for fam, nu in DF_FAMILIES:
            timed = n == cs.N and (fam, nu) in DF_TIMED
            for label, ys in (("K(x, x)", xs), ("K(x, x')", xc)):
                ms = same_arithmetic(
                    "gram_df", f"{label} {n}x{n} d={d} {fam} {nu}",
                    lambda ys=ys: gram_df_scaled(xs, ys, 1.3, fam, nu),
                    base, args.reps, timed)
                if timed:
                    record[f"gram_df {label} {fam} {nu}"] = ms
        del xs, xc

    x = coords(cs.N, cs.D)
    for fam, nu in cs.FAMILIES:
        record[f"gram_{fam}"] = same_arithmetic(
            "gram", f"{cs.N}x{cs.N} d={cs.D} {fam}",
            lambda: gram_scaled(x, x, 1.0, fam, nu), base, args.reps, True)
    xu = x * cs.GAMMA
    record["gram_l1"] = same_arithmetic(
        "gram_l1", f"{cs.N}x{cs.N} d={cs.D}",
        lambda: gram_l1(xu, xu, inv_g2, 1.0), base, args.reps, True)
    del xu
    x = coords(cs.LAZY_BIG_N, cs.D)
    V = torch.as_tensor(rng.standard_normal((cs.LAZY_BIG_N, cs.MATMAT_R)),
                        dtype=torch.float32, device=dev)
    record["gram_matmat"] = same_arithmetic(
        "gram_matmat", f"{cs.LAZY_BIG_N} d={cs.D} r={cs.MATMAT_R} se",
        lambda: gram_matmat_scaled(x, x, V, 1.0, "se"), base, args.reps, True)
    del x, V

    for mm, k in (cs.SYRK_PROBE, cs.SYRK_TAIL):
        W = torch.as_tensor(rng.standard_normal((mm, k)) / np.sqrt(k),
                            dtype=torch.float32, device=dev)
        T = torch.as_tensor(rng.standard_normal((mm, mm)),
                            dtype=torch.float32, device=dev)

        def base_fn(C=T, W=W):
            with using(base):
                return syrk_update_lower_(C, W)

        got = syrk_update_lower_(T.clone(), W)
        want = base_fn(T.clone())
        rel = float(((got - want).abs_().tril_() / (W.abs() @ W.abs().T)).max())
        ms = in_turns(base_fn, lambda: syrk_update_lower_(T, W), args.reps)
        print(f"  syrk_lower m={mm} k={k}: max |Δ| / (|W||W|ᵀ) against the "
              f"base tree's {rel!r} (bar {cs.syrk_rtol(k)!r}); base {ms[0]!r} "
              f"ms, this tree {ms[1]!r} ms")
        assert rel <= cs.syrk_rtol(k), rel
        record[f"syrk_lower_{mm}"] = ms
        if (mm, k) == cs.SYRK_PROBE:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                C = torch.empty_like(T)
                t = cs.cuda_ms(lambda: torch.mm(W, W.T, out=C), args.reps)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            rate = 2 * mm * mm * k / t / 1e9
            print(f"  yardstick: cuBLAS one-pass TF32 W·Wᵀ, m={mm} k={k}: "
                  f"{t!r} ms, {rate!r} TFLOP/s")
            record["cublas_tf32_mm"] = {"ms": t, "tflops": rate}
            del C
        del W, T
    Z = torch.empty((cs.N, cs.N), dtype=torch.float32, device=dev)
    t = cs.cuda_ms(lambda: Z.fill_(1.0), args.reps)
    print(f"  yardstick: fill_ of a {cs.N}² f32 tensor: {t!r} ms, "
          f"{Z.numel() * 4 / t / 1e6!r} GB/s")
    record["fill_ms"] = t
    del Z
    print(cs.card_line())
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
