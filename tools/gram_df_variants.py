#!/usr/bin/env python3
"""Launch variants of the double-float Gram kernel on a cross Gram, on one
card.

    python3 tools/gram_df_variants.py [--reps N]

Builds tools/gram_df_variants.cu (nvcc, sm_90a; ptxas's register report
printed) and runs each variant on K(x, x') at bench.py's shape: x ~ U(-1,
1)^(16384 x 8), numpy seed 0, over γ = 1.1, x' a copy of x, Matérn-5/2. Each
is held bit for bit to the production `gram_df` on the same inputs and
timed by CUDA events in turns with it and with its "sq" stage (the same
bytes, little arithmetic), forward then back. Prints each time beside the
byte bound of `chip_smoke.gram_bounds`, the card's name and power limit,
then one JSON record. Exits non-zero without CUDA or where a variant's bits
differ.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from stpy_tpu_torch import _build  # noqa: E402
from stpy_tpu_torch.ops.gram_df import gram_df_scaled, scale_coords  # noqa: E402
from stpy_tpu_torch.ops.gram_df_stages import gram_df_stage  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
VARIANTS = {0: "64² tile, min 1 block/SM", 1: "64² tile, min 2",
            2: "64² tile, min 3", 3: "64² tile, min 4",
            4: "32² tile, min 4", 5: "32² tile, min 6", 6: "32² tile, min 8",
            7: "two-phase 64², min 2", 8: "two-phase 64², min 3"}


def build():
    out_dir = ROOT / "build" / "gram_df_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libgram_df_variants.so"
    run = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(SOURCE)], capture_output=True, text=True, timeout=600)
    print("\n".join(line for line in (run.stdout + run.stderr).splitlines()
                    if "entry function" in line or "registers" in line
                    or "error" in line))
    run.check_returncode()
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.gram_df_variant.argtypes = (i, p, p, p, p, i, i, i, ctypes.c_double, p)
    so.gram_df_variant.restype = i
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gram_df_variants: CUDA is not available", file=sys.stderr)
        return 1
    so = build()
    dev = torch.device("cuda")
    x, _, _ = cs.bench_data(dev)
    xs = scale_coords(x.double(), 1.1)
    xc = xs.clone()
    n, d = xs.shape

    def variant(v):
        hi = torch.empty((n, n), dtype=torch.float32, device=dev)
        lo = torch.empty_like(hi)
        err = so.gram_df_variant(v, xs.data_ptr(), xc.data_ptr(),
                                 hi.data_ptr(), lo.data_ptr(), n, n, d, 1.0,
                                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, (v, err)
        return hi, lo

    ph, pl = gram_df_scaled(xs, xc, 1.0, "matern", 2.5)
    runs = {"gram_df": lambda: gram_df_scaled(xs, xc, 1.0, "matern", 2.5),
            "stage sq": lambda: gram_df_stage(xs, xc, 1.0, family="matern",
                                              nu=2.5, stage="sq")}
    for v, what in VARIANTS.items():
        h, l = variant(v)
        equal = torch.equal(h, ph) and torch.equal(l, pl)
        print(f"  variant {v} ({what}): bitwise equal to gram_df: {equal}")
        assert equal, v
        del h, l
        runs[f"variant {v}"] = lambda v=v: variant(v)
    del ph, pl
    ms = dict.fromkeys(runs, 0.0)
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            ms[key] += cs.cuda_ms(runs[key], args.reps) / 2
    bound = cs.gram_bounds(n, n, d)["gram_df"][0]
    for key, t in ms.items():
        print(f"  {key}: {t!r} ms, {bound / t * 100:.1f} % of the "
              f"{bound!r} ms byte bound")
    print(cs.card_line())
    print(json.dumps({"bound_ms": bound, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
