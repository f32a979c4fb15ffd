#!/usr/bin/env python3
"""The float32 port against the float64 port on chip_smoke.py phase 19's
models at the phase's sizes: the gaps that phase 19 holds.

    python3 tools/phase19_gap.py [--device cpu|cuda] [--only NAME ...]

NAME is one of mkl, sgcp, tmg, ep, mixtures, trace_convex, likelihoods
(default: all). Each prints the record of chip_smoke.py's `<NAME>_run`:
19.1 the MultipleKernelLearner's α and mean, the group-lasso MKL's and
PrimalMKL's means and weights; 19.2 the SGCP's integrated rate against the
truth and float64, its exact and linear-response bands; 19.3 the
truncated-normal means of the exact-HMC samples; 19.4 EP against the
conjugate posterior, the mixtures on the same draws, TraceFeatures and
ConvexRKHS, and each likelihood's objective, gradient and √V. The
GammaContProcess of 19.4 is the exact GP of phase 3 and is not rerun.
About 20 minutes on the CPU, most of it 19.1 and ConvexRKHS.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

RUNS = {"mkl": lambda dev: cs.mkl_run(dev)[0], "sgcp": cs.sgcp_run,
        "tmg": cs.tmg_run, "ep": cs.ep_run, "mixtures": cs.mixtures_run,
        "trace_convex": cs.trace_convex_run,
        "likelihoods": cs.likelihood_run}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--only", nargs="*", choices=sorted(RUNS))
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    for name in args.only or RUNS:
        t0 = time.perf_counter()
        rec = RUNS[name](dev)
        print(name, json.dumps(rec), f"({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
