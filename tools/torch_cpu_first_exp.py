#!/usr/bin/env python3
"""Count how often the first multi-threaded `torch.exp` of a fresh process
returns inaccurate entries on this CPU, float32 and float64.

    python3 tools/torch_cpu_first_exp.py [--procs 60] [--parallel 6]
                                         [--dtype float32 float64] [--one-thread]

Starts `--procs` fresh Python processes, `--parallel` at a time (as a
six-worker pytest run shares the cores), each of which calls `torch.exp`
once on a 300 x 517 tensor with torch's default intra-op threads (or one
thread with --one-thread), then once more, and compares both outputs with
numpy's exp of the same values. Prints, per dtype, how many first and
second calls were off by more than 1e-6 (float32) or 1e-14 (float64), and
the largest error seen. Runs on the CPU only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = r"""
import json, sys
import numpy as np
import torch
if sys.argv[2] == "1":
    torch.set_num_threads(1)
dt = {"float32": torch.float32, "float64": torch.float64}[sys.argv[1]]
a = np.random.default_rng(1).uniform(-3, 0, (300, 517))
t = torch.as_tensor(a, dtype=dt)
first, second = torch.exp(t), torch.exp(t)
ref = np.exp(t.double().numpy())
print(json.dumps([float(np.abs(o.double().numpy() - ref).max())
                  for o in (first, second)]))
"""
TOL = {"float32": 1e-6, "float64": 1e-14}


def run(dtype, one_thread):
    out = subprocess.run(
        [sys.executable, "-c", CHILD, dtype, "1" if one_thread else "0"],
        capture_output=True, text=True, check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=60)
    p.add_argument("--parallel", type=int, default=6)
    p.add_argument("--dtype", nargs="+", default=["float32", "float64"],
                   choices=sorted(TOL))
    p.add_argument("--one-thread", action="store_true")
    args = p.parse_args(argv)
    for dtype in args.dtype:
        with ThreadPoolExecutor(args.parallel) as pool:
            errs = list(pool.map(lambda _: run(dtype, args.one_thread),
                                 range(args.procs)))
        bad = [sum(e[k] > TOL[dtype] for e in errs) for k in (0, 1)]
        worst = max(max(e) for e in errs)
        print(f"{dtype}: first call off in {bad[0]} of {args.procs} fresh "
              f"processes, second call in {bad[1]}; largest error {worst!r}"
              f" ({'one thread' if args.one_thread else 'default threads'},"
              f" {args.parallel} at a time)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
