"""The readings that the limits of `correct` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 2] [--out FILE]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load (at least as many calls as a run holds to the reference),
and the same comparison as a run's (`harness.compare`): the program's
numbers against the float64 reference. On the control seeds, also the
control: the reference computed in the precision that
``limits/<cell>.json`` names, on the same calls' inputs. One JSON line per
seed on standard output (and appended to FILE).
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from portbench import harness

    bench = harness.Bench()
    control = bench.limits(args.workload)["control"]
    ctrl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.setup(bench, args.workload, seed, "cuda")
        run = harness.measure(cell, args.seconds, t0, False,
                              min_calls=harness.COMPARE_CALLS)
        nfailed = sum(harness.failed(cell, c) for c in run.calls)
        harness.free_program(cell)
        t1 = time.perf_counter()
        prog, ctrl, chosen = harness.compare(
            cell, run.calls, control if seed in ctrl_seeds else None)
        line = {"workload": args.workload, "seed": seed,
                "calls": len(run.calls), "call_s": run.window_s / len(run.calls),
                "setup_s": run.setup_s, "compare_s": time.perf_counter() - t1,
                "failed": nfailed, "picks": chosen, "program": prog,
                "control": ctrl, "control_precision": control,
                "status": [{k: v for k, v in c.status.items()
                            if k in ("cg_iterations", "cg_residual",
                                     "jitter_used", "cholesky_ok",
                                     "converged")}
                           for c in run.calls[:8]],
                "warnings": run.warnings[:2]}
        text = json.dumps(harness.json_safe(line))
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del cell, run
    return 0


if __name__ == "__main__":
    sys.exit(main())
