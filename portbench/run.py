"""Run one cell of stpy_tpu_torch's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (BENCHMARK.json). With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics and a
breakdown. The numbers that decide `correct` are printed beside their
limits as the last lines on standard error and under the line's last key.
It exits 1 and prints no result without the cards, and 3 where JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))
# the process's threads on a fixed set of cores: the CG cells' loops wait
# on the host once an iteration, and a thread that moves between cores
# wakes later
CORES = 4

# top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "stpy_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.Bench()
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    allowed = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, allowed[:CORES])
    torch.set_num_threads(min(CORES, len(allowed)))
    result = harness.json_safe(harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda", T_START))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():  # the last lines on stderr
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, default=str, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
