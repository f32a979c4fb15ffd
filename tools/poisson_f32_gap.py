#!/usr/bin/env python3
"""The float32 port against the float64 port on the Poisson point-process
slice: the gaps that chip_smoke.py phase 17 holds, and why its
user-size model takes the double-float grid Gram and SE γ = 0.1.

    python3 tools/poisson_f32_gap.py [--device cpu|cuda] [--bounds]

1. benchmarks/run_all.py config 4 as chip_smoke.py 17.1-17.2 runs it
   (16 leaf sets, 64 triangle functions, data from the port's process,
   generator seeded 0): the f32 fitted total against the float64 model's
   on the same rounds, and `ucb_lcb_actions` over the 16 leaves on the
   same rate, each bound's error over max(|bound64|, map64) and plain.
2. chip_smoke.py 17.3's model (1024 leaf sets, m = 32, SE γ = 0.1,
   dt = 200): Γ^{1/2}'s condition number and the f32 total's gap to
   float64, once with the basis built on the double-float grid Gram (the
   port) and once on the f32 Gram (the JAX package's default dtype);
   with --bounds also its bounds over the 64 sets of level 4 (about 3
   minutes on the CPU).
3. Config 4's γ = 0.4 on a finer basis (64 leaf sets, m = 16, dt = 200):
   the float64 MAP total against the truth after 1000 and 5000 L-BFGS
   iterations.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from stpy_tpu_torch.embeddings import positive  # noqa: E402


def pair(dev, levels, m, gamma, dt):
    """f32 and float64 models (chip_smoke.poisson_model) on the same
    rounds, both fitted: (h, est, h64, est64, process)."""
    h, p, est = cs.poisson_model(dev, torch.float32, levels, m, gamma)
    data = cs.poisson_data(p, h.get_sets_level(levels), dt, seed=0)
    est.load_data(data)
    est.fit_gp()
    h64, _, est64 = cs.poisson_model(dev, torch.float64, levels, m, gamma)
    est64.load_data([(S, None if o is None else o.double(), dt)
                     for S, (_, o, _) in zip(h64.get_sets_level(levels),
                                             data)])
    est64.fit_gp()
    return h, est, h64, est64, p


def total_gap(h, est, h64, est64):
    t32 = float(est.mean_set(h.top_node)[0])
    t64 = float(est64.mean_set(h64.top_node)[0])
    return t32, t64, abs(t32 - t64) / abs(t64)


def bound_errors(h, est, h64, est64, level):
    """Each bound's max error over max(|bound64|, map64), and plain."""
    rate64 = est64.rate
    est64.rate = est.rate.double()
    b32 = est.ucb_lcb_actions(h.get_sets_level(level))
    b64 = est64.ucb_lcb_actions(h64.get_sets_level(level))
    est64.rate = rate64
    m64 = b64[0]
    scaled = [float(((a.double() - b).abs()
                     / torch.maximum(b.abs(), m64.abs())).max())
              for a, b in zip(b32, b64)]
    plain = [float(((a.double() - b).abs() / b.abs()).max())
             for a, b in zip(b32, b64)]
    return scaled, plain


def f32_gram(self):
    """The grid Gram as the JAX package feeds the chain: the kernel's own
    (f32) Gram, promoted."""
    return self.kernel_object.gram(self._grid_nodes()).double()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--bounds", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.cuda.synchronize = lambda *a, **k: None

    h, est, h64, est64, _ = pair(dev, cs.CONFIG4_LEVELS, cs.CONFIG4_M,
                                 cs.POISSON_GAMMA, cs.CONFIG4_DT)
    t32, t64, gap = total_gap(h, est, h64, est64)
    scaled, plain = bound_errors(h, est, h64, est64, cs.CONFIG4_LEVELS)
    print(f"config 4: f32 total {t32!r}, float64 {t64!r}, rel {gap!r}; "
          f"bounds (map, ucb, lcb) over max(|b64|, map64) {scaled}, plain "
          f"{plain}")

    orig = positive.PositiveEmbedding._grid_gram64
    for label, gram in (("double-float grid Gram", orig),
                        ("f32 grid Gram", f32_gram)):
        positive.PositiveEmbedding._grid_gram64 = gram
        try:
            h, est, h64, est64, p = pair(dev, cs.USER_LEVELS, cs.USER_M,
                                         cs.USER_GAMMA, cs.USER_DT)
        finally:
            positive.PositiveEmbedding._grid_gram64 = orig
        cond = float(torch.linalg.cond(est.cov().double()))
        t32, t64, gap = total_gap(h, est, h64, est64)
        print(f"1024 functions, SE {cs.USER_GAMMA}, {label}: cond(Γ^½) "
              f"{cond!r}, f32 total {t32!r}, float64 {t64!r}, rel {gap!r}, "
              f"truth {p.rate_volume(h.top_node)!r}")
        if args.bounds and gram is orig:
            scaled, plain = bound_errors(h, est, h64, est64,
                                         cs.USER_ACTION_LEVEL)
            print(f"  bounds over level {cs.USER_ACTION_LEVEL}: over "
                  f"max(|b64|, map64) {scaled}, plain {plain}")

    for iters in (1000, 5000):
        cs.POISSON_EST["map_max_iter"] = iters
        h, p, est = cs.poisson_model(dev, torch.float64, 4, 16,
                                     cs.POISSON_GAMMA)
        est.load_data(cs.poisson_data(p, h.get_sets_level(4), cs.USER_DT, 0))
        est.fit_gp()
        total, true = float(est.mean_set(h.top_node)[0]), p.rate_volume(
            h.top_node)
        print(f"SE {cs.POISSON_GAMMA}, 64 leaf sets, m = 16, float64, "
              f"{iters} iterations: total {total!r} = {total / true!r} of "
              f"the truth {true!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
