#!/usr/bin/env python3
"""Why the exact evidence factors in float64 on a float32 Gram.

    python3 tools/evidence_dtype.py [--device cpu|cuda]

On `benchmarks/run_all.py` config 1's data (n = 1024, seed 0) it prints:
the fitted γ of `optimize_params(type="bandwidth", restarts=8,
maxiter=40)` for a float32 model with the evidence factored in float64
(`models.estimator.negative_log_evidence` on the promoted Gram, the port's
choice) and in float32 (the JAX package's arithmetic on a TPU, here a
subclass that factors the f32 Gram as it is), each against the float64 model's fit
on the CPU; then, at nine γ around that optimum, the evidence and its
gradient in log γ on the float32 Gram (factored in float64 and in float32)
minus the float64 model's, beside the float64 gradient. The float32 model
lives on `--device` (its Gram is the hand kernel on the card).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from stpy_tpu_torch import GaussianProcess  # noqa: E402
from stpy_tpu_torch.models.estimator import negative_log_evidence  # noqa: E402

FIT = dict(type="bandwidth", restarts=8, maxiter=40)


def config1_data():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1024, 1))
    return x, np.sin(4 * x) + 0.05 * rng.standard_normal((1024, 1))


class F32EvidenceGP(GaussianProcess):
    """The evidence factored in the model's dtype, not promoted."""

    def log_marginal_params(self, kernel, params_dict, s, weight=1.0):
        K = kernel.eval_params(params_dict, self.x, self.x)
        return negative_log_evidence(K, self.y, s, weight)


def model(x, y, device, dtype, cls=GaussianProcess):
    gp = cls(gamma=1.0, s=0.05, d=1, device=device, dtype=dtype)
    gp.fit_gp(x, y)
    return gp


def value_and_grad(gp, gamma):
    r = torch.tensor(np.log(gamma), dtype=torch.float64, device=gp.device)
    r.requires_grad_()
    f = gp.log_marginal_params(gp.kernel_object,
                               {"0": {"gamma": torch.exp(r)}}, gp.s)
    (g,) = torch.autograd.grad(f, r)
    return float(f.detach()), float(g)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    device = torch.device(ap.parse_args(argv).device)
    x, y = config1_data()
    ref = model(x, y, "cpu", torch.float64)
    ref.optimize_params(**FIT)
    g64 = float(ref.kernel_object.params_dict["0"]["gamma"])
    print(f"float64 model on the CPU: γ {g64!r}")
    kinds = ((torch.float64, GaussianProcess), (torch.float32, F32EvidenceGP))
    for dt, cls in kinds:
        gp = model(x, y, device, torch.float32, cls)
        gp.optimize_params(**FIT)
        g = float(gp.kernel_object.params_dict["0"]["gamma"])
        print(f"float32 model on {device.type}, evidence factored in "
              f"{dt}: γ {g!r} (rel {abs(g - g64) / g64!r}), iterations "
              f"{gp.hyperopt_metrics['iterations'].tolist()}")
    gps = [model(x, y, device, torch.float32, cls) for _, cls in kinds]
    print("γ, then per factorization dtype (float64, float32): "
          "Δevidence, Δgradient against the float64 model; the float64 "
          "gradient")
    for gamma in g64 * np.linspace(0.998, 1.002, 9):
        want = value_and_grad(ref, gamma)
        row = []
        for gp in gps:
            got = value_and_grad(gp, gamma)
            row += [got[0] - want[0], got[1] - want[1]]
        print(f"  {gamma!r}: " + ", ".join(f"{v!r}" for v in row)
              + f"; {want[1]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
