#!/usr/bin/env python3
"""The float32 port against the float64 port on benchmarks/run_all.py's
configs 2 and 3 at full size: the gaps that chip_smoke.py phase 16 holds.

    python3 tools/feature_f32_gap.py [--device cpu|cuda]

Config 2 (:94-127): HermiteEmbedding(0.5, 512, 2) and KernelizedFeatures at
s = 0.05 on n = 512, mean_std at 1024 points. Printed: the f32 mean's max
error over max|μ64|, the f32 std's max relative error, V's condition
number (float64), and the jitter that `sample`'s ladder adds to the f32
V⁻¹ (over its mean diagonal).

Config 3 (:130-159): NystromFeatures at n = 50 000, m = 512,
approx="uniform", s = 0.05 on the additive Matérn-3/2(0.4) on x₀ +
SE(0.6) on x₁, mean_std on the first 2048 points; both models draw the
same landmarks (generators seeded 17). Printed: the f32 mean's max error
over max|μ64|, both train_mae_head, and the landmark eigenvalues above
the 1e-14 cut and, of those, under 1e-6·λmax, for the f32 Gram and the
float64 one.

Both models live on `--device`; the data, models and float64 atoms are
chip_smoke.py's (phase 16).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from stpy_tpu_torch import linalg  # noqa: E402
from stpy_tpu_torch.embeddings import NystromFeatures  # noqa: E402


def config2(dev):
    x, y, xt = cs.config2_data()
    out = {}
    for dt in (torch.float32, torch.float64):
        F = cs.feature_gp(dev, dt)
        F.fit_gp(x, y)
        out[dt] = (F, *(t.double() for t in F.mean_std(xt)))
    (F32, m32, s32), (F64, m64, s64) = out[torch.float32], out[torch.float64]
    ev = torch.linalg.eigvalsh(F64.V)
    res = linalg.safe_cholesky(F32.invV.clone())
    print(f"config 2: mean gap {float((m32 - m64).abs().max() / m64.abs().max())!r}"
          f", std gap {float(((s32 - s64).abs() / s64).max())!r}, cond(V) "
          f"{float(ev.max() / ev.min())!r}, ladder jitter on the f32 V⁻¹ "
          f"{float(res.jitter / F32.invV.diagonal().mean())!r} of its mean "
          f"diagonal")


def config3(dev):
    x, y = cs.config3_data()
    head = torch.tensor(y[:cs.CONFIG3_HEAD]).double()
    out = {}
    for dt in (torch.float32, torch.float64):
        nf = NystromFeatures(cs.config3_kernel(dev, dt), m=cs.CONFIG3_M,
                             approx="uniform", s=cs.CONFIG3_S)
        nf.fit_gp(x, y)
        mu = nf.mean_std(x[:cs.CONFIG3_HEAD])[0].double().cpu()
        out[dt] = (nf, mu, float((mu - head).abs().mean()))
    (n32, m32, a32), (n64, m64, a64) = out[torch.float32], out[torch.float64]
    assert torch.equal(n32.C, n64.C)
    print(f"config 3: mean gap {float((m32 - m64).abs().max() / m64.abs().max())!r}"
          f", train_mae_head f32 {a32!r} float64 {a64!r} (diff "
          f"{abs(a32 - a64)!r}); landmark eigenvalues above the cut and of "
          f"those under 1e-6·λmax: f32 Gram {cs.eig_counts(n32.eigs)}, "
          f"float64 Gram {cs.eig_counts(n64.eigs)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    dev = ap.parse_args().device
    config2(dev)
    config3(dev)


if __name__ == "__main__":
    main()
