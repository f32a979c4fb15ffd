"""The departure of stpy_tpu_torch/models/mixtures.py for f32 models, on
the CPU: the mixtures factor each draw's moments in float64 on float64
(double-float) Grams. At the sizes of chip_smoke.py phase 19.4 the f32
Grams' moments are indefinite past the jitter ladder (ROADMAP Queue 3).
"""

import numpy as np
import torch

from stpy_tpu_torch.models import GaussianProcess as TGP
from stpy_tpu_torch.models import mixtures as tmx

from torch_threads import one_torch_thread  # noqa: F401


def test_f32_mixture_factors_float64_moments():
    """Departure: at 256 test points among 2048 data points in 2-D the
    posterior covariance of an f32 mixture is indefinite past the jitter
    ladder when formed from its f32 Grams (the JAX package's f32 draws
    there are NaN); the port forms it in float64 from the double-float
    Grams, and its f32 draws equal the float64 mixture's on the same
    draws within 1e-5."""
    from stpy_tpu_torch.linalg import safe_cholesky, tri_solve

    rng = np.random.default_rng(19)
    x = rng.uniform(-1, 1, (2048, 2))
    y = np.sin(3 * x[:, :1]) * np.cos(2 * x[:, 1:]) \
        + 0.1 * rng.standard_normal((2048, 1))
    xt = rng.uniform(-1, 1, (256, 2))
    out = {}
    for dt in (torch.float32, torch.float64):
        procs = [TGP(gamma=g, s=0.1, d=2, device="cpu", dtype=dt)
                 for g in (0.3, 0.6, 1.2)]
        mix = tmx.CategoricalMixture(
            procs, generator=torch.Generator().manual_seed(19), device="cpu",
            dtype=dt)
        mix.fit_gp(x, y)
        out[dt] = mix.sample(xt, size=4)
    assert out[torch.float32].dtype == torch.float32
    assert bool(torch.isfinite(out[torch.float32]).all())
    assert float((out[torch.float32].double()
                  - out[torch.float64]).abs().max()) < 1e-5
    # the same moments from the f32 Grams, as the JAX package forms them:
    # for the γ = 0.6 and 1.2 components the jitter ladder fails
    xf, xtf = (torch.tensor(a, dtype=torch.float32) for a in (x, xt))
    for g in (0.6, 1.2):
        k32 = TGP(gamma=g, s=0.1, d=2, device="cpu",
                  dtype=torch.float32).kernel_object
        K = k32.gram(xf) + 0.01 * torch.eye(2048)
        V = tri_solve(safe_cholesky(K).L, k32.cross(xtf, xf).T)
        assert not bool(safe_cholesky(k32.gram(xtf) - V.T @ V,
                                      jitter=1e-8).ok)
