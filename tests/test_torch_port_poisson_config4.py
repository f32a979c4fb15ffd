"""The Poisson point-process slice as a whole: benchmarks/run_all.py config
4 (d = 2, three levels, 16 leaf sets, SE γ = 0.4, 8 × 8 triangle basis,
B = 4, s = 1e-3, map_max_iter = 1000, every leaf sensed for dt = 20) on
the CPU, with data drawn by the port's `PoissonPointProcess` from a seeded
generator; and the basis selector.

The float64 port against stpy_tpu in x64 on the same points: the fitted
totals within 5e-3 (the L-BFGS runs to its cap; its iterates part in the
last digits). The f32 port against the float64 port on the same points:
the totals within 5e-3 (tests/test_point_processes.py:482-541's bar for
the JAX package), the f32 bounds of `ucb_lcb_actions` on the level-2 sets
within 1e-3 of the float64 model's on the same fitted rate, and
lcb ≤ map ≤ ucb. The fitted total lies within run_all.py's 10 % of the
process's true total.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.domains import HierarchicalBorelSets as JaxHier
from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.point_processes import PoissonPointProcess as JaxProcess
from stpy_tpu.point_processes import PoissonRateEstimator as JaxPRE
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.domains import HierarchicalBorelSets as TorchHier
from stpy_tpu_torch.embeddings import (
    BernsteinEmbedding, BernsteinSplinesEmbedding, BernsteinSplinesOverlapping,
    FaberSchauderEmbedding, PositiveNystromEmbeddingBump, TriangleEmbedding,
)
from stpy_tpu_torch.point_processes import PoissonPointProcess as TorchProcess
from stpy_tpu_torch.point_processes import PoissonRateEstimator as TorchPRE

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

TOTAL_RTOL, BOUND_RTOL, TRUE_RTOL = 5e-3, 1e-3, 0.10
CONFIG4 = dict(d=2, m=8, B=4.0, s=1e-3, map_max_iter=1000)


def torch_rate(x, dt=1.0):
    return (2.5 * torch.exp(-torch.sum(x**2, dim=1, keepdim=True) * 2)
            + 0.3) * dt


def jax_rate(x, dt=1.0):
    return (2.5 * jnp.exp(-jnp.sum(x**2, axis=1, keepdims=True) * 2)
            + 0.3) * dt


def port_model(dtype, levels=3):
    F = dict(device="cpu", dtype=dtype)
    h = TorchHier(2, [[-1.0, 1.0], [-1.0, 1.0]], levels=levels, **F)
    k = TorchKernel(kernel_name="squared_exponential", gamma=0.4, d=2, **F)
    p = TorchProcess(d=2, B=3.0, rate=torch_rate)
    return h, p, TorchPRE(p, h, kernel_object=k, **CONFIG4, **F)


@pytest.fixture(scope="module")
def config4():
    h32, p, e32 = port_model(torch.float32)
    g = torch.Generator().manual_seed(0)
    data = [(S, p.sample_discretized(g, S, 20.0, n=16), 20.0)
            for S in h32.get_sets_level(3)]
    points = [None if o is None else o.numpy() for _, o, _ in data]
    e32.load_data(data)
    e32.fit_gp()
    h64, _, e64 = port_model(torch.float64)
    e64.load_data([(S, o, 20.0) for S, o in zip(h64.get_sets_level(3), points)])
    e64.fit_gp()
    return h32, e32, h64, e64, points, p


def test_config4_totals_match_float64_jax_and_the_truth(config4):
    h32, e32, h64, e64, points, p = config4
    assert sum(len(x) for x in points if x is not None) > 50
    jh = JaxHier(2, [[-1.0, 1.0], [-1.0, 1.0]], levels=3)
    je = JaxPRE(JaxProcess(d=2, B=3.0, rate=jax_rate), jh,
                kernel_object=JaxKernel(kernel_name="squared_exponential",
                                        gamma=0.4, d=2), **CONFIG4)
    je.load_data([(S, None if o is None else jnp.asarray(o, jnp.float64),
                   20.0) for S, o in zip(jh.get_sets_level(3), points)])
    je.fit_gp()
    t_jax = float(je.mean_set(jh.top_node)[0])
    t64 = float(e64.mean_set(h64.top_node)[0])
    t32 = float(e32.mean_set(h32.top_node)[0])
    assert abs(t64 - t_jax) <= TOTAL_RTOL * t_jax, (t64, t_jax)
    assert abs(t32 - t64) <= TOTAL_RTOL * t64, (t32, t64)
    true = p.rate_volume(h32.top_node, dt=1.0)
    assert abs(t32 - true) <= TRUE_RTOL * true, (t32, true)
    assert e32.rate.dtype == torch.float32 and e32.rate.shape == (64,)


def test_config4_f32_bounds_match_float64_on_the_same_rate(config4):
    h32, e32, h64, e64, *_ = config4
    rate64 = e64.rate
    e64.rate = e32.rate.double()
    try:
        m32, u32, l32 = e32.ucb_lcb_actions(h32.get_sets_level(2))
        m64, u64, l64 = e64.ucb_lcb_actions(h64.get_sets_level(2))
    finally:
        e64.rate = rate64
    for a, b in ((m32, m64), (u32, u64), (l32, l64)):
        assert float(((a.double() - b).abs() / b.abs()).max()) <= BOUND_RTOL
    assert bool((l32 <= m32 + 1e-5).all() and (m32 <= u32 + 1e-5).all())
    assert bool((l64 < u64).all())


BASES = [("triangle", TriangleEmbedding, {}), ("bernstein", BernsteinEmbedding, {}),
         ("splines", BernsteinSplinesEmbedding, {}),
         ("overlap-splines", BernsteinSplinesOverlapping, {}),
         ("faber", FaberSchauderEmbedding, {}),
         ("nystrom", PositiveNystromEmbeddingBump, dict(samples_nystrom=20))]


@pytest.mark.parametrize("basis,cls,kw", BASES, ids=[b[0] for b in BASES])
def test_basis_selector_builds_each_basis(basis, cls, kw):
    F = dict(device="cpu", dtype=torch.float64)
    h = TorchHier(1, [[-1.0, 1.0]], levels=2, **F)
    k = TorchKernel(kernel_name="squared_exponential", gamma=0.5, d=1, **F)
    e = TorchPRE(None, h, d=1, m=8, kernel_object=k, B=2.0, basis=basis,
                 **kw, **F)
    assert type(e.packing) is cls
    assert e.varphis.shape == (2, 8) and bool(torch.isfinite(e.varphis).all())
    custom = TorchPRE(None, h, d=1, m=8, basis="custom", embedding=e.packing,
                      **F)
    assert custom.packing is e.packing and bool((custom.varphis == 0).all())


def test_newton_on_a_singular_system_ends_as_jax_does_without_raising():
    """Config 5's 64 restarts include starts whose regularised Newton
    system is singular or NaN: jnp.linalg.solve returns inf/NaN there and
    the restart ends NaN (excluded from the best); the port's solve must
    do the same, where torch.linalg.solve raises on the card."""
    from stpy_tpu.opt.lbfgs import minimize_newton_small as jax_newton
    from stpy_tpu_torch.opt.lbfgs import minimize_newton_small

    def f(x):      # Hessian diag(−1e-6, 1): H + 1e-6·max|H|·I is singular
        return -0.5e-6 * x[0] ** 2 + 0.5 * x[1] ** 2 + x[0]

    rj = jax_newton(f, jnp.zeros(2), max_iter=5)
    rt = minimize_newton_small(f, torch.zeros(2, dtype=torch.float64),
                               max_iter=5)
    assert rt.iterations == int(rj.iterations)
    assert np.array_equal(rt.x.numpy(), np.asarray(rj.x), equal_nan=True)
