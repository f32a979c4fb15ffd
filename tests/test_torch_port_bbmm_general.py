"""Port parity: bbmm's general tier in stpy_tpu_torch — the row-chunked
products differentiable in a per-call params dict
(`make_chunked_matvec` / `make_chunked_matmat`), the matrix-free evidence
of any kernel (`evidence_value_and_grad_general`), its fit
(`fit_evidence_general`) and `IterativeGP.optimize_params` on it — against
stpy_tpu/parallel on the CPU, on a product kernel SE(0.7)·Matérn-5/2(1.2)
(tests/test_lazy_algebra.py:315-380) and on a Laplace kernel.

The same numpy data goes through both packages, JAX in x64 and torch in
float64, where every port wrapper runs its plain PyTorch version; both
are fed the same Rademacher probes (`jax.random.rademacher` / `split` and
`torch.randint` replaced for the test, the JAX package's compiled general
evidence cleared before and after). Tolerances: the chunked products
within 1e-12 of the dense Gram's and their gradient in the params within
1e-12 of dense autograd's; the evidence gradients and the fits within
1e-7 relative of the JAX package's (CG at tol 1e-12: the same solutions,
not the same iterates; 1e-13 measured), its SLQ value within 1e-6; and
against dense float64 autograd of the Cholesky NLL the JAX package's own
bar, 6 % on each Hutchinson gradient at 500 probes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.parallel import bbmm as jbb
from stpy_tpu.parallel import iterative as jit_
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.parallel import bbmm as tbb
from stpy_tpu_torch.parallel import iterative as tit
from stpy_tpu_torch.parallel.lazy_kernel import (
    make_chunked_matmat, make_chunked_matvec,
)

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

TIGHT = dict(cg_tol=1e-12, cg_maxiter=800, probe_tol=1e-12, probe_maxiter=800)
GRAD_RTOL, NLL_RTOL = 1e-7, 1e-6
T = dict(device="cpu", dtype=torch.float64)
KERNELS = {
    "product": lambda cls, **kw: (
        cls(kernel_name="squared_exponential", gamma=0.7, d=2, **kw)
        * cls(kernel_name="matern", gamma=1.2, nu=2.5, d=2, **kw)),
    "laplace": lambda cls, **kw: cls(kernel_name="laplace", gamma=0.8,
                                     kappa=1.2, d=2, **kw),
}


def data(n=90, seed=37):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    return x, np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(n)


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture
def same_probes(monkeypatch):
    """`feed(Z)`: both packages draw their Rademacher block as Z."""
    jbb._evg_general_core.cache_clear()

    def feed(Z):
        Zj = jnp.asarray(Z)
        monkeypatch.setattr(jax.random, "split",
                            lambda key, num=2: jnp.arange(num))
        monkeypatch.setattr(
            jax.random, "rademacher",
            lambda k, shape, dtype=None: Zj if len(shape) == 2 else Zj[:, k])
        bits = torch.as_tensor((Z + 1) / 2, dtype=torch.int64)
        monkeypatch.setattr(
            torch, "randint",
            lambda lo, hi, shape, generator=None, device=None, dtype=None:
            bits)

    yield feed
    jbb._evg_general_core.cache_clear()


def signs(n, probes, seed=7):
    return np.random.default_rng(seed).choice([-1.0, 1.0], (n, probes))


@pytest.mark.parametrize("case", list(KERNELS))
def test_chunked_products_take_the_params_per_call(case):
    x, _ = data()
    k = KERNELS[case](TorchKernel, **T)
    xt = torch.as_tensor(x)
    V = torch.as_tensor(np.random.default_rng(1).standard_normal((90, 4)))
    pd = {"0": {"gamma": torch.tensor(0.5, dtype=torch.float64)}}
    K = k.eval_params(pd, xt, xt)
    mm = make_chunked_matmat(k, xt, noise=0.3, chunk=32)
    mv = make_chunked_matvec(k, xt, noise=0.3, chunk=32)
    assert rel(mm(V, pd), K @ V + 0.09 * V) <= 1e-12
    assert rel(mv(V[:, 0], pd), K @ V[:, 0] + 0.09 * V[:, 0]) <= 1e-12
    # without a per-call dict: the kernel's own params
    K0 = k.eval_params(k.params_dict, xt, xt)
    assert rel(mm(V), K0 @ V + 0.09 * V) <= 1e-12


@pytest.mark.parametrize("case", list(KERNELS))
def test_chunked_matmat_gradient_matches_dense_autograd(case):
    x, _ = data()
    k = KERNELS[case](TorchKernel, **T)
    xt = torch.as_tensor(x)
    rng = np.random.default_rng(2)
    V, W = (torch.as_tensor(rng.standard_normal((90, 3))) for _ in range(2))

    def leaves():
        return {ak: {pk: v.detach().clone().requires_grad_()
                     for pk, v in sub.items()}
                for ak, sub in k.params_dict.items()}

    chunked, dense = leaves(), leaves()
    mm = make_chunked_matmat(k, xt, chunk=32)
    flat_c = [v for s in chunked.values() for v in s.values()]
    flat_d = [v for s in dense.values() for v in s.values()]
    g_c = torch.autograd.grad(torch.sum(W * mm(V, chunked)), flat_c)
    g_d = torch.autograd.grad(
        torch.sum(W * (k.eval_params(dense, xt, xt) @ V)), flat_d)
    for a, b in zip(g_c, g_d):
        assert rel(a, b) <= 1e-12


@pytest.mark.parametrize("case", list(KERNELS))
def test_general_evidence_matches_jax_on_the_same_probes(case, same_probes):
    x, y = data()
    same_probes(signs(90, 8))
    kw = dict(chunk=32, probes=8, lanczos_iters=20, **TIGHT)
    jn, jg = jbb.evidence_value_and_grad_general(
        KERNELS[case](JaxKernel), jnp.asarray(x), jnp.asarray(y), noise=0.35,
        **kw)
    tn, tg = tbb.evidence_value_and_grad_general(
        KERNELS[case](TorchKernel, **T), torch.as_tensor(x),
        torch.as_tensor(y), noise=0.35, **kw)
    assert rel(tn, jn) <= NLL_RTOL
    assert rel(tg["noise"], jg["noise"]) <= GRAD_RTOL
    for ak, sub in jg["params"].items():
        for pk, want in sub.items():
            assert rel(tg["params"][ak][pk], want) <= GRAD_RTOL, (ak, pk)


def test_general_evidence_gradient_against_dense_float64():
    # tests/test_lazy_algebra.py's test at n = 140, 500 probes, 6 % bar
    rng = np.random.default_rng(37)
    n = 140
    x = rng.uniform(-1, 1, (n, 2))
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    k = KERNELS["product"](TorchKernel, **T)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    g0, g1, s = (torch.tensor(v, dtype=torch.float64, requires_grad=True)
                 for v in (0.7, 1.2, 0.35))
    A = k.eval_params({"0": {"gamma": g0}, "1": {"gamma": g1}}, xt, xt) \
        + s * s * torch.eye(n, dtype=torch.float64)
    L = torch.linalg.cholesky(A)
    nll = 0.5 * yt @ torch.cholesky_solve(yt[:, None], L)[:, 0] \
        + torch.sum(torch.log(torch.diagonal(L)))
    ref = torch.autograd.grad(nll, (g0, g1, s))
    _, grads = tbb.evidence_value_and_grad_general(
        k, xt, yt, noise=0.35, chunk=64, probes=500, cg_tol=1e-10,
        cg_maxiter=600, probe_tol=1e-8, probe_maxiter=600,
        compute_value=False)
    est = (grads["params"]["0"]["gamma"], grads["params"]["1"]["gamma"],
           grads["noise"])
    for e, r in zip(est, ref):
        assert abs(float(e) - float(r)) / max(abs(float(r)), 1.0) < 0.06


def test_preconditioned_general_evidence_has_the_same_gradient(same_probes):
    # a rank-24 preconditioner changes the CG iterates, not the solutions:
    # on the same probes the gradients agree to the solves' tolerance
    x, y = data(120, seed=4)
    same_probes(signs(120, 6))
    k = KERNELS["product"](TorchKernel, **T)
    kw = dict(chunk=64, probes=6, compute_value=False, **TIGHT)
    args = (k, torch.as_tensor(x), torch.as_tensor(y))
    _, plain = tbb.evidence_value_and_grad_general(*args, noise=0.2, **kw)
    _, pre = tbb.evidence_value_and_grad_general(*args, noise=0.2,
                                                 precond_rank=24, **kw)
    assert rel(pre["noise"], plain["noise"]) <= 1e-6
    for ak, sub in plain["params"].items():
        for pk, want in sub.items():
            assert rel(pre["params"][ak][pk], want) <= 1e-6


@pytest.mark.parametrize("case", list(KERNELS))
def test_fit_evidence_general_matches_jax(case, same_probes):
    x, y = data(80, seed=6)
    same_probes(signs(80, 8))
    kw = dict(optimize=("gamma", "kappa", "noise"), steps=3, lr=0.15,
              probes=8, tol=0.0, chunk=32, **TIGHT)
    jout = jbb.fit_evidence_general(KERNELS[case](JaxKernel), jnp.asarray(x),
                                    jnp.asarray(y), 0.3, **kw)
    tout = tbb.fit_evidence_general(KERNELS[case](TorchKernel, **T),
                                    torch.as_tensor(x), torch.as_tensor(y),
                                    0.3, **kw)
    assert tout["steps_run"] == jout["steps_run"] == 3
    assert rel(tout["noise"], jout["noise"]) <= GRAD_RTOL
    assert rel(tout["history"], jout["history"]) <= 1e-6
    for ak, sub in jout["params"].items():
        for pk, want in sub.items():
            got = tout["params"][ak][pk]
            assert tuple(got.shape) == np.shape(want)
            assert rel(got, want) <= GRAD_RTOL, (ak, pk)
