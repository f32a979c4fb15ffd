"""Port parity: stpy_tpu_torch/models/mkl.py (`MultipleKernelLearner`,
`MKL`, `PrimalMKL`) against stpy_tpu/models/mkl.py on the CPU.

The same numpy data (seeded) go through both packages, JAX in x64 and
torch in float64. The learner's objective and its closed-form gradient in
α are held to the JAX objective and `jax.grad`'s within 1e-10 relative;
the fitted weights α (300 exponentiated-gradient steps) and the posterior
within 1e-6, on the JAX package's own cases (tests/test_mkl_and_misc.py):
its kernel-selection case here, its case with the sup regularizer in
tests/test_torch_port_mkl_sup.py. The gradient on the SE + Matérn-3/2 +
Laplace mix of the card's phase 19.1, and the posterior on a JAX state
carried by `convert.load_mkl_state` (within 1e-10), are in
tests/test_torch_port_mkl_grad.py; the feature-space MKLs in
tests/test_torch_port_mkl_group_lasso.py and
tests/test_torch_port_mkl_primal.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JK
from stpy_tpu.models import mkl as jm
from stpy_tpu.regularization import DirichletRegularizer as JDir
from stpy_tpu.regularization import SupRegularizer as JSup
from stpy_tpu_torch.convert import load_mkl_state
from stpy_tpu_torch.kernels import KernelFunction as TK
from stpy_tpu_torch.models import mkl as tm
from stpy_tpu_torch.regularization import DirichletRegularizer as TDir
from stpy_tpu_torch.regularization import SupRegularizer as TSup

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DET = 1e-10
ITER = 1e-6
TK64 = {"device": "cpu", "dtype": torch.float64}


def rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def kernels(case, K, kw):
    if case == "select":
        return [K(kernel_name="squared_exponential", gamma=2.0, d=1, **kw),
                K(kernel_name="squared_exponential", gamma=0.3, d=1, **kw)]
    if case == "sup":
        return [K(kernel_name="squared_exponential", gamma=0.5, d=1, **kw),
                K(kernel_name="linear", d=1, **kw)]
    return [K(kernel_name="squared_exponential", gamma=0.5, d=2, **kw),
            K(kernel_name="matern", nu=1.5, gamma=0.8, d=2, **kw),
            K(kernel_name="laplace", gamma=1.0, d=2, **kw)]


def data(case):
    if case == "select":
        rng = np.random.default_rng(0)
        x = rng.uniform(-1, 1, (60, 1))
        return x, np.sin(6 * x)
    if case == "sup":
        rng = np.random.default_rng(1)
        x = rng.uniform(-1, 1, (40, 1))
        return x, np.sin(3 * x)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (48, 2))
    return x, np.sin(3 * x[:, :1]) * np.cos(2 * x[:, 1:]) \
        + 0.1 * rng.standard_normal((48, 1))


def learners(case):
    kw = dict(lam=1.0, s=0.05)
    rj = rt = None
    if case == "sup":
        rj, rt = JSup(lam=0.1, d=2), TSup(lam=0.1, d=2)
    elif case == "three":
        kw = dict(lam=1.0, s=0.1)
        w = np.array([1.5, 1.2, 1.1])
        rj, rt = JDir(lam=0.05, w=jnp.asarray(w), d=3), \
            TDir(lam=0.05, w=w, d=3)
    return (jm.MultipleKernelLearner(kernels(case, JK, {}), regularizer=rj,
                                     **kw),
            tm.MultipleKernelLearner(kernels(case, TK, TK64), regularizer=rt,
                                     device="cpu", dtype=torch.float64, **kw))


def fit_pair(case):
    """Both packages' learners fitted on `case` (300 EG steps)."""
    j, t = learners(case)
    x, y = data(case)
    j.fit_gp(x, y)
    t.fit_gp(x, y)
    return j, t, x, y


def check_learner_fit(case, fit):
    j, t, x, y = fit
    assert rel(t.alphas, j.alphas) < ITER
    assert float(t.alphas.sum()) == pytest.approx(1.0, abs=1e-12)
    xt = np.linspace(-1, 1, 30)[:, None] * np.ones((1, x.shape[1]))
    mu_j, s_j = jax.jit(j.mean_std)(jnp.asarray(xt))
    mu_t, s_t = t.mean_std(xt)
    assert rel(mu_t, mu_j) < ITER and rel(s_t, s_j) < ITER
    if case == "select":
        # the JAX package's own bars
        a = t.alphas.numpy()
        assert a[1] > a[0]
        assert np.abs(mu_t.numpy().ravel() - np.sin(6 * xt.ravel())).mean() < 0.2


def test_learner_fit_matches_jax():
    check_learner_fit("select", fit_pair("select"))


def jax_state(case, alphas):
    """A JAX learner on `case`'s kernels and data with weights `alphas`,
    its factor and solve formed as its `fit_gp` forms them."""
    from stpy_tpu.linalg import cho_solve, safe_cholesky
    j = learners(case)[0]
    x, y = data(case)
    j.x, j.y = jnp.asarray(x), jnp.asarray(y).reshape(-1, 1)
    j.n, j.d = x.shape
    j.Ks = jnp.stack([jax.jit(k.gram)(j.x) for k in j.kernel_objects])
    j.alphas = jnp.asarray(alphas)
    j.K = jnp.einsum("k,kij->ij", j.alphas, j.Ks) + j.lam * j.s**2 * \
        jnp.eye(j.n)
    j.L = safe_cholesky(j.K).L
    j.A = cho_solve(j.L, j.y)
    j.fitted = True
    return j, x, y


def check_objective_and_gradient(case):
    """The port's closed-form gradient against `jax.grad` of the JAX
    objective (through its Cholesky), at the simplex's centre and at three
    more of its points."""
    k = 3 if case == "three" else 2
    j, x, y = jax_state(case, np.ones(k) / k)
    t = load_mkl_state(learners(case)[1], x, y, j.alphas)
    reg = j.regularizer
    ridge = j.lam * j.s**2
    n = x.shape[0]

    def objective(alpha):
        from stpy_tpu.linalg import chol_jittered, cho_solve
        A = jnp.einsum("k,kij->ij", alpha, j.Ks) + ridge * jnp.eye(n)
        val = (j.y.T @ cho_solve(chol_jittered(A), j.y))[0, 0]
        return val + reg.eval(alpha)

    value_and_grad = jax.jit(jax.value_and_grad(objective))
    rng = np.random.default_rng(4)
    for a in [np.ones(k) / k] + [rng.dirichlet(np.ones(k)) for _ in range(3)]:
        vj, gj = value_and_grad(jnp.asarray(a))
        assert rel(t.objective(torch.tensor(a)), vj) < DET
        assert rel(t.objective_grad(torch.tensor(a)), gj) < DET


def test_learner_defaults_to_the_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ks = kernels("select", TK, {"device": "cpu"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.MultipleKernelLearner(ks)
    t = tm.MultipleKernelLearner(ks, lam=1.0, s=0.05, device="cpu")
    x, y = data("select")
    t.fit_gp(x, y, steps=20)
    assert t.L.device.type == "cpu" and t.L.dtype == torch.float32
    assert bool(torch.isfinite(t.mean_std(x)[1]).all())
