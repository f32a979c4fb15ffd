"""Port parity: the matrix-free hyperparameter fit of stpy_tpu_torch
(parallel/slq.py, parallel/bbmm.py, IterativeGP.optimize_params,
randomized_eig_precond) against stpy_tpu/parallel, at small size on the CPU.

The same numpy data goes through both packages, JAX in x64 and torch in
float64, where every port wrapper runs its plain PyTorch version. The
random draws differ between the packages (jax.random keys against
torch.Generator), so where a result depends on them both are fed the same
numbers: `jax.random.rademacher` / `split` / `normal` and `torch.randint` /
`randn` are replaced for the test by functions that return one numpy-made
block (the JAX package's compiled evidence programs are cleared before and
after, so none is traced with or kept from the replacement). Tolerances,
relative to the largest entry:
* Lanczos and the per-atom gradient pieces: 1e-9 — the same arithmetic in
  f64, in other summation orders (Matérn-½: 1e-7, its k'(sq)·sq carries
  r = √sq, and on the diagonal sq is the f64 cancellation residual
  δ ~ 1e-16 of each package's own summation order, so √δ ~ 1e-8 differs);
  SLQ: 1e-7 at 30 Lanczos steps and 1e-6 in the evidence's value —
  without reorthogonalisation the recurrence amplifies rounding
  differences once its basis loses orthogonality, sooner on a kernel
  matrix's fast-decaying spectrum (1.8e-8 and 2.4e-7 measured here);
* the evidence gradients and the fits: 1e-7 — the CG solves (tol 1e-12)
  converge to the same solution, not through the same iterates;
* against dense float64 autodiff (torch.autograd through a Cholesky NLL):
  the JAX package's own bars (tests/test_parallel.py,
  tests/test_lazy_algebra.py) — 2 % on the SLQ value, 6 % on each
  Hutchinson gradient at 600 probes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.parallel import bbmm as jbb
from stpy_tpu.parallel import iterative as jit_
from stpy_tpu.parallel import slq as jslq
from stpy_tpu_torch import parallel as tpar
from stpy_tpu_torch.parallel import bbmm as tbb
from stpy_tpu_torch.parallel import iterative as tit
from stpy_tpu_torch.parallel import slq as tslq

from test_torch_port_gram import make_kernel
from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu_torch import KernelFunction as TorchKernel

from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9
SQRT_DIAG_RTOL = SLQ_RTOL = EVIDENCE_RTOL = 1e-7
NLL_RTOL = 1e-6
TIGHT = dict(cg_tol=1e-12, cg_maxiter=800, probe_tol=1e-12, probe_maxiter=800)


def rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def data(n=90, d=2, seed=31):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    return x, y


def spd(n=80, seed=5):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.geomspace(0.05, 20, n)) @ Q.T
    return 0.5 * (A + A.T)


def signs(n, probes, seed=7):
    return np.random.default_rng(seed).choice([-1.0, 1.0], (n, probes))


@pytest.fixture
def same_probes(monkeypatch):
    """Returns `feed(Z)`: from then on both packages draw their Rademacher
    probes as the columns of Z (JAX: the (n, p) block draw returns Z, the
    per-probe draw of key k its column k, the split keys 0..p-1; torch:
    every `randint` returns Z's bits)."""
    jbb._evg_core.cache_clear()
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
    jbb._evg_core.cache_clear()
    jbb._evg_general_core.cache_clear()


# ---------------------------------------------------------------------------
# SLQ
# ---------------------------------------------------------------------------

def test_lanczos_tridiag_matches_jax_and_runs_probes_as_columns():
    A = spd()
    z = signs(80, 3)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    ja, jb, jn = jslq.lanczos_tridiag(lambda v: Aj @ v, jnp.asarray(z[:, 0]),
                                      25)
    ta, tb, tn = tslq.lanczos_tridiag(lambda v: At @ v,
                                      torch.as_tensor(z[:, 0]), 25)
    assert ta.shape == (25,) and tb.shape == (24,)
    for got, want in ((ta, ja), (tb, jb), (tn, jn)):
        assert rel_err(got, want) <= RTOL
    # a block of probes: one recurrence per column
    ba, bb, bn = tslq.lanczos_tridiag(lambda V: At @ V, torch.as_tensor(z), 25)
    assert ba.shape == (25, 3) and bb.shape == (24, 3) and bn.shape == (3,)
    for c in range(3):
        one = tslq.lanczos_tridiag(lambda v: At @ v,
                                   torch.as_tensor(z[:, c]), 25)
        for got, want in zip((ba[:, c], bb[:, c], bn[c]), one):
            assert rel_err(got, want) <= RTOL


def test_slq_matches_jax_on_the_same_probes(same_probes):
    A = spd()
    Z = signs(80, 6)
    same_probes(Z)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    kw = dict(probes=6, lanczos_iters=30)
    jld, jvals = jslq.slq_logdet(lambda v: Aj @ v, 80, dtype=jnp.float64, **kw)
    for mm in (None, lambda V: At @ V):
        tld, tvals = tslq.slq_logdet(lambda v: At @ v, 80, dtype=torch.float64,
                                     device="cpu", matmat=mm, **kw)
        assert rel_err(tvals, jvals) <= SLQ_RTOL
        assert rel_err(tld, jld) <= SLQ_RTOL
    jtr = jslq.slq_trace_fn(lambda v: Aj @ v, 80, jnp.sqrt,
                            dtype=jnp.float64, **kw)
    ttr = tslq.slq_trace_fn(lambda v: At @ v, 80, torch.sqrt,
                            dtype=torch.float64, generator=torch.Generator(),
                            **kw)
    assert rel_err(ttr, jtr) <= SLQ_RTOL
    y = np.random.default_rng(8).standard_normal(80)
    jev = jslq.evidence_matvec_only(lambda v: Aj @ v, jnp.asarray(y), 80, **kw)
    tev = tslq.evidence_matvec_only(lambda v: At @ v, torch.as_tensor(y), 80,
                                    **kw)
    assert rel_err(tev, jev) <= SLQ_RTOL


# ---------------------------------------------------------------------------
# gradient pieces and the evidence
# ---------------------------------------------------------------------------

ATOMS = [("se", 1.0, 0.6), ("matern", 0.5, 0.9), ("matern", 1.5, 0.8),
         ("matern", 2.5, 1.1), ("se", 1.0, [0.4, 0.9, 1.7]),
         ("matern", 1.5, [0.7, 1.2, 0.5])]
ATOM_IDS = ["se", "matern12", "matern32", "matern52", "ard_se",
            "ard_matern32"]


@pytest.mark.parametrize("family,nu,gamma", ATOMS, ids=ATOM_IDS)
def test_atom_gradient_pieces_match_jax(family, nu, gamma):
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (70, 3))
    alpha = rng.standard_normal(70)
    W, Z = rng.standard_normal((70, 5)), signs(70, 5)
    g = np.asarray(gamma)
    gj = jnp.asarray(g) if g.ndim else float(g)
    gt = torch.as_tensor(g) if g.ndim else float(g)
    want_q = jbb._atom_quad_gamma(jnp.asarray(x), jnp.asarray(alpha), gj, 1.3,
                                  family, nu)
    got_q = tbb._atom_quad_gamma(torch.as_tensor(x), torch.as_tensor(alpha),
                                 gt, 1.3, family, nu)
    want_t = jbb._atom_trace_gamma(jnp.asarray(x), jnp.asarray(W),
                                   jnp.asarray(Z), gj, 1.3, family, nu)
    got_t = tbb._atom_trace_gamma(torch.as_tensor(x), torch.as_tensor(W),
                                  torch.as_tensor(Z), gt, 1.3, family, nu)
    assert got_q.shape == got_t.shape == np.shape(want_q)
    bar = SQRT_DIAG_RTOL if nu == 0.5 else RTOL
    assert rel_err(got_q, want_q) <= bar and rel_err(got_t, want_t) <= bar


def flat(grads):
    out = [grads["noise"]]
    for key in ("gammas", "kappas", "gamma", "kappa"):
        v = grads.get(key)
        out += v if isinstance(v, list) else ([] if v is None else [v])
    return [np.asarray(g.detach() if isinstance(g, torch.Tensor) else g)
            for g in out]


EVIDENCE_CASES = {
    # a sum with one atom on a coordinate group
    "se[0,2]+matern32": (3, (("se", 1.0, (0, 2)), ("matern", 1.5, None)),
                         [0.5, 1.1], [1.2, 0.7]),
    "ard_matern52": (3, (("matern", 2.5, None),), [[0.4, 0.9, 1.7]], [1.3]),
}


@pytest.mark.parametrize("case", list(EVIDENCE_CASES))
def test_evidence_value_and_grad_matches_jax_on_the_same_probes(case,
                                                                same_probes):
    d, desc, gammas, kappas = EVIDENCE_CASES[case]
    x, y = data(90, d)
    same_probes(signs(90, 8))
    kw = dict(probes=8, lanczos_iters=20, **TIGHT)
    jn, jg = jbb.evidence_value_and_grad_sum(
        jnp.asarray(x), jnp.asarray(y), desc, gammas, kappas, 0.35, **kw)
    tn, tg = tbb.evidence_value_and_grad_sum(
        torch.as_tensor(x), torch.as_tensor(y), desc, gammas, kappas, 0.35,
        **kw)
    assert rel_err(tn, jn) <= NLL_RTOL
    for got, want in zip(flat(tg), flat(jg)):
        assert got.shape == np.shape(want)
        assert rel_err(got, want) <= EVIDENCE_RTOL
    if len(desc) == 1:
        # the single-atom form, and no value where none is asked for
        (fam, nu, _), = desc
        jn1, jg1 = jbb.evidence_value_and_grad_lazy(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(gammas[0]), kappas[0],
            0.35, family=fam, nu=nu, compute_value=False, **kw)
        tn1, tg1 = tpar.evidence_value_and_grad_lazy(
            torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor(gammas[0]), kappas[0], 0.35, family=fam, nu=nu,
            compute_value=False, **kw)
        assert np.isnan(float(jn1)) and torch.isnan(tn1)
        for got, want in zip(flat(tg1), flat(jg1)):
            assert rel_err(got, want) <= EVIDENCE_RTOL


def test_preconditioned_evidence_has_the_unpreconditioned_gradient(
        same_probes):
    """A rank-24 preconditioner changes the CG iterates, not the solutions:
    on the same probes the gradients agree to the solves' tolerance."""
    x, y = data(120, 2, seed=4)
    same_probes(signs(120, 6))
    desc = (("se", 1.0, None), ("matern", 1.5, None))
    args = (torch.as_tensor(x), torch.as_tensor(y), desc, [0.5, 1.1],
            [1.2, 0.7], 0.2)
    kw = dict(probes=6, compute_value=False, **TIGHT)
    _, plain = tbb.evidence_value_and_grad_sum(*args, **kw)
    _, pre = tbb.evidence_value_and_grad_sum(*args, precond_rank=24, **kw)
    for got, want in zip(flat(pre), flat(plain)):
        assert rel_err(got, want) <= 1e-6


def dense_nll(x, y, atoms, noise):
    """The exact NLL in float64 by a Cholesky: atoms (family, nu, γ, κ)."""
    n = x.shape[0]
    A = noise ** 2 * torch.eye(n, dtype=torch.float64)
    for fam, nu, g, k in atoms:
        xs = x / g
        sq = torch.clamp((xs * xs).sum(1)[:, None] + (xs * xs).sum(1)[None, :]
                         - 2 * xs @ xs.T, min=0.0)
        if fam == "se":
            A = A + k * torch.exp(-0.5 * sq)
        else:
            r = torch.sqrt(sq + 1e-30) * np.sqrt(3.0)
            A = A + k * (1 + r) * torch.exp(-r)
    L = torch.linalg.cholesky(A)
    a = torch.cholesky_solve(y[:, None], L)[:, 0]
    return (0.5 * y @ a + torch.log(torch.diagonal(L)).sum()
            + 0.5 * n * np.log(2 * np.pi))


@pytest.mark.parametrize("ard", [False, True], ids=["se+matern32", "ard_se"])
def test_evidence_grads_match_dense_autodiff(ard):
    """As tests/test_lazy_algebra.py holds the JAX package: 600 probes,
    CG to 1e-10, against torch.autograd through the dense Cholesky NLL."""
    x, y = data(160, 3 if ard else 2, seed=13)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    if ard:
        params = [torch.tensor([0.4, 0.9, 1.7], dtype=torch.float64),
                  torch.tensor(1.3, dtype=torch.float64),
                  torch.tensor(0.4, dtype=torch.float64)]
        desc = (("se", 1.0, None),)
    else:
        params = [torch.tensor(v, dtype=torch.float64)
                  for v in (0.5, 1.2, 1.1, 0.7, 0.35)]
        desc = (("se", 1.0, None), ("matern", 1.5, None))
    for p in params:
        p.requires_grad_()
    atoms = ([("se", 1.0, params[0], params[1])] if ard else
             [("se", 1.0, params[0], params[1]),
              ("matern", 1.5, params[2], params[3])])
    ref = dense_nll(xt, yt, atoms, params[-1])
    ref.backward()
    gammas = [p.detach() for p in params[:-1:2]]
    kappas = [float(p.detach()) for p in params[1:-1:2]]
    nll, g = tbb.evidence_value_and_grad_sum(
        xt, yt, desc, gammas, kappas, float(params[-1].detach()),
        probes=600, cg_tol=1e-10, cg_maxiter=600, lanczos_iters=60,
        generator=torch.Generator().manual_seed(3))
    ref = float(ref.detach())
    assert abs(float(nll) - ref) / abs(ref) < 0.02
    ests = []
    for a in range(len(desc)):
        ests += [g["gammas"][a], g["kappas"][a]]
    ests.append(g["noise"])
    for est, p in zip(ests, params):
        ref_g = p.grad.numpy()
        est = est.numpy()
        assert est.shape == ref_g.shape
        denom = np.maximum(np.abs(ref_g), 1.0)
        assert np.all(np.abs(est - ref_g) / denom < 0.06), (est, ref_g)


# ---------------------------------------------------------------------------
# the fits and IterativeGP.optimize_params
# ---------------------------------------------------------------------------

def test_adam_log_space_follows_the_jax_trajectory():
    target = {"a": np.array([0.3, 2.0]), "b": 0.7}

    def vg(theta):
        # d/dθ of Σ (log θ − log θ*)², a deterministic gradient
        return {k: 2 * (np.log(theta[k]) - np.log(target[k])) / theta[k]
                for k in theta}

    theta0 = {"a": np.array([1.0, 1.0]), "b": 2.0}
    for tol in (0.0, 0.05):
        jt, jsteps, jh = jbb._adam_log_space(vg, theta0, 40, 0.2, tol, False)
        tt, tsteps, th = tbb._adam_log_space(vg, theta0, 40, 0.2, tol, False)
        assert tsteps == jsteps and th == jh
        assert all(np.array_equal(tt[k], jt[k]) for k in theta0)
    assert jsteps < 40   # tol 0.05 stopped it early


def test_fit_evidence_lazy_and_sum_match_jax(same_probes):
    x, y = data(80, 2, seed=6)
    same_probes(signs(80, 8))
    kw = dict(steps=4, lr=0.15, probes=8, tol=0.0, **TIGHT)
    jl = jbb.fit_evidence_lazy(jnp.asarray(x), jnp.asarray(y), 0.5, 1.0, 0.3,
                               optimize=("gamma", "kappa", "noise"), **kw)
    tl = tbb.fit_evidence_lazy(torch.as_tensor(x), torch.as_tensor(y), 0.5,
                               1.0, 0.3, optimize=("gamma", "kappa", "noise"),
                               **kw)
    assert tl["steps_run"] == jl["steps_run"] == 4
    assert tl["nll_error"] is None and jl["nll_error"] is None
    for k in ("gamma", "kappa", "noise"):
        assert rel_err(tl[k], jl[k]) <= EVIDENCE_RTOL, k
    assert rel_err(tl["nll"], jl["nll"]) <= NLL_RTOL
    assert rel_err(tl["history"], jl["history"]) <= 1e-6
    desc = (("se", 1.0, None), ("matern", 1.5, None))
    js = jbb.fit_evidence_sum(jnp.asarray(x), jnp.asarray(y), desc,
                              [0.5, 1.1], [1.0, 0.5], 0.3, **kw)
    ts = tpar.fit_evidence_sum(torch.as_tensor(x), torch.as_tensor(y), desc,
                               [0.5, 1.1], [1.0, 0.5], 0.3, **kw)
    for k in ("gammas", "kappas", "noise"):
        assert rel_err(ts[k], js[k]) <= EVIDENCE_RTOL, k


def test_fit_evidence_lazy_reports_a_failed_closing_evaluation(monkeypatch):
    def broken(*args, **kwargs):
        raise FloatingPointError("no logdet")

    monkeypatch.setattr(tbb, "slq_logdet", broken)
    x, y = data(40, 2)
    with pytest.warns(UserWarning, match="closing SLQ evidence evaluation"):
        out = tbb.fit_evidence_lazy(torch.as_tensor(x), torch.as_tensor(y),
                                    0.5, steps=2, probes=4)
    assert np.isnan(out["nll"]) and "no logdet" in out["nll_error"]
    assert out["steps_run"] == 2 and np.isfinite(out["gamma"])


def test_step_generators_are_seeded_from_seed_and_step(monkeypatch):
    def draw(seed, step):
        return torch.randint(0, 2, (64,), generator=tbb.step_generator(
            seed, step, device="cpu"))
    assert torch.equal(draw(0, 3), draw(0, 3))
    assert not torch.equal(draw(0, 3), draw(0, 4))
    assert not torch.equal(draw(0, 3), draw(1, 3))
    # with no device the generator lives on the card, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbb.step_generator(0, 3)


@pytest.mark.parametrize("case", ["ard", "ard[0,2]+matern32"])
def test_optimize_params_writes_back_like_jax(case, same_probes):
    """The fitted values land in the kernel's params_dict as the JAX
    package writes them (an ARD vector stays a vector; an ARD atom on a
    coordinate group scatters its entries into the full-d vector and leaves
    the others), the noise in `s`, and the model is refitted."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (90, 3))
    y = np.sin(4 * x[:, :1]) + 0.2 * x[:, 2:3] + 0.05 * rng.standard_normal(
        (90, 1))
    same_probes(signs(90, 8))

    def kernel(cls, **kw):
        ard = cls(kernel_name="ard", ard_gamma=[0.3, 1.0, 2.0], d=3,
                  group=[0, 2] if "+" in case else None, **kw)
        return ard + cls(kernel_name="matern", gamma=0.9, nu=1.5, d=3, **kw) \
            if "+" in case else ard

    jk, tk = kernel(JaxKernel), kernel(TorchKernel, device="cpu",
                                       dtype=torch.float64)
    gp_kw = dict(s=0.3, lazy=True, tol=1e-10, maxiter=600, precond_rank=0)
    jg, tg = jit_.IterativeGP(jk, **gp_kw), tit.IterativeGP(tk, **gp_kw)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    kw = dict(optimize=("gamma", "kappa", "noise"), steps=3, lr=0.15,
              probes=8, tol=0.0, **TIGHT)
    jout = jg.optimize_params(**kw)
    tout = tg.optimize_params(**kw)
    assert tout["steps_run"] == jout["steps_run"] == 3
    for idx, p in tk.params_dict.items():
        for key, val in p.items():
            want = np.asarray(jk.params_dict[idx][key])
            assert tuple(val.shape) == want.shape, (idx, key)
            assert rel_err(val, want) <= EVIDENCE_RTOL, (idx, key)
    ard = tk.params_dict["0"]["ard_gamma"].numpy()
    assert ard.shape == (3,) and np.std(ard) > 1e-3
    if "+" in case:
        assert ard[1] == 1.0      # outside the atom's group: untouched
    assert rel_err(tg.s, jg.s) <= EVIDENCE_RTOL and tg.s != 0.3
    # refitted on the new values
    assert tg.fit_status["converged"]
    xt = rng.uniform(-1, 1, (20, 3))
    assert rel_err(tg.mean(xt).numpy(), jg.mean(jnp.asarray(xt))) <= 1e-6


def test_randomized_eig_precond_matches_jax(monkeypatch):
    x, _ = data(100, 2, seed=9)
    Om = np.random.default_rng(10).standard_normal((100, 20))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(Om))
    monkeypatch.setattr(torch, "randn",
                        lambda *shape, generator=None, dtype=None:
                        torch.as_tensor(Om, dtype=dtype))
    kw = dict(family="se", gamma=0.6, kappa=1.1, noise=0.3)
    from stpy_tpu.ops import pallas_gram_matvec as jax_mv
    jmm = jax_mv.make_lazy_matmat(jnp.asarray(x), **kw)
    tmm = tpar.make_lazy_matmat(torch.as_tensor(x), **kw)
    jM = jit_.randomized_eig_precond(jmm, 100, 20, 0.3, jax.random.PRNGKey(0),
                                     block=8)
    tM = tpar.randomized_eig_precond(tmm, 100, 20, 0.3, block=8,
                                     dtype=torch.float64, device="cpu")
    R = np.random.default_rng(2).standard_normal((100, 3))
    assert rel_err(tM(torch.as_tensor(R)), jM(jnp.asarray(R))) <= 1e-8
    assert rel_err(tM(torch.as_tensor(R[:, 0])), jM(jnp.asarray(R[:, 0]))) \
        <= 1e-8


@pytest.mark.parametrize("what", ["evidence", "fit"])
def test_general_tier_matches_jax_on_a_product_kernel(what, same_probes):
    """bbmm's general tier, once a raise: on the same probes the port's
    general evidence gradient and a 2-step general fit of the product
    kernel se*matern32 equal the JAX package's (EVIDENCE_RTOL; the fuller
    cases are tests/test_torch_port_bbmm_general.py)."""
    x, y = data(60, 3, seed=8)
    same_probes(signs(60, 6))
    jk = make_kernel(JaxKernel, "se*matern32")
    tk = make_kernel(TorchKernel, "se*matern32", device="cpu",
                     dtype=torch.float64)
    kw = dict(chunk=25, probes=6, **TIGHT)
    if what == "evidence":
        _, jg = jbb.evidence_value_and_grad_general(
            jk, jnp.asarray(x), jnp.asarray(y), noise=0.3,
            compute_value=False, **kw)
        _, tg = tpar.evidence_value_and_grad_general(
            tk, torch.as_tensor(x), torch.as_tensor(y), noise=0.3,
            compute_value=False, **kw)
        pairs = [(tg["noise"], jg["noise"])] + [
            (tg["params"][a][k], jg["params"][a][k])
            for a in jg["params"] for k in jg["params"][a]]
    else:
        fit = dict(steps=2, lr=0.15, tol=0.0, **kw)
        jo = jbb.fit_evidence_general(jk, jnp.asarray(x), jnp.asarray(y),
                                      0.3, **fit)
        to = tpar.fit_evidence_general(tk, torch.as_tensor(x),
                                       torch.as_tensor(y), 0.3, **fit)
        pairs = [(to["noise"], jo["noise"])] + [
            (to["params"][a][k], jo["params"][a][k])
            for a in jo["params"] for k in jo["params"][a]]
    for got, want in pairs:
        assert rel_err(got, want) <= EVIDENCE_RTOL
