"""Port parity: `GaussianProcess` served from a JAX fit's state
(`convert.load_fitted_state`, every tier), the float64 hyperparameters
of `params_from_jax`, and the once-unported paths (robust alpha, `ucb`
optimisation, the zoom L-BFGS fit) against stpy_tpu on the CPU.

After the state is loaded both sides share the JAX factor, and mean_std
agrees to 1e-10 (tests/test_torch_port_exact_gp.py's STATE_RTOL).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.models import GaussianProcess as JaxGP
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch.convert import load_fitted_state, params_from_jax
from stpy_tpu_torch.opt import minimize_lbfgs

from test_torch_port_exact_gp import (  # noqa: F401 (module fixtures)
    S, STATE_RTOL, assert_posterior_close, data, pinned_torch_state,
)
from test_torch_port_gram import jax_kernel, torch_kernel


@pytest.mark.parametrize("precision,var_refine", [
    ("single", 0), ("double", 0), ("double", 1)])
def test_mean_std_on_loaded_jax_state(data, precision, var_refine):
    x, y, xt = data
    kw = dict(s=S, precision=precision, var_refine=var_refine)
    jg = JaxGP(kernel=jax_kernel("se+matern32"), **kw)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg = TorchGP(kernel=torch_kernel("se+matern32"), **kw)
    tg.kernel_object.set_params(params_from_jax(
        {k: {n: np.asarray(v) for n, v in p.items()}
         for k, p in jg.kernel_object.params_dict.items()}))
    load_fitted_state(
        tg, np.asarray(jg.x), np.asarray(jg.y), np.asarray(jg.L),
        np.asarray(jg.A),
        A_df=None if jg._A_df is None else np.asarray(jg._A_df),
        df_train=(None if jg._df_train is None
                  else [np.asarray(k) for k in jg._df_train]))
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)),
                           STATE_RTOL, STATE_RTOL)


def test_loading_a_var_refine_state_needs_the_train_df_gram(data):
    x, y, _ = data
    tg = TorchGP(kernel=torch_kernel("se"), s=S, precision="double",
                 var_refine=1)
    with pytest.raises(ValueError, match="df_train"):
        load_fitted_state(tg, x, y, np.eye(96), y, A_df=np.zeros((96, 2)))


def test_params_from_jax_keeps_float64_values():
    jk = jax_kernel("ard*matern52")
    pd = params_from_jax({k: {n: np.asarray(v) for n, v in p.items()}
                          for k, p in jk.params_dict.items()})
    assert set(pd) == {"0", "1"} and set(pd["0"]) == {"kappa", "ard_gamma"}
    for k, p in jk.params_dict.items():
        for n, v in p.items():
            assert pd[k][n].dtype == torch.float64
            assert np.array_equal(pd[k][n].numpy(), np.asarray(v))


def _robust_alpha_pair(data, monkeypatch):
    x, y, _ = data
    y = y.copy()
    y[:4] += 5.0
    jg = JaxGP(kernel=jax_kernel("matern12"), s=1.0, loss="huber")
    tg = TorchGP(kernel=torch_kernel("matern12"), s=1.0, loss="huber")
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert tg.robust_status["converged"]
    return tg.A.numpy(), np.asarray(jg.A)


def _ucb_pair(data, monkeypatch):
    import jax

    x, y, _ = data
    U = np.random.default_rng(3).uniform(size=(6, 3))
    bounds = [[-1.0, 1.0]] * 3
    jg = JaxGP(kernel=jax_kernel("se"), s=S, bounds=bounds)
    tg = TorchGP(kernel=torch_kernel("se"), s=S, bounds=bounds)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    # both packages start from the same uniforms
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(U))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.as_tensor(U))
    jp, _ = jg.ucb_optimize(multistart=6, steps=50)
    tp, _ = tg.ucb_optimize(multistart=6, steps=50, generator=torch.Generator())
    return tp.numpy(), np.asarray(jp)


def _zoom_pair(data, monkeypatch):
    from stpy_tpu.opt.lbfgs import minimize_lbfgs as jax_minimize

    x0 = np.array([-1.2, 1.0, 0.3])

    def rosen(lib):
        return lambda v: lib.sum(100 * (v[1:] - v[:-1] ** 2) ** 2
                                 + (1 - v[:-1]) ** 2)

    t = minimize_lbfgs(rosen(torch), torch.as_tensor(x0), max_iter=100)
    j = jax_minimize(rosen(jnp), jnp.asarray(x0), max_iter=100)
    assert t.converged and bool(j.converged)
    return t.x.numpy(), np.asarray(j.x)


@pytest.mark.parametrize("pair", [_robust_alpha_pair, _ucb_pair, _zoom_pair],
                         ids=["robust-loss", "ucb_optimize", "zoom"])
def test_formerly_unported_paths_match_jax(data, pair, monkeypatch):
    # the paths the raise test above named before they were ported: the
    # huber MAP alpha (its L-BFGS converged in both), ucb_optimize from the
    # same starts, and the zoom line search's default L-BFGS
    got, want = pair(data, monkeypatch)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-8
