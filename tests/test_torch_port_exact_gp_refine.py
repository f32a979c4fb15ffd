"""Port parity: the refined double tier of stpy_tpu_torch's
`GaussianProcess` (`precision="double"`, var_refine >= 1) against
stpy_tpu on the CPU: fit_predict and fit_gp-then-mean_std for every
kernel case, var_refine above one, and the refined variance's gain over
var_refine=0.

The same numpy data goes through both packages (JAX in x64, torch in
float64), with the bars of tests/test_torch_port_exact_gp.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu_torch import GaussianProcess as TorchGP

from test_torch_port_exact_gp import (  # noqa: F401 (module fixtures)
    S, assert_posterior_close, data, gp_pair, pinned_torch_state,
)
from test_torch_port_gram import CASES, torch_kernel


@pytest.mark.parametrize("case", CASES)
def test_var_refine_fit_predict_matches_jax(data, case):
    x, y, xt = data
    jg, tg = gp_pair(case, precision="double", var_refine=1)
    want = jg.fit_predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    assert_posterior_close(tg.fit_predict(x, y, xt), want)
    # the train df Gram is kept for the quadratic form, as in the JAX GP
    got = sum(k.numpy() for k in tg._df_train)
    want = sum(np.asarray(k) for k in jg._df_train)
    assert np.max(np.abs(got - want) / want) <= 1e-13


@pytest.mark.parametrize("case", CASES)
def test_var_refine_fit_gp_then_mean_std_matches_jax(data, case):
    x, y, xt = data
    jg, tg = gp_pair(case, precision="double", var_refine=1)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))


def test_var_refine_above_one_acts_as_one(data):
    x, y, xt = data
    one = TorchGP(kernel=torch_kernel("se+matern32"), s=S, precision="double",
                  var_refine=1).fit_predict(x, y, xt)
    two = TorchGP(kernel=torch_kernel("se+matern32"), s=S, precision="double",
                  var_refine=2).fit_predict(x, y, xt)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_var_refine_tightens_the_variance_over_var_refine_zero(data):
    """Against a float64 posterior on the same f32-rounded Gram pair, the
    refined variance is exact to the df floor while the var_refine=0
    variance goes through the hi part only."""
    x, y, xt = data
    errs = {}
    for vr in (0, 1):
        tg = TorchGP(kernel=torch_kernel("matern32"), s=S, precision="double",
                     var_refine=vr)
        _, sd = tg.fit_predict(x, y, xt)
        K = tg.kernel_object.cross(x, x).numpy() + S * S * np.eye(96)
        Ks = tg.kernel_object.cross(xt, x).numpy()
        var = 1.0 - np.einsum("tn,nt->t", Ks, np.linalg.solve(K, Ks.T))
        errs[vr] = np.max(np.abs(sd.numpy()[:, 0] ** 2 - var) / var)
    assert errs[1] <= 1e-9 < errs[0]
