"""Port parity: the double tier of stpy_tpu_torch's `GaussianProcess`
(`precision="double"`, var_refine=0) against stpy_tpu on the CPU: its
fit_predict and fit_gp-then-mean_std for every kernel case, the df
diagonal of every descriptor, and Laplace as the float64 L1 posterior.

The same numpy data goes through both packages (JAX in x64, torch in
float64), with the bars of tests/test_torch_port_exact_gp.py: posterior
mean within 1e-8 relative to its largest entry, std within 1e-6 entry by
entry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.kernels import df_plan as jax_df_plan
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch.kernels import df_plan

from test_torch_port_exact_gp import (  # noqa: F401 (module fixtures)
    S, assert_posterior_close, data, gp_pair, pinned_torch_state,
)
from test_torch_port_gram import CASES, LAPLACE_CASES, jax_kernel, torch_kernel


@pytest.mark.parametrize("case", CASES)
def test_double_tier_fit_predict_matches_jax(data, case):
    x, y, xt = data
    jg, tg = gp_pair(case, precision="double")
    want = jg.fit_predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    assert_posterior_close(tg.fit_predict(x, y, xt), want)
    assert tg._df_refine_steps_resolved == jg._df_refine_steps_resolved == 1
    # alpha is kept as the (n, 2) df pair, self.A its hi column
    assert tg._A_df.shape == (96, 2)
    assert torch.equal(tg.A, tg._A_df[:, :1])


@pytest.mark.parametrize("case", CASES)
def test_df_diag_from_desc_matches_jax(case):
    xt = np.random.default_rng(9).uniform(-1, 1, (70, 3))
    jk, tk = jax_kernel(case), torch_kernel(case)
    jh, jl = jax_df_plan.df_diag_from_desc(
        jk, jk.params_dict, jnp.asarray(xt), jax_df_plan.df_atom_desc(jk),
        chunk=32)
    th, tl = df_plan.df_diag_from_desc(
        tk, tk.params_dict, torch.as_tensor(xt), df_plan.df_atom_desc(tk),
        chunk=32)
    got = th.double().numpy() + tl.double().numpy()
    want = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    assert th.shape == (70,) and np.max(np.abs(got - want) / want) <= 1e-13


@pytest.mark.parametrize("case", LAPLACE_CASES)
def test_double_tier_laplace_is_the_float64_l1_posterior(data, case):
    """The double tier of a kernel with a laplace atom runs the L1 family
    of the double-float Gram (the single tier's kernel; the JAX package's
    double tier computes an L2 Matérn-½ there, ROADMAP Queue 3): its
    posterior at var_refine=1 is the float64 model's on the L1 Gram, to
    the f32 floor of the returned mean and std (1e-7)."""
    x, y, xt = data
    x, xt = (np.asarray(a, np.float32).astype(np.float64) for a in (x, xt))
    want = TorchGP(kernel=torch_kernel(case), s=S).fit_predict(x, y, xt)
    tg = TorchGP(kernel=torch_kernel(case, dtype=torch.float32), s=S,
                 precision="double", var_refine=1)
    assert [d[1] for d in tg._df_desc].count("laplace") == 1
    assert_posterior_close(tg.fit_predict(x, y, xt), want, mean_rtol=1e-7,
                           std_rtol=1e-6)


def test_double_tier_fit_gp_then_mean_std_matches_jax(data):
    x, y, xt = data
    jg, tg = gp_pair("ard*matern52", precision="double", df_refine_steps=2)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))
