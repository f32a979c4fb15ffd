"""Port parity: the non-stationary, map, additive-group and custom atoms of
the kernel tail (gibbs, gibbs_custom, linear, polynomial, tanh, step,
wiener, angsim, custom_map, random_map, the `groups=` families,
`kernel_function=` callables), the kernel derivatives, the linear atom's
embedding and the group helpers of stpy_tpu_torch against stpy_tpu on the
CPU, with the bars of tests/test_torch_port_kernel_tail.py (which holds
the stationary atoms, `bessel_kv`, general-ν Matérn and the composites):
entries within 1e-12 of max|K| in float64 and 1e-5 in float32, the
derivatives within 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.utils import groups as jax_groups
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.kernels import functions as F
from stpy_tpu_torch.utils import groups as port_groups

from test_torch_port_kernel_tail import (
    CASES, D, DERIV_RTOL, STATIONARY, check_atom, kernels, points, rel,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", sorted(set(CASES) - set(STATIONARY)))
def test_atom_matches_jax(case):
    check_atom(case)


@pytest.mark.parametrize("case", ["ard-groups", "full_covariance_se"])
def test_derivatives_match_jax(case):
    """The JAX derivatives are traced once each under `jax.jit` (eagerly,
    their Jacobians dispatch op by op: 10 s for ard-groups)."""
    fixed, x = points(3, 2, seed=3)
    jk, tk = kernels(case)
    jf, jx = jnp.asarray(fixed), jnp.asarray(x)
    assert rel(tk.derivative_1(fixed, x),
               jax.jit(jk.derivative_1)(jf, jx)) <= DERIV_RTOL
    assert rel(tk.derivative_2(fixed, x),
               jax.jit(jk.derivative_2)(jf, jx)) <= DERIV_RTOL


def test_se_closed_form_derivatives_match_jax():
    fixed, x = points(5, 4, seed=4)
    jk = JaxKernel(kernel_name="squared_exponential", gamma=0.6, d=D)
    tk = TorchKernel(kernel_name="squared_exponential", gamma=0.6, d=D,
                     device="cpu", dtype=torch.float64)
    jf, jx = jnp.asarray(fixed), jnp.asarray(x)
    assert rel(tk.get_1_der(fixed, x), jk.get_1_der(jf, jx)) <= DERIV_RTOL
    assert rel(tk.get_2_der(fixed, x), jk.get_2_der(jf, jx)) <= DERIV_RTOL


def test_linear_embedding_and_basis_size():
    x = points(6, 1)[0]
    jk, tk = kernels("linear")
    assert np.array_equal(tk.embed(x).numpy(), np.asarray(jk.embed(x)))
    assert tk.get_basis_size() == jk.get_basis_size() == D
    _, other = kernels("polynomial")
    with pytest.raises(AttributeError, match="finite dimensional"):
        other.embed(x)


def test_groups_helpers_match_jax():
    for d in range(0, 6):
        assert port_groups.generate_groups(d) == jax_groups.generate_groups(d)
        assert port_groups.all_pairs(d) == jax_groups.all_pairs(d)
        assert port_groups.singletons(d) == jax_groups.singletons(d)
    assert len(port_groups.generate_groups(4)) == 15     # Bell(4)


def test_no_pair_broadcast_in_the_per_feature_kernels(monkeypatch):
    """step, wiener and modified_matern accumulate feature by feature and
    bessel_kv node by node: no intermediate grows with n·m·d or n·m·384."""
    seen = []
    real_exp = torch.exp

    def spy(t, *args, **kw):
        seen.append(t.numel())
        return real_exp(t, *args, **kw)

    monkeypatch.setattr(torch, "exp", spy)
    a, b = points(30, 20, seed=6)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    F.modified_matern({"gamma": torch.tensor(0.8)}, ta, tb, nu=2)
    F.matern({"gamma": torch.tensor(0.8)}, ta, tb, nu=1.3)
    assert seen and max(seen) <= 30 * 20
    assert F.step({}, ta, tb).shape == F.wiener({}, ta, tb).shape == (30, 20)
