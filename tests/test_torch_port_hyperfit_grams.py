"""Port parity: the hand Grams' autograd Functions (`ops.gram._Gram`,
`ops.gram_l1._GramL1`) of stpy_tpu_torch against the JAX package's
custom VJPs on the CPU, and their gradcheck / gradgradcheck.

The same numpy inputs go through both packages, JAX in x64 and torch in
float64; on the CPU the port's Gram Functions run their plain versions in
the forward and the JAX package's closed-form backward. The Gram
gradients agree with JAX's custom VJPs within 1e-12 of their largest
entry (tests/test_torch_port_hyperfit.py's GRAD_RTOL).
"""

import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

import jax
import jax.numpy as jnp

from stpy_tpu.ops import pallas_gram as jg
from stpy_tpu_torch.ops.gram import _Gram, gram_matern, gram_se
from stpy_tpu_torch.ops.gram_l1 import _GramL1, gram_laplace

from test_torch_port_hyperfit import FAMILIES, GRAD_RTOL, close, leaf, points
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("ard", [False, True], ids=["scalar", "ard"])
@pytest.mark.parametrize("family,nu", FAMILIES)
def test_gram_function_gradient_matches_the_jax_vjp(family, nu, ard):
    a, b = points(7, 5, 3, seed=1)
    gamma = np.array([0.6, 0.9, 1.3]) if ard else np.array(0.8)
    kappa = np.array(1.4)
    gbar = np.random.default_rng(3).standard_normal((7, 5))
    _, vjp = jax.vjp(lambda x, y, g, k: jg._gram(x, y, g, k, family, nu),
                     *(jnp.asarray(v) for v in (a, b, gamma, kappa)))
    want = vjp(jnp.asarray(gbar))
    ts = [leaf(v) for v in (a, b, gamma, kappa)]
    fn = gram_se if family == "se" else (
        lambda x, y, g, k: gram_matern(x, y, g, k, nu=nu))
    K = fn(*ts)
    assert close(K, jg._gram(*(jnp.asarray(v) for v in (a, b, gamma, kappa)),
                             family, nu), 1e-14)
    K.backward(torch.as_tensor(gbar))
    for t, w in zip(ts, want):
        assert close(t.grad, w, GRAD_RTOL)


def test_laplace_function_gradient_matches_the_jax_vjp():
    a, b = points(7, 5, 3, seed=4)
    gbar = np.random.default_rng(5).standard_normal((7, 5))
    args = (a, b, np.array(0.9), np.array(1.2))
    _, vjp = jax.vjp(jg._gram_l1, *(jnp.asarray(v) for v in args))
    want = vjp(jnp.asarray(gbar))
    ts = [leaf(v) for v in args]
    gram_laplace(*ts).backward(torch.as_tensor(gbar))
    for t, w in zip(ts, want):
        assert close(t.grad, w, GRAD_RTOL)


@pytest.mark.parametrize("family,nu", FAMILIES + [("laplace", None)])
def test_gram_functions_pass_gradcheck_and_gradgradcheck(family, nu):
    a, b = points(5, 4, 3, seed=6)
    x, y, k = leaf(a), leaf(b), leaf(1.3)
    if family == "laplace":
        def fn(x, y, k, ig):
            return _GramL1.apply(x, y, ig, k)
        args = (x, y, k, leaf(0.7))
    else:
        def fn(x, y, k):
            return _Gram.apply(x, y, k, family, nu)
        args = (x, y, k)
    assert gradcheck(fn, args)
    assert gradgradcheck(fn, args)


def test_gram_without_a_gradient_skips_the_function():
    a, b = points(5, 4, 2)
    x, y = torch.as_tensor(a), torch.as_tensor(b)
    K = gram_se(x, y, torch.tensor(0.7, dtype=torch.float64))
    assert K.grad_fn is None
    K = gram_se(x, y, leaf(0.7))
    assert type(K.grad_fn).__name__ == "_GramBackward"
    with torch.no_grad():
        assert gram_laplace(x, y, leaf(0.7)).grad_fn is None
