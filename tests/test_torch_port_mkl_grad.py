"""Port parity: `MultipleKernelLearner` of stpy_tpu_torch/models/mkl.py on
the SE + Matérn-3/2 + Laplace mix of the card's phase 19.1 against
stpy_tpu on the CPU, JAX in x64 and torch in float64: the objective and
its closed-form gradient against `jax.grad`'s within 1e-10, and the
posterior on a JAX state carried by `convert.load_mkl_state` within 1e-10
(the bars of tests/test_torch_port_mkl.py).
"""

import numpy as np

import jax
import jax.numpy as jnp

from stpy_tpu_torch.convert import load_mkl_state

from test_torch_port_mkl import (
    DET, check_objective_and_gradient, jax_state, learners, rel,
)
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def test_objective_and_gradient_match_jax():
    check_objective_and_gradient("three")


def test_posterior_on_the_jax_state_matches_jax():
    """The SE + Matérn-3/2 + Laplace mix of phase 19.1 at weights off the
    simplex's centre, the JAX state carried by `convert.load_mkl_state`."""
    j, x, y = jax_state("three", np.array([0.5, 0.3, 0.2]))
    t = load_mkl_state(learners("three")[1], x, y, j.alphas, L=j.L, A=j.A)
    xt = np.random.default_rng(5).uniform(-1, 1, (20, 2))
    jx = jnp.asarray(xt)
    outs = jax.jit(lambda z: (j.mean(z), j.mean_std(z),
                              j.mean_std(z, full=True), j.execute(z),
                              j.ucb(z), j.lcb(z)))(jx)
    assert rel(t.mean(xt), outs[0]) < DET
    for a, b in zip(t.mean_std(xt), outs[1]):
        assert rel(a, b) < DET
    for a, b in zip(t.mean_std(xt, full=True), outs[2]):
        assert rel(a, b) < DET
    for a, b in zip(t.execute(xt), outs[3]):
        assert rel(a, b) < DET
    assert rel(t.ucb(xt), outs[4]) < DET and rel(t.lcb(xt), outs[5]) < DET
    # L and A from the port's own Grams are the JAX package's
    t2 = load_mkl_state(learners("three")[1], x, y, j.alphas)
    assert rel(t2.L, j.L) < DET and rel(t2.A, j.A) < DET
