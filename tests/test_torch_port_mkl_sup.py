"""Port parity: `MultipleKernelLearner` of stpy_tpu_torch/models/mkl.py
against stpy_tpu's on the CPU, on the JAX package's case with the sup
regularizer (tests/test_mkl_and_misc.py: SE + linear on 40 points), JAX
in x64 and torch in float64: the fitted weights and the posterior within
1e-6 relative, the objective and its closed-form gradient against
`jax.grad`'s within 1e-10 (the bars of tests/test_torch_port_mkl.py).
"""

import jax

from test_torch_port_mkl import (
    check_learner_fit, check_objective_and_gradient, fit_pair,
)
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def test_learner_fit_matches_jax():
    check_learner_fit("sup", fit_pair("sup"))


def test_objective_and_gradient_match_jax():
    check_objective_and_gradient("sup")
