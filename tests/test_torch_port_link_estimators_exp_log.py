"""Port parity: `ExpGaussProcessRateEstimator` (exp(−Φθ)) and
`LogGaussProcessRateEstimator` (B·sigmoid) of
stpy_tpu_torch/point_processes/link_estimators.py against stpy_tpu on the
CPU: the tests of tests/test_torch_port_link_estimators.py (which runs them
on the quadratic and softplus links), with its data, draws and bars, on
these two links.
"""

import pytest

from test_torch_port_link_estimators import (  # noqa: F401
    CLASSES, fitted, jax_quadrature_below_the_domain, make_pair,
    test_construction_and_data_match_jax,
    test_leaf_product_integrals_are_the_leaves,
    test_fit_matches_jax,
    test_covariance_and_set_values_on_the_jax_fit,
    test_bounds_on_the_jax_fit,
    test_sample_matches_jax_on_the_same_draws,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=CLASSES[2:])
def pair(request):
    return make_pair(request.param)
