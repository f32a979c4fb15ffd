"""Point processes (port of stpy_tpu/point_processes): the Poisson process
simulator, the rate-estimator data model and `PoissonRateEstimator`. The
rest of the stack (binomial, link, log-linear, MBR and permanental
estimators) comes with ROADMAP Queue 1 item 9."""

from stpy_tpu_torch.point_processes.poisson import (
    PoissonPointProcess,
    SeasonalPoissonPointProcess,
)
from stpy_tpu_torch.point_processes.poisson_rate_estimator import (
    PoissonRateEstimator,
)
from stpy_tpu_torch.point_processes.rate_estimator import RateEstimator

__all__ = ["PoissonPointProcess", "PoissonRateEstimator", "RateEstimator",
           "SeasonalPoissonPointProcess"]
