"""Point processes (port of stpy_tpu/point_processes): the Poisson process
simulator, the rate-estimator data model, `PoissonRateEstimator`, the link
(permanental, logistic, exp, sigmoidal), log-linear and MBR estimators, and
the Bernoulli process with its two estimators."""

from stpy_tpu_torch.point_processes.binomial import (
    BernoulliPointProcess,
    BernoulliRateEstimator,
    LinkBernoulliRateEstimator,
)
from stpy_tpu_torch.point_processes.link_estimators import (
    ExpGaussProcessRateEstimator,
    LogGaussProcessRateEstimator,
    LogisticGaussProcessRateEstimator,
    PermanentalProcessRateEstimator,
)
from stpy_tpu_torch.point_processes.loglinear import LogLinearRateEstimator
from stpy_tpu_torch.point_processes.mbr_estimator import MBRPositiveEstimator
from stpy_tpu_torch.point_processes.poisson import (
    PoissonPointProcess,
    SeasonalPoissonPointProcess,
)
from stpy_tpu_torch.point_processes.poisson_rate_estimator import (
    PoissonRateEstimator,
)
from stpy_tpu_torch.point_processes.rate_estimator import RateEstimator

__all__ = ["BernoulliPointProcess", "BernoulliRateEstimator",
           "ExpGaussProcessRateEstimator", "LinkBernoulliRateEstimator",
           "LogGaussProcessRateEstimator", "LogLinearRateEstimator",
           "LogisticGaussProcessRateEstimator", "MBRPositiveEstimator",
           "PermanentalProcessRateEstimator", "PoissonPointProcess",
           "PoissonRateEstimator", "RateEstimator",
           "SeasonalPoissonPointProcess"]
