"""Likelihoods and noise models (port of stpy_tpu/probability)."""

from stpy_tpu_torch.probability.likelihoods import (
    Likelihood,
    GaussianLikelihood,
    PoissonLikelihoodCanonical,
    BernoulliLikelihoodCanonical,
    LaplaceLikelihood,
    HuberLikelihood,
    WeibullLikelihoodCanonical,
    RobustGraphicalLikelihood,
    EllipsoidSet,
    LRSet,
)
from stpy_tpu_torch.probability.noise_models import (
    NoiseModel,
    GaussianNoise,
    LaplaceNoise,
    HuberContaminatedNoise,
    BoundedNoise,
    MisspecifiedGaussianNoise,
    GumbelNoise,
    TwoSidedWeibullNoise,
    BernoulliNoise,
    PoissonNoise,
    LogWeibullNoise,
)

# reference-compat alias: the reference spells it "Weilbull"
WeilbullLikelihoodCanonical = WeibullLikelihoodCanonical
