from stpy_tpu_torch.models.convex_rkhs import ConvexRKHS
from stpy_tpu_torch.models.estimator import Estimator
from stpy_tpu_torch.models.exact_gp import GaussianProcess
from stpy_tpu_torch.models.feature_gp import KernelizedFeatures
from stpy_tpu_torch.models.fourier_gp import GaussianProcessFF, sample_embedding
from stpy_tpu_torch.models.gamma_process import GammaContProcess
from stpy_tpu_torch.models.mixtures import CategoricalMixture, DirichletMixture
from stpy_tpu_torch.models.mkl import MKL, MultipleKernelLearner, PrimalMKL
from stpy_tpu_torch.models.online_gp import OnlineGP
from stpy_tpu_torch.models.trace_features import TraceFeatures
from stpy_tpu_torch.models.truncated_features import (
    TruncatedKernelizedFeatures,
)

__all__ = ["CategoricalMixture", "ConvexRKHS", "DirichletMixture",
           "Estimator", "GammaContProcess", "GaussianProcess",
           "GaussianProcessFF", "KernelizedFeatures", "MKL",
           "MultipleKernelLearner", "OnlineGP", "PrimalMKL", "TraceFeatures",
           "TruncatedKernelizedFeatures", "sample_embedding"]
