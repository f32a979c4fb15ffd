from stpy_tpu_torch.models.estimator import Estimator
from stpy_tpu_torch.models.exact_gp import GaussianProcess
from stpy_tpu_torch.models.feature_gp import KernelizedFeatures
from stpy_tpu_torch.models.fourier_gp import GaussianProcessFF, sample_embedding
from stpy_tpu_torch.models.online_gp import OnlineGP
from stpy_tpu_torch.models.truncated_features import (
    TruncatedKernelizedFeatures,
)

__all__ = ["Estimator", "GaussianProcess", "GaussianProcessFF",
           "KernelizedFeatures", "OnlineGP", "TruncatedKernelizedFeatures",
           "sample_embedding"]
