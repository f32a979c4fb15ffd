from stpy_tpu_torch.models.estimator import Estimator
from stpy_tpu_torch.models.exact_gp import GaussianProcess

__all__ = ["Estimator", "GaussianProcess"]
