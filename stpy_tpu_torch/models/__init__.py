from stpy_tpu_torch.models.estimator import Estimator
from stpy_tpu_torch.models.exact_gp import GaussianProcess
from stpy_tpu_torch.models.online_gp import OnlineGP

__all__ = ["Estimator", "GaussianProcess", "OnlineGP"]
