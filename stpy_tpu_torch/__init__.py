"""stpy_tpu_torch — the PyTorch / CUDA port of stpy_tpu for NVIDIA Hopper.

Mirrors the layout of the JAX package `stpy_tpu` (config.py, configs.py,
kernels/, ops/, linalg.py, embeddings/, models/, parallel/, ...) and its
top-level exports; `default_dtype` is the dtype its constructors default to
(float32), since the port has no global dtype switch.
Hand-written CUDA kernels live in csrc/ and are built on first use by
_build.py; importing the package builds nothing.
"""

__version__ = "0.1.0"

from stpy_tpu_torch.config import default_dtype, default_jitter
from stpy_tpu_torch.configs import GPConfig, KernelConfig, PoissonRateConfig
from stpy_tpu_torch.domains import (
    BallSet,
    BorelSet,
    CandidateSet,
    HierarchicalBorelSets,
)
from stpy_tpu_torch.kernels import KernelFunction
from stpy_tpu_torch.models import GaussianProcess, KernelizedFeatures

__all__ = ["BallSet", "BorelSet", "CandidateSet", "GPConfig",
           "GaussianProcess", "HierarchicalBorelSets", "KernelConfig",
           "KernelFunction", "KernelizedFeatures", "PoissonRateConfig",
           "default_dtype", "default_jitter"]
