"""Numeric policy of the port: IEEE f32 matmuls, jitter defaults, the default
device, tensor conversion.

Counterpart of stpy_tpu/config.py. The JAX package forces
``jax_default_matmul_precision="highest"`` because a GP is accuracy-critical;
the card's equivalent is to keep TF32 off for matmuls and convolutions, set
here when the package is imported. There is no global dtype flag: models and
kernels take an explicit ``device`` and ``dtype``, the dtype defaulting to
:func:`default_dtype`; a ``device`` left as None means the card
(:func:`resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# relative jitter added to Gram diagonals before Cholesky, scaled by the mean
# diagonal magnitude; f32 needs more than f64
_JITTER_F32 = 1e-6
_JITTER_F64 = 1e-12


def default_dtype() -> torch.dtype:
    """The float dtype the port's constructors default to: float32, what the
    JAX package's `default_dtype` gives with x64 off. Nothing switches it;
    a float64 model is built with ``dtype=torch.float64``."""
    return torch.float32


def default_jitter(dtype: torch.dtype | None = None) -> float:
    dtype = dtype or default_dtype()
    return _JITTER_F64 if dtype == torch.float64 else _JITTER_F32


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None. Raises when there is no CUDA
    device to default to: the CPU is used only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def as_tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """Convert array-like (tensor, numpy, anything with ``__array__``) to a
    tensor of `dtype` on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)
