"""Helpers of the port (counterpart of stpy_tpu/utils)."""

from stpy_tpu_torch.utils.helper import (
    cartesian,
    interval,
    interval_grid,
    logdet,
    symsqrt,
)

__all__ = ["cartesian", "interval", "interval_grid", "logdet", "symsqrt"]
