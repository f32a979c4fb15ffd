"""Host-side grid helpers: the port's own copy of what it needs from
stpy_tpu/utils/helper.py (numpy only)."""

from __future__ import annotations

import numpy as np


def cartesian(arrays) -> np.ndarray:
    """Cartesian product of 1-D arrays, shape (prod(len_i), d), first array
    varying slowest (stpy_tpu/utils/helper.py:16-24)."""
    arrays = [np.asarray(a).ravel() for a in arrays]
    grids = np.meshgrid(*arrays, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)
