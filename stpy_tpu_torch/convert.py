"""Carry hyperparameters and fitted state (exact GP, iterative GP) from the
JAX package to the port.

Inputs are numpy arrays (or anything with ``__array__``, such as a JAX
array); nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor


def params_from_jax(params_dict_numpy, device=None, dtype=torch.float64):
    """The port's params_dict from a JAX `KernelFunction.params_dict`
    ({"0": {"gamma": …, "kappa": …, "ard_gamma": …}, …}). Hyperparameters
    stay float64 by default, as the port stores them."""
    return {
        idx: {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
              for k, v in p.items()}
        for idx, p in params_dict_numpy.items()
    }


def load_fitted_state(gp_port, x, y, L, A, A_df=None, df_train=None):
    """Load a fitted JAX GP's state (data, Cholesky factor, alpha, for
    ``precision="double"`` the (n, 2) df alpha pair and, with
    ``var_refine``, the train df Gram pair ``_df_train``) into a port
    `GaussianProcess`, so that `mean_std` runs on the same factor. Tensors
    go to the GP's device and dtype."""
    def t(a):
        return as_tensor(a, device=gp_port.device, dtype=gp_port.dtype)

    gp_port.x = t(x)
    gp_port.y = t(y).reshape(-1, 1)
    gp_port.n, gp_port.d = gp_port.x.shape
    gp_port.L = t(L)
    if gp_port._precision == "double":
        if A_df is None:
            raise ValueError("precision='double' needs the (n, 2) A_df pair")
        gp_port._A_df = t(A_df)
        gp_port.A = gp_port._A_df[:, :1]
        if gp_port._var_refine:
            if df_train is None:
                raise ValueError("var_refine needs the (Kh, Kl) df_train pair")
            gp_port._df_train = tuple(t(k) for k in df_train)
    else:
        gp_port.A = t(A).reshape(-1, 1)
    gp_port.fitted = True
    return gp_port


def load_iterative_state(gp_port, x, y, A, A_df=None):
    """Load a fitted JAX `IterativeGP`'s state (data, alpha and, for
    ``precision="double"``, the (n, 2) df alpha pair ``_A_df``) into a port
    `parallel.IterativeGP`, so that `mean` serves the same alpha without a
    refit. The CG operators (matvec, block matmat and, on the lazy tier, the
    preconditioner) are rebuilt from x for `mean_std`'s variance solves;
    the CG statistics of the JAX fit are not carried, so ``fit_status`` is
    None. Tensors go to the GP's device and dtype."""
    def t(a):
        return as_tensor(a, device=gp_port.device, dtype=gp_port.dtype)

    gp_port.x = t(x)
    gp_port.y = t(y).reshape(-1, 1)
    gp_port.n = gp_port.x.shape[0]
    if gp_port.precision == "double":
        if A_df is None:
            raise ValueError("precision='double' needs the (n, 2) A_df pair")
        gp_port._A_df = t(A_df)
        gp_port.A = gp_port._A_df[:, :1]
    else:
        gp_port._A_df = None
        gp_port.A = t(A).reshape(-1, 1)
    gp_port._matvec, gp_port._M_inv = gp_port._matvec_factory(gp_port.x)
    gp_port.fit_status = None
    gp_port.fitted = True
    return gp_port
