"""Carry hyperparameters and fitted state (exact GP, iterative GP, online
GP, embeddings, feature GPs, Nyström features, positive bases, Poisson,
link, log-linear, MBR and Bernoulli rate estimators) from the JAX package
to the port.

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


def load_kernel_params(kernel_port, params_dict_numpy):
    """Overwrite a port kernel's hyperparameters with a JAX kernel's
    (`params_dict`, as numpy), e.g. a fitted full-covariance `cov`; they
    stay float64 on the kernel's device."""
    for idx, p in params_from_jax(params_dict_numpy,
                                  device=kernel_port.device).items():
        kernel_port.params_dict[idx].update(p)
    return kernel_port


def load_estimator_arrays(est_port, **arrays):
    """Set named arrays of a fitted JAX estimator on a port one loaded with
    the same data, each as a tensor of the estimator's dtype on its device
    in its own shape: e.g. a link estimator's `rate`, `W`, `W_inv_approx`
    or `sampled_theta`, an MBR estimator's (m, m) `rate`, a Bernoulli
    estimator's `rate`. The ellipsoid cache is marked stale where `W` or
    `rate` changes."""
    for name, value in arrays.items():
        setattr(est_port, name, as_tensor(np.asarray(value),
                                          device=est_port.device,
                                          dtype=est_port.dtype))
    if {"rate", "W"} & set(arrays):
        est_port.approx_fit = False
    return est_port


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


def load_online_state(og_port, x_buf, y_buf, L, alpha, count):
    """Load a JAX `OnlineGP`'s state (its capacity-padded buffers, the
    block-diag(L_active, I) factor, alpha and the count) into a port
    `OnlineGP` of the same capacity, written into the port's own buffers
    so that they stay where they were allocated."""
    for dst, src in ((og_port.x_buf, x_buf), (og_port.y_buf, y_buf),
                     (og_port.L, L), (og_port.alpha, alpha)):
        src = as_tensor(src, device=og_port.device, dtype=og_port.dtype)
        dst.copy_(src.reshape(dst.shape))
    og_port.count = int(count)
    return og_port


def load_embedding_state(emb_port, W=None, weights=None, kappa=None, m=None,
                         W1=None, W2=None, W_mid=None):
    """Load an embedding's random or quadrature state into a port
    embedding: the frequencies W (m/2, d), their weights, κ and m of a trig
    embedding (`RFFEmbedding`, `QuadratureEmbedding` and its subclasses),
    or W1, W2 (and `RandomNestedMap`'s W_mid) of a `RandomMap`. Arguments
    left None keep the port's own value."""
    def t(a):
        return as_tensor(a, device=emb_port.device, dtype=emb_port.dtype)

    for name, value in (("W", W), ("weights", weights), ("W1", W1),
                        ("W2", W2), ("W_mid", W_mid)):
        if value is not None:
            setattr(emb_port, name, t(value))
    if kappa is not None:
        emb_port.kappa = float(kappa)
    if m is not None:
        emb_port.m = int(m)
    return emb_port


def load_feature_state(f_port, x, y, Q=None, V=None, invV=None, K=None,
                       invK=None, invK_V=None, Qty=None):
    """Load a fitted JAX `KernelizedFeatures`' state into a port one: the
    data and either the primal state (Q, V, invV), the dual state (Q, K,
    invK, invK_V), or a streamed fit's (V, invV and Qᵀy, with Q None), so
    that `mean_std` and `sample` run on the JAX fit's own matrices."""
    def t(a):
        return None if a is None else as_tensor(a, device=f_port.device,
                                                dtype=f_port.dtype)

    f_port.x = t(x)
    f_port.y = t(y).reshape(-1, 1)
    f_port.n, f_port.d = f_port.x.shape
    f_port.dual = invK is not None
    f_port.Q, f_port.V, f_port.invV = t(Q), t(V), t(invV)
    f_port.K, f_port.invK, f_port.invK_V = t(K), t(invK), t(invK_V)
    f_port._Qty = None if Qty is None else t(Qty).reshape(-1, 1)
    f_port.to_add = []
    f_port.data = f_port.fitted = True
    return f_port


def load_nystrom_state(nf_port, x, y, C, xs, Wmat, L, theta):
    """Load a fitted JAX `NystromFeatures`' landmark state (the landmark
    indices C and points xs, the map Wmat, the Cholesky factor L of
    ΦᵀΦ + s²I and θ) into a port one, so that `embed`, `mean_std` and
    `sample_theta` run on the JAX fit's landmarks and factor."""
    def t(a):
        return as_tensor(a, device=nf_port.device, dtype=nf_port.dtype)

    nf_port.x = t(x)
    nf_port.y = t(y).reshape(-1, 1)
    nf_port.N, nf_port.d = nf_port.x.shape
    nf_port.C = torch.tensor(np.array(C), device=nf_port.device)
    nf_port._xs, nf_port._Wmat = t(xs), t(Wmat)
    ko, xs_, W_ = nf_port.kernel_object, nf_port._xs, nf_port._Wmat
    nf_port._embed = lambda q: ko.cross(q, xs_) @ W_
    nf_port._L, nf_port._theta = t(L), t(theta).reshape(-1, 1)
    nf_port.fitted = True
    return nf_port


def load_positive_embedding_state(emb_port, Gamma_half, invGamma_half,
                                  grid=None, basis=None):
    """Load a JAX positive basis's Γ^{1/2} and its pseudo-inverse into a port
    one (its `cov()` then returns them) and, for a
    `PositiveNystromEmbeddingBump`, its 1-D basis: the values `basis`
    (N, m) on the ascending points `grid` (N,), interpolated linearly as
    the JAX package's "positive_svd" map does. The cached integrals are
    dropped."""
    from stpy_tpu_torch.embeddings.nystrom import _interp_columns

    def t(a):
        return as_tensor(a, device=emb_port.device, dtype=emb_port.dtype)

    emb_port.Gamma_half, emb_port.invGamma_half = t(Gamma_half), t(invGamma_half)
    emb_port.precomp = True
    emb_port.procomp_integrals = {}
    if grid is not None:
        xg, bg = t(grid).reshape(-1), t(basis)
        emb_port.GP._embed = lambda q: _interp_columns(
            t(q).reshape(-1, 1)[:, 0].contiguous(), xg, bg)
    return emb_port


def load_rate_estimator_state(est_port, rate=None, W=None, phis=None,
                              counts=None, observations=None,
                              obs_multiplicities=None, loglikelihood=None):
    """Load a JAX `PoissonRateEstimator`'s fitted state into a port one
    loaded with the same rounds: the rate θ, the covariance W, the running
    log-likelihood and the data arrays (phis, counts, the embedded
    observations and their multiplicities; the JAX package's rows past
    the port's own counts, its power-of-two padding, are dropped), so that
    the covariances, bounds and conformal sets run on the JAX fit. Arguments
    left None keep the port's own value."""
    def t(a):
        return as_tensor(a, device=est_port.device, dtype=est_port.dtype)

    if rate is not None:
        est_port.rate = t(rate).reshape(-1)
    if W is not None:
        est_port.W = t(W)
    for name, value in (("phis", phis), ("counts", counts),
                        ("observations", observations),
                        ("obs_multiplicities", obs_multiplicities)):
        if value is not None:
            own = getattr(est_port, name)
            rows = own.shape[0] if own is not None else np.asarray(value).shape[0]
            setattr(est_port, name, t(np.asarray(value)[:rows]))
    if loglikelihood is not None:
        est_port.loglikelihood = float(loglikelihood)
    return est_port
