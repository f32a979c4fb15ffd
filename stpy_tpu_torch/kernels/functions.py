"""The kernel catalogue: k(params, X, Y) -> (n_x, n_y), K[i, j] = k(X[i], Y[j]).

Port of stpy_tpu/kernels/functions.py: the distance primitives, every atom,
the additive (per-group) families and the SE closed-form derivatives, as
plain torch functions of a params dict, in any float dtype. `KernelFunction`
routes SE/ARD/Matérn ½-5/2 and Laplace to the hand Grams (ops/gram.py,
ops/gram_l1.py); everything here runs as torch ops.

Where the JAX function broadcasts an (n, m, d) or (n, m, F) tensor that XLA
fuses into its reduction, eager torch would materialise it. So the
per-feature kernels (`modified_matern`, `step`, `wiener`) accumulate one
feature at a time into an (n, m) buffer, `spectral` takes its mean of
cos(φ_i − ψ_j) as cos·cosᵀ + sin·sinᵀ, and `bessel_kv` scans its 384
trapezoid nodes in order into one buffer: at n = m = 16384 the JAX form's
(n, m, 384) tensor would be 3e11 bytes in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# distance primitives
# ---------------------------------------------------------------------------

def sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances, (n, m): one matmul plus rank-1
    norm corrections, clamped at 0 (stpy_tpu/kernels/functions.py:25-31)."""
    nx = torch.sum(x * x, dim=1)[:, None]
    ny = torch.sum(y * y, dim=1)[None, :]
    return torch.clamp(nx + ny - 2.0 * (x @ y.T), min=0.0)


def euclid_dist(x, y, eps=1e-36):
    return torch.sqrt(sq_dist(x, y) + eps)


def manhattan_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise L1 distances Σ_c |x_c − y_c|, (n, m)
    (stpy_tpu/kernels/functions.py:39-40)."""
    return torch.cdist(x, y, p=1)


def _sel(x, group):
    if group is None:
        return x
    return x[:, torch.as_tensor(group, device=x.device)]


def _gsel(g, group):
    """A per-dim parameter's entries for `group`."""
    if group is None:
        return g
    return g.reshape(-1)[torch.as_tensor(group, device=g.device)]


def _kappa(params):
    return params.get("kappa", 1.0)


def _per_feature(x, y, term):
    """Σ_c term(x[:, c, None], y[None, :, c]) accumulated feature by
    feature into one (n, m) buffer (no (n, m, d) tensor)."""
    acc = None
    for c in range(x.shape[1]):
        t = term(x[:, c, None], y[None, :, c])
        acc = t if acc is None else acc + t
    return acc


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def se_shape(sq: torch.Tensor) -> torch.Tensor:
    """Squared-exponential correlation of a squared scaled distance."""
    return torch.exp(-0.5 * sq)


def laplace_shape(d1: torch.Tensor) -> torch.Tensor:
    """Laplace correlation exp(−d1) of a scaled L1 distance
    d1 = ‖x − y‖₁/γ² (stpy_tpu/kernels/functions.py:71-75)."""
    return torch.exp(-d1)


def bessel_nodes(nu, T=24.0, n_quad=384):
    """The trapezoid nodes of `bessel_kv`: (cosh t_k, log cosh(ν t_k), w_k)
    as float64 numpy arrays, each formed as the JAX package forms it."""
    t = np.linspace(0.0, T, n_quad)
    w = np.full(n_quad, T / (n_quad - 1))
    w[0] *= 0.5
    w[-1] *= 0.5
    z = nu * t
    logcosh = np.abs(z) + np.log1p(np.exp(-2.0 * np.abs(z))) - math.log(2.0)
    return np.cosh(t), logcosh, w


def bessel_kv(nu, x, T=24.0, n_quad=384):
    """Modified Bessel K_ν(x), x > 0, by the trapezoid rule on
        K_ν(x) = ∫₀^∞ exp(−x cosh t) cosh(ν t) dt
    over [0, T] with `n_quad` nodes, in log space (exp(−x cosh t +
    log cosh(ν t))), as stpy_tpu/kernels/functions.py:78-119. The nodes are
    scanned in order and accumulated into one buffer of x's shape, so no
    (..., n_quad) tensor exists. Keep ν·T below the dtype's exp overflow
    (ν ≲ 3.5 in f32 with T = 24)."""
    cosh_t, logcosh, w = bessel_nodes(nu, T, n_quad)
    if x.requires_grad and torch.is_grad_enabled():
        acc = torch.zeros_like(x)
        for c, lc, wk in zip(cosh_t, logcosh, w):
            acc = acc + torch.exp(x * (-float(c)) + float(lc)) * float(wk)
        return acc
    acc = torch.zeros_like(x)
    tmp = torch.empty_like(x)
    for c, lc, wk in zip(cosh_t, logcosh, w):
        torch.mul(x, -float(c), out=tmp)
        tmp.add_(float(lc)).exp_()
        acc.add_(tmp, alpha=float(wk))
    return acc


def _matern_shape_general(dists, nu):
    """General-ν Matérn correlation 2^{1−ν}/Γ(ν) (√(2ν) r)^ν K_ν(√(2ν) r),
    exactly 1 where √(2ν) r < 1e-6, clipped to [0, 1]."""
    s = math.sqrt(2.0 * nu) * dists
    arg = torch.clamp(s, min=1e-6)
    const = 2.0 ** (1.0 - nu) / math.gamma(nu)
    val = const * arg ** nu * bessel_kv(nu, arg)
    val = torch.where(s < 1e-6, torch.ones_like(val), val)
    return torch.clamp(val, 0.0, 1.0)


def matern_shape(dists: torch.Tensor, nu: float) -> torch.Tensor:
    """Matérn correlation of a scaled distance: closed forms at ν ∈
    {½, 3/2, 5/2}, the quadrature K_ν otherwise."""
    if nu == 0.5:
        return torch.exp(-dists)
    if nu == 1.5:
        k = dists * math.sqrt(3.0)
        return (1.0 + k) * torch.exp(-k)
    if nu == 2.5:
        k = dists * math.sqrt(5.0)
        return (1.0 + k + k * k / 3.0) * torch.exp(-k)
    return _matern_shape_general(dists, nu)


# ---------------------------------------------------------------------------
# stationary kernels
# ---------------------------------------------------------------------------

def squared_exponential(params, x, y, group=None):
    """κ·exp(−‖x−y‖²/(2γ²))."""
    x, y = _sel(x, group), _sel(y, group)
    g = params["gamma"]
    return _kappa(params) * torch.exp((-0.5 / (g * g)) * sq_dist(x, y))


def ard(params, x, y, group=None):
    """SE with per-dimension lengthscales `ard_gamma`."""
    x, y = _sel(x, group), _sel(y, group)
    g = _gsel(params["ard_gamma"], group)
    return _kappa(params) * torch.exp(-0.5 * sq_dist(x / g, y / g))


def laplace(params, x, y, group=None):
    """κ·exp(−‖x−y‖₁/γ²)."""
    x, y = _sel(x, group), _sel(y, group)
    g = params["gamma"]
    return _kappa(params) * torch.exp(-manhattan_dist(x, y) / (g * g))


def matern(params, x, y, group=None, *, nu=1.5):
    """Isotropic Matérn, lengthscale `gamma`."""
    x, y = _sel(x, group), _sel(y, group)
    g = params["gamma"]
    return _kappa(params) * matern_shape(euclid_dist(x / g, y / g), nu)


def ard_matern(params, x, y, group=None, *, nu=1.5):
    """Matérn with per-dimension lengthscales."""
    x, y = _sel(x, group), _sel(y, group)
    g = _gsel(params["ard_gamma"], group)
    return _kappa(params) * matern_shape(euclid_dist(x / g, y / g), nu)


_MODIFIED = {
    1: lambda d: torch.exp(-d),
    2: lambda d: (1.0 + d) * torch.exp(-d),
    3: lambda d: (d ** 2 + 3.0 * d + 3.0) * torch.exp(-d) / 3.0,
    4: lambda d: (d ** 3 + 6.0 * d ** 2 + 15.0 * d + 15.0) * torch.exp(-d)
    / 15.0,
}


def modified_matern(params, x, y, group=None, *, nu=2):
    """Product over dims of 1-D Matérn-like shapes (integer ν 1..4)."""
    if nu not in _MODIFIED:
        raise NotImplementedError(f"modified_matern nu={nu}")
    x, y = _sel(x, group), _sel(y, group)
    g = params["gamma"]
    shape = _MODIFIED[nu]
    K = None
    for c in range(x.shape[1]):
        t = shape(torch.abs(x[:, c, None] - y[None, :, c]) / g)
        K = t if K is None else K * t
    return _kappa(params) * K


def covar_se(params, x, y, group=None):
    """Full-covariance SE: inputs mapped through the square-root covariance
    `cov`."""
    x, y = _sel(x, group), _sel(y, group)
    C = params["cov"]
    return _kappa(params) * torch.exp(-0.5 * sq_dist(x @ C, y @ C))


def covar_matern(params, x, y, group=None, *, nu=1.5):
    """Full-covariance Matérn."""
    x, y = _sel(x, group), _sel(y, group)
    C = params["cov"]
    return _kappa(params) * matern_shape(euclid_dist(x @ C, y @ C), nu)


def gibbs(params, x, y, group=None, *, gamma_fun=None):
    """Input-dependent lengthscale: l(x)² + l(y)² in the denominator."""
    x, y = _sel(x, group), _sel(y, group)
    lx = gamma_fun(x).reshape(-1, 1)
    ly = gamma_fun(y).reshape(-1, 1)
    ls = lx ** 2 + ly.T ** 2
    return _kappa(params) * torch.exp(-0.5 * sq_dist(x, y) / ls)


def gibbs_custom(params, x, y, group=None, *, gamma_fun=None):
    """Lengthscale matrix given directly by gamma_fun(x, y)."""
    x, y = _sel(x, group), _sel(y, group)
    ls = gamma_fun(x, y)
    return _kappa(params) * torch.exp(-0.5 * sq_dist(x, y) / ls)


# ---------------------------------------------------------------------------
# dot-product / non-stationary kernels
# ---------------------------------------------------------------------------

def linear(params, x, y, group=None):
    """κ·x·y + offset."""
    x, y = _sel(x, group), _sel(y, group)
    return _kappa(params) * (x @ y.T) + params.get("offset", 0.0)


def polynomial(params, x, y, group=None, *, degree=2):
    """κ·(x·y + 1)^degree."""
    x, y = _sel(x, group), _sel(y, group)
    return _kappa(params) * (x @ y.T + 1.0) ** degree


def tanh_kernel(params, x, y, group=None, *, q=3, eps=1e-9):
    """tanh(d)^q/d^q of the Manhattan distance d."""
    x, y = _sel(x, group), _sel(y, group)
    K = manhattan_dist(x, y)
    return _kappa(params) * (torch.tanh(K) ** q) / (eps + K ** q)


def step(params, x, y, group=None):
    """Σ_k (x_k + y_k − |x_k − y_k|) = 2 Σ_k min(x_k, y_k)."""
    x, y = _sel(x, group), _sel(y, group)
    return _kappa(params) * _per_feature(
        x, y, lambda a, b: a + b - torch.abs(a - b))


def wiener(params, x, y, group=None):
    """Σ_k min(x_k, y_k)."""
    x, y = _sel(x, group), _sel(y, group)
    return _kappa(params) * _per_feature(x, y, torch.minimum)


def angsim(params, x, y, group=None):
    """Angular similarity (2/π)·asin(cosine similarity)."""
    x, y = _sel(x, group), _sel(y, group)
    nx = torch.linalg.vector_norm(x, dim=1)[:, None]
    ny = torch.linalg.vector_norm(y, dim=1)[None, :]
    c = torch.clamp((x @ y.T) / (nx * ny), -1.0, 1.0)
    return _kappa(params) * (2.0 / math.pi) * torch.asin(c)


def spectral(params, x, y, group=None):
    """Mean over fixed frequencies `freq` (F, d) of cos((x − y)·f), as
    (cos(xf)·cos(yf)ᵀ + sin(xf)·sin(yf)ᵀ)/F."""
    x, y = _sel(x, group), _sel(y, group)
    freq = params["freq"]
    px, py = x @ freq.T, y @ freq.T            # (n, F), (m, F)
    return (torch.cos(px) @ torch.cos(py).T
            + torch.sin(px) @ torch.sin(py).T) / freq.shape[0]


def custom_map(params, x, y, group=None, *, map_fn=None):
    """Linear kernel in a feature map."""
    x, y = _sel(x, group), _sel(y, group)
    if map_fn is not None:
        x, y = map_fn(x), map_fn(y)
    return _kappa(params) * (x @ y.T)


# ---------------------------------------------------------------------------
# additive (per-group) kernels
# ---------------------------------------------------------------------------

def squared_exponential_per_group_additive(params, x, y, groups=None):
    """Mean over groups of SE with a lengthscale per group
    (`gamma_per_group`)."""
    gs = params["gamma_per_group"]
    acc = 0.0
    for i, group in enumerate(groups):
        acc = acc + squared_exponential({"gamma": gs[i]}, x, y, group=group)
    return _kappa(params) * acc / float(len(groups))


def ard_per_group_additive(params, x, y, groups=None):
    """Mean over groups of ARD with lengthscale segments packed by group in
    `ard_per_group`."""
    g_all = params["ard_per_group"]
    acc = 0.0
    idx = 0
    for group in groups:
        seg = g_all[idx:idx + len(group)]
        idx += len(group)
        xs, ys = _sel(x, group), _sel(y, group)
        acc = acc + torch.exp(-0.5 * sq_dist(xs / seg, ys / seg))
    return _kappa(params) * acc / float(len(groups))


def ard_additive(params, x, y, groups=None):
    """Mean over groups of ARD sharing one `ard_gamma`."""
    acc = 0.0
    for group in groups:
        acc = acc + ard(params, x, y, group=group)
    return acc / float(len(groups))


def polynomial_additive(params, x, y, groups=None, *, degree=2):
    """Mean over groups of polynomial kernels."""
    acc = 0.0
    for group in groups:
        acc = acc + polynomial(params, x, y, group=group, degree=degree)
    return acc / float(len(groups))


# ---------------------------------------------------------------------------
# closed-form derivatives of the SE kernel
# ---------------------------------------------------------------------------

def squared_exponential_derivative_1(params, fixed, x):
    """d/dx k(fixed_i, x_j): (n_fixed, n_x, d)."""
    g2 = params["gamma"] ** 2
    K = squared_exponential(params, fixed, x)
    diff = (fixed[:, None, :] - x[None, :, :]) / g2
    return K[:, :, None] * diff


def squared_exponential_derivative_2(params, fixed, x):
    """Second derivative tensor, (n_fixed, n_x, d, d)."""
    g2 = params["gamma"] ** 2
    K = squared_exponential(params, fixed, x)
    diff = (fixed[:, None, :] - x[None, :, :]) / g2
    outer = diff[..., :, None] * diff[..., None, :]
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device) / g2
    return K[:, :, None, None] * (outer - eye)
