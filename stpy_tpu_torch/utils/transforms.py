"""Data transforms: the port of stpy_tpu/utils/transforms.py.

The affine box map and the uncertainty-weighted R² run in torch on the
card (or `device`); the Haar and Haar-Fisz transforms are host numpy, as
in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device


def transform(X, low=-1.0, high=1.0, functions=True, offsets=None,
              device=None, dtype=torch.float32):
    """Affine map of the columns of X onto [low, high]; (Xt, fwd, inv)
    when `functions`, else Xt."""
    dev = resolve_device(device)

    def t(v):
        return as_tensor(v, device=dev, dtype=dtype)

    X = t(X)
    mins = torch.min(X, dim=0).values
    maxs = torch.max(X, dim=0).values
    if offsets is not None:
        mins = mins - t(offsets)
        maxs = maxs + t(offsets)
    span = torch.where(maxs - mins < 1e-12, torch.ones_like(mins), maxs - mins)

    def fwd(Z):
        return low + (t(Z) - mins) / span * (high - low)

    def inv(Z):
        return mins + (t(Z) - low) / (high - low) * span

    if functions:
        return fwd(X), fwd, inv
    return fwd(X)


def haar_coefficients(f, interval, level):
    """Haar coefficients of f on `interval` up to `level`: (scaling
    coefficient, detail coefficients by level, coarsest first)."""
    a, b = interval
    n = 2**level
    xs = np.linspace(a, b, n, endpoint=False) + (b - a) / (2 * n)
    vals = np.asarray(f(xs.reshape(-1, 1))).ravel()
    details = []
    cur = vals
    for _ in range(level):
        evens, odds = cur[0::2], cur[1::2]
        details.append((evens - odds) / 2.0)
        cur = (evens + odds) / 2.0
    return vals.mean(), details[::-1]


def haarval(scaling, details, x, interval):
    """Evaluate a Haar expansion at the points x."""
    a, b = interval
    x = np.asarray(x).ravel()
    out = np.full_like(x, scaling, dtype=float)
    for det in details:
        n = len(det)
        idx = np.clip(((x - a) / (b - a) * n).astype(int), 0, n - 1)
        frac = (x - a) / (b - a) * n - idx
        sign = np.where(frac < 0.5, 1.0, -1.0)
        out = out + sign * det[idx]
    return out


def haar_fisz_transform(data):
    """Variance-stabilising Haar-Fisz transform of Poisson-like counts;
    the length must be a power of two."""
    v = np.asarray(data, dtype=float).copy()
    n = len(v)
    J = int(np.log2(n))
    assert 2**J == n, "length must be a power of 2"
    sm = [v]
    dt = []
    for _ in range(J):
        cur = sm[-1]
        s = (cur[0::2] + cur[1::2]) / 2.0
        d = (cur[0::2] - cur[1::2]) / 2.0
        f = np.where(s > 0, d / np.sqrt(np.where(s > 0, s, 1.0)), 0.0)
        sm.append(s)
        dt.append(f)
    out = sm[-1]
    for f in reversed(dt):
        up = np.empty(2 * len(out))
        up[0::2] = out + f
        up[1::2] = out - f
        out = up
    return out


def inverse_haar_fisz_transform(data):
    """Inverse of `haar_fisz_transform`."""
    u = np.asarray(data, dtype=float).copy()
    n = len(u)
    J = int(np.log2(n))
    sm = [u]
    ft = []
    for _ in range(J):
        cur = sm[-1]
        s = (cur[0::2] + cur[1::2]) / 2.0
        f = (cur[0::2] - cur[1::2]) / 2.0
        sm.append(s)
        ft.append(f)
    out = sm[-1]
    for f in reversed(ft):
        d = f * np.sqrt(np.maximum(out, 0.0))
        up = np.empty(2 * len(out))
        up[0::2] = out + d
        up[1::2] = out - d
        out = up
    return out


def r_score_std(y_true, y_pred, std, alpha=1.0, device=None,
                dtype=torch.float32):
    """Uncertainty-weighted R²: 1 − Σw(y − ŷ)² / Σw(y − ȳ)², w = 1/(σ² + α)."""
    dev = resolve_device(device)
    y_true, y_pred, std = (as_tensor(v, device=dev, dtype=dtype).reshape(-1)
                           for v in (y_true, y_pred, std))
    w = 1.0 / (std**2 + alpha)
    ss_res = torch.sum(w * (y_true - y_pred) ** 2)
    ss_tot = torch.sum(w * (y_true - torch.mean(y_true)) ** 2)
    return float(1.0 - ss_res / torch.clamp(ss_tot, min=1e-30))
