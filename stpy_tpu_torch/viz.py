"""Plotting mixin for the estimators: the port of stpy_tpu/viz.py.

Any estimator with `mean_std(xtest)` (and `mean_gradient_hessian` for the
quiver plot) can mix in `RandomProcess`, as the port's `GaussianProcess`,
`KernelizedFeatures` and `OnlineGP` do. It is host-side matplotlib, which
each method imports when called, so the package imports without it.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(v):
    """A tensor or array-like as a host numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class RandomProcess:
    def visualize(self, xtest, f_true=None, points=True, show=True, size=2,
                  norm=1, fig=True, sqrtbeta=2, constrained=None, fill=True,
                  color=None, label=""):
        import matplotlib.pyplot as plt

        xtest = _np(xtest)
        d = xtest.shape[1]
        mu, std = self.mean_std(xtest)
        mu = _np(mu).ravel()
        std = _np(std).ravel() if std is not None else None
        if d == 1:
            if fig:
                plt.figure(figsize=(12, 6))
            plt.plot(xtest[:, 0], mu, lw=2, color=color or "C0",
                     label=label + " mean")
            if std is not None and fill:
                plt.fill_between(
                    xtest[:, 0], mu - sqrtbeta * std, mu + sqrtbeta * std,
                    alpha=0.25, color=color or "C0",
                )
            if f_true is not None:
                plt.plot(xtest[:, 0], _np(f_true(xtest)).ravel(), "k--",
                         lw=1.5, label="truth")
            if points and getattr(self, "x", None) is not None:
                plt.plot(_np(self.x)[:, 0], _np(self.y).ravel(), "ro", ms=5,
                         label="data")
            plt.legend()
            if show:
                plt.show()
        elif d == 2:
            from scipy.interpolate import griddata

            if fig:
                plt.figure(figsize=(10, 7))
            ax = plt.axes(projection="3d")
            xx, yy = xtest[:, 0], xtest[:, 1]
            gx, gy = np.mgrid[xx.min():xx.max():100j, yy.min():yy.max():100j]
            gz = griddata((xx, yy), mu, (gx, gy), method="linear")
            ax.plot_surface(gx, gy, gz, alpha=0.5)
            if points and getattr(self, "x", None) is not None:
                ax.scatter(_np(self.x)[:, 0], _np(self.x)[:, 1],
                           _np(self.y).ravel(), c="r")
            if show:
                plt.show()
        else:
            raise NotImplementedError("visualize supports d <= 2")

    def visualize_contour(self, xtest, f_true=None, show=True, levels=20):
        import matplotlib.pyplot as plt
        from scipy.interpolate import griddata

        xtest = _np(xtest)
        mu = _np(self.mean_std(xtest)[0]).ravel()
        xx, yy = xtest[:, 0], xtest[:, 1]
        gx, gy = np.mgrid[xx.min():xx.max():100j, yy.min():yy.max():100j]
        gz = griddata((xx, yy), mu, (gx, gy), method="linear")
        plt.contourf(gx, gy, gz, levels=levels)
        plt.colorbar()
        if getattr(self, "x", None) is not None:
            plt.plot(_np(self.x)[:, 0], _np(self.x)[:, 1], "r.")
        if show:
            plt.show()

    def visualize_function(self, xtest, f, show=True, **kwargs):
        import matplotlib.pyplot as plt

        xtest = _np(xtest)
        plt.plot(xtest[:, 0], _np(f(xtest)).ravel(), **kwargs)
        if show:
            plt.show()

    def visualize_quiver(self, xtest, show=True):
        import matplotlib.pyplot as plt

        xtest = _np(xtest)
        grads = np.stack([_np(self.mean_gradient_hessian(xtest[i])).ravel()
                          for i in range(xtest.shape[0])])
        plt.quiver(xtest[:, 0], xtest[:, 1], grads[:, 0], grads[:, 1])
        if show:
            plt.show()
