"""Estimator base class: data loading, the log evidence and the generic
hyperparameter fit.

Port of stpy_tpu/models/estimator.py (`fit`, `ucb`, `lcb`, `load_data`,
`log_marginal`, `log_marginal_params`, `optimize_params_general` and
`load_params`). Positive hyperparameters (lengthscales, noise, κ) are
optimised in log space and finite boxes through a sigmoid bijector, as
there. The evidence is factored in float64 whatever the model's dtype
(`negative_log_evidence`).

The JAX package runs all restarts as one `vmap`ped program; here they run
one after another (`torch.func.vmap` cannot batch a kernel launch, and the
restarts are independent). Random inits come from a `torch.Generator`
seeded 13 (the JAX package's `PRNGKey(13)`), so restart 0 (the warm start)
and inits from a callable are the JAX package's, and random ones are drawn
from another stream.
"""

from __future__ import annotations

import pickle
from abc import ABC, abstractmethod

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor
from stpy_tpu_torch.linalg import chol_jittered, cho_solve, logdet_from_chol
from stpy_tpu_torch.opt.lbfgs import (
    make_box_bijector,
    make_positive_bijector,
    minimize_lbfgs,
    minimize_newton_small,
)
from stpy_tpu_torch.opt.scalar import golden_section

# hyperparameters that must stay positive → log-space optimization
_POSITIVE_PARAMS = {
    "gamma", "ard_gamma", "kappa", "sigma", "gamma_per_group", "ard_per_group",
}
# the memory budgets of the route rule (stpy_tpu/models/estimator.py:248-271),
# set for a 16 GB TPU: restarts per batch, and the batched line search's
# candidates, each within ~2 GB
_BATCH_BYTES = 2e9
_LINESEARCH_CANDIDATES = 12


def negative_log_evidence(K, y, s, weight=1.0):
    """−log p(y) up to constants of a Gaussian likelihood with noise s on
    the Gram K, in K's dtype: ½yᵀ(K + s²I)⁻¹y + ½·weight·log det, by a
    fixed-jitter differentiable Cholesky (the fit needs reverse mode).

    The port's evidence (`Estimator.log_marginal_params`) calls it on the
    Gram promoted to float64, whatever the model's dtype. Factored in f32,
    as the JAX package runs it on a TPU (which has no FP64), K + s²I's
    conditioning (up to ~n/s²) biases the evidence gradient: on config 1's
    data on an H100 by −0.27 to −0.57 in log γ near the optimum, where the
    float64 gradient runs from −0.24 to 0.25, and the fit stops 4.6e-3
    from the float64 γ; factored in float64, the f32 Gram's rounding leaves
    ±0.12 and the fit 1.12e-4 (tools/evidence_dtype.py)."""
    n = K.shape[0]
    K = 0.5 * (K + K.T) + torch.eye(n, dtype=K.dtype, device=K.device) * (
        s * s)
    L = chol_jittered(K)
    alpha = cho_solve(L, y)
    logdet = -0.5 * logdet_from_chol(L) * weight
    return -(-0.5 * (y.T @ alpha)[0, 0] + logdet)


class Estimator(ABC):
    x = None
    y = None
    s = 0.001
    device = torch.device("cpu")
    dtype = torch.float32

    def fit(self):
        raise NotImplementedError("subclasses implement fit()")

    @abstractmethod
    def ucb(self, x):
        ...

    @abstractmethod
    def lcb(self, x):
        ...

    def load_data(self, d):
        self.x = as_tensor(d[0], device=self.device, dtype=self.dtype)
        self.y = as_tensor(d[1], device=self.device,
                           dtype=self.dtype).reshape(-1, 1)

    # -- evidence --------------------------------------------------------------
    def log_marginal(self, kernel, X, weight=1.0):
        """Negative log evidence −log p(y | X-params) up to constants, under
        a Gaussian likelihood (constant term omitted, as the reference).
        Whatever a GP's tier, it is evaluated on the single-tier Gram
        (`kernel.eval_params`), as the reference does."""
        return self.log_marginal_params(kernel, X, self.s, weight)

    def log_marginal_params(self, kernel, params_dict, s, weight=1.0):
        f64 = torch.float64
        K = kernel.eval_params(params_dict, self.x, self.x)
        return negative_log_evidence(K.to(f64), self.y.to(f64), s, weight)

    # -- the generic hyperparameter fit -----------------------------------------
    def optimize_params_general(
        self, params=None, restarts: int = 2, optimizer: str = "lbfgs",
        maxiter: int = 200, mingradnorm: float = 1e-6, regularizer_func=None,
        verbose: bool = False, scale: float = 1.0, weight: float = 1.0,
        save: bool = False, save_name: str = "model.np", generator=None,
        rtol: float = 1e-5,
        xtol: float = 1e-6,
    ):
        """Optimise named kernel parameters (and optionally the noise).

        `params` = {kernel_idx: {var_name: (init, shape_hint, bounds)}}, with
        'likelihood'/'sigma' addressing the noise level. `optimizer` is
        'lbfgs' (also under the reference's names 'pymanopt' /
        'pytorch-minimize'), 'bisection' or 'discrete' (a search over the
        group structures a parameter lists, `_optimize_discrete`). The
        route rule is the JAX
        package's: at most 2 parameters and no regularizer go to damped
        Newton, else L-BFGS with the batched line search while its
        candidates fit the memory budget, else with backtracking.
        `generator` draws the random inits (default: seed 13).
        """
        params = params or {}
        kernel = self.kernel_object
        dt, dev = torch.float64, self.device
        if optimizer == "discrete":
            return self._optimize_discrete(params, weight)
        if generator is None:
            generator = torch.Generator().manual_seed(13)

        # ---- the flat spec ---------------------------------------------------
        specs = []  # (key, var, size, fwd, inv, init, cur)
        for pkey, dparams in params.items():
            for var, value in dparams.items():
                init, _manifold, bound = value
                if pkey == "likelihood":
                    cur = torch.tensor(float(self.s), dtype=dt, device=dev)
                else:
                    cur = kernel.params_dict[pkey][var].to(dt)
                cur = cur.reshape(-1)
                if bound is not None:
                    lo, hi = bound if not isinstance(bound, list) else bound[0]
                    fwd, inv = make_box_bijector(lo, hi)
                elif var in _POSITIVE_PARAMS:
                    fwd, inv = make_positive_bijector()
                else:
                    fwd, inv = (lambda r: r), (lambda p: p)
                specs.append((pkey, var, cur.numel(), fwd, inv, init, cur))
        offsets = np.concatenate([[0], np.cumsum([s[2] for s in specs])])
        dim = int(offsets[-1])

        def unpack(xflat):
            override = {}
            s_val = torch.tensor(float(self.s), dtype=dt, device=dev)
            for i, (pkey, var, _size, fwd, _inv, _init, _cur) in enumerate(
                    specs):
                seg = fwd(xflat[offsets[i]:offsets[i + 1]])
                if pkey == "likelihood":
                    s_val = seg.reshape(())
                else:
                    # match the stored param's rank (scalars stay scalars)
                    shape = kernel.params_dict[pkey][var].shape
                    override.setdefault(pkey, {})[var] = seg.reshape(shape)
            return override, s_val

        def cost(xflat):
            override, s_val = unpack(xflat)
            f = self.log_marginal_params(kernel, override, s_val, weight)
            if regularizer_func is not None:
                f = f + regularizer_func(xflat)
            return f

        if optimizer == "bisection":
            # golden section on the single parameter, inside its bound
            assert dim == 1
            bound = [v[2] for dps in params.values() for v in dps.values()][-1]
            a, b = (torch.tensor(float(t), dtype=dt, device=dev) for t in bound)
            inv = specs[0][4]
            best_x = golden_section(lambda t: cost(t.reshape(1)), inv(a),
                                    inv(b), iters=60).reshape(1)
        else:
            x0s = self._restart_points(specs, restarts, scale, generator)
            # the reference's rule, sized by the model's dtype: the Gram's
            # there, so the route is the JAX package's for the same model
            # (f32 on the TPU). The budgets bind nothing here, where the
            # restarts and candidates run one after another.
            n_pts = int(self.x.shape[0])
            itemsize = 8 if self.dtype == torch.float64 else 4
            per_restart_bytes = 16 * n_pts * n_pts * itemsize / 4
            chunk = max(1, min(restarts,
                               int(_BATCH_BYTES // max(per_restart_bytes, 1))))
            cand_bytes = (chunk * _LINESEARCH_CANDIDATES * 2 * n_pts * n_pts
                          * itemsize)
            route = "batched" if cand_bytes <= _BATCH_BYTES else "backtracking"
            if dim <= 2 and regularizer_func is None:
                route = "newton"
            results = []
            for x0 in x0s:
                if route == "newton":
                    res = minimize_newton_small(
                        cost, x0, max_iter=maxiter, tol=mingradnorm,
                        rtol=rtol, xtol=xtol)
                else:
                    res = minimize_lbfgs(
                        cost, x0, max_iter=maxiter, tol=mingradnorm,
                        rtol=rtol, xtol=xtol, linesearch=route,
                        max_linesearch_steps=_LINESEARCH_CANDIDATES)
                results.append(res)
            values = torch.stack([r.value for r in results])
            best = int(torch.where(torch.isnan(values),
                                   torch.full_like(values, float("inf")),
                                   values).argmin())
            best_x = results[best].x
            self.hyperopt_metrics = {
                "iterations": np.array([r.iterations for r in results]),
                "converged": np.array([r.converged for r in results]),
                "values": values.cpu().numpy(),
                "restarts": restarts,
                "chunk": chunk,
                "route": route,
            }
            if verbose:
                print("restart values:", self.hyperopt_metrics["values"])
                print("restart iterations:",
                      self.hyperopt_metrics["iterations"],
                      "converged:", self.hyperopt_metrics["converged"])

        if save:
            with torch.no_grad():
                evidence = float(cost(best_x))
            with open(save_name, "wb") as f:
                pickle.dump({
                    "params": best_x.cpu().numpy(),
                    "evidence": evidence,
                    "repeats": restarts,
                    "param_names": {k: list(v.keys())
                                    for k, v in params.items()},
                }, f)

        # ---- write back + refit ----------------------------------------------
        with torch.no_grad():
            override, s_val = unpack(best_x)
        kernel.set_params(override)
        if "likelihood" in params:
            self.s = float(s_val)
        self.fitted = False
        self.fit_gp(self.x, self.y)
        return True

    def _optimize_discrete(self, params, weight):
        """Search over discrete configurations: each group structure of
        `params` = {kernel_idx: {var: (init, configurations, bound)}} in
        turn, its atom rebuilt with it, scored by the evidence; the first
        least value wins (strict <, the JAX package's order), then the
        refit."""
        atoms = self.kernel_object._atoms
        best_val, best_cfg, target = np.inf, None, None
        for pkey, dparams in params.items():
            atom = atoms[int(pkey)]
            for var, (_init, configurations, _bound) in dparams.items():
                old = atom.static.get("groups")
                for config in configurations:
                    atom.static["groups"] = config
                    atom.rebuild()
                    with torch.no_grad():
                        val = float(self.log_marginal_params(
                            self.kernel_object, {}, self.s, weight))
                    if val < best_val:
                        best_val, best_cfg, target = val, config, pkey
                atom.static["groups"] = old
                atom.rebuild()
        if best_cfg is not None:
            atoms[int(target)].static["groups"] = best_cfg
            atoms[int(target)].rebuild()
        self.fitted = False
        self.fit_gp(self.x, self.y)
        return True

    def _restart_points(self, specs, restarts, scale, generator):
        """(restarts, dim) raw starting points: a callable init's value, or
        |N(0, 1)|²·scale (+1e-3 for a positive parameter) drawn from
        `generator`; restart 0 starts from the current values."""
        dt, dev = torch.float64, self.device
        pts = []
        for _key, var, size, _fwd, inv, init, _cur in specs:
            if callable(init):
                base = torch.as_tensor(np.asarray(init(size)), dtype=dt,
                                       device=dev).reshape(1, size)
                pts.append(inv(base * torch.ones((restarts, size), dtype=dt,
                                                 device=dev)))
            else:
                raw = torch.randn((restarts, size), generator=generator,
                                  dtype=dt, device=generator.device).to(dev)
                raw = raw ** 2 * scale
                pts.append(inv(raw + 1e-3) if var in _POSITIVE_PARAMS else raw)
        x0s = torch.cat(pts, dim=1)
        x0s[0] = torch.cat([spec[4](spec[6]) for spec in specs])
        return x0s

    def load_params(self, save_name):
        """Restore pickled hyperopt results."""
        with open(save_name, "rb") as f:
            return pickle.load(f)
