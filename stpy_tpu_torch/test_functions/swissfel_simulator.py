"""SwissFEL accelerator-tuning simulator backed by a fitted GP: the port of
stpy_tpu/test_functions/swissfel_simulator.py.

The measured data come in as arrays (`load_fresh`, `from_arrays`) or from
an HDF5 file (`from_file`, which needs h5py and imports it when called);
`fit_simulator` fits a GP to them, whose posterior mean is then the
noiseless response. The data live on the card (or `device`) in `dtype`.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device


class FelSimulator:
    def __init__(self, d, sigma, name="fel", device=None, dtype=torch.float32):
        self.d = d
        self.sigma = sigma
        self.name = name
        self.GP = None
        self.device, self.dtype = resolve_device(device), dtype

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def load_fresh(self, x, y, dts="1"):
        """Take measured data directly."""
        self.x = self._tensor(x).reshape(-1, self.d)
        self.y = self._tensor(y).reshape(-1, 1)

    def _ingest(self, x, y, line_id, y_std):
        """The measured-data pipeline: keep the rows whose line_id < d,
        divide y by max|y|, map each x column affinely onto [-0.5, 0.5],
        and take the noise level s = max(y_std / y's scale)."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64).reshape(-1)
        line_id = np.asarray(line_id).reshape(-1)
        y_std = np.asarray(y_std, np.float64).reshape(-1)
        mask = np.zeros(x.shape[0], dtype=bool)
        for j in range(self.d):
            mask |= line_id == j
        xs = x[mask, : self.d].reshape(-1, self.d)
        ys = y[mask].reshape(-1, 1)
        scale = np.max(np.abs(ys))
        ys = ys / scale
        for j in range(self.d):
            a, b = xs[:, j].min(), xs[:, j].max()
            xs[:, j] = xs[:, j] / (b - a) - 0.5 - a / (b - a)
        self.s = float(np.max(y_std[mask] / scale))
        self.x = self._tensor(xs)
        self.y = self._tensor(ys)
        return self

    def from_arrays(self, x, y, line_id, y_std):
        """The measured-data pipeline on arrays read elsewhere."""
        return self._ingest(x, y, line_id, y_std)

    def from_file(self, file_name, dts="1"):
        """Read group `dts`'s datasets x, y, line_id and y_std of an HDF5
        file, then the pipeline of `from_arrays`. Needs h5py."""
        try:
            from h5py import File
        except ImportError as e:
            raise ImportError(
                "FelSimulator.from_file needs h5py (absent in this "
                "environment); use from_arrays(x, y, line_id, y_std) with "
                "pre-read arrays"
            ) from e
        with File(file_name, "r") as f:
            dset = f[dts]
            return self._ingest(
                dset["x"][...], dset["y"][...], dset["line_id"][...],
                dset["y_std"][...],
            )

    def fit_simulator(self, GP, optimize="bandwidth", restarts=2):
        GP.fit_gp(self.x, self.y)
        if optimize is not None:
            GP.optimize_params(type=optimize, restarts=restarts)
        self.GP = GP
        return GP

    def eval_noiseless(self, X):
        assert self.GP is not None, "fit_simulator first"
        return self.GP.mean_std(self._tensor(X))[0]

    def eval(self, X, generator=None):
        """The GP mean plus N(0, sigma²) noise from `generator` (a fresh
        one seeded from numpy's global state where None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                int(np.random.randint(2**31)))
        mu = self.eval_noiseless(X)
        return mu + self.sigma * torch.randn(
            mu.shape, generator=generator, dtype=self.dtype,
            device=generator.device).to(self.device)

    def bounds(self, N=None, n=None):
        lo = torch.min(self.x, dim=0).values
        hi = torch.max(self.x, dim=0).values
        return torch.stack([lo, hi], dim=1)

    opt_bounds = bounds

    def save(self, file_name):
        np.savez(file_name, x=self.x.cpu().numpy(), y=self.y.cpu().numpy())

    def load_pickle(self, file_name):
        with np.load(file_name) as dat:
            self.x = self._tensor(dat["x"])
            self.y = self._tensor(dat["y"])
