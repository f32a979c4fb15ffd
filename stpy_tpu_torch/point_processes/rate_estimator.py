"""RateEstimator base: the sensing-round data model of the point processes.

Port of stpy_tpu/point_processes/rate_estimator.py. Data are rounds
(S, obs, dt): a sensed region S (a BorelSet), the observed points obs
((k, d) or None) and the sensing time dt. `load_data` builds `counts`,
`phis` (∫_S Φ·dt per round) and the embedded observations with duplicate
rows merged into multiplicities; the dual mode assigns observations to
anchor points. The per-round bookkeeping is host-side; every stored array
is a tensor of the estimator's dtype on its device.

`jit_pad` is accepted and does nothing. The JAX package pads the rounds
and observations to powers of two so that XLA does not retrace its jitted
fits every round; PyTorch traces nothing, and the padded rows carry zero
weight, so padding changes no value.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor


class RateEstimator:
    def _tensor(self, x):
        return as_tensor(x, device=self.device, dtype=self.dtype)

    @property
    def n_rounds(self):
        """Number of sensing rounds loaded."""
        return int(self.phis.shape[0]) if getattr(self, "data", None) else 0

    def get_min_max(self):
        volumes = [s.volume() for s in
                   self.hierarchy.get_sets_level(self.hierarchy.levels)]
        return (np.min(volumes), np.max(volumes))

    def get_m(self):
        return self.packing.get_m()

    # -- the leaf sets a round covers ------------------------------------------
    def _leaf_bounds(self):
        """(leaves, d, 2) float64 bounds of the basic sets, cached."""
        if getattr(self, "_leaf_bounds_np", None) is None:
            self._leaf_bounds_np = np.stack([e._bounds_np
                                             for e in self.basic_sets])
        return self._leaf_bounds_np

    def _contained_leaves(self, S):
        """Indices (ascending) of the basic sets inside S. For a box S one
        vectorized comparison against every leaf's bounds (the JAX package
        asks `S.inside` leaf by leaf, with the same comparisons)."""
        if S.type != "box":
            return [i for i, e in enumerate(self.basic_sets) if S.inside(e)]
        lb, sb = self._leaf_bounds(), S._bounds_np
        ok = (np.all(sb[:, 0] <= lb[:, :, 0], axis=1)
              & np.all(sb[:, 1] >= lb[:, :, 1], axis=1))
        return np.nonzero(ok)[0].tolist()

    def _leaf_obs_counts(self, idx, obs):
        """Number of rows of obs (a (k, d) tensor) in each basic set (a
        box) of `idx`: the sets' half-open membership test on the host."""
        if len(idx) == 0:
            return np.zeros(0)
        pts = obs.reshape(-1, self.d).cpu().double().numpy()
        lb = self._leaf_bounds()[np.asarray(idx)]
        inside = np.all((pts[None] >= lb[:, None, :, 0])
                        & (pts[None] < lb[:, None, :, 1]), axis=-1)
        return inside.sum(axis=1).astype(float)

    # -- data loading ------------------------------------------------------------
    def _merge_duplicates(self, obs):
        """Unique rows weighted by multiplicity: (unique_obs, multiplicities);
        the likelihood weighs log-terms by the counts."""
        uniq, counts = np.unique(obs.cpu().numpy(), axis=0, return_counts=True)
        return self._tensor(uniq), self._tensor(counts.astype(float))

    def _assign_anchors(self, uniq, mult):
        d2 = torch.sum((uniq[:, None, :] - self.anchor_points[None, :, :]) ** 2,
                       dim=-1)
        idx = torch.argmin(d2, dim=1).cpu().numpy()
        w = self.anchor_weights.cpu().double().numpy().copy()
        np.add.at(w, idx, mult.cpu().double().numpy())
        self.anchor_weights = self._tensor(w)

    def load_data(self, data, times=True):
        self.approx_fit = False
        if len(data) == 0:
            return
        phis, observations, counts, x = [], [], [], []
        obs_weights = []
        self.data = list(data)
        for S, obs, dt in data:
            count = 0.0
            if obs is not None:
                obs = self._tensor(obs).reshape(-1, self.d)
                x.append(obs)
                uniq, mult = self._merge_duplicates(obs)
                emb = self.packing.embed(uniq) * (dt if times else 1.0)
                observations.append(emb)
                obs_weights.append(mult)
                count = float(emb.shape[0])
                if getattr(self, "dual", False):
                    self.global_dt = dt
                    self._assign_anchors(uniq, mult)
            phis.append((self.packing.integral(S) * dt).reshape(1, -1))
            counts.append(count)

        self.counts = self._tensor(counts)
        self.phis = torch.cat(phis, dim=0)
        self.x = torch.cat(x, dim=0) if x else None
        self.observations = torch.cat(observations, dim=0) if observations else None
        self.obs_multiplicities = torch.cat(obs_weights) if obs_weights else None
        if self.feedback == "count-record":
            self.bucketization()

    def add_data_point(self, new_data, times=True):
        self.approx_fit = False
        if self.data is None:
            self.load_data([new_data])
            return
        self.data.append(new_data)
        S, obs, dt = new_data
        if obs is not None:
            obs = self._tensor(obs).reshape(-1, self.d)
            uniq, mult = self._merge_duplicates(obs)
            emb = self.packing.embed(uniq) * (dt if times else 1.0)
            count = float(emb.shape[0])
            self.observations = (torch.cat([self.observations, emb], dim=0)
                                 if self.observations is not None else emb)
            self.obs_multiplicities = (
                torch.cat([self.obs_multiplicities, mult])
                if self.obs_multiplicities is not None else mult)
            if getattr(self, "dual", False):
                self._assign_anchors(uniq, mult)
        else:
            count = 0.0
        phi = self.packing.integral(S).reshape(1, -1) * dt
        self.phis = torch.cat([self.phis, phi], dim=0)
        self.counts = torch.cat([self.counts, self._tensor([count])])
        if self.feedback == "count-record":
            # incremental bucket update
            idx = self._contained_leaves(S)
            if idx:
                it = torch.as_tensor(idx, device=self.device)
                if obs is not None:
                    self.total_bucketized_obs[it] += self._tensor(
                        self._leaf_obs_counts(idx, obs))
                self.bucketized_counts[it] += 1
                self.total_bucketized_time[it] += dt

    # -- rate evaluation ------------------------------------------------------------
    def mean_rate(self, S, n=128):
        return self.mean_rate_points(S.return_discretization(n))

    def mean_rate_points(self, xtest):
        if self.rate is not None:
            return self.packing.embed(xtest) @ self.rate.reshape(-1, 1)
        return self.packing.embed(xtest)[:, :1] * 0 + self.b

    def mean_set(self, S, dt=1):
        phi = self.packing.integral(S) * dt
        return phi @ self.rate.reshape(-1, 1)

    def rate_value(self, x, dt=1):
        phi = self.packing.embed(x) * dt
        if self.rate is not None:
            return phi @ self.rate.reshape(-1, 1)
        print("Rate function not fitted!")
        return 0 * phi[:, :1] + self.b

    def sample_value(self, S):
        return self.packing.integral(S) @ self.sampled_theta

    def sample_path(self, S, n=128):
        xtest = S.return_discretization(n)
        self._require_sampled()
        return self.packing.embed(xtest) @ self.sampled_theta

    def sample_path_points(self, xtest):
        self._require_sampled()
        return self.packing.embed(xtest) @ self.sampled_theta.reshape(-1, 1)

    def _require_sampled(self):
        if getattr(self, "sampled_theta", None) is None:
            raise RuntimeError(
                "no posterior sample available — call .sample() first")

    def get_observations(self):
        if self.data is None:
            return None
        points = [self._tensor(d[1]) for d in self.data if d[1] is not None]
        return torch.vstack(points) if points else None
