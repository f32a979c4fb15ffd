"""Protein mutation-landscape benchmark on one-hot features: the port of
stpy_tpu/test_functions/protein_benchmark.py.

`ProteinOperator` translates amino-acid letters, integer codes and one-hot
rows (host numpy; the one-hot rows and code grids come back as tensors on
the card, or `device`); `ProteinBenchmark` holds a mutation dataset, from
arrays, from a file (`from_file` imports pandas when called) or as a
synthetic additive + pairwise-epistasis landscape (`synthetic`).
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.utils.helper import cartesian

AMINO_ACIDS = list("ARNDCQEGHILKMFPSTWYV")


class ProteinOperator:
    def __init__(self, device=None, dtype=torch.float32):
        self.dictionary = {aa: i for i, aa in enumerate(AMINO_ACIDS)}
        self.inv_dictionary = {i: aa for i, aa in enumerate(AMINO_ACIDS)}
        self.q = len(AMINO_ACIDS)
        self.device, self.dtype = device, dtype

    def _tensor(self, v):
        return as_tensor(v, device=resolve_device(self.device),
                         dtype=self.dtype)

    def translate_amino_acid(self, letter):
        return self.dictionary[letter]

    def translate(self, X):
        """Letters (n, d) -> integer codes (n, d)."""
        X = np.atleast_2d(np.asarray(X))
        return np.vectorize(lambda a: self.dictionary[a])(X)

    def translate_mutation_series(self, series):
        return np.asarray([self.dictionary[s] for s in series])

    def translate_one_hot(self, X):
        """Integer codes (n, d) -> one-hot rows (n, d·q)."""
        X = np.atleast_2d(np.asarray(X)).astype(int)
        n, d = X.shape
        out = np.zeros((n, d * self.q))
        for j in range(d):
            out[np.arange(n), j * self.q + X[:, j]] = 1.0
        return self._tensor(out)

    def get_variant_code(self, mutation):
        """'A123T' -> (position 123, from 'A', to 'T')."""
        return int(mutation[1:-1]), mutation[0], mutation[-1]

    def get_substitutes_from_mutation(self, mutation):
        pos, src, dst = self.get_variant_code(mutation)
        return pos, self.dictionary[src], self.dictionary[dst]

    def mutation(self, original_seq, positions, new_seq):
        s = list(original_seq)
        for p, c in zip(positions, new_seq):
            s[p] = c
        return "".join(s)

    def interval_number(self, dim=None):
        d = dim or 1
        return self._tensor(cartesian([np.arange(self.q)] * d))

    def interval_onehot(self, dim=None):
        return self.translate_one_hot(cartesian([np.arange(self.q)]
                                                * (dim or 1)))

    def interval_letters(self, dim=None):
        codes = cartesian([np.arange(self.q)] * (dim or 1))
        return ["".join(self.inv_dictionary[c] for c in row) for row in codes]


class ProteinBenchmark:
    """Mutation dataset benchmark. `data` = (variants, values), variants
    integer-coded (n, dim) arrays or letter arrays."""

    def __init__(self, data, dim=1, ref=None, avg=False, scale=True,
                 device=None, dtype=torch.float32):
        self.op = ProteinOperator(device=device, dtype=dtype)
        variants, values = data
        variants = np.asarray(variants)
        if variants.dtype.kind in "UO":
            variants = self.op.translate(variants)
        self.X_codes = variants.astype(int)
        y = np.asarray(values, dtype=float).reshape(-1, 1)
        self.dim = dim
        self.ref = ref
        if scale:
            self.y_scale = np.abs(y).max() or 1.0
            y = y / self.y_scale
        self._y = y
        self.y = self.op._tensor(y)
        self.X = self.op.translate_one_hot(self.X_codes)

    @classmethod
    def from_file(cls, fname, dim=1, ref=("D", "D", "D", "D"), avg=False,
                  scale=True, positions=4, fitness_col="Fitness",
                  device=None, dtype=torch.float32):
        """Load a mutation dataset: columns P1..P{positions} hold each
        position's amino-acid letter and `fitness_col` the response; unless
        `avg`, rows are kept whose trailing (positions − dim) sites equal
        `ref`'s, and the fitness is divided by its maximum. The format
        follows the suffix: .csv, .h5/.hdf/.hdf5 (pandas with pytables),
        .xlsx/.xls (pandas with openpyxl). Needs pandas, imported here."""
        import pandas as pd

        fname = str(fname)
        if fname.endswith((".h5", ".hdf", ".hdf5")):
            dset = pd.read_hdf(fname)
        elif fname.endswith((".xlsx", ".xls")):
            dset = pd.read_excel(fname)
        else:
            dset = pd.read_csv(fname)
        if not avg:
            mask = np.full(dset.shape[0], True, dtype=bool)
            for j in range(positions - dim):
                mask &= (
                    dset[f"P{positions - j}"] == ref[positions - 1 - j]
                ).to_numpy()
            dset = dset[mask]
        cols = [f"P{i + 1}" for i in range(dim)]
        variants = dset[cols].to_numpy()
        values = dset[fitness_col].to_numpy(dtype=float)
        if scale and values.size:
            # divided by the maximum, which flips the signs where it is
            # negative, as the reference does
            values = values / (np.max(values) or 1.0)
        return cls((variants, values), dim=dim, ref=list(ref), scale=False,
                   device=device, dtype=dtype)

    @classmethod
    def synthetic(cls, dim=2, n=256, key=0, epistasis=0.3, noise=0.0,
                  device=None, dtype=torch.float32):
        """A synthetic mutation landscape from numpy seed `key`: additive
        per-site effects plus pairwise epistasis on the codes. Returns
        (benchmark, truth_fn), truth_fn mapping integer codes to the
        noiseless fitness (numpy)."""
        rng = np.random.default_rng(key)
        q = len(AMINO_ACIDS)
        codes = rng.integers(0, q, size=(n, dim))
        w_site = rng.standard_normal((dim, q))
        w_pair = epistasis * rng.standard_normal((dim, dim, q, q))

        def truth_fn(codes):
            codes = np.atleast_2d(np.asarray(codes)).astype(int)
            f = w_site[np.arange(dim), codes].sum(axis=1)
            for a in range(dim):
                for b in range(a + 1, dim):
                    f = f + w_pair[a, b, codes[:, a], codes[:, b]]
            return f.reshape(-1, 1)

        y = truth_fn(codes)
        if noise:
            y = y + noise * rng.standard_normal(y.shape)
        return cls((codes, y), dim=dim, device=device, dtype=dtype), truth_fn

    def data_summary(self):
        return {
            "n": int(self.X.shape[0]),
            "dim": self.dim,
            "features": int(self.X.shape[1]),
        }

    def eval_noiseless(self, X_codes):
        """The dataset's value at each code row (the benchmark is a
        table); NaN where the row is not in it."""
        X_codes = np.atleast_2d(np.asarray(X_codes)).astype(int)
        out = np.zeros((X_codes.shape[0], 1))
        for i, row in enumerate(X_codes):
            match = np.where((self.X_codes == row).all(axis=1))[0]
            out[i, 0] = self._y[match[0], 0] if len(match) else np.nan
        return self.op._tensor(out)

    def get_data(self):
        return self.X, self.y
