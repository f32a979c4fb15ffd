"""Sampling helpers: the port of stpy_tpu/utils/sampling.py.

Sphere and box draws come from a `torch.Generator` (where the JAX package
takes a key) on the generator's device; rejection sampling, the Halton
sequence and the duplicate-free splits are host numpy, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59,
           61, 67, 71]


def sample_uniform_sphere(generator, n, d, radius=1.0, dtype=torch.float32):
    """n points uniform on the sphere of `radius` in d dimensions."""
    z = torch.randn((n, d), generator=generator, dtype=dtype,
                    device=generator.device)
    return radius * z / torch.linalg.vector_norm(z, dim=1, keepdim=True)


def rejection_sampling(pdf, size=(1, 1), bound=None, proposal_range=10.0,
                       seed=0, max_tries=100000):
    """Host rejection sampler from an unnormalised pdf over the box
    [-R, R]^d."""
    n, d = size
    rng = np.random.default_rng(seed)
    if bound is None:
        probe = rng.uniform(-proposal_range, proposal_range, (4096, d))
        bound = float(np.max(pdf(probe))) * 1.5
    out = []
    tries = 0
    while len(out) < n and tries < max_tries:
        x = rng.uniform(-proposal_range, proposal_range, (n, d))
        u = rng.uniform(0, bound, n)
        acc = u < np.asarray(pdf(x)).ravel()
        out.extend(list(x[acc]))
        tries += n
    return np.asarray(out[:n])


def vdc(n, base=2):
    """Van der Corput sequence: the first n points in `base`."""
    seq = np.zeros(n)
    for i in range(n):
        q, denom = 0.0, 1.0
        k = i + 1
        while k > 0:
            denom *= base
            k, rem = divmod(k, base)
            q += rem / denom
        seq[i] = q
    return seq


def halton_sequence(size, dim):
    assert dim <= len(_PRIMES)
    return np.stack([vdc(size, _PRIMES[j]) for j in range(dim)], axis=1)


def sample_qmc_halton(inverse_cdf, size=(1, 1)):
    u = halton_sequence(size[0], size[1])
    return inverse_cdf(u)


def sample_bounded(generator, bounds, n=1, dtype=torch.float32):
    """n points uniform in the box `bounds` = ((low, high), ...)."""
    bounds = torch.as_tensor(np.asarray(bounds, dtype=float), dtype=dtype,
                             device=generator.device)
    u = torch.rand((n, bounds.shape[0]), generator=generator, dtype=dtype,
                   device=generator.device)
    return bounds[:, 0] + u * (bounds[:, 1] - bounds[:, 0])


def randomly_split_set_without_duplicates(x, sizes, seed=0):
    """Split the rows of x into disjoint index sets of the given sizes, no
    duplicate row split across sets."""
    x_np = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    _, inverse = np.unique(x_np, axis=0, return_inverse=True)
    inverse = inverse.ravel()
    rng = np.random.default_rng(seed)
    group_ids = np.unique(inverse)
    rng.shuffle(group_ids)
    sets = [[] for _ in sizes]
    cursor = 0
    for gid in group_ids:
        idx = np.where(inverse == gid)[0]
        while cursor < len(sizes) and len(sets[cursor]) >= sizes[cursor]:
            cursor += 1
        if cursor >= len(sizes):
            break
        sets[cursor].extend(idx.tolist())
    return [np.asarray(s, dtype=int) for s in sets]


def randomly_split_set_without_duplicates_balanced(x, k, seed=0):
    """k roughly equal splits keeping duplicates together."""
    n = x.shape[0]
    sizes = [n // k] * k
    return randomly_split_set_without_duplicates(x, sizes, seed=seed)
