"""Posterior samplers (port of stpy_tpu/inference): the Langevin family and
Hamiltonian Monte Carlo, and the exact-HMC truncated-multivariate-Gaussian
sampler (`tmg.py`)."""

from stpy_tpu_torch.inference.hmc import HmcSampler, hmc_sample
from stpy_tpu_torch.inference.langevin import (
    LangevinSampler,
    MirrorLangevin,
    ProximalLangevin,
    mirror_langevin_box,
    mirror_langevin_positive,
    mla_prime_positive,
    newton_langevin,
    projected_langevin,
    proximal_langevin,
    ula,
)
from stpy_tpu_torch.inference.tmg import tmg_sample

__all__ = ["HmcSampler", "LangevinSampler", "MirrorLangevin",
           "ProximalLangevin", "hmc_sample", "mirror_langevin_box",
           "mirror_langevin_positive", "mla_prime_positive",
           "newton_langevin", "projected_langevin", "proximal_langevin",
           "tmg_sample", "ula"]
