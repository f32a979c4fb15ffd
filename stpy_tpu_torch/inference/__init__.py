"""Posterior samplers (port of stpy_tpu/inference): the Langevin family and
Hamiltonian Monte Carlo. The truncated-multivariate-Gaussian sampler
(`tmg.py`) comes with ROADMAP Queue 1 item 10."""

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

__all__ = ["HmcSampler", "LangevinSampler", "MirrorLangevin",
           "ProximalLangevin", "hmc_sample", "mirror_langevin_box",
           "mirror_langevin_positive", "mla_prime_positive",
           "newton_langevin", "projected_langevin", "proximal_langevin",
           "ula"]
