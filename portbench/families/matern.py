"""Matérn of smoothness ν ∈ {1/2, 3/2, 5/2}: κ · k_ν(r), r = ‖a − b‖/γ."""

import math

import torch

from portbench.roofline.bounds import shape_cost

PORT = "matern"


def correlation(sq, atom):
    """k_ν(√sq), in place on the scaled squared distance `sq`."""
    nu = float(atom.get("nu", 1.5))
    r = sq.sqrt_()
    if nu == 0.5:
        return r.neg_().exp_()
    if nu == 1.5:
        r.mul_(math.sqrt(3.0))
        return torch.exp(-r).mul_(r.add_(1.0))
    if nu == 2.5:
        r.mul_(math.sqrt(5.0))
        e = torch.exp(-r)
        return e.mul_(r.square().div_(3.0).add_(r).add_(1.0))
    raise ValueError(f"no reference for Matern nu = {nu}")


def cost(atom, shape="k"):
    return shape_cost("matern", float(atom.get("nu", 1.5)), shape)
