"""Squared exponential: κ · exp(−r²/2), r = ‖a − b‖/γ."""

from portbench.roofline.bounds import shape_cost

PORT = "squared_exponential"


def correlation(sq, atom):
    """exp(−sq/2), in place on the scaled squared distance `sq`."""
    return sq.mul_(-0.5).exp_()


def cost(atom, shape="k"):
    return shape_cost("se", None, shape)
