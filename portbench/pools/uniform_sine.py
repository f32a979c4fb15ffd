"""x ~ U(x_low, x_high)^d and y = sin(y_frequency · x[:, y_feature]) +
y_noise · ε, as bench.py draws them: f32, on the device, in two draws."""

import torch


def make(config, g, device):
    data = config["data"]
    n, d = config["pool_rows"], config["d"]
    lo, hi = float(data["x_low"]), float(data["x_high"])
    x = torch.rand((n, d), generator=g, device=device).mul_(hi - lo).add_(lo)
    eps = torch.randn((n,), generator=g, device=device)
    y = torch.sin(float(data["y_frequency"]) * x[:, int(data["y_feature"])])
    return x, y.add_(float(data["y_noise"]) * eps)
