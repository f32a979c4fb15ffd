"""The dense exact GP: stpy_tpu_torch.models.exact_gp.GaussianProcess."""

from portbench.families import port_kernel


def build(config, families, options, device):
    from stpy_tpu_torch.models.exact_gp import GaussianProcess

    return GaussianProcess(kernel=port_kernel(config, families, device),
                           s=config["s"], **options)


def status(model) -> dict:
    return dict(model.fit_status or {})


def failed(status) -> bool:
    """A factor that failed through the jitter ladder."""
    return status.get("cholesky_ok") is False
