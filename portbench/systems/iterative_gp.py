"""The matrix-free CG tier: stpy_tpu_torch.parallel.iterative.IterativeGP."""

from portbench.families import port_kernel


def build(config, families, options, device):
    from stpy_tpu_torch.parallel.iterative import IterativeGP

    return IterativeGP(port_kernel(config, families, device), s=config["s"],
                       **options)


def status(model) -> dict:
    """The fit's status, and the preconditioner's rank as the model
    resolves it at its n (the gram_matmat roofline counts its slabs)."""
    st = dict(model.fit_status or {})
    if getattr(model, "lazy", False) and model.n is not None:
        from stpy_tpu_torch.parallel.iterative import resolve_precond_rank

        st["precond_rank"] = resolve_precond_rank(model.precond_rank,
                                                  int(model.n))
    return st


def failed(status) -> bool:
    """A CG fit that ended unconverged."""
    return status.get("converged") is False
