"""Kernel atoms by family: ``families/<family>.py`` holds the port's name
of the family (`PORT`), the plain reference's correlation of a scaled
squared distance (`correlation`) and the roofline's cost of one entry
(`cost`). A configuration's atoms name their family; a new family is a new
file."""


def port_kernel(config: dict, families: dict, device):
    """The configuration's kernel as the port builds it: the sum of its
    atoms, each a `KernelFunction` of its family's `PORT` name."""
    from stpy_tpu_torch.kernels import KernelFunction

    kernel = None
    for atom in config["kernel"]:
        k = KernelFunction(kernel_name=families[atom["family"]].PORT,
                           gamma=atom["gamma"], nu=atom.get("nu", 1.5),
                           kappa=atom.get("kappa", 1.0), d=config["d"],
                           device=device)
        kernel = k if kernel is None else kernel + k
    return kernel
