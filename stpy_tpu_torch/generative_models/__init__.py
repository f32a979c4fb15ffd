from stpy_tpu_torch.generative_models.cvae import CVAE  # noqa: F401
