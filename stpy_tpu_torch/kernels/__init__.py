from stpy_tpu_torch.kernels import functions
from stpy_tpu_torch.kernels.kernel_function import KernelFunction

__all__ = ["KernelFunction", "functions"]
