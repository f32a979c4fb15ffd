"""Device milliseconds per call of the cuSOLVER / cuBLAS stages of
stpy_tpu_torch/linalg.py and the preconditioner: the kernels launched
inside these aten ops."""

# the kernels are found by the host op that launched them
HOST_OPS = True
LINALG_OPS = ("aten::linalg_cholesky_ex", "aten::cholesky_solve",
              "aten::linalg_solve_triangular", "aten::linalg_qr",
              "aten::linalg_eigh")


def read(run):
    if run.profile is None or not run.calls:
        return None
    s = run.profile.op_device_s(LINALG_OPS)
    return s * 1e3 / len(run.calls) if s > 0 else None
