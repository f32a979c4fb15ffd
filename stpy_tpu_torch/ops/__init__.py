"""Hand-kernel ops of the port.

Each kernel has a wrapper that launches it for CUDA tensors (or raises) and
runs its plain PyTorch version, in the same module, for CPU tensors. A
wrapper adds one to its ``launches`` attribute each time it launches its
kernel and nowhere else, so a run can show that it went through the kernels.
The matrix-free products count their derivative shapes apart, in
``shape_launches`` ("dk_sq", "dk"; ``launches`` counts the shape "k").

The package re-exports the JAX package's ops names (stpy_tpu/ops/__init__.py)
that mean the same here: `gram_se`, `gram_matern`, `gram_laplace` and
`make_lazy_matvec`, resolved on first access (`__getattr__`), since the kernel
modules import this one. `gram` and `gram_matvec` are not re-exported: those
names are the kernel modules `ops.gram` and `ops.gram_matvec`, whose
functions `ops.gram.gram` and `ops.gram_matvec.gram_matvec` are the JAX
package's `ops.gram` and `ops.gram_matvec`.
"""

from __future__ import annotations

import importlib

import torch

# re-exported name -> the port module that defines it
_REEXPORTS = {
    "gram_se": "gram",
    "gram_matern": "gram",
    "gram_laplace": "gram_l1",
    "make_lazy_matvec": "gram_matvec",
}


def __getattr__(name):
    if name not in _REEXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_REEXPORTS[name]}"),
                    name)
    globals()[name] = value
    return value


def kernel_wrappers() -> dict:
    """name -> wrapper, for every hand kernel of the port."""
    from stpy_tpu_torch.ops import (
        chol_leaf, gemv_df, gram, gram_df, gram_df_stages, gram_l1,
        gram_matvec, qform_df, syrk,
    )

    return {
        "gram": gram.gram_scaled,
        "gram_df": gram_df.gram_df_scaled,
        "gemv_df": gemv_df.gemv_df,
        "qform_df": qform_df.qform_refined_strip,
        "gram_l1": gram_l1.gram_l1,
        "gram_matvec": gram_matvec.gram_matvec_scaled,
        "gram_matmat": gram_matvec.gram_matmat_scaled,
        "syrk_lower": syrk.syrk_update_lower_,
        "chol_leaf": chol_leaf.chol_leaf_,
        "gram_df_stages": gram_df_stages.df_entry_stage,
        "gram_df[stage]": gram_df_stages.gram_df_stage,
    }


def launch_counts() -> dict:
    """name -> launches; a wrapper's derivative shapes as "name[shape]"."""
    counts = {}
    for name, w in kernel_wrappers().items():
        counts[name] = w.launches
        for shape, c in getattr(w, "shape_launches", {}).items():
            counts[f"{name}[{shape}]"] = c
    return counts


def reset_launch_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0
        shapes = getattr(w, "shape_launches", {})
        for shape in shapes:
            shapes[shape] = 0


def check_cuda_inputs(name: str, dtype: torch.dtype, *tensors) -> None:
    """Raise unless every tensor is a `dtype` tensor on the first one's
    CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: a direct call of the CUDA kernel has no backward "
                "yet; differentiate through its module's public functions, "
                "which launch it on detached inputs inside a "
                "torch.autograd.Function, or detach the inputs"
            )


def needs_grad(*values) -> bool:
    """Whether autograd records and one of `values` is a tensor that
    requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in values)
