"""Hand-kernel ops of the port.

Each kernel has a wrapper that launches it for CUDA tensors (or raises) and
runs its plain PyTorch version, in the same module, for CPU tensors. A
wrapper adds one to its ``launches`` attribute each time it launches its
kernel and nowhere else, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import torch


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
    return {name: w.launches for name, w in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


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
                f"{name}: the CUDA kernel has no backward yet (hyperparameter "
                "fitting, ROADMAP Queue 1 item 5); detach the inputs"
            )
