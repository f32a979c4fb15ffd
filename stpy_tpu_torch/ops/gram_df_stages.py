"""Stage probes of the double-float Gram's entry: its intermediate values,
each as an f32 (hi, lo) pair.

Port of the round-3 probe kernels of the JAX package, which dump the stages
of the TPU kernel's df Matérn entry to find where it loses accuracy:

- `df_entry_stage` is the counterpart of `run_stage`
  (benchmarks/exp_r3_batch_p.py:114-123, kernel `_stage_kernel`). It takes
  squared distances as (hi, lo) pairs, whose f64 sum is the input, and
  returns √sq ("sl"), t, e^{-t} or P_ν(t)·e^{-t} ("entry"). CUDA:
  csrc/gram_df_stages.cu.
- `gram_df_stage` is the counterpart of `staged_call`
  (benchmarks/exp_r3_batch_x.py:104-148, kernel `_staged_kernel`) and of the
  inline kernels of exp_r3_batch_t.py and exp_r3_batch_u.py. It takes the
  f64 scaled coordinates that `gram_df.gram_df_scaled` takes and returns, at
  the production launch, κ·entry ("entry", bitwise the production Gram), the
  squared distance ("sq"), t or e^{-t}. CUDA: csrc/gram_df.cu's
  `stpy_gram_df_stage`.

Both kernels run the production entry's device code (csrc/gram_df_entry.cuh)
in FP64. For CPU tensors each wrapper runs its plain version (`*_plain`), the
same stages in torch float64.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.ops import check_cuda_inputs
from stpy_tpu_torch.ops.gram import SHAPE_CODES
from stpy_tpu_torch.ops.gram_df import _kernel_f64, _sq_f64, _t_f64, split_f64

# stage name -> the stage code of csrc/gram_df_entry.cuh
STAGE_CODES = {"entry": 0, "sq": 1, "t": 2, "exp": 3, "sl": 4}
ENTRY_STAGES = ("sl", "t", "exp", "entry")      # df_entry_stage
GRAM_STAGES = ("entry", "sq", "t", "exp")       # gram_df_stage


def _stage_code(stage, allowed):
    if stage not in allowed:
        raise ValueError(f"unknown stage {stage!r}: expected one of {allowed}")
    return STAGE_CODES[stage]


def _shape_code(family, nu):
    key = (family, None if family == "se" else float(nu))
    if key not in SHAPE_CODES:
        raise ValueError(f"no df entry for family={family!r}, nu={nu}: SE or "
                         "Matérn with nu in (0.5, 1.5, 2.5)")
    return SHAPE_CODES[key]


def _stage_f64(sq, kappa, family, nu, stage):
    if stage == "sq":
        return sq
    if stage == "sl":
        return torch.sqrt(sq)
    if stage == "entry":
        return _kernel_f64(sq, kappa, family, nu)
    t = _t_f64(sq, family, nu)
    return t if stage == "t" else torch.exp(-t)


def df_entry_stage_plain(sqh, sql, *, nu, stage):
    """Plain version of `df_entry_stage`: the stage of sq = sqh + sql in
    torch float64, split into an f32 pair."""
    sq = sqh.to(torch.float64) + sql.to(torch.float64)
    return split_f64(_stage_f64(sq, 1.0, "matern", float(nu), stage))


def df_entry_stage(sqh, sql, *, nu, stage):
    """One stage of the df Matérn entry (ν ∈ {½, 3/2, 5/2}) at the squared
    distances sq = sqh + sql (f32 pairs, any equal shapes): "sl" √sq, "t"
    √(2ν·sq), "exp" e^{-t}, "entry" P_ν(t)·e^{-t}. Returns (hi, lo), f32.
    CUDA: the hand kernel; CPU: `df_entry_stage_plain`."""
    shape = _shape_code("matern", nu)
    code = _stage_code(stage, ENTRY_STAGES)
    check_cuda_inputs("gram_df_stages", torch.float32, sqh, sql)
    if sqh.shape != sql.shape:
        raise ValueError(f"gram_df_stages: hi {tuple(sqh.shape)} and lo "
                         f"{tuple(sql.shape)} differ")
    if not sqh.is_cuda:
        return df_entry_stage_plain(sqh, sql, nu=nu, stage=stage)
    sqh, sql = sqh.contiguous(), sql.contiguous()
    hi, lo = torch.empty_like(sqh), torch.empty_like(sqh)
    if sqh.numel() == 0:
        return hi, lo
    lib = _build.library()
    with torch.cuda.device(sqh.device):
        err = lib.stpy_gram_df_stages(
            sqh.data_ptr(), sql.data_ptr(), hi.data_ptr(), lo.data_ptr(),
            sqh.numel(), shape, code, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gram_df_stages")
    df_entry_stage.launches += 1
    return hi, lo


df_entry_stage.launches = 0


def gram_df_stage_plain(xs, ys, kappa, *, family, nu, stage):
    """Plain version of `gram_df_stage`: `gram_df.gram_df_plain`'s squared
    distances, then the stage in torch float64, split into an f32 pair."""
    return split_f64(_stage_f64(_sq_f64(xs, ys), float(kappa), family,
                                float(nu), stage))


def gram_df_stage(xs, ys, kappa, *, family, nu, stage):
    """One stage of the df Gram of f64 coordinates already scaled by 1/γ
    (what `gram_df.gram_df_scaled` takes), at every (xs_i, ys_j): "entry"
    κ·P(t)·e^{-t}, "sq" the squared distance, "t" its exponent (√(2ν·sq);
    sq/2 for SE), "exp" e^{-t}. Returns (hi, lo), f32. CUDA: the production
    kernel's launch with its output swapped for the stage; CPU:
    `gram_df_stage_plain`."""
    shape = _shape_code(family, nu)
    code = _stage_code(stage, GRAM_STAGES)
    check_cuda_inputs("gram_df[stage]", torch.float64, xs, ys)
    if xs.dim() != 2 or ys.dim() != 2 or xs.shape[1] != ys.shape[1]:
        raise ValueError(f"gram_df[stage]: coordinates {tuple(xs.shape)} and "
                         f"{tuple(ys.shape)} are not (n, d) and (m, d)")
    if not xs.is_cuda:
        return gram_df_stage_plain(xs, ys, kappa, family=family, nu=nu,
                                   stage=stage)
    xs, ys = xs.contiguous(), ys.contiguous()
    n, d = xs.shape
    m = ys.shape[0]
    hi = torch.empty((n, m), dtype=torch.float32, device=xs.device)
    lo = torch.empty_like(hi)
    if n == 0 or m == 0:
        return hi, lo
    lib = _build.library()
    with torch.cuda.device(xs.device):
        err = lib.stpy_gram_df_stage(
            xs.data_ptr(), ys.data_ptr(), hi.data_ptr(), lo.data_ptr(),
            n, m, d, float(kappa), shape, code,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gram_df[stage]")
    gram_df_stage.launches += 1
    return hi, lo


gram_df_stage.launches = 0
