"""The least time of a kernel's work on one H100, frozen.

Copied from chip_smoke.py (the peaks and `bound`, `gram_bounds`,
`shape_cost`, `matvec_bound`, `matmat_tc_bound`, `qform_bound`), so that a
later change to the program's own arithmetic does not move the yardstick.
Each bound is the larger of the bytes the function must move over the HBM
bandwidth and its operations over the peak of the units that run them; each
input byte is counted read once and each output byte written once. Times in
milliseconds.
"""

from __future__ import annotations

# H100 SXM data-sheet peaks, dense: HBM3 bytes/s, f32 outside the tensor
# cores, FP64 outside them, FP64 and TF32 on the tensor cores (flop/s)
HBM_BPS, F32_FLOPS, F64_FLOPS, F64_MMA_FLOPS = 3.35e12, 67e12, 34e12, 67e12
TF32_FLOPS = 495e12
# special-function unit (exp, sqrt): 16 results per clock per SM, 132 SMs at
# the 1.98 GHz boost clock of the SXM part
SFU_OPS = 16 * 132 * 1.98e9


def bound(nbytes, flops, peak_flops):
    """(least time in ms, what bounds it): the bytes the function must move
    over HBM_BPS against its operations over `peak_flops`."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gram_bounds(n, m, d):
    """gram, gram_df, gemv_df and gram_l1 at an (n, m, d) shape: inputs read
    once, outputs written once; per entry 2d + 5 f32 operations for the SE
    Gram, 3d + 10 FP64 ones for the df Gram, 4 FP64 ones per GEMV term and
    3d + 2 f32 ones for the L1 Gram."""
    return {
        "gram": bound(4 * (n + m) * d + 4 * n * m, (2 * d + 5) * n * m,
                      F32_FLOPS),
        "gram_df": bound(8 * (n + m) * d + 8 * n * m, (3 * d + 10) * n * m,
                         F64_FLOPS),
        "gemv_df": bound(8 * n * m + 8 * m + 8 * n, 4 * n * m, F64_FLOPS),
        "gram_l1": bound(4 * (n + m) * d + 4 * n * m, (3 * d + 2) * n * m,
                         F32_FLOPS),
    }


def shape_cost(family, nu=1.5, shape="k"):
    """(f32 operations, special-function results) of one shape entry past
    the squared distance: "k" SE 2 and an exp, Matérn 4, a sqrt and an exp;
    "dk_sq" / "dk" SE 3 / 2 and an exp; Matérn: the sqrt, the exponent's
    FMUL and the exp, then for ½ 2 FMULs / an FMUL, an FMAX and an IEEE
    division (a reciprocal on the SFU and 4 FMAs), 3/2 2 / 1 FMULs, 5/2 an
    FMA and 3 / 2 FMULs."""
    if shape == "k":
        return (2, 1) if family == "se" else (4, 2)
    if family == "se":
        return (3, 1) if shape == "dk_sq" else (2, 1)
    extra = {0.5: (2, 6), 1.5: (2, 1), 2.5: (4, 3)}[float(nu)]
    sfu = 3 if (float(nu), shape) == (0.5, "dk") else 2
    return 1 + extra[shape == "dk"], sfu


def matvec_bound(n, m, d, family, r=None, nu=1.5, shape="k", cost=None):
    """gram_matvec (r = None) or gram_matmat with r columns: x, y and the
    right side read once, the output written once; per (i, j) pair 2d f32
    operations for the squared distance, the shape's (`shape_cost`, or
    `cost` where given) and 2 per column of the product over F32_FLOPS,
    against the exps and sqrts over SFU_OPS; the larger of the two is the
    operations' time."""
    cols = 1 if r is None else r
    shape_ops, sfu = cost or shape_cost(family, nu, shape)
    t_bytes = 4 * ((n + m) * d + (n + m) * cols) / HBM_BPS * 1e3
    t_ops = n * m * max((2 * d + shape_ops + 2 * cols) / F32_FLOPS,
                        sfu / SFU_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matmat_tc_bound(n, m, d, family, r, nu=1.5, shape="k", cost=None):
    """gram_matmat as csrc/gram_matmat.cu computes it: the product with V in
    three TF32 passes on the tensor cores (the split that keeps f32
    accuracy), 3·2·n·m·r operations over TF32_FLOPS, against the Gram
    entries' 2d + shape f32 operations over F32_FLOPS, their exps and sqrts
    over SFU_OPS, and the bytes of `matvec_bound`; the largest of these. The
    entries are counted once; `cost` as in `matvec_bound`."""
    shape_ops, sfu = cost or shape_cost(family, nu, shape)
    t_bytes = 4 * ((n + m) * d + (n + m) * r) / HBM_BPS * 1e3
    t_ops = max(6 * n * m * r / TF32_FLOPS,
                n * m * (2 * d + shape_ops) / F32_FLOPS,
                n * m * sfu / SFU_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qform_bound(c, n, t):
    """qform_df: Th, Tl, W0k, W0a, Bh, Bl read once, (qh, ql) written once;
    2cnt FP64 operations of the product, which the tensor cores could run."""
    return bound(4 * (2 * c * n + n * t + 3 * c * t) + 8 * t,
                 2 * c * n * t + 6 * c * t, F64_MMA_FLOPS)
