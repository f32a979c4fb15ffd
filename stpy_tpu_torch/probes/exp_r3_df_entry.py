"""Stage-by-stage audit of the card's double-float Matérn-5/2 entry.

    python3 -m stpy_tpu_torch.probes.exp_r3_df_entry [--device cpu] [--small]

Port of the JAX package's round-3 probes of the df Matérn entry,
benchmarks/exp_r3_batch_{p,t,u,x}.py, which hunted a 1.8e-8 error of the TPU
kernel `_gram_df_kernel` at t ≈ 2.73 (γ = 1.1, d = 8). It replays the four,
in order, with each script's own data, sizes and constants:

- P: exact df squared distances sq = hi + lo on a log grid over
  [1e-6, 120] (512 × 128), ν ∈ {1.5, 2.5}, through `df_entry_stage`:
  the stages sl = √sq, t = √(2ν·sq), e^{-t} and P_ν(t)·e^{-t}.
- T: x ~ U(−1, 1)^(2048×8) in f32, seed 0: the scaled coordinates (T1), the
  squared distance of 512 × 512 pairs (T2, stage "sq"), the d-loop and the
  entry fused (T3, stage "entry") and the production Gram (T4, `gram_df`).
- U: the 512 × 16384 cross Gram with bench's seed-0 data by the production
  `gram_df` (U1), its top-8 error entries replayed through the fused kernel
  from their coordinates (U2) and through the entry stage from their exact
  squared distances (U3).
- X: every stage of the production launch on a 512 × 512 slice whose
  columns are the blocks of the TPU's worst pairs (WORST_J).

Every stage is held to the df Gram's bar, DF_RTOL = 1e-13 relative on the
pair's value hi + lo, against host float64 of exactly what the kernel
received (the f64 scaled coordinates, or the f64 value of the sq pair) and
against 40-digit `decimal` on U's top-8 pairs, X's worst pairs and 64
points of P's grid per ν and stage. Squared distances are held in the
absolute form, over the row's largest. `--small` cuts every size for the
CPU; `main` exits 1 when a stage misses its bar.
"""

from __future__ import annotations

import argparse
import math
import sys
from decimal import Decimal, localcontext

import numpy as np
import torch

from stpy_tpu_torch.config import resolve_device
from stpy_tpu_torch.ops.gram_df import gram_df, scale_coords
from stpy_tpu_torch.ops.gram_df_stages import df_entry_stage, gram_df_stage

N, T, D, G, NU = 16384, 512, 8, 1.1, 2.5
WORST_J = [7766, 15179, 3482, 11910]
WORST_I = [153, 288, 25, 42]
P_NUS = (1.5, 2.5)
P_STAGES = ("sl", "t", "t2", "exp", "entry")
X_STAGES = (("entry", "entry"), ("acc", "sq"), ("t", "t"), ("exp", "exp"))
DF_RTOL = 1e-13                  # tests/test_torch_port_gram_df.py:DF_RTOL
DECIMAL_DIGITS = 40
DECIMAL_P_POINTS = 64
TPU_ENTRY_ERR = 1.8e-8           # the TPU kernel's, exp_r3_batch_x.py:4-9
# full sizes, and the --small cuts: P's grid rows (of 128), T's pairs, U's
# (test, train) points, X's columns per worst block (X has 4 blocks)
SIZES = {False: {"p_rows": 512, "t_pairs": 512, "u": (T, N), "x_block": 128},
         True: {"p_rows": 8, "t_pairs": 256, "u": (256, 2048), "x_block": 64}}


def p_grid(small=False):
    """P's squared distances: 512 × 128 log-spaced over [1e-6, 120], as an
    f32 pair (sqh, sql) and their f64 value; small keeps 8 rows spread over
    the range."""
    sq64 = np.logspace(-6, np.log10(120.0), 512 * 128).reshape(512, 128)
    rows = SIZES[small]["p_rows"]
    sq64 = sq64[::512 // rows]
    sqh = sq64.astype(np.float32)
    sql = (sq64 - sqh.astype(np.float64)).astype(np.float32)
    return sqh, sql, sqh.astype(np.float64) + sql.astype(np.float64)


def t_points():
    """exp_r3_batch_t.py's x ~ U(−1, 1)^(2048×8), f32, seed 0."""
    return np.asarray(np.random.default_rng(0).uniform(-1, 1, (2048, D)),
                      np.float32)


def _seed0_points():
    """exp_r3_batch_u.py's and _x.py's data, seed 0: x (N, D) and
    xt (T, D), f32."""
    rng = np.random.default_rng(0)
    x = np.asarray(rng.uniform(-1, 1, (N, D)), np.float32)
    return x, np.asarray(rng.uniform(-1, 1, (T, D)), np.float32)


def bench_points(small=False):
    """U's (x, xt); small keeps the first of each."""
    x, xt = _seed0_points()
    t, n = SIZES[small]["u"]
    return x[:n], xt[:t]


def x_slice(small=False):
    """X's slice: rows xt (512, or 256 small), columns the 128-row (64
    small) blocks of x that start at WORST_J."""
    x, xt = _seed0_points()
    w = SIZES[small]["x_block"]
    return xt[:4 * w], np.concatenate([x[j:j + w] for j in WORST_J])


def host_stage(sq, stage, nu):
    """One stage at sq in numpy float64 (the kernel's formulas)."""
    if stage == "sq":
        return sq
    if stage == "sl":
        return np.sqrt(sq)
    t = np.sqrt(2.0 * nu * sq + 1e-300)
    if stage == "t":
        return t
    e = np.exp(-t)
    if stage == "exp":
        return e
    poly = 1.0 + t if nu == 1.5 else 1.0 + t + t * t / 3.0
    return poly * e


def decimal_stage(sq, stage, nu):
    """One stage at sq (a Decimal) to DECIMAL_DIGITS digits."""
    with localcontext() as ctx:
        ctx.prec = DECIMAL_DIGITS
        if stage == "sq":
            return +sq
        if stage == "sl":
            return sq.sqrt()
        t = (Decimal(2 * nu) * sq).sqrt()
        if stage == "t":
            return t
        e = (-t).exp()
        if stage == "exp":
            return e
        poly = 1 + t if nu == 1.5 else 1 + t + t * t / 3
        return poly * e


def decimal_sq(a, b):
    """Σ (a_k − b_k)² of two f64 coordinate rows, to DECIMAL_DIGITS digits
    (each f64 converts exactly)."""
    with localcontext() as ctx:
        ctx.prec = DECIMAL_DIGITS
        return sum((Decimal(float(u)) - Decimal(float(v))) ** 2
                   for u, v in zip(a, b))


def decimal_rel(hi, lo, ref):
    """|hi + lo − ref| / |ref| of one f32 pair against a Decimal."""
    with localcontext() as ctx:
        ctx.prec = DECIMAL_DIGITS
        got = Decimal(float(hi)) + Decimal(float(lo))
        return float(abs(got - ref) / abs(ref))


def pair(hi, lo):
    """The f64 value of a (hi, lo) pair of tensors, as numpy."""
    return hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy()


def rel_err(got, ref):
    return np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)


def _record(results, label, **numbers):
    """Keep a stage's numbers; it passes when every `*rel*` number is
    within DF_RTOL."""
    rels = [v for k, v in numbers.items() if "rel" in k]
    numbers["ok"] = bool(all(r <= DF_RTOL for r in rels))
    results[label] = numbers
    return numbers


def probe_p(dev, small, results):
    sqh, sql, sqx = p_grid(small)
    th, tl = torch.as_tensor(sqh, device=dev), torch.as_tensor(sql, device=dev)
    flat = np.linspace(0, sqx.size - 1, DECIMAL_P_POINTS).astype(int)
    for nu in P_NUS:
        for stage in P_STAGES:
            if stage == "t2":
                print(f"P nu={nu} stage=t2   : no counterpart -- the card "
                      "holds sqrt(2 nu) as one FP64 value, so the TPU "
                      "probe's witness of Mosaic constant-folding its f32 "
                      "split has nothing to witness", flush=True)
                continue
            oh, ol = df_entry_stage(th, tl, nu=nu, stage=stage)
            got, ref = pair(oh, ol), host_stage(sqx, stage, nu)
            rel, ab = rel_err(got, ref), np.abs(got - ref)
            i = np.unravel_index(np.argmax(ab), ab.shape)
            hi, lo = oh.cpu().numpy().ravel(), ol.cpu().numpy().ravel()
            dec = max(decimal_rel(hi[k], lo[k], decimal_stage(
                Decimal(float(sqx.ravel()[k])), stage, nu)) for k in flat)
            r = _record(results, f"P nu={nu} {stage}", rel=float(rel.max()),
                        abs=float(ab.max()), decimal_rel=dec)
            print(f"P nu={nu} stage={stage:5s}: rel max {r['rel']:.2e}  abs "
                  f"max {r['abs']:.2e} (at sq={sqx[i]:.3e}, ref={ref[i]:.3e})"
                  f"; {DECIMAL_DIGITS}-digit decimal on {len(flat)} points: "
                  f"rel max {dec:.2e}", flush=True)


def probe_t(dev, small, results):
    x = t_points()
    xs = scale_coords(torch.as_tensor(x, device=dev), G)
    x64 = x.astype(np.float64) / G
    got = xs.cpu().numpy()
    r = _record(results, "T1", abs=float(np.abs(got - x64).max()),
                rel=float(rel_err(got, x64).max()))
    print(f"T1 scale_coords (x·(1/γ) in f64 against x/γ in f64) abs err: "
          f"{r['abs']:.2e}  rel err {r['rel']:.2e}", flush=True)

    m = SIZES[small]["t_pairs"]
    a, b = xs[:m], xs[m:2 * m]
    a64, b64 = a.cpu().numpy(), b.cpu().numpy()
    sq64 = ((a64[:, None, :] - b64[None, :, :]) ** 2).sum(-1)
    got = pair(*gram_df_stage(a, b, 1.0, family="matern", nu=NU, stage="sq"))
    ab = np.abs(got - sq64)
    r = _record(results, "T2", abs=float(ab.max()),
                rel_row=float((ab / sq64.max(1, keepdims=True)).max()))
    print(f"T2 d-loop sq df: abs err {r['abs']:.2e}  err / row max sq "
          f"{r['rel_row']:.2e}", flush=True)

    k64 = host_stage(sq64, "entry", NU)
    got = pair(*gram_df_stage(a, b, 1.0, family="matern", nu=NU,
                              stage="entry"))
    r = _record(results, "T3", abs=float(np.abs(got - k64).max()),
                rel=float(rel_err(got, k64).max()))
    print(f"T3 fused d-loop+entry: abs err {r['abs']:.2e}  rel err "
          f"{r['rel']:.2e}", flush=True)

    xt = torch.as_tensor(x, device=dev)
    got = pair(*gram_df(xt[:m], xt[m:2 * m], G, 1.0, family="matern", nu=NU))
    r = _record(results, "T4", abs=float(np.abs(got - k64).max()),
                rel=float(rel_err(got, k64).max()))
    print(f"T4 production gram_df:  abs err {r['abs']:.2e}  rel err "
          f"{r['rel']:.2e}", flush=True)


def probe_u(dev, small, results):
    x, xt = bench_points(small)
    a = scale_coords(torch.as_tensor(xt, device=dev), G)
    b = scale_coords(torch.as_tensor(x, device=dev), G)
    a64, b64 = a.cpu().numpy(), b.cpu().numpy()
    sq64 = np.zeros((len(a64), len(b64)))
    for c in range(D):
        sq64 += (a64[:, c, None] - b64[None, :, c]) ** 2
    ref = host_stage(sq64, "entry", NU)
    Kh, Kl = gram_df(torch.as_tensor(xt, device=dev),
                     torch.as_tensor(x, device=dev), G, 1.0, family="matern",
                     nu=NU)
    got = pair(Kh, Kl)
    err = np.abs(got - ref)
    top = [np.unravel_index(f, err.shape)
           for f in np.argsort(err.reshape(-1))[::-1][:8]]
    hi, lo = Kh.cpu().numpy(), Kl.cpu().numpy()
    dec_refs = [decimal_stage(decimal_sq(a64[i], b64[j]), "entry", NU)
                for i, j in top]
    dec = [decimal_rel(hi[i, j], lo[i, j], d) for (i, j), d in zip(top, dec_refs)]
    for (i, j), dr in zip(top, dec):
        t = math.sqrt(2 * NU * sq64[i, j])
        print(f"U1 ({i:4d},{j:5d}): sq {sq64[i, j]:.6e}  t {t:9.5f}  entry "
              f"{ref[i, j]:.6e}  err(exact-ref) {err[i, j]:.2e}  rel "
              f"{err[i, j] / ref[i, j]:.2e}  rel(decimal) {dr:.2e}",
              flush=True)
    worst = [(i, j) for i, j in zip(WORST_I, WORST_J)
             if i < len(a64) and j < len(b64)]
    for i, j in worst:
        print(f"U1 at the TPU's worst pair ({i:4d},{j:5d}): sq "
              f"{sq64[i, j]:.6e}  err {err[i, j]:.2e}  rel "
              f"{err[i, j] / ref[i, j]:.2e}", flush=True)
    r = _record(results, "U1", abs=float(err.max()),
                rel=float(rel_err(got, ref).max()), decimal_rel=max(dec),
                worst_pairs_rel=max((float(err[i, j] / ref[i, j])
                                     for i, j in worst), default=0.0),
                shape=list(err.shape))
    print(f"U1 cross Gram {err.shape[0]}x{err.shape[1]}: abs err max "
          f"{r['abs']:.2e}  rel err max {r['rel']:.2e} (the TPU's: "
          f"{TPU_ENTRY_ERR:.1e} abs)", flush=True)

    rows = a[[i for i, _ in top]]
    cols = b[[j for _, j in top]]
    oh, ol = gram_df_stage(rows, cols, 1.0, family="matern", nu=NU,
                           stage="entry")
    oh, ol = oh.cpu().numpy().diagonal(), ol.cpu().numpy().diagonal()
    u2 = []
    for k, (i, j) in enumerate(top):
        v = float(oh[k]) + float(ol[k])
        u2.append((abs(v - ref[i, j]) / ref[i, j],
                   decimal_rel(oh[k], ol[k], dec_refs[k])))
        print(f"U2 ({i:4d},{j:5d}): fused-replay err {abs(v - ref[i, j]):.2e}"
              f"  rel {u2[-1][0]:.2e}  rel(decimal) {u2[-1][1]:.2e}",
              flush=True)
    _record(results, "U2", rel=max(e for e, _ in u2),
            decimal_rel=max(d for _, d in u2))

    sq8 = np.array([sq64[i, j] for i, j in top])
    blk = np.zeros((512, 128))
    blk[:8, 0] = sq8
    sqh = blk.astype(np.float32)
    sql = (blk - sqh.astype(np.float64)).astype(np.float32)
    oh, ol = df_entry_stage(torch.as_tensor(sqh, device=dev),
                            torch.as_tensor(sql, device=dev), nu=NU,
                            stage="entry")
    oh, ol = oh.cpu().numpy()[:8, 0], ol.cpu().numpy()[:8, 0]
    u3 = []
    for k, (i, j) in enumerate(top):
        sqx = float(sqh[k, 0]) + float(sql[k, 0])
        want = float(host_stage(np.float64(sqx), "entry", NU))
        v = float(oh[k]) + float(ol[k])
        u3.append((abs(v - want) / want, decimal_rel(
            oh[k], ol[k], decimal_stage(Decimal(sqx), "entry", NU))))
        print(f"U3 ({i:4d},{j:5d}): entry-only err {abs(v - want):.2e}  rel "
              f"{u3[-1][0]:.2e}  rel(decimal) {u3[-1][1]:.2e}", flush=True)
    _record(results, "U3", rel=max(e for e, _ in u3),
            decimal_rel=max(d for _, d in u3))


def probe_x(dev, small, results):
    rows, cols = x_slice(small)
    a = scale_coords(torch.as_tensor(rows, device=dev), G)
    b = scale_coords(torch.as_tensor(cols, device=dev), G)
    a64, b64 = a.cpu().numpy(), b.cpu().numpy()
    sq64 = ((a64[:, None, :] - b64[None, :, :]) ** 2).sum(-1)
    t64 = host_stage(sq64, "t", NU)
    w = SIZES[small]["x_block"]
    worst = [(i, k * w) for k, i in enumerate(WORST_I) if i < len(a64)]
    for label, stage in X_STAGES:
        oh, ol = gram_df_stage(a, b, 1.0, family="matern", nu=NU, stage=stage)
        got, ref = pair(oh, ol), host_stage(sq64, stage, NU)
        d_ = np.abs(got - ref)
        i, j = np.unravel_index(np.argmax(d_), d_.shape)
        hi, lo = oh.cpu().numpy(), ol.cpu().numpy()
        dec = max(decimal_rel(hi[r, c], lo[r, c], decimal_stage(
            decimal_sq(a64[r], b64[c]), stage, NU)) for r, c in worst)
        if stage == "sq":
            rel = {"rel_row": float((d_ / sq64.max(1, keepdims=True)).max())}
        else:
            rel = {"rel": float(rel_err(got, ref).max())}
        r = _record(results, f"X {label}", abs=float(d_.max()),
                    decimal_rel=dec, **rel)
        print(f"X {label:5s}: abs err max {r['abs']:.2e} at (sq="
              f"{sq64[i, j]:.4e}, t={t64[i, j]:.5f}); "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f"; rel(decimal) at the TPU's worst pairs {dec:.2e}",
              flush=True)


def run(device=None, small=False) -> dict:
    """Replay P, T, U and X on `device` (default: the card). Returns
    {stage label: its numbers, with "ok" when within DF_RTOL}."""
    dev = resolve_device(device)
    if small:
        s = SIZES[True]
        print(f"--small: P {s['p_rows']} x 128 of the 512 x 128 grid; T "
              f"{s['t_pairs']} x {s['t_pairs']} pairs of 512 x 512; U "
              f"{s['u'][0]} x {s['u'][1]} of {T} x {N} with its top 8; X "
              f"{4 * s['x_block']} x {4 * s['x_block']} of 512 x 512",
              flush=True)
    results = {}
    probe_p(dev, small, results)
    probe_t(dev, small, results)
    probe_u(dev, small, results)
    probe_x(dev, small, results)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--small", action="store_true",
                        help="cut every size for a CPU run")
    args = parser.parse_args(argv)
    results = run(args.device, args.small)
    failed = [label for label, r in results.items() if not r["ok"]]
    if failed:
        print(f"df-entry probe: {len(failed)} of {len(results)} stages miss "
              f"the {DF_RTOL} bar: {failed}", flush=True)
        return 1
    print(f"df-entry probe: all {len(results)} stages within {DF_RTOL} "
          "relative", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
