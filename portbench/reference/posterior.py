"""The plain reference: exact GP regression in plain PyTorch.

It rebuilds everything from the inputs the harness hands it (training rows,
targets, test points, the configuration's kernel and noise): the Gram by
direct differences, its dense Cholesky factor, the solves, the posterior
mean and variance. It imports nothing of the program and takes nothing the
program made.

``precision`` picks how it is computed:

* ``"float64"``: the reference. torch.linalg in float64, no jitter.
* ``"float32"``: the same in float32 (TF32 off): the control of a
  configuration served in double precision.
* ``"tf32"``: the control of a configuration served in float32. The Gram's
  entries are formed in float32 (elementwise work, as the program's Gram
  kernels do it); every matrix product of the factor, the solves and the
  mean takes its operands rounded to TF32 (10 mantissa bits) and sums in
  float32, as TF32 tensor cores do: a right-looking blocked Cholesky whose
  trailing updates, and blocked triangular solves whose updates, are such
  products. Only the diagonal blocks (`NB` wide) are factored and solved in
  float32.

A factor that fails in a control precision is retried with the program's
jitter ladder (1e-6 of the mean diagonal, then ×10, six times), so the
control gives a number where the program would.
"""

from __future__ import annotations

import math

import torch

from portbench.plugins import Pieces

NB = 1024          # block of the TF32 factor and solves
_LADDER = (0.0,) + tuple(1e-6 * 10.0 ** k for k in range(7))


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """`t` (float32) rounded to the nearest TF32 value, ties away from zero:
    the low 13 of float32's 23 mantissa bits cleared."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, precision):
    if precision == "tf32":
        return to_tf32(a) @ to_tf32(b)
    return a @ b


def _dtype(precision):
    return torch.float64 if precision == "float64" else torch.float32


def own_families(atoms: list[dict]) -> dict:
    """The families of portbench/families/ that `atoms` name."""
    return Pieces().families({"kernel": atoms})


def gram(a: torch.Tensor, b: torch.Tensor, atoms: list[dict],
         families: dict) -> torch.Tensor:
    """Σ_atoms κ · k(‖a_i − b_j‖/γ) in a's dtype, the squared distances
    summed coordinate by coordinate (no cancellation; 0 where a_i = b_j);
    k is the correlation of the atom's family (`families`: name ->
    module, as portbench/families/ holds them)."""
    K = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    for atom in atoms:
        g = float(atom["gamma"])
        sa, sb = a / g, b / g
        sq = torch.zeros_like(K)
        for k in range(a.shape[1]):
            sq.add_((sa[:, k, None] - sb[None, :, k]).square_())
        K.add_(families[atom["family"]].correlation(sq, atom),
               alpha=float(atom.get("kappa", 1.0)))
        del sq
    return K


def _chol_tf32(A: torch.Tensor) -> torch.Tensor | None:
    """Right-looking blocked Cholesky, trailing updates in TF32."""
    A = A.clone()
    n = A.shape[0]
    for k in range(0, n, NB):
        e = min(k + NB, n)
        L11, info = torch.linalg.cholesky_ex(A[k:e, k:e])
        if int(info):
            return None
        A[k:e, k:e] = L11
        if e < n:
            L21 = torch.linalg.solve_triangular(L11, A[e:, k:e].T,
                                                upper=False).T
            A[e:, k:e] = L21
            L21 = to_tf32(L21)
            A[e:, e:] -= L21 @ L21.T
    return A.tril_()


def cholesky(A: torch.Tensor, precision: str) -> tuple[torch.Tensor, float]:
    """(L, jitter) with L Lᵀ = A + jitter·I. float64: no jitter, and a
    failure raises."""
    scale = float(torch.mean(torch.diagonal(A)))
    for rung in _LADDER:
        Aj = A
        if rung:
            Aj = A.clone()
            Aj.diagonal().add_(rung * scale)
        if precision == "tf32":
            L = _chol_tf32(Aj)
        else:
            L, info = torch.linalg.cholesky_ex(Aj)
            L = None if int(info) else L
        if L is not None:
            return L, rung * scale
        if precision == "float64":
            raise RuntimeError("the float64 Gram is not positive definite")
    raise RuntimeError(f"no {precision} factor within the jitter ladder")


def solve_lower(L: torch.Tensor, B: torch.Tensor, precision: str):
    """L⁻¹B."""
    if precision != "tf32":
        return torch.linalg.solve_triangular(L, B, upper=False)
    X = B.clone()
    n = L.shape[0]
    for k in range(0, n, NB):
        e = min(k + NB, n)
        X[k:e] = torch.linalg.solve_triangular(L[k:e, k:e], X[k:e],
                                               upper=False)
        if e < n:
            X[e:] -= to_tf32(L[e:, k:e]) @ to_tf32(X[k:e])
    return X


def solve_upper_t(L: torch.Tensor, B: torch.Tensor, precision: str):
    """L⁻ᵀB."""
    if precision != "tf32":
        return torch.linalg.solve_triangular(L.T, B, upper=True)
    X = B.clone()
    n = L.shape[0]
    for k in reversed(range(0, n, NB)):
        e = min(k + NB, n)
        X[k:e] = torch.linalg.solve_triangular(L[k:e, k:e].T, X[k:e],
                                               upper=True)
        if k:
            X[:k] -= to_tf32(L[k:e, :k]).T @ to_tf32(X[k:e])
    return X


def posterior(x, y, xt, atoms, s, precision="float64", mean_points=None,
              std_points=0, families=None):
    """The exact posterior of GP regression with kernel `atoms` and noise
    standard deviation `s`: (mean at xt[:mean_points], std at
    xt[:std_points] or None, the jitter the factor needed), in the
    precision's dtype. `families` as `gram` takes them; by default
    portbench/families/'s."""
    families = families or own_families(atoms)
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = _dtype(precision)
    x, y, xt = (t.to(dt) for t in (x, y.reshape(-1, 1), xt))
    pm = xt.shape[0] if mean_points is None else mean_points
    K = gram(x, x, atoms, families)
    K.diagonal().add_(float(s) ** 2)
    L, jitter = cholesky(K, precision)
    del K
    alpha = solve_upper_t(L, solve_lower(L, y, precision), precision)
    Ks = gram(xt[:pm], x, atoms, families)
    mu = _mm(Ks, alpha, precision)[:, 0]
    sd = None
    if std_points:
        Kv = (Ks[:std_points] if std_points <= pm
              else gram(xt[:std_points], x, atoms, families))
        del Ks
        V = solve_lower(L, Kv.T, precision)
        prior = sum(float(a.get("kappa", 1.0)) for a in atoms)
        var = prior - V.square_().sum(dim=0)
        sd = torch.sqrt(torch.clamp(var, min=1e-30))
    return mu, sd, jitter


def errors(outputs, mu_ref, sd_ref) -> dict:
    """mean_err: max |μ − μ_ref| over max |μ_ref|; std_err: max of
    |σ − σ_ref| / σ_ref; each the worst over `outputs`, (kind, points,
    tensor) with kind "mean" or "std" at the first `points` test points."""
    errs = {}
    for kind, p, t in outputs:
        v = t.reshape(-1).to(torch.float64)
        if kind == "mean":
            ref = mu_ref[:p]
            e = float((v - ref).abs().max() / ref.abs().max())
        else:
            ref = sd_ref[:p]
            e = float(((v - ref).abs() / ref).max())
        e = e if math.isfinite(e) else math.inf
        name = f"{kind}_err"
        errs[name] = max(errs.get(name, 0.0), e)
    return errs


def judge(config, families, x, y, xt, outputs, control=None):
    """The outputs of one call against the float64 posterior of the
    configuration's kernel and noise on the same inputs: (the numbers of
    `errors`, and with `control` the same numbers of the reference
    computed in that precision in the program's place, else None)."""
    atoms, s = config["kernel"], config["s"]
    pm = max([p for k, p, _ in outputs if k == "mean"], default=0)
    ps = max([p for k, p, _ in outputs if k == "std"], default=0)
    mu, sd, _ = posterior(x, y, xt, atoms, s, "float64", pm, ps, families)
    prog, ctrl = errors(outputs, mu, sd), None
    if control:
        cmu, csd, _ = posterior(x, y, xt, atoms, s, control, pm, ps,
                                families)
        ctrl = errors([(k, p, (cmu if k == "mean" else csd)[:p])
                       for k, p, _ in outputs], mu, sd)
    return prog, ctrl
