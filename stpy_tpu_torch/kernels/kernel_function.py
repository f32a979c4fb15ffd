"""KernelFunction: named kernel with `+`/`*` algebra and a params dict.

Port of stpy_tpu/kernels/kernel_function.py for the atoms of the exact-GP
slice: `squared_exponential`, `ard`, `matern` and `ard_matern` with
ν ∈ {½, 3/2, 5/2}, routed to the fused Gram of ops/gram.py, and `laplace`,
routed to the L1 Gram of ops/gram_l1.py. Any other kernel raises
NotImplementedError naming its ROADMAP item. With ``device=None`` the kernel
lives on the card (config.resolve_device).

Hyperparameters live in ``params_dict`` as nested dicts of float64 tensors on
the kernel's device, whatever the working ``dtype``: the double tier reads
their full value, so the JAX package's f32 lo-limb shadows
(`_record_lo`, `lo_limbs`, `params_with_lo`) have no counterpart here.

Convention: `cross(a, b)` and `gram(x)` return K[i, j] = k(a_i, b_j) of
shape (n_a, n_b); the reference-compatible `kernel(a, b)` returns the
transpose (n_b, n_a).
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.ops import gram as gram_ops
from stpy_tpu_torch.ops import gram_l1

_TAIL = "ROADMAP Queue 1 item 7 (the kernel tail and the general double tier)"


class _Atom:
    """One named kernel with its static options."""

    def __init__(self, name: str, static: dict, fn):
        self.name = name
        self.static = static  # group / nu
        self.fn = fn          # f(params, a, b) -> (n_a, n_b)

    def __call__(self, params, a, b):
        return self.fn(params, a, b)


class KernelFunction:
    def __init__(
        self,
        kernel_function=None,
        kernel_name: str = "squared_exponential",
        freq=None,
        groups=None,
        d: int = 1,
        gamma=1.0,
        ard_gamma=None,
        nu=1.5,
        kappa=1.0,
        map=None,
        power=2,
        cov=None,
        params=None,
        group=None,
        offset=0.0,
        gamma_fun=None,
        device=None,
        dtype=torch.float32,
    ):
        self.d = d
        self.group = list(range(d)) if group is None else list(group)
        self.groups = groups
        self.device = resolve_device(device)
        self.dtype = dtype
        if kernel_function is not None:
            raise NotImplementedError(f"custom kernel functions: {_TAIL}")
        name = kernel_name
        if name not in ("squared_exponential", "ard", "matern", "ard_matern",
                        "laplace"):
            raise NotImplementedError(f"kernel {name!r}: {_TAIL}")
        if name == "ard" and groups is not None:
            raise NotImplementedError(f"additive ard over groups: {_TAIL}")
        if name in ("matern", "ard_matern") and float(nu) not in (0.5, 1.5, 2.5):
            raise NotImplementedError(f"general-nu Matérn (nu={nu}): {_TAIL}")

        p = {"kappa": self._param(kappa)}
        static = {"group": self.group}
        if name in ("squared_exponential", "matern", "laplace"):
            p["gamma"] = self._param(gamma)
        else:
            g = self._param(1.0 if ard_gamma is None else ard_gamma).reshape(-1)
            p["ard_gamma"] = g.expand(d).clone() if g.numel() == 1 else g
        if name in ("matern", "ard_matern"):
            static["nu"] = float(nu)
        if params:
            p.update({k: self._param(v) for k, v in params.items()})

        self.optkernel = name
        self._atoms = [_Atom(name, static, self._make_fn(name, static))]
        self.operations = ["-"]
        self.params_dict = {"0": p}
        self.kernel_items = 1

    def _param(self, v):
        return as_tensor(v, device=self.device, dtype=torch.float64)

    # -- functional dispatch -------------------------------------------------
    @staticmethod
    def _make_fn(name, static):
        group = static["group"]
        nu = static.get("nu")

        def select(a):
            if group == list(range(a.shape[1])):
                return a
            return a[:, torch.as_tensor(group, device=a.device)]

        def gamma_of(p):
            if name in ("ard", "ard_matern"):
                return p["ard_gamma"][torch.as_tensor(group,
                                                      device=p["ard_gamma"].device)]
            return p["gamma"]

        if name in ("squared_exponential", "ard"):
            def fn(p, a, b):
                return gram_ops.gram_se(select(a), select(b), gamma_of(p),
                                        p.get("kappa", 1.0))
            return fn

        if name == "laplace":
            def fn(p, a, b):
                return gram_l1.gram_laplace(select(a), select(b), p["gamma"],
                                            p.get("kappa", 1.0))
            return fn

        def fn(p, a, b):
            return gram_ops.gram_matern(select(a), select(b), gamma_of(p),
                                        p.get("kappa", 1.0), nu=nu)
        return fn

    # -- algebra (parity: stpy/kernels.py:76-94) ------------------------------
    def _combine(self, other: "KernelFunction", op: str) -> "KernelFunction":
        self._atoms = self._atoms + other._atoms
        self.operations = self.operations + other.operations[1:]
        for value in other.params_dict.values():
            self.params_dict[str(self.kernel_items)] = value
            self.kernel_items += 1
        self.operations.append(op)
        return self

    def __add__(self, other):
        diff = len(set(other.group) - set(self.group))
        self.d += diff
        return self._combine(other, "+")

    def __mul__(self, other):
        return self._combine(other, "*")

    # -- evaluation ------------------------------------------------------------
    def eval_params(self, params_dict, a, b) -> torch.Tensor:
        """Evaluation with an explicit params dict; (n_a, n_b). Atoms after
        the first fold into the first atom's fresh Gram in place."""
        out = None
        for i, atom in enumerate(self._atoms):
            # partial overrides fall back per-parameter to stored values
            p = {**self.params_dict[str(i)], **params_dict.get(str(i), {})}
            K = atom(p, a, b)
            op = self.operations[i]
            if op == "-":
                out = K
            elif out.requires_grad or K.requires_grad:
                out = out + K if op == "+" else out * K
            else:
                out = out.add_(K) if op == "+" else out.mul_(K)
        return out

    def _input(self, x):
        return as_tensor(x, device=self.device, dtype=self.dtype)

    def cross(self, a, b, params_dict=None) -> torch.Tensor:
        """K[i, j] = k(a_i, b_j), shape (n_a, n_b)."""
        return self.eval_params(params_dict or self.params_dict,
                                self._input(a), self._input(b))

    def gram(self, x, params_dict=None) -> torch.Tensor:
        x = self._input(x)
        K = self.eval_params(params_dict or self.params_dict, x, x)
        return 0.5 * (K + K.T)  # exact symmetry for Cholesky

    def diag(self, x, params_dict=None) -> torch.Tensor:
        """k(x_i, x_i): κ for every stationary atom of this slice."""
        x = self._input(x)
        pd = params_dict or self.params_dict
        out = None
        for i in range(len(self._atoms)):
            p = pd.get(str(i), self.params_dict[str(i)])
            v = torch.full((x.shape[0],), float(p.get("kappa", 1.0)),
                           dtype=x.dtype, device=x.device)
            op = self.operations[i]
            out = v if op == "-" else (out + v if op == "+" else out * v)
        return out

    # -- reference-compatible surface -------------------------------------------
    def kernel(self, a, b, **kwargs):
        """Reference convention (stpy/kernels.py:136): returns (n_b, n_a)."""
        pd = kwargs if kwargs else None
        return self.cross(a, b, params_dict=pd).T

    def kernel_diag(self, a, b, **kwargs):
        pd = kwargs if kwargs else None
        return self.diag(a, params_dict=pd).reshape(-1, 1)

    def get_kernel(self):
        return self.kernel

    def get_param_refs(self):
        return self.params_dict

    def set_params(self, params_dict):
        """Write optimized numeric params back (stored as f64 tensors)."""
        for k, v in params_dict.items():
            self.params_dict[k].update({n: self._param(t) for n, t in v.items()})

    def embed(self, x):
        """A finite-dimensional embedding: only the linear kernel has one
        (the kernel tail, ROADMAP Queue 1 item 7)."""
        raise AttributeError(
            "This type of kernel does not support a finite dimensional "
            "embedding")

    def get_basis_size(self):
        raise AttributeError(
            "This type of kernel does not support a finite dimensional "
            "embedding")

    def description(self) -> str:
        lines = ["Kernel description:"]
        for i, atom in enumerate(self._atoms):
            lines.append(f"  kernel: {atom.name}  op: {self.operations[i]}")
            for k, v in self.params_dict[str(i)].items():
                lines.append(f"    {k}={v}")
        return "\n".join(lines)
