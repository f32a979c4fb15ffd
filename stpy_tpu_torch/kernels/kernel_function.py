"""KernelFunction: named kernel with `+`/`*` algebra and a params dict.

Port of stpy_tpu/kernels/kernel_function.py: every `kernel_name` of the JAX
table, custom `kernel_function=` callables (f(params, a, b) on torch
tensors) and `groups=` for the additive families. SE, ARD and Matérn with
ν ∈ {½, 3/2, 5/2} go to the fused Gram of ops/gram.py and `laplace` to the
L1 Gram of ops/gram_l1.py (hand kernels on the card); so do the SE-based
additive families, group by group. Every other atom (general-ν Matérn,
the full-covariance kernels, gibbs, linear, polynomial, tanh, step,
wiener, angsim, spectral, the maps and custom kernels) is its plain torch
function of kernels/functions.py, as it is plain jnp in the JAX package.
Each atom also keeps `plain`, its function in torch ops alone (no hand
kernel, any dtype), which the general double tier evaluates in float64.
With ``device=None`` the kernel lives on the card (config.resolve_device).

Hyperparameters live in ``params_dict`` as nested dicts of float64 tensors on
the kernel's device, whatever the working ``dtype``: the double tier reads
their full value, so the JAX package's f32 lo-limb shadows
(`_record_lo`, `lo_limbs`, `params_with_lo`) have no counterpart here. The
plain atoms take them cast to their inputs' dtype.

Convention: `cross(a, b)` and `gram(x)` return K[i, j] = k(a_i, b_j) of
shape (n_a, n_b); the reference-compatible `kernel(a, b)` returns the
transpose (n_b, n_a).
"""

from __future__ import annotations

import functools

import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.kernels import functions as F
from stpy_tpu_torch.ops import gram as gram_ops
from stpy_tpu_torch.ops import gram_l1

_FUSED_NU = (0.5, 1.5, 2.5)
# atoms whose diagonal is κ (a stationary correlation times κ)
_KAPPA_DIAG = ("squared_exponential", "ard", "matern", "ard_matern", "laplace",
               "modified_matern", "full_covariance_se",
               "full_covariance_matern", "gibbs", "gibbs_custom")
# rows per block of the generic diagonal (`_atom_diag`)
_DIAG_BLOCK = 64


def _cast_params(p, like):
    """`p` with its floating tensors in `like`'s dtype (graph-keeping)."""
    return {k: v.to(like.dtype) if isinstance(v, torch.Tensor)
            and v.is_floating_point() else v for k, v in p.items()}


def _select(a, group):
    if group is None or group == list(range(a.shape[1])):
        return a
    return a[:, torch.as_tensor(group, device=a.device)]


def _plain_fn(name, static):
    """The atom's function of kernels/functions.py (torch ops only)."""
    group, groups = static.get("group"), static.get("groups")
    nu = static.get("nu", 1.5)
    if name == "polynomial":
        degree = static.get("degree", 2)
        if groups is None:
            return functools.partial(F.polynomial, group=group, degree=degree)
        return functools.partial(F.polynomial_additive, groups=groups,
                                 degree=degree)
    if name == "ard" and groups is not None:
        return functools.partial(F.ard_additive, groups=groups)
    if name == "squared_exponential_per_group":
        return functools.partial(F.squared_exponential_per_group_additive,
                                 groups=groups)
    if name == "ard_per_group":
        return functools.partial(F.ard_per_group_additive, groups=groups)
    table = {
        "squared_exponential": functools.partial(F.squared_exponential,
                                                 group=group),
        "ard": functools.partial(F.ard, group=group),
        "laplace": functools.partial(F.laplace, group=group),
        "matern": functools.partial(F.matern, group=group, nu=nu),
        "ard_matern": functools.partial(F.ard_matern, group=group, nu=nu),
        "modified_matern": functools.partial(
            F.modified_matern, group=group, nu=int(static.get("nu", 2))),
        "full_covariance_se": functools.partial(F.covar_se, group=group),
        "full_covariance_matern": functools.partial(F.covar_matern,
                                                    group=group, nu=nu),
        "linear": functools.partial(F.linear, group=group),
        "step": functools.partial(F.step, group=group),
        "wiener": functools.partial(F.wiener, group=group),
        "tanh": functools.partial(F.tanh_kernel, group=group),
        "angsim": functools.partial(F.angsim, group=group),
        "spectral": functools.partial(F.spectral, group=group),
        "gibbs": functools.partial(F.gibbs, group=group,
                                   gamma_fun=static.get("gamma_fun")),
        "gibbs_custom": functools.partial(F.gibbs_custom, group=group,
                                          gamma_fun=static.get("gamma_fun")),
        "custom_map": functools.partial(F.custom_map, group=group,
                                        map_fn=static.get("map_fn")),
        "random_map": functools.partial(F.custom_map, group=group,
                                        map_fn=static.get("map_fn")),
    }
    if name not in table:
        raise AssertionError(f"Kernel '{name}' not implemented.")
    f = table[name]
    return lambda p, a, b: f(_cast_params(p, a), a, b)


def _fused_fn(name, static):
    """The hand-kernel route of an atom, or None where it has none."""
    group, groups = static.get("group"), static.get("groups")
    nu = static.get("nu")

    def ard_gamma(p, grp):
        g = p["ard_gamma"]
        return g[torch.as_tensor(grp, device=g.device)]

    if name == "squared_exponential":
        return lambda p, a, b: gram_ops.gram_se(
            _select(a, group), _select(b, group), p["gamma"],
            p.get("kappa", 1.0))
    if name == "ard" and groups is None:
        return lambda p, a, b: gram_ops.gram_se(
            _select(a, group), _select(b, group), ard_gamma(p, group),
            p.get("kappa", 1.0))
    if name == "laplace":
        return lambda p, a, b: gram_l1.gram_laplace(
            _select(a, group), _select(b, group), p["gamma"],
            p.get("kappa", 1.0))
    if name in ("matern", "ard_matern") and nu in _FUSED_NU:
        def fn(p, a, b):
            g = p["gamma"] if name == "matern" else ard_gamma(p, group)
            return gram_ops.gram_matern(_select(a, group), _select(b, group),
                                        g, p.get("kappa", 1.0), nu=nu)
        return fn
    if name == "ard" or name == "squared_exponential_per_group" or (
            name == "ard_per_group"):
        # the SE-based additive families: one fused Gram a group, their
        # mean times κ (stpy_tpu/kernels/functions.py:267-296)
        def fn(p, a, b):
            acc, idx = 0.0, 0
            for i, grp in enumerate(groups):
                if name == "ard":
                    g = ard_gamma(p, grp)
                elif name == "ard_per_group":
                    g = p["ard_per_group"][idx:idx + len(grp)]
                    idx += len(grp)
                else:
                    g = p["gamma_per_group"][i]
                acc = acc + gram_ops.gram_se(_select(a, grp), _select(b, grp),
                                             g, 1.0)
            return gram_ops.as_scalar_tensor(p.get("kappa", 1.0), acc) * (
                acc / float(len(groups)))
        return fn
    return None


def _atom_fns(name, static, kernel_function=None):
    """(fn, plain) of an atom: its evaluation (hand kernels where it has
    them) and its plain torch version."""
    if kernel_function is not None:
        fn = lambda p, a, b: kernel_function(_cast_params(p, a), a, b)
        return fn, fn
    plain = _plain_fn(name, static)
    return _fused_fn(name, static) or plain, plain


class _Atom:
    """One named kernel with its static options (group, groups, nu,
    degree, callables). `rebuild()` makes its functions again after a
    change to `static` (the discrete group search)."""

    def __init__(self, name: str, static: dict, kernel_function=None):
        self.name = name
        self.static = static
        self._custom = kernel_function
        self.rebuild()

    def rebuild(self):
        self.fn, self.plain = _atom_fns(self.name, self.static, self._custom)

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
        static = {"group": self.group}

        if kernel_function is not None:
            name = "custom"
            p = {k: self._maybe_param(v) for k, v in (params or {}).items()}
            p.setdefault("kappa", self._param(kappa))
        else:
            name = kernel_name
            p = {"kappa": self._param(kappa)}
            g = self._param(1.0 if ard_gamma is None else ard_gamma).reshape(-1)
            ard_gamma_arr = g.expand(d).clone() if g.numel() == 1 else g
            if name in ("squared_exponential", "laplace"):
                p["gamma"] = self._param(gamma)
            elif name == "ard":
                p["ard_gamma"] = ard_gamma_arr
                if groups is not None:
                    static["groups"] = groups
            elif name in ("matern", "modified_matern"):
                p["gamma"] = self._param(gamma)
                static["nu"] = nu if name == "modified_matern" else float(nu)
            elif name == "ard_matern":
                p["ard_gamma"] = ard_gamma_arr
                static["nu"] = float(nu)
            elif name in ("full_covariance_se", "full_covariance_matern"):
                p["cov"] = (torch.eye(d, dtype=torch.float64,
                                      device=self.device)
                            if cov is None else self._param(cov))
                if name.endswith("matern"):
                    static["nu"] = float(nu)
            elif name == "linear":
                p["offset"] = self._param(offset)
            elif name == "polynomial":
                static["degree"] = power
                if groups is not None:
                    static["groups"] = groups
            elif name == "squared_exponential_per_group":
                assert groups is not None
                static["groups"] = groups
                p["gamma_per_group"] = self._param(gamma) * torch.ones(
                    len(groups), dtype=torch.float64, device=self.device)
            elif name == "ard_per_group":
                assert groups is not None
                static["groups"] = groups
                p["ard_per_group"] = torch.ones(
                    sum(len(g) for g in groups), dtype=torch.float64,
                    device=self.device)
            elif name in ("gibbs", "gibbs_custom"):
                static["gamma_fun"] = gamma_fun
            elif name == "spectral":
                assert freq is not None, "spectral kernel needs `freq`"
                p["freq"] = self._param(freq)
            elif name in ("step", "wiener", "tanh", "angsim", "custom_map",
                          "random_map"):
                if name in ("custom_map", "random_map"):
                    # random_map = the linear kernel through a (random NN)
                    # feature map
                    static["map_fn"] = map.map if hasattr(map, "map") else map
            else:
                raise AssertionError(f"Kernel '{name}' not implemented.")
            if params:
                p.update({k: self._param(v) for k, v in params.items()})

        self.optkernel = name
        self._atoms = [_Atom(name, static, kernel_function)]
        self.operations = ["-"]
        self.params_dict = {"0": p}
        self.kernel_items = 1

    def _param(self, v):
        return as_tensor(v, device=self.device, dtype=torch.float64)

    def _maybe_param(self, v):
        """A custom kernel's parameter: numbers and arrays become float64
        tensors, anything else is kept as given."""
        try:
            return self._param(v)
        except (TypeError, ValueError, RuntimeError):
            return v

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
        the first fold into the first atom's Gram in place where that Gram
        is a fresh tensor of a built-in atom."""
        out = None
        for i, atom in enumerate(self._atoms):
            # partial overrides fall back per-parameter to stored values
            p = {**self.params_dict[str(i)], **params_dict.get(str(i), {})}
            K = atom.fn(p, a, b)
            op = self.operations[i]
            if op == "-":
                out = K
            elif (out.requires_grad or K.requires_grad
                  or self._atoms[0].name == "custom"):
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
        """k(x_i, x_i), (n,), without a full Gram."""
        x = self._input(x)
        pd = params_dict or self.params_dict
        out = None
        for i, atom in enumerate(self._atoms):
            p = pd.get(str(i), self.params_dict[str(i)])
            v = self._atom_diag(atom, p, x)
            op = self.operations[i]
            out = v if op == "-" else (out + v if op == "+" else out * v)
        return out

    @staticmethod
    def _atom_diag(atom, p, x):
        kappa = p.get("kappa", 1.0)
        if atom.name in _KAPPA_DIAG:
            return gram_ops.as_scalar_tensor(kappa, x).expand(
                x.shape[0]).clone()
        if atom.name == "linear":
            xs = _select(x, atom.static.get("group"))
            return (gram_ops.as_scalar_tensor(kappa, x) * torch.sum(xs * xs, 1)
                    + gram_ops.as_scalar_tensor(p.get("offset", 0.0), x))
        # generic: the diagonals of (64, 64) blocks k(x_r, x_r), O(64·n)
        # work and no (n, n) Gram (the JAX package vmaps n singleton
        # evaluations, which a hand-kernel atom cannot be vmapped through)
        return torch.cat([
            torch.diagonal(atom(p, x[r:r + _DIAG_BLOCK], x[r:r + _DIAG_BLOCK]))
            for r in range(0, x.shape[0], _DIAG_BLOCK)])

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

    def description(self) -> str:
        lines = ["Kernel description:"]
        for i, atom in enumerate(self._atoms):
            lines.append(f"  kernel: {atom.name}  op: {self.operations[i]}")
            for k, v in self.params_dict[str(i)].items():
                lines.append(f"    {k}={v}")
        return "\n".join(lines)

    # -- kernel derivatives (SE closed form, else autograd) ---------------------
    def _point_fn(self, fixed):
        return lambda pt: self.eval_params(self.params_dict, fixed,
                                           pt[None, :])[:, 0]

    def derivative_1(self, fixed, x):
        """d/dx k(fixed_i, x_j): (n_fixed, n_x, d)."""
        fixed, x = self._input(fixed), self._input(x)
        if self.kernel_items == 1 and self.optkernel == "squared_exponential":
            return F.squared_exponential_derivative_1(
                _cast_params(self.params_dict["0"], x), fixed, x)
        f = self._point_fn(fixed)
        jac = torch.autograd.functional.jacobian
        return torch.stack([jac(f, pt) for pt in x], dim=1)

    def derivative_2(self, fixed, x):
        """d²/dx² k(fixed_i, x_j): (n_fixed, n_x, d, d)."""
        fixed, x = self._input(fixed), self._input(x)
        if self.kernel_items == 1 and self.optkernel == "squared_exponential":
            return F.squared_exponential_derivative_2(
                _cast_params(self.params_dict["0"], x), fixed, x)
        f = self._point_fn(fixed)
        jac = torch.autograd.functional.jacobian

        def grad_f(pt):
            return jac(f, pt, create_graph=True)

        return torch.stack([jac(grad_f, pt) for pt in x], dim=1)

    get_1_der = derivative_1  # reference aliases (gauss_procc.py:452-453)
    get_2_der = derivative_2

    # -- a finite embedding: the single linear atom only ------------------------
    def embed(self, x):
        if self.optkernel == "linear" and self.kernel_items == 1:
            return self._input(x)
        raise AttributeError(
            "This type of kernel does not support a finite dimensional "
            "embedding")

    def get_basis_size(self):
        if self.optkernel == "linear" and self.kernel_items == 1:
            return self.d
        raise AttributeError(
            "This type of kernel does not support a finite dimensional "
            "embedding")
