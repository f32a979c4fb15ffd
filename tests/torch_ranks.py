"""Rank-side code of the port's multi-rank tests: gloo ranks on the CPU.

`Ranks(cases, worlds, tmp)` spawns, for each world size, that many
processes with the `spawn` start method (the test process has JAX's threads
running, which a fork would copy mid-flight), each on one intra-op thread;
they meet through a `FileStore` in `tmp` (no TCP port: several test workers
run at once), run `cases(rank, world)` and write its numpy results to
`tmp/<cases>-<world>-<rank>.npz`, which `Ranks` reads back. The worlds
start together and are joined with a deadline when a test first reads
them, so a rank that hangs fails the test instead of the run.

This module imports torch and the port only, so no rank imports JAX. The
data of each case is made here from numpy seeds, and the test modules
import the same functions to feed the JAX package.
"""

from __future__ import annotations

import datetime
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE_S = 300


def _rank_main(rank, world, tmp, name):
    torch.set_num_threads(1)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    out = os.path.join(tmp, f"{name}-{world}-{rank}")
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, f"store-{name}-"
                                                      f"{world}"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=DEADLINE_S))
        results = globals()[name](rank, world)
        np.savez(out + ".npz", **results)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """The spawned worlds of one `cases` function, joined on first read:
    `ranks[world]` is [rank 0's results, rank 1's, ...]. A test module
    starts them first and computes its JAX references while they run."""

    def __init__(self, name, worlds, tmp):
        self.name, self.worlds, self.tmp = name, tuple(worlds), str(tmp)
        self._ctxs = {w: mp.start_processes(
            _rank_main, args=(w, self.tmp, name), nprocs=w,
            start_method="spawn", join=False) for w in self.worlds}
        self._t0 = time.monotonic()
        self._results = None

    def __getitem__(self, world):
        if self._results is None:
            self._results = self._join()
        return self._results[world]

    def _join(self):
        try:
            for w, ctx in self._ctxs.items():
                while not ctx.join(timeout=1):
                    if time.monotonic() - self._t0 > DEADLINE_S:
                        raise TimeoutError(f"{self.name}: world {w} ran past "
                                           f"{DEADLINE_S} s")
        except Exception as e:
            errs = [open(os.path.join(self.tmp, f)).read()
                    for f in os.listdir(self.tmp) if f.endswith(".err")]
            raise RuntimeError(f"{e}\n" + "\n".join(errs)) from None
        finally:
            self.close()
        return {w: [dict(np.load(os.path.join(
            self.tmp, f"{self.name}-{w}-{r}.npz"))) for r in range(w)]
            for w in self.worlds}

    def close(self):
        """Kill any rank still running (a test module ended before its
        results were read)."""
        for ctx in self._ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()


# -- data, shared with the test modules ---------------------------------------

def gram_points():
    return np.random.default_rng(0).standard_normal((64, 3))


def evidence_data():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (64, 2))
    return x, np.sin(x[:, :1])


def gradient_data():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (32, 1))
    return x, np.sin(3 * x)


FARM_GAMMAS = np.linspace(0.2, 1.6, 8)


def farm_data():
    x, y = gradient_data()
    return x[:16], y[:16]


def lazy_data():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (64, 2))
    y = np.sin(3 * x[:, :1]) + 0.05 * rng.standard_normal((64, 1))
    return x, y, rng.uniform(-1, 1, (16, 2)), rng.standard_normal((64, 3))


def spd(n, seed):
    A = np.random.default_rng(seed).standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


BLOCKED_N, BLOCKED_REFIT_N, BLOCKED_NB = 250, 150, 64


def blocked_data(n=BLOCKED_N, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    y = np.sin(3 * x[:, :1]) * np.cos(2 * x[:, 1:]) \
        + 0.01 * rng.standard_normal((n, 1))
    return x, y, rng.uniform(-1, 1, (48, 2))


def feature_data(n=256, d=1, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(3 * x[:, :1]) + 0.05 * rng.standard_normal((n, 1))
    return x, y


def partition(a, world, rank):
    """Rank `rank`'s own contiguous rows of `a`."""
    nl = a.shape[0] // world
    return a[rank * nl:(rank + 1) * nl]


def global_batches(a, world, batch_size):
    """The rows of a sharded loader's global batches, in order: batch b is
    every rank's rows [b·lb, (b + 1)·lb) of its partition, rank by rank."""
    lb = batch_size // world
    nb = (a.shape[0] // world) // lb
    return np.concatenate([partition(a, world, r)[b * lb:(b + 1) * lb]
                           for b in range(nb) for r in range(world)])


# -- the port's objects, float64 on the CPU ------------------------------------

F64 = torch.float64


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def se(gamma, d, **kw):
    from stpy_tpu_torch.kernels import KernelFunction

    return KernelFunction(kernel_name="squared_exponential", gamma=gamma,
                          d=d, device="cpu", dtype=F64, **kw)


def matern(gamma, d, nu=1.5):
    from stpy_tpu_torch.kernels import KernelFunction

    return KernelFunction(kernel_name="matern", gamma=gamma, nu=nu, d=d,
                          device="cpu", dtype=F64)


def laplace(gamma, d):
    from stpy_tpu_torch.kernels import KernelFunction

    return KernelFunction(kernel_name="laplace", gamma=gamma, d=d,
                          device="cpu", dtype=F64)


def lazy_kernel(case):
    """tests/test_parallel.py:468-507's cases, fresh objects (`+`/`*`
    mutate their left operand)."""
    if case == "atom":
        return se(0.5, 2)
    if case == "sum":
        return se(0.5, 2) + matern(0.8, 2)
    if case == "product":
        return se(0.5, 2) * matern(0.8, 2)
    if case == "laplace":
        return laplace(0.8, 2)
    return se(0.6, 2) + matern(0.9, 2)          # "double"


def mesh_for(world, shape=None, names=("dp", "tp")):
    from stpy_tpu_torch.parallel import make_mesh

    return make_mesh(shape or (1, world), names, device="cpu")


def np_(t):
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


# -- cases: parallel/mesh.py and the sharded products ---------------------------

def mesh_cases(rank, world):
    from stpy_tpu_torch.parallel import (
        distributed_evidence, make_lazy_matvec_sharded, replicate,
        restart_farm, shard_rows, sharded_gram,
    )
    from stpy_tpu_torch.parallel.lazy_kernel import (
        atom_params, fast_atoms, make_chunked_matmat_sharded,
        make_chunked_matvec_sharded, make_sum_matmat_sharded,
        make_sum_matvec_sharded,
    )

    mesh = mesh_for(world)
    out = {}
    x = t64(gram_points())
    xs = shard_rows(x, mesh, "tp")
    out["shard_local"] = xs.to_local().numpy()
    out["shard_full"] = np_(xs)
    out["replicate_local"] = replicate(x, mesh).to_local().numpy()
    k = se(0.7, 3)
    K = sharded_gram(lambda a, b: k.eval_params(k.params_dict, a, b), xs,
                     mesh, "tp")
    out["gram_local_rows"] = np.asarray(K.to_local().shape)
    out["gram"] = np_(K)

    xe, ye = evidence_data()
    ke = se(0.5, 2)
    nll = distributed_evidence(ke, mesh, "tp")
    out["evidence"] = np.asarray(float(nll(ke.params_dict, 0.1, t64(xe),
                                           shard_rows(t64(ye), mesh, "tp"))))
    xg, yg = gradient_data()
    kg = se(0.5, 1)
    g = torch.tensor(0.5, dtype=F64, requires_grad=True)
    s = torch.tensor(0.1, dtype=F64, requires_grad=True)
    val = distributed_evidence(kg, mesh, "tp")({"0": {"gamma": g}}, s,
                                               shard_rows(t64(xg), mesh, "tp"),
                                               t64(yg))
    gg, gs = torch.autograd.grad(val, (g, s))
    out["evidence_grad"] = np.asarray([val.item(), gg.item(), gs.item()])

    farm_mesh = mesh_for(world, (world, 1))
    xf, yf = (t64(a) for a in farm_data())

    def farm_nll(gamma):
        sq = (xf - xf.T) ** 2
        A = torch.exp(-0.5 * sq / gamma ** 2) + 0.01 * torch.eye(
            xf.shape[0], dtype=F64)
        L = torch.linalg.cholesky(A)
        alpha = torch.cholesky_solve(yf, L)
        return 0.5 * (yf.T @ alpha)[0, 0] + torch.sum(
            torch.log(torch.diagonal(L)))

    farm = restart_farm(torch.func.grad_and_value(farm_nll), 8, farm_mesh,
                        "dp")
    fg, fv = farm((t64(FARM_GAMMAS),))
    out["farm_grad"], out["farm_value"] = fg.numpy(), fv.numpy()
    sq_farm = restart_farm(lambda th: torch.sum(th ** 2), 8, farm_mesh, "dp")
    out["farm_sq"] = sq_farm((torch.arange(8.0, dtype=F64)[:, None]
                              * torch.ones((8, 4), dtype=F64),)).numpy()

    xl, _, _, V = lazy_data()
    xl, V = t64(xl), t64(V)
    for fam, nu in (("se", 1.5), ("matern", 1.5)):
        mv = make_lazy_matvec_sharded(xl, mesh, "tp", family=fam, gamma=0.6,
                                      kappa=1.3, nu=nu, noise=0.1)
        out[f"lazy_matvec_{fam}"] = mv(V[:, 0]).numpy()
    for case in ("sum", "atom"):
        ko = lazy_kernel(case)
        atoms = fast_atoms(ko)
        gk = [atom_params(ko, a) for a in atoms]
        gs_, ks_ = [g_ for g_, _ in gk], [k_ for _, k_ in gk]
        out[f"sum_matvec_{case}"] = make_sum_matvec_sharded(
            xl, mesh, "tp", atoms, gs_, ks_, noise=0.1)(V[:, 0]).numpy()
        out[f"sum_matmat_{case}"] = make_sum_matmat_sharded(
            xl, mesh, "tp", atoms, gs_, ks_, noise=0.1)(V).numpy()
    for case in ("product", "laplace"):
        ko = lazy_kernel(case)
        out[f"chunked_matvec_{case}"] = make_chunked_matvec_sharded(
            ko, shard_rows(xl, mesh, "tp"), mesh, "tp", noise=0.1,
            chunk=5)(V[:, 0]).numpy()
        out[f"chunked_matmat_{case}"] = make_chunked_matmat_sharded(
            ko, xl, mesh, "tp", noise=0.1, chunk=5)(V).numpy()
    return out


# -- cases: the mesh tiers of IterativeGP ------------------------------------

LAZY_CASES = ("atom", "sum", "product")


def iterative_cases(rank, world):
    from stpy_tpu_torch.parallel import IterativeGP

    mesh = mesh_for(world)
    x, y, xt, _ = lazy_data()
    out = {}
    for case in LAZY_CASES:
        gp = IterativeGP(lazy_kernel(case), s=0.1, mesh=mesh, axis="tp",
                         lazy=True, tol=1e-10, chunk=16)
        gp.fit_gp(x, y)
        mu, sd = gp.mean_std(xt)
        out[f"lazy_{case}_mu"], out[f"lazy_{case}_sd"] = mu.numpy(), sd.numpy()
        out[f"lazy_{case}_cg"] = np.asarray([gp.cg_residual,
                                             gp.cg_iterations])
    gp = IterativeGP(lazy_kernel("sum"), s=0.1, mesh=mesh, axis="tp",
                     lazy=False, tol=1e-10)
    gp.fit_gp(x, y)
    mu, sd = gp.mean_std(xt)
    out["dense_mu"], out["dense_sd"] = mu.numpy(), sd.numpy()
    out["dense_alpha"] = gp.A.numpy()
    out["dense_cg"] = np.asarray([gp.cg_residual, gp.cg_iterations])
    for lazy in (True, False):
        gp = IterativeGP(lazy_kernel("double"), s=0.1, mesh=mesh, axis="tp",
                         lazy=lazy, precision="double", tol=1e-8,
                         df_chunk=16)
        gp.fit_gp(x, y)
        mu, sd = gp.mean_std(xt)
        tag = "lazy" if lazy else "dense"
        out[f"double_{tag}_mu"], out[f"double_{tag}_sd"] = (mu.numpy(),
                                                            sd.numpy())
        out[f"double_{tag}_res"] = np.asarray(gp.df_residuals)
    return out


# -- cases: parallel/blocked.py ------------------------------------------------

FACTORIZATIONS = ("panels", "masked", "rec")


def blocked_cases(rank, world):
    from stpy_tpu_torch.parallel import (
        DistributedExactGP, blocked_cholesky, chol_sharded, chol_sharded_rec,
        shard_rows,
    )

    mesh = mesh_for(world, (world,), ("tp",))
    out = {}
    K = t64(spd(256, 0))
    out["blocked_dtensor"] = np_(blocked_cholesky(shard_rows(K, mesh, "tp"),
                                                  nb=BLOCKED_NB))
    Kp = t64(spd(BLOCKED_N, 1))
    L = chol_sharded(Kp, mesh, "tp", nb=BLOCKED_NB)
    out["chol_sharded"], out["chol_sharded_shape"] = np_(L), np.asarray(
        L.shape)
    out["chol_sharded_rec"] = np_(chol_sharded_rec(Kp, mesh, "tp",
                                                   nb=BLOCKED_NB))
    x, y, xt = blocked_data()
    for fac in FACTORIZATIONS:
        gp = DistributedExactGP(se(0.5, 2), s=0.1, mesh=mesh,
                                nb=BLOCKED_NB, factorization=fac)
        gp.fit_gp(x, y)
        mu, sd = gp.mean_std(xt)
        out[f"{fac}_mu"], out[f"{fac}_sd"] = mu.numpy(), sd.numpy()
        out[f"{fac}_L_local_shape"] = np.asarray(gp.L.to_local().shape)
        if fac == "panels":
            x2, y2, _ = blocked_data(BLOCKED_REFIT_N, seed=9)
            gp.fit_gp(x2, y2)
            mu, sd = gp.mean_std(x2[:10])
            out["refit_mu"], out["refit_sd"] = mu.numpy(), sd.numpy()
    return out


# -- cases: parallel/data.py ------------------------------------------------------

FEATURE_BATCH = 64


def feature_model():
    from stpy_tpu_torch.embeddings import HermiteEmbedding
    from stpy_tpu_torch.models import KernelizedFeatures

    emb = HermiteEmbedding(gamma=0.5, m=64, d=1, device="cpu", dtype=F64)
    return KernelizedFeatures(embedding=emb, m=emb.get_m(), s=0.05, lam=1.0,
                              primal=True, d=1)


def data_cases(rank, world):
    from stpy_tpu_torch.parallel import (
        HostShardedLoader, fit_feature_gp_sharded, host_sharded,
        streamed_feature_stats,
    )

    mesh = mesh_for(world)
    out = {}
    x, y = feature_data(200, d=2, seed=3)
    g = host_sharded(partition(x, world, rank), mesh, "tp")
    out["host_full"], out["host_local"] = np_(g), g.to_local().numpy()
    xp, yp = partition(x, world, rank), partition(y, world, rank)
    loader = HostShardedLoader(lambda lo, hi: (xp[lo:hi], yp[lo:hi]),
                               n_local=xp.shape[0], batch_size=FEATURE_BATCH,
                               mesh=mesh, axis="tp")
    batches = [tuple(np_(a) for a in b) for b in loader]
    out["n_batches"] = np.asarray([len(loader), len(batches)])
    out["batch_x"] = np.concatenate([b[0] for b in batches])
    out["batch_y"] = np.concatenate([b[1] for b in batches])
    xf, yf = feature_data()
    xfp, yfp = partition(xf, world, rank), partition(yf, world, rank)
    model = feature_model()

    def loader_f():
        return HostShardedLoader(lambda lo, hi: (xfp[lo:hi], yfp[lo:hi]),
                                 n_local=xfp.shape[0],
                                 batch_size=FEATURE_BATCH, mesh=mesh)

    V, b = streamed_feature_stats(model.embed, loader_f(), model.m)
    out["stats_V"], out["stats_b"] = V.numpy(), b.numpy()
    fit_feature_gp_sharded(model, loader_f())
    mu, sd = model.mean_std(t64(np.linspace(-1, 1, 32)[:, None]))
    out["fit_mu"], out["fit_sd"], out["fit_n"] = (mu.numpy(), sd.numpy(),
                                                  np.asarray(model.n))
    return out
