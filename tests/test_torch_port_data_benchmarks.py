"""Port parity: stpy_tpu_torch/test_functions/{protein_benchmark,
swissfel_simulator}.py and configs.py against stpy_tpu on the CPU, JAX in
x64 and torch in float64, the same numpy inputs from a seed.

`ProteinOperator`, `synthetic` and `from_file` agree exactly (codes,
one-hot rows, targets), a GP on the synthetic landscape within 1e-10;
`FelSimulator.from_arrays` + `fit_simulator` give the same data exactly
and γ and the mean within 1e-6; the three configs build models with the
same `mean_std` or Gram (1e-10).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import configs as jcfg
from stpy_tpu import test_functions as jtf
from stpy_tpu.domains import HierarchicalBorelSets as JHier
from stpy_tpu.models import GaussianProcess as JGP
from stpy_tpu_torch import configs as tcfg
from stpy_tpu_torch import test_functions as ttf
from stpy_tpu_torch.domains import HierarchicalBorelSets as THier
from stpy_tpu_torch.models import GaussianProcess as TGP

from test_torch_port_test_functions import F64, FIT_RTOL, RTOL, rel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def test_protein_operator_matches_jax():
    jop, top = jtf.ProteinOperator(), ttf.ProteinOperator(**F64)
    letters = [["A", "R", "W"], ["N", "D", "V"]]
    codes = top.translate(letters)
    np.testing.assert_array_equal(codes, jop.translate(letters))
    np.testing.assert_array_equal(top.translate_one_hot(codes),
                                  jop.translate_one_hot(codes))
    for dim in (1, 2):
        np.testing.assert_array_equal(top.interval_number(dim),
                                      jop.interval_number(dim))
        np.testing.assert_array_equal(top.interval_onehot(dim),
                                      jop.interval_onehot(dim))
        assert top.interval_letters(dim) == jop.interval_letters(dim)
    assert top.get_substitutes_from_mutation("A123T") == \
        jop.get_substitutes_from_mutation("A123T")
    assert top.mutation("AAAA", [1, 3], "RW") == jop.mutation("AAAA", [1, 3],
                                                               "RW")
    np.testing.assert_array_equal(top.translate_mutation_series("WAV"),
                                  jop.translate_mutation_series("WAV"))


def test_protein_synthetic_and_its_gp_match_jax():
    jb, jtruth = jtf.ProteinBenchmark.synthetic(dim=2, n=64, key=3,
                                                noise=0.1)
    tb, ttruth = ttf.ProteinBenchmark.synthetic(dim=2, n=64, key=3,
                                                noise=0.1, **F64)
    np.testing.assert_array_equal(tb.X, jb.X)
    np.testing.assert_array_equal(tb.y, jb.y)
    assert tb.data_summary() == jb.data_summary()
    codes = np.vstack([jb.X_codes[:5], [[19, 19]]])
    np.testing.assert_array_equal(ttruth(codes), jtruth(codes))
    np.testing.assert_array_equal(tb.eval_noiseless(codes),
                                  jb.eval_noiseless(codes))
    j, t = JGP(gamma=1.0, s=0.1, d=40), TGP(gamma=1.0, s=0.1, d=40, **F64)
    j.fit_gp(*jb.get_data())
    t.fit_gp(*tb.get_data())
    held = tb.op.translate_one_hot(np.random.default_rng(5).integers(
        0, 20, (16, 2)))
    for a, b in zip(t.mean_std(held), j.mean_std(jnp.asarray(held))):
        assert rel(a, b) < RTOL


def test_protein_from_file_matches_jax(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(3)
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    df = pd.DataFrame({f"P{i + 1}": letters[rng.integers(0, 20, 80)]
                       for i in range(4)})
    df.loc[:19, ["P3", "P4"]] = "D"
    df["Fitness"] = rng.uniform(-1.0, 3.0, 80)
    df.to_csv(tmp_path / "m.csv", index=False)
    jb = jtf.ProteinBenchmark.from_file(tmp_path / "m.csv", dim=2)
    tb = ttf.ProteinBenchmark.from_file(tmp_path / "m.csv", dim=2, **F64)
    np.testing.assert_array_equal(tb.X_codes, jb.X_codes)
    np.testing.assert_array_equal(tb.X, jb.X)
    np.testing.assert_array_equal(tb.y, jb.y)


def fel_arrays():
    rng = np.random.default_rng(3)
    x = rng.uniform(2.0, 7.0, (120, 4))
    y = 3.0 * np.sin(x[:, 0]) + x[:, 1]
    return x, y, rng.integers(0, 4, 120), np.abs(rng.normal(0.1, 0.02, 120))


def test_fel_simulator_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    j = jtf.FelSimulator(d=2, sigma=0.01).from_arrays(*fel_arrays())
    t = ttf.FelSimulator(d=2, sigma=0.01, **F64).from_arrays(*fel_arrays())
    np.testing.assert_array_equal(t.x, j.x)
    np.testing.assert_array_equal(t.y, j.y)
    assert t.s == j.s
    np.testing.assert_array_equal(t.bounds(), j.bounds())
    gj = j.fit_simulator(JGP(gamma=1.0, s=j.s, d=2), restarts=1)
    gt = t.fit_simulator(TGP(gamma=1.0, s=t.s, d=2, **F64), restarts=1)
    assert float(gt.kernel_object.params_dict["0"]["gamma"]) == pytest.approx(
        float(gj.kernel_object.params_dict["0"]["gamma"]), rel=FIT_RTOL)
    X = np.random.default_rng(6).uniform(-0.5, 0.5, (10, 2))
    assert rel(t.eval_noiseless(X), j.eval_noiseless(jnp.asarray(X))) \
        < FIT_RTOL
    assert t.eval(X, generator=torch.Generator().manual_seed(0)).shape == \
        (10, 1)
    # the HDF5 reader and the npz checkpoint give the same data
    x, y, line, sd = fel_arrays()
    with h5py.File(tmp_path / "fel.h5", "w") as f:
        g = f.create_group("1")
        for k, v in (("x", x), ("y", y), ("line_id", line), ("y_std", sd)):
            g[k] = v
    t2 = ttf.FelSimulator(d=2, sigma=0.01, **F64).from_file(
        tmp_path / "fel.h5")
    np.testing.assert_array_equal(t2.x, t.x)
    t.save(tmp_path / "fel.npz")
    t3 = ttf.FelSimulator(d=2, sigma=0.01, **F64)
    t3.load_pickle(tmp_path / "fel.npz")
    np.testing.assert_array_equal(t3.y, t.y)


def test_configs_build_equal_models():
    kc = dict(kernel_name="ard", d=3, ard_gamma=(0.5, 0.7, 0.9))
    jk = jcfg.KernelConfig(**kc).build()
    tk = tcfg.KernelConfig(**kc).build(**F64)
    X = np.random.default_rng(0).uniform(-1, 1, (15, 3))
    assert rel(tk.gram(torch.as_tensor(X)), jk.gram(jnp.asarray(X))) < RTOL
    j = jcfg.GPConfig(kernel=jcfg.KernelConfig(gamma=0.5), s=0.05).build()
    t = tcfg.GPConfig(kernel=tcfg.KernelConfig(gamma=0.5), s=0.05).build(
        **F64)
    assert t.s == j.s == 0.05
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (40, 1))
    j.fit_gp(jnp.asarray(x), jnp.asarray(np.sin(3 * x)))
    t.fit_gp(x, np.sin(3 * x))
    xt = np.linspace(-1, 1, 9)[:, None]
    for a, b in zip(t.mean_std(xt), j.mean_std(jnp.asarray(xt))):
        assert rel(a, b) < RTOL
    cfg = dict(d=1, m=16, basis="triangle", estimator="likelihood", B=2.0)
    je = jcfg.PoissonRateConfig(**cfg).build(
        None, JHier(d=1, interval=(-1, 1), levels=3))
    te = tcfg.PoissonRateConfig(**cfg).build(
        None, THier(d=1, interval=(-1, 1), levels=3, **F64), **F64)
    assert te.get_m() == je.get_m() == 16 and te.estimator == je.estimator
    assert rel(te.packing.embed(xt), je.packing.embed(jnp.asarray(xt))) \
        < RTOL
    with pytest.raises(ValueError, match="kernel_name"):
        tcfg.KernelConfig(kernel_name="sqexp")
    with pytest.raises(ValueError, match="loss"):
        tcfg.GPConfig(loss="l3")
    with pytest.raises(ValueError, match="basis"):
        tcfg.PoissonRateConfig(basis="triangles")
