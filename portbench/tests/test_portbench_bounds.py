"""The frozen bounds give chip_smoke.py's figures (PERF.md §6) at its
shapes."""

import pytest

from portbench.roofline import bounds


def test_gram_bound():
    ms, by = bounds.gram_bounds(16384, 16384, 8)["gram"]
    assert ms == pytest.approx(0.32083295522388056, rel=1e-12)
    assert by == "bytes"


def test_qform_bound():
    ms, by = bounds.qform_bound(16384, 16384, 16384)
    assert ms == pytest.approx(131.3090094767761, rel=1e-12)
    assert by == "operations"


@pytest.mark.parametrize("family, want", [("se", 1.282079789850746),
                                          ("matern", 2.0541433731251915)])
def test_matvec_bound(family, want):
    ms, by = bounds.matvec_bound(65536, 65536, 8, family)
    assert ms == pytest.approx(want, rel=1e-12)
    assert by == "operations"


def test_matmat_tc_bound():
    ms, _ = bounds.matmat_tc_bound(65536, 65536, 8, "se", 128)
    assert ms == pytest.approx(6.663706835006061, rel=1e-12)
    ms, _ = bounds.matmat_tc_bound(65536, 65536, 4, "se", 576)
    assert ms == pytest.approx(29.98668075752727, rel=1e-12)


def test_gram_matmat_work_unknown_without_block_solves():
    """A call that ran mean_std on the CG tier and recorded no block CG
    solve has unknown work: the roofline reads nothing, not a share of the
    preconditioner's slabs alone."""
    from types import SimpleNamespace

    from portbench.metrics.gram_matmat_roofline import read as reader
    from portbench.plugins import Pieces
    from portbench.roofline import gram_matmat as work

    config = {"train_rows": 4096, "d": 9,
              "kernel": [{"family": "se", "gamma": 0.5}]}
    families = Pieces().families(config)

    def run(status):
        calls = [SimpleNamespace(status=status)]
        profile = SimpleNamespace(kernels={"gram_matmat": 1.0})
        return SimpleNamespace(config=config, families=families,
                               calls=calls, profile=profile)

    seen = {"precond_rank": 256, "ops": ["fit", "mean_std"],
            "block_cg": [(40, 128)]}
    assert work.products(run(seen)) == 2 + 40
    assert reader(run(seen)) > 0
    unseen = {"precond_rank": 256, "ops": ["fit", "mean_std"]}
    assert work.products(run(unseen)) is None
    assert reader(run(unseen)) is None
    fit_only = {"precond_rank": 256, "ops": ["fit", "mean"]}
    assert work.products(run(fit_only)) == 2


def test_device_kernels_map_to_their_hand_kernel():
    """kernels/<hand kernel>.json names the device kernels that carry it;
    a device kernel's demangled name maps to its hand kernel by the whole
    identifier, and a library kernel maps to none."""
    from portbench import trace
    from portbench.plugins import Pieces

    stems = trace.kernel_stems(Pieces())
    assert set(stems.values()) >= {"gram", "gram_matvec", "gram_matmat",
                                   "qform_df", "gemv_df", "gram_df"}
    assert trace.hand_kernel(
        "void gram_matvec_kernel<4, 1>(float const*, int)", stems) \
        == "gram_matvec"
    assert trace.hand_kernel("pad_points_kernel(float*)", stems) \
        == "gram_matvec"
    assert trace.hand_kernel("void my_gram_kernel_2(float*)", stems) is None
    assert trace.hand_kernel("sm90_xmma_gemm_f32f32_tf32", stems) is None
