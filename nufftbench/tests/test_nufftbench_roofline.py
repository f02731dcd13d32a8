"""The roofline's bytes and operations for the four cells, pinned by sums
worked out by hand from the shapes alone."""

import pytest

from nufftbench import roofline
from nufftbench.shapes import oversampled_grid, shapes_of

C128 = {"shape": [256] * 3, "dtype": "complex128", "m": 4, "sigma": 1.5,
        "kernel": "BackwardsKaiserBesselKernel", "kernel_evalmode": "FastApproximation"}
F64 = dict(C128, dtype="float64")
RHO1 = {"density": 1.0, "ntransforms": 1}
RHO0P1 = {"density": 0.1, "ntransforms": 1}
GRID = 384**3  # 56,623,104 nodes

# Operations a point: taps 3 axes x 8 taps x 14 (Horner, degree 7);
# 512 tap products; 512 multiply-adds of each scalar (2 operations).
OPS_C128 = 3 * 8 * 14 + 512 + 512 * 2 * 2  # 2,896
OPS_F64 = 3 * 8 * 14 + 512 + 512 * 2  # 1,872


@pytest.mark.parametrize("config,mix,npts,nbytes,flops,bound_ms,by", [
    # values 16 B + coordinates 24 B a point; the grid 16 B a node
    (C128, RHO1, 16_777_216, 16_777_216 * 40 + GRID * 16, 16_777_216 * OPS_C128,
     48.586_817_536, "operations"),
    (F64, RHO1, 16_777_216, 16_777_216 * 32 + GRID * 8, 16_777_216 * OPS_F64,
     31.406_948_352, "operations"),
    (C128, RHO0P1, 1_677_722, 1_677_722 * 40 + GRID * 16, 1_677_722 * OPS_C128,
     None, "bytes"),
    (F64, RHO0P1, 1_677_722, 1_677_722 * 32 + GRID * 8, 1_677_722 * OPS_F64,
     None, "bytes"),
])
def test_four_cells(config, mix, npts, nbytes, flops, bound_ms, by):
    s = shapes_of(config, mix)
    assert s.num_points == npts and s.grid_over == (384, 384, 384)
    for work in (roofline.spread_work(s), roofline.interp_work(s)):
        assert work == (nbytes, flops)
        t, which = roofline.bound_s(work)
        assert which == by
        want = flops / 67e12 if by == "operations" else nbytes / 3.35e12
        assert t == pytest.approx(want, rel=1e-12)
    if bound_ms is not None:
        assert flops / 1e9 == pytest.approx(bound_ms)  # GFLOP


def test_bounds_in_ms():
    """The bounds PERF.md prints."""
    got = {name: 1e3 * roofline.bound_s(roofline.spread_work(shapes_of(c, m)))[0]
           for name, c, m in (("c128.rho1", C128, RHO1), ("f64.rho1", F64, RHO1),
                              ("c128.rho0p1", C128, RHO0P1), ("f64.rho0p1", F64, RHO0P1))}
    assert got["c128.rho1"] == pytest.approx(0.72518, rel=1e-4)
    assert got["f64.rho1"] == pytest.approx(0.46876, rel=1e-4)
    assert got["c128.rho0p1"] == pytest.approx(0.29046, rel=1e-4)
    assert got["f64.rho0p1"] == pytest.approx(0.15124, rel=1e-4)


def test_oversampled_grid_rule():
    assert oversampled_grid((256, 256, 256), 1.5, False) == (384, 384, 384)
    assert oversampled_grid((256, 256, 256), 1.5, True) == (384, 384, 384)
    assert oversampled_grid((100,), 1.5, False) == (150,)
    assert oversampled_grid((4096, 4096), 1.25, False) == (5120, 5120)
    assert oversampled_grid((10, 14), 2.0, True) == (20, 30)  # 2 x 15, 14 = 2 x 7


@pytest.mark.parametrize("shape,sigma", [((256, 256, 256), 1.5), ((10, 14), 2.0),
                                         ((33, 7, 20), 1.25), ((4096,), 1.5)])
@pytest.mark.parametrize("dtype", ["complex128", "float64"])
def test_grid_rule_is_the_plans(shape, sigma, dtype):
    """The published rule, worked out here, gives the grid the program's
    plans choose (the program is consulted only by this test)."""
    import numpy as np

    import nonuniformffts_tpu_torch as nufft

    plan = nufft.PlanNUFFT(np.dtype(dtype), shape, m=2, sigma=sigma, device="cpu")
    assert oversampled_grid(shape, sigma, dtype == "float64") == plan.shape_over
