"""Every window in both evaluation modes through the port's blocked plans in
2D and 3D against the JAX package, and through every dimension, dtype and
half-support against the exact sums.

The blocked wrappers run the plain versions of the CUDA kernels on CPU
tensors.  A JAX blocked plan in interpret mode takes 3-40 s here (pytest
--durations), so JAX sees a set of (window, dtype, shape) cases that covers
each window evaluator in 2D and 3D at m = 4 and m = 10; the exact sums see
the whole cross product.
"""

import numpy as np
import pytest
import torch

import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch.ops.deconvolve import output_wavenumbers
from nufft_test_utils import direct_type1, direct_type2
from test_torch_window_modes import WINDOWS, check_against_jax
from torch_port_utils import random_complex, real_dtype, rel_err

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype,shape,window,m,sigma", [
    (np.complex64, (16, 12), ("KaiserBesselKernel", "Direct"), 4, 1.5),
    (np.float64, (16, 12), ("GaussianKernel", "Direct"), 4, 1.5),
    (np.complex128, (16, 12), ("BSplineKernel", "FastApproximation"), 4, 1.5),
    (np.complex128, (8, 8, 8), ("BackwardsKaiserBesselKernel", "Direct"), 4, 1.5),
    (np.complex64, (8, 8, 8), ("GaussianKernel", "FastApproximation"), 4, 1.5),
    (np.float64, (8, 8, 8), ("BSplineKernel", "Direct"), 4, 1.5),
    (np.complex64, (16, 12), ("GaussianKernel", "FastApproximation"), 10, 2.0),
    (np.complex128, (16, 12), ("BackwardsKaiserBesselKernel", "Direct"), 10, 2.0),
    (np.float64, (12, 12, 12), ("KaiserBesselKernel", "Direct"), 10, 2.0),
], ids=str)
def test_blocked_nd_matches_jax(dtype, shape, window, m, sigma):
    """2D and 3D blocked plans against the JAX blocked plan (yz-form
    kernels, interpret mode): 1e-5 in float32, 1e-12 in float64."""
    check_against_jax(dtype, shape, window, m, sigma, seed=60 + m)


def error_budget(kind: str, m: int) -> float:
    """Relative L2 budget of one dimension at sigma = 2, copied from
    ``tests/test_accuracy.py:error_budget`` (float64 floor included)."""
    if kind in ("KaiserBesselKernel", "BackwardsKaiserBesselKernel"):
        return max(6 * 10.0 ** (-1.9 * m), 4e-14)
    if kind == "GaussianKernel":
        return 10.0 ** (-0.95 * m) * 0.8
    return 10.0 ** (-0.98 * m) * 0.4


def _budget(kind, m, D, dtype):
    """D times the 1D budget (the dimensions' errors add); float32 plans
    floor at 1e-5 at m = 4 and at 5e-5, the float32 high-m bound of
    ``tests/test_accuracy.py:109-124``, at m = 10."""
    b = D * error_budget(kind, m)
    if real_dtype(dtype) == np.float32:
        b = max(b, 1e-5 if m == 4 else 5e-5)
    return b


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("m,shape", [(4, (64,)), (4, (16, 12)), (4, (8, 8, 8)),
                                     (10, (64,)), (10, (16, 12)), (10, (12, 12, 12))],
                         ids=str)
@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_blocked_window_matches_exact_sums(window, m, shape, dtype):
    """Type 1 (and type 2 of its output on complex plans) of a blocked plan
    at sigma = 2 against the exact sums, within D x the accuracy sweep's
    budget of the window (``_budget``)."""
    rng = np.random.default_rng(70 + m)
    D = len(shape)
    kernel, mode = (getattr(tnufft, n)() for n in window)
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=2.0, kernel=kernel, kernel_evalmode=mode,
                            spread_method="blocked", device="cpu")
    real = real_dtype(dtype)
    pts = rng.uniform(0, 2 * np.pi, (D, 1000))
    v = random_complex(rng, np.complex128, 1000)
    v = (v if np.dtype(dtype).kind == "c" else v.real).astype(dtype)
    plan = tnufft.set_points(plan, pts.astype(real))
    kv = [output_wavenumbers(n, r2c=plan.is_real and d == D - 1, fftshift=False)
          for d, n in enumerate(shape)]
    u = tnufft.exec_type1(plan, v).numpy()
    budget = _budget(window[0], m, D, dtype)
    assert rel_err(u, direct_type1(pts, v, kv)) <= budget
    if not plan.is_real:
        v2 = tnufft.exec_type2(plan, u).numpy()
        assert rel_err(v2, direct_type2(pts, u, kv)) <= budget
