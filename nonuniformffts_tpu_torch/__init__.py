"""nonuniformffts_tpu_torch: the NUFFT library in PyTorch, with hand-written
CUDA kernels for the NVIDIA H100.

The port of ``nonuniformffts_tpu`` (JAX/Pallas on TPU), which stays in the
repository as its reference.  ``PlanNUFFT`` -> ``set_points`` ->
``exec_type1`` / ``exec_type2`` on complex64, complex128, float32 and
float64 (real-data r2c/c2r) values; on the card the blocked method runs the
CUDA kernels ``nufft_spread_<D>d_<type>`` and ``nufft_interp_<D>d_<type>``
(``csrc/``, built with nvcc at first use) for 1D, 2D and 3D plans, in
native float64 for 64-bit plans, for all four windows in both evaluation
modes and m = 2..10.  ``NFFTPlan`` / ``plan_nfft`` / ``nfft`` /
``nfft_adjoint`` speak the NFFT convention.  Plans run on the card unless
``device='cpu'``.

Quick start::

    import numpy as np
    import nonuniformffts_tpu_torch as nufft

    plan = nufft.PlanNUFFT(np.complex64, (64, 64, 64), m=4, sigma=1.5)
    plan = nufft.set_points(plan, (xs, ys, zs))    # points in [0, 2pi)
    uhat = nufft.exec_type1(plan, vp)              # sum_j v_j e^{-i k x_j}
    vp2 = nufft.exec_type2(plan, uhat)             # sum_k u_k e^{+i k x_j}
"""

from .callbacks import NUFFTCallbacks
from .execution import exec_type1, exec_type2
from .ops.windows import (
    BackwardsKaiserBesselKernel,
    BSplineKernel,
    Direct,
    FastApproximation,
    GaussianKernel,
    KaiserBesselKernel,
)
from .nfft_compat import WINDOWS, NFFTPlan, accuracy_params, nfft, nfft_adjoint, plan_nfft
from .plan import Plan, PlanNUFFT, set_points

__version__ = "0.1.0"

__all__ = [
    "Plan",
    "PlanNUFFT",
    "set_points",
    "exec_type1",
    "exec_type2",
    "NUFFTCallbacks",
    "KaiserBesselKernel",
    "BackwardsKaiserBesselKernel",
    "GaussianKernel",
    "BSplineKernel",
    "Direct",
    "FastApproximation",
    "NFFTPlan",
    "plan_nfft",
    "nfft",
    "nfft_adjoint",
    "accuracy_params",
    "WINDOWS",
]
