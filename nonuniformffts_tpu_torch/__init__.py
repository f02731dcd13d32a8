"""nonuniformffts_tpu_torch: the NUFFT library in PyTorch, with hand-written
CUDA kernels for the NVIDIA H100.

The port of ``nonuniformffts_tpu`` (JAX/Pallas on TPU), which stays in the
repository as its reference.  This slice covers 3D-capable complex plans:
``PlanNUFFT`` -> ``set_points`` -> ``exec_type1`` / ``exec_type2``, with the
blocked method running the CUDA kernels ``nufft_spread_3d_f32`` and
``nufft_interp_3d_f32`` (``csrc/``, built with nvcc at first use) on
complex64 plans.

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
]
