"""Transform execution: type-1 (non-uniform -> uniform) and type-2
(uniform -> non-uniform) pipelines on native complex and real tensors.

Counterpart of ``nonuniformffts_tpu/execution.py`` (reference:
src/NonuniformFFTs.jl:148-189, 237-286), with identical conventions:

- type 1: ``uhat(k) = sum_j v_j exp(-i k . x_j)``;
- type 2: ``v_j = sum_k uhat(k) exp(+i k . x_j)``.

Stages, each a function so that a caller can time them one by one:

- type 1: spread (the spread kernel on the blocked CUDA path) ->
  ``torch.fft.fftn`` (``rfftn`` on real-data plans) -> ``deconvolve_truncate``
  with ``normfactor``.  The kernel adds each block's halo into the grid with
  periodic wrap, so there is no fold pass.
- type 2: ``deconvolve_pad`` -> unnormalised inverse FFT (``irfftn`` on
  real-data plans) -> interpolate (the interpolation kernel on the blocked
  CUDA path, writing each result to its original index).

Real-data plans take real values in type 1 and return a complex spectrum of
``plan.spectral_shape`` (last axis halved); type 2 takes that spectrum and
returns real values.  64-bit plans run float64 in every stage: the JAX
package's double-single branches (``plan.ds``) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .callbacks import NUFFTCallbacks, check_no_callbacks
from .ops import fft
from .ops.deconvolve import deconvolve_pad, deconvolve_truncate
from .ops.interpolation import interpolate_reference
from .ops.kernels.blocked import interpolate_blocked, spread_blocked
from .ops.spreading import spread_reference
from .plan import Plan

_NP_DTYPE = {
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
    torch.float32: np.float32,
    torch.float64: np.float64,
}


def _check_points(plan: Plan):
    if plan.num_points is None:
        raise ValueError("points not set; call set_points first")


def _as_plan_tensor(x, plan: Plan, dtype: torch.dtype, what: str) -> torch.Tensor:
    """Host arrays and tensors of ``dtype``, moved to the plan's device."""
    if isinstance(x, torch.Tensor):
        if x.dtype != dtype:
            raise TypeError(f"{what} must have dtype {dtype}, got {x.dtype}")
        return x.to(plan.device)
    x = np.asarray(x)
    if x.dtype != np.dtype(_NP_DTYPE[dtype]):
        raise TypeError(f"{what} must have dtype {dtype}, got {x.dtype}")
    return torch.as_tensor(x, device=plan.device)


def _as_components(x: torch.Tensor, plan: Plan, expected_tail_ndim: int):
    if x.ndim == expected_tail_ndim:
        if plan.ntransforms != 1:
            raise ValueError(
                f"plan has ntransforms={plan.ntransforms}; pass data with a "
                "leading component axis"
            )
        return x[None], False
    if x.ndim == expected_tail_ndim + 1:
        if x.shape[0] != plan.ntransforms:
            raise ValueError(
                f"leading axis {x.shape[0]} != ntransforms {plan.ntransforms}"
            )
        return x, True
    raise ValueError(f"unexpected input rank {x.ndim}")


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def t1_spread_stage(plan: Plan, vp: torch.Tensor) -> torch.Tensor:
    """(C, Np) values in input order -> (C,) + shape_over grid."""
    if plan.spread_method == "blocked":
        return spread_blocked(plan, vp)
    if plan.point_perm is not None:
        vp = vp[:, plan.point_perm]
    return spread_reference(
        plan.kernel_data, plan.evalmode, plan.shape_over, plan.points, vp,
        chunk_size=plan.chunk_size,
    )


def t1_fft_stage(plan: Plan, grid: torch.Tensor) -> torch.Tensor:
    return fft.forward_fft(grid, real=plan.is_real)


def t1_deconv_stage(plan: Plan, spec: torch.Tensor) -> torch.Tensor:
    return deconvolve_truncate(
        spec, plan.index_ranges, plan.phihat_inv, plan.normfactor
    )


def t2_pad_stage(plan: Plan, uhat: torch.Tensor) -> torch.Tensor:
    return deconvolve_pad(
        uhat, plan.spectral_shape_over, plan.index_ranges, plan.phihat_inv
    )


def t2_fft_stage(plan: Plan, spec: torch.Tensor) -> torch.Tensor:
    return fft.backward_fft(spec, plan.shape_over, real=plan.is_real)


def t2_interp_stage(plan: Plan, grid: torch.Tensor) -> torch.Tensor:
    """(C,) + shape_over grid -> (C, Np) values in input order."""
    if plan.spread_method == "blocked":
        return interpolate_blocked(plan, grid)
    out = interpolate_reference(
        plan.kernel_data, plan.evalmode, grid, plan.points, plan.normfactor,
        chunk_size=plan.chunk_size,
    )
    if plan.point_perm is not None:
        out = out[:, plan.point_perm_inv]
    return out


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def exec_type1(plan: Plan, vp, callbacks: NUFFTCallbacks = None) -> torch.Tensor:
    """Type-1 NUFFT: values at non-uniform points -> Fourier modes.

    ``vp`` (numpy array or tensor of the plan's dtype, real on real-data
    plans) has shape ``(Np,)`` or ``(ntransforms, Np)``; the output is a
    tensor of ``plan.complex_dtype`` on the plan's device of shape
    ``plan.spectral_shape`` (plus the leading component axis if present), in
    FFTW frequency order unless ``fftshift``.
    """
    _check_points(plan)
    check_no_callbacks(callbacks)
    vp = _as_plan_tensor(vp, plan, plan.dtype, "non-uniform data")
    vp, had_axis = _as_components(vp, plan, expected_tail_ndim=1)
    if vp.shape[1] != plan.num_points:
        raise ValueError(
            f"number of values {vp.shape[1]} != number of points {plan.num_points}"
        )
    grid = t1_spread_stage(plan, vp)
    spec = t1_fft_stage(plan, grid)
    uhat = t1_deconv_stage(plan, spec)
    return uhat if had_axis else uhat[0]


def exec_type2(plan: Plan, uhat, callbacks: NUFFTCallbacks = None) -> torch.Tensor:
    """Type-2 NUFFT: Fourier modes -> values at non-uniform points.

    ``uhat`` has shape ``plan.spectral_shape`` (optionally with a leading
    component axis) and dtype ``plan.complex_dtype``; the output is ``(Np,)``
    / ``(ntransforms, Np)`` of the plan's dtype (real on real-data plans) on
    the plan's device.
    """
    _check_points(plan)
    check_no_callbacks(callbacks)
    uhat = _as_plan_tensor(uhat, plan, plan.complex_dtype, "uniform data")
    uhat, had_axis = _as_components(uhat, plan, expected_tail_ndim=plan.ndim)
    if tuple(uhat.shape[1:]) != plan.spectral_shape:
        raise ValueError(
            f"uniform data shape {tuple(uhat.shape[1:])} != expected "
            f"{plan.spectral_shape}"
        )
    spec = t2_pad_stage(plan, uhat)
    grid = t2_fft_stage(plan, spec)
    vp = t2_interp_stage(plan, grid)
    return vp if had_axis else vp[0]
