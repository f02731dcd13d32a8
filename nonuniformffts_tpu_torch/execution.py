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

User callbacks (``callbacks.py``): the nonuniform one on the type-1 values
before the spread and on the type-2 values after the interpolation, in
input order; the uniform one inside both deconvolution passes.  Direct
plans (``ops/direct.py``) run type 1 as nonuniform callback -> exact sums
-> uniform callback, and type 2 as uniform callback on the spectrum as
given -> exact sums -> nonuniform callback; no deconvolution scaling exists
there.  A plan's ``timer`` runs each stage in a section labelled as the JAX
package labels it (``exec_type1/(1) spreading`` ..), synchronised when the
timer is; the stages are the same functions in the same order either way.
A ``torch.profiler`` trace carries the same labels as spans
(``utils/timer.py``), with or without a timer.  The ``exec_type1`` and
``exec_type2`` sections cover the whole public call, the input checks and
conversion included.

A plan with ``transform_chunk`` set (``plan.py:choose_transform_chunk``,
the JAX package's ``cr_chunk``) runs its transforms in groups: type 1
spreads, transforms and truncates one group at a time into one output, each
group's grid freed before the next; type 2 scales every transform once and
pads, transforms and interpolates one group at a time.  The callbacks run
on every transform at once either way, so grouped results equal ungrouped
ones; each stage's timer section adds up over the groups, and a grouped
exec opens one ``(1) spreading`` or ``(3) interpolation`` section a group
and writes each group's result into the whole output in a ``(4) group
copy`` section, a sibling of the stages that an exec in one pass never
opens.
The other paths run their groups through the same loops
(:func:`type1_groups`, :func:`type2_groups`) with their own spread or
interpolation: the points-chunked plans (``chunked.py``) and the
point-sharded mode (``parallel/sharded.py``).

Real-data plans take real values in type 1 and return a complex spectrum of
``plan.spectral_shape`` (last axis halved); type 2 takes that spectrum and
returns real values.  64-bit plans run float64 in every stage: the JAX
package's double-single branches (``plan.ds``) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .callbacks import NUFFTCallbacks, apply_nonuniform_callback, apply_uniform_callback
from .ops import fft
from .ops.deconvolve import deconvolve_pad, deconvolve_scale, deconvolve_truncate, pad_modes
from .ops.direct import exec_type1_direct, exec_type2_direct
from .ops.interpolation import interpolate_reference
from .ops.kernels.blocked import interpolate_blocked, spread_blocked
from .ops.spreading import spread_reference
from .plan import Plan, transform_groups
from .utils.timer import section, traced

_NP_DTYPE = {
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
    torch.float32: np.float32,
    torch.float64: np.float64,
}
_NO_CALLBACKS = NUFFTCallbacks()


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


def t1_deconv_stage(plan: Plan, spec: torch.Tensor, callback=None) -> torch.Tensor:
    return deconvolve_truncate(
        spec, plan.index_ranges, plan.phihat_inv, plan.normfactor, callback
    )


def t2_pad_stage(plan: Plan, uhat: torch.Tensor, callback=None) -> torch.Tensor:
    return deconvolve_pad(
        uhat, plan.spectral_shape_over, plan.index_ranges, plan.phihat_inv, callback
    )


def t2_scale_stage(plan: Plan, uhat: torch.Tensor, callback=None) -> torch.Tensor:
    """The scaling and the uniform callback of ``t2_pad_stage``, without
    the padding: what a grouped type 2 runs once on all transforms."""
    return deconvolve_scale(uhat, plan.phihat_inv, callback)


def t2_pad_modes_stage(plan: Plan, w: torch.Tensor) -> torch.Tensor:
    """The padding of ``t2_pad_stage`` alone, on scaled modes."""
    return pad_modes(w, plan.spectral_shape_over, plan.index_ranges)


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


def t1_direct(plan: Plan, vp: torch.Tensor, callbacks: NUFFTCallbacks) -> torch.Tensor:
    """Direct type 1 with its callbacks: (C, Np) -> (C,) + spectral_shape."""
    vp = apply_nonuniform_callback(vp, callbacks.nonuniform)
    return apply_uniform_callback(exec_type1_direct(plan, vp), callbacks.uniform)


def t2_direct(plan: Plan, uhat: torch.Tensor, callbacks: NUFFTCallbacks) -> torch.Tensor:
    """Direct type 2 with its callbacks: (C,) + spectral_shape -> (C, Np)."""
    uhat = apply_uniform_callback(uhat, callbacks.uniform)
    return apply_nonuniform_callback(exec_type2_direct(plan, uhat), callbacks.nonuniform)


def _stage(plan: Plan, label: str, fn, *args):
    """``fn(*args)`` in the section ``label`` (``utils/timer.py:traced``):
    the plan's timer's, synchronised on the result when the timer is, and a
    profiler span while a profiler records."""
    return traced(plan.timer, label, fn, *args)


def _t1_pass(plan: Plan, vp: torch.Tensor, uniform, spread) -> torch.Tensor:
    """Spread, FFT, deconvolve and truncate ``vp`` (C', Np); the grid goes
    before the deconvolution."""
    grid = _stage(plan, "(1) spreading", spread, plan, vp)
    spec = _stage(plan, "(2) forward FFT", t1_fft_stage, plan, grid)
    del grid
    return _stage(plan, "(3) deconvolve + truncate", t1_deconv_stage, plan, spec, uniform)


def _t2_pass(plan: Plan, interp, spec_fn, uhat: torch.Tensor, *args) -> torch.Tensor:
    """``spec_fn(plan, uhat, *args)`` (pad, or scale and pad), backward FFT
    and interpolation: (C',) + spectral_shape -> (C', Np)."""
    spec = _stage(plan, "(1) deconvolve + pad", spec_fn, plan, uhat, *args)
    grid = _stage(plan, "(2) backward FFT", t2_fft_stage, plan, spec)
    del spec
    return _stage(plan, "(3) interpolation", interp, plan, grid)


def _put(out: torch.Tensor, sl: slice, part: torch.Tensor) -> torch.Tensor:
    """``out[sl] = part``, one group's result written into the whole output;
    returns ``out``."""
    out[sl] = part
    return out


def type1_groups(plan: Plan, vp: torch.Tensor, uniform=None,
                 spread=t1_spread_stage) -> torch.Tensor:
    """(C, Np) values (after the nonuniform callback) -> (C,) +
    spectral_shape in the plan's groups of transforms (``transform_chunk``):
    each group's ``spread(plan, values)`` -> FFT -> deconvolution, the
    group's grid freed before the next.  The uniform callback sees every
    transform at once: grouped, it runs on the whole output after the last
    group.  ``spread`` is the plan's own spread stage, or a path's (the
    chunks' sum of a points-chunked plan, a point-sharded rank's spread and
    all-reduce)."""
    groups = transform_groups(vp.shape[0], plan.transform_chunk)
    if len(groups) == 1:
        return _t1_pass(plan, vp, uniform, spread)
    out = torch.empty((vp.shape[0],) + plan.spectral_shape, dtype=plan.complex_dtype,
                      device=vp.device)
    for sl in groups:
        part = _t1_pass(plan, vp[sl], None, spread)
        _stage(plan, "(4) group copy", _put, out, sl, part)
    if uniform is not None:
        out = _stage(plan, "(3) deconvolve + truncate", apply_uniform_callback, out, uniform)
    return out


def type2_groups(plan: Plan, uhat: torch.Tensor, uniform=None,
                 interp=t2_interp_stage) -> torch.Tensor:
    """(C,) + spectral_shape -> (C, Np) values (before the nonuniform
    callback) in the plan's groups of transforms: grouped, the scaling and
    the uniform callback run once on all transforms, then each group is
    padded, transformed and interpolated by ``interp(plan, grid)`` (the
    plan's own stage, or a path's: the chunks' interpolations of a
    points-chunked plan)."""
    groups = transform_groups(uhat.shape[0], plan.transform_chunk)
    if len(groups) == 1:
        return _t2_pass(plan, interp, t2_pad_stage, uhat, uniform)
    w = _stage(plan, "(1) deconvolve + pad", t2_scale_stage, plan, uhat, uniform)
    vp = torch.empty((uhat.shape[0], plan.num_points), dtype=plan.dtype, device=uhat.device)
    for sl in groups:
        part = _t2_pass(plan, interp, t2_pad_modes_stage, w[sl])
        _stage(plan, "(4) group copy", _put, vp, sl, part)
    return vp


def _type1(plan: Plan, vp: torch.Tensor, callbacks: NUFFTCallbacks) -> torch.Tensor:
    """(C, Np) values -> (C,) + spectral_shape, stage by stage, in the
    plan's groups of transforms (:func:`type1_groups`)."""
    if plan.spread_method == "direct":
        return _stage(plan, "(1) direct NUDFT", t1_direct, plan, vp, callbacks)
    if callbacks.nonuniform is not None:
        vp = _stage(plan, "(0) nonuniform callback", apply_nonuniform_callback, vp,
                    callbacks.nonuniform)
    return type1_groups(plan, vp, callbacks.uniform)


def _type2(plan: Plan, uhat: torch.Tensor, callbacks: NUFFTCallbacks) -> torch.Tensor:
    """(C,) + spectral_shape -> (C, Np) values, stage by stage, in the
    plan's groups of transforms (:func:`type2_groups`)."""
    if plan.spread_method == "direct":
        return _stage(plan, "(1) direct NUDFT", t2_direct, plan, uhat, callbacks)
    vp = type2_groups(plan, uhat, callbacks.uniform)
    if callbacks.nonuniform is not None:
        vp = _stage(plan, "(4) nonuniform callback", apply_nonuniform_callback, vp,
                    callbacks.nonuniform)
    return vp


def prepare_type1(plan: Plan, vp) -> tuple:
    """``vp`` as a (C, Np) tensor on the plan's device, and whether the
    caller gave the component axis."""
    vp = _as_plan_tensor(vp, plan, plan.dtype, "non-uniform data")
    vp, had_axis = _as_components(vp, plan, expected_tail_ndim=1)
    if vp.shape[1] != plan.num_points:
        raise ValueError(
            f"number of values {vp.shape[1]} != number of points {plan.num_points}"
        )
    return vp, had_axis


def prepare_type2(plan: Plan, uhat) -> tuple:
    """``uhat`` as a (C,) + spectral_shape tensor on the plan's device, and
    whether the caller gave the component axis."""
    uhat = _as_plan_tensor(uhat, plan, plan.complex_dtype, "uniform data")
    uhat, had_axis = _as_components(uhat, plan, expected_tail_ndim=plan.ndim)
    if tuple(uhat.shape[1:]) != plan.spectral_shape:
        raise ValueError(
            f"uniform data shape {tuple(uhat.shape[1:])} != expected "
            f"{plan.spectral_shape}"
        )
    return uhat, had_axis


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def exec_type1(plan: Plan, vp, callbacks: NUFFTCallbacks = None) -> torch.Tensor:
    """Type-1 NUFFT: values at non-uniform points -> Fourier modes.

    ``vp`` (numpy array or tensor of the plan's dtype, real on real-data
    plans) has shape ``(Np,)`` or ``(ntransforms, Np)``; the output is a
    tensor of ``plan.complex_dtype`` on the plan's device of shape
    ``plan.spectral_shape`` (plus the leading component axis if present), in
    FFTW frequency order unless ``fftshift``.  ``callbacks``: see
    ``callbacks.py``.
    """
    with section(plan.timer, "exec_type1"):
        _check_points(plan)
        vp, had_axis = prepare_type1(plan, vp)
        uhat = _type1(plan, vp, callbacks or _NO_CALLBACKS)
        return uhat if had_axis else uhat[0]


def exec_type2(plan: Plan, uhat, callbacks: NUFFTCallbacks = None) -> torch.Tensor:
    """Type-2 NUFFT: Fourier modes -> values at non-uniform points.

    ``uhat`` has shape ``plan.spectral_shape`` (optionally with a leading
    component axis) and dtype ``plan.complex_dtype``; the output is ``(Np,)``
    / ``(ntransforms, Np)`` of the plan's dtype (real on real-data plans) on
    the plan's device.  ``callbacks``: see ``callbacks.py``.
    """
    with section(plan.timer, "exec_type2"):
        _check_points(plan)
        uhat, had_axis = prepare_type2(plan, uhat)
        vp = _type2(plan, uhat, callbacks or _NO_CALLBACKS)
        return vp if had_axis else vp[0]


# ---------------------------------------------------------------------------
# Public API: the channel form (JAX package's execution.py:703-738)
# ---------------------------------------------------------------------------


def to_channels(x: torch.Tensor, axis: int) -> torch.Tensor:
    """A complex tensor as real channels: a (re, im) axis of size 2 inserted
    at ``axis`` (a copy; ``view_as_real`` puts it last)."""
    return torch.movedim(torch.view_as_real(x), -1, axis).contiguous()


def from_channels(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of :func:`to_channels`: the (re, im) axis at ``axis`` folded
    into a complex tensor."""
    if x.shape[axis] != 2:
        raise ValueError(f"channel axis {axis} has size {x.shape[axis]}, not 2")
    return torch.view_as_complex(torch.movedim(x, axis, -1).contiguous())


def exec_type1_channels(plan: Plan, vp_ch, callbacks: NUFFTCallbacks = None) -> torch.Tensor:
    """Channel-form type 1.  ``vp_ch`` (of the plan's real dtype): real plans
    ``(Np,)`` / ``(C, Np)``; complex plans ``(2, Np)`` / ``(C, 2, Np)`` with
    channel 0 the real part and 1 the imaginary part.  Returns the real
    spectrum ``(2,) + spectral_shape`` / ``(C, 2) + spectral_shape``."""
    _check_points(plan)
    vp_ch = _as_plan_tensor(vp_ch, plan, plan.real_dtype, "channel values")
    vp = vp_ch if plan.is_real else from_channels(vp_ch, vp_ch.ndim - 2)
    uhat = exec_type1(plan, vp, callbacks)
    return to_channels(uhat, uhat.ndim - plan.ndim)


def exec_type2_channels(plan: Plan, uhat_ch, callbacks: NUFFTCallbacks = None) -> torch.Tensor:
    """Channel-form type 2.  ``uhat_ch``: ``(2,) + spectral_shape`` /
    ``(C, 2) + spectral_shape`` of the plan's real dtype.  Returns real plans'
    ``(Np,)`` / ``(C, Np)``, complex plans' ``(2, Np)`` / ``(C, 2, Np)``."""
    _check_points(plan)
    uhat_ch = _as_plan_tensor(uhat_ch, plan, plan.real_dtype, "channel spectrum")
    vp = exec_type2(plan, from_channels(uhat_ch, uhat_ch.ndim - plan.ndim - 1), callbacks)
    return vp if plan.is_real else to_channels(vp, vp.ndim - 1)
