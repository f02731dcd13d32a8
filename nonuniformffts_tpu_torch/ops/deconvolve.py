"""Deconvolution passes fused with truncation / zero-padding between the
oversampled and non-oversampled Fourier grids.

Counterpart of ``nonuniformffts_tpu/ops/deconvolve.py`` and of the
reference's copy_deconvolve_to_(non_)oversampled! (src/NonuniformFFTs.jl:
318-480).  The output modes occupy at most two contiguous runs of each
oversampled FFT axis (k >= 0 at the front, k < 0 at the back), so truncation
and padding are slices; ``1/phi_hat`` is applied as D broadcast multiplies.

Wavenumber order is FFTW's (``0 .. N/2-1, -N/2 .. -1``) unless
``fftshift=True`` (increasing order).  On real-data (r2c/c2r) plans the
halved LAST axis holds ``k = 0 .. N/2`` in order (positive Nyquist, never
shifted) at the front of an ``n_over // 2 + 1`` oversampled axis, so its
range is one slice; callers pass the plan's ``spectral_shape_over``.  The
optional user callback on uniform data runs in both passes, after the
``1/phi_hat`` scaling (``callbacks.py:apply_uniform_callback``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..callbacks import apply_uniform_callback


def output_wavenumbers(n: int, *, r2c: bool, fftshift: bool) -> np.ndarray:
    """Integer wavenumbers of the output grid along one dim
    (src/plan.jl:558-566)."""
    if r2c:
        return np.arange(n // 2 + 1, dtype=np.float64)
    k = np.fft.fftfreq(n, d=1.0 / n).astype(np.float64)
    if fftshift:
        k = np.fft.fftshift(k)
    return k


def truncate_ranges(
    n_out: int, n_over: int, *, r2c: bool, fftshift: bool
) -> Tuple[Tuple[int, int], ...]:
    """``(src_start, length)`` ranges into the oversampled axis, in output
    order (FFTW-order index ranges of the output modes)."""
    if r2c:
        return ((0, n_out),)
    h_neg = n_out // 2
    h_pos = n_out - h_neg
    if fftshift:
        return ((n_over - h_neg, h_neg), (0, h_pos))
    return ((0, h_pos), (n_over - h_neg, h_neg))


def truncate_axis(x: torch.Tensor, axis: int, ranges) -> torch.Tensor:
    parts = [x.narrow(axis, s, l) for s, l in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def pad_axis(x: torch.Tensor, axis: int, ranges, n_over: int) -> torch.Tensor:
    """Inverse of :func:`truncate_axis`: the output-ordered segments at their
    oversampled positions, zeros elsewhere."""
    shape = list(x.shape)
    shape[axis] = n_over
    out = x.new_zeros(shape)
    off = 0
    for s, l in ranges:
        out.narrow(axis, s, l).copy_(x.narrow(axis, off, l))
        off += l
    return out


def _scale(u: torch.Tensor, phihat_inv: Sequence[torch.Tensor]) -> torch.Tensor:
    D = len(phihat_inv)
    for d, ph_inv in enumerate(phihat_inv):
        shape = [1] * (D + 1)
        shape[1 + d] = ph_inv.shape[0]
        u = u * ph_inv.reshape(shape)
    return u


def deconvolve_truncate(
    uhat_over: torch.Tensor,  # (C,) + oversampled spectral shape
    index_ranges,
    phihat_inv: Sequence[torch.Tensor],
    normfactor: float,
    callback=None,
) -> torch.Tensor:
    """Type-1 step (3): truncate to the output modes, multiply by
    ``normfactor / prod_d phi_hat_d`` (src/NonuniformFFTs.jl:179-185), then
    apply the uniform ``callback``."""
    out = uhat_over
    for d, ranges in enumerate(index_ranges):
        out = truncate_axis(out, 1 + d, ranges)
    return apply_uniform_callback(_scale(out * normfactor, phihat_inv), callback)


def deconvolve_scale(
    uhat_k: torch.Tensor,  # (C,) + output spectral shape
    phihat_inv: Sequence[torch.Tensor],
    callback=None,
) -> torch.Tensor:
    """The first half of type-2 step (1): scale by ``1 / prod_d phi_hat_d``,
    then apply the uniform ``callback``."""
    return apply_uniform_callback(_scale(uhat_k, phihat_inv), callback)


def pad_modes(
    w: torch.Tensor,  # (C,) + output spectral shape
    shape_over_spec: Tuple[int, ...],
    index_ranges,
) -> torch.Tensor:
    """The second half of type-2 step (1): the modes placed into the
    zero-padded oversampled spectrum."""
    for d, ranges in enumerate(index_ranges):
        w = pad_axis(w, 1 + d, ranges, shape_over_spec[d])
    return w


def deconvolve_pad(
    uhat_k: torch.Tensor,  # (C,) + output spectral shape
    shape_over_spec: Tuple[int, ...],
    index_ranges,
    phihat_inv: Sequence[torch.Tensor],
    callback=None,
) -> torch.Tensor:
    """Type-2 step (1): scale by ``1 / prod_d phi_hat_d``, apply the uniform
    ``callback``, and place the modes into the zero-padded oversampled
    spectrum (src/NonuniformFFTs.jl:268-272, 453-480)."""
    return pad_modes(deconvolve_scale(uhat_k, phihat_inv, callback), shape_over_spec,
                     index_ranges)
