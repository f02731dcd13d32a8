"""Oversampled-grid FFTs through ``torch.fft`` (cuFFT on the card).

The reference's conventions (test/uniform_points.jl): type 1 uses the
unnormalised forward DFT, type 2 the unnormalised backward DFT, which is
``ifftn(..., norm="forward")`` (the JAX package's ``ifftn * ntot``).
Real-data plans use r2c / c2r over the LAST axis (``rfftn`` / ``irfftn``,
the JAX package's convention); ``irfftn`` is given the full oversampled
shape, since the halved axis alone does not say whether it was even.
"""

from __future__ import annotations

from typing import Sequence

import torch


def forward_fft(grid: torch.Tensor, *, real: bool = False) -> torch.Tensor:
    """Forward (type-1) FFT over all axes but the leading component axis."""
    dim = tuple(range(1, grid.ndim))
    if real:
        return torch.fft.rfftn(grid, dim=dim)
    return torch.fft.fftn(grid, dim=dim)


def backward_fft(uhat: torch.Tensor, shape_over: Sequence[int], *,
                 real: bool = False) -> torch.Tensor:
    """Backward (type-2) unnormalised FFT (bfft semantics); real plans get a
    real grid of ``shape_over``."""
    dim = tuple(range(1, uhat.ndim))
    if real:
        return torch.fft.irfftn(uhat, s=tuple(shape_over), dim=dim, norm="forward")
    return torch.fft.ifftn(uhat, dim=dim, norm="forward")
