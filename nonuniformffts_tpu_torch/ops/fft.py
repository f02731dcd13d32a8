"""Oversampled-grid FFTs through ``torch.fft`` (cuFFT on the card).

The reference's conventions (test/uniform_points.jl): type 1 uses the
unnormalised forward DFT, type 2 the unnormalised backward DFT, which is
``ifftn(..., norm="forward")`` (the JAX package's ``ifftn * ntot``).
"""

from __future__ import annotations

import torch


def forward_fft(grid: torch.Tensor) -> torch.Tensor:
    """Forward (type-1) FFT over all axes but the leading component axis."""
    return torch.fft.fftn(grid, dim=tuple(range(1, grid.ndim)))


def backward_fft(uhat: torch.Tensor) -> torch.Tensor:
    """Backward (type-2) unnormalised FFT (bfft semantics)."""
    return torch.fft.ifftn(uhat, dim=tuple(range(1, uhat.ndim)), norm="forward")
