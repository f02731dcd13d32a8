"""Type-2 interpolation: gather oversampled grid values at non-uniform points.

The plain PyTorch implementation (transpose of ``ops/spreading.py``), with
the cell-volume prefactor ``prod(2pi / N~)`` applied at the gather
(src/interpolation/cpu_nonblocked.jl:45-48).  It is the
``spread_method='reference'`` path and the plain version the hand-written
interpolation kernel (``ops/kernels/blocked.py``) is held against.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .stencil import cells_and_fracs, linear_stencil_cells
from .windows import EvaluationMode, KernelData


def interpolate_cells(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    grid: torch.Tensor,  # (C,) + shape_over
    cells: torch.Tensor,  # (D, Np) int32
    fracs: torch.Tensor,  # (D, Np)
    prefactor: float,
    *,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """Values at the points given by cells and fractions, shape (C, Np)."""
    C = grid.shape[0]
    np_ = cells.shape[1]
    gflat = grid.reshape(C, -1)
    out = torch.empty((C, np_), dtype=grid.dtype, device=grid.device)
    step = max(np_, 1) if chunk_size is None else max(int(chunk_size), 1)
    for s in range(0, np_, step):
        lin, w = linear_stencil_cells(
            kernel_data, evalmode, cells[:, s : s + step], fracs[:, s : s + step]
        )
        vals = gflat[:, lin]  # (C, P, S)
        out[:, s : s + step] = torch.sum(vals * w[None], dim=-1) * prefactor
    return out


def interpolate_reference(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    grid: torch.Tensor,
    points: torch.Tensor,  # (D, Np), folded
    prefactor: float,
    *,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """Returns values at points, shape (C, Np)."""
    cells, fracs = cells_and_fracs(kernel_data, points)
    return interpolate_cells(
        kernel_data, evalmode, grid, cells, fracs, prefactor, chunk_size=chunk_size
    )
