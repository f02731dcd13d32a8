"""Type-1 spreading: scatter non-uniform values onto the oversampled grid.

The plain PyTorch implementation: one ``index_add_`` over the flattened grid
per chunk of points (``chunk_size`` bounds the memory of the materialised
``(chunk, (2M)^D)`` stencil tensors).  It runs on any device, is the
``spread_method='reference'`` path, and is the plain version the
hand-written spread kernel (``ops/kernels/blocked.py``) is held against.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .stencil import cells_and_fracs, linear_stencil_cells
from .windows import EvaluationMode, KernelData


def spread_cells(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    shape_over: tuple,
    cells: torch.Tensor,  # (D, Np) int32
    fracs: torch.Tensor,  # (D, Np)
    vp: torch.Tensor,  # (C, Np)
    *,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """Spread from precomputed cells and fractions; returns
    ``(C,) + shape_over`` with the dtype of ``vp``.  Each term is formed in
    the dtype of ``vp`` and summed in float64, as the spread kernels do
    (``csrc/spread_<D>d.cu``: float32 sums cost err1 more than the JAX
    package's float32 kernels, ROADMAP queue 3, P2)."""
    C, np_ = vp.shape
    ntot = 1
    for n in shape_over:
        ntot *= n
    acc_dtype = torch.complex128 if vp.is_complex() else torch.float64
    grid = torch.zeros((C, ntot), dtype=acc_dtype, device=vp.device)
    # index_add_ on the (re, im) view: real accumulation on every device.
    acc = torch.view_as_real(grid) if grid.is_complex() else grid
    step = max(np_, 1) if chunk_size is None else max(int(chunk_size), 1)
    for s in range(0, np_, step):
        lin, w = linear_stencil_cells(
            kernel_data, evalmode, cells[:, s : s + step], fracs[:, s : s + step]
        )
        vals = (w[None, :, :] * vp[:, s : s + step, None]).reshape(C, -1).to(acc_dtype)
        if vals.is_complex():
            vals = torch.view_as_real(vals)
        acc.index_add_(1, lin.reshape(-1), vals)
    return grid.to(vp.dtype).reshape((C,) + tuple(shape_over))


def spread_reference(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    shape_over: tuple,
    points: torch.Tensor,  # (D, Np), folded
    vp: torch.Tensor,  # (C, Np)
    *,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """Returns the oversampled grid ``(C,) + shape_over``."""
    cells, fracs = cells_and_fracs(kernel_data, points)
    return spread_cells(
        kernel_data, evalmode, shape_over, cells, fracs, vp, chunk_size=chunk_size
    )
