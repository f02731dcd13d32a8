"""Shared window-stencil construction: per-point linear indices and
tensor-product weights over the ``(2M)^D`` spreading stencil.

Counterpart of ``nonuniformffts_tpu/ops/stencil.py``; used by the plain
spreading and interpolation paths, which are also the plain versions the
hand-written kernels are held against.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import windows
from .windows import EvaluationMode, KernelData


def wrap_indices(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Branchless periodic wrap for indices in ``[-n, 2n)`` (valid since the
    plan guarantees 2M <= N; src/Kernels/Kernels.jl:148-158)."""
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where(idx >= n, idx - n, idx)


def cells_and_fracs(kernel_data: Sequence[KernelData], points: torch.Tensor):
    """High-accuracy per-dim cells ``(D, Np)`` int32 and in-cell fractions
    ``(D, Np)`` for raw (possibly unfolded) points ``(D, Np)``."""
    cs, xs = [], []
    for d, kd in enumerate(kernel_data):
        c, X = windows.point_to_cell_split(points[d], kd.n)
        cs.append(c)
        xs.append(X)
    return torch.stack(cs), torch.stack(xs)


def linear_stencil_cells(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    cells: torch.Tensor,  # (D, P) int32
    fracs: torch.Tensor,  # (D, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened stencil ``(lin, w)``, both ``(P, S)`` with
    ``S = prod(2M_d)``: int64 linear indices into the row-major oversampled
    grid and the tensor-product window weights."""
    lin = None
    w = None
    for d, kd in enumerate(kernel_data):
        vals = windows.eval_window_frac(kd, evalmode, fracs[d])  # (P, 2M)
        t = torch.arange(2 * kd.m, dtype=torch.int64, device=cells.device)
        start = cells[d].to(torch.int64) - (kd.m - 1)
        idx = wrap_indices(start[:, None] + t[None, :], kd.n)  # (P, 2M)
        if lin is None:
            lin, w = idx, vals
        else:
            lin = (lin[:, :, None] * kd.n + idx[:, None, :]).reshape(lin.shape[0], -1)
            w = (w[:, :, None] * vals[:, None, :]).reshape(w.shape[0], -1)
    return lin, w

