"""Blocked fast path: wrappers around the hand-written CUDA kernels K1
(spread) and K2 (interpolate), each with its plain PyTorch version.

Counterpart of ``nonuniformffts_tpu/ops/pallas/blocked.py``.  Both wrappers
read the plan's bin-sorted point state (``set_points`` with
``spread_method='blocked'``): cells and fractions in sorted order, the
sort permutation and the per-block point ranges.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches its kernel or raises.  Each launch adds one to
``LAUNCHES[kernel name]``.
"""

from __future__ import annotations

import torch

from ..interpolation import interpolate_cells
from ..spreading import spread_cells
from ..windows import FastApproximation
from . import build
from .common import KERNEL_M_RANGE, MAX_SMEM_BYTES, spread_smem_bytes

#: Launches of each kernel by its wrapper in this process.
LAUNCHES = {"nufft_spread_3d_f32": 0, "nufft_interp_3d_f32": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_kernel_support(plan) -> None:
    """Raise unless the CUDA kernels take this plan (3D, complex64,
    (B)KB FastApproximation, M in 2..8, padded block within shared memory)."""
    if plan.ndim != 3:
        raise NotImplementedError(
            "the CUDA kernels are 3D only; 1D/2D plans arrive with ROADMAP "
            "queue 1, item 6 (use spread_method='reference')"
        )
    if plan.dtype != torch.complex64:
        raise NotImplementedError(
            f"the CUDA kernels take complex64 plans, not {plan.dtype}; "
            "native FP64 arrives with ROADMAP queue 1, item 7"
        )
    if plan.coefs is None or not isinstance(plan.evalmode, FastApproximation):
        raise NotImplementedError(
            "the CUDA kernels evaluate (B)KB windows in FastApproximation "
            "mode only; the other windows are ROADMAP queue 2, item K3"
        )
    if plan.m not in KERNEL_M_RANGE:
        raise NotImplementedError(
            f"the CUDA kernels are instantiated for m in 2..8, got m={plan.m}"
        )
    smem = spread_smem_bytes(plan.block_dims, plan.m, plan.coefs.shape[-1])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"block_dims {plan.block_dims} need {smem} B of shared memory "
            f"per CTA, above the {MAX_SMEM_BYTES} B a Hopper CTA can use"
        )


def _check_cuda_inputs(x: torch.Tensor, plan, what: str) -> None:
    if x.dtype != torch.complex64:
        raise TypeError(f"{what} must be complex64, got {x.dtype}")
    for t in (plan.cells_sorted, plan.fracs_sorted, plan.sort_perm,
              plan.pstarts, plan.coefs):
        if t.device != x.device:
            raise ValueError(
                f"{what} lies on {x.device} but the plan's point state on "
                f"{t.device}"
            )
    for t, dt in ((plan.cells_sorted, torch.int32),
                  (plan.fracs_sorted, torch.float32),
                  (plan.sort_perm, torch.int64), (plan.pstarts, torch.int32),
                  (plan.coefs, torch.float32)):
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"plan point state must be contiguous {dt}")


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# K1: spread
# ---------------------------------------------------------------------------


def spread_blocked_plain(plan, vp: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: chunked ``index_add_`` from the sorted cells and
    fractions.  ``vp``: (C, Np) in original point order."""
    return spread_cells(
        plan.kernel_data, plan.evalmode, plan.shape_over, plan.cells_sorted,
        plan.fracs_sorted, vp[:, plan.sort_perm], chunk_size=plan.chunk_size,
    )


def spread_blocked(plan, vp: torch.Tensor) -> torch.Tensor:
    """Blocked type-1 spreading.  ``vp``: (C, Np) in original point order.
    Returns the oversampled grid ``(C,) + shape_over``."""
    if vp.device.type == "cpu":
        return spread_blocked_plain(plan, vp)
    if vp.device.type != "cuda":
        raise ValueError(f"no spread kernel for device {vp.device}")
    check_kernel_support(plan)
    _check_cuda_inputs(vp, plan, "values")
    C, np_ = vp.shape
    if np_ != plan.num_points:
        raise ValueError(f"{np_} values for {plan.num_points} points")
    vals = vp[:, plan.sort_perm].contiguous()
    grid = torch.zeros((C,) + tuple(plan.shape_over), dtype=vp.dtype,
                       device=vp.device)
    lib = build.load()
    n0, n1, n2 = plan.shape_over
    b0, b1, b2 = plan.block_dims
    with torch.cuda.device(vp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nufft_spread_3d_f32(
            vals.data_ptr(), plan.cells_sorted.data_ptr(),
            plan.fracs_sorted.data_ptr(), plan.pstarts.data_ptr(),
            plan.coefs.data_ptr(), grid.data_ptr(), np_, C, plan.m,
            plan.coefs.shape[-1], n0, n1, n2, b0, b1, b2, stream,
        )
    _raise_on_error("nufft_spread_3d_f32", err)
    LAUNCHES["nufft_spread_3d_f32"] += 1
    return grid


# ---------------------------------------------------------------------------
# K2: interpolate
# ---------------------------------------------------------------------------


def interpolate_blocked_plain(plan, grid: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: chunked gather at the sorted points, times
    ``normfactor``, scattered back to original point order."""
    vals = interpolate_cells(
        plan.kernel_data, plan.evalmode, grid, plan.cells_sorted,
        plan.fracs_sorted, plan.normfactor, chunk_size=plan.chunk_size,
    )
    out = torch.empty_like(vals)
    out[:, plan.sort_perm] = vals
    return out


def interpolate_blocked(plan, grid: torch.Tensor) -> torch.Tensor:
    """Blocked type-2 interpolation.  ``grid``: (C,) + shape_over.  Returns
    (C, Np) in original point order with the prefactor applied."""
    if grid.device.type == "cpu":
        return interpolate_blocked_plain(plan, grid)
    if grid.device.type != "cuda":
        raise ValueError(f"no interpolation kernel for device {grid.device}")
    check_kernel_support(plan)
    _check_cuda_inputs(grid, plan, "grid")
    if tuple(grid.shape[1:]) != tuple(plan.shape_over):
        raise ValueError(
            f"grid shape {tuple(grid.shape[1:])} != oversampled grid "
            f"{plan.shape_over}"
        )
    grid = grid.contiguous()
    C = grid.shape[0]
    np_ = plan.num_points
    out = torch.empty((C, np_), dtype=grid.dtype, device=grid.device)
    if np_ == 0:
        return out
    lib = build.load()
    n0, n1, n2 = plan.shape_over
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nufft_interp_3d_f32(
            grid.data_ptr(), plan.cells_sorted.data_ptr(),
            plan.fracs_sorted.data_ptr(), plan.sort_perm.data_ptr(),
            plan.coefs.data_ptr(), out.data_ptr(), np_, C, plan.m,
            plan.coefs.shape[-1], n0, n1, n2, float(plan.normfactor), stream,
        )
    _raise_on_error("nufft_interp_3d_f32", err)
    LAUNCHES["nufft_interp_3d_f32"] += 1
    return out
