"""Blocked fast path: wrappers around the hand-written CUDA kernels, each
with its plain PyTorch version: spread K4 (1D, 2D) and K1/K6a (3D),
interpolate K5 (1D, 2D) and K2/K6b (3D), and the window taps K3.

Counterpart of ``nonuniformffts_tpu/ops/pallas/blocked.py`` and
``blocked_ds.py``.  Both wrappers read the plan's bin-sorted point state
(``set_points`` with ``spread_method='blocked'``): cells and fractions in
sorted order, the sort permutation and the per-block point ranges.  The
plan's dimension and dtype pick the kernel's entry point
(``common.entry_point_name``): D = 1, 2 or 3; complex64, complex128, float32
or float64 values, with fractions and coefficients in the matching real
dtype; 64-bit plans run native FP64.  Every window runs, in both
evaluation modes, for M in 2..10.  The spread and interpolation kernels
evaluate the (B)KB FastApproximation taps themselves from the coefficient
stack; for every other window their wrapper first launches K3
(``nufft_window_weights_<f32|f64>``, ``csrc/window_weights.cu``), which
writes each sorted point's taps from the window's scalars
(``ops/windows.py:window_pack``), and passes those taps to the kernel.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches its kernel or raises.  Each launch adds one to
``LAUNCHES[entry point]``.
"""

from __future__ import annotations

import torch

from ..interpolation import interpolate_cells
from ..spreading import spread_cells
from ..windows import WINDOW_KINDS
from . import build
from .common import (
    KERNEL_DIMS,
    KERNEL_M_RANGE,
    MAX_SMEM_BYTES,
    VALUE_TYPES,
    entry_point_name,
    spread_smem_bytes,
    window_weights,
)

#: The window-weights entry point by the plan's real dtype.
WEIGHTS_ENTRY = {torch.float32: "nufft_window_weights_f32",
                 torch.float64: "nufft_window_weights_f64"}

#: Launches of each entry point by its wrapper in this process.
LAUNCHES = {
    **{entry_point_name(kind, ndim, dtype): 0
       for ndim in KERNEL_DIMS
       for kind in ("spread", "interp")
       for dtype in VALUE_TYPES},
    **dict.fromkeys(WEIGHTS_ENTRY.values(), 0),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def entry_point(kind: str, plan) -> str:
    """The kernel entry point (``kind`` 'spread' or 'interp') for the plan's
    dimension and dtype."""
    return entry_point_name(kind, plan.ndim, plan.dtype)


def kernel_coefs(plan):
    """The coefficient stack the kernels read and its ``ncoef``: the plan's
    for a Horner window ((B)KB FastApproximation), else ``(None, 0)``."""
    if plan.window.kind != WINDOW_KINDS["horner"]:
        return None, 0
    if plan.coefs is None:
        raise ValueError("a (B)KB FastApproximation plan needs its coefficient stack")
    return plan.coefs, plan.coefs.shape[-1]


def check_kernel_support(plan) -> None:
    """Raise unless the CUDA kernels take this plan (1-3D, complex or real
    of 32 or 64 bits, any window in either mode, M in 2..10, the spread
    CTA's shared memory within the card's)."""
    if plan.ndim not in KERNEL_DIMS:
        raise NotImplementedError(f"no CUDA kernel takes {plan.ndim}D plans")
    if plan.dtype not in VALUE_TYPES:
        raise NotImplementedError(f"no CUDA kernel takes {plan.dtype} values")
    if plan.m not in KERNEL_M_RANGE:
        raise NotImplementedError(
            f"the CUDA kernels are instantiated for m in "
            f"{KERNEL_M_RANGE.start}..{KERNEL_M_RANGE.stop - 1}, got m={plan.m} "
            "(10 is the JAX package's documented maximum; ROADMAP queue 2)"
        )
    _, ncoef = kernel_coefs(plan)
    _, scalar_bytes, ncomp = VALUE_TYPES[plan.dtype]
    smem = spread_smem_bytes(plan.block_dims, plan.m, ncoef, scalar_bytes, ncomp)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"block_dims {plan.block_dims} need {smem} B of shared memory "
            f"per CTA, above the {MAX_SMEM_BYTES} B a Hopper CTA can use"
        )


def _check_cuda_inputs(x: torch.Tensor, plan, what: str) -> None:
    if x.dtype != plan.dtype:
        raise TypeError(f"{what} must be {plan.dtype}, got {x.dtype}")
    coefs, _ = kernel_coefs(plan)
    state = [(plan.cells_sorted, torch.int32), (plan.fracs_sorted, plan.real_dtype),
             (plan.sort_perm, torch.int64), (plan.pstarts, torch.int32)]
    if coefs is not None:
        state.append((coefs, plan.real_dtype))
    for t, dt in state:
        if t.device != x.device:
            raise ValueError(
                f"{what} lies on {x.device} but the plan's point state on "
                f"{t.device}"
            )
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"plan point state must be contiguous {dt}")


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# K3: window taps of every sorted point (all windows but (B)KB Fast)
# ---------------------------------------------------------------------------


def window_weights_blocked_plain(plan) -> torch.Tensor:
    """Plain version of the window-weights kernel: ``(D, 2M, Np)`` taps of
    the sorted points in the plan's real dtype, row ``t`` of a dim the
    weight of node ``c - M + 1 + t`` (``common.window_weights``)."""
    coefs, _ = kernel_coefs(plan)
    per_dim = [
        window_weights(kd, plan.evalmode, plan.fracs_sorted[d][None, :],
                       None if coefs is None else coefs[d])
        for d, kd in enumerate(plan.kernel_data)
    ]
    return torch.stack(per_dim)


def window_weights_blocked(plan) -> torch.Tensor:
    """The sorted points' window taps ``(D, 2M, Np)`` for a plan whose
    window the spread and interpolation kernels do not evaluate themselves
    (any but (B)KB FastApproximation).  CPU point state runs the plain
    version; CUDA launches K3 or raises."""
    if plan.fracs_sorted.device.type == "cpu":
        return window_weights_blocked_plain(plan)
    if plan.window.kind == WINDOW_KINDS["horner"]:
        raise ValueError("(B)KB FastApproximation taps are evaluated inside the kernels")
    fracs = plan.fracs_sorted
    if fracs.dtype != plan.real_dtype or not fracs.is_contiguous():
        raise TypeError(f"plan fractions must be contiguous {plan.real_dtype}")
    np_ = plan.num_points
    out = torch.empty((plan.ndim, 2 * plan.m, np_), dtype=fracs.dtype, device=fracs.device)
    if np_ == 0:
        return out
    name = WEIGHTS_ENTRY[plan.real_dtype]
    fn = getattr(build.load(), name)
    with torch.cuda.device(fracs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(fracs.data_ptr(), build.WindowParams.from_pack(plan.window),
                 out.data_ptr(), np_, plan.ndim, plan.m, stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return out


def _launch_args(plan):
    """The coefficient pointer, the window-taps tensor (K3's output, for
    every window but (B)KB FastApproximation) and its pointer, and
    ``ncoef`` of a launch; absent pointers are 0.  The caller holds the
    taps tensor across the launch; its memory returns to the stream's
    allocator only after, so a later allocation reuses it in stream order."""
    coefs, ncoef = kernel_coefs(plan)
    wtaps = None if coefs is not None else window_weights_blocked(plan)
    return (0 if coefs is None else coefs.data_ptr(), wtaps,
            0 if wtaps is None else wtaps.data_ptr(), ncoef)


# ---------------------------------------------------------------------------
# K4 (1D, 2D), K1 / K6a (3D): spread
# ---------------------------------------------------------------------------


def spread_blocked_plain(plan, vp: torch.Tensor) -> torch.Tensor:
    """Plain version of the spread kernel: chunked ``index_add_`` from the
    sorted cells and fractions.  ``vp``: (C, Np) in original point order."""
    return spread_cells(
        plan.kernel_data, plan.evalmode, plan.shape_over, plan.cells_sorted,
        plan.fracs_sorted, vp[:, plan.sort_perm], chunk_size=plan.chunk_size,
    )


def spread_blocked(plan, vp: torch.Tensor) -> torch.Tensor:
    """Blocked type-1 spreading.  ``vp``: (C, Np) of the plan's dtype in
    original point order.  Returns the oversampled grid ``(C,) +
    shape_over`` of the same dtype."""
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
    name = entry_point("spread", plan)
    fn = getattr(build.load(), name)
    coefs, wtaps, wtaps_ptr, ncoef = _launch_args(plan)
    with torch.cuda.device(vp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            vals.data_ptr(), plan.cells_sorted.data_ptr(),
            plan.fracs_sorted.data_ptr(), plan.pstarts.data_ptr(),
            coefs, wtaps_ptr, grid.data_ptr(), np_, C, plan.m, ncoef,
            *plan.shape_over, *plan.block_dims, stream,
        )
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return grid


# ---------------------------------------------------------------------------
# K5 (1D, 2D), K2 / K6b (3D): interpolate
# ---------------------------------------------------------------------------


def interpolate_blocked_plain(plan, grid: torch.Tensor) -> torch.Tensor:
    """Plain version of the interpolation kernel: chunked gather at the
    sorted points, times ``normfactor``, scattered back to original point
    order."""
    vals = interpolate_cells(
        plan.kernel_data, plan.evalmode, grid, plan.cells_sorted,
        plan.fracs_sorted, plan.normfactor, chunk_size=plan.chunk_size,
    )
    out = torch.empty_like(vals)
    out[:, plan.sort_perm] = vals
    return out


def interpolate_blocked(plan, grid: torch.Tensor) -> torch.Tensor:
    """Blocked type-2 interpolation.  ``grid``: (C,) + shape_over of the
    plan's dtype.  Returns (C, Np) in original point order with the
    prefactor applied."""
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
    name = entry_point("interp", plan)
    fn = getattr(build.load(), name)
    coefs, wtaps, wtaps_ptr, ncoef = _launch_args(plan)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            grid.data_ptr(), plan.cells_sorted.data_ptr(),
            plan.fracs_sorted.data_ptr(), plan.sort_perm.data_ptr(),
            coefs, wtaps_ptr, out.data_ptr(), np_, C, plan.m, ncoef,
            *plan.shape_over, float(plan.normfactor), stream,
        )
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return out
