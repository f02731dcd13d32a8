"""Blocked fast path: wrappers around the hand-written CUDA kernels, each
with its plain PyTorch version: spread K4 (1D, a lane a cell; 2D on the
FP64 tensor cores) and K1/K6a (3D, on the FP64 tensor cores), interpolate
K5 (1D a thread a point for outputs of up to 8 MiB, else from each dense
block's window staged in shared memory; 2D a thread a point) and K2/K6b
(3D, from each block's window staged in shared memory), and the window
taps K3.

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
stack; for every other window ``set_points`` launches K3 once
(``nufft_window_weights_<f32|f64>``, ``csrc/window_weights.cu``, through
``window_taps``), which writes each sorted point's taps from the
window's scalars (``ops/windows.py:window_pack``), and the plan keeps that
table (``Plan.wtaps_sorted``) for the kernels of every exec to read.

A CUDA plan's ``set_points`` forms its sorted point state with two more
kernels (``csrc/bin_sort.cu``) around its one stable sort: ``bin_keys``
(``nufft_bin_keys_<f32|f64>``) writes each point's bin key from its raw
coordinates, and its coordinates packed into one record, and
``sorted_state`` (``nufft_sorted_state_<f32|f64>``) the sorted cells,
fractions and per-block ranges from the sorted keys and the records.  Their
plain version is ``blocking.py``'s chain, which a CPU plan runs, so these
two wrappers take CUDA tensors only.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches its kernel or raises.  Each launch adds one to
``LAUNCHES[entry point]``, which also counts the deconvolution kernels'
launches (``ops/kernels/deconvolve.py``).  A 3D spread launch of C > 1
transforms whose CTAs serve several of them
(``common.spread3d_cta_transforms``) runs the shared-staging kernel
(``csrc/spread_3d.cu``: a CTA a block and a group of transforms) and adds
C to ``SPREAD3D_SHARED[entry point]``; any other 3D spread launch runs the
pipelined kernel (persistent CTAs that take their (block, transform) items
in launch order from a zeroed counter that the wrapper passes, and stage
the next batch while the current one's MMAs run) and adds C to
``SPREAD3D_PIPELINED[entry point]``, and the kernel adds its batches to a
device counter that ``spread3d_batches`` reads.  A 2D interpolation launch
whose value type and M pick the whole-chunk rows design
(``interp2d_rows_served``, ``common.INTERP2D_ROWS_M``, the kernel's
``rows_mask``) adds C to ``INTERP2D_ROWS[entry point]``; the first design
(``interp_2d_point_kernel``) adds nothing.  ``reset_launch_counts`` zeros
the four host counters.

The 2D and 3D spread wrappers gather the values into sorted point order in
the section ``value gather`` (``utils/timer.py:traced``, nested in the
exec's ``(1) spreading``), beside the grid's ``grid zero``; the 1D kernel
gathers them itself, and the plain versions open neither section.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..interpolation import interpolate_cells
from ..spreading import spread_cells
from ..windows import WINDOW_KINDS, cell_scale
from ...utils.timer import traced
from . import build
from .common import (
    DECONVOLVE_STEPS,
    KERNEL_DIMS,
    KERNEL_M_RANGE,
    MAX_SMEM_BYTES,
    VALUE_TYPES,
    deconvolve_entry_name,
    entry_point_name,
    interp1d_gathers,
    interp2d_chunked_rows,
    interp_tiles,
    spread3d_cta_transforms,
    spread_smem_bytes,
    window_weights,
)

#: The window-weights entry point by the plan's real dtype.
WEIGHTS_ENTRY = {torch.float32: "nufft_window_weights_f32",
                 torch.float64: "nufft_window_weights_f64"}
#: The set_points entry points by the coordinates' dtype: bin keys, sorted
#: state.
BIN_SORT_ENTRIES = {torch.float32: ("nufft_bin_keys_f32", "nufft_sorted_state_f32"),
                    torch.float64: ("nufft_bin_keys_f64", "nufft_sorted_state_f64")}

#: Launches of each entry point by its wrapper in this process.
LAUNCHES = {
    **{entry_point_name(kind, ndim, dtype): 0
       for ndim in KERNEL_DIMS
       for kind in ("spread", "interp")
       for dtype in VALUE_TYPES},
    **dict.fromkeys(WEIGHTS_ENTRY.values(), 0),
    **{name: 0 for names in BIN_SORT_ENTRIES.values() for name in names},
    # csrc/deconvolve.cu, launched by ops/kernels/deconvolve.py
    **{deconvolve_entry_name(step, dtype): 0
       for step in DECONVOLVE_STEPS for dtype in VALUE_TYPES},
}

#: Transforms that the 3D spread's shared-staging kernel served in this
#: process, by entry point: a launch of C > 1 transforms whose CTAs serve
#: several of them adds C; any other runs the per-transform kernel and adds
#: nothing.
SPREAD3D_SHARED = {entry_point_name("spread", 3, dtype): 0 for dtype in VALUE_TYPES}

#: Transforms that the 3D spread's pipelined one-transform kernel served in
#: this process, by entry point: a 3D launch of C transforms whose CTAs
#: serve one each adds C.
SPREAD3D_PIPELINED = {entry_point_name("spread", 3, dtype): 0 for dtype in VALUE_TYPES}

#: Transforms that the 2D interpolation's whole-chunk rows design served in
#: this process, by entry point: a launch adds ``interp2d_rows_served``.
INTERP2D_ROWS = {entry_point_name("interp", 2, dtype): 0 for dtype in VALUE_TYPES}


def reset_launch_counts() -> None:
    """Zero ``LAUNCHES``, ``SPREAD3D_SHARED``, ``SPREAD3D_PIPELINED`` and
    ``INTERP2D_ROWS``."""
    for counts in (LAUNCHES, SPREAD3D_SHARED, SPREAD3D_PIPELINED, INTERP2D_ROWS):
        for name in counts:
            counts[name] = 0


def spread3d_batches(dtype: torch.dtype):
    """``(staged, overlapped)``: the batches that the 3D spread's pipelined
    kernel of ``dtype``'s value type staged on the current card since the
    kernel library was loaded, and those of them staged while another
    batch's MMAs ran (all but each CTA's first where a CTA holds two operand
    buffers, ``common.spread3d_buffers``).  Waits for the card: for tests
    and probes, never on the exec path."""
    name = f"nufft_spread_3d_batches_{VALUE_TYPES[dtype][0]}"
    counts = (ctypes.c_ulonglong * 2)()
    torch.cuda.synchronize()
    _raise_on_error(name, getattr(build.load(), name)(counts))
    return int(counts[0]), int(counts[1])


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
    of 32 or 64 bits, any window in either mode, M in 2..10, the spread and
    interpolation CTAs' shared memory within the card's: in 3D the spread's
    operands of a batch, in two buffers where they fit and else in one
    (``common.spread3d_buffers``), and one x plane of the interpolation
    window a pass, so any block dims)."""
    if plan.ndim not in KERNEL_DIMS:
        raise NotImplementedError(f"no CUDA kernel takes {plan.ndim}D plans")
    if plan.dtype not in VALUE_TYPES:
        raise NotImplementedError(f"no CUDA kernel takes {plan.dtype} values")
    if plan.m not in KERNEL_M_RANGE:
        raise NotImplementedError(
            f"the CUDA kernels are instantiated for m in "
            f"{KERNEL_M_RANGE.start}..{KERNEL_M_RANGE.stop - 1}, got m={plan.m} "
            "(10 is the JAX package's documented maximum)"
        )
    _, ncoef = kernel_coefs(plan)
    _, scalar_bytes, ncomp = VALUE_TYPES[plan.dtype]
    # The 1D interpolation kernel reads a block too wide to stage from
    # global memory (interp1d_window), so it refuses no block dims.  A 3D
    # spread's shared-staging kernel takes a group of transforms only where
    # it fits (common.spread3d_cta_transforms), else the kernel checked here.
    smem = spread_smem_bytes(plan.block_dims, plan.m, ncoef, scalar_bytes, ncomp)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"block_dims {plan.block_dims} need {smem} B of shared memory "
            f"per spread CTA, above the {MAX_SMEM_BYTES} B a Hopper CTA can use"
        )
    if plan.ndim == 3 and not interp_tiles(plan.block_dims, plan.m, ncoef, scalar_bytes,
                                           ncomp).passes:
        raise ValueError(
            f"block_dims {plan.block_dims}: one x plane of the padded window does "
            f"not fit the {MAX_SMEM_BYTES} B of shared memory a Hopper CTA can use"
        )


def _launch_args(x: torch.Tensor, plan, what: str):
    """The coefficient pointer, the window-taps pointer (the plan's K3
    table, for every window but (B)KB FastApproximation) and ``ncoef`` of a
    launch on ``x`` (the caller's values or grid), absent pointers 0, once
    ``x`` is of the plan's dtype and the plan's point state lies on its
    device, contiguous, of the kernels' dtypes.  The plan's support by the
    kernels was checked where it was made (``check_kernel_support``)."""
    if x.dtype != plan.dtype:
        raise TypeError(f"{what} must be {plan.dtype}, got {x.dtype}")
    coefs, ncoef = kernel_coefs(plan)
    taps = plan.wtaps_sorted
    state = [(plan.cells_sorted, torch.int32), (plan.fracs_sorted, plan.real_dtype),
             (plan.sort_perm, torch.int64), (plan.pstarts, torch.int32),
             (taps if coefs is None else coefs, plan.real_dtype)]
    if coefs is None:
        if taps is None:
            raise ValueError("the plan holds no window taps: call set_points first")
        if tuple(taps.shape) != (plan.ndim, 2 * plan.m, plan.num_points):
            raise ValueError(f"window taps of shape {tuple(taps.shape)} for "
                             f"{plan.num_points} points")
    for t, dt in state:
        if t.device != x.device:
            raise ValueError(
                f"{what} lies on {x.device} but the plan's point state on "
                f"{t.device}"
            )
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"plan point state must be contiguous {dt}")
    return (0 if coefs is None else coefs.data_ptr(),
            0 if coefs is not None else taps.data_ptr(), ncoef)


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


def window_taps(plan):
    """The window taps that the kernels of ``plan``, whose bin-sorted point
    state is set, read from memory: K3's ``(D, 2M, Np)`` table for a window
    they do not evaluate themselves (any but (B)KB FastApproximation), else
    None.  ``set_points`` and every other builder of blocked point state
    keep it as ``wtaps_sorted``, so that no exec launches K3; on the CPU
    the table comes from the plain version."""
    return None if kernel_coefs(plan)[0] is not None else window_weights_blocked(plan)


# ---------------------------------------------------------------------------
# set_points: bin keys and sorted state (csrc/bin_sort.cu)
# ---------------------------------------------------------------------------


#: Elements of a point's record by dimension (``csrc/bin_sort.cu:kRecord``):
#: its coordinates, padded to 4 in 3D; 1D gathers from the points themselves.
BIN_RECORD = {1: 1, 2: 2, 3: 4}


def _bin_launch(x: torch.Tensor, shape_over, block_dims, which: int):
    """Check ``x`` (the points or their records: float32 or float64 on the
    card) and the grid; returns the entry point (``which`` 0 for the keys,
    1 for the sorted state), its geometry argument and the grid's block
    count."""
    if x.device.type != "cuda":
        raise ValueError(f"the set_points kernels take CUDA points, got {x.device}: "
                         "the plain version is blocking.py's chain")
    if x.dtype not in BIN_SORT_ENTRIES:
        raise TypeError(f"points must be float32 or float64, got {x.dtype}")
    nblocks = math.prod(n // b for n, b in zip(shape_over, block_dims))
    if nblocks * math.prod(block_dims) >= 2**31:
        raise ValueError("grid too large for int32 bin keys")
    geom = build.BinGeometry.of(shape_over, block_dims, [cell_scale(n) for n in shape_over])
    return BIN_SORT_ENTRIES[x.dtype][which], geom, nblocks


def bin_keys(pts: torch.Tensor, shape_over, block_dims):
    """``(keys, records)`` of the raw (possibly unfolded) points ``pts`` (D,
    Np): the int32 bin key of each point, ``(Np,)``, ``bid *
    cells_per_block + lcell`` of its folded cell as ``blocking.py:cell_keys``
    forms it from ``cells_and_fracs``' cells, and the points' coordinates
    packed for :func:`sorted_state`'s gather, ``(Np, BIN_RECORD[D])`` (in
    1D ``pts`` itself).  One launch of ``nufft_bin_keys_<type>``."""
    name, geom, _ = _bin_launch(pts, shape_over, block_dims, 0)
    D = len(shape_over)
    if pts.ndim != 2 or pts.shape[0] != D or not pts.is_contiguous():
        raise ValueError(f"points must be contiguous ({D}, Np), got {tuple(pts.shape)}")
    np_ = pts.shape[1]
    if np_ >= 2**31:
        raise ValueError("more points than the int32 ranges hold")
    keys = torch.empty(np_, dtype=torch.int32, device=pts.device)
    records = pts if D == 1 else torch.empty((np_, BIN_RECORD[D]), dtype=pts.dtype,
                                             device=pts.device)
    if np_ == 0:
        return keys, records
    fn = getattr(build.load(), name)
    with torch.cuda.device(pts.device):
        err = fn(pts.data_ptr(), geom, keys.data_ptr(), records.data_ptr(), np_,
                 torch.cuda.current_stream().cuda_stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return keys, records


def sorted_state(records: torch.Tensor, skeys: torch.Tensor, perm: torch.Tensor, shape_over,
                 block_dims):
    """``(cells_sorted, fracs_sorted, pstarts)`` of the points whose
    :func:`bin_keys` gave ``records``, from the stable sort of their keys
    (``skeys`` the sorted keys, ``perm`` the order): the cells decoded from
    the sorted keys, each fraction recomputed from its point's gathered
    coordinates, and each block's first sorted position, equal to
    ``blocking.py``'s ``sorted_copies`` and ``block_starts``.  One launch of
    ``nufft_sorted_state_<type>``."""
    name, geom, nblocks = _bin_launch(records, shape_over, block_dims, 1)
    D, np_ = len(shape_over), skeys.shape[0]
    want = (1, np_) if D == 1 else (np_, BIN_RECORD[D])
    if tuple(records.shape) != want or not records.is_contiguous():
        raise ValueError(f"records must be contiguous {want}, got {tuple(records.shape)}")
    for t, dt in ((skeys, torch.int32), (perm, torch.int64)):
        if (t.dtype != dt or tuple(t.shape) != (np_,) or t.device != records.device
                or not t.is_contiguous()):
            raise ValueError(f"sorted keys and order must be contiguous ({np_},) {dt} on "
                             f"{records.device}")
    dev = records.device
    cells = torch.empty((D, np_), dtype=torch.int32, device=dev)
    fracs = torch.empty((D, np_), dtype=records.dtype, device=dev)
    if np_ == 0:
        return cells, fracs, torch.zeros(nblocks + 1, dtype=torch.int32, device=dev)
    pstarts = torch.empty(nblocks + 1, dtype=torch.int32, device=dev)
    fn = getattr(build.load(), name)
    with torch.cuda.device(dev):
        err = fn(records.data_ptr(), skeys.data_ptr(), perm.data_ptr(), geom, cells.data_ptr(),
                 fracs.data_ptr(), pstarts.data_ptr(), np_,
                 torch.cuda.current_stream().cuda_stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return cells, fracs, pstarts


def interp1d_inverse(plan, perm: torch.Tensor):
    """The sorted position of each point, ``(Np,)`` int32, the inverse of
    ``perm``, for a 1D plan whose interpolation outputs are large enough to
    take the kernel's gather (``common.interp1d_gathers`` at the plan's
    transforms), else None: ``set_points`` keeps it as ``sort_perm_inv``."""
    _, scalar_bytes, ncomp = VALUE_TYPES[plan.dtype]
    if plan.ndim != 1 or not interp1d_gathers(perm.shape[0], plan.ntransforms,
                                              scalar_bytes * ncomp):
        return None
    inv = torch.empty(perm.shape, dtype=torch.int32, device=perm.device)
    inv[perm] = torch.arange(perm.shape[0], dtype=torch.int32, device=perm.device)
    return inv


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


def _sorted_values(vp: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``vp`` (C, Np) in the sorted point order ``perm``, contiguous."""
    return vp[:, perm].contiguous()


def spread_blocked(plan, vp: torch.Tensor) -> torch.Tensor:
    """Blocked type-1 spreading.  ``vp``: (C, Np) of the plan's dtype in
    original point order.  Returns the oversampled grid ``(C,) +
    shape_over`` of the same dtype.  On the card the kernel adds into a grid
    zeroed in the section ``grid zero`` (``utils/timer.py:traced``, nested
    in the exec's ``(1) spreading``), and in 2D and 3D reads the values
    gathered into sorted order in the section ``value gather``; the plain
    version opens neither."""
    if vp.device.type == "cpu":
        return spread_blocked_plain(plan, vp)
    if vp.device.type != "cuda":
        raise ValueError(f"no spread kernel for device {vp.device}")
    coefs, wtaps, ncoef = _launch_args(vp, plan, "values")
    C, np_ = vp.shape
    if np_ != plan.num_points:
        raise ValueError(f"{np_} values for {plan.num_points} points")
    grid = traced(plan.timer, "grid zero", torch.zeros, (C,) + tuple(plan.shape_over),
                  dtype=vp.dtype, device=vp.device)
    if np_ == 0:  # a rank of the spatial mode may own no point
        return grid
    # The 1D kernel reads the values through the sort permutation; the 2D
    # and 3D kernels take them sorted, and the 3D pipelined kernel a zeroed
    # counter from which its CTAs take their items.
    shared = plan.ndim == 3 and spread3d_cta_transforms(
        plan.block_dims, plan.m, ncoef, *VALUE_TYPES[plan.dtype][1:], C) > 1
    extra, work = (), None
    if plan.ndim == 1:
        extra = (plan.sort_perm.data_ptr(),)
    elif plan.ndim == 3:
        if not shared:
            work = torch.zeros(1, dtype=torch.int32, device=vp.device)
        extra = (0 if shared else work.data_ptr(),)
    vals = (vp.contiguous() if plan.ndim == 1
            else traced(plan.timer, "value gather", _sorted_values, vp, plan.sort_perm))
    name = entry_point("spread", plan)
    fn = getattr(build.load(), name)
    with torch.cuda.device(vp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            vals.data_ptr(), plan.cells_sorted.data_ptr(),
            plan.fracs_sorted.data_ptr(), plan.pstarts.data_ptr(),
            coefs, wtaps, grid.data_ptr(), *extra, np_, C, plan.m, ncoef,
            *plan.shape_over, *plan.block_dims, stream,
        )
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    if plan.ndim == 3:
        (SPREAD3D_SHARED if shared else SPREAD3D_PIPELINED)[name] += C
    return grid


# ---------------------------------------------------------------------------
# K5 (1D, 2D), K2 / K6b (3D): interpolate
# ---------------------------------------------------------------------------


def interp2d_rows_served(plan, ntransforms: int) -> int:
    """Transforms of one interpolation launch on ``plan`` that the 2D
    kernel's whole-chunk rows design serves: all ``ntransforms`` of a 2D plan
    whose value type and M pick it (``common.interp2d_chunked_rows``), else
    0 (any other dimension, or the first design's ``interp_2d_point_kernel``)."""
    _, scalar_bytes, ncomp = VALUE_TYPES[plan.dtype]
    return ntransforms if plan.ndim == 2 and interp2d_chunked_rows(scalar_bytes, ncomp,
                                                                   plan.m) else 0


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
    coefs, wtaps, ncoef = _launch_args(grid, plan, "grid")
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
    # The 1D kernel scatters an output of up to 8 MiB to perm[j] a point a
    # thread, and puts a larger one in order through a sorted scratch table
    # and the inverse permutation (csrc/interp_1d.cu).
    scratch, gather = None, ()
    if plan.ndim == 1:
        if interp1d_gathers(np_, C, out.element_size()):
            inv = plan.sort_perm_inv
            if (inv is None or inv.dtype != torch.int32 or tuple(inv.shape) != (np_,)
                    or inv.device != grid.device):
                raise ValueError("this 1D plan's outputs need its (Np,) int32 sort_perm_inv: "
                                 "call set_points")
            scratch = torch.empty_like(out)
        gather = (0, 0) if scratch is None else (scratch.data_ptr(), plan.sort_perm_inv.data_ptr())
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        # The 1D and 3D kernels walk the blocks (csrc/interp_{1,3}d.cu).
        pstarts, dims = (((plan.pstarts.data_ptr(),), plan.block_dims) if plan.ndim != 2
                         else ((), ()))
        err = fn(
            grid.data_ptr(), plan.cells_sorted.data_ptr(),
            plan.fracs_sorted.data_ptr(), plan.sort_perm.data_ptr(), *pstarts,
            coefs, wtaps, out.data_ptr(), *gather, np_, C, plan.m, ncoef,
            *plan.shape_over, *dims, float(plan.normfactor), stream,
        )
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    served = interp2d_rows_served(plan, C)
    if served:
        INTERP2D_ROWS[name] += served
    return out
