"""Shared pieces of the hand-written kernels' Python side: the coefficient
stack they read, the plain version of their tap evaluation, the value types
they are instantiated for, the geometry limits of the card, the
shared-memory footprint of the spread kernels, the rounds of the 1D spread
kernel (``spread1d_warp_rounds``), the tile geometry of the 2D and 3D
spread kernels (``spread2d_units``, ``spread_tiles``), which the kernels and
the block geometry chooser share, the staged windows of the 1D
interpolation kernel (``interp1d_window``, ``interp1d_staged``), the row
geometry, design and register cap of the 2D interpolation kernel
(``interp2d_rows``, ``interp2d_chunked_rows``, ``interp2d_min_ctas``), the staged window and lane groups of the 3D
interpolation kernel (``interp_tiles``, ``interp_lanes``), and the index map,
access width and item count of the deconvolution kernels
(``deconvolve_axes``, ``source_index``, ``mode_index``,
``truncate_sources``, ``pad_sources``, ``deconvolve_vector``,
``deconvolve_items``).

Counterpart of ``nonuniformffts_tpu/ops/pallas/common.py``.  The TPU
kernels placed the 2M taps of each point into dense weight matrices for the
MXU (``build_wt_matrix*``); a Hopper kernel uses the taps directly, so only
the coefficient stack and the tap evaluation (``window_weights`` here,
``csrc/window.cuh`` on the card) carry over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from ..windows import FastApproximation, KernelData, bspline_values_list
from ...utils.besseli0 import besseli0

#: Streaming multiprocessors of an H100 SXM.
NUM_SMS = 132
#: Dynamic shared memory one CTA may opt in to on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448
#: Shared memory of one SM (228 KB), of which the system keeps 1 KB per CTA.
SM_SMEM_BYTES = 233_472
SMEM_RESERVED_PER_CTA = 1024
#: Registers of one SM.
SM_REGISTERS = 65_536
#: Threads and CTAs one SM holds at most.
SM_THREADS = 2048
SM_CTAS = 32
#: Half-supports M the kernels are instantiated for (``csrc/window.cuh:
#: NUFFT_FOR_EACH_M``); 10 is the JAX package's documented maximum.
KERNEL_M_RANGE = range(2, 11)
#: Dimensions the kernels are instantiated for (``csrc/{spread,interp}_<D>d.cu``).
KERNEL_DIMS = (1, 2, 3)
#: Bytes of one scalar of the spread kernels' sums (``csrc/spread_<D>d.cu``):
#: double for every value type, since float32 sums of the ~150 terms a cell
#: takes at rho = 1 in 3D cost err1 more than the JAX package's float32
#: kernels do (ROADMAP queue 3, P2).
ACC_BYTES = 8

# The 1D spread kernel (``csrc/spread_1d.cu``, which must match): a CTA a
# block and transform, a lane a local cell; each warp walks one contiguous
# run of rounds of 32 cells (``spread1d_warp_rounds``), carrying the 2M - 1
# padded cells past a round into the next in registers, and its last carry
# reaches the next warp through shared memory.
#: Threads of one 1D spread CTA (``kThreads`` there).
SPREAD1D_THREADS = 256

# The 3D spread kernel's tiles (``csrc/spread_3d.cu``, which must match).  A
# padded block's sum is the product G (NCOMP pd0 x pd1 pd2') of the block's
# points, on the FP64 tensor cores: rows (i, k) with the value component k
# fastest, columns (j, l) with l padded to a multiple of 8 (pd2'), so that
# an n-tile of 8 columns is one z row's run.  G is cut into units of
# ``SPREAD3D_UNIT_ROWS`` rows x ``SPREAD3D_UNIT_COL_TILES`` n-tiles, one unit
# a warp, kept in registers (32 doubles a lane) across the block's points.
#: Rows of one MMA tile (``kAtomRows``): 16 for
#: ``mma.sync.m16n8k8.f64``, which ran faster than m16n8k4 and m8n8k4 at
#: rho = 1 (PERF.md).
SPREAD3D_ATOM_ROWS = 16
#: Rows and n-tiles (8 columns each) of one warp's unit.
SPREAD3D_UNIT_ROWS = 32
SPREAD3D_UNIT_COL_TILES = 4
#: Warps of one CTA at most; a block with more units walks its points once
#: per pass of this many.
SPREAD3D_MAX_WARPS = 16
#: Points staged in shared memory at a time (a multiple of the MMA's k = 8),
#: and the doubles from one staged operand row to the next.
SPREAD3D_BATCH = 64
SPREAD3D_STRIDE = SPREAD3D_BATCH + 4
#: Registers a thread of the 3D spread kernels takes at most
#: (``__launch_bounds__`` of ``SPREAD3D_MAX_WARPS`` warps): 128.
SPREAD3D_MAX_REGISTERS = SM_REGISTERS // (SPREAD3D_MAX_WARPS * 32)
#: Grid bytes that the transforms of one CTA of the 3D shared-staging
#: kernel cover at most (``kCtaGridBytes``): a CTA adds into one padded
#: block of each of its transforms' grids, and with more the halos that
#: neighbouring CTAs add to fall out of L2 between their flushes (16
#: complex64 or float32 transforms at the main paths' blocks, 8 complex128
#: or float64: the fastest of 8, 16 and 32 in each dtype, PERF.md §6).
SPREAD3D_CTA_GRID_BYTES = 448 * 1024

# The 2D spread kernel's units (``csrc/spread_2d.cu``, which must match): the
# 3D kernel's product with the z factor dropped, G (NCOMP pd0 x pd1') +=
# A B with pd1' = pd1 rounded to 8, a warp a block.  G is cut into units of
# ``SPREAD2D_UNIT_ROWS`` rows x ``SPREAD2D_UNIT_COL_TILES`` n-tiles, which the
# warp keeps in registers one at a time, walking the block's points once a
# unit; each warp stages its points' dense operand rows (the unit's A rows
# and B rows, ``SPREAD2D_STRIDE`` doubles apart) in its own slice of shared
# memory, ``SPREAD2D_BATCH`` points at a time.
#: Warps of one 2D spread CTA, a block each at a time (``kWarps``).
SPREAD2D_WARPS = 8
#: Points a warp stages at a time (two k-steps of the m16n8k8 MMA).
SPREAD2D_BATCH = 16
SPREAD2D_STRIDE = SPREAD2D_BATCH + 4
#: Rows (two m16 tiles) and n-tiles (8 columns each) of one unit.
SPREAD2D_UNIT_ROWS = 32
SPREAD2D_UNIT_COL_TILES = 4

# The 3D interpolation kernel (``csrc/interp_3d.cu``, which must match): a
# CTA stages each dense block's padded window in shared memory, after a
# batch's sums, the coefficient table (ncoef, 3, span), a batch's taps
# (3, 2M, batch) and int32 cells (3, batch), the blocks' point ranges and
# three int32 offset tables (one entry per padded index of each dim); a
# group of lanes contracts each point.
#: Threads of one interpolation CTA (``kThreads``).
INTERP3D_THREADS = 256
#: Blocks with fewer points are read from global memory instead of staged
#: (``kSparse``).
INTERP3D_SPARSE = 64
#: Most spatial blocks one CTA covers (``csrc/interp_3d.cu:kMaxGroup``).
INTERP3D_MAX_GROUP = 64
#: Bytes of one shared-memory wavefront (32 banks of 4 bytes).
WAVEFRONT_BYTES = 128

# The 1D interpolation kernel's staged path (``csrc/interp_1d.cu``, which
# must match; outputs above ``INTERP1D_GATHER_BYTES``): a CTA a spatial
# block; a block with a point for every ``INTERP1D_SPARSE`` cells of its
# window stages the window in shared memory from the 16-byte chunk that
# holds its first cell (``interp1d_window``, ``interp1d_staged``), the
# others read the grid in global memory.
#: A block is staged when it holds a point for every this many cells of its
#: window (``kSparse``).
INTERP1D_SPARSE = 8
#: Shared memory for the staged windows of one pass over the transforms
#: (``kStageBytes``).
INTERP1D_STAGE_BYTES = 32768
#: An output of more bytes than this takes the staged path, written in
#: sorted order and then gathered into the caller's order
#: (``interp1d_gathers``): where the two paths' times cross on the H100
#: (``chip_probe.py --interp1d-sweep``: the point path ahead or level at
#: 7.6 MiB, behind at 11.4 MiB, in all four value types and at one and two
#: transforms).
INTERP1D_GATHER_BYTES = 8 << 20

# The 2D interpolation kernel (``csrc/interp_2d.cu``, which must match): a
# thread a sorted point; each row of its window read as whole 16-byte
# chunks from the chunk that holds the row's first cell (``interp2d_rows``),
# a few rows issued before their FMAs; the registers capped for
# ``interp2d_min_ctas`` CTAs an SM.
#: Threads of one CTA (``kThreads``).
INTERP2D_THREADS = 256
#: Registers of loaded cells a thread keeps in flight (``kLoadRegs``).
INTERP2D_LOAD_REGS = 64
#: The M at which each value type, by (scalar bytes, scalars a value), reads
#: whole-chunk rows (``rows_mask``); the others keep the first design's loop.
INTERP2D_ROWS_M = {(4, 2): (7, 8, 9, 10), (8, 2): (4, 9, 10), (4, 1): (2, 7, 8, 9, 10),
                   (8, 1): (5, 6, 7, 8, 9, 10)}

#: The kernels' value types by the plan's dtype: the entry-point suffix
#: (``nufft_spread_<D>d_<suffix>``), the bytes of one scalar and the scalars
#: of one value (2 for complex, 1 for real).
VALUE_TYPES = {
    torch.complex64: ("f32", 4, 2),
    torch.complex128: ("f64", 8, 2),
    torch.float32: ("real_f32", 4, 1),
    torch.float64: ("real_f64", 8, 1),
}

#: Registers per thread of each 3D spread-kernel instantiation, by (D,
#: scalar bytes, components) and then M = 2..10, as ``ptxas -v`` gave them
#: for sm_90a (CUDA 12.9, PERF.md).  One instantiation serves every window;
#: the 32 doubles of a warp's unit take 64 of them.  The 3D chooser counts
#: the CTAs an SM holds by them; the 1D and 2D kernels launch CTAs of a
#: fixed size and shared memory, so their choosers have no CTA term.
SPREAD_REGISTERS = {
    (3, 4, 2): (128,) * 9,
    (3, 8, 2): (128,) * 9,
    (3, 4, 1): (128,) * 9,
    (3, 8, 1): (128,) * 9,
}


def entry_point_name(kind: str, ndim: int, dtype: torch.dtype) -> str:
    """``nufft_<kind>_<ndim>d_<suffix>``: the C entry point of the
    ``kind`` ('spread' or 'interp') kernel for ``ndim``-D plans of
    ``dtype``."""
    return f"nufft_{kind}_{ndim}d_{VALUE_TYPES[dtype][0]}"


#: The deconvolution kernels' steps (``csrc/deconvolve.cu``): type 1's
#: truncate-and-scale and type 2's scale-and-pad.
DECONVOLVE_STEPS = ("truncate", "pad")


def deconvolve_entry_name(step: str, dtype: torch.dtype) -> str:
    """``nufft_deconvolve_<step>_<suffix>``: the C entry point of the
    deconvolution ``step`` for a plan of ``dtype`` (a real plan's suffix for
    its complex spectrum)."""
    return f"nufft_deconvolve_{step}_{VALUE_TYPES[dtype][0]}"


class DeconvolveAxes(NamedTuple):
    """A plan's spectra as the deconvolution kernels see them
    (``csrc/deconvolve.cu:DeconvGeometry``): three axes, missing leading
    ones of length 1 with one run; on axis d output index ``i < len0[d]``
    sits at ``start0[d] + i`` of the oversampled axis, the others at
    ``start1[d] + i - len0[d]``."""

    out: Tuple[int, int, int]
    over: Tuple[int, int, int]
    start0: Tuple[int, int, int]
    len0: Tuple[int, int, int]
    start1: Tuple[int, int, int]


def deconvolve_axes(index_ranges, shape_over_spec: Sequence[int]) -> DeconvolveAxes:
    """The kernels' axes of a plan's ``index_ranges`` (one or two
    ``(start, length)`` runs an axis, in output order) and oversampled
    spectral shape."""
    pad = 3 - len(index_ranges)
    axes = [((0, 1),)] * pad + [tuple(r) for r in index_ranges]
    over = (1,) * pad + tuple(int(n) for n in shape_over_spec)
    runs = [r + ((0, 0),) * (2 - len(r)) for r in axes]
    return DeconvolveAxes(
        out=tuple(sum(int(l) for _, l in r) for r in axes), over=over,
        start0=tuple(int(r[0][0]) for r in runs), len0=tuple(int(r[0][1]) for r in runs),
        start1=tuple(int(r[1][0]) for r in runs))


def source_index(axes: DeconvolveAxes, d: int) -> torch.Tensor:
    """``csrc/deconvolve.cu:source`` along axis ``d``: the oversampled index
    each output index reads."""
    i = torch.arange(axes.out[d])
    return torch.where(i < axes.len0[d], axes.start0[d] + i, axes.start1[d] + i - axes.len0[d])


def mode_index(axes: DeconvolveAxes, d: int) -> torch.Tensor:
    """``csrc/deconvolve.cu:mode`` along axis ``d``: the output index each
    oversampled index holds, -1 where pad writes a zero."""
    j = torch.arange(axes.over[d])
    a, b = j - axes.start0[d], j - axes.start1[d]
    len1 = axes.out[d] - axes.len0[d]
    return torch.where((a >= 0) & (a < axes.len0[d]), a,
                       torch.where((b >= 0) & (b < len1), axes.len0[d] + b, -1))


def truncate_sources(axes: DeconvolveAxes) -> torch.Tensor:
    """``(out0, out1, out2)``: the flat index into one transform's
    ``(over0, over1, over2)`` spectrum that each output mode of the truncate
    kernel reads."""
    s0, s1, s2 = (source_index(axes, d) for d in range(3))
    return (s0[:, None, None] * axes.over[1] + s1[None, :, None]) * axes.over[2] + s2


def pad_sources(axes: DeconvolveAxes) -> torch.Tensor:
    """``(over0, over1, over2)``: the flat index into one transform's
    ``(out0, out1, out2)`` modes that each element of the pad kernel reads,
    -1 where it writes a zero."""
    m0, m1, m2 = (mode_index(axes, d) for d in range(3))
    flat = (m0[:, None, None] * axes.out[1] + m1[None, :, None]) * axes.out[2] + m2
    kept = (m0[:, None, None] >= 0) & (m1[None, :, None] >= 0) & (m2 >= 0)
    return torch.where(kept, flat, -1)


def deconvolve_vector(axes: DeconvolveAxes, value_bytes: int) -> int:
    """Values of one access of the deconvolution kernels: 2 complex64 (16
    bytes) where the last axis's extents and run bounds are even, so that
    no pair straddles a run or a row and each pair is 16-byte aligned; else
    1."""
    last = (axes.out[2], axes.over[2], axes.start0[2], axes.len0[2], axes.start1[2])
    return 2 if value_bytes == 8 and not any(v % 2 for v in last) else 1


#: Accesses of one work item of the deconvolution kernels (a warp's 32 lanes
#: x 8) and the items of one transform they take, fewer than 2^31 - 1
#: (``csrc/deconvolve.cu``: ``kItemVecs``, ``kMaxItems``).
DECONVOLVE_ITEM_VECS = 32 * 8
DECONVOLVE_MAX_ITEMS = 2**31 - 1


def deconvolve_items(axes: DeconvolveAxes, step: str, vec: int) -> int:
    """``csrc/deconvolve.cu:items_of``: the (row, chunk) work items of one
    transform of ``step``, over the output rows of truncate or the
    oversampled rows of pad, ``vec`` values an access.  The kernels index
    items in 32-bit arithmetic and refuse ``DECONVOLVE_MAX_ITEMS`` or more;
    their element offsets are 64-bit."""
    rows = axes.out if step == "truncate" else axes.over
    return rows[0] * rows[1] * -(-(rows[2] // vec) // DECONVOLVE_ITEM_VECS)


def spread_registers(scalar_bytes: int, ncomp: int, m: int, ndim: int) -> int:
    """Registers a thread of the spread kernel takes, rounded to the 8 a
    warp is given at a time (256 a warp)."""
    # A plan beyond the instantiated M runs only its plain version, on the
    # CPU; its geometry takes the largest M's row.
    m = min(m, KERNEL_M_RANGE.stop - 1)
    regs = SPREAD_REGISTERS[(ndim, scalar_bytes, ncomp)][m - KERNEL_M_RANGE.start]
    return -(-regs // 8) * 8


def spread_ctas_per_sm(scalar_bytes: int, ncomp: int, m: int, ndim: int,
                       threads: int) -> int:
    """Resident spread CTAs of ``threads`` threads per SM that the register
    file allows; a 3D CTA's threads come from ``spread_tiles``."""
    regs = spread_registers(scalar_bytes, ncomp, m, ndim)
    return max(SM_REGISTERS // (regs * threads), 1)


@dataclasses.dataclass(frozen=True)
class SpreadTiles:
    """The tile geometry of one padded block in the 3D spread kernel
    (``csrc/spread_3d.cu:Tiles`` and its launch)."""

    padded: Tuple[int, int, int]
    row_tiles: int   # ceil(NCOMP pd0 / SPREAD3D_ATOM_ROWS)
    z_tiles: int     # ceil(pd2 / 8): the n-tiles of one z row
    col_tiles: int   # pd1 z_tiles
    units: int       # row groups x column groups, one warp's each
    passes: int      # walks over the block's points
    warps: int       # warps of one CTA

    @property
    def rows(self) -> int:
        """Rows of G the MMAs cover, padding included."""
        return self.row_tiles * SPREAD3D_ATOM_ROWS

    @property
    def cols(self) -> int:
        """Columns of G the MMAs cover, padding included."""
        return self.col_tiles * 8

    @property
    def dense_fmas(self) -> int:
        """FMAs of one point through every tile, before the kernel skips
        the tiles no point of a k-step reaches."""
        return self.rows * self.cols


def spread_tiles(block_dims: Sequence[int], m: int, ncomp: int) -> SpreadTiles:
    """The 3D spread kernel's tiles for ``block_dims`` (three dims), M = m
    and values of ``ncomp`` scalars: as few passes as ``SPREAD3D_MAX_WARPS``
    warps allow, the units spread evenly over the warps."""
    pd = padded_block_dims(block_dims, m)
    row_tiles = -(-ncomp * pd[0] // SPREAD3D_ATOM_ROWS)
    z_tiles = -(-pd[2] // 8)
    col_tiles = pd[1] * z_tiles
    row_groups = -(-row_tiles // (SPREAD3D_UNIT_ROWS // SPREAD3D_ATOM_ROWS))
    units = row_groups * -(-col_tiles // SPREAD3D_UNIT_COL_TILES)
    passes = -(-units // SPREAD3D_MAX_WARPS)
    return SpreadTiles(pd, row_tiles, z_tiles, col_tiles, units, passes,
                       -(-units // passes))


@dataclasses.dataclass(frozen=True)
class Spread2DUnits:
    """The unit geometry of one padded block in the 2D spread kernel
    (``csrc/spread_2d.cu:Units``)."""

    padded: Tuple[int, int]
    row_tiles: int   # ceil(NCOMP pd0 / 16)
    col_tiles: int   # ceil(pd1 / 8)
    col_groups: int  # ceil(col_tiles / SPREAD2D_UNIT_COL_TILES)
    units: int       # row groups x column groups, walked one after another

    @property
    def rows(self) -> int:
        """Rows of G the MMAs cover, padding included."""
        return self.row_tiles * 16

    @property
    def cols(self) -> int:
        """Columns of G the MMAs cover, padding included."""
        return self.col_tiles * 8

    def unit_tiles(self, unit: int) -> Tuple[int, int, int, int]:
        """Unit ``unit``'s first row tile, first n-tile, and its row tiles
        and n-tiles (``csrc/spread_2d.cu``, the unit loop)."""
        per_unit = SPREAD2D_UNIT_ROWS // 16
        rt0 = unit // self.col_groups * per_unit
        ct0 = unit % self.col_groups * SPREAD2D_UNIT_COL_TILES
        return (rt0, ct0, min(per_unit, self.row_tiles - rt0),
                min(SPREAD2D_UNIT_COL_TILES, self.col_tiles - ct0))


def spread2d_coef_stride(m: int, ncoef: int, scalar_bytes: int) -> int:
    """Scalars from one dim's staged coefficients to the next's in the 2D
    spread kernel (``csrc/spread_2d.cu:coef_stride``): the coefficient-major
    ``(ncoef, 2M)`` stack rounded up to 16 bytes past a multiple of 128, so
    that the warp's two halves, one on each dim, read different banks and
    every 16-byte chunk stays aligned."""
    stack = 2 * m * ncoef * scalar_bytes
    return (stack + (16 - stack) % 128) // scalar_bytes


def spread2d_units(block_dims: Sequence[int], m: int, ncomp: int) -> Spread2DUnits:
    """The 2D spread kernel's units for ``block_dims`` (two dims), M = m and
    values of ``ncomp`` scalars."""
    pd = padded_block_dims(block_dims, m)
    row_tiles = -(-ncomp * pd[0] // 16)
    col_tiles = -(-pd[1] // 8)
    col_groups = -(-col_tiles // SPREAD2D_UNIT_COL_TILES)
    row_groups = -(-row_tiles // (SPREAD2D_UNIT_ROWS // 16))
    return Spread2DUnits(pd, row_tiles, col_tiles, col_groups, row_groups * col_groups)


@dataclasses.dataclass(frozen=True)
class InterpLanes:
    """The lanes that contract one point in the 3D interpolation kernel
    (``csrc/interp_3d.cu:Lanes``): lane ``q`` of a point takes z tap
    ``q % span`` of window rows ``q // span + rows * k``, ``k < steps``."""

    span: int       # z taps a group spans: 2M rounded up to a power of two, >= 4
    per_point: int  # lanes a point: a wavefront's cells, at least span
    rows: int       # window rows one load instruction reads
    steps: int      # rows a lane walks


def interp_batch(m: int, scalar_bytes: int = 4, ncomp: int = 2) -> int:
    """Points whose taps the 3D interpolation CTA holds at a time
    (``csrc/interp_3d.cu:batch_of``): 128 for complex values, 64 for
    float64, 256 for float32, halved while the (3, 2M, batch) taps exceed
    64 KB."""
    batch = 128 if ncomp == 2 else 64 if scalar_bytes == 8 else 256
    while batch * 6 * m * scalar_bytes > 65536:
        batch //= 2
    return batch


def interp_lanes(m: int, scalar_bytes: int = 4, ncomp: int = 2) -> InterpLanes:
    span = next(s for s in (4, 8, 16, 32) if s >= 2 * m)
    per_point = max(span, WAVEFRONT_BYTES // (scalar_bytes * ncomp))
    rows = per_point // span
    return InterpLanes(span, per_point, rows, -(-2 * m // rows))


@dataclasses.dataclass(frozen=True)
class InterpTiles:
    """The staged window of one padded block in the 3D interpolation kernel
    (``csrc/interp_3d.cu:Window``)."""

    padded: Tuple[int, int, int]
    pitch: int   # cells from one staged z row to the next
    planes: int  # x planes staged a pass
    passes: int  # passes over the window's x planes; 0 if one plane does not fit
    smem: int    # dynamic shared memory of one CTA, bytes


def interp_tiles(block_dims: Sequence[int], m: int, ncoef: int, scalar_bytes: int = 4,
                 ncomp: int = 2) -> InterpTiles:
    """The 3D interpolation kernel's window for ``block_dims`` (three dims),
    M = m, ``ncoef`` coefficients a tap (0 for a window without a
    coefficient stack) and values of ``ncomp`` scalars of ``scalar_bytes``:
    the padded window in as few x-slab passes as the 227 KB allow, the
    planes spread evenly over the passes.  The z pitch is the least >= pd2
    that equals ``interp_lanes(..).span`` modulo a wavefront's cells where
    the span is fewer, so that the rows one load instruction of a point
    reads fall on distinct banks (pd2 otherwise)."""
    pd = padded_block_dims(block_dims, m)
    cells = WAVEFRONT_BYTES // (scalar_bytes * ncomp)
    span = interp_lanes(m, scalar_bytes, ncomp).span
    pitch = pd[2] + (span - pd[2]) % cells if span < cells else pd[2]
    # a batch's sums, the coefficient table, a batch's taps and cells, the
    # blocks' point ranges, the offset tables
    batch = interp_batch(m, scalar_bytes, ncomp)
    head = (scalar_bytes * (ncomp * batch + ncoef * 3 * span + 3 * 2 * m * batch)
            + 4 * (3 * batch + INTERP3D_MAX_GROUP + 1 + sum(pd)))
    head = -(-head // 16) * 16
    plane_bytes = scalar_bytes * ncomp * pd[1] * pitch
    fit = max(MAX_SMEM_BYTES - head, 0) // plane_bytes
    passes = -(-pd[0] // fit) if fit else 0
    planes = -(-pd[0] // passes) if passes else 0
    return InterpTiles(pd, pitch, planes, passes, head + plane_bytes * planes)


@dataclasses.dataclass(frozen=True)
class Interp1DWindow:
    """The staged window of a CTA in the 1D interpolation kernel
    (``csrc/interp_1d.cu:Geometry``)."""

    span: int   # cells of a block's window: b0 + 2M - 1
    chunk: int  # cells of one 16-byte chunk
    cells: int  # cells staged a transform: whole chunks, for the worst offset
    chans: int  # transforms staged a pass; 0 if one window exceeds the budget
    smem: int   # dynamic shared memory of one CTA, bytes

    def first_chunk(self, ox: int, m: int) -> Tuple[int, int]:
        """The first staged cell of the block at cell ``ox`` (unwrapped, a
        multiple of ``chunk`` at or below the window's first cell ``ox - m +
        1``) and the window's first cell's offset from it."""
        s0 = ox - (m - 1)
        a0 = s0 // self.chunk * self.chunk
        return a0, s0 - a0


def interp1d_window(b0: int, m: int, ncoef: int, scalar_bytes: int = 4, ncomp: int = 2,
                    nchan: int = 1) -> Interp1DWindow:
    """The 1D interpolation kernel's window for blocks of ``b0`` cells, M =
    m, ``ncoef`` coefficients a tap (0 for a window without a coefficient
    stack), values of ``ncomp`` scalars of ``scalar_bytes`` and ``nchan``
    transforms: as many transforms a pass as ``INTERP1D_STAGE_BYTES`` hold;
    the coefficient-major ``(ncoef, row_pitch)`` coefficients before the
    windows."""
    cell = scalar_bytes * ncomp
    chunk = 16 // cell
    span = b0 + 2 * m - 1
    cells = (span + 2 * (chunk - 1)) // chunk * chunk
    per = cells * cell
    chans = min(nchan, INTERP1D_STAGE_BYTES // per) if per <= INTERP1D_STAGE_BYTES else 0
    smem = scalar_bytes * row_pitch(2 * m, scalar_bytes) * ncoef + chans * per
    return Interp1DWindow(span, chunk, cells, chans, smem)


def interp1d_staged(points: int, window: Interp1DWindow) -> bool:
    """Whether the 1D interpolation kernel stages a block of ``points``
    points, or reads its points' cells from global memory."""
    return window.chans > 0 and INTERP1D_SPARSE * points >= window.span


@dataclasses.dataclass(frozen=True)
class Interp2DRows:
    """One row of a point's window in the 2D interpolation kernel
    (``csrc/interp_2d.cu:RowGeometry``)."""

    per: int             # cells of one 16-byte chunk
    chunks: int          # chunks a row: the window's 2M cells at any offset
    width: int           # cells loaded a row
    rows_in_flight: int  # rows issued before their FMAs

    def first_chunk(self, cy: int) -> Tuple[int, int]:
        """The first loaded cell of the row window whose first cell is
        ``cy`` (>= 0; a multiple of ``per``) and ``cy``'s offset from it:
        the taps shift by that offset, zero outside the 2M cells."""
        return cy - cy % self.per, cy % self.per

    def whole(self, cy: int, n1: int, chunked: bool) -> bool:
        """Whether the row window starting at cell ``cy`` is read as whole
        chunks within the row (else cell by cell with periodic wrap);
        ``chunked``: the grid's rows are whole chunks from an aligned base."""
        return chunked and cy >= 0 and self.first_chunk(cy)[0] + self.width <= n1


def interp2d_rows(m: int, scalar_bytes: int = 4, ncomp: int = 2) -> Interp2DRows:
    """The 2D interpolation kernel's row geometry at M = m for values of
    ``ncomp`` scalars of ``scalar_bytes``: 16-byte chunks covering 2M cells
    from any offset within a chunk, and as many rows in flight as
    ``INTERP2D_LOAD_REGS`` registers hold (at least one, at most 2M)."""
    per = 16 // (scalar_bytes * ncomp)
    chunks = -(-(2 * m + per - 1) // per)
    row_regs = chunks * 16 // 4
    return Interp2DRows(per, chunks, chunks * per,
                        min(max(INTERP2D_LOAD_REGS // row_regs, 1), 2 * m))


def interp2d_chunked_rows(scalar_bytes: int, ncomp: int, m: int) -> bool:
    """Whether the 2D interpolation kernel's instantiation reads whole-chunk
    rows (``chunked_rows``), or runs the first design's rolled x loop, where
    that was as fast on the H100 (``INTERP2D_ROWS_M``)."""
    return m in INTERP2D_ROWS_M[scalar_bytes, ncomp]


def interp2d_min_ctas(scalar_bytes: int, ncomp: int, m: int) -> int:
    """Resident CTAs an SM that the 2D interpolation kernel's register cap
    leaves room for (``min_ctas``): 32-bit values three to M = 4, two past
    it; 64-bit values two to M = 8, one past it; one (no minimum) for the
    first design's kernel (``interp_2d_point_kernel``)."""
    if not interp2d_chunked_rows(scalar_bytes, ncomp, m):
        return 1
    if scalar_bytes == 4:
        return 2 if m > 4 else 3
    return 1 if m > 8 else 2


def interp2d_smem_bytes(m: int, ncoef: int, scalar_bytes: int = 4, ncomp: int = 2) -> int:
    """Dynamic shared memory of one 2D interpolation CTA: both dimensions'
    coefficients, coefficient-major ``(ncoef, row_pitch)`` tables for the
    whole-chunk rows, tap-major ``(2M, ncoef)`` for the first design."""
    per_dim = (row_pitch(2 * m, scalar_bytes) if interp2d_chunked_rows(scalar_bytes, ncomp, m)
               else 2 * m)
    return 2 * scalar_bytes * per_dim * ncoef


def interp1d_gathers(np_: int, nchan: int, value_bytes: int) -> bool:
    """Whether the 1D interpolation wrapper takes the kernel's staged path,
    which stores the results in sorted order and gathers them into the
    caller's order (an output of ``nchan`` x ``np_`` values of
    ``value_bytes`` beyond ``INTERP1D_GATHER_BYTES``), rather than its point
    path, which scatters them to ``perm[j]``."""
    return nchan * np_ * value_bytes > INTERP1D_GATHER_BYTES


def spread1d_warp_rounds(b0: int) -> Tuple[Tuple[int, int], ...]:
    """Each warp's rounds of 32 local cells, ``[begin, end)``, in the 1D
    spread kernel (``csrc/spread_1d.cu``): one contiguous run a warp, the
    runs as even as ``SPREAD1D_THREADS // 32`` warps allow; a warp past the
    last round has none."""
    warps = SPREAD1D_THREADS // 32
    rounds = -(-b0 // 32)
    per_warp = -(-rounds // warps)
    return tuple((min(w * per_warp, rounds), min((w + 1) * per_warp, rounds))
                 for w in range(warps))


def spread1d_stored(p: int, b0: int, m: int) -> bool:
    """Whether the 1D spread kernel writes padded cell ``p`` of a block with
    a plain store (an interior cell, which no other block reaches) rather
    than a global reduction (the 2(2M - 1) halo cells)."""
    return 2 * m - 1 <= p < b0


def coefficient_stack(kernel_data: Sequence[KernelData]) -> torch.Tensor:
    """The per-dim piecewise-polynomial coefficients as one contiguous
    ``(D, 2M, ncoef)`` tensor in the plan's real dtype, TAP-MAJOR:
    coefficient ``q`` of tap ``t`` sits at ``[d, t, q]``, so a kernel's
    Horner loop for one tap reads ``ncoef`` consecutive scalars.  Only (B)KB
    kernels have one, and the kernels read it only in FastApproximation
    mode.  The JAX package stacks ``cs_gauss`` for the Gaussian and zeros
    for the B-spline; no kernel reads either (the Gaussian takes one exp per
    node, the B-spline de Boor's recurrence), so here they have none and
    launch with ``ncoef = 0``.
    """
    if any(kd.cs_poly is None for kd in kernel_data):
        raise ValueError("coefficient_stack needs (B)KB kernel data")
    return torch.stack([kd.cs_poly.T for kd in kernel_data]).contiguous()


def padded_block_dims(block_dims: Sequence[int], m: int) -> Tuple[int, ...]:
    """Per-dim padded block sizes ``B + 2M - 1``: the block's cells plus the
    halo its points' windows reach."""
    return tuple(int(b) + 2 * m - 1 for b in block_dims)


def row_pitch(taps: int, scalar_bytes: int) -> int:
    """``taps`` rounded up to whole 16-byte rows of ``scalar_bytes``
    scalars: the pitch of a coefficient-major table read by
    ``csrc/window.cuh:horner_rows`` (``row_pitch`` there)."""
    return -(-taps * scalar_bytes // 16) * 16 // scalar_bytes


def _spread3d_shared_bytes(t: SpreadTiles, m: int, ncoef: int, scalar_bytes: int, ncomp: int,
                           ctrans: int) -> int:
    """Dynamic shared memory of one CTA of the 3D shared-staging kernel
    (``csrc/spread_3d.cu:shared_smem_bytes``) serving ``ctrans``
    transforms."""
    ntaps = 3 * 2 * m
    rows = t.rows // ncomp + t.padded[1] + 8 * t.z_tiles
    return (8 * (SPREAD3D_STRIDE * (rows + ncomp * ctrans) + ntaps * SPREAD3D_BATCH)
            + 4 * 3 * SPREAD3D_BATCH + scalar_bytes * ntaps * ncoef)


def spread3d_build_tasks(ncoef: int) -> int:
    """Tasks of one batch's build in the 3D one-transform kernel
    (``csrc/spread_3d.cu:build_tasks``): for the Horner window (``ncoef`` >
    0) the x dim's padded cells in two halves, y and z, so that at the main
    paths' blocks each of the four tasks writes about 15 rows; with the
    window-weights taps (``ncoef`` 0), whose 2M taps each task copies, x, y
    and z."""
    return 4 if ncoef else 3


def _spread3d_bytes(t: SpreadTiles, m: int, ncoef: int, scalar_bytes: int, ncomp: int,
                    nbuf: int) -> int:
    """Dynamic shared memory of one CTA of the 3D one-transform kernel
    (``csrc/spread_3d.cu:spread_smem_bytes``) with ``nbuf`` dense operand
    buffers."""
    tasks = spread3d_build_tasks(ncoef)
    dense = t.rows + t.padded[1] + 8 * t.z_tiles
    state = ((tasks - 2) * scalar_bytes * ncomp + 4 * tasks
             + scalar_bytes * (tasks if ncoef else 3 * 2 * m))
    return (8 * SPREAD3D_STRIDE * dense * nbuf + state * SPREAD3D_BATCH
            + scalar_bytes * 3 * 2 * m * ncoef)


def spread3d_resident_ctas(t: SpreadTiles) -> int:
    """CTAs of the 3D spread kernels that the register file keeps resident
    an SM at ``SPREAD3D_MAX_REGISTERS`` a thread: two at the main paths'
    blocks (8 warps)."""
    return max(1, SM_REGISTERS // (SPREAD3D_MAX_REGISTERS * 32 * t.warps))


def spread3d_buffers(block_dims: Sequence[int], m: int, ncoef: int, scalar_bytes: int,
                     ncomp: int) -> int:
    """Dense operand buffers of one CTA of the 3D one-transform kernel
    (``csrc/spread_3d.cu:spread_buffers``, which must match): two, so that
    the next batch's operands are built while the current batch's MMAs run,
    where they fit beside the CTAs that the register file keeps resident an
    SM (``spread3d_resident_ctas``); else one."""
    t = spread_tiles(block_dims, m, ncomp)
    budget = min(MAX_SMEM_BYTES,
                 SM_SMEM_BYTES // spread3d_resident_ctas(t) - SMEM_RESERVED_PER_CTA)
    return 2 if _spread3d_bytes(t, m, ncoef, scalar_bytes, ncomp, 2) <= budget else 1


def spread3d_persistent_ctas(block_dims: Sequence[int], m: int, ncoef: int, scalar_bytes: int,
                             ncomp: int, items: int, sms: int = NUM_SMS) -> int:
    """CTAs of a launch of the 3D one-transform kernel over ``items``
    (block, transform) items (``csrc/spread_3d.cu``'s launch, by the CUDA
    occupancy calculator there): as many as ``sms`` SMs keep resident by
    registers, shared memory, threads and CTAs, at most one an item."""
    t = spread_tiles(block_dims, m, ncomp)
    smem = spread_smem_bytes(block_dims, m, ncoef, scalar_bytes, ncomp)
    per_sm = min(spread3d_resident_ctas(t), SM_SMEM_BYTES // (smem + SMEM_RESERVED_PER_CTA),
                 SM_THREADS // (32 * t.warps), SM_CTAS)
    return min(items, max(1, per_sm) * sms)


def spread3d_cta_transforms(block_dims: Sequence[int], m: int, ncoef: int, scalar_bytes: int,
                            ncomp: int, nchan: int) -> int:
    """Transforms one CTA of a 3D spread launch of ``nchan`` transforms
    serves (``csrc/spread_3d.cu:cta_transforms``, which must match).  1 runs
    ``spread_3d_kernel``, a CTA a (block, transform); more runs
    ``spread_3d_shared_kernel``, a CTA a block and a group of transforms
    whose point state it stages once: as many as keep their padded blocks
    within ``SPREAD3D_CTA_GRID_BYTES`` and their values within the CTA's
    shared memory beside the rest, while an SM still holds the CTAs its
    register file allows at ``SPREAD3D_MAX_REGISTERS`` a thread; at least
    one."""
    t = spread_tiles(block_dims, m, ncomp)
    block = scalar_bytes * ncomp * math.prod(t.padded)
    budget = min(MAX_SMEM_BYTES,
                 SM_SMEM_BYTES // spread3d_resident_ctas(t) - SMEM_RESERVED_PER_CTA)
    base = _spread3d_shared_bytes(t, m, ncoef, scalar_bytes, ncomp, 0)
    fit = (budget - base) // (8 * SPREAD3D_STRIDE * ncomp) if budget > base else 0
    return max(1, min(nchan, SPREAD3D_CTA_GRID_BYTES // block, fit))


def spread_smem_bytes(block_dims: Sequence[int], m: int, ncoef: int,
                      scalar_bytes: int = 4, ncomp: int = 2, nchan: int = 1) -> int:
    """Dynamic shared memory of one spread CTA for ``D = len(block_dims)``
    (must match ``spread_smem_bytes`` in ``csrc/spread_<D>d.cu``).
    ``ncoef`` is 0 for a window without a coefficient stack (any but (B)KB
    FastApproximation): nothing is staged for it.

    3D, a launch of ``nchan`` transforms whose CTAs serve one each
    (``spread3d_cta_transforms`` 1): ``spread3d_buffers`` buffers of the
    dense operands of one batch of ``SPREAD3D_BATCH`` points (A's rows, the
    y and z taps at every padded row: ``SpreadTiles.rows + pd1 + cols /
    pd1`` rows of ``SPREAD3D_STRIDE`` doubles), the copies of the next
    batch's point state a slot (a point and a task,
    ``spread3d_build_tasks``): the x tasks' values, every task's fraction
    (or the window-weights kernel's 3 x 2M taps) in the plan's precision
    and its int32 cell, then the coefficient stack, coefficient-major
    ``(3, ncoef, 2M)``; the sums live in registers.  3D, CTAs of several
    transforms (the
    shared-staging kernel): the x taps at ``rows / ncomp`` padded rows in
    place of A's rows, and the values of the CTA's transforms in ``ncomp``
    rows of ``SPREAD3D_STRIDE`` doubles each.  2D: each of ``SPREAD2D_WARPS`` warps' unit rows (A's and
    B's, ``SPREAD2D_UNIT_ROWS`` + 8 ``SPREAD2D_UNIT_COL_TILES`` rows of
    ``SPREAD2D_STRIDE`` doubles), then the two dims' coefficient-major
    ``(ncoef, 2M)`` stacks, ``spread2d_coef_stride`` apart; the block dims
    do not enter, and the sums live in registers.  1D: the coefficient-major
    ``(ncoef, row_pitch)`` coefficients, each warp's carry (2M - 1 padded
    cells of ``ncomp`` doubles) and an int32 start table of B + 1 entries;
    the sums live in registers."""
    D = len(block_dims)
    if D == 1:
        return (scalar_bytes * row_pitch(2 * m, scalar_bytes) * ncoef
                + ACC_BYTES * (SPREAD1D_THREADS // 32) * (2 * m - 1) * ncomp
                + 4 * (int(block_dims[0]) + 1))
    if D == 3:
        t = spread_tiles(block_dims, m, ncomp)
        ctrans = spread3d_cta_transforms(block_dims, m, ncoef, scalar_bytes, ncomp, nchan)
        if ctrans > 1:
            return _spread3d_shared_bytes(t, m, ncoef, scalar_bytes, ncomp, ctrans)
        return _spread3d_bytes(t, m, ncoef, scalar_bytes, ncomp,
                               spread3d_buffers(block_dims, m, ncoef, scalar_bytes, ncomp))
    rows = SPREAD2D_UNIT_ROWS + 8 * SPREAD2D_UNIT_COL_TILES
    return (8 * SPREAD2D_WARPS * rows * SPREAD2D_STRIDE
            + scalar_bytes * (spread2d_coef_stride(m, ncoef, scalar_bytes) + 2 * m * ncoef))


def window_weights(kd: KernelData, evalmode, X: torch.Tensor,
                   cs: torch.Tensor = None) -> torch.Tensor:
    """Plain version of the kernels' tap evaluation (``csrc/window.cuh``),
    with the contract of the JAX package's
    ``ops/pallas/common.py:window_weights``: ``X`` (1, P) in-cell fractions,
    ``cs`` the dim's (2M, ncoef) tap-major coefficients ((B)KB
    FastApproximation only).  Returns (2M, P); row ``t`` is the weight of
    grid node ``c - M + 1 + t``.  The Gaussian takes one exp per node in
    both modes, as the kernels do (``ops/windows.py:eval_window_frac``, the
    plain path, uses fast Gaussian gridding in FastApproximation mode; the
    two agree to rounding)."""
    m = kd.m
    dt = X.dtype
    two_m = 2 * m
    P = X.shape[-1]
    if kd.kind in ("kb", "bkb") and isinstance(evalmode, FastApproximation):
        z = (2.0 * X - 1.0).expand(two_m, P)
        cs = cs.to(dt)
        v = cs[:, -1:].expand(two_m, P)
        for q in range(cs.shape[-1] - 2, -1, -1):
            v = v * z + cs[:, q : q + 1]
        return v
    t_col = torch.arange(two_m, dtype=dt, device=X.device)[:, None]
    if kd.kind in ("kb", "bkb"):
        y = (m - 1.0 - t_col + X) / m
        s = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
        bs = kd.beta * s
        if kd.kind == "kb":
            return besseli0(bs) * (1.0 / kd.peak)
        sinh_s = 0.5 * (torch.exp(bs - kd.beta) - torch.exp(-bs - kd.beta))
        ratio = torch.where(bs == 0.0, torch.full_like(bs, math.exp(-kd.beta)),
                            sinh_s / torch.where(bs == 0.0, torch.ones_like(bs), bs))
        return ratio * (kd.beta / (-0.5 * math.expm1(-2.0 * kd.beta)))
    if kd.kind == "gaussian":
        y = (m - 1.0 - t_col + X) * kd.dx
        return torch.exp(-(y * y) * (1.0 / kd.tau))
    if kd.kind == "bspline":
        return torch.cat([v.expand(1, P) for v in bspline_values_list(1.0 - X, two_m)])
    raise ValueError(kd.kind)
