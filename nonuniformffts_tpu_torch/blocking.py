"""Device-side point bin-sorting into spatial blocks, and the Hopper block
geometry.

Counterpart of ``nonuniformffts_tpu/blocking.py``.  Points sort by
``key = bid * prod(B) + linear_local_cell`` (block-major, row-major local
cell minor; ``packed_layout`` in the JAX package) with ONE stable sort, so
each block's points are a contiguous range of the sorted arrays and the
order equals the JAX package's stable ``lax.sort``.  The per-block ranges
come from one binary search a block over the sorted keys
(``searchsorted``), which reads nothing back to the host.

The block id derives from the same high-accuracy cell split the kernels use
(``ops/windows.py:point_to_cell_split``), so a point can never land outside
its block's padded window (reference: src/blocking/gpu.jl:145-160).

This chain (:func:`cells_and_fracs`, :func:`bin_order`,
:func:`sorted_copies`) is the plain version of the two CUDA kernels that a
CUDA plan's ``set_points`` runs around the same stable sort
(``ops/kernels/blocked.py:bin_keys`` and ``sorted_state``,
``csrc/bin_sort.cu``): CPU plans run it, and the card test holds the
kernels to it.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple

import torch

from .ops.kernels.common import (
    NUM_SMS,
    spread2d_units,
    spread_ctas_per_sm,
    spread_tiles,
)
from .ops.stencil import cells_and_fracs

__all__ = [
    "block_ids_from_cells",
    "bin_counts",
    "bin_order",
    "bin_sort",
    "block_starts",
    "cell_keys",
    "cells_and_fracs",
    "choose_geometry",
    "num_blocks",
    "sorted_copies",
]


def num_blocks(shape_over: Sequence[int], block_dims: Sequence[int]) -> Tuple[int, ...]:
    return tuple(n // b for n, b in zip(shape_over, block_dims))


#: A 1D grid is cut into at least this many blocks per SM where it can be:
#: two full waves of the 8 CTAs of 256 threads an SM holds of the 1D spread
#: kernel.  At 1,572,864 cells and 10M complex128 points, B = 1,024 (1.45
#: waves) ran 1.69 ms and B = 512 1.05 ms (``chip_probe.py``, PERF.md).
BLOCKS_PER_SM_1D = 16
#: Longest 1D block considered (its start table takes 4 B a cell).
MAX_BLOCK_1D = 16_384

# The 3D chooser's cost model (``csrc/spread_3d.cu``), fitted to the
# geometry sweep of ``chip_probe.py --spread3d`` (14 geometries, four dtypes,
# two densities at grid 384^3; mean error 12%, PERF.md): a non-empty block
# costs a fixed time and each of its points a time per staged row (its
# 3 x 2M taps and the dense operand rows), once a pass, over the CTAs an SM
# holds at once (two at most: the sweep's range).  The MMAs, the warps and
# the flush took no weight of their own.
#: Seconds of one non-empty block, a pass.
SPREAD3D_BLOCK_S = 6.18e-8
#: Seconds to stage one point into one row, a pass.
SPREAD3D_POINT_ROW_S = 1.22e-11
#: Points per oversampled cell the model is summed over: the 3D main path's
#: two point counts at grid 384^3 (1M and 16,777,216, rho = 1).
SPREAD3D_DENSITIES = (1_000_000 / 384 ** 3, 16_777_216 / 384 ** 3)
#: Largest 3D block dim considered.
MAX_BLOCK_3D = 64


def spread3d_cost(block_dims: Sequence[int], m: int, ncomp: int,
                  scalar_bytes: int = 4) -> float:
    """Modelled seconds per oversampled grid cell of the 3D spread kernel at
    ``block_dims``, summed over ``SPREAD3D_DENSITIES`` (uniform points, so
    a block of V cells holds Poisson(rho V) points)."""
    t = spread_tiles(block_dims, m, ncomp)
    vol = 1
    for b in block_dims:
        vol *= b
    ctas = min(spread_ctas_per_sm(scalar_bytes, ncomp, m, 3, 32 * t.warps), 2)
    rows = 6 * m + t.rows + t.padded[1] + 8 * t.z_tiles
    cost = 0.0
    for rho in SPREAD3D_DENSITIES:
        lam = rho * vol  # points a block
        full = -math.expm1(-lam)  # share of blocks holding a point
        cost += full / vol / ctas * t.passes * (
            SPREAD3D_BLOCK_S + SPREAD3D_POINT_ROW_S * lam / full * rows)
    return cost


# The 2D chooser's cost model (``csrc/spread_2d.cu``), fitted to the
# geometry sweep of ``chip_probe.py --spread2d`` (18 geometries at grid
# 6144^2, m = 4, four dtypes, 1M and 16,777,216 points; mean error 8.5-11.8%
# by dtype, PERF.md): the kernel's seconds on the whole card are a sum of
# four counts, each times a constant of the value type:
#
# - each non-empty block's units (a warp's set-up, the unit loop and the
#   flush's code);
# - the cells the flush adds into the grid (those some point reached);
# - each point's taps, once a unit (2M taps of a dimension a lane, staged);
# - each point's MMA tiles over all units (row tiles x n-tiles; 8 points a
#   k-step).
#: Constants (seconds per count) by (scalar bytes, components): block-unit,
#: flushed cell, point-unit tap, point tile.
SPREAD2D_COST = {
    (4, 2): (1.37e-9, 2.93e-12, 2.96e-12, 4.51e-12),
    (8, 2): (1.60e-9, 1.15e-11, 3.85e-12, 3.16e-12),
    (4, 1): (8.17e-10, 6.39e-12, 1.76e-12, 3.67e-12),
    (8, 1): (1.03e-9, 8.97e-12, 3.10e-12, 3.07e-12),
}
#: Points per oversampled cell the model is summed over: the 2D main path's
#: two point counts at grid 6144^2 (1M and 16,777,216).
SPREAD2D_DENSITIES = (1_000_000 / 6144 ** 2, 16_777_216 / 6144 ** 2)
#: Largest 2D block dim considered.
MAX_BLOCK_2D = 128


def _reach_counts(b: int, m: int) -> torch.Tensor:
    """For each padded index of a block dim of ``b`` cells, how many of the
    block's cells have it within their 2M taps."""
    i = torch.arange(b + 2 * m - 1, dtype=torch.float64)
    return (torch.clamp(i, max=b - 1) - torch.clamp(i - 2 * m + 1, min=0) + 1)


def spread2d_counts(block_dims: Sequence[int], m: int, ncomp: int, rho: float):
    """The cost model's four counts per oversampled grid cell at density
    ``rho`` (uniform points, so a block of V cells holds Poisson(rho V)
    points, and a padded cell reached by q of its cells is flushed with
    probability 1 - exp(-rho q)): non-empty block-units, flushed cells,
    point-unit taps and point tiles."""
    u = spread2d_units(block_dims, m, ncomp)
    vol = block_dims[0] * block_dims[1]
    lam = rho * vol
    full = -math.expm1(-lam)  # share of blocks holding a point
    q = torch.outer(_reach_counts(block_dims[0], m), _reach_counts(block_dims[1], m))
    flushed = float((-torch.expm1(-rho * q)).sum())
    return (full * u.units / vol, flushed / vol, rho * u.units * 2 * m,
            rho * u.row_tiles * u.col_tiles)


def spread2d_cost(block_dims: Sequence[int], m: int, ncomp: int,
                  scalar_bytes: int = 4) -> float:
    """Modelled seconds per oversampled grid cell of the 2D spread kernel at
    ``block_dims``, summed over ``SPREAD2D_DENSITIES``."""
    consts = SPREAD2D_COST[(scalar_bytes, ncomp)]
    return sum(c * n for rho in SPREAD2D_DENSITIES
               for c, n in zip(consts, spread2d_counts(block_dims, m, ncomp, rho)))


def choose_geometry(shape_over: Sequence[int], m: int, scalar_bytes: int = 4,
                    ncomp: int = 2) -> Tuple[int, ...]:
    """Block dims for the spread kernel on an H100, for values of ``ncomp``
    scalars of ``scalar_bytes`` each (complex64: 4, 2; complex128: 8, 2;
    float32: 4, 1; float64: 8, 1).  Each block dim divides its grid dim.

    1D (``csrc/spread_1d.cu`` keeps its sums in registers, so shared memory
    does not bound the block): the longest block, up to ``MAX_BLOCK_1D``
    cells, that still cuts the grid into ``BLOCKS_PER_SM_1D`` blocks per
    SM, or into as many blocks as the grid allows.  At 1,572,864 cells that
    is 512 cells, 3,072 blocks.

    3D (``csrc/spread_3d.cu``, a tensor-core contraction per block with
    its sums in registers): among candidates up to ``MAX_BLOCK_3D`` cells a
    dim with at least two blocks per SM (264 blocks, so the grid fills the
    card), the lowest ``spread3d_cost`` wins, ties going to the wider last
    dim: larger blocks stage more rows a point and may take more passes
    (``spread_tiles``) or fewer CTAs an SM; smaller ones make more blocks.
    At grid 384^3, m = 4: (8, 8, 8) for complex values, (24, 8, 8) for real
    ones.

    2D (``csrc/spread_2d.cu``, a warp a block, its sum a tensor-core
    product in registers, one unit at a time; the CTA's shared memory does
    not depend on the block): among candidates up to ``MAX_BLOCK_2D`` cells
    a dim with at least two blocks per SM, the lowest ``spread2d_cost``
    wins, ties going to the wider last dim: larger blocks flush fewer halo
    cells a point but may take more units (each a walk over the block's
    points) and more MMA tiles a point; smaller ones make more blocks.
    """
    D = len(shape_over)
    if D == 1:
        n = shape_over[0]
        want = BLOCKS_PER_SM_1D * NUM_SMS
        return (max((b for b in range(1, min(n, MAX_BLOCK_1D) + 1) if n % b == 0),
                    key=lambda b: (min(n // b, want), b)),)
    total = 1
    for n in shape_over:
        total *= n
    if D == 3:
        per_dim = [[b for b in range(1, min(n, MAX_BLOCK_3D) + 1) if n % b == 0]
                   for n in shape_over]
        return max(itertools.product(*per_dim),
                   key=lambda dims: (total // (dims[0] * dims[1] * dims[2]) >= 2 * NUM_SMS,
                                     -spread3d_cost(dims, m, ncomp, scalar_bytes), dims[-1]))
    per_dim = [[b for b in range(1, min(n, MAX_BLOCK_2D) + 1) if n % b == 0]
               for n in shape_over]
    return max(itertools.product(*per_dim),
               key=lambda dims: (total // (dims[0] * dims[1]) >= 2 * NUM_SMS,
                                 -spread2d_cost(dims, m, ncomp, scalar_bytes), dims[-1]))


def block_ids_from_cells(cells: torch.Tensor, shape_over, block_dims) -> torch.Tensor:
    """Flattened (row-major) block id per point from per-dim cells."""
    nb = num_blocks(shape_over, block_dims)
    bid = None
    for d in range(cells.shape[0]):
        b = torch.div(cells[d], block_dims[d], rounding_mode="floor")
        bid = b if bid is None else bid * nb[d] + b
    return bid


def bin_sort(cells: torch.Tensor, fracs: torch.Tensor, shape_over, block_dims):
    """Stable bin sort of the points by spatial block.

    ``cells`` (D, Np) int32, ``fracs`` (D, Np).  Returns
    ``(cells_sorted, fracs_sorted, perm, pstarts)``: the sorted cells and
    fractions (contiguous), ``perm`` (Np,) int64 with ``perm[j]`` the
    original index of sorted point ``j``, and ``pstarts`` (nblocks + 1,)
    int32, block ``b``'s points being sorted positions
    ``[pstarts[b], pstarts[b + 1])``: :func:`bin_order`, then
    :func:`sorted_copies`.
    """
    perm, pstarts = bin_order(cells, shape_over, block_dims)
    return (*sorted_copies(cells, fracs, perm), perm, pstarts)


def bin_counts(shape_over, block_dims) -> Tuple[int, int]:
    """``(nblocks, cells_per_block)`` of the grid's blocks; raises where
    the grid's cells do not fit the int32 bin keys."""
    nblocks = math.prod(num_blocks(shape_over, block_dims))
    cells_per_block = math.prod(int(b) for b in block_dims)
    if nblocks * cells_per_block >= 2**31:
        raise ValueError("grid too large for int32 bin keys")
    return nblocks, cells_per_block


def cell_keys(cells: torch.Tensor, shape_over, block_dims) -> torch.Tensor:
    """The int32 bin key of each point's cell, ``bid * cells_per_block +
    lcell``: its block id and its row-major cell inside the block, so the
    keys sort the points by block."""
    _, cells_per_block = bin_counts(shape_over, block_dims)
    bid = block_ids_from_cells(cells, shape_over, block_dims)
    lcell = None
    for d in range(cells.shape[0]):
        ld = torch.remainder(cells[d], block_dims[d])
        lcell = ld if lcell is None else lcell * int(block_dims[d]) + ld
    return (bid * cells_per_block + lcell).to(torch.int32)


def block_starts(skeys: torch.Tensor, shape_over, block_dims) -> torch.Tensor:
    """``pstarts`` (nblocks + 1,) int32 from the sorted keys: block ``b``
    starts at the first key of block ``b`` or above: one binary search a
    block, with nothing read back to the host."""
    nblocks, cells_per_block = bin_counts(shape_over, block_dims)
    firsts = torch.arange(nblocks + 1, dtype=torch.int32, device=skeys.device) * cells_per_block
    return torch.searchsorted(skeys, firsts, out_int32=True)


def bin_order(cells: torch.Tensor, shape_over, block_dims):
    """The order of :func:`bin_sort`, without its copies: ``(perm,
    pstarts)`` from one stable sort of the keys (:func:`cell_keys`) and
    :func:`block_starts` of the sorted keys."""
    skeys, perm = torch.sort(cell_keys(cells, shape_over, block_dims), stable=True)
    return perm, block_starts(skeys, shape_over, block_dims)


def sorted_copies(cells: torch.Tensor, fracs: torch.Tensor, perm: torch.Tensor):
    """The cells and fractions in the order ``perm``, contiguous."""
    return cells[:, perm].contiguous(), fracs[:, perm].contiguous()
