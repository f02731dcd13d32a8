"""Device-side point bin-sorting into spatial blocks, and the Hopper block
geometry.

Counterpart of ``nonuniformffts_tpu/blocking.py``.  Points sort by
``key = bid * prod(B) + linear_local_cell`` (block-major, row-major local
cell minor; ``packed_layout`` in the JAX package) with ONE stable sort, so
each block's points are a contiguous range of the sorted arrays and the
order equals the JAX package's stable ``lax.sort``.  The per-block ranges
come from a histogram (``bincount``) and a prefix sum: the card can scatter,
so no binary search over the keys is needed.

The block id derives from the same high-accuracy cell split the kernels use
(``ops/windows.py:point_to_cell_split``), so a point can never land outside
its block's padded window (reference: src/blocking/gpu.jl:145-160).
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch

from .ops.kernels.common import (
    ACC_BYTES,
    MAX_SMEM_BYTES,
    NUM_SMS,
    SM_SMEM_BYTES,
    SMEM_RESERVED_PER_CTA,
    spread_bank_conflicts,
    spread_ctas_per_sm,
    spread_smem_bytes,
)
from .ops.stencil import cells_and_fracs

__all__ = [
    "block_ids_from_cells",
    "bin_sort",
    "cells_and_fracs",
    "choose_geometry",
    "num_blocks",
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


def choose_geometry(shape_over: Sequence[int], m: int, scalar_bytes: int = 4,
                    ncomp: int = 2, ncoef: int = None) -> Tuple[int, ...]:
    """Block dims for the spread kernel on an H100, for values of ``ncomp``
    scalars of ``scalar_bytes`` each (complex64: 4, 2; complex128: 8, 2;
    float32: 4, 1; float64: 8, 1) and a window of ``ncoef`` staged
    coefficients a tap (``m + 4`` by default, (B)KB FastApproximation; 0
    for the other windows).  Each block dim divides its grid dim and the
    CTA's shared memory (``spread_smem_bytes``) fits the 227 KB.

    1D (``csrc/spread_1d.cu`` keeps its sums in registers, so shared memory
    does not bound the block): the longest block, up to ``MAX_BLOCK_1D``
    cells, that still cuts the grid into ``BLOCKS_PER_SM_1D`` blocks per
    SM, or into as many blocks as the grid allows.  At 1,572,864 cells that
    is 512 cells, 3,072 blocks.

    2D and 3D (a padded block of ``ncomp`` double planes in shared memory,
    ``ACC_BYTES``): among candidates up to 128 cells a dim with at least two
    blocks per SM (264 blocks, so the grid fills the card), the lowest
    estimated cost ``halo_ratio * conflicts / ctas`` wins, ties going to the
    wider last dim (coalesced flush rows):

    - ``halo_ratio = prod(B + 2M - 1) / prod(B)``: every padded cell of a
      non-empty block costs a global atomic add in the flush;
    - ``conflicts``: lanes of a warp on one shared-memory bank in the tap
      loop (``spread_bank_conflicts``), which depends on the padded last
      dim; K1 ran 1.8x (float32) to 3x (complex64) slower at rho = 1 with
      a last block dim of 24 (4-way) than of 16 (2-way) (PERF.md);
    - ``ctas``: resident CTAs per SM by shared memory, counted up to what
      the register file allows (``spread_ctas_per_sm``).  K1 ran 1.8x
      faster at rho = 1 with three CTAs' worth of shared memory per SM than
      with one (PERF.md): one CTA's atomics stall at its barriers
      unless another CTA runs.  A complex cell takes 16 B, so the same cap
      picks smaller blocks than for real values.
    """
    if ncoef is None:
        ncoef = m + 4
    D = len(shape_over)
    if D == 1:
        n = shape_over[0]
        want = BLOCKS_PER_SM_1D * NUM_SMS
        return (max((b for b in range(1, min(n, MAX_BLOCK_1D) + 1) if n % b == 0),
                    key=lambda b: (min(n // b, want), b)),)
    cta_cap = spread_ctas_per_sm(scalar_bytes, ncomp, m, D)
    per_dim = [[b for b in range(1, min(n, 128) + 1) if n % b == 0]
               for n in shape_over]
    total = 1
    for n in shape_over:
        total *= n
    best, best_score = None, None
    for dims in itertools.product(*per_dim):
        smem = spread_smem_bytes(dims, m, ncoef, scalar_bytes, ncomp)
        if smem > MAX_SMEM_BYTES:
            continue
        ctas = min(SM_SMEM_BYTES // (smem + SMEM_RESERVED_PER_CTA), cta_cap)
        vol, padded = 1, 1
        for b in dims:
            vol *= b
            padded *= b + 2 * m - 1
        conflicts = spread_bank_conflicts(dims[-1] + 2 * m - 1, m, ACC_BYTES)
        score = (total // vol >= 2 * NUM_SMS, -padded / vol * conflicts / ctas,
                 dims[-1])
        if best_score is None or score > best_score:
            best, best_score = tuple(dims), score
    if best is None:
        raise ValueError(
            f"no block geometry fits shared memory for m={m} on grid {shape_over}"
        )
    return best


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
    ``[pstarts[b], pstarts[b + 1])``.
    """
    D = cells.shape[0]
    nb = num_blocks(shape_over, block_dims)
    nblocks = 1
    cells_per_block = 1
    for n_b, b in zip(nb, block_dims):
        nblocks *= n_b
        cells_per_block *= int(b)
    if nblocks * cells_per_block >= 2**31:
        raise ValueError("grid too large for int32 bin keys")
    bid = block_ids_from_cells(cells, shape_over, block_dims)
    lcell = None
    for d in range(D):
        ld = torch.remainder(cells[d], block_dims[d])
        lcell = ld if lcell is None else lcell * int(block_dims[d]) + ld
    key = (bid * cells_per_block + lcell).to(torch.int32)
    _, perm = torch.sort(key, stable=True)
    counts = torch.bincount(bid.to(torch.int64), minlength=nblocks)
    pstarts = torch.zeros(nblocks + 1, dtype=torch.int32, device=cells.device)
    pstarts[1:] = torch.cumsum(counts, 0)
    return (
        cells[:, perm].contiguous(),
        fracs[:, perm].contiguous(),
        perm,
        pstarts,
    )
