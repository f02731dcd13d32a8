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
    MAX_SMEM_BYTES,
    NUM_SMS,
    SM_SMEM_BYTES,
    SMEM_RESERVED_PER_CTA,
    SPREAD_CTAS_PER_SM,
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


def choose_geometry(shape_over: Sequence[int], m: int) -> Tuple[int, ...]:
    """Block dims for the spread kernel on an H100.

    Each block dim divides its grid dim, and one CTA's padded block
    ``prod(B + 2M - 1)`` (two float planes, 8 B a cell) fits the 227 KB of
    shared memory.  Among candidates with at least two blocks per SM (264
    blocks, so the grid fills the card), the lowest estimated cost
    ``halo_ratio / ctas`` wins, ties going to the wider last dim (coalesced
    flush rows):

    - ``halo_ratio = prod(B + 2M - 1) / prod(B)``: every padded cell of a
      non-empty block costs a global atomic add in the flush;
    - ``ctas``: resident CTAs per SM by shared memory, counted up to
      ``SPREAD_CTAS_PER_SM``.  K1 ran 1.8x faster at rho = 1 with three
      CTAs' worth of shared memory per SM than with one (PERF.md, PR 1):
      one CTA's atomics stall at its barriers unless another CTA runs.
    """
    ncoef = m + 4
    per_dim = [[b for b in range(1, min(n, 128) + 1) if n % b == 0]
               for n in shape_over]
    total = 1
    for n in shape_over:
        total *= n
    best, best_score = None, None
    for dims in itertools.product(*per_dim):
        smem = spread_smem_bytes(dims, m, ncoef)
        if smem > MAX_SMEM_BYTES:
            continue
        ctas = min(SM_SMEM_BYTES // (smem + SMEM_RESERVED_PER_CTA), SPREAD_CTAS_PER_SM)
        vol, padded = 1, 1
        for b in dims:
            vol *= b
            padded *= b + 2 * m - 1
        score = (total // vol >= 2 * NUM_SMS, -padded / vol / ctas, dims[-1])
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
