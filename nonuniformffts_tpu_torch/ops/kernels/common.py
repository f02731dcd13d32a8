"""Shared pieces of the hand-written kernels' Python side: the coefficient
stack they read, the value types they are instantiated for, the geometry
limits of the card, and the shared-memory footprint of the spread kernel.

Counterpart of ``nonuniformffts_tpu/ops/pallas/common.py``.  The TPU
kernels placed the 2M taps of each point into dense weight matrices for the
MXU (``build_wt_matrix*``); a Hopper kernel uses the taps directly, so only
the coefficient stack and the tap evaluation (``csrc/window.cuh``) carry over.
"""

from __future__ import annotations

import collections
from typing import Sequence, Tuple

import torch

from ..windows import KernelData

#: Streaming multiprocessors of an H100 SXM.
NUM_SMS = 132
#: Dynamic shared memory one CTA may opt in to on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448
#: Shared memory of one SM (228 KB), of which the system keeps 1 KB per CTA.
SM_SMEM_BYTES = 233_472
SMEM_RESERVED_PER_CTA = 1024
#: Registers of one SM.
SM_REGISTERS = 65_536
#: Threads per CTA of the spread kernel (``csrc/spread_3d.cu:kThreads``).
SPREAD_THREADS = 512
#: Half-supports M the kernels are instantiated for (``csrc/*.cu``).
KERNEL_M_RANGE = range(2, 9)

#: The kernels' value types by the plan's dtype: the entry-point suffix
#: (``nufft_spread_3d_<suffix>``), the bytes of one scalar and the scalars
#: of one value (2 for complex, 1 for real).
VALUE_TYPES = {
    torch.complex64: ("f32", 4, 2),
    torch.complex128: ("f64", 8, 2),
    torch.float32: ("real_f32", 4, 1),
    torch.float64: ("real_f64", 8, 1),
}

#: Registers per thread of each spread-kernel instantiation, by (scalar
#: bytes, components) and then M = 2..8, as ``ptxas -v`` gave them for
#: sm_90a (CUDA 12.9, PERF.md).
SPREAD_REGISTERS = {
    (4, 2): (40, 55, 40, 32, 32, 32, 32),
    (8, 2): (40, 58, 40, 40, 40, 40, 40),
    (4, 1): (32, 40, 40, 32, 32, 32, 32),
    (8, 1): (32, 48, 40, 38, 32, 32, 32),
}


def spread_ctas_per_sm(scalar_bytes: int, ncomp: int, m: int) -> int:
    """Resident spread CTAs per SM that the register file allows (registers
    go to a warp in multiples of 256, so 8 per thread): K1 runs faster with
    several CTAs resident than with one (PERF.md)."""
    regs = SPREAD_REGISTERS[(scalar_bytes, ncomp)][m - KERNEL_M_RANGE.start]
    regs = -(-regs // 8) * 8
    return max(SM_REGISTERS // (regs * SPREAD_THREADS), 1)


def spread_bank_conflicts(pd_last: int, m: int, scalar_bytes: int) -> int:
    """Most lanes of one warp that hit the same shared-memory bank in the
    spread kernel's tap loop (``csrc/spread_3d.cu``): lane ``q`` adds to
    word ``(q // 2M) * pd_last + q % 2M`` of an accumulator plane, where
    ``pd_last`` is the padded last block dim.  4-byte words serve the 32
    lanes from 32 banks; 8-byte words serve each half-warp from 16 bank
    pairs.  Each conflict serialises a compare-and-swap loop (PERF.md):
    K1 ran 3x slower at pd_last = 31 (4 lanes a bank) than at 23 (2)."""
    S = 2 * m
    lanes = 32 if scalar_bytes == 4 else 16
    worst = 1
    for start in range(0, S * S, lanes):
        counts = collections.Counter(
            ((q // S) * pd_last + q % S) % lanes
            for q in range(start, min(start + lanes, S * S))
        )
        worst = max(worst, max(counts.values()))
    return worst


def coefficient_stack(kernel_data: Sequence[KernelData]) -> torch.Tensor:
    """The per-dim piecewise-polynomial coefficients as one contiguous
    ``(D, 2M, ncoef)`` tensor in the plan's real dtype, TAP-MAJOR:
    coefficient ``q`` of tap ``t`` sits at ``[d, t, q]``, so a kernel's
    Horner loop for one tap reads ``ncoef`` consecutive scalars.  Only (B)KB
    kernels have one.
    """
    if any(kd.cs_poly is None for kd in kernel_data):
        raise ValueError("coefficient_stack needs (B)KB kernel data")
    return torch.stack([kd.cs_poly.T for kd in kernel_data]).contiguous()


def padded_block_dims(block_dims: Sequence[int], m: int) -> Tuple[int, ...]:
    """Per-dim padded block sizes ``B + 2M - 1``: the block's cells plus the
    halo its points' windows reach."""
    return tuple(int(b) + 2 * m - 1 for b in block_dims)


def spread_smem_bytes(block_dims: Sequence[int], m: int, ncoef: int,
                      scalar_bytes: int = 4, ncomp: int = 2) -> int:
    """Dynamic shared memory of one spread CTA: ``ncomp`` accumulator planes
    over the padded block, the coefficient stack, and each warp's 3 x 2M
    taps, all of ``scalar_bytes`` each (must match
    ``csrc/spread_3d.cu:spread_smem_bytes``)."""
    pv = 1
    for p in padded_block_dims(block_dims, m):
        pv *= p
    ntaps = 3 * 2 * m
    return scalar_bytes * (ncomp * pv + ntaps * ncoef + (SPREAD_THREADS // 32) * ntaps)
