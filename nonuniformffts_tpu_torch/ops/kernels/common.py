"""Shared pieces of the hand-written kernels' Python side: the coefficient
stack they read, the geometry limits of the card, and the shared-memory
footprint of the spread kernel.

Counterpart of ``nonuniformffts_tpu/ops/pallas/common.py``.  The TPU
kernels placed the 2M taps of each point into dense weight matrices for the
MXU (``build_wt_matrix*``); a Hopper kernel uses the taps directly, so only
the coefficient stack and the tap evaluation (``csrc/window.cuh``) carry over.
"""

from __future__ import annotations

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
#: Resident spread CTAs per SM worth having: at 40 registers a thread
#: (ptxas, M = 4) three 512-thread CTAs fill the register file, and K1
#: measured no faster at four CTAs' worth of shared memory than at three
#: (PERF.md, PR 1).
SPREAD_CTAS_PER_SM = 3
#: Threads per CTA of the spread kernel (``csrc/spread_3d.cu:kThreads``).
SPREAD_THREADS = 512
#: Half-supports M the kernels are instantiated for (``csrc/*.cu``).
KERNEL_M_RANGE = range(2, 9)


def coefficient_stack(kernel_data: Sequence[KernelData]) -> torch.Tensor:
    """The per-dim piecewise-polynomial coefficients as one contiguous
    ``(D, 2M, ncoef)`` tensor, TAP-MAJOR: coefficient ``q`` of tap ``t`` sits
    at ``[d, t, q]``, so a kernel's Horner loop for one tap reads ``ncoef``
    consecutive floats.  Only (B)KB kernels have one.
    """
    if any(kd.cs_poly is None for kd in kernel_data):
        raise ValueError("coefficient_stack needs (B)KB kernel data")
    return torch.stack([kd.cs_poly.T for kd in kernel_data]).contiguous()


def padded_block_dims(block_dims: Sequence[int], m: int) -> Tuple[int, ...]:
    """Per-dim padded block sizes ``B + 2M - 1``: the block's cells plus the
    halo its points' windows reach."""
    return tuple(int(b) + 2 * m - 1 for b in block_dims)


def spread_smem_bytes(block_dims: Sequence[int], m: int, ncoef: int) -> int:
    """Dynamic shared memory of one spread CTA: the re and im accumulator
    planes over the padded block, the coefficient stack, and each warp's
    3 x 2M taps (must match ``csrc/spread_3d.cu:spread_smem_bytes``)."""
    pv = 1
    for p in padded_block_dims(block_dims, m):
        pv *= p
    ntaps = 3 * 2 * m
    return 4 * (2 * pv + ntaps * ncoef + (SPREAD_THREADS // 32) * ntaps)
