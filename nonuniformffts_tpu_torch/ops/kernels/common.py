"""Shared pieces of the hand-written kernels' Python side: the coefficient
stack they read, the plain version of their tap evaluation, the value types
they are instantiated for, the geometry limits of the card, and the
shared-memory footprint of the spread kernel.

Counterpart of ``nonuniformffts_tpu/ops/pallas/common.py``.  The TPU
kernels placed the 2M taps of each point into dense weight matrices for the
MXU (``build_wt_matrix*``); a Hopper kernel uses the taps directly, so only
the coefficient stack and the tap evaluation (``window_weights`` here,
``csrc/window.cuh`` on the card) carry over.
"""

from __future__ import annotations

import collections
import math
from typing import Sequence, Tuple

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
#: Threads per CTA of the 2D and 3D spread kernels (``csrc/spread_{2,3}d.cu:
#: kThreads``).
SPREAD_THREADS = 512
#: Half-supports M the kernels are instantiated for (``csrc/window.cuh:
#: NUFFT_FOR_EACH_M``); 10 is the JAX package's documented maximum.
KERNEL_M_RANGE = range(2, 11)
#: Dimensions the kernels are instantiated for (``csrc/{spread,interp}_<D>d.cu``).
KERNEL_DIMS = (1, 2, 3)
#: Bytes of one scalar of the spread kernels' sums (``csrc/spread_<D>d.cu:
#: Acc``): double for every value type, since float32 sums of the ~150 terms
#: a cell takes at rho = 1 in 3D cost err1 more than the JAX package's
#: float32 kernels do (ROADMAP queue 3, P2).
ACC_BYTES = 8

#: The kernels' value types by the plan's dtype: the entry-point suffix
#: (``nufft_spread_<D>d_<suffix>``), the bytes of one scalar and the scalars
#: of one value (2 for complex, 1 for real).
VALUE_TYPES = {
    torch.complex64: ("f32", 4, 2),
    torch.complex128: ("f64", 8, 2),
    torch.float32: ("real_f32", 4, 1),
    torch.float64: ("real_f64", 8, 1),
}

#: Registers per thread of each 2D and 3D spread-kernel instantiation (with
#: double accumulators), by (D, scalar bytes, components) and then
#: M = 2..10, as ``ptxas -v`` gave them for sm_90a (CUDA 12.9, PERF.md).
#: One instantiation serves every window.  The 1D kernel has no shared
#: accumulator and its chooser no CTA term, so it has no row.
SPREAD_REGISTERS = {
    (3, 4, 2): (32, 54, 32, 32, 32, 32, 32, 32, 32),
    (3, 8, 2): (40, 58, 40, 40, 40, 40, 40, 40, 40),
    (3, 4, 1): (32, 40, 40, 32, 32, 32, 32, 32, 32),
    (3, 8, 1): (32, 44, 40, 38, 32, 38, 32, 32, 32),
    (2, 4, 2): (32, 53, 40, 57, 40, 40, 31, 38, 38),
    (2, 8, 2): (32, 54, 40, 58, 47, 47, 40, 47, 47),
    (2, 4, 1): (32, 40, 40, 40, 40, 36, 40, 40, 40),
    (2, 8, 1): (32, 40, 36, 49, 44, 44, 32, 40, 40),
}


def entry_point_name(kind: str, ndim: int, dtype: torch.dtype) -> str:
    """``nufft_<kind>_<ndim>d_<suffix>``: the C entry point of the
    ``kind`` ('spread' or 'interp') kernel for ``ndim``-D plans of
    ``dtype``."""
    return f"nufft_{kind}_{ndim}d_{VALUE_TYPES[dtype][0]}"


def spread_ctas_per_sm(scalar_bytes: int, ncomp: int, m: int, ndim: int = 3) -> int:
    """Resident 2D/3D spread CTAs per SM that the register file allows
    (registers go to a warp in multiples of 256, so 8 per thread): K1 runs
    faster with several CTAs resident than with one (PERF.md)."""
    # A plan beyond the instantiated M runs only its plain version, on the
    # CPU; its geometry takes the largest M's row.
    m = min(m, KERNEL_M_RANGE.stop - 1)
    regs = SPREAD_REGISTERS[(ndim, scalar_bytes, ncomp)][m - KERNEL_M_RANGE.start]
    regs = -(-regs // 8) * 8
    return max(SM_REGISTERS // (regs * SPREAD_THREADS), 1)


def spread_bank_conflicts(pd_last: int, m: int, word_bytes: int) -> int:
    """Most lanes of one warp that hit the same shared-memory bank in the 2D
    and 3D spread kernels' tap loop (``csrc/spread_{2,3}d.cu``): lane ``q``
    adds to word ``(q // 2M) * pd_last + q % 2M`` of an accumulator plane of
    ``word_bytes`` words (``ACC_BYTES``), where ``pd_last`` is the padded
    last block dim (lanes over (y, z) tap pairs in 3D, (x, y) pairs in 2D).
    4-byte words serve the 32 lanes from 32 banks; 8-byte words serve each
    half-warp from 16 bank pairs.  Each conflict serialises a
    compare-and-swap loop (PERF.md): K1 ran 3x slower at pd_last = 31 (4
    lanes a bank) than at 23 (2) with float accumulators.  The 1D kernel
    (``csrc/spread_1d.cu``) has no shared accumulator: its lanes read
    consecutive words of a start table, one lane a bank."""
    S = 2 * m
    lanes = 32 if word_bytes == 4 else 16
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


def spread_smem_bytes(block_dims: Sequence[int], m: int, ncoef: int,
                      scalar_bytes: int = 4, ncomp: int = 2) -> int:
    """Dynamic shared memory of one spread CTA for ``D = len(block_dims)``
    (must match ``spread_smem_bytes`` in ``csrc/spread_<D>d.cu``).
    ``ncoef`` is 0 for a window without a coefficient stack (any but (B)KB
    FastApproximation): nothing is staged for it.

    2D and 3D: ``ncomp`` accumulator planes of ``ACC_BYTES`` scalars over
    the padded block, then the ``(D, 2M, ncoef)`` coefficient stack and each
    warp's D x 2M taps of ``scalar_bytes`` each.  1D: the ``(2M, ncoef)``
    coefficients and an int32 start table of B + 1 entries; the sums live
    in registers."""
    D = len(block_dims)
    ntaps = D * 2 * m
    if D == 1:
        return scalar_bytes * ntaps * ncoef + 4 * (int(block_dims[0]) + 1)
    pv = 1
    for p in padded_block_dims(block_dims, m):
        pv *= p
    return ACC_BYTES * ncomp * pv + scalar_bytes * (ntaps * ncoef
                                                    + (SPREAD_THREADS // 32) * ntaps)


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
