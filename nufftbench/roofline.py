"""The least time the card could take for the spread and the
interpolation of a cell, from its shapes alone.

The count is of the work, whatever implements it: it never reads a plan's
block dims, permutation or tap tables, so a later design that moves work
(a sorted copy of the values, a table of taps) is still divided into the
same bound.

- Bytes: the user's values and the float64 coordinates read once, and the
  oversampled grid written once (the spread) or read once (the
  interpolation), each of ``ntransforms`` transforms.
- Operations: per point, the taps' evaluation as the window's mode defines
  it (D axes of 2M taps), the (2M)^D products of the taps into the tensor
  product weight, and per transform (2M)^D multiply-adds of each scalar of
  the value (two operations each).
- Peaks: NVIDIA H100 SXM at 700 W, NVIDIA's data sheet: 3.35 TB/s of HBM3
  and 67 TFLOP/s, the FP64 tensor cores' rate, the highest at which a
  double sum runs.  A card below 700 W runs slower than these peaks; the
  harness records the card's power limit beside every run.
"""

from __future__ import annotations

import math

from .shapes import Shapes, VALUE_TYPES

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
COORD_BYTES = 8  # the coordinates are float64


def tap_flops(s: Shapes) -> float:
    """Operations of one window tap.  (Backwards) Kaiser-Bessel in
    FastApproximation: Horner on a polynomial of degree M + 3
    (NonuniformFFTs.jl's piecewise_polynomial.jl), M + 3 multiply-adds; in
    Direct mode about 50 (KB: a square root and I0's polynomials) or 30
    (BKB: two exponentials and a division); the Gaussian about 15 (one
    exponential); the B-spline about 2.5 per tap of its de Boor updates."""
    fast = s.evalmode == "FastApproximation"
    if s.kernel in ("KaiserBesselKernel", "BackwardsKaiserBesselKernel"):
        if fast:
            return 2.0 * (s.m + 3)
        return 50.0 if s.kernel == "KaiserBesselKernel" else 30.0
    if s.kernel == "GaussianKernel":
        return 15.0
    if s.kernel == "BSplineKernel":
        return 2.5 * 2 * s.m
    raise ValueError(f"unknown window {s.kernel}")


def _flops(s: Shapes) -> float:
    S = 2 * s.m
    taps = S ** s.ndim
    ncomp = VALUE_TYPES[s.dtype][1]
    per_point = s.ndim * S * tap_flops(s) + taps + s.ntransforms * taps * 2 * ncomp
    return s.num_points * per_point


def _bytes(s: Shapes) -> float:
    values = s.ntransforms * s.num_points * s.value_bytes
    coords = s.ndim * s.num_points * COORD_BYTES
    grid = s.ntransforms * math.prod(s.grid_over) * s.value_bytes
    return values + coords + grid


def spread_work(s: Shapes) -> tuple:
    """(bytes, operations) of the spread of one step's type 1."""
    return _bytes(s), _flops(s)


def interp_work(s: Shapes) -> tuple:
    """(bytes, operations) of the interpolation of one step's type 2: the
    same bytes (the grid read instead of written, the values written
    instead of read) and the same operations."""
    return _bytes(s), _flops(s)


def bound_s(work: tuple) -> tuple:
    """(seconds, 'bytes' or 'operations'): the larger of the two times."""
    nbytes, flops = work
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
