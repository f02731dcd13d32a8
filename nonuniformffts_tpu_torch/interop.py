"""Carry a JAX plan's precomputed state into the port.

:func:`plan_data_from_numpy` takes the JAX plan's arrays as numpy (kernel
coefficients and shape parameters per dim, ``phihat_inv``, the index ranges
and ``shape_over``) and returns the matching fields of the port's
:class:`~nonuniformffts_tpu_torch.plan.Plan` on a chosen device, so that a
test can check that the port builds the same numbers, or run the port on
exactly the JAX package's coefficients::

    plan = dataclasses.replace(plan, **plan_data_from_numpy(...))
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from .ops.kernels.common import coefficient_stack
from .ops.windows import KernelData

TWO_PI = 2.0 * math.pi


def _hi_plus_lo(hi, lo) -> np.ndarray:
    """A double-single pair summed in float64 (``hi`` alone without ``lo``)."""
    out = np.asarray(hi, dtype=np.float64)
    return out if lo is None else out + np.asarray(lo, dtype=np.float64)


def plan_data_from_numpy(
    *,
    kind: str,
    cs_poly: Sequence[np.ndarray],
    beta: Sequence[float],
    peak: Sequence[float],
    phihat_inv: Sequence[np.ndarray],
    index_ranges,
    shape_over,
    cs_poly_lo: Optional[Sequence[np.ndarray]] = None,
    phihat_inv_lo: Optional[Sequence[np.ndarray]] = None,
    dtype: torch.dtype = torch.float64,
    device="cpu",
) -> dict:
    """Port plan fields from a JAX plan of a (B)KB kernel.

    ``cs_poly[d]`` is ``(npoly, 2M)``; ``dtype`` is the plan's real dtype.
    A JAX double-single plan (``precision='double'`` on a 64-bit dtype)
    stores float32 ``(hi, lo)`` pairs: pass its ``cs_poly_lo`` and
    ``phihat_inv_lo`` too, and each pair is summed in float64 (about 48 bits
    of each coefficient).  ``index_ranges`` may be a real-data plan's, whose
    halved last axis is one range.  Returns ``kernel_data``, ``phihat_inv``,
    ``index_ranges``, ``shape_over`` and ``coefs``.
    """
    if kind not in ("kb", "bkb"):
        raise ValueError(f"plan_data_from_numpy takes (B)KB kernel data, not {kind!r}")
    shape_over = tuple(int(n) for n in shape_over)
    ndim = len(shape_over)
    cs_lo = [None] * ndim if cs_poly_lo is None else list(cs_poly_lo)
    ph_lo = [None] * ndim if phihat_inv_lo is None else list(phihat_inv_lo)
    kernel_data = []
    for n, cs_hi, cs_l, b, pk in zip(shape_over, cs_poly, cs_lo, beta, peak):
        cs = _hi_plus_lo(cs_hi, cs_l)
        m = cs.shape[1] // 2
        dx = TWO_PI / n
        kernel_data.append(KernelData(
            kind=kind, m=m, n=n, beta=float(b), w=m * dx, dx=dx,
            peak=float(pk), cs_poly=torch.tensor(cs, dtype=dtype, device=device),
        ))
    kernel_data = tuple(kernel_data)
    return dict(
        kernel_data=kernel_data,
        phihat_inv=tuple(
            torch.tensor(_hi_plus_lo(p, p_lo), dtype=dtype, device=device)
            for p, p_lo in zip(phihat_inv, ph_lo)
        ),
        index_ranges=tuple(
            tuple((int(s), int(l)) for s, l in r) for r in index_ranges
        ),
        shape_over=shape_over,
        coefs=coefficient_stack(kernel_data),
    )
