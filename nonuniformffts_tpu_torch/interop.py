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
    phihat_inv: Sequence[np.ndarray],
    index_ranges,
    shape_over,
    cs_poly: Optional[Sequence[np.ndarray]] = None,
    beta: Optional[Sequence[float]] = None,
    peak: Optional[Sequence[float]] = None,
    tau: Optional[Sequence[float]] = None,
    cs_gauss: Optional[Sequence[np.ndarray]] = None,
    cs_poly_lo: Optional[Sequence[np.ndarray]] = None,
    phihat_inv_lo: Optional[Sequence[np.ndarray]] = None,
    m: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    device="cpu",
) -> dict:
    """Port plan fields from a JAX plan of any window.

    ``kind`` is the JAX ``KernelData.kind``; ``m``, the half-support, may
    be left out where ``cs_poly`` or ``cs_gauss`` gives it.  What each
    window carries, per dim:

    - ``'kb'`` / ``'bkb'``: ``beta`` and ``peak``, and ``cs_poly``
      ``(npoly, 2M)`` for FastApproximation (a Direct plan runs without);
    - ``'gaussian'``: ``tau`` and ``cs_gauss`` ``(2M,)``;
    - ``'bspline'``: nothing beyond the shape.

    ``dtype`` is the plan's real dtype.  A JAX double-single plan
    (``precision='double'`` on a 64-bit dtype) stores float32 ``(hi, lo)``
    pairs: pass its ``cs_poly_lo`` and ``phihat_inv_lo`` too, and each pair
    is summed in float64 (about 48 bits of each coefficient).
    ``index_ranges`` may be a real-data plan's, whose halved last axis is
    one range.  Returns ``kernel_data``, ``phihat_inv``, ``index_ranges``,
    ``shape_over`` and ``coefs`` (``None`` without ``cs_poly``).
    """
    if kind not in ("kb", "bkb", "gaussian", "bspline"):
        raise ValueError(f"unknown kernel kind {kind!r}")
    shape_over = tuple(int(n) for n in shape_over)
    ndim = len(shape_over)
    if kind in ("kb", "bkb") and (beta is None or peak is None):
        raise ValueError(f"{kind!r} kernel data needs beta and peak")
    if kind == "gaussian" and (tau is None or cs_gauss is None):
        raise ValueError("Gaussian kernel data needs tau and cs_gauss")
    if m is None:
        if cs_poly is not None:
            m = np.shape(cs_poly[0])[1] // 2
        elif cs_gauss is not None:
            m = len(cs_gauss[0]) // 2
        else:
            raise ValueError("pass m: no cs_poly or cs_gauss gives it")

    def per_dim(x):
        return [None] * ndim if x is None else list(x)

    def tensor(a):
        return None if a is None else torch.tensor(
            np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    kernel_data = []
    for d, n in enumerate(shape_over):
        cs = None
        if cs_poly is not None:
            cs = _hi_plus_lo(cs_poly[d], per_dim(cs_poly_lo)[d])
            if cs.shape[1] != 2 * m:
                raise ValueError(f"cs_poly[{d}] has {cs.shape[1]} taps, not 2m = {2 * m}")
        dx = TWO_PI / n
        kernel_data.append(KernelData(
            kind=kind, m=m, n=n, w=m * dx, dx=dx,
            beta=0.0 if beta is None else float(beta[d]),
            peak=1.0 if peak is None else float(peak[d]),
            tau=0.0 if tau is None else float(tau[d]),
            cs_poly=tensor(cs), cs_gauss=tensor(per_dim(cs_gauss)[d]),
        ))
    kernel_data = tuple(kernel_data)
    return dict(
        kernel_data=kernel_data,
        phihat_inv=tuple(
            torch.tensor(_hi_plus_lo(p, p_lo), dtype=dtype, device=device)
            for p, p_lo in zip(phihat_inv, per_dim(phihat_inv_lo))
        ),
        index_ranges=tuple(
            tuple((int(s), int(l)) for s, l in r) for r in index_ranges
        ),
        shape_over=shape_over,
        coefs=coefficient_stack(kernel_data) if cs_poly is not None else None,
    )
