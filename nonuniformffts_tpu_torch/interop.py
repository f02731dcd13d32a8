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
from typing import Sequence

import numpy as np
import torch

from .ops.kernels.common import coefficient_stack
from .ops.windows import KernelData

TWO_PI = 2.0 * math.pi


def plan_data_from_numpy(
    *,
    kind: str,
    cs_poly: Sequence[np.ndarray],
    beta: Sequence[float],
    peak: Sequence[float],
    phihat_inv: Sequence[np.ndarray],
    index_ranges,
    shape_over,
    dtype: torch.dtype = torch.float64,
    device="cpu",
) -> dict:
    """Port plan fields from a JAX plan of a (B)KB kernel.

    ``cs_poly[d]`` is ``(npoly, 2M)``; ``dtype`` is the plan's real dtype.
    Returns ``kernel_data``, ``phihat_inv``, ``index_ranges``,
    ``shape_over`` and ``coefs``.
    """
    if kind not in ("kb", "bkb"):
        raise ValueError(f"plan_data_from_numpy takes (B)KB kernel data, not {kind!r}")
    shape_over = tuple(int(n) for n in shape_over)
    kernel_data = []
    for n, cs, b, pk in zip(shape_over, cs_poly, beta, peak):
        cs = np.asarray(cs, dtype=np.float64)
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
            torch.tensor(np.asarray(p, np.float64), dtype=dtype, device=device)
            for p in phihat_inv
        ),
        index_ranges=tuple(
            tuple((int(s), int(l)) for s, l in r) for r in index_ranges
        ),
        shape_over=shape_over,
        coefs=coefficient_stack(kernel_data),
    )
