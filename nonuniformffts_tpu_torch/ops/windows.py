"""Spreading-window kernels (the math core of the NUFFT), in PyTorch.

Counterpart of ``nonuniformffts_tpu/ops/windows.py`` and of the reference's
``src/Kernels/`` submodule.  The plan-time math (shape parameters, the
piecewise-polynomial solve, Fourier coefficients) is numpy in float64; the
per-point evaluation is vectorised torch over a trailing ``2M`` axis and
runs on whatever device the inputs live on.

Conventions (identical to the reference and the JAX package):

- the domain is the periodic box ``[0, 2pi)^d``;
- a point with cell ``c`` (0-based) spreads onto the ``2M`` grid nodes
  ``c - M + 1 ... c + M`` (periodically wrapped); the value at node
  ``c - M + 1 + t`` is ``phi((M - 1 - t + X) / M)`` with ``X = r - c`` in
  ``[0, 1)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..utils.besseli0 import besseli0

TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# User-facing kernel specifications (static / hashable)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AbstractKernel:
    pass


@dataclasses.dataclass(frozen=True)
class KaiserBesselKernel(AbstractKernel):
    """phi(y) = I0(beta * sqrt(1 - y^2)) for |y| <= 1
    (src/Kernels/kaiser_bessel.jl)."""

    beta: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class BackwardsKaiserBesselKernel(AbstractKernel):
    """phi(y) = sinh(beta * sqrt(1 - y^2)) / (pi * sqrt(1 - y^2)); the default
    kernel (src/Kernels/kaiser_bessel_backwards.jl)."""

    beta: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class GaussianKernel(AbstractKernel):
    """Truncated Gaussian; ``ell`` is the normalised width ``l / dx``
    (src/Kernels/gaussian.jl)."""

    ell: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class BSplineKernel(AbstractKernel):
    """B-spline of order 2M (src/Kernels/bspline.jl)."""


class EvaluationMode:
    pass


@dataclasses.dataclass(frozen=True)
class Direct(EvaluationMode):
    """Evaluate the window from its definition."""


@dataclasses.dataclass(frozen=True)
class FastApproximation(EvaluationMode):
    """Piecewise-polynomial evaluation for (B)KB kernels, fast Gaussian
    gridding for the Gaussian; same as Direct for B-splines."""


# ---------------------------------------------------------------------------
# Per-dimension kernel data
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class KernelData:
    """Window parameters and coefficient tensors for one dimension
    (oversampled grid of size ``n``).

    ``peak ~= phi(0)`` normalises every evaluation path and the Fourier
    coefficients alike, so it cancels in both transform types while keeping
    the f32 pipeline away from overflow (see the JAX package's
    ``KernelData.peak``).  ``cs_poly`` (npoly, 2M) and ``cs_gauss`` (2M,)
    are tensors in the plan's real dtype on the plan's device.
    """

    kind: str  # 'kb' | 'bkb' | 'gaussian' | 'bspline'
    m: int
    n: int
    beta: float = 0.0
    tau: float = 0.0
    w: float = 0.0
    dx: float = 0.0
    peak: float = 1.0
    cs_poly: Optional[torch.Tensor] = None
    cs_gauss: Optional[torch.Tensor] = None


def _optimal_beta_kb(m: int, sigma: float) -> float:
    # src/Kernels/kaiser_bessel.jl:152-166.
    a = m * (2.0 - 1.0 / sigma)
    gamma = math.sqrt(1.0 - 0.8 / a**2)
    return math.pi * a * gamma


def _optimal_beta_bkb(m: int, sigma: float) -> float:
    # src/Kernels/kaiser_bessel_backwards.jl:123-136.
    a = m * (2.0 - 1.0 / sigma)
    gamma = max(0.995, math.sqrt(1.0 - 0.3 / a**2))
    return math.pi * a * gamma


def _optimal_ell_gauss(m: int, sigma: float) -> float:
    # src/Kernels/gaussian.jl:106-115.
    return math.sqrt(sigma * m / ((2.0 * sigma - 1.0) * math.pi))


def _solve_piecewise_polynomial_coefficients(f, m: int, npoly: int) -> np.ndarray:
    """Solve for the (npoly, 2M) piecewise-polynomial coefficient tensor
    (src/Kernels/piecewise_polynomial.jl): on each of the 2M subintervals of
    [-1, 1] the window is fitted at Chebyshev nodes; piece ``t`` evaluated
    at ``z = 2X - 1`` gives the weight of node ``c - M + 1 + t``."""
    L = 2 * m
    i = np.arange(npoly, dtype=np.float64)
    xs = np.cos(np.pi * (i + 0.5) / npoly)
    A = np.vander(xs, npoly, increasing=True)
    cs = np.empty((npoly, L), dtype=np.float64)
    for j in range(1, L + 1):
        h = 1.0 - 2.0 * (j - 0.5) / L
        delta = 1.0 / L
        ys = f(h + xs * delta)
        cs[:, j - 1] = np.linalg.solve(A, ys)
    return cs


def make_kernel_data(
    kernel: AbstractKernel, m: int, n: int, sigma: float,
    dtype: torch.dtype, device,
) -> KernelData:
    """Per-dimension kernel data (reference: Kernels.optimal_kernel).
    ``dtype`` is the plan's real dtype."""
    dx = TWO_PI / n
    w = m * dx
    npoly = m + 4  # polynomial degree npoly - 1 (kaiser_bessel.jl:128)

    def _tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if isinstance(kernel, KaiserBesselKernel):
        from scipy.special import i0 as _i0

        beta = float(kernel.beta if kernel.beta is not None else _optimal_beta_kb(m, sigma))
        peak = float(_i0(beta))  # phi(0); see KernelData.peak
        cs = _solve_piecewise_polynomial_coefficients(
            lambda y: _i0(beta * np.sqrt(np.maximum(1.0 - y**2, 0.0))) / peak,
            m, npoly,
        )
        return KernelData(kind="kb", m=m, n=n, beta=beta, w=w, dx=dx,
                          peak=peak, cs_poly=_tensor(cs))

    if isinstance(kernel, BackwardsKaiserBesselKernel):
        beta = float(kernel.beta if kernel.beta is not None else _optimal_beta_bkb(m, sigma))
        peak = float(math.sinh(beta) / math.pi)  # phi(0)

        def f(y):
            s = np.sqrt(np.maximum(1.0 - y**2, 0.0))
            with np.errstate(divide="ignore", invalid="ignore"):
                v = np.sinh(beta * s) / (s * np.pi)
            return np.where(s == 0.0, beta / np.pi, v) / peak

        cs = _solve_piecewise_polynomial_coefficients(f, m, npoly)
        return KernelData(kind="bkb", m=m, n=n, beta=beta, w=w, dx=dx,
                          peak=peak, cs_poly=_tensor(cs))

    if isinstance(kernel, GaussianKernel):
        alpha = kernel.ell if kernel.ell is not None else _optimal_ell_gauss(m, sigma)
        ell = alpha * dx
        tau = 2.0 * ell**2
        e = np.arange(2 * m, dtype=np.float64) - (m - 1)
        csg = np.exp(-((e * dx) ** 2) / tau)
        return KernelData(kind="gaussian", m=m, n=n, tau=float(tau), w=w,
                          dx=dx, cs_gauss=_tensor(csg))

    if isinstance(kernel, BSplineKernel):
        return KernelData(kind="bspline", m=m, n=n, w=w, dx=dx)
    raise TypeError(f"unknown kernel type: {kernel!r}")


# ---------------------------------------------------------------------------
# Point -> cell mapping
# ---------------------------------------------------------------------------


def point_to_cell_split(x: torch.Tensor, n: int):
    """High-accuracy cell decomposition: raw (possibly unfolded)
    coordinates -> ``(c, X)``, ``c`` the int32 cell in ``[0, N)`` and
    ``X = r - floor(r)`` in ``[0, 1)`` for ``r = x * N / 2pi``, ``X`` in the
    dtype of ``x``.  Folding is the mod-N on the cell.

    The product is taken in float64 for float32 inputs too (the card has
    native FP64).  In float32 the naive ``(x/L)*N`` carries an absolute
    error of ``N * 2^-24`` cells (2.3e-5 at N=384); the JAX package's
    double-single product (a TPU workaround, 12 + 12-bit Veltkamp split)
    still keeps ``N * 2^-36`` (2.3e-5 cells at N = 1,572,864, the 1D main
    path's grid, where it alone put err1 at 1.1e-5).  In float64 the error
    is ``N * 2^-53`` cells, and only ``X`` is rounded to float32.
    """
    r = x.to(torch.float64) * (np.float64(n) / np.float64(TWO_PI))
    i = torch.floor(r)
    X = (r - i).to(x.dtype)
    c = torch.remainder(i.to(torch.int64), n).to(torch.int32)
    return c, X


# ---------------------------------------------------------------------------
# Window evaluation: per-point (..., 2M) value tensors
# ---------------------------------------------------------------------------


def _eval_bkb_direct(kd: KernelData, y: torch.Tensor) -> torch.Tensor:
    """Peak-normalised BKB window with shifted exponents (every intermediate
    <= 1; the s -> 0 limit sinh(bs)/bs -> 1 becomes e^{-beta})."""
    beta = kd.beta
    s = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    bs = beta * s
    sinh_s = 0.5 * (torch.exp(bs - beta) - torch.exp(-bs - beta))
    ratio = torch.where(
        bs == 0.0,
        torch.full_like(bs, math.exp(-beta)),
        sinh_s / torch.where(bs == 0.0, torch.ones_like(bs), bs),
    )
    pref = beta / (-0.5 * math.expm1(-2.0 * beta))
    return ratio * pref


def _eval_kb_direct(kd: KernelData, y: torch.Tensor) -> torch.Tensor:
    s = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    return besseli0(kd.beta * s) * (1.0 / kd.peak)


def bspline_values_list(xp: torch.Tensor, order: int):
    """All ``order`` non-zero B-splines at ``xp in [0, 1]`` by the de Boor
    recurrence (src/Kernels/bspline.jl:143-222), one tensor per node."""
    b = [torch.ones_like(xp)]
    for q in range(2, order + 1):
        alpha = 1.0 / (q - 1)
        deltas = [(xp + j) * alpha for j in range(q - 1)]
        new = [deltas[0] * b[0]]
        for j in range(1, q - 1):
            new.append((1.0 - deltas[j - 1]) * b[j - 1] + deltas[j] * b[j])
        new.append((1.0 - deltas[q - 2]) * b[q - 2])
        b = new
    return b


def _horner_piecewise(cs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """All 2M piecewise polynomials at ``z = 2X - 1`` by one Horner
    recurrence (piecewise_polynomial.jl:76-92); ``cs`` is (npoly, 2M)."""
    cs = cs.to(z.dtype)
    npoly = cs.shape[0]
    zb = z[..., None]
    acc = cs[npoly - 1].expand(z.shape + (cs.shape[1],))
    for q in range(npoly - 2, -1, -1):
        acc = acc * zb + cs[q]
    return acc


def eval_window_frac(kd: KernelData, evalmode: EvaluationMode, X: torch.Tensor):
    """The 2M window values for each in-cell fraction ``X in [0, 1)``:
    shape ``X.shape + (2M,)``; entry ``t`` is the weight of grid node
    ``c - M + 1 + t``."""
    m = kd.m
    t = torch.arange(2 * m, dtype=X.dtype, device=X.device)
    fast = isinstance(evalmode, FastApproximation)

    if kd.kind in ("kb", "bkb"):
        if fast:
            return _horner_piecewise(kd.cs_poly, 2.0 * X - 1.0)
        y = (m - 1.0 - t + X[..., None]) / m
        return _eval_kb_direct(kd, y) if kd.kind == "kb" else _eval_bkb_direct(kd, y)

    if kd.kind == "gaussian":
        if fast:
            # Fast Gaussian gridding (gaussian.jl:125-138, 155-192).
            Xp = X * kd.dx
            a = torch.exp(-(Xp * Xp) / kd.tau)
            e = t - (m - 1.0)
            bpow = torch.exp((2.0 * Xp * kd.dx / kd.tau)[..., None] * e)
            return a[..., None] * kd.cs_gauss.to(X.dtype) * bpow
        yphys = (m - 1.0 - t + X[..., None]) * kd.dx
        return torch.exp(-(yphys * yphys) / kd.tau)

    if kd.kind == "bspline":
        return torch.stack(bspline_values_list(1.0 - X, 2 * m), dim=-1)

    raise ValueError(f"unknown kernel kind {kd.kind}")


# ---------------------------------------------------------------------------
# The window as the CUDA kernels read it
# ---------------------------------------------------------------------------

#: The kernels' tap evaluators (``csrc/window.cuh:WindowKind``): Horner on
#: the piecewise-polynomial coefficients for (B)KB FastApproximation, the
#: direct (B)KB formulas, one exp per node for the Gaussian in both modes,
#: de Boor for the B-spline in both modes.
WINDOW_KINDS = {"horner": 0, "kb_direct": 1, "bkb_direct": 2, "gaussian": 3,
                "bspline": 4}


def window_evaluator(kd: KernelData, evalmode: EvaluationMode) -> str:
    """The key of ``WINDOW_KINDS`` that evaluates ``kd`` in ``evalmode``."""
    if kd.kind in ("kb", "bkb"):
        return "horner" if isinstance(evalmode, FastApproximation) else f"{kd.kind}_direct"
    if kd.kind in ("gaussian", "bspline"):
        return kd.kind
    raise ValueError(f"unknown kernel kind {kd.kind}")


@dataclasses.dataclass(frozen=True)
class WindowPack:
    """The per-dimension scalars of a plan's window that the window-weights
    kernel reads (``csrc/window.cuh:WindowParams``), as Python floats; it
    rounds them to its scalar type.  ``kind`` indexes ``WINDOW_KINDS``."""

    kind: int
    beta: tuple
    inv_peak: tuple
    pref: tuple  # BKB Direct: beta / (-expm1(-2 beta) / 2)
    exp_mbeta: tuple  # BKB Direct: e^-beta, the value at beta s == 0
    inv_tau: tuple  # Gaussian
    dx: tuple


def window_pack(kernel_data, evalmode: EvaluationMode) -> WindowPack:
    """The window scalars of every dimension of a plan (all dims share one
    kernel family and mode)."""
    kinds = {window_evaluator(kd, evalmode) for kd in kernel_data}
    if len(kinds) != 1:
        raise ValueError(f"dimensions disagree on the window: {sorted(kinds)}")
    bkb = [kd.kind == "bkb" for kd in kernel_data]
    return WindowPack(
        kind=WINDOW_KINDS[kinds.pop()],
        beta=tuple(float(kd.beta) for kd in kernel_data),
        inv_peak=tuple(1.0 / kd.peak for kd in kernel_data),
        pref=tuple(kd.beta / (-0.5 * math.expm1(-2.0 * kd.beta)) if b else 0.0
                   for kd, b in zip(kernel_data, bkb)),
        exp_mbeta=tuple(math.exp(-kd.beta) if b else 0.0
                        for kd, b in zip(kernel_data, bkb)),
        inv_tau=tuple(1.0 / kd.tau if kd.tau else 0.0 for kd in kernel_data),
        dx=tuple(float(kd.dx) for kd in kernel_data),
    )


# ---------------------------------------------------------------------------
# Fourier coefficients phi_hat(k)
# ---------------------------------------------------------------------------


def fourier_coefficients_np(kd: KernelData, k: np.ndarray) -> np.ndarray:
    """phi_hat at wavenumbers ``k`` (host-side, float64; plan time only),
    divided by the same ``kd.peak`` the evaluators use."""
    k = np.asarray(k, dtype=np.float64)
    if kd.kind == "kb":
        q = kd.w * k
        s = np.sqrt(np.maximum(kd.beta**2 - q**2, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            v = 2.0 * kd.w * np.sinh(s) / s
        return np.where(s == 0.0, 2.0 * kd.w, v) / kd.peak
    if kd.kind == "bkb":
        from scipy.special import i0 as _i0

        q = kd.w * k
        s = np.sqrt(np.maximum(kd.beta**2 - q**2, 0.0))
        return kd.w * _i0(s) / kd.peak
    if kd.kind == "gaussian":
        return np.sqrt(np.pi * kd.tau) * np.exp(-kd.tau * k**2 / 4.0)
    if kd.kind == "bspline":
        kh = k * kd.dx / 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            s = np.sin(kh) / kh
        s = np.where(k == 0.0, 1.0, s)
        return kd.dx * s ** (2 * kd.m)
    raise ValueError(kd.kind)
