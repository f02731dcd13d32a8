"""NFFT-ecosystem compatibility adapter.

Counterpart of ``nonuniformffts_tpu/nfft_compat.py`` (and of the reference's
AbstractNFFTs.jl interface layer, src/abstractNFFTs.jl:115-245): an
operator-style plan speaking the NFFT convention rather than ours, so users
of NFFT-style libraries can switch without touching their math:

- points live in ``[-1/2, 1/2)^d`` (ours: ``[0, 2pi)^d``);
- opposite sign convention: the NFFT *forward* transform computes
  ``f_j = sum_k fhat[k] e^{-2pi i k.x_j}`` and the *adjoint* computes
  ``fhat[k] = sum_j f_j e^{+2pi i k.x_j}``, realised by wrapping a
  :class:`~nonuniformffts_tpu_torch.plan.Plan` whose ``point_transform``
  maps ``x -> -2pi x`` before the cell split (reference:
  src/abstractNFFTs.jl:150-158 ``_transform_point_convention``);
- frequencies in *increasing* order, ``k = -N/2 .. N/2-1`` per axis
  (``fftshift=True``; reference default at src/abstractNFFTs.jl:219-225);
- accuracy requested as a relative tolerance ``reltol`` and mapped to
  ``(m, sigma)`` by :func:`accuracy_params`.

Plans run on the card (the blocked method and its CUDA kernels, every
window) unless ``device='cpu'`` is passed.  ``forward`` / ``adjoint``
return tensors on the plan's device; ``with_nodes`` returns a new plan.
The JAX adapter's switch of complex128 plans to ``precision='double'`` on a
TPU (its double-single pipeline) has no counterpart: the card runs native
float64.
"""

from __future__ import annotations

import copy
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .execution import exec_type1, exec_type2
from .ops.windows import (
    BackwardsKaiserBesselKernel,
    BSplineKernel,
    GaussianKernel,
    KaiserBesselKernel,
)
from .plan import TWO_PI, PlanNUFFT, set_points

#: Window-name map, mirroring the symbol names accepted by the NFFT
#: ecosystem (reference: src/abstractNFFTs.jl window symbol handling).
WINDOWS = {
    "kaiser_bessel": KaiserBesselKernel,
    "kaiser_bessel_rev": BackwardsKaiserBesselKernel,
    "backwards_kaiser_bessel": BackwardsKaiserBesselKernel,
    "gauss": GaussianKernel,
    "gaussian": GaussianKernel,
    "spline": BSplineKernel,
    "bspline": BSplineKernel,
}


_COMPLEX = {np.dtype(np.complex64): torch.complex64,
            np.dtype(np.complex128): torch.complex128}


def accuracy_params(
    reltol: float, *, f32: bool = False, precision: Optional[str] = None
) -> Tuple[int, float]:
    """Map a requested relative tolerance to ``(m, sigma)``.

    The JAX adapter's mapping, kept as it is so that both packages choose
    the same ``(m, sigma)`` for the same request: sigma = 2 and the
    (backwards) Kaiser-Bessel error model ``~6 x 10^(-1.9 m)`` of
    ``tests/test_accuracy.py:error_budget``, with ``m`` clamped to 2..10
    and the tolerance to a floor of 2.5e-7 for complex64 plans, 5e-12 for
    ``precision='double'`` and 4e-14 otherwise.  Those floors were set for
    the JAX package; what the card reaches at the adapter's default point
    is measured by ``chip_smoke.py`` phase 12 (PERF.md).
    """
    if not 0.0 < reltol < 1.0:
        raise ValueError(f"reltol must be in (0, 1), got {reltol}")
    sigma = 2.0
    if f32:
        floor = 2.5e-7
    elif precision == "double":
        floor = 5e-12
    else:
        floor = 4e-14
    target = max(float(reltol), floor)
    m = math.ceil(math.log10(6.0 / target) / 1.9)
    m = min(max(m, 2), 10)
    return m, sigma


def _transform_point_convention(x):
    """[-1/2, 1/2) NFFT coordinates -> our convention: t = -2pi x, folded to
    [0, 2pi) by set_points (the sign flip realises the opposite transform
    sign; reference: src/abstractNFFTs.jl:150-158)."""
    return -TWO_PI * x


class NFFTPlan:
    """Operator-style NFFT plan (counterpart of the reference's ``NFFTPlan``
    wrapper, src/abstractNFFTs.jl:115-145).

    Parameters
    ----------
    x : array or tensor
        Non-uniform nodes in ``[-1/2, 1/2)^d``; shape ``(d, Np)`` (or
        anything :func:`set_points` accepts).
    N : tuple of int
        Uniform grid dimensions.
    reltol : float
        Requested relative accuracy; mapped to ``(m, sigma)`` via
        :func:`accuracy_params` unless ``m`` and ``sigma`` are given.
    window : str
        Window name (see :data:`WINDOWS`).
    dtype : complex64 or complex128
    device : the card (``None``, the default) or ``'cpu'``.
    ntransforms, ... forwarded to :func:`PlanNUFFT`.
    """

    def __init__(
        self,
        x,
        N,
        *,
        reltol: float = 1e-9,
        m: Optional[int] = None,
        sigma: Optional[float] = None,
        window: str = "kaiser_bessel",
        dtype=np.complex128,
        ntransforms: int = 1,
        device=None,
        **plan_kw,
    ):
        if isinstance(N, int):
            N = (N,)
        N = tuple(int(n) for n in N)
        if not isinstance(dtype, torch.dtype):
            dtype = _COMPLEX.get(np.dtype(dtype), np.dtype(dtype))
        if dtype not in (torch.complex64, torch.complex128):
            raise TypeError(f"NFFT-convention plans are complex transforms, got {dtype}")
        f32 = dtype == torch.complex64
        m_auto, sigma_auto = accuracy_params(
            reltol, f32=f32, precision=plan_kw.get("precision")
        )
        try:
            kernel_cls = WINDOWS[window]
        except KeyError:
            raise ValueError(
                f"unknown window {window!r}; available: {sorted(set(WINDOWS))}"
            ) from None

        self.N = N
        self.reltol = float(reltol)
        self._plan = PlanNUFFT(
            dtype,
            N,
            m=int(m_auto if m is None else m),
            sigma=float(sigma_auto if sigma is None else sigma),
            kernel=kernel_cls(),
            ntransforms=ntransforms,
            fftshift=True,  # increasing frequency order, NFFT convention
            point_transform=_transform_point_convention,
            device=device,
            **plan_kw,
        )
        self._plan = set_points(self._plan, x)

    # -- geometry ---------------------------------------------------------
    @property
    def size_in(self) -> Tuple[int, ...]:
        """Shape of the frequency-domain input of ``forward`` (= N)."""
        return self.N

    @property
    def size_out(self) -> Tuple[int, ...]:
        """Shape of the node-domain output of ``forward`` (= (Np,))."""
        return (self._plan.num_points,)

    @property
    def num_nodes(self) -> int:
        return self._plan.num_points

    @property
    def plan(self):
        """The wrapped native :class:`Plan` (our convention)."""
        return self._plan

    def with_nodes(self, x) -> "NFFTPlan":
        """Return a new plan with updated nodes (reference ``nodes!``,
        src/abstractNFFTs.jl:163-171, made functional)."""
        out = copy.copy(self)
        out._plan = set_points(self._plan, x)
        return out

    # -- transforms ---------------------------------------------------------
    def _as_input(self, a) -> torch.Tensor:
        dt = self._plan.complex_dtype
        if isinstance(a, torch.Tensor):
            return a.to(device=self._plan.device, dtype=dt)
        return torch.as_tensor(np.asarray(a), device=self._plan.device).to(dt)

    def forward(self, fhat) -> torch.Tensor:
        """``f_j = sum_k fhat[k] e^{-2pi i k.x_j}`` (NFFT trafo; our type 2
        through the sign-flipping point transform)."""
        return exec_type2(self._plan, self._as_input(fhat))

    def adjoint(self, f) -> torch.Tensor:
        """``fhat[k] = sum_j f_j e^{+2pi i k.x_j}`` (NFFT adjoint; our
        type 1)."""
        return exec_type1(self._plan, self._as_input(f))

    # Operator sugar: plan @ fhat == forward; plan.H @ f == adjoint.
    def __matmul__(self, fhat):
        return self.forward(fhat)

    @property
    def H(self) -> "_AdjointNFFTPlan":
        return _AdjointNFFTPlan(self)

    def __repr__(self):
        return (
            f"NFFTPlan(N={self.N}, nodes={self._plan.num_points}, "
            f"reltol={self.reltol:g}, m={self._plan.m}, "
            f"sigma={self._plan.sigma:g}, device={self._plan.device})"
        )


class _AdjointNFFTPlan:
    """Lazy adjoint operator (``plan.H``), mirroring the reference's
    ``mul!(fhat, adjoint(p), f)`` path (src/abstractNFFTs.jl:138-145)."""

    def __init__(self, parent: NFFTPlan):
        self.parent = parent

    def __matmul__(self, f):
        return self.parent.adjoint(f)

    @property
    def H(self) -> NFFTPlan:
        return self.parent


def plan_nfft(x, N, **kw) -> NFFTPlan:
    """Convenience constructor (reference: ``plan_nfft``,
    src/abstractNFFTs.jl:238-245)."""
    return NFFTPlan(x, N, **kw)


def nfft(x, fhat, **kw) -> torch.Tensor:
    """One-shot forward NFFT at nodes ``x`` of the frequency data ``fhat``."""
    dtype = fhat.dtype if isinstance(fhat, torch.Tensor) else np.asarray(fhat).dtype
    return NFFTPlan(x, tuple(fhat.shape), dtype=dtype, **kw).forward(fhat)


def nfft_adjoint(x, f, N, **kw) -> torch.Tensor:
    """One-shot adjoint NFFT of node values ``f`` onto an ``N`` grid."""
    dtype = f.dtype if isinstance(f, torch.Tensor) else np.asarray(f).dtype
    return NFFTPlan(x, N, dtype=dtype, **kw).adjoint(f)
