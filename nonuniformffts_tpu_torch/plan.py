"""NUFFT plans: transform configuration plus precomputed device tensors.

Counterpart of ``nonuniformffts_tpu/plan.py`` (and of the reference's
``PlanNUFFT``, src/plan.jl).  A plan is a frozen dataclass; ``set_points``
returns a new plan holding the point state (folded points on the
reference path; bin-sorted cells, fractions, permutation and per-block
ranges on the blocked path).  The plan's tensors live on ``plan.device``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .blocking import bin_sort, cells_and_fracs, choose_geometry
from .ops import deconvolve, windows
from .ops.kernels.blocked import check_kernel_support
from .ops.kernels.common import VALUE_TYPES, coefficient_stack
from .ops.windows import (
    WINDOW_KINDS,
    AbstractKernel,
    BackwardsKaiserBesselKernel,
    EvaluationMode,
    FastApproximation,
    KernelData,
    WindowPack,
    window_pack,
)
from .utils.misc import next_fast_len

TWO_PI = 2.0 * math.pi

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_REAL_OF = {
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
    torch.float32: torch.float32,
    torch.float64: torch.float64,
}
_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _identity(x):
    return x


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """See :func:`PlanNUFFT` for the user-facing constructor."""

    dtype: torch.dtype  # dtype of the non-uniform data (real: r2c/c2r)
    shape: Tuple[int, ...]  # output (non-oversampled) dims
    shape_over: Tuple[int, ...]  # oversampled grid dims
    m: int
    sigma: float  # actual oversampling factor (max over dims)
    kernel: AbstractKernel
    evalmode: EvaluationMode
    ntransforms: int
    fftshift: bool
    spread_method: str  # 'reference' | 'blocked'
    device: torch.device
    block_dims: Optional[Tuple[int, ...]] = None
    sort_points: bool = False
    point_transform: Callable = _identity
    chunk_size: Optional[int] = None

    # --- precomputed tensors --------------------------------------------
    kernel_data: Tuple[KernelData, ...] = ()
    phihat_inv: Tuple[torch.Tensor, ...] = ()  # 1/phi_hat per dim
    index_ranges: Tuple = ()  # per-dim (src_start, length) ranges
    coefs: Optional[torch.Tensor] = None  # (D, 2M, ncoef), (B)KB kernels

    # --- point state (set by set_points) --------------------------------
    points: Optional[torch.Tensor] = None  # (D, Np) folded, reference path
    point_perm: Optional[torch.Tensor] = None  # sort_points, reference path
    point_perm_inv: Optional[torch.Tensor] = None
    cells_sorted: Optional[torch.Tensor] = None  # (D, Np) int32, blocked
    fracs_sorted: Optional[torch.Tensor] = None  # (D, Np), blocked
    sort_perm: Optional[torch.Tensor] = None  # (Np,) int64, blocked
    pstarts: Optional[torch.Tensor] = None  # (nblocks + 1,) int32, blocked
    num_points_static: Optional[int] = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_real(self) -> bool:
        return not self.dtype.is_complex

    @property
    def real_dtype(self) -> torch.dtype:
        return _REAL_OF[self.dtype]

    @property
    def complex_dtype(self) -> torch.dtype:
        """dtype of the uniform (Fourier) data."""
        return _COMPLEX_OF[self.dtype] if self.is_real else self.dtype

    @property
    def spectral_shape(self) -> Tuple[int, ...]:
        """Dimensions of the uniform (Fourier) data; real-data plans halve
        the LAST axis to ``n // 2 + 1`` (rfft layout, positive Nyquist)."""
        if self.is_real:
            return self.shape[:-1] + (self.shape[-1] // 2 + 1,)
        return self.shape

    @property
    def spectral_shape_over(self) -> Tuple[int, ...]:
        """The oversampled spectrum: ``shape_over`` with the last axis
        halved to ``n_over // 2 + 1`` on real-data plans."""
        if self.is_real:
            return self.shape_over[:-1] + (self.shape_over[-1] // 2 + 1,)
        return self.shape_over

    @property
    def window(self) -> WindowPack:
        """The window's scalars as the CUDA kernels read them."""
        return window_pack(self.kernel_data, self.evalmode)

    @property
    def num_points(self) -> Optional[int]:
        if self.num_points_static is not None:
            return self.num_points_static
        return None if self.points is None else self.points.shape[1]

    @property
    def normfactor(self) -> float:
        """FFT normalisation ``prod(2pi / N~)`` (NonuniformFFTs.jl:181)."""
        out = 1.0
        for n in self.shape_over:
            out *= TWO_PI / n
        return out


def _check_nufft_size(n_over: int, m: int):
    if n_over < 2 * m:
        raise ValueError(
            f"data size is too small: sigma*N = {n_over} < {2 * m} = 2M. Try "
            "increasing N or sigma, or decreasing the kernel half-support M."
        )


def _resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        if dtype in _DTYPES.values():
            return dtype
        raise TypeError(f"unsupported non-uniform data dtype {dtype}")
    dt = np.dtype(dtype)
    if dt not in _DTYPES:
        raise TypeError(f"unsupported non-uniform data dtype {dt}")
    return _DTYPES[dt]


def resolve_device(device) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device on a host without CUDA raises.
    The CPU runs only when the caller asks for it (``device='cpu'``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device (torch.cuda.is_available() is False); pass "
                "device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def PlanNUFFT(
    dtype,
    shape,
    *,
    m: int = 4,
    sigma: float = 2.0,
    kernel: AbstractKernel = None,
    kernel_evalmode: EvaluationMode = None,
    ntransforms: int = 1,
    fftshift: bool = False,
    spread_method: str = "auto",
    block_dims=None,
    sort_points: bool = False,
    point_transform: Callable = _identity,
    chunk_size: Optional[int] = None,
    device=None,
    # Accepted so that call sites match the JAX package; none of these has
    # an effect in the port (README "PyTorch / CUDA port").
    batch_size="auto",
    interpret: bool = False,
    fft_method: Optional[str] = None,
    fft_variant: str = "auto",
    precision: str = "highest",
    kernel_precision: Optional[str] = None,
    np_hint: Optional[int] = None,
    window_rows: Optional[int] = "auto",
    window_rows_y: Optional[int] = "auto",
    layout: str = "packed",
    dma_super: int = 4,
    spread_acc2: bool = False,
    value_permute: str = "auto",
    dft_fold: bool = True,
    timer: Any = None,
) -> Plan:
    """Construct a NUFFT plan (counterpart of ``PlanNUFFT`` in src/plan.jl
    and in the JAX package).

    ``dtype`` is the non-uniform data type (numpy or torch dtype: complex64,
    complex128, or float32 / float64 for real-data r2c/c2r plans, whose
    spectrum halves the last axis), ``shape`` the uniform grid dimensions,
    ``m`` the kernel half-support, ``sigma`` the oversampling factor, ``kernel`` one of the four windows
    (default backwards Kaiser-Bessel), ``ntransforms`` the number of
    simultaneous transforms over shared points, ``fftshift`` the frequency
    order.  ``device`` defaults to ``cuda`` and raises without a card; the CPU
    runs only with ``device='cpu'``.  64-bit plans run native float64
    everywhere, whatever ``precision`` says (the JAX package's
    double-single mode, ``precision='double'``, is a TPU workaround).

    ``spread_method``: ``'reference'`` is the plain torch scatter/gather
    path; ``'blocked'`` bin-sorts the points and runs the hand-written CUDA
    kernels on a CUDA device (their plain versions on the CPU); ``'auto'``
    is ``'blocked'`` on CUDA and ``'reference'`` on the CPU.
    """
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(n) for n in shape)
    D = len(shape)
    if not 1 <= D <= 3:
        raise ValueError(f"only 1-3 dimensions supported, got {D}")
    tdtype = _resolve_dtype(dtype)

    is_real = not tdtype.is_complex

    # Oversampled dims: next 5-smooth integer >= sigma*N; a real-data plan's
    # halved (last) axis is forced even (the JAX package's plan.py:427-435).
    shape_over = []
    for d, n in enumerate(shape):
        if is_real and d == D - 1:
            n_over = 2 * next_fast_len(int(math.floor(sigma * ((n + 1) // 2))))
        else:
            n_over = next_fast_len(int(math.floor(sigma * n)))
        _check_nufft_size(n_over, m)
        shape_over.append(n_over)
    shape_over = tuple(shape_over)
    sigma_actual = max(no / n for no, n in zip(shape_over, shape))

    dev = resolve_device(device)
    if timer is not None:
        raise NotImplementedError(
            "the staged timer is not ported yet (ROADMAP queue 1, item 5)"
        )
    if kernel is None:
        kernel = BackwardsKaiserBesselKernel()
    if kernel_evalmode is None:
        kernel_evalmode = FastApproximation()

    if spread_method == "auto":
        spread_method = "blocked" if dev.type == "cuda" else "reference"
    if spread_method not in ("reference", "blocked", "direct"):
        raise ValueError(f"unknown spread_method {spread_method!r}")
    if spread_method == "direct":
        raise NotImplementedError(
            "the direct NUDFT is not ported yet (ROADMAP queue 1, item 8)"
        )
    if precision not in ("default", "high", "highest", "double"):
        raise ValueError(f"unknown precision {precision!r}")
    # In the JAX package precision='double' on a 64-bit dtype selects the
    # double-single pipeline (its plan.py:412-462): float64 emulated as
    # (hi, lo) float32 pairs, which forces FastApproximation, m <= 8, the
    # pruned matmul DFT, the packed layout and dma_super=1.  The card has
    # native FP64, so none of those limits carries over and 'double' changes
    # nothing here: every 64-bit plan runs float64 throughout.
    if kernel_precision not in (None, "default", "high", "highest", "double", "fxp"):
        raise ValueError(f"unknown kernel_precision {kernel_precision!r}")
    if value_permute not in ("auto", "gather", "sort"):
        raise ValueError(f"unknown value_permute {value_permute!r}")

    real_dtype = _REAL_OF[tdtype]
    kernel_data = tuple(
        windows.make_kernel_data(kernel, m, n_over, n_over / n, real_dtype, dev)
        for n, n_over in zip(shape, shape_over)
    )
    # Per-dim 1/phi_hat and slice ranges; the halved r2c axis holds
    # k = 0 .. n/2 in order (no fftshift) from an n_over // 2 + 1 spectrum.
    phinv, iranges = [], []
    for d, (n, n_over, kd) in enumerate(zip(shape, shape_over, kernel_data)):
        r2c = is_real and d == D - 1
        shift = fftshift and not r2c
        k = deconvolve.output_wavenumbers(n, r2c=r2c, fftshift=shift)
        phinv.append(1.0 / windows.fourier_coefficients_np(kd, k))
        n_over_spec = n_over // 2 + 1 if r2c else n_over
        iranges.append(
            deconvolve.truncate_ranges(len(k), n_over_spec, r2c=r2c, fftshift=shift)
        )

    if spread_method == "blocked":
        if batch_size != "auto" and batch_size % 128 != 0 and not interpret:
            raise ValueError(
                f"batch_size={batch_size} must be a multiple of 128 for the "
                "blocked method on TPU (DMA lane-tile alignment); use "
                "interpret=True for emulation with smaller batches"
            )
        if block_dims is None:
            _, scalar_bytes, ncomp = VALUE_TYPES[tdtype]
            horner = window_pack(kernel_data, kernel_evalmode).kind == WINDOW_KINDS["horner"]
            block_dims = choose_geometry(shape_over, m, scalar_bytes, ncomp,
                                         ncoef=m + 4 if horner else 0)
        block_dims = tuple(int(b) for b in block_dims)
        if len(block_dims) != D:
            raise ValueError(f"block_dims {block_dims} must have {D} entries")
        for b, n_over in zip(block_dims, shape_over):
            if b < 1 or n_over % b != 0:
                raise ValueError(
                    f"block dim {b} must divide the oversampled grid size {n_over}"
                )

    coefs = None
    if all(kd.cs_poly is not None for kd in kernel_data):
        coefs = coefficient_stack(kernel_data)

    plan = Plan(
        dtype=tdtype,
        shape=shape,
        shape_over=shape_over,
        m=int(m),
        sigma=float(sigma_actual),
        kernel=kernel,
        evalmode=kernel_evalmode,
        ntransforms=int(ntransforms),
        fftshift=bool(fftshift),
        spread_method=spread_method,
        device=dev,
        block_dims=block_dims if spread_method == "blocked" else None,
        sort_points=bool(sort_points),
        point_transform=point_transform,
        chunk_size=chunk_size,
        kernel_data=kernel_data,
        phihat_inv=tuple(
            torch.as_tensor(p, dtype=real_dtype, device=dev) for p in phinv
        ),
        index_ranges=tuple(iranges),
        coefs=coefs,
    )
    if spread_method == "blocked" and dev.type == "cuda":
        check_kernel_support(plan)
    return plan


# ---------------------------------------------------------------------------
# set_points
# ---------------------------------------------------------------------------


def _as_real_tensor(p, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(p, torch.Tensor):
        return p.to(device=device, dtype=dtype)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return torch.as_tensor(np.asarray(p, dtype=np_dt), device=device)


def _canonicalise_points(points, D: int, real_dtype, device) -> torch.Tensor:
    """The reference's input formats (src/set_points.jl): a tuple/list of D
    vectors, a 1-D vector (D == 1), an (Np, D) array of point tuples, or a
    (D, Np) matrix.  Returns a (D, Np) tensor."""
    if isinstance(points, (tuple, list)):
        if len(points) != D:
            raise ValueError(f"expected {D} coordinate arrays, got {len(points)}")
        cols = [_as_real_tensor(p, real_dtype, device).reshape(-1) for p in points]
        n0 = cols[0].shape[0]
        if any(c.shape[0] != n0 for c in cols):
            raise ValueError("coordinate arrays must have equal lengths")
        return torch.stack(cols, dim=0)
    arr = _as_real_tensor(points, real_dtype, device)
    if arr.ndim == 1:
        if D != 1:
            raise ValueError(f"1-D point array given for a {D}-D plan")
        return arr[None, :]
    if arr.ndim == 2:
        if arr.shape[0] == D:
            return arr
        if arr.shape[1] == D:
            return arr.T
        raise ValueError(f"point array shape {tuple(arr.shape)} incompatible with D={D}")
    raise ValueError(f"point array must be 1- or 2-dimensional, got {arr.ndim}")


def fold_points(x: torch.Tensor, point_transform: Callable = _identity) -> torch.Tensor:
    """Apply the optional convention transform, then fold onto [0, 2pi)
    (src/blocking/blocking.jl:26-33); non-finite coordinates stay NaN."""
    if point_transform is not _identity:
        x = point_transform(x)
    return torch.remainder(x, torch.tensor(TWO_PI, dtype=x.dtype, device=x.device))


def set_points(plan: Plan, points) -> Plan:
    """Return a new plan with the non-uniform points set (folded on the
    reference path; split into cells and fractions and bin-sorted on the
    blocked path)."""
    pts = _canonicalise_points(points, plan.ndim, plan.real_dtype, plan.device)
    if plan.spread_method == "blocked":
        # No fold before the split: the split folds through its mod-N, and
        # an f32 fold first would put 2pi * 2^-24 of noise on the points.
        pts_t = pts if plan.point_transform is _identity else plan.point_transform(pts)
        cells, fracs = cells_and_fracs(plan.kernel_data, pts_t)
        cells_s, fracs_s, perm, pstarts = bin_sort(
            cells, fracs, plan.shape_over, plan.block_dims
        )
        return dataclasses.replace(
            plan,
            points=None,
            point_perm=None,
            point_perm_inv=None,
            cells_sorted=cells_s,
            fracs_sorted=fracs_s,
            sort_perm=perm,
            pstarts=pstarts,
            num_points_static=pts.shape[1],
        )
    pts_f = fold_points(pts, plan.point_transform)
    perm = perm_inv = None
    if plan.sort_points:
        # Cell-major order for scatter/gather locality
        # (src/blocking/gpu.jl:130-139).
        cells, _ = cells_and_fracs(plan.kernel_data, pts_f)
        lin = cells[0].to(torch.int64)
        for d in range(1, plan.ndim):
            lin = lin * plan.kernel_data[d].n + cells[d]
        _, perm = torch.sort(lin, stable=True)
        perm_inv = torch.argsort(perm)
        pts_f = pts_f[:, perm]
    return dataclasses.replace(
        plan,
        points=pts_f,
        point_perm=perm,
        point_perm_inv=perm_inv,
        cells_sorted=None,
        fracs_sorted=None,
        sort_perm=None,
        pstarts=None,
        num_points_static=None,
    )
