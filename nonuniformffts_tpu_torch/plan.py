"""NUFFT plans: transform configuration plus precomputed device tensors.

Counterpart of ``nonuniformffts_tpu/plan.py`` (and of the reference's
``PlanNUFFT``, src/plan.jl).  A plan is a frozen dataclass; ``set_points``
returns a new plan holding the point state (folded points on the
reference and direct paths; bin-sorted cells, fractions, permutation and
per-block ranges on the blocked path).  The plan's tensors live on
``plan.device``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .blocking import bin_order, cells_and_fracs, choose_geometry, sorted_copies
from .ops import deconvolve, direct, windows
from .ops.kernels.blocked import (
    bin_keys,
    check_kernel_support,
    interp1d_inverse,
    sorted_state,
    window_taps,
)
from .ops.kernels.common import VALUE_TYPES, coefficient_stack
from .ops.windows import (
    AbstractKernel,
    BackwardsKaiserBesselKernel,
    EvaluationMode,
    FastApproximation,
    KernelData,
    WindowPack,
    window_pack,
)
from .utils.misc import next_fast_len
from .utils.timer import traced

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
    spread_method: str  # 'reference' | 'blocked' | 'direct'
    device: torch.device
    block_dims: Optional[Tuple[int, ...]] = None
    sort_points: bool = False
    point_transform: Callable = _identity
    chunk_size: Optional[int] = None
    # Per-stage timer (utils/timer.py) or None: set_points and each exec
    # stage run in its labelled sections.
    timer: Any = None

    # --- precomputed tensors --------------------------------------------
    kernel_data: Tuple[KernelData, ...] = ()
    phihat_inv: Tuple[torch.Tensor, ...] = ()  # 1/phi_hat per dim
    index_ranges: Tuple = ()  # per-dim (src_start, length) ranges
    kvec: Tuple[torch.Tensor, ...] = ()  # per-dim output wavenumbers, float64
    coefs: Optional[torch.Tensor] = None  # (D, 2M, ncoef), (B)KB kernels

    # --- point state (set by set_points) --------------------------------
    # (D, Np) folded: the plan's real dtype on the reference path, float64
    # on the direct path
    points: Optional[torch.Tensor] = None
    point_perm: Optional[torch.Tensor] = None  # sort_points, reference path
    point_perm_inv: Optional[torch.Tensor] = None
    cells_sorted: Optional[torch.Tensor] = None  # (D, Np) int32, blocked
    fracs_sorted: Optional[torch.Tensor] = None  # (D, Np), blocked
    # (D, 2M, Np) window taps of the sorted points, blocked, every window but
    # (B)KB FastApproximation (ops/kernels/blocked.py:window_taps)
    wtaps_sorted: Optional[torch.Tensor] = None
    sort_perm: Optional[torch.Tensor] = None  # (Np,) int64, blocked
    # (Np,) int32, 1D blocked with outputs past INTERP1D_GATHER_BYTES: the
    # sorted position of each point (the 1D interpolation's gather,
    # ops/kernels/blocked.py:interp1d_inverse)
    sort_perm_inv: Optional[torch.Tensor] = None
    pstarts: Optional[torch.Tensor] = None  # (nblocks + 1,) int32, blocked
    num_points_static: Optional[int] = None
    # A slab plan of the spatial mode (parallel/spatial.py) keeps the global
    # grid's FFT normalisation, which its own shape_over would misstate.
    normfactor_override: Optional[float] = None
    # Transforms a pass of exec_type1 / exec_type2 (the JAX package's
    # cr_chunk, counted in transforms): the C transforms run in ceil(C / k)
    # groups of nearly equal size when their working set would not fit the
    # card (choose_transform_chunk); None runs them all in one pass.
    transform_chunk: Optional[int] = None

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

    @functools.cached_property
    def window(self) -> WindowPack:
        """The window's scalars as the CUDA kernels read them, computed once
        a plan object: a plan made from it (``dataclasses.replace``, as the
        spatial mode's slab plan with its own dim-0 ``kernel_data``) computes
        its own."""
        return window_pack(self.kernel_data, self.evalmode)

    @property
    def num_points(self) -> Optional[int]:
        if self.num_points_static is not None:
            return self.num_points_static
        return None if self.points is None else self.points.shape[1]

    @property
    def normfactor(self) -> float:
        """FFT normalisation ``prod(2pi / N~)`` (NonuniformFFTs.jl:181)."""
        if self.normfactor_override is not None:
            return self.normfactor_override
        out = 1.0
        for n in self.shape_over:
            out *= TWO_PI / n
        return out

    def __repr__(self):  # the reference's Base.show (plan.jl:362-392)
        dev = str(self.device)
        if self.device.type == "cuda":
            dev += f" ({torch.cuda.get_device_name(self.device)})"
        lines = [
            f"{self.ndim}-dimensional PlanNUFFT (PyTorch) with input type "
            f"{str(self.dtype).removeprefix('torch.')}:",
            f"  - kernel: {self.kernel} with half-support M = {self.m}",
            f"  - evaluation mode: {type(self.evalmode).__name__}",
            f"  - oversampling factor: sigma = {self.sigma:.6g}",
            f"  - uniform dimensions: {self.spectral_shape} (oversampled grid {self.shape_over})",
            f"  - simultaneous transforms: {self.ntransforms}",
            f"  - frequency order: {'increasing' if self.fftshift else 'FFTW'} "
            f"(fftshift = {self.fftshift})",
            f"  - spreading method: {self.spread_method}"
            + (f", block dims {self.block_dims}" if self.block_dims else ""),
            f"  - points set: {self.num_points if self.num_points is not None else 'no'}",
            f"  - device: {dev}",
        ]
        if self.block_dims:
            nblocks = math.prod(n // b for n, b in zip(self.shape_over, self.block_dims))
            lines.append(f"  - blocked geometry: {nblocks} blocks")
        if self.timer is not None:
            lines.append(f"  - timer attached (synchronise={self.timer.synchronise})")
        return "\n".join(lines)


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


def auto_spread_method(device: torch.device, np_hint: Optional[int],
                       spectral_shape, shape_over, real_dtype: torch.dtype) -> str:
    """``spread_method='auto'``: ``'reference'`` on the CPU; on CUDA
    ``'direct'`` where ``np_hint`` points fall below the crossover model
    (``ops/direct.py:prefers_direct``), else ``'blocked'``."""
    if device.type != "cuda":
        return "reference"
    if np_hint is not None and direct.prefers_direct(np_hint, spectral_shape, shape_over,
                                                     real_dtype):
        return "direct"
    return "blocked"


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
    np_hint: Optional[int] = None,
    timer: Any = None,
    # Accepted so that call sites match the JAX package; none of these has
    # an effect in the port (README "PyTorch / CUDA port").
    batch_size="auto",
    interpret: bool = False,
    fft_method: Optional[str] = None,
    fft_variant: str = "auto",
    precision: str = "highest",
    kernel_precision: Optional[str] = None,
    window_rows: Optional[int] = "auto",
    window_rows_y: Optional[int] = "auto",
    layout: str = "packed",
    dma_super: int = 4,
    spread_acc2: bool = False,
    value_permute: str = "auto",
    dft_fold: bool = True,
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
    kernels on a CUDA device (their plain versions on the CPU); ``'direct'``
    evaluates the exact sums as dense factor products (``ops/direct.py``);
    ``'auto'`` is ``'blocked'`` on CUDA, or ``'direct'`` there when
    ``np_hint`` (the expected number of points) lies below the measured
    crossover, and ``'reference'`` on the CPU.  ``timer`` (a
    ``utils.timer.Timer``) times ``set_points`` and each exec stage.
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
    if kernel is None:
        kernel = BackwardsKaiserBesselKernel()
    if kernel_evalmode is None:
        kernel_evalmode = FastApproximation()

    if spread_method == "auto":
        spec_shape = shape[:-1] + (shape[-1] // 2 + 1,) if is_real else shape
        spread_method = auto_spread_method(dev, np_hint, spec_shape, shape_over,
                                           _REAL_OF[tdtype])
    if spread_method not in ("reference", "blocked", "direct"):
        raise ValueError(f"unknown spread_method {spread_method!r}")
    if spread_method == "direct" and sort_points:
        # No locality to exploit; the value order is the point order.
        raise ValueError("sort_points is not supported with spread_method='direct'")
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
    phinv, iranges, kvec = [], [], []
    for d, (n, n_over, kd) in enumerate(zip(shape, shape_over, kernel_data)):
        r2c = is_real and d == D - 1
        shift = fftshift and not r2c
        k = deconvolve.output_wavenumbers(n, r2c=r2c, fftshift=shift)
        kvec.append(torch.as_tensor(k, dtype=torch.float64, device=dev))
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
            block_dims = choose_geometry(shape_over, m, scalar_bytes, ncomp)
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
        timer=timer,
        kernel_data=kernel_data,
        phihat_inv=tuple(
            torch.as_tensor(p, dtype=real_dtype, device=dev) for p in phinv
        ),
        index_ranges=tuple(iranges),
        kvec=tuple(kvec),
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


# ---------------------------------------------------------------------------
# Transform groups: the memory model behind Plan.transform_chunk
# ---------------------------------------------------------------------------

#: Share of the card's memory (``total_memory``) that the modelled working
#: set of one exec may fill; the rest is left to the CUDA context, cuFFT's
#: plans, the caching allocator's slack and what the caller holds.
TRANSFORM_MEMORY_FRACTION = 0.75
#: cuFFT's workspace, in grids of the transforms of one FFT call.  On an
#: NVIDIA H100 (700 W; ``chip_smoke.py`` phase 15, PERF.md) the batched c2c
#: FFTs of 6144^2 grids took about one (type 2's peak a transform 2.97
#: grids, of which the padded spectrum and the grid 2.0), those of 384^3 and
#: 512^3 grids and of 1.57M-point lines none: one grid everywhere holds
#: every measured peak, and the smaller groups it makes elsewhere cost no
#: measured time.
FFT_WORKSPACE_GRIDS = 1.0


@dataclasses.dataclass(frozen=True)
class WorkingSet:
    """Device bytes of one exec: ``fixed`` whatever the group size, and
    ``per_transform`` for each transform of a group."""

    fixed: int
    per_transform: int

    def total(self, group: int) -> int:
        return self.fixed + group * self.per_transform


def transform_working_set(shape_over, spectral_shape_over, spectral_shape, dtype,
                          ntransforms: int, num_points: int, *, point_state_bytes: int = 0,
                          spread_method: str = "blocked", m: int = 4,
                          chunk_size: Optional[int] = None, extra_grids: float = 0,
                          slab_buffers: Optional[Tuple[Tuple[int, ...], ...]] = None
                          ) -> WorkingSet:
    """The modelled device memory of ``exec_type1`` / ``exec_type2`` on
    ``ntransforms`` transforms of ``num_points`` points.

    Each transform of a group holds its grid (``shape_over`` in the plan's
    dtype), cuFFT's out-of-place output (``spectral_shape_over``, complex),
    cuFFT's workspace (``FFT_WORKSPACE_GRIDS`` of the larger of the two),
    the pad or truncation temporary beside its spectrum (the spectrum cut
    or padded along one axis; on a real-data plan also the spectra that
    ``irfftn`` makes: the c2c pass over the leading axes writes a new one,
    and the c2r pass, which overwrites its input, copies it), and the
    sorted or interpolated values of its points, twice.  On an NVIDIA H100
    (700 W) this holds each measured peak a transform: at 256^3 1.8-2.1
    grids complex and 2.7-4.0 real against 3.5-3.7 and 5.7, at 4096^2
    2.56 / 2.97 against 3.72, at 2^20 2.33 / 2.36 against 4.94
    (``chip_smoke.py`` phase 15, PERF.md).  The reference path's spread
    also accumulates in a 64-bit grid and both its passes materialise
    ``(chunk, (2M)^D)`` stencil values a transform.  Fixed: the ``(C, Np)``
    values and the ``(C,) + spectral_shape`` spectrum, each twice (the
    caller's and the callback's or scaled copy), and the device bytes held
    whatever the group size (``point_state_bytes``: the plan's point state,
    all chunks' on a points-chunked plan).

    The other paths' execs say what they hold beyond that:
    ``extra_grids`` more grids a transform (a points-chunked type 1 keeps
    its accumulator beside each chunk's grid: 1); ``slab_buffers`` for a
    spatial rank (``parallel/spatial.py``), whose ``shape_over`` is its
    extended slab, ``spectral_shape_over`` the slab transformed over dims
    1.., ``spectral_shape`` its output a transform, and whose transform holds
    complex buffers of these shapes in place of the pad or truncation
    temporary (the transposes' columns, the gathered spectrum); its
    ``irfftn`` covers dims 1.. only."""
    tdtype = _resolve_dtype(dtype)
    real_bytes = torch.finfo(_REAL_OF[tdtype]).bits // 8
    value_bytes = real_bytes * (2 if tdtype.is_complex else 1)
    grid = math.prod(shape_over) * value_bytes
    spec_over = math.prod(spectral_shape_over) * 2 * real_bytes
    fft_dims = len(shape_over)
    if slab_buffers is None:
        temp = spec_over * max(k / n for k, n in zip(spectral_shape, spectral_shape_over))
    else:
        temp = sum(math.prod(s) for s in slab_buffers) * 2 * real_bytes
        fft_dims -= 1
    if not tdtype.is_complex:
        temp += spec_over * (2 if fft_dims > 1 else 1)
    per = (grid * (1 + extra_grids) + spec_over + temp
           + FFT_WORKSPACE_GRIDS * max(grid, spec_over)
           + 2 * num_points * value_bytes)
    fixed = (2 * ntransforms * num_points * value_bytes
             + 2 * ntransforms * math.prod(spectral_shape) * 2 * real_bytes
             + point_state_bytes)
    if spread_method == "reference":
        acc_bytes = 8 * (2 if tdtype.is_complex else 1)
        stencil = min(num_points, chunk_size or num_points) * (2 * m) ** len(shape_over)
        per += math.prod(shape_over) * acc_bytes + stencil * (value_bytes + acc_bytes)
        fixed += stencil * (8 + real_bytes)  # the linear cells and the weights
    return WorkingSet(fixed=int(fixed), per_transform=int(per))


def choose_transform_chunk(shape_over, spectral_shape_over, spectral_shape, dtype,
                           ntransforms: int, num_points: int, device_bytes: int,
                           **working_set_kw) -> Optional[int]:
    """The largest group of transforms whose modelled working set
    (:func:`transform_working_set`) fits ``TRANSFORM_MEMORY_FRACTION`` of
    ``device_bytes``: ``None`` when all ``ntransforms`` fit in one pass,
    never less than 1 (a single transform that does not fit fails in the
    exec, visibly)."""
    ws = transform_working_set(shape_over, spectral_shape_over, spectral_shape, dtype,
                               ntransforms, num_points, **working_set_kw)
    budget = int(TRANSFORM_MEMORY_FRACTION * device_bytes) - ws.fixed
    group = max(1, budget // ws.per_transform)
    return None if group >= ntransforms else int(group)


def transform_groups(ntransforms: int, chunk: Optional[int]) -> Tuple[slice, ...]:
    """The transforms of each pass: one slice of all of them when ``chunk``
    is None or covers them, else ``ceil(C / chunk)`` slices of nearly equal
    size (``torch.tensor_split``'s), so that cuFFT sees at most two batch
    sizes."""
    if chunk is None or chunk >= ntransforms:
        return (slice(0, ntransforms),)
    parts = torch.arange(ntransforms).tensor_split(-(-ntransforms // chunk))
    return tuple(slice(int(p[0]), int(p[-1]) + 1) for p in parts)


def point_state_bytes(plan: Plan) -> int:
    """Device bytes of the point state ``set_points`` keeps on ``plan``."""
    state = (plan.points, plan.point_perm, plan.point_perm_inv, plan.cells_sorted,
             plan.fracs_sorted, plan.wtaps_sorted, plan.sort_perm, plan.sort_perm_inv,
             plan.pstarts)
    return sum(t.numel() * t.element_size() for t in state if t is not None)


def device_share_bytes(device: torch.device, ranks_on_device: int = 1) -> int:
    """The device memory one process may plan with: the card's
    ``total_memory``, or its ``1 / ranks_on_device`` share when that many
    ranks of a process group run on the one card
    (``parallel/comm.py:ranks_on_device``)."""
    return torch.cuda.get_device_properties(device).total_memory // ranks_on_device


def model_arguments(plan: Plan) -> dict:
    """The arguments of :func:`choose_transform_chunk` (but the device's
    bytes) that describe ``plan``'s own exec."""
    return dict(shape_over=plan.shape_over, spectral_shape_over=plan.spectral_shape_over,
                spectral_shape=plan.spectral_shape, dtype=plan.dtype,
                ntransforms=plan.ntransforms, num_points=plan.num_points,
                point_state_bytes=point_state_bytes(plan), spread_method=plan.spread_method,
                m=plan.m, chunk_size=plan.chunk_size)


def card_transform_chunk(plan: Plan, *, ranks_on_device: int = 1,
                         **model_kw) -> Optional[int]:
    """The ``transform_chunk`` of ``plan`` chosen for the card it runs on
    (its share of it, :func:`device_share_bytes`), for CUDA plans on the
    blocked and reference paths (the direct path bounds its factors by
    points, ``ops/direct.py``); other plans keep theirs.  ``model_kw``
    replaces arguments of :func:`model_arguments` where the exec that runs
    the plan holds more than the plan's own (a points-chunked, point-sharded
    or spatial exec)."""
    if plan.device.type != "cuda" or plan.spread_method not in ("blocked", "reference"):
        return plan.transform_chunk
    budget = device_share_bytes(plan.device, ranks_on_device)
    return choose_transform_chunk(device_bytes=budget, **{**model_arguments(plan), **model_kw})


def with_transform_chunk(plan: Plan, *, ranks_on_device: int = 1, **model_kw) -> Plan:
    """``plan`` with its :func:`card_transform_chunk`."""
    chunk = card_transform_chunk(plan, ranks_on_device=ranks_on_device, **model_kw)
    if chunk == plan.transform_chunk:
        return plan
    return dataclasses.replace(plan, transform_chunk=chunk)


def set_points(plan: Plan, points) -> Plan:
    """Return a new plan with the non-uniform points set (folded on the
    reference path, and in float64 on the direct path; split into cells and
    fractions and bin-sorted on the blocked path, where a window other than
    (B)KB FastApproximation also gets its sorted points' taps,
    ``wtaps_sorted``, for every exec).  A CUDA plan on the blocked or
    reference path also gets its ``transform_chunk`` from the card's memory
    (:func:`card_transform_chunk`).  A plan's timer times it under
    ``"set_points"`` and its parts under ``"set_points/(k) ..."``: on the
    blocked path ``(1) cell split``, ``(2) bin sort``, ``(3) sorted
    copies``, ``(4) window taps`` and ``(5) transform groups``; on the
    reference path ``(1) fold``, ``(2) sort`` (with ``sort_points``) and
    ``(5) transform groups``; on the direct path ``(1) fold``.  A profiler
    trace carries the same labels (``utils/timer.py``).  On a CUDA plan the
    blocked path's first three parts are two kernels around the sort
    (``csrc/bin_sort.cu``: the bin keys, then the sorted cells, fractions
    and block ranges), which read nothing back to the host; elsewhere
    ``blocking.py``'s chain, their plain version."""
    return traced(plan.timer, "set_points", _set_points, plan, points)


def canonical_points(plan: Plan, points) -> torch.Tensor:
    """``points`` as the (D, Np) tensor ``set_points`` works on: the plan's
    real dtype, or float64 on the direct path, whose phases are formed in
    float64 (ops/direct.py)."""
    real_dtype = torch.float64 if plan.spread_method == "direct" else plan.real_dtype
    return _canonicalise_points(points, plan.ndim, real_dtype, plan.device)


def _transformed_points(plan: Plan, points) -> torch.Tensor:
    """``points`` as the blocked path splits them: canonical, after the
    plan's point transform.  No fold before the split: the split folds
    through its mod-N, and an f32 fold first would put 2pi * 2^-24 of noise
    on the points."""
    pts = canonical_points(plan, points)
    return pts if plan.point_transform is _identity else plan.point_transform(pts)


def _cell_split(plan: Plan, points):
    """The blocked path's cells and fractions of ``points`` (after the
    plan's point transform), and the number of points."""
    pts_t = _transformed_points(plan, points)
    cells, fracs = cells_and_fracs(plan.kernel_data, pts_t)
    return cells, fracs, pts_t.shape[1]


def _bin_keys(plan: Plan, points):
    """The bin keys of ``points`` (after the plan's point transform) and
    their records (``ops/kernels/blocked.py:bin_keys``)."""
    pts_t = _transformed_points(plan, points).contiguous()
    return bin_keys(pts_t, plan.shape_over, plan.block_dims)


def _sorted_state_kernels(plan: Plan, points):
    """A CUDA plan's sorted point state ``(cells, fracs, perm, pstarts,
    num_points)``: the key kernel, the stable sort, the sorted-state
    kernel; no host read."""
    t = plan.timer
    keys, records = traced(t, "(1) cell split", _bin_keys, plan, points)
    skeys, perm = traced(t, "(2) bin sort", torch.sort, keys, stable=True)
    del keys  # freed before the sorted state's outputs
    cells_s, fracs_s, pstarts = traced(t, "(3) sorted copies", sorted_state, records, skeys,
                                       perm, plan.shape_over, plan.block_dims)
    return cells_s, fracs_s, perm, pstarts, perm.shape[0]


def _sorted_state_plain(plan: Plan, points):
    """The plain version of :func:`_sorted_state_kernels` (``blocking.py``'s
    chain), for plans off the card."""
    t = plan.timer
    cells, fracs, num_points = traced(t, "(1) cell split", _cell_split, plan, points)
    perm, pstarts = traced(t, "(2) bin sort", bin_order, cells, plan.shape_over,
                           plan.block_dims)
    cells_s, fracs_s = traced(t, "(3) sorted copies", sorted_copies, cells, fracs, perm)
    return cells_s, fracs_s, perm, pstarts, num_points


def _with_sorted_state(plan: Plan, cells_s, fracs_s, perm, pstarts, num_points):
    """``plan`` holding the blocked path's sorted point state (and, for a
    large 1D interpolation, the inverse order), and the window taps of that
    state (``window_taps``)."""
    plan = dataclasses.replace(
        plan,
        points=None,
        point_perm=None,
        point_perm_inv=None,
        cells_sorted=cells_s,
        fracs_sorted=fracs_s,
        wtaps_sorted=None,
        sort_perm=perm,
        sort_perm_inv=interp1d_inverse(plan, perm),
        pstarts=pstarts,
        num_points_static=num_points,
    )
    return plan, window_taps(plan)


def _with_taps_and_groups(plan: Plan, taps) -> Plan:
    """``plan`` with its window taps and its ``transform_chunk``
    (:func:`card_transform_chunk`, the taps counted in its point state)."""
    taps_bytes = 0 if taps is None else taps.numel() * taps.element_size()
    chunk = card_transform_chunk(plan, point_state_bytes=point_state_bytes(plan) + taps_bytes)
    return dataclasses.replace(plan, wtaps_sorted=taps, transform_chunk=chunk)


def _fold(plan: Plan, points) -> torch.Tensor:
    return fold_points(canonical_points(plan, points), plan.point_transform)


def _cell_order(plan: Plan, pts_f: torch.Tensor):
    """Cell-major order for scatter/gather locality
    (src/blocking/gpu.jl:130-139): the sorted points, the order and its
    inverse."""
    cells, _ = cells_and_fracs(plan.kernel_data, pts_f)
    lin = cells[0].to(torch.int64)
    for d in range(1, plan.ndim):
        lin = lin * plan.kernel_data[d].n + cells[d]
    _, perm = torch.sort(lin, stable=True)
    return pts_f[:, perm], perm, torch.argsort(perm)


def _set_points(plan: Plan, points) -> Plan:
    t = plan.timer
    if plan.spread_method == "blocked":
        # The split's intermediates are freed before a window's tap table
        # is made.  The K3 table reads the sorted state from a plan, so the
        # state goes in first; the taps and the group size go in together.
        state = (_sorted_state_kernels if plan.device.type == "cuda"
                 else _sorted_state_plain)(plan, points)
        plan, taps = traced(t, "(4) window taps", _with_sorted_state, plan, *state)
        return traced(t, "(5) transform groups", _with_taps_and_groups, plan, taps)
    pts_f = traced(t, "(1) fold", _fold, plan, points)
    perm = perm_inv = None
    if plan.sort_points:
        pts_f, perm, perm_inv = traced(t, "(2) sort", _cell_order, plan, pts_f)
    plan = dataclasses.replace(
        plan,
        points=pts_f,
        point_perm=perm,
        point_perm_inv=perm_inv,
        cells_sorted=None,
        fracs_sorted=None,
        wtaps_sorted=None,
        sort_perm=None,
        sort_perm_inv=None,
        pstarts=None,
        num_points_static=None,
    )
    if plan.spread_method == "direct":
        return plan  # the direct path bounds its factors by points, not groups
    return traced(t, "(5) transform groups", with_transform_chunk, plan)
