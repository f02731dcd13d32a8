"""The deconvolution kernels (``csrc/deconvolve.cu``): type 1's
truncate-and-scale (``nufft_deconvolve_truncate_<type>``) and type 2's
scale-and-pad (``nufft_deconvolve_pad_<type>``), one pass each over the
spectra of C' transforms.

Their plain version is ``ops/deconvolve.py``'s torch chain
(``deconvolve_truncate_plain``, ``deconvolve_pad_plain``), which runs every
spectrum :func:`takes` refuses: one that is not a CUDA complex64 or
complex128 tensor of 1-3 spectral axes.  A geometry past the kernels'
32-bit item count (``common.py:deconvolve_items``) raises.  A 1D or 2D
spectrum reaches the same kernels with the missing leading axes of length
1 (``common.py:deconvolve_axes``).  A real-data plan's spectrum, whose halved
last axis is one run, launches the ``real_<type>`` entry point.  Each
launch adds one to ``blocked.LAUNCHES[entry point]``.
"""

from __future__ import annotations

import functools

import torch

from . import build
from .blocked import LAUNCHES
from .common import (
    DECONVOLVE_MAX_ITEMS,
    DeconvolveAxes,
    deconvolve_axes,
    deconvolve_entry_name,
    deconvolve_items,
    deconvolve_vector,
)

#: The real dtype of each complex dtype the kernels take.
REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}

#: The ctypes function of each entry point, resolved at first use.
_FNS = {}


def takes(x: torch.Tensor) -> bool:
    """Whether the kernels take the spectrum ``x``, ``(C',)`` and 1-3
    spectral axes."""
    return x.device.type == "cuda" and x.dtype in REAL_OF and 2 <= x.ndim <= 4


@functools.lru_cache(maxsize=256)
def _axes(index_ranges, shape_over_spec) -> DeconvolveAxes:
    """``deconvolve_axes``, after checking that every run lies inside its
    oversampled axis."""
    if len(index_ranges) != len(shape_over_spec):
        raise ValueError(f"{len(index_ranges)} axes of index ranges for a "
                         f"{len(shape_over_spec)}D spectrum")
    for ranges, n in zip(index_ranges, shape_over_spec):
        if not 1 <= len(ranges) <= 2 or any(s < 0 or l < 0 or s + l > n for s, l in ranges):
            raise ValueError(f"index ranges {ranges} do not fit an axis of {n}")
    return deconvolve_axes(index_ranges, shape_over_spec)


def _launch(step: str, x: torch.Tensor, out_shape, index_ranges, axes: DeconvolveAxes,
            phihat_inv, arg) -> torch.Tensor:
    """The ``step`` kernel from ``x`` into a new contiguous tensor of
    ``out_shape``; ``arg`` is the truncate's normfactor or the pad's scale
    flag, and ``phihat_inv`` the factors (None: none read)."""
    if not takes(x):
        raise ValueError(f"no deconvolution kernel for a {tuple(x.shape)} {x.dtype} tensor "
                         f"on {x.device}")
    real = len(index_ranges[-1]) == 1  # an r2c plan's halved last axis
    name = deconvolve_entry_name(step, REAL_OF[x.dtype] if real else x.dtype)
    x = x.contiguous()
    vec = deconvolve_vector(axes, x.element_size()) if x.data_ptr() % 16 == 0 else 1
    items = deconvolve_items(axes, step, vec)
    if items >= DECONVOLVE_MAX_ITEMS:
        raise ValueError(f"{name}: {items} work items a transform, the kernel takes fewer "
                         f"than {DECONVOLVE_MAX_ITEMS}")
    out = x.new_empty(out_shape)
    if out.numel() == 0:
        return out
    ptrs = [None] * 3
    if phihat_inv is not None:
        D = len(index_ranges)
        for d, (p, n) in enumerate(zip(phihat_inv, axes.out[3 - D:])):
            if (p.device != x.device or p.dtype != REAL_OF[x.dtype] or p.shape != (n,)
                    or not p.is_contiguous()):
                raise TypeError(f"phihat_inv[{d}] must be a contiguous ({n},) "
                                f"{REAL_OF[x.dtype]} tensor on {x.device}")
            ptrs[3 - D + d] = p.data_ptr()
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(build.load(), name)
    geom = build.DeconvGeometry.of(x.shape[0], axes)
    with torch.cuda.device(x.device):
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        err = fn(x.data_ptr(), out.data_ptr(), *ptrs, arg, geom, vec, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def truncate(uhat_over: torch.Tensor, index_ranges, phihat_inv, normfactor: float) -> torch.Tensor:
    """Type-1 step (3) on the card: ``(C',) + shape_over_spec`` ->
    ``(C',) + output modes``, each mode read through ``index_ranges`` and
    multiplied by ``normfactor``, then by ``phihat_inv`` of axis 0, 1, 2."""
    axes = _axes(tuple(map(tuple, index_ranges)), tuple(uhat_over.shape[1:]))
    out_shape = (uhat_over.shape[0],) + axes.out[3 - len(index_ranges):]
    return _launch("truncate", uhat_over, out_shape, index_ranges, axes, phihat_inv,
                   float(normfactor))


def pad(uhat_k: torch.Tensor, shape_over_spec, index_ranges, phihat_inv=None) -> torch.Tensor:
    """Type-2 step (1) on the card: ``(C',) + output modes`` ->
    ``(C',) + shape_over_spec``, each kept mode multiplied by ``phihat_inv``
    of axis 0, 1, 2 (not at all when None) at its place, zeros elsewhere."""
    shape_over_spec = tuple(int(n) for n in shape_over_spec)
    axes = _axes(tuple(map(tuple, index_ranges)), shape_over_spec)
    D = len(index_ranges)
    if tuple(uhat_k.shape[1:]) != axes.out[3 - D:]:
        raise ValueError(f"modes {tuple(uhat_k.shape[1:])} do not match the index "
                         f"ranges' {axes.out[3 - D:]}")
    return _launch("pad", uhat_k, (uhat_k.shape[0],) + shape_over_spec, index_ranges, axes,
                   phihat_inv, int(phihat_inv is not None))
