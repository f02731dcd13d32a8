"""Block-major <-> grid relayout: wrappers around the hand-written CUDA
kernels K8a (``nufft_relayout_to_grid_<type>``) and K8b
(``nufft_relayout_to_blocks_<type>``), ``csrc/relayout.cu``, each with its
plain PyTorch version.

Counterpart of ``nonuniformffts_tpu/ops/pallas/common.py:396-532``: the
grid layout ``(CR, N0, .., N_{D-1})`` and the block-major layout ``(CR,
nb0, .., nb_{D-1}, B0, .., B_{D-1})`` differ by the block-interleave
transpose.  In the port they pack and unpack the slabs around the
all_to_all transposes of the spatial mode (``parallel/spatial.py``): with
block dims ``(N0l, K1l, K2)`` the blocks are ``(CR, 1, n, 1, ..)``, so the
block axis ``nb1`` is the rank.

A wrapper given a CPU tensor runs the plain version, for any dtype; given a
CUDA tensor it launches its kernel or raises.  The kernels take complex64
and complex128, what the transposes move (real-data plans' spectra are
complex too).  D = 1 is a free reshape on every device and launches
nothing.  Each launch adds one to ``LAUNCHES[entry point]``.

The kernels copy runs, not elements: :func:`run_geometry` splits a
relayout into runs that are contiguous in both layouts, and
:func:`block_runs` is the kernels' division chain from a run's grid
position to its block-major one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from . import build

#: The entry-point suffix of each dtype the kernels take.
SUFFIXES = {torch.complex64: "f32", torch.complex128: "f64"}

#: Launches of each relayout entry point by its wrapper in this process.
LAUNCHES = {f"nufft_relayout_to_{direction}_{suffix}": 0
            for direction in ("grid", "blocks") for suffix in SUFFIXES.values()}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def entry_point(direction: str, dtype: torch.dtype) -> str:
    """``nufft_relayout_to_<direction>_<suffix>`` for ``direction`` 'grid'
    (K8a) or 'blocks' (K8b) and a tensor of ``dtype``."""
    if dtype not in SUFFIXES:
        raise TypeError(f"no relayout kernel for {dtype}")
    return f"nufft_relayout_to_{direction}_{SUFFIXES[dtype]}"


def _check_dims(block_dims: Sequence[int], extents: Sequence[int], what: str):
    """1-3 block dims, as many as the grid's dims, or equal to the block
    extents of a block-major tensor (``what`` 'block')."""
    ok = len(block_dims) == len(extents) and 1 <= len(block_dims) <= 3
    if what == "block":
        ok = ok and tuple(extents) == tuple(int(b) for b in block_dims)
    if not ok:
        raise ValueError(f"block_dims {tuple(block_dims)} do not match the {what} "
                         f"dims {tuple(extents)} (1-3 dims)")


def relayout_to_grid_plain(blocks_major: torch.Tensor, block_dims) -> torch.Tensor:
    """Plain version of K8a: ``(CR, nb0, .., B0, ..) -> (CR, N0, ..)`` by one
    permute and reshape (``common.py:relayout_to_grid``)."""
    D = len(block_dims)
    _check_dims(block_dims, blocks_major.shape[1 + D:], "block")
    CR = blocks_major.shape[0]
    nb = tuple(blocks_major.shape[1 : 1 + D])
    perm = (0,) + tuple(x for d in range(D) for x in (1 + d, 1 + D + d))
    return blocks_major.permute(perm).reshape(
        (CR,) + tuple(n * b for n, b in zip(nb, block_dims)))


def relayout_to_blocks_plain(grid: torch.Tensor, block_dims) -> torch.Tensor:
    """Plain version of K8b: ``(CR, N0, ..) -> (CR, nb0, .., B0, ..)``, the
    inverse of :func:`relayout_to_grid_plain` (``common.py:relayout_to_blocks``)."""
    D = len(block_dims)
    _check_dims(block_dims, grid.shape[1:], "grid")
    CR = grid.shape[0]
    nb = tuple(n // b for n, b in zip(grid.shape[1:], block_dims))
    split = (CR,) + tuple(x for nbd, b in zip(nb, block_dims) for x in (nbd, b))
    perm = (0,) + tuple(1 + 2 * d for d in range(D)) + tuple(2 + 2 * d for d in range(D))
    return grid.reshape(split).permute(perm).contiguous()


def _as_3d(grid_shape: Tuple[int, ...], block_dims) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """A 2D relayout as the 3D one with a leading dim of one block of 1."""
    pad = 3 - len(block_dims)
    return (1,) * pad + tuple(grid_shape), (1,) * pad + tuple(int(b) for b in block_dims)


class RunGeometry(NamedTuple):
    """A relayout as ``runs`` runs of ``run_len`` elements, contiguous in
    both layouts.  Run ``r = ((c n0 + g0) n1 + g1) nb2 + j2`` starts at grid
    offset ``r run_len`` and at the block-major offset :func:`block_runs`
    gives; ``n0, b0, n1, b1, nb2`` are the dims of that division chain."""

    runs: int
    run_len: int
    n0: int
    b0: int
    n1: int
    b1: int
    nb2: int


def run_geometry(grid_shape: Sequence[int], block_dims) -> RunGeometry:
    """The run decomposition of the relayout of a grid ``(CR, N0, ..)``
    (2 or 3 grid dims) with ``block_dims``: runs of the longest stretch that
    is contiguous on both sides, ``B2`` if ``B2 < N2``, else ``B1 B2`` if
    ``B1 < N1``, else ``B0 B1 B2`` (then the relayout is a plain copy).  The
    longer stretches are the first case with a dim merged into the run."""
    (n0, n1, n2), (b0, b1, b2) = _as_3d(tuple(grid_shape[1:]), block_dims)
    if b2 < n2:
        run_len, dims = b2, (n0, b0, n1, b1, n2 // b2)
    elif b1 < n1:
        run_len, dims = b1 * b2, (n0, b0, n1 // b1, 1, 1)
    else:
        run_len, dims = b0 * b1 * b2, (n0 // b0, 1, 1, 1, 1)
    return RunGeometry(int(grid_shape[0]) * dims[0] * dims[2] * dims[4], run_len, *dims)


def block_runs(geom: RunGeometry, r: torch.Tensor) -> torch.Tensor:
    """Block-major offsets of runs ``r`` in units of ``run_len``: the
    kernels' division chain (``csrc/relayout.cu:block_run``)."""
    r, j2 = r.div(geom.nb2, rounding_mode="floor"), r % geom.nb2
    r, g1 = r.div(geom.n1, rounding_mode="floor"), r % geom.n1
    c, g0 = r.div(geom.n0, rounding_mode="floor"), r % geom.n0
    blk = ((c * (geom.n0 // geom.b0) + g0 // geom.b0) * (geom.n1 // geom.b1)
           + g1 // geom.b1) * geom.nb2 + j2
    return (blk * geom.b0 + g0 % geom.b0) * geom.b1 + g1 % geom.b1


#: The ctypes function of each entry point, resolved at first use.
_FNS = {}
#: run_geometry of the shapes seen, so that a repeated call computes none.
_run_geometry = functools.lru_cache(maxsize=256)(run_geometry)


def _launch(direction: str, x: torch.Tensor, out_shape, grid_shape, block_dims) -> torch.Tensor:
    """K8a / K8b on the CUDA tensor ``x`` into a new tensor of ``out_shape``.
    The host work is kept to what a launch needs: one check of the device,
    type, contiguity and alignment, the entry point and the run geometry
    from caches, and the current stream's handle."""
    if x.device.type != "cuda":
        raise ValueError(f"no relayout kernel for device {x.device}")
    name = entry_point(direction, x.dtype)  # raises for a dtype without a kernel
    if not x.is_contiguous():
        x = x.contiguous()
    elif x.data_ptr() % x.element_size():  # the kernel moves whole elements
        x = x.clone()
    out = x.new_empty(out_shape)
    if out.numel() == 0:
        return out
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(build.load(), name)
    geom = _run_geometry(tuple(grid_shape), tuple(block_dims))
    dev = x.device.index
    if dev == torch.cuda.current_device():
        # The raw handle: torch.cuda.current_stream() builds a Stream object
        # first, several microseconds on the host.
        err = fn(x.data_ptr(), out.data_ptr(), *geom, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(x.data_ptr(), out.data_ptr(), *geom,
                     torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def relayout_to_grid(blocks_major: torch.Tensor, block_dims) -> torch.Tensor:
    """``(CR, nb0, .., nb_{D-1}, B0, .., B_{D-1}) -> (CR, N0, .., N_{D-1})``:
    K8a on a CUDA tensor, the plain version on a CPU one."""
    D = len(block_dims)
    _check_dims(block_dims, blocks_major.shape[1 + D:], "block")
    CR = blocks_major.shape[0]
    grid_shape = (CR,) + tuple(n * b for n, b in zip(blocks_major.shape[1 : 1 + D], block_dims))
    if D == 1:  # block-major is the grid up to a contiguous merge
        return blocks_major.reshape(grid_shape)
    if blocks_major.device.type == "cpu":
        return relayout_to_grid_plain(blocks_major, block_dims)
    return _launch("grid", blocks_major, grid_shape, grid_shape, block_dims)


def relayout_to_blocks(grid: torch.Tensor, block_dims) -> torch.Tensor:
    """``(CR, N0, .., N_{D-1}) -> (CR, nb0, .., nb_{D-1}, B0, .., B_{D-1})``:
    K8b on a CUDA tensor, the plain version on a CPU one."""
    D = len(block_dims)
    _check_dims(block_dims, grid.shape[1:], "grid")
    CR = grid.shape[0]
    for n, b in zip(grid.shape[1:], block_dims):
        if b < 1 or n % b:
            raise ValueError(f"block dims {tuple(block_dims)} must divide the grid "
                             f"{tuple(grid.shape[1:])}")
    nb = tuple(n // b for n, b in zip(grid.shape[1:], block_dims))
    if D == 1:
        return grid.reshape((CR,) + nb + tuple(block_dims))
    if grid.device.type == "cpu":
        return relayout_to_blocks_plain(grid, block_dims)
    return _launch("blocks", grid, (CR,) + nb + tuple(block_dims), grid.shape, block_dims)
