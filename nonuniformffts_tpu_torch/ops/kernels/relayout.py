"""Block-major <-> grid relayout: wrappers around the hand-written CUDA
kernels K8a (``nufft_relayout_to_grid_<type>``) and K8b
(``nufft_relayout_to_blocks_<type>``), ``csrc/relayout.cu``, each with its
plain PyTorch version.

Counterpart of ``nonuniformffts_tpu/ops/pallas/common.py:396-532``: the
grid layout ``(CR, N0, .., N_{D-1})`` and the block-major layout ``(CR,
nb0, .., nb_{D-1}, B0, .., B_{D-1})`` differ by the block-interleave
transpose.  In the port they pack and unpack the slabs around the
all_to_all transposes of the spatial mode (``parallel/spatial.py``): with
block dims ``(N0l, K1 / n, K2)`` the blocks are ``(CR, 1, n, 1, ..)``, so
the block axis ``nb1`` is the rank.

A wrapper given a CPU tensor runs the plain version, for any dtype; given a
CUDA tensor it launches its kernel or raises.  The kernels take complex64
and complex128, what the transposes move (real-data plans' spectra are
complex too).  D = 1 is a free reshape on every device and launches
nothing.  Each launch adds one to ``LAUNCHES[entry point]``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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


def _launch(direction: str, src: torch.Tensor, dst: torch.Tensor, CR: int,
            grid_shape, block_dims) -> None:
    name = entry_point(direction, src.dtype)
    fn = getattr(build.load(), name)
    n3, b3 = _as_3d(grid_shape, block_dims)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), dst.data_ptr(), CR, *n3, *b3, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _cuda_input(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"no relayout kernel for device {x.device}")
    entry_point("grid", x.dtype)  # raises for a dtype without a kernel
    x = x.contiguous()
    if x.data_ptr() % x.element_size():  # the kernel moves whole elements
        x = x.clone()
    return x


def relayout_to_grid(blocks_major: torch.Tensor, block_dims) -> torch.Tensor:
    """``(CR, nb0, .., nb_{D-1}, B0, .., B_{D-1}) -> (CR, N0, .., N_{D-1})``:
    K8a on a CUDA tensor, the plain version on a CPU one."""
    D = len(block_dims)
    _check_dims(block_dims, blocks_major.shape[1 + D:], "block")
    CR = blocks_major.shape[0]
    grid_shape = tuple(n * b for n, b in zip(blocks_major.shape[1 : 1 + D], block_dims))
    if D == 1:  # block-major is the grid up to a contiguous merge
        return blocks_major.reshape((CR,) + grid_shape)
    if blocks_major.device.type == "cpu":
        return relayout_to_grid_plain(blocks_major, block_dims)
    src = _cuda_input(blocks_major)
    out = torch.empty((CR,) + grid_shape, dtype=src.dtype, device=src.device)
    _launch("grid", src, out, CR, grid_shape, block_dims)
    return out


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
    src = _cuda_input(grid)
    out = torch.empty((CR,) + nb + tuple(block_dims), dtype=src.dtype, device=src.device)
    _launch("blocks", src, out, CR, tuple(grid.shape[1:]), block_dims)
    return out
