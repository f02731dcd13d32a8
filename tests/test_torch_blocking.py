"""Bin sort and block geometry of the PyTorch port: the stable sort's
permutation and per-block point ranges equal the JAX package's packed
layout (``blocking.packed_layout``) for the same block dims."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.blocking import packed_layout
from nonuniformffts_tpu_torch import blocking
from nonuniformffts_tpu_torch.ops.kernels.common import (
    MAX_SMEM_BYTES,
    NUM_SMS,
    SM_SMEM_BYTES,
    SMEM_RESERVED_PER_CTA,
    SPREAD2D_UNIT_COL_TILES,
    SPREAD2D_UNIT_ROWS,
    SPREAD3D_MAX_WARPS,
    VALUE_TYPES,
    spread2d_coef_stride,
    spread2d_units,
    spread_ctas_per_sm,
    spread_smem_bytes,
    spread_tiles,
)
from torch_port_utils import random_points

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize(
    "shape,block_dims",
    [((16, 16, 16), (8, 4, 12)), ((16, 12, 20), (6, 18, 10)), ((20, 24), (5, 12))],
)
def test_sort_matches_packed_layout(dtype, shape, block_dims):
    rng = np.random.default_rng(11)
    np_ = 700
    # Unfolded coordinates: the cell split folds them.
    pts = random_points(rng, len(shape), np_, dtype, lo=-2 * np.pi, hi=4 * np.pi)
    pts[:, :5] = np.float32(2 * np.pi)  # ties on the bin key
    jp = jnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5)
    tp = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, spread_method="blocked",
                          block_dims=block_dims, device="cpu")
    out = packed_layout(jp.kernel_data, block_dims, jnp.asarray(pts), 128)
    tp = tnufft.set_points(tp, pts)
    np.testing.assert_array_equal(tp.sort_perm.numpy(), np.asarray(out[5])[:np_])
    np.testing.assert_array_equal(tp.pstarts.numpy(), np.asarray(out[1]))
    assert tp.sort_perm.dtype == torch.int64 and tp.pstarts.dtype == torch.int32

    # Sorted cells and fractions are the unsorted ones permuted, and every
    # block's range holds exactly its own points.
    cells, fracs = blocking.cells_and_fracs(tp.kernel_data, torch.from_numpy(pts))
    np.testing.assert_array_equal(tp.cells_sorted.numpy(), cells[:, tp.sort_perm].numpy())
    np.testing.assert_array_equal(tp.fracs_sorted.numpy(), fracs[:, tp.sort_perm].numpy())
    bid = blocking.block_ids_from_cells(tp.cells_sorted, tp.shape_over, block_dims)
    nb = blocking.num_blocks(tp.shape_over, block_dims)
    want = np.ravel_multi_index(
        tuple(tp.cells_sorted.numpy()[d] // block_dims[d] for d in range(len(nb))), nb
    )
    np.testing.assert_array_equal(bid.numpy(), want)
    ps = tp.pstarts.numpy()
    for b in range(len(ps) - 1):
        assert (want[ps[b]:ps[b + 1]] == b).all()


@pytest.mark.parametrize("shape_over,m", [((384, 384, 384), 4), ((96, 96, 96), 4),
                                          ((384, 384, 384), 8), ((30, 45, 60), 2)])
def test_choose_geometry_fits_hopper(shape_over, m):
    bd = blocking.choose_geometry(shape_over, m)
    assert len(bd) == len(shape_over)
    assert all(n % b == 0 for n, b in zip(shape_over, bd))
    assert spread_smem_bytes(bd, m, m + 4) <= MAX_SMEM_BYTES
    nblocks = int(np.prod(blocking.num_blocks(shape_over, bd)))
    if int(np.prod(shape_over)) >= 2 * NUM_SMS * 4096:
        assert nblocks >= 2 * NUM_SMS


def test_main_path_geometry():
    """At the benchmark point (grid 384^3, m = 4, complex64) the 3D spread
    kernel holds the whole padded block in the registers of one pass of at
    most 16 warps, at least two of its CTAs fit an SM's register file and
    shared memory, and its dense product stays within 8x the 1,024 useful
    FMAs a point at a halo ratio below 10."""
    bd = blocking.choose_geometry((384, 384, 384), 4)
    t = spread_tiles(bd, 4, 2)
    assert t.passes == 1 and t.warps <= SPREAD3D_MAX_WARPS
    smem = spread_smem_bytes(bd, 4, 8)
    assert spread_ctas_per_sm(4, 2, 4, 3, 32 * t.warps) >= 2
    assert SM_SMEM_BYTES // (smem + SMEM_RESERVED_PER_CTA) >= 2
    assert t.dense_fmas <= 8 * 2 * 8 ** 3
    assert np.prod(t.padded) / np.prod(bd) < 10


@pytest.mark.parametrize(
    "block_dims,m,ncomp,want",
    [((8, 16), 4, 2, (2, 3, 1, 1)), ((8, 24), 4, 2, (2, 4, 1, 1)), ((16, 16), 4, 2, (3, 3, 1, 2)),
     ((24, 24), 4, 1, (2, 4, 1, 1)), ((8, 8), 10, 2, (4, 4, 1, 2)),
     ((48, 64), 4, 2, (7, 9, 3, 12)), ((32, 32), 10, 1, (4, 7, 2, 4))],
    ids=str,
)
def test_spread2d_units(block_dims, m, ncomp, want):
    """The 2D spread kernel's units (``csrc/spread_2d.cu:units_of``): row
    tiles of 16 over NCOMP pd0 rows, n-tiles of 8 over pd1 columns, units of
    two row tiles x four n-tiles, walked one after another.  The main
    path's complex blocks are one unit; (48, 64), the shared-memory
    kernel's complex pick, would be 12."""
    u = spread2d_units(block_dims, m, ncomp)
    assert (u.row_tiles, u.col_tiles, u.col_groups, u.units) == want
    assert u.padded == tuple(b + 2 * m - 1 for b in block_dims)
    assert u.rows >= ncomp * u.padded[0] and u.cols >= u.padded[1]
    tiles = [u.unit_tiles(k) for k in range(u.units)]
    # The units cover every tile once.
    assert sum(nr * nc for _, _, nr, nc in tiles) == u.row_tiles * u.col_tiles
    assert all(nr * 16 <= SPREAD2D_UNIT_ROWS and nc <= SPREAD2D_UNIT_COL_TILES
               for _, _, nr, nc in tiles)


def test_2d_main_path_picks_one_unit():
    """At the 2D main path's grid 6144^2, m = 4, every dtype's pick is one
    unit, so the kernel walks each block's points once.  The 3D float32
    pick at grid 384^3 is the 3D cost model's, one pass."""
    for dtype in VALUE_TYPES:
        _, sb, ncomp = VALUE_TYPES[dtype]
        bd = blocking.choose_geometry((6144, 6144), 4, sb, ncomp)
        assert spread2d_units(bd, 4, ncomp).units == 1
    bd = blocking.choose_geometry((384, 384, 384), 4, 4, 1)
    assert bd == (24, 8, 8)
    assert spread_tiles(bd, 4, 1).passes == 1


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("shape_over", [(6144, 6144), (1_572_864,)], ids=str)
def test_lowdim_main_path_geometry(shape_over, dtype):
    """The 2D (N = 4096^2) and 1D (N = 2^20) main paths' grids: each block
    dim divides its grid dim, the spread CTA fits shared memory, the grid
    makes at least two blocks per SM, and a 1D block is far longer than the
    2D/3D candidates' 128 cells."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    bd = blocking.choose_geometry(shape_over, 4, sb, ncomp)
    assert len(bd) == len(shape_over)
    assert all(n % b == 0 for n, b in zip(shape_over, bd))
    assert spread_smem_bytes(bd, 4, 8, sb, ncomp) <= MAX_SMEM_BYTES
    assert int(np.prod(blocking.num_blocks(shape_over, bd))) >= 2 * NUM_SMS
    if len(shape_over) == 1:
        assert bd == (512,) and bd[0] > 128
        assert int(np.prod(blocking.num_blocks(shape_over, bd))) >= 16 * NUM_SMS


def test_spread_smem_bytes_by_dimension():
    """The shared-memory footprint the spread sources allocate
    (``csrc/spread_<D>d.cu:spread_smem_bytes``): 3D stages the dense
    operands of a batch of 64 points (A's rows rounded to the MMA tile, pd1
    y rows and pd2 rounded to 8 z rows, 68 doubles a row), the batch's
    compact 3 x 2M taps and values in double, three int32 cells a point and
    the coefficient stack; 2D stages 8 warps' unit rows (32 A rows and 32 B
    rows of 20 doubles each), whatever the block dims, and two dims'
    coefficients, the first rounded up to 16 bytes past a multiple of 128
    (``spread2d_coef_stride``); 1D holds the coefficients in rows of whole
    16 bytes, each warp's carry of 2M - 1 padded cells in double and an
    int32 start table of B + 1 entries, so a long 1D block is refused.  A
    window without a coefficient stack (ncoef = 0) stages none."""
    cells = 4 * 3 * 64
    # (8, 8, 12), m = 4, complex: 32 A rows, 15 y rows, 24 z rows.
    assert spread_smem_bytes((8, 8, 12), 4, 8, 4, 2) == (
        8 * (68 * (32 + 15 + 24) + (24 + 2) * 64) + cells + 4 * 24 * 8)
    assert spread_smem_bytes((12, 12, 16), 4, 8, 8, 2) == (
        8 * (68 * (48 + 19 + 24) + (24 + 2) * 64) + cells + 8 * 24 * 8)
    assert spread_smem_bytes((8, 8, 8), 10, 0, 8, 1) == (
        8 * (68 * (32 + 27 + 32) + (60 + 1) * 64) + cells)
    rows = 8 * 8 * 64 * 20
    # m = 4: 64 coefficients a dim, 256 B of float (-> 272) or 512 B of
    # double (-> 528); m = 10, ncoef 14: 280 doubles, 2,240 B (-> 2,320).
    assert spread2d_coef_stride(4, 8, 4) == 68 and spread2d_coef_stride(4, 8, 8) == 66
    assert spread_smem_bytes((48, 96), 4, 8, 4, 2) == rows + 4 * (68 + 64)
    assert spread_smem_bytes((48, 96), 4, 8, 8, 1) == rows + 8 * (66 + 64)
    assert spread_smem_bytes((48, 96), 4, 0, 8, 1) == rows + 16
    assert spread_smem_bytes((128, 128), 10, 14, 8, 2) == rows + 8 * (290 + 280) <= MAX_SMEM_BYTES
    assert spread_smem_bytes((8, 16), 4, 8, 4, 2) == spread_smem_bytes((48, 96), 4, 8, 4, 1)
    # 1D: the coefficients in rows of whole 16 bytes (m = 5 in float: 12 of
    # 10 taps), each of the 8 warps' carry, 2M - 1 padded cells of ncomp
    # doubles.
    assert spread_smem_bytes((1024,), 4, 8, 4, 2) == 4 * 8 * 8 + 8 * 8 * 7 * 2 + 4 * 1025
    assert spread_smem_bytes((1024,), 5, 9, 4, 1) == 4 * 12 * 9 + 8 * 8 * 9 + 4 * 1025
    assert spread_smem_bytes((1024,), 8, 12, 8, 1) == 8 * 16 * 12 + 8 * 8 * 15 + 4 * 1025
    assert spread_smem_bytes((1024,), 10, 0, 8, 2) == 8 * 8 * 19 * 2 + 4 * 1025
    assert spread_smem_bytes((65536,), 4, 8, 4, 2) > MAX_SMEM_BYTES
