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
    ACC_BYTES,
    MAX_SMEM_BYTES,
    NUM_SMS,
    SM_SMEM_BYTES,
    SMEM_RESERVED_PER_CTA,
    SPREAD3D_MAX_WARPS,
    VALUE_TYPES,
    spread_bank_conflicts,
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
    "pd_last,m,scalar_bytes,want",
    [(23, 4, 4, 2), (31, 4, 4, 4), (19, 4, 4, 2), (40, 4, 4, 1), (31, 4, 8, 2),
     (23, 4, 8, 2), (23, 2, 4, 1)],
)
def test_spread_bank_conflicts(pd_last, m, scalar_bytes, want):
    """Lanes of a warp on one shared-memory bank in the spread kernel's tap
    loop: lane q writes word (q // 2M) * pd_last + q % 2M."""
    assert spread_bank_conflicts(pd_last, m, scalar_bytes) == want


def test_float32_geometry_avoids_four_way_conflicts():
    """The 2D spread kernel's tap loop (shared-memory adds, each a
    compare-and-swap loop) stays at two lanes a bank of the double
    accumulator for the float32 and complex64 picks at the 2D main path's
    grid 6144^2, m = 4; with float words a last block dim of 24 (padded 31)
    put four there (a 3D kernel of that design ran 1.8-3x slower, PERF.md).
    The 3D kernel has no such loop: its float32 pick at grid 384^3 is the
    cost model's, one pass."""
    for ncomp in (1, 2):
        bd = blocking.choose_geometry((6144, 6144), 4, 4, ncomp)
        assert spread_bank_conflicts(bd[-1] + 7, 4, ACC_BYTES) == 2
    assert spread_bank_conflicts(31, 4, 4) == 4
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
    the coefficient stack; 2D holds double accumulator planes over the
    padded block, the coefficient stack and 16 warps' D x 2M taps; 1D holds
    the coefficients and an int32 start table of B + 1 entries.  A window
    without a coefficient stack (ncoef = 0) stages none."""
    cells = 4 * 3 * 64
    # (8, 8, 12), m = 4, complex: 32 A rows, 15 y rows, 24 z rows.
    assert spread_smem_bytes((8, 8, 12), 4, 8, 4, 2) == (
        8 * (68 * (32 + 15 + 24) + (24 + 2) * 64) + cells + 4 * 24 * 8)
    assert spread_smem_bytes((12, 12, 16), 4, 8, 8, 2) == (
        8 * (68 * (48 + 19 + 24) + (24 + 2) * 64) + cells + 8 * 24 * 8)
    assert spread_smem_bytes((8, 8, 8), 10, 0, 8, 1) == (
        8 * (68 * (32 + 27 + 32) + (60 + 1) * 64) + cells)
    assert spread_smem_bytes((48, 96), 4, 8, 4, 2) == 8 * 2 * 55 * 103 + 4 * (16 * 8 + 16 * 16)
    assert spread_smem_bytes((48, 96), 4, 8, 8, 1) == 8 * 55 * 103 + 8 * (16 * 8 + 16 * 16)
    assert spread_smem_bytes((48, 96), 4, 0, 8, 1) == 8 * 55 * 103 + 8 * 16 * 16
    assert spread_smem_bytes((1024,), 4, 8, 4, 2) == 4 * 8 * 8 + 4 * 1025
    assert spread_smem_bytes((1024,), 8, 12, 8, 1) == 8 * 16 * 12 + 4 * 1025
    assert spread_smem_bytes((1024,), 10, 0, 8, 2) == 4 * 1025
