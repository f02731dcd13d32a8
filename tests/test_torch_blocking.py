"""Bin sort and block geometry of the PyTorch port: the stable sort's
permutation and per-block point ranges equal the JAX package's packed
layout (``blocking.packed_layout``) for the same block dims."""

import types

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
from nonuniformffts_tpu_torch.ops.windows import cell_scale
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


def set_points_case(rng, case: str, shape_over, block_dims, real) -> np.ndarray:
    """(D, Np) points of one edge case of the set_points kernels:
    ``unfolded`` (negative, beyond 2pi, exact multiples of 2pi / N and of
    2pi), ``empty_ends`` (the first and last blocks hold no point),
    ``one_block`` (every point in one inner block), ``np1`` and ``np0``."""
    D = len(shape_over)
    if case == "np0":
        return np.zeros((D, 0), real)
    if case == "np1":
        return rng.uniform(-7.0, 13.0, (D, 1)).astype(real)
    if case == "unfolded":
        pts = rng.uniform(-3 * np.pi, 5 * np.pi, (D, 600))
        for d, n in enumerate(shape_over):
            k = rng.integers(-2 * n, 3 * n, 200)
            pts[d, :200] = k * (2 * np.pi / n)
        pts[:, 200:204] = np.array([0.0, 2 * np.pi, -2 * np.pi, 4 * np.pi])
        return pts.astype(real)
    lo, hi = [], []
    for n, b in zip(shape_over, block_dims):
        first, last = (b, n - b) if case == "empty_ends" else (b, 2 * b)
        lo.append(first * 2 * np.pi / n)
        hi.append(last * 2 * np.pi / n)
    pts = rng.uniform(np.array(lo)[:, None], np.array(hi)[:, None], (D, 500))
    # Inside [lo, hi) after rounding to the points' type.
    return np.clip(pts, np.array(lo)[:, None] * 1.0001, np.array(hi)[:, None] * 0.9999).astype(real)


def emulate_set_points_kernels(pts: torch.Tensor, shape_over, block_dims):
    """The CUDA set_points kernels' own arithmetic in torch
    (``csrc/bin_sort.cu``): the key of each point from its split (C-style
    remainder, then + N where negative; truncating divisions), the stable
    sort, the cells decoded from the sorted keys, the fractions recomputed
    from the gathered coordinates, and ``pstarts`` by a binary search a
    block over the sorted keys."""
    D, np_ = pts.shape
    nb = blocking.num_blocks(shape_over, block_dims)
    nblocks, cpb = blocking.bin_counts(shape_over, block_dims)
    bid = torch.zeros(np_, dtype=torch.int64)
    lcell = torch.zeros(np_, dtype=torch.int64)
    for d, (n, b) in enumerate(zip(shape_over, block_dims)):
        i = torch.floor(pts[d].to(torch.float64) * cell_scale(n)).to(torch.int64)
        c = torch.fmod(i, n)
        c = torch.where((i >= 0) & (i < n), i, torch.where(c < 0, c + n, c))
        q = torch.div(c, b, rounding_mode="trunc")
        bid = bid * nb[d] + q
        lcell = lcell * b + (c - q * b)
    skeys, perm = torch.sort((bid * cpb + lcell).to(torch.int32), stable=True)
    key = skeys.to(torch.int64)
    sbid = torch.div(key, cpb, rounding_mode="trunc")
    lcell, rest = key - sbid * cpb, sbid
    cells = torch.empty((D, np_), dtype=torch.int32)
    fracs = torch.empty((D, np_), dtype=pts.dtype)
    for d in reversed(range(D)):
        b = block_dims[d]
        ql = torch.div(lcell, b, rounding_mode="trunc")
        qb = torch.div(rest, nb[d], rounding_mode="trunc")
        cells[d] = ((rest - qb * nb[d]) * b + (lcell - ql * b)).to(torch.int32)
        lcell, rest = ql, qb
        r = pts[d][perm].to(torch.float64) * cell_scale(shape_over[d])
        fracs[d] = (r - torch.floor(r)).to(pts.dtype)
    # A binary search a block for its first key, all blocks in step.
    first = torch.arange(nblocks + 1, dtype=torch.int64) * cpb
    lo = torch.zeros(nblocks + 1, dtype=torch.int64)
    hi = torch.full((nblocks + 1,), np_, dtype=torch.int64)
    while bool((lo < hi).any()):
        live = lo < hi
        mid = (lo + hi) // 2
        below = live & (key[mid.clamp(max=max(np_ - 1, 0))] < first)
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(live & ~below, mid, hi)
    return cells, fracs, perm, lo.to(torch.int32)


@pytest.mark.parametrize("case", ["unfolded", "empty_ends", "one_block", "np1", "np0"])
@pytest.mark.parametrize("real", [np.float32, np.float64], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape_over,block_dims", [((96,), (16,)), ((24, 20), (8, 5)),
                                                   ((12, 18, 10), (6, 6, 5))], ids=str)
def test_set_points_kernels_emulated_match_plain_chain(shape_over, block_dims, real, case):
    """The arithmetic of the CUDA set_points kernels (key, sort, decode,
    fractions, pstarts by a binary search a block) equals ``cells_and_fracs`` ->
    ``bin_order`` -> ``sorted_copies`` bit for bit."""
    rng = np.random.default_rng(len(shape_over))
    pts = torch.from_numpy(set_points_case(rng, case, shape_over, block_dims, real))
    kd = [types.SimpleNamespace(n=n) for n in shape_over]
    cells, fracs = blocking.cells_and_fracs(kd, pts)
    perm, pstarts = blocking.bin_order(cells, shape_over, block_dims)
    want = (*blocking.sorted_copies(cells, fracs, perm), perm, pstarts)
    got = emulate_set_points_kernels(pts, shape_over, block_dims)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    counts = torch.diff(pstarts)
    if case in ("empty_ends", "one_block"):
        assert counts[0] == 0 and counts[-1] == 0
    if case == "one_block":
        assert int(counts.max()) == pts.shape[1]


@pytest.mark.parametrize("case", ["unfolded", "empty_ends", "one_block", "np1", "np0"])
@pytest.mark.parametrize("shape_over,block_dims", [((96,), (16,)), ((24, 20), (8, 5)),
                                                   ((12, 18, 10), (6, 6, 5))], ids=str)
def test_block_starts_equal_histogram_prefix_sum(shape_over, block_dims, case):
    """``pstarts`` by a binary search a block over the sorted keys equals
    the prefix sum of the block ids' histogram."""
    rng = np.random.default_rng(7 + len(shape_over))
    pts = torch.from_numpy(set_points_case(rng, case, shape_over, block_dims, np.float64))
    kd = [types.SimpleNamespace(n=n) for n in shape_over]
    cells, _ = blocking.cells_and_fracs(kd, pts)
    skeys, _ = torch.sort(blocking.cell_keys(cells, shape_over, block_dims), stable=True)
    nblocks, _ = blocking.bin_counts(shape_over, block_dims)
    bid = blocking.block_ids_from_cells(cells, shape_over, block_dims)
    want = torch.zeros(nblocks + 1, dtype=torch.int32)
    want[1:] = torch.cumsum(torch.bincount(bid.to(torch.int64), minlength=nblocks), 0)
    got = blocking.block_starts(skeys, shape_over, block_dims)
    assert got.dtype == torch.int32 and torch.equal(got, want)


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
    (``csrc/spread_<D>d.cu:spread_smem_bytes``): 3D (one transform a CTA)
    holds two buffers (``spread3d_buffers``) of a batch of 64 points' dense
    operands (A's rows rounded to the MMA tile, pd1 y rows and pd2 rounded
    to 8 z rows, 68 doubles a row), the copies of the next batch's point
    state a slot (a point and a task: four tasks with a coefficient stack,
    whose two x tasks each take the value, each task a fraction and an
    int32 cell; three without, each task 2M taps and a cell, the x task the
    value) and the coefficient stack; 2D stages 8 warps' unit rows (32 A
    rows and 32 B rows of 20 doubles each), whatever the block dims, and two
    dims' coefficients, the first rounded up to 16 bytes past a multiple of
    128 (``spread2d_coef_stride``); 1D holds the coefficients in rows of
    whole 16 bytes, each warp's carry of 2M - 1 padded cells in double and
    an int32 start table of B + 1 entries, so a long 1D block is refused.
    A window without a coefficient stack (ncoef = 0) stages none."""
    # (8, 8, 12), m = 4, complex: 32 A rows, 15 y rows, 24 z rows.
    assert spread_smem_bytes((8, 8, 12), 4, 8, 4, 2) == (
        2 * 8 * 68 * (32 + 15 + 24) + 64 * (2 * 8 + 4 * 4 + 4 * 4) + 4 * 24 * 8)
    assert spread_smem_bytes((12, 12, 16), 4, 8, 8, 2) == (
        2 * 8 * 68 * (48 + 19 + 24) + 64 * (2 * 16 + 4 * 8 + 4 * 4) + 8 * 24 * 8)
    assert spread_smem_bytes((8, 8, 8), 10, 0, 8, 1) == (
        2 * 8 * 68 * (32 + 27 + 32) + 64 * (8 + 3 * 20 * 8 + 3 * 4))
    # 8 warps whose two buffers would not fit beside the two CTAs an SM
    # holds: one buffer.
    assert spread_smem_bytes((50, 1, 1), 4, 8, 4, 2) == (
        8 * 68 * (128 + 8 + 8) + 64 * (2 * 8 + 4 * 4 + 4 * 4) + 4 * 24 * 8)
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
