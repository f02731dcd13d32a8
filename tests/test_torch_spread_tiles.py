"""The 2D and 3D spread kernels' decompositions (``csrc/spread_2d.cu``,
``csrc/spread_3d.cu``), emulated on the CPU in float64, and the 2D and 3D
block geometry choosers built on them.

The emulations follow the kernels' arithmetic with the shared geometry
(``ops/kernels/common.py:spread2d_units``, ``spread_tiles``): each block's
dense A (value times x tap, rows (i, k)) and B (the y tap, in 3D times the
z tap; columns padded to whole n-tiles) from the plain taps, one
``torch.matmul`` per unit (in 2D per unit and batch of points), and a flush
of each unit with periodic wrap.  Each grid must equal the plain version
(``spread_blocked_plain``) to 1e-12, and once the JAX package's reference
spread.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.ops.spreading import spread_reference as j_spread
from nonuniformffts_tpu_torch import blocking
from nonuniformffts_tpu_torch.ops.kernels import blocked
from nonuniformffts_tpu_torch.ops.kernels.common import (
    MAX_SMEM_BYTES,
    NUM_SMS,
    SM_REGISTERS,
    SM_SMEM_BYTES,
    SMEM_RESERVED_PER_CTA,
    SPREAD2D_BATCH,
    SPREAD3D_CTA_GRID_BYTES,
    SPREAD3D_MAX_REGISTERS,
    SPREAD3D_MAX_WARPS,
    SPREAD3D_STRIDE,
    SPREAD3D_UNIT_COL_TILES,
    SPREAD3D_UNIT_ROWS,
    VALUE_TYPES,
    spread2d_units,
    spread3d_cta_transforms,
    spread_registers,
    spread_smem_bytes,
    spread_tiles,
)
from torch_port_utils import random_complex, random_points, rel_err

torch.set_num_threads(1)


def _wrap(i: torch.Tensor, n: int) -> torch.Tensor:
    return torch.remainder(i, n)


def emulate_spread_3d(plan, vp: torch.Tensor) -> torch.Tensor:
    """The 3D spread kernel's decomposition in float64 on the CPU.  ``vp``
    (C, Np) in original point order; returns the grid ``(C,) +
    shape_over`` in the plan's dtype."""
    m, S = plan.m, 2 * plan.m
    ncomp = 2 if plan.dtype.is_complex else 1
    bd = plan.block_dims
    t = spread_tiles(bd, m, ncomp)
    pd0, pd1, pd2 = t.padded
    zrow = t.z_tiles * 8  # columns of one padded z row
    taps = blocked.window_weights_blocked_plain(plan).to(torch.float64)  # (3, S, Np)
    vals = vp[:, plan.sort_perm]
    vals = (torch.view_as_real(vals.to(torch.complex128)) if ncomp == 2
            else vals.to(torch.float64)[..., None])  # (C, Np, ncomp)
    C = vals.shape[0]
    n = plan.shape_over
    grid = torch.zeros((C, n[0] * n[1] * n[2], ncomp), dtype=torch.float64)
    nb = blocking.num_blocks(n, bd)
    ps = plan.pstarts.tolist()
    cells = plan.cells_sorted.to(torch.int64)

    rows = torch.arange(t.rows)
    ri, rk = rows // ncomp, rows % ncomp
    cols = torch.arange(t.cols)
    cj, cl = cols // zrow, cols % zrow
    col_groups = -(-t.col_tiles // SPREAD3D_UNIT_COL_TILES)
    for bid in range(len(ps) - 1):
        p0, p1 = ps[bid], ps[bid + 1]
        if p0 == p1:
            continue
        o = torch.tensor(np.unravel_index(bid, nb)) * torch.tensor(bd)
        lc = cells[:, p0:p1] - o[:, None]  # (3, P) cells relative to the origin
        tx, ty, tz = (taps[d][:, p0:p1] for d in range(3))  # (S, P)
        di = ri[:, None] - lc[0][None, :]  # (rows, P)
        wx = torch.where((di >= 0) & (di < S), tx.gather(0, di.clamp(0, S - 1)), 0.0)
        A = wx[None] * vals[:, p0:p1, :].permute(0, 2, 1)[:, rk, :]  # (C, rows, P)
        dj = cj[None, :] - lc[1][:, None]  # (P, cols)
        dl = cl[None, :] - lc[2][:, None]
        ok = (dj >= 0) & (dj < S) & (dl >= 0) & (dl < S)
        B = torch.where(ok, ty.T.gather(1, dj.clamp(0, S - 1)) * tz.T.gather(1, dl.clamp(0, S - 1)),
                        0.0)  # (P, cols)
        for unit in range(t.units):
            rg, cg = divmod(unit, col_groups)
            r0, c0 = rg * SPREAD3D_UNIT_ROWS, cg * SPREAD3D_UNIT_COL_TILES * 8
            r1 = min(r0 + SPREAD3D_UNIT_ROWS, t.rows)
            c1 = min(c0 + SPREAD3D_UNIT_COL_TILES * 8, t.cols)
            if r0 >= r1 or c0 >= c1:
                continue
            G = torch.matmul(A[:, r0:r1], B[:, c0:c1])  # (C, r, c)
            i, k = ri[r0:r1], rk[r0:r1]
            j, l = cj[c0:c1], cl[c0:c1]
            keep = (i < pd0)[:, None] & (l < pd2)[None, :]
            gx = _wrap(o[0] - (m - 1) + i, n[0])[:, None]
            gy = _wrap(o[1] - (m - 1) + j, n[1])[None, :]
            gz = _wrap(o[2] - (m - 1) + l, n[2])[None, :]
            flat = ((gx * n[1] + gy) * n[2] + gz).expand_as(keep)[keep]
            comp = k[:, None].expand_as(keep)[keep]
            for c in range(C):
                grid[c].index_put_((flat, comp), G[c][keep], accumulate=True)
    grid = grid.reshape((C,) + tuple(n) + (ncomp,))
    if ncomp == 2:
        return torch.view_as_complex(grid).to(plan.dtype)
    return grid[..., 0].to(plan.dtype)


# (shape, sigma, m, block_dims, transforms): the main path's blocks cut to a
# small grid, ragged tiles (pd0 = 12, pd2 = 13; odd n2), M = 2 and 10 (the
# latter several passes of 16 warps), and a spatial rank's slab, whose
# planes are padded to a multiple of 8 (``parallel/spatial.py``).
TILE_CASES = {
    "main_888": ((32, 32, 32), 1.5, 4, (8, 8, 8), 1),
    "ragged": ((20, 24, 16), 1.5, 4, (5, 4, 6), 2),
    "odd_n2": ((20, 16, 18), 1.5, 4, (5, 6, 3), 1),
    "m2": ((16, 16, 16), 2.0, 2, (4, 4, 4), 1),
    "m10": ((16, 16, 16), 2.0, 10, (8, 8, 8), 1),
    "slab": ((16, 16, 16), 1.5, 4, None, 1),
}


def _tile_plan(case, dtype, np_=900, seed=0):
    shape, sigma, m, bd, C = TILE_CASES[case]
    rng = np.random.default_rng(seed)
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=bd, device="cpu")
    if case == "slab":
        # A rank of 4 at n0 = 24 holds 6 planes plus 2M - 1 of halo: 13,
        # padded to 16, as SpatialNUFFT's slab plan.
        ext = (16,) + plan.shape_over[1:]
        kd0 = dataclasses.replace(plan.kernel_data[0], n=ext[0])
        plan = dataclasses.replace(
            plan, shape_over=ext, kernel_data=(kd0,) + plan.kernel_data[1:],
            block_dims=blocking.choose_geometry(ext, m, *VALUE_TYPES[plan.dtype][1:]))
    pts = random_points(rng, 3, np_, dtype, lo=-1.0, hi=7.0)
    pts[:, :4] = np.float64(2 * np.pi) - 1e-9  # the grid's top edge
    plan = tnufft.set_points(plan, pts)
    v = random_complex(rng, np.complex128, (C, np_))
    if not plan.dtype.is_complex:
        v = v.real.copy()
    return plan, pts, torch.from_numpy(v).to(plan.dtype)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64], ids=str)
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_emulated_tiles_match_plain_spread(case, dtype):
    plan, _, vp = _tile_plan(case, dtype)
    got = emulate_spread_3d(plan, vp)
    want = blocked.spread_blocked_plain(plan, vp)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got.numpy(), want.numpy()) <= 1e-12


def test_emulated_tiles_match_jax_spread():
    """The decomposition against the JAX package's reference spread (its
    CPU path) on the same points and values, complex128."""
    plan, pts, vp = _tile_plan("ragged", np.complex128, seed=3)
    jp = jnufft.PlanNUFFT(np.complex128, TILE_CASES["ragged"][0], m=4, sigma=1.5,
                          ntransforms=2)
    assert tuple(jp.shape_over) == plan.shape_over
    want = j_spread(jp.kernel_data, jp.evalmode, jp.shape_over, jnp.asarray(pts),
                    jnp.asarray(vp.numpy()))
    got = emulate_spread_3d(plan, vp)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("m", [2, 4, 6, 8, 10])
def test_3d_chooser_picks_fit_the_kernel(dtype, m):
    """Every 3D pick at grid 384^3 divides the grid, fits shared memory,
    fits the register file with at least one CTA an SM, runs at most
    SPREAD3D_MAX_WARPS warps a CTA, and yields at least 2 x 132 blocks."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    bd = blocking.choose_geometry((384, 384, 384), m, sb, ncomp)
    assert all(384 % b == 0 for b in bd)
    assert spread_smem_bytes(bd, m, m + 4, sb, ncomp) <= MAX_SMEM_BYTES
    t = spread_tiles(bd, m, ncomp)
    assert 1 <= t.warps <= SPREAD3D_MAX_WARPS
    assert t.warps * t.passes >= t.units
    assert spread_registers(sb, ncomp, m, 3) * 32 * t.warps <= SM_REGISTERS
    assert int(np.prod(blocking.num_blocks((384,) * 3, bd))) >= 2 * NUM_SMS


def test_3d_chooser_is_the_cost_models_minimum():
    """At the main path (complex64, m = 4, grid 384^3) the pick has the
    least modelled cost among the candidates with at least 2 x 132 blocks,
    and the main path takes one pass of at most 16 warps."""
    bd = blocking.choose_geometry((384, 384, 384), 4, 4, 2)
    best = blocking.spread3d_cost(bd, 4, 2)
    divs = [b for b in range(1, blocking.MAX_BLOCK_3D + 1) if 384 % b == 0]
    for dims in [(a, b, c) for a in divs for b in divs for c in divs]:
        if 384 ** 3 // (dims[0] * dims[1] * dims[2]) >= 2 * NUM_SMS:
            assert blocking.spread3d_cost(dims, 4, 2) >= best
    assert spread_tiles(bd, 4, 2).passes == 1


def test_3d_shared_staging_at_the_32_coil_plan():
    """The 32-coil cell's plan (complex64, 256^3, m = 4, sigma = 1.5, BKB
    Fast, 32 transforms): a launch of one transform runs the per-transform
    kernel at the bytes it had before the shared-staging kernel came
    (49,120); one of 32 runs the shared-staging kernel, two CTAs a block of
    16 transforms each, whose values it stages at once in 56,800 B, room
    for the 2 CTAs an SM that its 8 warps at 128 registers allow.  At the
    other dtypes' main-path blocks a CTA serves 16 (float32) or 8 (64-bit)
    transforms."""
    plan = tnufft.PlanNUFFT(np.complex64, (256,) * 3, m=4, sigma=1.5, ntransforms=32,
                            spread_method="blocked", device="cpu")
    bd, (_, ncoef) = plan.block_dims, blocked.kernel_coefs(plan)
    assert plan.shape_over == (384,) * 3 and bd == (8, 8, 8) and ncoef == 8
    assert spread_tiles(bd, 4, 2).warps == 8 and SPREAD3D_MAX_REGISTERS == 128
    assert spread3d_cta_transforms(bd, 4, ncoef, 4, 2, 1) == 1
    assert spread_smem_bytes(bd, 4, ncoef, 4, 2) == spread_smem_bytes(bd, 4, ncoef, 4, 2, 1)
    assert spread_smem_bytes(bd, 4, ncoef, 4, 2, 1) == 49_120
    assert spread3d_cta_transforms(bd, 4, ncoef, 4, 2, 32) == 16
    assert spread_smem_bytes(bd, 4, ncoef, 4, 2, 32) == 56_800
    assert SM_SMEM_BYTES // (56_800 + SMEM_RESERVED_PER_CTA) >= 2
    blocked.check_kernel_support(plan)
    for dtype, cta in ((np.float32, 16), (np.complex128, 8), (np.float64, 8)):
        _, sb, ncomp = VALUE_TYPES[torch.from_numpy(np.zeros(1, dtype)).dtype]
        pick = blocking.choose_geometry((384,) * 3, 4, sb, ncomp)
        assert spread3d_cta_transforms(pick, 4, ncoef, sb, ncomp, 32) == cta


@pytest.mark.parametrize("nchan", [2, 3, 32, 1000])
@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("m", [2, 4, 8, 10])
def test_3d_shared_staging_keeps_the_register_bound_residency(m, dtype, nchan):
    """At every 3D pick (grid 384^3) a launch of ``nchan`` > 1 transforms
    gives each CTA as many of them as keep their padded blocks within
    SPREAD3D_CTA_GRID_BYTES and their values within its shared memory (one:
    the per-transform kernel, at its bytes): its bytes stay within what one
    CTA may take and leave an SM the CTAs its register file allows at 128
    registers a thread, and one transform more would break a limit where
    not all ``nchan`` are served."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    bd = blocking.choose_geometry((384, 384, 384), m, sb, ncomp)
    t = spread_tiles(bd, m, ncomp)
    block = sb * ncomp * int(np.prod(t.padded))
    ctas = max(1, SM_REGISTERS // (SPREAD3D_MAX_REGISTERS * 32 * t.warps))
    cta = spread3d_cta_transforms(bd, m, m + 4, sb, ncomp, nchan)
    smem = spread_smem_bytes(bd, m, m + 4, sb, ncomp, nchan)
    assert 1 <= cta <= nchan
    if cta == 1:
        assert smem == spread_smem_bytes(bd, m, m + 4, sb, ncomp)
        return
    assert cta * block <= SPREAD3D_CTA_GRID_BYTES and smem <= MAX_SMEM_BYTES
    assert SM_SMEM_BYTES // (smem + SMEM_RESERVED_PER_CTA) >= ctas
    if cta < nchan:
        more = smem + 8 * SPREAD3D_STRIDE * ncomp
        assert ((cta + 1) * block > SPREAD3D_CTA_GRID_BYTES or more > MAX_SMEM_BYTES
                or SM_SMEM_BYTES // (more + SMEM_RESERVED_PER_CTA) < ctas)


def emulate_spread_2d(plan, vp: torch.Tensor) -> torch.Tensor:
    """The 2D spread kernel's decomposition in float64 on the CPU: for each
    non-empty block, each unit (``spread2d_units``) and each batch of
    ``SPREAD2D_BATCH`` points, the unit's rows of A and columns of B and
    their product into the unit's sum; then the unit's flush with periodic
    wrap.  ``vp`` (C, Np) in original point order; returns the grid ``(C,)
    + shape_over`` in the plan's dtype."""
    m, S = plan.m, 2 * plan.m
    ncomp = 2 if plan.dtype.is_complex else 1
    bd = plan.block_dims
    u = spread2d_units(bd, m, ncomp)
    pd0, pd1 = u.padded
    taps = blocked.window_weights_blocked_plain(plan).to(torch.float64)  # (2, S, Np)
    vals = vp[:, plan.sort_perm]
    vals = (torch.view_as_real(vals.to(torch.complex128)) if ncomp == 2
            else vals.to(torch.float64)[..., None])  # (C, Np, ncomp)
    C = vals.shape[0]
    n = plan.shape_over
    grid = torch.zeros((C, n[0] * n[1], ncomp), dtype=torch.float64)
    nb = blocking.num_blocks(n, bd)
    ps = plan.pstarts.tolist()
    cells = plan.cells_sorted.to(torch.int64)
    for bid in range(len(ps) - 1):
        p0, p1 = ps[bid], ps[bid + 1]
        if p0 == p1:
            continue
        o = torch.tensor(np.unravel_index(bid, nb)) * torch.tensor(bd)
        for unit in range(u.units):
            rt0, ct0, nr, nc = u.unit_tiles(unit)
            rows = 16 * rt0 + torch.arange(16 * nr)
            ri, rk = rows // ncomp, rows % ncomp
            cols = 8 * ct0 + torch.arange(8 * nc)
            G = torch.zeros((C, len(rows), len(cols)), dtype=torch.float64)
            for b0 in range(p0, p1, SPREAD2D_BATCH):
                b1 = min(b0 + SPREAD2D_BATCH, p1)
                lx = cells[0, b0:b1] - o[0]
                ly = cells[1, b0:b1] - o[1]
                tx, ty = taps[0][:, b0:b1], taps[1][:, b0:b1]  # (S, P)
                di = ri[:, None] - lx[None, :]  # (rows, P)
                wx = torch.where((di >= 0) & (di < S), tx.gather(0, di.clamp(0, S - 1)), 0.0)
                A = wx[None] * vals[:, b0:b1, :].permute(0, 2, 1)[:, rk, :]  # (C, rows, P)
                dj = cols[None, :] - ly[:, None]  # (P, cols)
                B = torch.where((dj >= 0) & (dj < S), ty.T.gather(1, dj.clamp(0, S - 1)), 0.0)
                G += torch.matmul(A, B)
            keep = (ri < pd0)[:, None] & (cols < pd1)[None, :]
            gx = _wrap(o[0] - (m - 1) + ri, n[0])[:, None]
            gy = _wrap(o[1] - (m - 1) + cols, n[1])[None, :]
            flat = (gx * n[1] + gy).expand_as(keep)[keep]
            comp = rk[:, None].expand_as(keep)[keep]
            for c in range(C):
                grid[c].index_put_((flat, comp), G[c][keep], accumulate=True)
    grid = grid.reshape((C,) + tuple(n) + (ncomp,))
    if ncomp == 2:
        return torch.view_as_complex(grid).to(plan.dtype)
    return grid[..., 0].to(plan.dtype)


# (shape, sigma, m, block_dims, transforms, points): the main path's complex
# block cut to a small grid (one unit), M = 2, 4, 8, 10, blocks of several
# units (m = 8 complex: two row groups; (16, 48): two column groups), a grid
# smaller than the padded block (one 32 x 32 block at m = 10, padded 51),
# sparse blocks (40 points over 36 blocks), ragged blocks with three
# transforms, and the 2D slab of a spatial rank.
UNIT_CASES_2D = {
    "main_8x16": ((32, 32), 1.5, 4, (8, 16), 1, 900),
    "m2": ((16, 16), 2.0, 2, (4, 8), 1, 900),
    "m8_units": ((16, 16), 2.0, 8, (8, 8), 1, 900),
    "multi_unit": ((32, 32), 1.5, 4, (16, 48), 1, 900),
    "m10_grid_below_block": ((16, 16), 2.0, 10, (32, 32), 1, 900),
    "sparse": ((32, 32), 1.5, 4, (8, 8), 1, 40),
    "three_transforms": ((20, 24), 1.5, 4, (5, 12), 3, 900),
    "slab": ((16, 24), 1.5, 4, None, 1, 900),
}


def _unit_plan(case, dtype, seed=0):
    shape, sigma, m, bd, C, np_ = UNIT_CASES_2D[case]
    rng = np.random.default_rng(seed)
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=bd, device="cpu")
    if case == "slab":
        # A rank of 4 at n0 = 24 holds 6 rows plus 2M - 1 of halo: 13,
        # padded to 16, as SpatialNUFFT's slab plan.
        ext = (16,) + plan.shape_over[1:]
        kd0 = dataclasses.replace(plan.kernel_data[0], n=ext[0])
        plan = dataclasses.replace(
            plan, shape_over=ext, kernel_data=(kd0,) + plan.kernel_data[1:],
            block_dims=blocking.choose_geometry(ext, m, *VALUE_TYPES[plan.dtype][1:]))
    pts = random_points(rng, 2, np_, dtype, lo=-1.0, hi=7.0)
    pts[:, :4] = np.float64(2 * np.pi) - 1e-9  # the grid's top edge
    plan = tnufft.set_points(plan, pts)
    v = random_complex(rng, np.complex128, (C, np_))
    if not plan.dtype.is_complex:
        v = v.real.copy()
    return plan, pts, torch.from_numpy(v).to(plan.dtype)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64], ids=str)
@pytest.mark.parametrize("case", list(UNIT_CASES_2D))
def test_emulated_2d_units_match_plain_spread(case, dtype):
    plan, _, vp = _unit_plan(case, dtype)
    u = spread2d_units(plan.block_dims, plan.m, 2 if plan.dtype.is_complex else 1)
    if case in ("m8_units", "multi_unit") and plan.dtype.is_complex:
        assert u.units > 1
    if case == "m10_grid_below_block":
        assert all(p > n for p, n in zip(u.padded, plan.shape_over))
    if case == "sparse":
        counts = plan.pstarts[1:] - plan.pstarts[:-1]
        assert int((counts == 0).sum()) > 0 and int(counts.max()) < SPREAD2D_BATCH
    got = emulate_spread_2d(plan, vp)
    want = blocked.spread_blocked_plain(plan, vp)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got.numpy(), want.numpy()) <= 1e-12


def test_emulated_2d_units_match_jax_spread():
    """The 2D decomposition against the JAX package's reference spread (its
    CPU path) on the same points and values, complex128, three transforms."""
    plan, pts, vp = _unit_plan("three_transforms", np.complex128, seed=3)
    jp = jnufft.PlanNUFFT(np.complex128, UNIT_CASES_2D["three_transforms"][0], m=4,
                          sigma=1.5, ntransforms=3)
    assert tuple(jp.shape_over) == plan.shape_over
    want = j_spread(jp.kernel_data, jp.evalmode, jp.shape_over, jnp.asarray(pts),
                    jnp.asarray(vp.numpy()))
    got = emulate_spread_2d(plan, vp)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("m", [2, 4, 6, 8, 10])
def test_2d_chooser_picks_fit_the_kernel(dtype, m):
    """Every 2D pick at grid 6144^2 divides the grid, fits shared memory
    (the same for every block: 8 warps' unit rows and the coefficients),
    stays within the candidates' 128 cells a dim, and yields at least
    2 x 132 blocks."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    bd = blocking.choose_geometry((6144, 6144), m, sb, ncomp)
    assert len(bd) == 2 and all(6144 % b == 0 and b <= blocking.MAX_BLOCK_2D for b in bd)
    assert spread_smem_bytes(bd, m, m + 4, sb, ncomp) <= MAX_SMEM_BYTES
    assert spread2d_units(bd, m, ncomp).units >= 1
    assert int(np.prod(blocking.num_blocks((6144, 6144), bd))) >= 2 * NUM_SMS


def test_2d_chooser_is_the_cost_models_minimum():
    """At the 2D main path (complex64, m = 4, grid 6144^2) the pick has the
    least modelled cost among the candidates with at least 2 x 132 blocks,
    and is one unit."""
    bd = blocking.choose_geometry((6144, 6144), 4, 4, 2)
    best = blocking.spread2d_cost(bd, 4, 2)
    divs = [b for b in range(1, blocking.MAX_BLOCK_2D + 1) if 6144 % b == 0]
    for dims in [(a, b) for a in divs for b in divs]:
        if 6144 ** 2 // (dims[0] * dims[1]) >= 2 * NUM_SMS:
            assert blocking.spread2d_cost(dims, 4, 2) >= best
    assert spread2d_units(bd, 4, 2).units == 1
