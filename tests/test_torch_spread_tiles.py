"""The 3D spread kernel's decomposition (``csrc/spread_3d.cu``), emulated on
the CPU in float64, and the 3D block geometry chooser built on it.

The emulation follows the kernel's arithmetic with the shared tile geometry
(``ops/kernels/common.py:spread_tiles``): each block's dense A (value times
x tap, rows (i, k)) and B (y tap times z tap, columns (j, l) with l padded
to whole n-tiles) from the plain taps, one ``torch.matmul`` per warp's
unit, and a flush of each unit with periodic wrap.  The grid must equal
the plain version (``spread_blocked_plain``) to 1e-12, and once the JAX
package's reference spread.
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
    SPREAD3D_MAX_WARPS,
    SPREAD3D_UNIT_COL_TILES,
    SPREAD3D_UNIT_ROWS,
    VALUE_TYPES,
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
