"""The 3D interpolation kernel's staged window (``csrc/interp_3d.cu``),
emulated on the CPU in float64, and its shared-memory geometry.

The emulation follows the kernel's arithmetic with the shared geometry
(``ops/kernels/common.py:interp_tiles``): each non-empty block's padded
window gathered from the grid with periodic wrap, in the x-slab passes the
geometry fixes (one pass from the grid itself for a block below
``INTERP3D_SPARSE`` points, the kernel's gather branch), and each point
contracted in local coordinates over the x taps that fall in the pass, its
partial results times ``normfactor`` added pass by pass.  The values must
equal the plain version (``interpolate_blocked_plain``) to 1e-12, and once
the JAX package's reference interpolation.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.ops.interpolation import interpolate_reference as j_interp
from nonuniformffts_tpu_torch import blocking
from nonuniformffts_tpu_torch.ops.kernels import blocked
from nonuniformffts_tpu_torch.ops.kernels.common import (
    INTERP3D_SPARSE,
    MAX_SMEM_BYTES,
    VALUE_TYPES,
    WAVEFRONT_BYTES,
    interp_lanes,
    interp_tiles,
)
from torch_port_utils import random_complex, random_points, rel_err

torch.set_num_threads(1)


def emulate_interp_3d(plan, grid: torch.Tensor) -> torch.Tensor:
    """The 3D interpolation kernel's arithmetic in float64 on the CPU.
    ``grid`` (C,) + shape_over; returns (C, Np) in original point order, in
    the plan's dtype."""
    m, S = plan.m, 2 * plan.m
    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    t = interp_tiles(plan.block_dims, m, blocked.kernel_coefs(plan)[1], sb, ncomp)
    assert t.passes >= 1
    pd0 = t.padded[0]
    taps = blocked.window_weights_blocked_plain(plan).to(torch.float64)  # (3, S, Np)
    g = grid.to(torch.complex128 if ncomp == 2 else torch.float64)
    C, n = g.shape[0], plan.shape_over
    out = torch.zeros((C, plan.num_points), dtype=g.dtype)
    nb = blocking.num_blocks(n, plan.block_dims)
    ps = plan.pstarts.tolist()
    cells = plan.cells_sorted.to(torch.int64)
    a = torch.arange(S)
    for bid in range(len(ps) - 1):
        p0, p1 = ps[bid], ps[bid + 1]
        if p0 == p1:
            continue
        o = torch.tensor(np.unravel_index(bid, nb)) * torch.tensor(plan.block_dims)
        # Padded index i of a dim is grid node origin - (M - 1) + i, wrapped.
        idx = [torch.remainder(o[d] - (m - 1) + torch.arange(t.padded[d]), n[d])
               for d in range(3)]
        lc = cells[:, p0:p1] - o[:, None]  # (3, P) local cells
        wx, wy, wz = (taps[d][:, p0:p1].T for d in range(3))  # (P, S)
        slabs = ([(0, pd0)] if p1 - p0 < INTERP3D_SPARSE
                 else [(x0, min(t.planes, pd0 - x0)) for x0 in range(0, pd0, t.planes)])
        acc = torch.zeros((C, p1 - p0), dtype=g.dtype)
        for x0, nx in slabs:
            win = g[:, idx[0][x0:x0 + nx]][:, :, idx[1]][:, :, :, idx[2]]  # the staged slab
            xi = lc[0][:, None] + a[None, :] - x0  # (P, S): slab plane of x tap a
            inside = (xi >= 0) & (xi < nx)
            yi, zi = lc[1][:, None] + a, lc[2][:, None] + a
            vals = win[:, xi.clamp(0, nx - 1)[:, :, None, None], yi[:, None, :, None],
                       zi[:, None, None, :]]  # (C, P, S, S, S)
            part = torch.einsum("cpabe,pa,pb,pe->cp", vals,
                                torch.where(inside, wx, 0.0).to(g.dtype),
                                wy.to(g.dtype), wz.to(g.dtype))
            acc += part * plan.normfactor
        out[:, plan.sort_perm[p0:p1]] = acc
    return out.to(plan.dtype)


# (shape, sigma, m, block_dims, transforms, kernel, points, where): the
# main path's blocks cut to a small grid; ragged block dims; a grid smaller
# than the padded window (35 cells of a 32-cell dim at m = 10); a window
# staged in x-slab passes (m = 10, (8, 8, 8), complex128); blocks with
# no point; three transforms; taps from K3 (a window without coefficients);
# blocks on each side of the gather threshold (half the points in one block).
TILE_CASES = {
    "main_888": ((32, 32, 32), 1.5, 4, (8, 8, 8), 1, None, 20_000, "uniform"),
    "ragged": ((20, 24, 16), 1.5, 4, (5, 4, 6), 2, None, 20_000, "uniform"),
    "grid_below_window": ((16, 16, 16), 2.0, 10, (16, 16, 16), 1, None, 1_000, "uniform"),
    "x_slab_passes": ((16, 16, 16), 2.0, 10, (8, 8, 8), 1, None, 4_500, "uniform"),
    "empty_blocks": ((32, 32, 32), 1.5, 4, None, 1, None, 900, "corner"),
    "three_transforms": ((20, 24, 16), 1.5, 4, None, 3, None, 6_000, "uniform"),
    "k3_taps": ((20, 24, 16), 1.5, 4, (5, 4, 6), 1, "GaussianKernel", 20_000, "uniform"),
    "sparse": ((32, 32, 32), 1.5, 4, (8, 8, 8), 1, None, 400, "clustered"),
}


def _tile_plan(case, dtype, seed=0, np_=None):
    shape, sigma, m, bd, C, kernel, case_np, where = TILE_CASES[case]
    np_ = np_ or case_np
    rng = np.random.default_rng(seed)
    kw = {} if kernel is None else dict(kernel=getattr(tnufft, kernel)())
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=bd, device="cpu", **kw)
    if where == "corner":  # one octant: most blocks hold no point
        pts = random_points(rng, 3, np_, dtype, lo=0.0, hi=np.pi / 2)
    elif where == "clustered":  # half in one corner block, half spread thin
        pts = random_points(rng, 3, np_, dtype)
        pts[:, ::2] = random_points(rng, 3, np_ // 2, dtype, lo=0.1, hi=0.9)
    else:
        pts = random_points(rng, 3, np_, dtype, lo=-1.0, hi=7.0)
    pts[:, :4] = np.float64(2 * np.pi) - 1e-9  # the grid's top edge
    plan = tnufft.set_points(plan, pts)
    g = random_complex(rng, np.complex128, (C,) + plan.shape_over)
    if not plan.dtype.is_complex:
        g = g.real.copy()
    return plan, pts, torch.from_numpy(g).to(plan.dtype)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64], ids=str)
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_emulated_window_matches_plain_interp(case, dtype):
    plan, _, grid = _tile_plan(case, dtype)
    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    t = interp_tiles(plan.block_dims, plan.m, blocked.kernel_coefs(plan)[1], sb, ncomp)
    counts = (plan.pstarts[1:] - plan.pstarts[:-1]).tolist()
    if case == "x_slab_passes" and dtype == np.complex128:
        assert t.passes >= 2
    if case == "grid_below_window":
        assert t.padded[0] > plan.shape_over[0]
    if case == "empty_blocks":
        assert 0 in counts
    if case in ("main_888", "sparse"):  # both branches of the kernel
        assert any(0 < c < INTERP3D_SPARSE for c in counts)
    assert any(c >= INTERP3D_SPARSE for c in counts)  # a staged block
    got = emulate_interp_3d(plan, grid)
    want = blocked.interpolate_blocked_plain(plan, grid)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got.numpy(), want.numpy()) <= 1e-12


def test_emulated_window_matches_jax_interp():
    """The staged window against the JAX package's reference interpolation
    (its CPU path) on the same points and grid, complex128, with blocks on
    both sides of the threshold."""
    plan, pts, grid = _tile_plan("ragged", np.complex128, seed=3, np_=10_000)
    counts = (plan.pstarts[1:] - plan.pstarts[:-1]).tolist()
    assert min(counts) < INTERP3D_SPARSE <= max(counts)
    jp = jnufft.set_points(jnufft.PlanNUFFT(np.complex128, TILE_CASES["ragged"][0], m=4,
                                            sigma=1.5, ntransforms=2), pts)
    assert tuple(jp.shape_over) == plan.shape_over
    want = j_interp(jp.kernel_data, jp.evalmode, jnp.asarray(grid.numpy()), jp.points,
                    jp.normfactor)
    got = emulate_interp_3d(plan, grid)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
def test_chooser_picks_stage_in_one_pass(dtype):
    """At the main path (grid 384^3, m = 4, BKB Fast) the chooser's pick
    stages its whole window in one pass."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    bd = blocking.choose_geometry((384, 384, 384), 4, sb, ncomp)
    t = interp_tiles(bd, 4, 8, sb, ncomp)
    assert t.passes == 1 and t.planes == t.padded[0] and t.pitch >= t.padded[2]
    assert t.smem <= MAX_SMEM_BYTES
    assert t.smem >= sb * ncomp * t.padded[0] * t.padded[1] * t.pitch


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("m", list(range(2, 11)))
def test_lane_loads_are_conflict_free(dtype, m):
    """Each load instruction of a point's lane group reads cells on
    distinct banks within every 128-byte wavefront: lane q reads z tap
    q % span of row q // span + rows k, rows ``pitch`` cells apart, and the
    hardware serves a wavefront's worth of lanes (128 B of cells) at a
    time.  The points of one warp lie in different wavefronts."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    lanes = interp_lanes(m, sb, ncomp)
    cells = WAVEFRONT_BYTES // (sb * ncomp)
    assert lanes.per_point <= 32 and lanes.per_point % cells == 0
    assert lanes.rows * lanes.steps >= 2 * m
    for bd in ((8, 8, 8), (24, 8, 8), (5, 4, 6)):
        pitch = interp_tiles(bd, m, m + 4, sb, ncomp).pitch
        for k in range(lanes.steps):
            for chunk in range(0, lanes.per_point, cells):
                banks = [((q // lanes.span + lanes.rows * k) * pitch + q % lanes.span) % cells
                         for q in range(chunk, chunk + cells)
                         if q % lanes.span < 2 * m and q // lanes.span + lanes.rows * k < 2 * m]
                assert len(set(banks)) == len(banks), (bd, k, chunk, banks)


def test_m10_takes_passes_rather_than_raising():
    """m = 10 at (8, 8, 8) in complex128 (27^3 cells of 16 B, 315 KB) takes
    x-slab passes, and the kernels take the plan; a block whose single x
    plane exceeds the 227 KB is refused."""
    t = interp_tiles((8, 8, 8), 10, 14, 8, 2)
    assert t.passes >= 2 and (t.passes - 1) * t.planes < 27 <= t.passes * t.planes
    plane = 16 * 27 * t.pitch
    head = t.smem - plane * t.planes
    assert t.smem <= MAX_SMEM_BYTES < head + plane * -(-27 // (t.passes - 1))  # fewest passes
    plan = tnufft.PlanNUFFT(np.complex128, (16, 16, 16), m=10, sigma=2.0,
                            spread_method="blocked", block_dims=(8, 8, 8), device="cpu")
    blocked.check_kernel_support(plan)
    # (1, 64, 256): the spread's batch fits, one window plane (71 x 263 cells) does not.
    assert interp_tiles((1, 64, 256), 4, 14, 8, 2).passes == 0
    wide = dataclasses.replace(plan, m=4, block_dims=(1, 64, 256), shape_over=(32, 256, 256))
    with pytest.raises(ValueError, match="one x plane"):
        blocked.check_kernel_support(wide)
