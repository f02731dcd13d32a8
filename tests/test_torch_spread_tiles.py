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
    SPREAD3D_BATCH,
    SPREAD3D_CTA_GRID_BYTES,
    SPREAD3D_MAX_REGISTERS,
    SPREAD3D_MAX_WARPS,
    SPREAD3D_STRIDE,
    SPREAD3D_UNIT_COL_TILES,
    SPREAD3D_UNIT_ROWS,
    VALUE_TYPES,
    spread2d_units,
    spread3d_build_tasks,
    spread3d_buffers,
    spread3d_cta_transforms,
    spread3d_persistent_ctas,
    spread3d_resident_ctas,
    spread_registers,
    spread_smem_bytes,
    spread_tiles,
)
from torch_port_utils import random_complex, random_points, rel_err

torch.set_num_threads(1)


def _wrap(i: torch.Tensor, n: int) -> torch.Tensor:
    return torch.remainder(i, n)


def spread3d_walk(pstarts, nchan: int, ctas: int, passes: int, takers=None):
    """The batches of each of ``ctas`` CTAs of the 3D one-transform kernel,
    in the order it stages them (``csrc/spread_3d.cu:spread_3d_kernel``).
    The kernel hands its (block, transform) items out in launch order (item
    = transform x blocks + block) from a counter, a CTA taking the next one
    as it needs one, past the empty blocks; which CTA takes an item depends
    on the timing, so here the i-th non-empty item goes to CTA
    ``takers[i]``, by default to the CTAs in turn.  A CTA takes an item's
    points ``SPREAD3D_BATCH`` at a time, once a pass over its units.
    Returns, a CTA each, its batches as ``(transform, block, pass, first
    point, points)``."""
    nblocks = len(pstarts) - 1
    walks = [[] for _ in range(ctas)]
    full = [(item, int(pstarts[item % nblocks]), int(pstarts[item % nblocks + 1]))
            for item in range(nblocks * nchan)
            if pstarts[item % nblocks] < pstarts[item % nblocks + 1]]
    for i, (item, pb, pe) in enumerate(full):
        ch, bid = divmod(item, nblocks)
        walks[i % ctas if takers is None else takers[i]] += [
            (ch, bid, q, p0, min(SPREAD3D_BATCH, pe - p0))
            for q in range(passes) for p0 in range(pb, pe, SPREAD3D_BATCH)]
    return walks


def emulate_spread_3d(plan, vp: torch.Tensor, ctas: int = None, walks: list = None,
                      tasks: bool = False, takers=None) -> torch.Tensor:
    """The 3D one-transform kernel's walk in float64 on the CPU: ``ctas``
    persistent CTAs (by default as many as the card keeps resident,
    ``spread3d_persistent_ctas``) taking the non-empty (block, transform)
    items in launch order, the i-th by CTA ``takers[i]`` (by default the
    CTAs in turn), each CTA's batches as one chain (``spread3d_walk``):
    each batch's dense A and B, each unit of the
    batch's pass adding its rows of A times its columns of B into its sums,
    and a unit's flush with periodic wrap where its block or pass ends.
    With ``tasks`` each batch's columns are built slot by slot as the
    kernel's tasks write them (``spread3d_build_tasks``: rows of a padded
    cell range of one dim, zero outside the point's taps and past the
    batch's points, up to whole k-steps).  ``vp`` (C, Np) in original point
    order; returns the grid ``(C,) + shape_over`` in the plan's dtype.
    ``walks``, a list, receives each CTA's walk."""
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
    ncoef = blocked.kernel_coefs(plan)[1]
    if ctas is None:
        _, sb, _ = VALUE_TYPES[plan.dtype]
        ctas = spread3d_persistent_ctas(bd, m, ncoef, sb, ncomp, (len(ps) - 1) * C)

    rows = torch.arange(t.rows)
    ri, rk = rows // ncomp, rows % ncomp
    cols = torch.arange(t.cols)
    cj, cl = cols // zrow, cols % zrow
    col_groups = -(-t.col_tiles // SPREAD3D_UNIT_COL_TILES)

    def batch_operands(o, p0, P, ch):
        """A (rows, P') and B (P', cols) of points p0 .. p0 + P - 1, P'
        rounded up to whole k-steps (the extra columns zero)."""
        P8 = -(-P // 8) * 8
        lc = torch.zeros((3, P8), dtype=torch.int64)
        lc[:, :P] = cells[:, p0:p0 + P] - o[:, None]  # cells relative to the origin
        tp = torch.zeros((3, S, P8), dtype=torch.float64)
        tp[:, :, :P] = taps[:, :, p0:p0 + P]
        v = torch.zeros((P8, ncomp), dtype=torch.float64)
        v[:P] = vals[ch, p0:p0 + P]
        if tasks:
            A, wy, wz = _built_columns(lc, tp, v, P, t, m, ncomp, ncoef)
            B = (wy[cj] * wz[cl]).T  # (P8, cols)
            return A, B
        di = ri[:, None] - lc[0][None, :]  # (rows, P8)
        wx = torch.where((di >= 0) & (di < S), tp[0].gather(0, di.clamp(0, S - 1)), 0.0)
        A = wx * v.T[rk, :]
        dj = cj[None, :] - lc[1][:, None]  # (P8, cols)
        dl = cl[None, :] - lc[2][:, None]
        ok = (dj >= 0) & (dj < S) & (dl >= 0) & (dl < S)
        B = torch.where(ok, tp[1].T.gather(1, dj.clamp(0, S - 1))
                        * tp[2].T.gather(1, dl.clamp(0, S - 1)), 0.0)
        return A, B

    def unit_box(unit):
        rg, cg = divmod(unit, col_groups)
        r0, c0 = rg * SPREAD3D_UNIT_ROWS, cg * SPREAD3D_UNIT_COL_TILES * 8
        return r0, min(r0 + SPREAD3D_UNIT_ROWS, t.rows), c0, min(c0 + SPREAD3D_UNIT_COL_TILES * 8,
                                                                  t.cols)

    def flush(acc, ch, o, units):
        for unit in units:
            r0, r1, c0, c1 = unit_box(unit)
            i, k = ri[r0:r1], rk[r0:r1]
            j, l = cj[c0:c1], cl[c0:c1]
            keep = (i < pd0)[:, None] & (l < pd2)[None, :]
            gx = _wrap(o[0] - (m - 1) + i, n[0])[:, None]
            gy = _wrap(o[1] - (m - 1) + j, n[1])[None, :]
            gz = _wrap(o[2] - (m - 1) + l, n[2])[None, :]
            flat = ((gx * n[1] + gy) * n[2] + gz).expand_as(keep)[keep]
            comp = k[:, None].expand_as(keep)[keep]
            grid[ch].index_put_((flat, comp), acc[r0:r1, c0:c1][keep], accumulate=True)

    for walk in spread3d_walk(ps, C, ctas, t.passes, takers):
        if walks is not None:
            walks.append(walk)
        acc = None
        for b, (ch, bid, q, p0, P) in enumerate(walk):
            o = torch.tensor(np.unravel_index(bid, nb)) * torch.tensor(bd)
            units = range(q * t.warps, min((q + 1) * t.warps, t.units))
            if acc is None:
                acc = torch.zeros((t.rows, t.cols), dtype=torch.float64)
            A, B = batch_operands(o, p0, P, ch)
            for unit in units:
                r0, r1, c0, c1 = unit_box(unit)
                acc[r0:r1, c0:c1] += A[r0:r1] @ B[:, c0:c1]
            if b + 1 == len(walk) or walk[b + 1][:3] != (ch, bid, q):
                flush(acc, ch, o, units)
                acc = None
    grid = grid.reshape((C,) + tuple(n) + (ncomp,))
    if ncomp == 2:
        return torch.view_as_complex(grid).to(plan.dtype)
    return grid[..., 0].to(plan.dtype)


def _built_columns(lc, tp, v, P, t, m, ncomp, ncoef):
    """A batch's dense operands as the kernel's slots build them: each task
    (``spread3d_build_tasks``) covers a padded cell range along its dim, and
    a slot writes, for one point, the rows of its task's cells (A's: NCOMP
    rows a cell, the value times the tap), zero outside the point's 2M taps;
    a column past the batch's P points, up to whole k-steps, is zero.  Rows past NCOMP pd0 and z
    rows past pd2 keep the zeros the buffers started with.  Returns A (rows,
    P'), the y rows (pd1, P') and the z rows (8 z_tiles, P')."""
    S = 2 * m
    P8 = lc.shape[1]
    pd = t.padded
    A = torch.full((t.rows, P8), float("nan"), dtype=torch.float64)
    A[ncomp * pd[0]:] = 0.0
    wy = torch.full((pd[1], P8), float("nan"), dtype=torch.float64)
    wz = torch.full((8 * t.z_tiles, P8), float("nan"), dtype=torch.float64)
    wz[pd[2]:] = 0.0
    half = (pd[0] + 1) // 2
    ntask = spread3d_build_tasks(ncoef)
    bounds = ([(0, 0, half), (0, half, pd[0])] if ntask == 4 else [(0, 0, pd[0])])
    bounds += [(1, 0, pd[1]), (2, 0, pd[2])]
    for d, lo, hi in bounds:
        dst, per = (A, ncomp) if d == 0 else (wy, 1) if d == 1 else (wz, 1)
        for p in range(P8):
            c = int(lc[d, p]) if p < P else pd[d]
            for i in range(lo, hi):
                tap = i - c
                w = float(tp[d, tap, p]) if 0 <= tap < S else 0.0
                for k in range(per):
                    dst[i * per + k, p] = w * float(v[p, k]) if d == 0 else w
    assert not (A.isnan().any() or wy.isnan().any() or wz.isnan().any())
    return A, wy, wz


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


def _tile_plan(case, dtype, np_=900, seed=0, window=None):
    shape, sigma, m, bd, C = TILE_CASES[case]
    rng = np.random.default_rng(seed)
    kw = {} if window is None else {"kernel": window, "kernel_evalmode": tnufft.Direct()}
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=bd, device="cpu", **kw)
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


# Walks of the one-transform kernel (``spread3d_walk``): (tile case, CTAs,
# window, takers).  As many CTAs as the card keeps resident (more than the
# items here), one CTA walking every block, a few CTAs each walking several
# blocks (ragged: two transforms, so items of both; once the items dealt in
# turn, once to CTAs drawn at random, as uneven timing deals them), several
# passes of 16 warps a batch (m = 10), and the window-weights taps (KB
# Direct: three build tasks, x whole).
WALK_CASES = {
    "main_888_resident": ("main_888", None, None, None),
    "main_888_one_cta": ("main_888", 1, None, None),
    "ragged_7_ctas": ("ragged", 7, None, None),
    "ragged_7_ctas_random": ("ragged", 7, None, "random"),
    "m10_passes_5_ctas": ("m10", 5, None, None),
    "main_888_kb_direct": ("main_888", 3, "kb", None),
}


@pytest.mark.parametrize("dtype", [np.complex128, np.float64], ids=str)
@pytest.mark.parametrize("walk", list(WALK_CASES))
def test_emulated_walk_matches_plain_spread(walk, dtype):
    """The one-transform kernel's persistent walk, its batches chained
    across blocks and built slot by slot as its tasks write them, against
    the plain spread to 1e-12.  Each CTA takes its items in launch order,
    every non-empty (block, transform) item once, its points a batch of 64
    at a time and again each pass, so the batches are C x passes x the sum
    of ceil(n_b / 64), whichever CTA takes which item."""
    case, ctas, window, takers = WALK_CASES[walk]
    plan, _, vp = _tile_plan(case, dtype, window=tnufft.KaiserBesselKernel() if window else None)
    ncomp = 2 if plan.dtype.is_complex else 1
    t = spread_tiles(plan.block_dims, plan.m, ncomp)
    assert spread3d_build_tasks(blocked.kernel_coefs(plan)[1]) == (3 if window else 4)
    counts = (plan.pstarts[1:] - plan.pstarts[:-1]).tolist()
    nblocks, C = len(counts), vp.shape[0]
    if takers == "random":
        takers = np.random.default_rng(1).integers(0, ctas, C * nblocks).tolist()
    walks = []
    got = emulate_spread_3d(plan, vp, ctas=ctas, walks=walks, tasks=True, takers=takers)
    want = blocked.spread_blocked_plain(plan, vp)
    assert rel_err(got.numpy(), want.numpy()) <= 1e-12
    G = len(walks)
    assert G == (ctas or min(C * nblocks, 2 * NUM_SMS))
    seen = []
    for w in walks:
        items = list(dict.fromkeys(ch * nblocks + bid for ch, bid, _, _, _ in w))
        assert items == sorted(items)
        seen += items
    assert sorted(seen) == [c * nblocks + b for c in range(C) for b in range(nblocks)
                            if counts[b]]
    batches = sum(len(w) for w in walks)
    assert batches == C * t.passes * sum(-(-n // SPREAD3D_BATCH) for n in counts)
    assert t.passes > 1 if case == "m10" else t.passes == 1


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
def test_pipelined_kernel_keeps_16_mma_warps_an_sm(dtype):
    """At each main path's pick (grid 384^3, m = 4, BKB Fast: ncoef 8; and
    with the window-weights taps, ncoef 0) the one-transform kernel stages
    into two operand buffers, and its shared memory still lets an SM hold
    the two CTAs of 8 warps at 128 registers that its register file allows:
    16 MMA warps, the whole register file, so no staging warp fits beside
    them; a launch is 2 x 132 persistent CTAs."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    bd = blocking.choose_geometry((384, 384, 384), 4, sb, ncomp)
    t = spread_tiles(bd, 4, ncomp)
    assert t.warps == 8 and t.passes == 1 and spread3d_resident_ctas(t) == 2
    assert 2 * 32 * t.warps * SPREAD3D_MAX_REGISTERS == SM_REGISTERS
    for ncoef in (8, 0):
        assert spread3d_buffers(bd, 4, ncoef, sb, ncomp) == 2
        smem = spread_smem_bytes(bd, 4, ncoef, sb, ncomp)
        assert SM_SMEM_BYTES // (smem + SMEM_RESERVED_PER_CTA) >= 2
        assert spread3d_persistent_ctas(bd, 4, ncoef, sb, ncomp, 10 ** 6) == 2 * NUM_SMS


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
def test_chooser_keeps_the_main_path_blocks(dtype):
    """The pipelined kernel leaves the 3D chooser's picks at grid 384^3,
    m = 4: (8, 8, 8) for complex values, (24, 8, 8) for real ones."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    want = (8, 8, 8) if ncomp == 2 else (24, 8, 8)
    assert blocking.choose_geometry((384, 384, 384), 4, sb, ncomp) == want


def _one_cta_a_block_bytes(bd, m, ncoef, sb, ncomp):
    """Shared memory of the design the pipelined kernel replaced (a CTA a
    block and transform, one batch's dense operands, its compact taps and
    values in double and its int32 cells, then the coefficients)."""
    t = spread_tiles(bd, m, ncomp)
    dense = t.rows + t.padded[1] + 8 * t.z_tiles
    return (8 * (SPREAD3D_STRIDE * dense + (6 * m + ncomp) * SPREAD3D_BATCH)
            + 4 * 3 * SPREAD3D_BATCH + sb * 6 * m * ncoef)


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("m", [2, 4, 7, 10])
def test_pipelined_kernel_refuses_no_block_the_old_one_took(m, dtype):
    """Over block dims up to 64 cells a dim, with and without a coefficient
    stack, the pipelined kernel's shared memory stays within what one CTA
    may take wherever the one-CTA-a-block design's did: where two buffers
    do not fit beside the resident CTAs it stages into one, which takes no
    more than that design did.  A block of 64 x 1 x 1 cells (complex) or
    100 x 1 x 1 (real) at m = 4 is such a block at 8 warps."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    dims = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64)
    ones = 0
    for bd in [(a, b, c) for a in dims for b in dims for c in dims]:
        for ncoef in (m + 4, 0):
            old = _one_cta_a_block_bytes(bd, m, ncoef, sb, ncomp)
            new = spread_smem_bytes(bd, m, ncoef, sb, ncomp)
            if spread3d_buffers(bd, m, ncoef, sb, ncomp) == 1:
                ones += 1
                assert new <= old
            if old <= MAX_SMEM_BYTES:
                assert new <= MAX_SMEM_BYTES
    assert ones > 0 or m < 7
    bd = (50, 1, 1) if ncomp == 2 else (100, 1, 1)
    assert spread_tiles(bd, 4, ncomp).warps == 8 and spread3d_buffers(bd, 4, 8, sb, ncomp) == 1


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
    Fast, 32 transforms): a launch of one transform runs the pipelined
    one-transform kernel in two operand buffers (72,384 B: 2 x 34,272 of
    dense operands, 3,072 of copied point state, 768 of coefficients); one
    of 32 runs the shared-staging kernel, two CTAs a block of
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
    assert spread_smem_bytes(bd, 4, ncoef, 4, 2, 1) == 72_384 == 2 * 34_272 + 3_072 + 768
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
