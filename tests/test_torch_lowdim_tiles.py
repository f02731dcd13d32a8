"""The 1D spread kernel's rounds (``csrc/spread_1d.cu``), emulated on the
CPU in float64, and their shared-memory geometry.

The emulation follows the kernel with the shared geometry
(``ops/kernels/common.py:spread1d_warp_rounds``, ``spread1d_stored``): each
local cell's 2M tap sums, each value read through the sort permutation,
the rotation of a round's sums by t lanes into
padded cells and the next round's carry, each warp's first cells waiting
for the previous warp's carry, and the flush with periodic wrap, interior
cells stored and halo cells added, each logged.  Each result must equal
the plain version to 1e-12, and once the JAX package's reference.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.ops.interpolation import interpolate_reference as j_interp
from nonuniformffts_tpu.ops.spreading import spread_reference as j_spread
from nonuniformffts_tpu_torch import blocking
from nonuniformffts_tpu_torch.ops.kernels import blocked
from nonuniformffts_tpu_torch.ops.kernels.common import (
    INTERP1D_GATHER_BYTES,
    INTERP1D_STAGE_BYTES,
    INTERP2D_LOAD_REGS,
    INTERP2D_ROWS_M,
    INTERP2D_THREADS,
    MAX_SMEM_BYTES,
    SPREAD1D_THREADS,
    VALUE_TYPES,
    coefficient_stack,
    interp1d_gathers,
    interp1d_staged,
    interp1d_window,
    interp2d_chunked_rows,
    interp2d_min_ctas,
    interp2d_rows,
    interp2d_smem_bytes,
    row_pitch,
    window_weights,
    spread1d_stored,
    spread1d_warp_rounds,
    spread_smem_bytes,
)
from torch_port_utils import random_complex, random_points, rel_err

torch.set_num_threads(1)


def emulate_spread_1d(plan, vp: torch.Tensor, log=None) -> torch.Tensor:
    """The 1D spread kernel's arithmetic in float64 on the CPU.  ``vp``
    (C, Np) in original point order; returns the grid ``(C, n0)`` in the
    plan's dtype.  ``log``, a list, receives each flush as (transform,
    block, padded cell, node, 'store' or 'reduce')."""
    m, S = plan.m, 2 * plan.m
    (b0,), (n0,) = plan.block_dims, plan.shape_over
    taps = blocked.window_weights_blocked_plain(plan)[0].to(torch.float64)  # (S, Np)
    v = vp[:, plan.sort_perm].to(torch.complex128 if vp.is_complex() else torch.float64)
    C = v.shape[0]
    grid = torch.zeros((C, n0), dtype=v.dtype)
    ps = plan.pstarts.tolist()
    cells = plan.cells_sorted[0].to(torch.int64)
    rounds = spread1d_warp_rounds(b0)
    lanes = torch.arange(32)

    def flush(c, bid, p, s):
        if s == 0 or p >= b0 + S - 1:
            return
        node = (bid * b0 - (m - 1) + p) % n0
        kind = "store" if spread1d_stored(p, b0, m) else "reduce"
        if kind == "store":
            grid[c, node] = s
        else:
            grid[c, node] += s
        if log is not None:
            log.append((c, bid, p, node, kind))

    for c in range(C):
        for bid in range(len(ps) - 1):
            p0, p1 = ps[bid], ps[bid + 1]
            if p0 == p1:
                continue
            lc = cells[p0:p1] - bid * b0
            # Each local cell's 2M tap sums, (32 rounds, S); each point's
            # value read through the sort permutation, as the kernel does.
            nr = -(-b0 // 32)
            acc = torch.zeros((32 * nr, S), dtype=v.dtype)
            acc.index_add_(0, lc, taps[:, p0:p1].T.to(v.dtype)
                           * vp[c, plan.sort_perm[p0:p1], None].to(v.dtype))
            s_carry, heads = {}, {}
            for w, (rb, re) in enumerate(rounds):
                carry = torch.zeros(32, dtype=v.dtype)
                for r in range(rb, re):
                    a = acc[32 * r:32 * r + 32]  # lane l: cell 32 r + l
                    ins, out = carry.clone(), torch.zeros(32, dtype=v.dtype)
                    for t in range(S):
                        x = a[(lanes - t) % 32, t]  # lane l takes lane (l - t) mod 32's tap t
                        ins += torch.where(t <= lanes, x, 0)
                        out += torch.where(t > lanes, x, 0)
                    for lane in range(32):
                        if r == rb and lane < S - 1:
                            heads[(w, lane)] = ins[lane]
                        else:
                            flush(c, bid, 32 * r + lane, ins[lane])
                    carry = out
                if rb < re:
                    for lane in range(S - 1):
                        if re == nr:
                            flush(c, bid, 32 * re + lane, carry[lane])
                        else:
                            s_carry[(w, lane)] = carry[lane]
            for (w, lane), h in heads.items():  # after the barrier
                flush(c, bid, 32 * rounds[w][0] + lane, h + s_carry.get((w - 1, lane), 0))
    return grid.to(plan.dtype)


# (shape, sigma, m, block_dims, transforms, kernel, points, where): the main
# path's block (512 cells, 16 rounds over 8 warps) cut to a small grid; a
# block of one round and a ragged one (b0 not a multiple of 32); blocks of
# more rounds than warps; a grid smaller than the padded block (m = 10,
# one block of 20 cells, 39 padded); m = 2; empty blocks; three transforms;
# taps from K3; dense cells (~20 points a cell).
SPREAD1D_CASES = {
    "main_512": ((1024,), 1.5, 4, (512,), 1, None, 4_000, "uniform"),
    "one_round": ((64,), 1.5, 4, (32,), 1, None, 400, "uniform"),
    "ragged": ((60,), 1.5, 4, (45,), 2, None, 600, "uniform"),
    "many_rounds": ((2048,), 1.5, 3, (3072,), 1, None, 5_000, "uniform"),
    "grid_below_block": ((10,), 2.0, 10, (20,), 1, None, 300, "uniform"),
    "m2": ((256,), 2.0, 2, (64,), 1, None, 2_000, "uniform"),
    "empty_blocks": ((1024,), 1.5, 4, (64,), 1, None, 300, "corner"),
    "three_transforms": ((256,), 1.5, 5, (96,), 3, None, 2_000, "uniform"),
    "k3_taps": ((256,), 2.0, 4, (128,), 1, "GaussianKernel", 2_000, "uniform"),
    "dense_cells": ((128,), 1.5, 4, (64,), 1, None, 4_000, "uniform"),
}


def _spread1d_plan(case, dtype, seed=0):
    shape, sigma, m, bd, C, kernel, np_, where = SPREAD1D_CASES[case]
    rng = np.random.default_rng(seed)
    kw = {} if kernel is None else dict(kernel=getattr(tnufft, kernel)())
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=bd, device="cpu", **kw)
    hi = np.pi / 4 if where == "corner" else 7.0
    pts = random_points(rng, 1, np_, dtype, lo=-1.0 if where == "uniform" else 0.0, hi=hi)
    pts[:, :4] = np.float64(2 * np.pi) - 1e-9  # the grid's top edge: the halo wraps
    plan = tnufft.set_points(plan, pts)
    vp = random_complex(rng, np.complex128, (C, np_))
    if not plan.dtype.is_complex:
        vp = vp.real.copy()
    return plan, pts, torch.from_numpy(vp).to(plan.dtype)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64], ids=str)
@pytest.mark.parametrize("case", list(SPREAD1D_CASES))
def test_emulated_1d_rounds_match_plain_spread(case, dtype):
    plan, _, vp = _spread1d_plan(case, dtype)
    (b0,) = plan.block_dims
    rounds = spread1d_warp_rounds(b0)
    counts = (plan.pstarts[1:] - plan.pstarts[:-1]).tolist()
    if case == "main_512":
        assert rounds == tuple((2 * w, 2 * w + 2) for w in range(8))
    if case == "many_rounds":
        assert all(re - rb == 12 for rb, re in rounds)
    if case == "ragged":
        assert b0 % 32 and rounds[0] == (0, 1) and rounds[1] == (1, 2)
    if case == "grid_below_block":
        assert b0 + 2 * plan.m - 1 > plan.shape_over[0] == b0
    if case == "empty_blocks":
        assert 0 in counts
    if case == "dense_cells":
        assert plan.num_points / plan.shape_over[0] > 15
    got = emulate_spread_1d(plan, vp)
    want = blocked.spread_blocked_plain(plan, vp)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got.numpy(), want.numpy()) <= 1e-12


def test_emulated_1d_rounds_match_jax_spread():
    """The 1D rounds against the JAX package's reference spread (its CPU
    path) on the same points and values, complex128, three transforms."""
    plan, pts, vp = _spread1d_plan("three_transforms", np.complex128, seed=3)
    shape, sigma, m = SPREAD1D_CASES["three_transforms"][:3]
    jp = jnufft.PlanNUFFT(np.complex128, shape, m=m, sigma=sigma, ntransforms=3)
    assert tuple(jp.shape_over) == plan.shape_over
    want = j_spread(jp.kernel_data, jp.evalmode, jp.shape_over, jnp.asarray(pts),
                    jnp.asarray(vp.numpy()))
    got = emulate_spread_1d(plan, vp)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("case", ["main_512", "ragged", "grid_below_block", "three_transforms"])
def test_1d_flush_writes_each_cell_once(case):
    """Each padded cell with a sum is flushed exactly once by its block; a
    node stored by one block (an interior cell) is reached by no other
    block's flush, so plain stores need no atomics; every halo cell is a
    reduction."""
    plan, _, vp = _spread1d_plan(case, np.complex128, seed=5)
    log = []
    emulate_spread_1d(plan, vp, log)
    (b0,), m = plan.block_dims, plan.m
    per_cell = collections.Counter((c, bid, p) for c, bid, p, _, _ in log)
    assert max(per_cell.values()) == 1
    writers = collections.defaultdict(set)
    for c, bid, p, node, kind in log:
        writers[(c, node)].add((bid, kind))
        assert (kind == "store") == (2 * m - 1 <= p < b0)
    for (c, node), who in writers.items():
        if any(kind == "store" for _, kind in who):
            assert len(who) == 1, (node, who)
    assert any(kind == "reduce" for *_, kind in log)
    if case == "main_512":
        assert any(kind == "store" for *_, kind in log)


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("m", list(range(2, 11)))
def test_1d_spread_smem_fits(dtype, m):
    """The 1D CTA (the coefficient rows, each warp's carry, the start table)
    fits shared memory at the chooser's pick for the main path's grid and
    at the longest block the chooser considers; its warps cover a block's
    cells with at most one partial round."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    bd = blocking.choose_geometry((1_572_864,), m, sb, ncomp)
    for b in (bd, (blocking.MAX_BLOCK_1D,)):
        smem = spread_smem_bytes(b, m, m + 4, sb, ncomp)
        assert smem <= MAX_SMEM_BYTES
        assert smem == (sb * row_pitch(2 * m, sb) * (m + 4)
                        + 8 * (SPREAD1D_THREADS // 32) * (2 * m - 1) * ncomp
                        + 4 * (b[0] + 1))
        assert row_pitch(2 * m, sb) * sb % 16 == 0 and 0 <= row_pitch(2 * m, sb) - 2 * m < 4
        rounds = spread1d_warp_rounds(b[0])
        assert rounds[0][0] == 0 and rounds[-1][1] == -(-b[0] // 32)
        assert all(a[1] == c[0] for a, c in zip(rounds, rounds[1:]))


@pytest.mark.parametrize("stem, table", [("spread_3d", "SPREAD3D_PARTS"),
                                         ("interp_3d", "INTERP3D_PARTS"),
                                         ("spread_2d", "SPREAD2D_PARTS"),
                                         ("spread_1d", "SPREAD1D_PARTS"),
                                         ("interp_2d", "INTERP2D_PARTS"),
                                         ("interp_2d", "POINT_INTERP2D_PARTS"),
                                         ("interp_2d", "INTERP2D_DESIGNS"),
                                         ("interp_1d", "INTERP1D_PARTS"),
                                         ("window_weights", "WEIGHTS_PARTS")])
def test_probe_parts_edit_the_shipped_sources(stem, table):
    """Every line that a ``chip_probe.py`` parts probe (``--spread3d-parts``
    .. ``--interp1d-parts``, ``--weights``) replaces to take a phase out, and
    that ``--interp2d`` replaces for the 2D interpolation's first design, is
    in the shipped kernel's source as the probe builds it (``spread_mma.cuh``
    written in place of its include), and each copy differs from it: a stale
    edit would fail the probe on the card."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_probe.py"
    spec = importlib.util.spec_from_file_location("chip_probe_parts", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    parts = getattr(probe, table)
    texts = probe._edited_sources(stem, parts, (4, 8, 10))
    assert "CASE(4) CASE(8) CASE(10)" in texts["shipped"]
    assert '#include "spread_mma.cuh"' not in texts["shipped"]
    assert set(texts) == {"shipped", *parts}
    assert all(texts[k] != texts["shipped"] for k in parts)


def emulate_interp_1d(plan, grid: torch.Tensor, log=None) -> torch.Tensor:
    """The 1D interpolation kernel's reads in float64 on the CPU, from the
    shared geometry (``interp1d_window``, ``interp1d_staged``,
    ``Interp1DWindow.first_chunk``): a block with enough points copies its
    window chunk by chunk, a chunk within the grid in one piece and one that
    crosses an end cell by cell with periodic wrap, ``chans`` transforms a
    pass; each point reads its 2M cells at its offset in that window, or
    from the grid with wrap.  ``grid`` (C, n0); returns (C, Np) in the
    caller's point order.  ``log``, a list, receives (block, staged)."""
    m, S = plan.m, 2 * plan.m
    (b0,), (n0,) = plan.block_dims, plan.shape_over
    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    C = grid.shape[0]
    win = interp1d_window(b0, m, blocked.kernel_coefs(plan)[1], sb, ncomp, C)
    taps = blocked.window_weights_blocked_plain(plan)[0].to(torch.float64)  # (S, Np)
    g = grid.to(torch.complex128 if grid.is_complex() else torch.float64)
    cells = plan.cells_sorted[0].to(torch.int64)
    out = torch.zeros((C, plan.num_points), dtype=g.dtype)
    ps = plan.pstarts.tolist()
    for bid in range(len(ps) - 1):
        p0, p1 = ps[bid], ps[bid + 1]
        if p0 == p1:
            continue
        staged = interp1d_staged(p1 - p0, win)
        if log is not None:
            log.append((bid, staged))
        ox = bid * b0
        a0, lo = win.first_chunk(ox, m)
        nchunks = -(-(lo + win.span) // win.chunk)
        assert nchunks * win.chunk <= win.cells
        for c0 in range(0, C, win.chans if staged else C):
            for c in range(c0, min(c0 + (win.chans if staged else C), C)):
                if staged:
                    window = torch.full((win.cells,), float("nan"), dtype=g.dtype)
                    for k in range(nchunks):
                        gc = a0 + k * win.chunk
                        if gc >= 0 and gc + win.chunk <= n0 and (c * n0 + gc) % win.chunk == 0:
                            window[k * win.chunk:(k + 1) * win.chunk] = g[c, gc:gc + win.chunk]
                        else:
                            for e in range(win.chunk):
                                window[k * win.chunk + e] = g[c, (gc + e) % n0]
                    idx = (cells[p0:p1] - ox + lo)[:, None] + torch.arange(S)
                    vals = window[idx]
                else:
                    idx = (cells[p0:p1] - (m - 1))[:, None] + torch.arange(S)
                    vals = g[c, idx % n0]
                out[c, p0:p1] = (vals * taps[:, p0:p1].T).sum(1) * plan.normfactor
    res = torch.empty_like(out)
    res[:, plan.sort_perm] = out
    return res.to(plan.dtype)


# (shape, sigma, m, block_dims, transforms, points, where): the main path's
# 512-cell blocks cut to a small grid (every block staged); rho = 0.01 (none
# staged); clustered points (both); a block wider than its grid at m = 10
# (the staged window wraps more than once); an odd grid (the second
# transform's row starts off the 16-byte chunks); staging passes over the
# transforms, or a window too wide to stage; taps from K3.
INTERP1D_CASES = {
    "main_512": ((1024,), 1.5, 4, (512,), 1, None, 4_000, "uniform"),
    "rho_0_01": ((4096,), 1.5, 4, (512,), 1, None, 41, "uniform"),
    "clustered": ((2048,), 1.5, 4, (96,), 2, None, 600, "corner"),
    "grid_below_block": ((10,), 2.0, 10, (20,), 1, None, 300, "uniform"),
    "odd_grid": ((50,), 1.5, 4, (25,), 2, None, 800, "uniform"),
    "passes": ((4096,), 1.5, 4, (3072,), 3, None, 6_000, "uniform"),
    "k3_taps": ((256,), 2.0, 4, (128,), 1, "GaussianKernel", 2_000, "uniform"),
}


def _interp1d_plan(case, dtype, seed=0):
    shape, sigma, m, bd, C, kernel, np_, where = INTERP1D_CASES[case]
    rng = np.random.default_rng(seed)
    kw = {} if kernel is None else dict(kernel=getattr(tnufft, kernel)())
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=bd, device="cpu", **kw)
    hi = np.pi / 4 if where == "corner" else 7.0
    pts = random_points(rng, 1, np_, dtype, lo=-1.0 if where == "uniform" else 0.0, hi=hi)
    if where == "corner":  # and an eighth of them anywhere
        pts[:, ::8] = random_points(rng, 1, -(-np_ // 8), dtype, hi=2 * np.pi)
    pts[:, :4] = np.float64(2 * np.pi) - 1e-9  # the grid's top edge: the window wraps
    plan = tnufft.set_points(plan, pts)
    g = random_complex(rng, np.complex128, (C,) + plan.shape_over)
    if not plan.dtype.is_complex:
        g = g.real.copy()
    return plan, pts, torch.from_numpy(g).to(plan.dtype)


# A real plan's last axis is even (its r2c grid), so the odd grid is complex.
@pytest.mark.parametrize("case, dtype", [
    (case, dtype) for case in INTERP1D_CASES for dtype in VALUE_TYPES
    if case != "odd_grid" or dtype.is_complex], ids=str)
def test_emulated_1d_windows_match_plain_interp(case, dtype):
    """Each block's reads as the 1D interpolation kernel makes them, staged
    or from global memory, against the plain interpolation (1e-12 in
    float64 of the same taps and cells)."""
    np_dtype = {torch.complex64: np.complex64, torch.complex128: np.complex128,
                torch.float32: np.float32, torch.float64: np.float64}[dtype]
    plan, _, g = _interp1d_plan(case, np_dtype)
    (b0,), (n0,) = plan.block_dims, plan.shape_over
    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    win = interp1d_window(b0, plan.m, blocked.kernel_coefs(plan)[1], sb, ncomp, g.shape[0])
    log = []
    got = emulate_interp_1d(plan, g, log)
    staged = [s for _, s in log]
    if case in ("main_512", "grid_below_block", "odd_grid"):
        assert all(staged)
    if case == "rho_0_01":
        assert not any(staged)
    if case == "clustered":
        assert any(staged) and not all(staged)
    if case == "grid_below_block":
        assert win.span > n0
    if case == "odd_grid":
        assert n0 % 2 == 1 and ((n0 * sb * ncomp) % 16 != 0) == (sb * ncomp < 16)
    if case == "passes":
        assert (win.chans == 0) if sb * ncomp == 16 else 0 < win.chans < g.shape[0]
    want = blocked.interpolate_blocked_plain(plan, g)
    tol = 1e-12 if sb == 8 else 1e-6
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got.numpy(), want.numpy()) <= tol


def test_emulated_1d_windows_match_jax_interp():
    """The staged reads against the JAX package's reference interpolation
    (its CPU path) on the same points and grid, complex128, two transforms."""
    plan, pts, g = _interp1d_plan("clustered", np.complex128, seed=3)
    shape, sigma, m = INTERP1D_CASES["clustered"][:3]
    jp = jnufft.PlanNUFFT(np.complex128, shape, m=m, sigma=sigma, ntransforms=2)
    assert tuple(jp.shape_over) == plan.shape_over
    want = j_interp(jp.kernel_data, jp.evalmode, jnp.asarray(g.numpy()), jnp.asarray(pts),
                    plan.normfactor)
    got = emulate_interp_1d(plan, g)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("m", list(range(2, 11)))
def test_1d_interp_window_geometry(dtype, m):
    """The staged window (``interp1d_window``) holds each block's window
    from its first chunk at every offset, in whole 16-byte chunks; the
    transforms a pass fill at most the staging budget; the CTA's shared
    memory (coefficient rows, then the windows) stays below 48 KB, so the
    launch needs no opt-in; a block of the main path's grid is staged at 1M
    and 10M points and read from global memory at rho = 0.01."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    cell = sb * ncomp
    b0 = blocking.choose_geometry((1_572_864,), m, sb, ncomp)[0]
    for C in (1, 2, 7, 64):
        for b in (b0, 45, 3072, blocking.MAX_BLOCK_1D):
            win = interp1d_window(b, m, m + 4, sb, ncomp, C)
            assert win.chunk * cell == 16 and win.cells % win.chunk == 0
            for ox in range(0, 4 * b, b):
                a0, lo = win.first_chunk(ox, m)
                assert a0 % win.chunk == 0 and 0 <= lo < win.chunk
                assert lo + win.span <= win.cells
            assert win.chans * win.cells * cell <= INTERP1D_STAGE_BYTES
            assert (win.chans == 0) == (win.cells * cell > INTERP1D_STAGE_BYTES)
            assert win.chans <= C
            assert win.smem == sb * row_pitch(2 * m, sb) * (m + 4) + win.chans * win.cells * cell
            assert win.smem <= 48 * 1024
    win = interp1d_window(b0, m, m + 4, sb, ncomp)
    per_block = [n / (1_572_864 // b0) for n in (1_000_000, 10_000_000, 15_729)]
    assert [interp1d_staged(int(n), win) for n in per_block] == [True, True, False]
    # The main path's outputs: at 1M points scattered up to 8 MiB (every
    # value type but complex128, whose 15.3 MiB are gathered), stored sorted
    # and gathered at 10M (38-153 MiB).
    assert [interp1d_gathers(n, 1, cell) for n in (1_000_000, 10_000_000)] == [cell == 16, True]


def test_1d_gather_puts_sorted_results_in_order(monkeypatch):
    """The gather pass's arithmetic, ``out[c, i] = sorted[c, inv[i]]`` with
    the plan's ``sort_perm_inv`` (made here for a small plan by forcing the
    gather), equals the plain interpolation's scatter to ``perm[j]``."""
    monkeypatch.setattr(blocked, "interp1d_gathers", lambda *args: True)
    plan, _, g = _interp1d_plan("main_512", np.complex128, seed=7)
    inv = plan.sort_perm_inv.long()
    assert plan.sort_perm_inv.dtype == torch.int32
    assert torch.equal(plan.sort_perm[inv], torch.arange(plan.num_points))
    want = blocked.interpolate_blocked_plain(plan, g)
    in_sorted = want[:, plan.sort_perm]  # what the kernel stores, sorted
    assert torch.equal(in_sorted[:, inv], want)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("C", [1, 2])
def test_1d_inverse_only_where_the_gather_runs(dtype, C):
    """``set_points`` keeps ``sort_perm_inv`` exactly for the 1D plans whose
    interpolation outputs take the gather (``interp1d_gathers`` at the
    plan's transforms); the inverse, where made, puts ``sort_perm`` back in
    order.  Held at the threshold's two sides without building such a plan:
    ``interp1d_inverse`` on a permutation of the size that crosses it."""
    plan, _, _ = _interp1d_plan("main_512", dtype)
    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    assert plan.sort_perm_inv is None
    plan = dataclasses.replace(plan, ntransforms=C)
    edge = INTERP1D_GATHER_BYTES // (C * sb * ncomp)
    assert blocked.interp1d_inverse(plan, torch.arange(edge)) is None
    perm = torch.randperm(edge + 1, generator=torch.Generator().manual_seed(C))
    inv = blocked.interp1d_inverse(plan, perm)
    assert inv.dtype == torch.int32 and torch.equal(perm[inv.long()], torch.arange(edge + 1))
    plan2 = tnufft.PlanNUFFT(dtype, (8, 8), m=2, sigma=2.0, ntransforms=C,
                             spread_method="blocked", device="cpu")
    assert blocked.interp1d_inverse(plan2, perm) is None  # 2D: no gather


def emulate_interp_2d(plan, grid: torch.Tensor, chunked: bool = True, log=None) -> torch.Tensor:
    """The 2D interpolation kernel's reads in float64 on the CPU, from the
    shared row geometry (``interp2d_rows``): a point whose row window lies
    within the row reads each of its 2M rows as whole chunks from the chunk
    that holds the row's first cell, with its y taps shifted to that offset
    and zero on the other loaded cells; any other point (or every point when
    ``chunked`` is False) reads its 2M x 2M cells with periodic wrap.  Rows
    wrap in x either way.  ``grid`` (C, n0, n1); returns (C, Np) in the
    caller's point order.  ``log``, a list, receives each point's path
    (True: whole chunks)."""
    m, S = plan.m, 2 * plan.m
    n0, n1 = plan.shape_over
    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    rows = interp2d_rows(m, sb, ncomp)
    wx, wy = blocked.window_weights_blocked_plain(plan).to(torch.float64)  # (S, Np) each
    g = grid.to(torch.complex128 if grid.is_complex() else torch.float64)
    cx = plan.cells_sorted[0].to(torch.int64) - (m - 1)
    cy = plan.cells_sorted[1].to(torch.int64) - (m - 1)
    whole = torch.tensor([rows.whole(int(y), n1, chunked) for y in cy], dtype=torch.bool)
    if log is not None:
        log.extend(whole.tolist())
    xs = (cx[:, None] + torch.arange(S)) % n0  # (Np, S): the rows, wrapped
    taps = torch.zeros((plan.num_points, rows.width), dtype=torch.float64)
    ys = torch.zeros((plan.num_points, rows.width), dtype=torch.int64)
    for j in range(plan.num_points):
        if whole[j]:
            y0, shift = rows.first_chunk(int(cy[j]))
            assert y0 % rows.per == 0 and shift + S <= rows.width
            taps[j, shift:shift + S] = wy[:, j]
            ys[j] = y0 + torch.arange(rows.width)
        else:
            taps[j, :S] = wy[:, j]
            ys[j, :S] = (cy[j] + torch.arange(S)) % n1
    assert not whole.any() or int(ys[whole].max()) < n1  # whole chunks never wrap
    out = torch.zeros((grid.shape[0], plan.num_points), dtype=g.dtype)
    for c in range(grid.shape[0]):
        vals = g[c][xs[:, :, None], ys[:, None, :]]  # (Np, S, width)
        r = (vals * taps[:, None, :]).sum(-1)
        out[c] = (r * wx.T).sum(-1) * plan.normfactor
    res = torch.empty_like(out)
    res[:, plan.sort_perm] = out
    return res.to(plan.dtype)


# (shape, sigma, m, block_dims, transforms, points, where): the main path's
# 8 x 24 blocks on a small grid; half the points within 0.3 of an edge, so
# windows wrap in both dims; a grid of odd rows (45 cells: whole chunks only
# for complex128); every M's chunk geometry at 2, 3, 7 and 10; taps from K3.
INTERP2D_CASES = {
    "main_8x24": ((64, 64), 1.5, 4, (8, 24), 1, None, 2_000, "uniform"),
    "edges": ((20, 24), 1.5, 4, None, 2, None, 1_500, "edges"),
    "odd_rows": ((20, 21), 2.0, 4, None, 2, None, 1_500, "edges"),
    "m2": ((16, 16), 2.0, 2, None, 1, None, 1_000, "edges"),
    "m3": ((16, 16), 2.0, 3, None, 1, None, 1_000, "uniform"),
    "m7": ((24, 24), 2.0, 7, None, 1, None, 1_000, "edges"),
    "m10": ((16, 24), 2.0, 10, None, 3, None, 1_000, "edges"),
    "k3_taps": ((20, 24), 2.0, 4, None, 1, "GaussianKernel", 1_000, "edges"),
}


def _interp2d_plan(case, dtype, seed=0):
    shape, sigma, m, bd, C, kernel, np_, where = INTERP2D_CASES[case]
    rng = np.random.default_rng(seed)
    kw = {} if kernel is None else dict(kernel=getattr(tnufft, kernel)())
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=bd, device="cpu", **kw)
    pts = random_points(rng, 2, np_, dtype, lo=-1.0, hi=7.0)
    if where == "edges":  # half the points within 0.3 of an edge
        pts[:, ::2] = random_points(rng, 2, -(-np_ // 2), dtype, lo=-0.3, hi=0.3)
    plan = tnufft.set_points(plan, pts)
    g = random_complex(rng, np.complex128, (C,) + plan.shape_over)
    if not plan.dtype.is_complex:
        g = g.real.copy()
    return plan, pts, torch.from_numpy(g).to(plan.dtype)


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("case", list(INTERP2D_CASES))
def test_emulated_2d_rows_match_plain_interp(case, dtype):
    """Each point's reads as the 2D interpolation kernel makes them, whole
    chunks with shifted taps or cell by cell with wrap, against the plain
    interpolation (1e-12 in float64 of the same taps and cells); both paths
    taken where windows wrap, none whole on rows that are not whole
    chunks, and the same values with every point read cell by cell."""
    np_dtype = {torch.complex64: np.complex64, torch.complex128: np.complex128,
                torch.float32: np.float32, torch.float64: np.float64}[dtype]
    plan, _, g = _interp2d_plan(case, np_dtype)
    n1 = plan.shape_over[1]
    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    rows = interp2d_rows(plan.m, sb, ncomp)
    chunked = n1 % rows.per == 0
    log = []
    got = emulate_interp_2d(plan, g, chunked, log)
    if case == "odd_rows" and plan.dtype.is_complex:  # a real plan's rows are even
        assert n1 % 2 == 1 and chunked == (sb * ncomp == 16)
    if chunked:
        assert any(log) and (case == "main_8x24" or not all(log))
    else:
        assert not any(log)
    want = blocked.interpolate_blocked_plain(plan, g)
    tol = 1e-12 if sb == 8 else 1e-6
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got.numpy(), want.numpy()) <= tol
    if chunked:
        cells = emulate_interp_2d(plan, g, False)
        assert rel_err(got.to(torch.complex128).numpy(),
                       cells.to(torch.complex128).numpy()) <= (1e-14 if sb == 8 else 1e-7)


def test_emulated_2d_rows_match_jax_interp():
    """The kernel's reads against the JAX package's reference interpolation
    (its CPU path) on the same points and grid, complex128, two transforms,
    windows wrapping at every edge."""
    plan, pts, g = _interp2d_plan("edges", np.complex128, seed=3)
    shape, sigma, m = INTERP2D_CASES["edges"][:3]
    jp = jnufft.PlanNUFFT(np.complex128, shape, m=m, sigma=sigma, ntransforms=2)
    assert tuple(jp.shape_over) == plan.shape_over
    want = j_interp(jp.kernel_data, jp.evalmode, jnp.asarray(g.numpy()), jnp.asarray(pts),
                    plan.normfactor)
    got = emulate_interp_2d(plan, g)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("m", list(range(2, 11)))
def test_2d_interp_rows_and_coefficient_table(dtype, m):
    """The 2D interpolation kernel's host-side pieces: each row's chunks
    hold the 2M cells at every offset in whole 16-byte loads; the rows in
    flight fit ``INTERP2D_LOAD_REGS`` (one at least); the register cap
    leaves at least the registers the taps and a row need, and the
    instantiations that keep the first design's loop run uncapped; the two
    coefficient tables in shared memory stay below 48 KB; and Horner's rule
    on the coefficient-major ``(ncoef, row_pitch)`` tables, laid out as
    ``coefficient_rows`` lays them (zero past 2M in each row), gives the
    plain taps."""
    _, sb, ncomp = VALUE_TYPES[dtype]
    S = 2 * m
    rows = interp2d_rows(m, sb, ncomp)
    assert rows.per * sb * ncomp == 16 and rows.width == rows.chunks * rows.per
    assert all(shift + S <= rows.width for shift in range(rows.per))
    assert rows.width - S < 2 * rows.per
    row_regs = rows.chunks * 16 // 4
    assert 1 <= rows.rows_in_flight <= S
    assert rows.rows_in_flight * row_regs <= INTERP2D_LOAD_REGS or rows.rows_in_flight == 1
    assert rows.first_chunk(0) == (0, 0) and rows.whole(0, rows.width, True)
    assert rows.whole(rows.per, rows.per + rows.width, True)
    assert not rows.whole(rows.per, rows.per + rows.width - 1, True)
    assert not rows.whole(-1, 10 * rows.width, True) and not rows.whole(0, 99, False)
    ctas = interp2d_min_ctas(sb, ncomp, m)
    cap = min(65536 // (ctas * INTERP2D_THREADS), 255)
    assert 1 <= ctas <= 3 and cap >= 2 * S * sb // 4 + min(row_regs, INTERP2D_LOAD_REGS)
    assert (ctas == 1) >= (not interp2d_chunked_rows(sb, ncomp, m))
    plan = tnufft.PlanNUFFT({4: np.complex64, 8: np.complex128}[sb], (32, 32), m=m,
                            sigma=2.0, spread_method="blocked", device="cpu")
    coefs = coefficient_stack(plan.kernel_data).to(torch.float64)  # (2, S, ncoef)
    ncoef = coefs.shape[-1]
    per_dim = row_pitch(S, sb) if interp2d_chunked_rows(sb, ncomp, m) else S
    assert interp2d_smem_bytes(m, ncoef, sb, ncomp) == 2 * sb * per_dim * ncoef <= 48 * 1024
    pitch = row_pitch(S, sb)
    table = torch.zeros(2 * pitch * ncoef, dtype=torch.float64)
    for i in range(table.numel()):  # csrc/interp_2d.cu:coefficient_rows
        d, r = divmod(i, pitch * ncoef)
        q, t = divmod(r, pitch)
        table[i] = coefs[d, t, q] if t < S else 0.0
    X = torch.linspace(0, 1, 7, dtype=torch.float64)[:-1]
    for d in range(2):
        rows_d = table[d * pitch * ncoef:(d + 1) * pitch * ncoef].view(ncoef, pitch)
        z = 2 * X - 1
        acc = rows_d[ncoef - 1][:, None].expand(pitch, X.numel()).clone()
        for q in range(ncoef - 2, -1, -1):  # window.cuh:horner_rows
            acc = acc * z + rows_d[q][:, None]
        assert torch.equal(acc[S:], torch.zeros_like(acc[S:]))
        want = window_weights(plan.kernel_data[d], plan.evalmode, X[None, :], coefs[d])
        assert torch.allclose(acc[:S], want, rtol=0, atol=1e-13)


def test_2d_interp_design_table_matches_the_kernel():
    """``INTERP2D_ROWS_M`` (where the 2D interpolation reads whole-chunk
    rows) is the bit mask of ``csrc/interp_2d.cu:rows_mask`` for each value
    type, and every M of the kernels is in range."""
    import re
    from pathlib import Path

    src = (Path(blocked.__file__).resolve().parent.parent.parent / "csrc" / "interp_2d.cu").read_text()
    body = re.search(r"rows_mask\(int scalar_bytes, int ncomp\) \{\n  return (.*?);\n\}", src, re.S)
    masks = [int(h, 16) for h in re.findall(r"0x([0-9A-F]+)u", body.group(1))]
    # scalar_bytes == 4 ? (complex : real) : (complex : real)
    for (sb, ncomp), mask in zip([(4, 2), (4, 1), (8, 2), (8, 1)], masks):
        assert {m for m in range(2, 11) if mask >> m & 1} == set(INTERP2D_ROWS_M[sb, ncomp])
    assert all(mk >> 11 == 0 and mk & 3 == 0 for mk in masks)
