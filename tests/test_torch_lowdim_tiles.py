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
    SPREAD1D_THREADS,
    VALUE_TYPES,
    row_pitch,
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


@pytest.mark.parametrize("stem, table", [("spread_1d", "SPREAD1D_PARTS"),
                                         ("spread_1d", "SPREAD1D_VARIANTS"),
                                         ("interp_2d", "INTERP2D_PARTS")])
def test_probe_parts_edit_the_shipped_sources(stem, table):
    """Every line that ``chip_probe.py --spread1d-parts`` / ``--interp2d-parts``
    replaces to take a phase out, and that ``--spread1d`` replaces for a
    variant, is in the shipped kernel's source, and each copy differs from
    it: a stale edit would fail the probe on the card."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_probe.py"
    spec = importlib.util.spec_from_file_location("chip_probe_parts", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    parts = getattr(probe, table)
    texts = probe._edited_sources(stem, parts, (4, 8, 10))
    assert "CASE(4) CASE(8) CASE(10)" in texts["shipped"]
    assert set(texts) == {"shipped", *parts}
    assert all(texts[k] != texts["shipped"] for k in parts)

