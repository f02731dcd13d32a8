"""The hand-written CUDA kernels against their plain PyTorch versions on the
card.  Needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; elsewhere every test
here skips.  The file imports no JAX, so on a GPU host without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -s
"""

import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch import execution as ex
from nonuniformffts_tpu_torch import plan as plan_module
from nonuniformffts_tpu_torch.ops import deconvolve
from nonuniformffts_tpu_torch.ops.kernels import blocked, build, common
from nonuniformffts_tpu_torch.ops.kernels import deconvolve as kernels
from nonuniformffts_tpu_torch.ops.kernels.common import (
    INTERP3D_SPARSE,
    INTERP3D_THREADS,
    deconvolve_entry_name,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# float32 atomics add in a run-dependent order (~1e-7 expected); float64
# atomics reorder sums at ~1e-16.
KERNEL_TOL = {4: 1e-5, 8: 1e-12}
DTYPES = [np.complex64, np.complex128, np.float32, np.float64]


def _values(rng, dtype, shape):
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _rel_err(a, b) -> float:
    return float(((a - b).abs().pow(2).sum() / b.abs().pow(2).sum()).sqrt())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_toolchain(cuda_device):
    """Record which toolchain the GPU host has."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    has_nvcc = Path(nvcc).exists()
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"triton {triton_version}, nvcc {'found' if has_nvcc else 'missing'}")
    if has_nvcc:
        print(subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1])
    print(torch.cuda.get_device_name(0))
    assert has_nvcc


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize(
    "shape,block_dims",
    [((32, 32, 32), None), ((64, 48), None), ((64, 48), (16, 24)),
     ((4096,), None), ((4096,), (512,))],
    ids=str,
)
def test_kernels_match_plain_versions(cuda_device, shape, block_dims, m, dtype):
    """Each spread and interpolation entry point (3D at 32^3, grid 48^3; 2D
    at 64 x 48; 1D at 4096, ~3 points a cell) against its plain version,
    with the launch counts moving."""
    rng = np.random.default_rng(m)
    D = len(shape)
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=1.5, ntransforms=2,
                            spread_method="blocked", block_dims=block_dims,
                            device=cuda_device)
    real = np.dtype(dtype).type(0).real.dtype
    pts = rng.uniform(-1.0, 7.0, (D, 20_000)).astype(real)
    pts[:, :50] = np.nextafter(real.type(2 * np.pi), real.type(0))
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(cuda_device))
    vp = torch.from_numpy(_values(rng, dtype, (2, 20_000))).to(cuda_device)
    grid = torch.from_numpy(_values(rng, dtype, (2,) + plan.shape_over)).to(cuda_device)
    spread = blocked.entry_point("spread", plan)
    interp = blocked.entry_point("interp", plan)
    assert f"_{D}d_" in spread and f"_{D}d_" in interp
    before = dict(blocked.LAUNCHES)
    g_k = blocked.spread_blocked(plan, vp)
    v_k = blocked.interpolate_blocked(plan, grid)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[spread] == before[spread] + 1
    assert blocked.LAUNCHES[interp] == before[interp] + 1
    g_p = blocked.spread_blocked_plain(plan, vp)
    v_p = blocked.interpolate_blocked_plain(plan, grid)
    tol = KERNEL_TOL[np.dtype(real).itemsize]
    assert g_k.dtype == g_p.dtype == plan.dtype
    assert _rel_err(g_k, g_p) <= tol
    assert _rel_err(v_k, v_p) <= tol


WINDOWS = [
    ("KaiserBesselKernel", "FastApproximation"),
    ("KaiserBesselKernel", "Direct"),
    ("BackwardsKaiserBesselKernel", "FastApproximation"),
    ("BackwardsKaiserBesselKernel", "Direct"),
    ("GaussianKernel", "FastApproximation"),
    ("GaussianKernel", "Direct"),
    ("BSplineKernel", "FastApproximation"),
    ("BSplineKernel", "Direct"),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("m", [3, 10])
@pytest.mark.parametrize("shape", [(24, 24, 24), (64, 48), (4096,)], ids=str)
@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_window_kernels_match_plain_versions(cuda_device, window, shape, m, dtype):
    """Every window in both modes, at m = 3 and m = 10 (sigma = 2), each
    entry point against its plain version; the spread and interpolation
    launch no K3, whose taps the plan holds from set_points.  The plain fast
    Gaussian uses fast Gaussian gridding, the kernels one exp per node: they
    agree to rounding."""
    rng = np.random.default_rng(m + 17)
    D = len(shape)
    kernel, mode = (getattr(tnufft, n)() for n in window)
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=2.0, ntransforms=2, kernel=kernel,
                            kernel_evalmode=mode, spread_method="blocked",
                            device=cuda_device)
    real = np.dtype(dtype).type(0).real.dtype
    pts = rng.uniform(-1.0, 7.0, (D, 5_000)).astype(real)
    pts[:, :20] = np.nextafter(real.type(2 * np.pi), real.type(0))
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(cuda_device))
    vp = torch.from_numpy(_values(rng, dtype, (2, 5_000))).to(cuda_device)
    grid = torch.from_numpy(_values(rng, dtype, (2,) + plan.shape_over)).to(cuda_device)
    spread = blocked.entry_point("spread", plan)
    interp = blocked.entry_point("interp", plan)
    weights = blocked.WEIGHTS_ENTRY[plan.real_dtype]
    horner = blocked.kernel_coefs(plan)[0] is not None
    before = dict(blocked.LAUNCHES)
    g_k = blocked.spread_blocked(plan, vp)
    v_k = blocked.interpolate_blocked(plan, grid)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[spread] == before[spread] + 1
    assert blocked.LAUNCHES[interp] == before[interp] + 1
    assert blocked.LAUNCHES[weights] == before[weights]  # K3 ran in set_points
    g_p = blocked.spread_blocked_plain(plan, vp)
    v_p = blocked.interpolate_blocked_plain(plan, grid)
    tol = KERNEL_TOL[np.dtype(real).itemsize]
    assert torch.isfinite(torch.view_as_real(g_k) if g_k.is_complex() else g_k).all()
    assert _rel_err(g_k, g_p) <= tol
    assert _rel_err(v_k, v_p) <= tol
    if not horner:  # K3 against its plain version, the kernels' tap twin
        w_k = blocked.window_weights_blocked(plan)
        assert w_k.shape == (D, 2 * m, 5_000)
        assert _rel_err(w_k, blocked.window_weights_blocked_plain(plan)) <= tol


# The 3D spread kernel's edges (csrc/spread_3d.cu): (shape, sigma, m,
# block_dims, transforms, where the points lie).
SPREAD_3D_CASES = {
    # pd0 = 12 (not a multiple of 8), pd2 = 13 (odd): ragged row and n-tiles.
    "ragged": ((20, 24, 16), 1.5, 4, (5, 4, 6), 1, "uniform"),
    # n2 = 27: z rows start on odd cells, so float pairs meet the vector
    # reduction's alignment edge on every other row.
    "odd_n2": ((20, 16, 18), 1.5, 4, (5, 6, 3), 1, "uniform"),
    "m2": ((16, 16, 16), 2.0, 2, None, 1, "uniform"),
    # (8, 8, 8) at m = 10: several units a warp's worth, so several passes.
    "m10_passes": ((16, 16, 16), 2.0, 10, (8, 8, 8), 1, "uniform"),
    "three_transforms": ((20, 24, 16), 1.5, 4, None, 3, "uniform"),
    "empty_blocks": ((32, 32, 32), 1.5, 4, None, 1, "corner"),
    # complex64's main-path block dims, whatever the dtype.
    "blocks_888": ((32, 32, 32), 1.5, 4, (8, 8, 8), 1, "uniform"),
    # Half the points within 0.3 of a face, so every face's halo wraps.
    "wrapped_faces": ((20, 24, 16), 1.5, 4, None, 2, "faces"),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("case", list(SPREAD_3D_CASES))
def test_spread_3d_matches_plain_version(cuda_device, case, dtype):
    """Each 3D spread entry point (the tensor-core kernel) against its plain
    version on the kernel's edge cases, with its launch count moving."""
    shape, sigma, m, block_dims, C, where = SPREAD_3D_CASES[case]
    rng = np.random.default_rng(len(case))
    real = np.dtype(dtype).type(0).real.dtype
    np_ = 6_000
    if where == "uniform":
        pts = rng.uniform(-1.0, 7.0, (3, np_))
    elif where == "corner":  # one octant: most blocks hold no point
        pts = rng.uniform(0.0, np.pi / 2, (3, np_))
    else:
        pts = rng.uniform(-0.3, 0.3, (3, np_))
        pts[:, ::2] = rng.uniform(0.0, 2 * np.pi, (3, np_ // 2))
    pts = pts.astype(real)
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=block_dims,
                            device=cuda_device)
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(cuda_device))
    if where == "corner":
        assert (plan.pstarts[1:] == plan.pstarts[:-1]).any()
    vp = torch.from_numpy(_values(rng, dtype, (C, np_))).to(cuda_device)
    name = blocked.entry_point("spread", plan)
    assert name.startswith("nufft_spread_3d_")
    before = blocked.LAUNCHES[name]
    g_k = blocked.spread_blocked(plan, vp)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[name] == before + 1
    g_p = blocked.spread_blocked_plain(plan, vp)
    assert g_k.dtype == g_p.dtype == plan.dtype
    assert _rel_err(g_k, g_p) <= KERNEL_TOL[np.dtype(real).itemsize]


# The 3D shared-staging kernel (csrc/spread_3d.cu:spread_3d_shared_kernel,
# launches of C > 1 transforms) at three densities and over several passes:
# (shape, sigma, m, block_dims, points, where they lie, what the blocks hold).
SHARED_3D_CASES = {
    # ~9 points a block: every block fits one batch (staged once).
    "one_batch": ((32, 32, 32), 1.5, 4, (8, 8, 8), 2_000, "uniform", "one_batch"),
    # ~93 points a block: most blocks take two batches, restaged a transform.
    "restaged": ((32, 32, 32), 1.5, 4, (8, 8, 8), 20_000, "uniform", "some_restaged"),
    # One octant: most blocks empty, the rest one batch.
    "empty_blocks": ((32, 32, 32), 1.5, 4, (8, 8, 8), 100, "corner", "some_empty"),
    # m = 10 at (8, 8, 8): several passes of 16 warps over one staged batch.
    "m10_passes": ((16, 16, 16), 2.0, 10, (8, 8, 8), 2_000, "uniform", "one_batch"),
    # m = 2 at (4, 4, 4): two warps a CTA, whose shared memory holds the
    # values of 7 transforms, where L2 would allow 83 to 334.
    "small_blocks": ((16, 16, 16), 2.0, 2, (4, 4, 4), 2_000, "uniform", "some_empty"),
}


def _shared_plan(case, dtype, C, device, seed):
    shape, sigma, m, bd, np_, where, holds = SHARED_3D_CASES[case]
    rng = np.random.default_rng(seed)
    real = np.dtype(dtype).type(0).real.dtype
    hi = np.pi / 2 if where == "corner" else 2 * np.pi
    pts = rng.uniform(0.0, hi, (3, np_)).astype(real)
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=bd, device=device)
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(device))
    counts = plan.pstarts[1:] - plan.pstarts[:-1]
    batch = common.SPREAD3D_BATCH
    assert {"one_batch": bool(counts.max() <= batch),
            "some_restaged": bool((counts > batch).any()),
            "some_empty": bool((counts == 0).any() and counts.max() <= batch)}[holds]
    vp = torch.from_numpy(_values(rng, dtype, (C, np_))).to(device)
    return plan, vp, KERNEL_TOL[np.dtype(real).itemsize]


def _shared_launch(plan, vp):
    """One spread launch of ``vp``'s transforms; checks that it is one
    launch and that the shared-staging kernel served its transforms where
    a CTA serves more than one (every case but ``m10_passes`` in
    complex128, whose padded blocks exceed SPREAD3D_CTA_GRID_BYTES / 2)."""
    name = blocked.entry_point("spread", plan)
    before = blocked.LAUNCHES[name], blocked.SPREAD3D_SHARED[name]
    grid = blocked.spread_blocked(plan, vp)
    torch.cuda.synchronize()
    C = vp.shape[0]
    _, sb, ncomp = common.VALUE_TYPES[plan.dtype]
    shared = common.spread3d_cta_transforms(plan.block_dims, plan.m, blocked.kernel_coefs(plan)[1],
                                            sb, ncomp, C) > 1
    assert blocked.LAUNCHES[name] == before[0] + 1
    assert blocked.SPREAD3D_SHARED[name] == before[1] + (C if shared else 0)
    return grid


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("C", [2, 3, 32])
@pytest.mark.parametrize("case", list(SHARED_3D_CASES))
def test_spread_3d_shared_staging_matches_one_transform_launches(cuda_device, case, C, dtype):
    """A 3D spread launch of C transforms (the shared-staging kernel)
    against C launches of one transform each (the per-transform kernel) and
    against the plain version, transform by transform."""
    plan, vp, tol = _shared_plan(case, dtype, C, cuda_device, seed=C + len(case))
    g_k = _shared_launch(plan, vp)
    g_p = blocked.spread_blocked_plain(plan, vp)
    assert g_k.shape == g_p.shape and g_k.dtype == g_p.dtype == plan.dtype
    for c in range(C):
        g_1 = _shared_launch(plan, vp[c : c + 1])[0]
        assert _rel_err(g_k[c], g_1) <= tol
        assert _rel_err(g_k[c], g_p[c]) <= tol


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("case", ["one_batch", "small_blocks"])
def test_spread_3d_shared_staging_in_groups_of_transforms(cuda_device, case, dtype):
    """More transforms than one CTA serves
    (``common.spread3d_cta_transforms``, set by L2 at (8, 8, 8) and by
    shared memory at the small blocks): CTAs of a group each along
    blockIdx.y, the last one short, against the plain version."""
    bd, m = SHARED_3D_CASES[case][3], SHARED_3D_CASES[case][2]
    plan, _, _ = _shared_plan(case, dtype, 1, cuda_device, seed=5)
    _, sb, ncomp = common.VALUE_TYPES[plan.dtype]
    cta = common.spread3d_cta_transforms(bd, m, blocked.kernel_coefs(plan)[1], sb, ncomp, 10_000)
    C = 2 * cta + 3
    plan, vp, tol = _shared_plan(case, dtype, C, cuda_device, seed=5)
    assert 1 < cta < C
    g_k = _shared_launch(plan, vp)
    g_p = blocked.spread_blocked_plain(plan, vp)
    for c in sorted({0, cta - 1, cta, 2 * cta, C - 1}):
        assert _rel_err(g_k[c], g_p[c]) <= tol


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("C, chunk", [(7, 3), (3, 2)])
def test_spread_3d_groups_of_many_transforms(cuda_device, C, chunk, dtype):
    """A grouped 3D exec (7 transforms in groups of 3, 2 and 2; 3 in groups
    of 2 and 1): each group of more than one transform runs the
    shared-staging kernel, one of a single transform the per-transform
    kernel; the same as the one-pass exec, which runs all C shared."""
    import dataclasses

    plan, vp, _ = _shared_plan("one_batch", dtype, C, cuda_device, seed=11)
    grouped = dataclasses.replace(plan, transform_chunk=chunk)
    sizes = [g.stop - g.start for g in plan_module.transform_groups(C, chunk)]
    name = blocked.entry_point("spread", plan)
    before = blocked.LAUNCHES[name], blocked.SPREAD3D_SHARED[name]
    got = tnufft.exec_type1(grouped, vp)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[name] == before[0] + len(sizes)
    shared = sum(n for n in sizes if n > 1)
    assert blocked.SPREAD3D_SHARED[name] == before[1] + shared
    want = tnufft.exec_type1(plan, vp)
    torch.cuda.synchronize()
    assert blocked.SPREAD3D_SHARED[name] == before[1] + shared + C
    real = np.dtype(dtype).type(0).real.dtype
    assert _rel_err(got, want) <= (1e-6 if real == np.float32 else 1e-12)


# The pipelined one-transform kernel (csrc/spread_3d.cu:spread_3d_kernel):
# persistent CTAs walking (block, transform) items, their batches chained
# across blocks.  (shape, sigma, block_dims, transforms, where the points
# lie.)  "sized": four blocks of exactly 1, 64, 65 and 1,500 points (a
# batch, one over it, 24 batches) among ~1.5 points a block elsewhere, so
# empty blocks lie between full ones and each CTA walks several of the
# 1,728 blocks; "few": only those four blocks, fewer non-empty blocks than
# resident CTAs; "three": three transforms of 48^3-cell blocks, each CTA a
# (block, transform) item (``common.spread3d_cta_transforms`` 1), several
# passes of 16 warps and at some M one operand buffer.
PIPELINED_CASES = {
    "sized": ((64, 64, 64), 1.5, (8, 8, 8), 1, "sized"),
    "few": ((32, 32, 32), 1.5, (8, 8, 8), 1, "four_blocks"),
    "three": ((64, 64, 64), 1.5, (48, 48, 48), 3, "uniform"),
}
#: Points of the four sized blocks (at 5%, 30%, 55% and 80% of the block
#: ids).
SIZED_BLOCKS = (1, 64, 65, 1_500)


def _sized_points(rng, plan, background: float, real) -> np.ndarray:
    """``SIZED_BLOCKS`` points in four blocks and ``background`` points a
    block, on average, in the others; (3, Np) in [0, 2 pi)."""
    from nonuniformffts_tpu_torch import blocking

    nb = blocking.num_blocks(plan.shape_over, plan.block_dims)
    nblocks = int(np.prod(nb))
    h = 2 * np.pi / np.array(plan.shape_over)
    side = np.array(plan.block_dims) * h
    ids = [int(f * nblocks) for f in (0.05, 0.30, 0.55, 0.80)]
    parts = []
    for bid, count in zip(ids, SIZED_BLOCKS):
        lo = np.array(np.unravel_index(bid, nb)) * side
        parts.append(lo[:, None] + rng.uniform(0.01, 0.99, (3, count)) * side[:, None])
    if background:  # none within a cell of the four blocks
        pts = rng.uniform(0.0, 2 * np.pi, (3, int(background * nblocks)))
        cell = (pts / h[:, None]).astype(int)
        keep = np.ones(pts.shape[1], dtype=bool)
        for bid in ids:
            lo = np.array(np.unravel_index(bid, nb)) * np.array(plan.block_dims)
            hi = lo + np.array(plan.block_dims)
            keep &= ~((cell >= lo[:, None] - 1) & (cell <= hi[:, None])).all(axis=0)
        parts.append(pts[:, keep])
    pts = np.concatenate(parts, axis=1)
    return pts[:, rng.permutation(pts.shape[1])].astype(real)


def _pipelined_launch(plan, vp, tol):
    """One spread launch of ``vp`` against the plain version: one launch,
    C transforms served by the pipelined kernel and none by the shared one,
    and the kernel's device counter moved by C x passes x the sum over the
    blocks of ceil(points / 64) batches, all but each working CTA's first
    staged while another batch's MMAs ran where a CTA holds two operand
    buffers (none with one).  A zeroed counter from which the CTAs take
    their items is allocated for the launch."""
    name = blocked.entry_point("spread", plan)
    _, sb, ncomp = common.VALUE_TYPES[plan.dtype]
    ncoef = blocked.kernel_coefs(plan)[1]
    C = vp.shape[0]
    assert common.spread3d_cta_transforms(plan.block_dims, plan.m, ncoef, sb, ncomp, C) == 1
    before = (blocked.LAUNCHES[name], blocked.SPREAD3D_PIPELINED[name],
              blocked.SPREAD3D_SHARED[name], blocked.spread3d_batches(plan.dtype))
    g_k = blocked.spread_blocked(plan, vp)
    staged, overlapped = (a - b for a, b in zip(blocked.spread3d_batches(plan.dtype), before[3]))
    assert blocked.LAUNCHES[name] == before[0] + 1
    assert blocked.SPREAD3D_PIPELINED[name] == before[1] + C
    assert blocked.SPREAD3D_SHARED[name] == before[2]
    g_p = blocked.spread_blocked_plain(plan, vp)
    assert g_k.dtype == g_p.dtype == plan.dtype
    assert _rel_err(g_k, g_p) <= tol
    t = common.spread_tiles(plan.block_dims, plan.m, ncomp)
    counts = (plan.pstarts[1:] - plan.pstarts[:-1]).tolist()
    assert staged == C * t.passes * sum(-(-n // common.SPREAD3D_BATCH) for n in counts)
    if common.spread3d_buffers(plan.block_dims, plan.m, ncoef, sb, ncomp) == 1:
        assert overlapped == 0
        return
    # Each CTA that took an item staged its first batch alone; which CTAs
    # took items depends on the timing.
    sms = torch.cuda.get_device_properties(plan.pstarts.device).multi_processor_count
    ctas = common.spread3d_persistent_ctas(plan.block_dims, plan.m, ncoef, sb, ncomp,
                                           len(counts) * C, sms)
    if t.warps != 8:  # the register file's residency then follows what ptxas gives
        ctas = len(counts) * C
    assert 1 <= staged - overlapped <= min(ctas, sum(1 for n in counts if n) * C)


def _pipelined_plan(case, dtype, m, device, window=None):
    shape, sigma, bd, C, where = PIPELINED_CASES[case]
    rng = np.random.default_rng(m + len(case))
    real = np.dtype(dtype).type(0).real.dtype
    kw = {} if window is None else {"kernel": window, "kernel_evalmode": tnufft.Direct()}
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=bd, device=device, **kw)
    if where == "uniform":
        pts = rng.uniform(0.0, 2 * np.pi, (3, 5_000)).astype(real)
    else:
        pts = _sized_points(rng, plan, 1.5 if where == "sized" else 0.0, real)
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(device))
    counts = plan.pstarts[1:] - plan.pstarts[:-1]
    if where != "uniform":
        assert sorted(counts[counts > 64].tolist())[-2:] == [65, 1_500]
        assert (counts == 0).any() and (counts == 1).any() and (counts == 64).any()
    if where == "four_blocks":
        assert int((counts > 0).sum()) == 4
    vp = torch.from_numpy(_values(rng, dtype, (C, pts.shape[1]))).to(device)
    return plan, vp, KERNEL_TOL[np.dtype(real).itemsize]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("m", [2, 4, 8, 10])
@pytest.mark.parametrize("case", list(PIPELINED_CASES))
def test_spread_3d_pipelined_matches_plain_version(cuda_device, case, m, dtype):
    """The pipelined one-transform kernel against the plain version, its
    counters and its batches (``_pipelined_launch``)."""
    plan, vp, tol = _pipelined_plan(case, dtype, m, cuda_device)
    _pipelined_launch(plan, vp, tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_spread_3d_pipelined_window_weights_taps(cuda_device, dtype):
    """The pipelined kernel on the window-weights kernel's taps (KB Direct:
    three build tasks, each copying its 2M taps a point) over the sized
    blocks, m = 4."""
    plan, vp, tol = _pipelined_plan("sized", dtype, 4, cuda_device, tnufft.KaiserBesselKernel())
    assert blocked.kernel_coefs(plan)[1] == 0 and plan.wtaps_sorted is not None
    _pipelined_launch(plan, vp, tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_spread_3d_pipelined_one_buffer(cuda_device, dtype):
    """8 warps a CTA whose two operand buffers would not fit beside the two
    CTAs an SM holds (50 x 1 x 1 complex blocks, 100 x 1 x 1 real, m = 4):
    the kernel stages into one, its build after every warp's MMAs."""
    complex_ = np.dtype(dtype).kind == "c"
    shape, bd = ((50, 8, 8), (50, 1, 1)) if complex_ else ((100, 8, 8), (100, 1, 1))
    rng = np.random.default_rng(7)
    real = np.dtype(dtype).type(0).real.dtype
    plan = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=2.0, spread_method="blocked",
                            block_dims=bd, device=cuda_device)
    _, sb, ncomp = common.VALUE_TYPES[plan.dtype]
    assert common.spread3d_buffers(bd, 4, blocked.kernel_coefs(plan)[1], sb, ncomp) == 1
    pts = rng.uniform(0.0, 2 * np.pi, (3, 3_000)).astype(real)
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(cuda_device))
    vp = torch.from_numpy(_values(rng, dtype, (1, 3_000))).to(cuda_device)
    _pipelined_launch(plan, vp, KERNEL_TOL[np.dtype(real).itemsize])


#: The spread's value gather (ops/kernels/blocked.py): a grid of each
#: dimension, its points on a lattice 12 cells apart, so that no cell of the
#: oversampled grid takes more than one point's taps (2M = 8 cells) and the
#: atomic adds leave every grid bit-equal from run to run.
GATHER_SHAPES = {1: (64,), 2: (64, 48), 3: (24, 24, 24)}
GATHER = "exec_type1/(1) spreading/value gather"


def _lattice_plan(dtype, shape, device, timer=None, C=2, seed=0):
    """A blocked plan on ``shape`` (sigma 1.5, M = 4) whose points sit one a
    lattice node, 12 cells apart on each axis, each at a random offset
    within its cell; and its (C, Np) values."""
    rng = np.random.default_rng(seed)
    real = np.dtype(dtype).type(0).real.dtype
    plan = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, ntransforms=C,
                            spread_method="blocked", device=device, timer=timer)
    axes = np.meshgrid(*[np.arange(0, n, 12) for n in plan.shape_over], indexing="ij")
    nodes = np.stack([a.ravel() for a in axes])
    cells = nodes + rng.uniform(0.0, 1.0, nodes.shape)
    pts = cells * (2 * np.pi / np.array(plan.shape_over, dtype=np.float64)[:, None])
    perm = rng.permutation(pts.shape[1])  # not in sorted order
    pts = torch.from_numpy(pts[:, perm].astype(real)).to(device)
    vp = torch.from_numpy(_values(rng, dtype, (C, pts.shape[1]))).to(device)
    return tnufft.set_points(plan, pts), vp


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_value_gather_section_leaves_the_grid_bit_equal(cuda_device, ndim, dtype):
    """A spread with a synchronised Timer gives the grid an untimed plan
    gives, bit for bit; the Timer holds the ``value gather`` inside the
    spreading once a type 1 in 2D and 3D, and never in 1D, whose kernel
    reads the values through the permutation itself."""
    shape = GATHER_SHAPES[ndim]
    timer = tnufft.Timer(synchronise=True)
    timed, vp = _lattice_plan(dtype, shape, cuda_device, timer=timer, seed=ndim)
    plain, _ = _lattice_plan(dtype, shape, cuda_device, seed=ndim)
    got = tnufft.exec_type1(timed, vp)
    want = tnufft.exec_type1(plain, vp)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert timer.counts["exec_type1/(1) spreading"] == 1
    assert timer.counts["exec_type1/(1) spreading/grid zero"] == 1
    gathers = [label for label in timer.times if label.endswith("value gather")]
    assert gathers == ([GATHER] if ndim > 1 else [])
    assert timer.counts.get(GATHER, 0) == (1 if ndim > 1 else 0)
    # the wrapper alone, outside any exec: its section is the top one
    grid_t, grid_p = blocked.spread_blocked(timed, vp), blocked.spread_blocked(plain, vp)
    torch.cuda.synchronize()
    assert torch.equal(grid_t, grid_p) and bool(grid_p.abs().sum() > 0)
    assert timer.counts.get("value gather", 0) == (1 if ndim > 1 else 0)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("m", [4, 9])
def test_interp_2d_rows_counter(cuda_device, m, dtype):
    """A 2D interpolation of C transforms adds C to ``INTERP2D_ROWS`` where
    the value type and M pick the whole-chunk rows (complex128 at M = 4, the
    2D deployment's plan, and every value type at M = 9), else nothing; a
    3D interpolation adds nothing."""
    C = 3
    rng = np.random.default_rng(m)
    real = np.dtype(dtype).type(0).real.dtype
    for shape in ((64, 48), (24, 24, 24)):
        plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=1.5, ntransforms=C,
                                spread_method="blocked", device=cuda_device)
        pts = torch.from_numpy(rng.uniform(0, 2 * np.pi, (len(shape), 2_000)).astype(real))
        plan = tnufft.set_points(plan, pts.to(cuda_device))
        name = blocked.entry_point("interp", plan)
        key = common.entry_point_name("interp", 2, plan.dtype)
        before = blocked.LAUNCHES[name], dict(blocked.INTERP2D_ROWS)
        u = torch.from_numpy(_values(rng, np.complex128, (C,) + plan.spectral_shape))
        tnufft.exec_type2(plan, u.to(cuda_device, torch.complex128 if real == np.float64
                                     else torch.complex64))
        torch.cuda.synchronize()
        assert blocked.LAUNCHES[name] == before[0] + 1
        _, sb, ncomp = common.VALUE_TYPES[plan.dtype]
        rows = len(shape) == 2 and m in common.INTERP2D_ROWS_M[sb, ncomp]
        assert blocked.INTERP2D_ROWS[key] == before[1][key] + (C if rows else 0)
        assert all(blocked.INTERP2D_ROWS[k] == v for k, v in before[1].items() if k != key)
        if np.dtype(dtype) == np.complex128 and m == 4:
            assert rows == (len(shape) == 2)


# The 2D spread kernel's edges (csrc/spread_2d.cu): (shape, sigma, m,
# block_dims, transforms, where the points lie, points, window).  The cases
# of tests/test_torch_spread_tiles.py:UNIT_CASES_2D, the chooser's own pick,
# points near every edge, dense blocks (tens of batches a block), and every
# window whose taps come from K3 (wtaps).
SPREAD_2D_CASES = {
    "main_8x16": ((32, 32), 1.5, 4, (8, 16), 1, "uniform", 6_000, None),
    "chosen": ((64, 48), 1.5, 4, None, 1, "uniform", 6_000, None),
    "m2": ((16, 16), 2.0, 2, (4, 8), 1, "uniform", 6_000, None),
    "m8_units": ((16, 16), 2.0, 8, (8, 8), 1, "uniform", 6_000, None),
    "multi_unit": ((32, 32), 1.5, 4, (16, 48), 1, "uniform", 6_000, None),
    # One 32 x 32 block at m = 10: the padded block (51) exceeds the grid.
    "m10_grid_below_block": ((16, 16), 2.0, 10, (32, 32), 1, "uniform", 6_000, None),
    # 40 points over 36 blocks: empty blocks, and one k-step a block.
    "sparse": ((32, 32), 1.5, 4, (8, 8), 1, "uniform", 40, None),
    "three_transforms": ((20, 24), 1.5, 4, (5, 12), 3, "uniform", 6_000, None),
    "wrapped_edges": ((20, 24), 1.5, 4, None, 2, "edges", 6_000, None),
    # ~700 points a block: 44 batches.
    "dense_blocks": ((16, 16), 1.5, 4, (8, 8), 1, "uniform", 6_000, None),
    **{f"wtaps_{k}_{e}": ((20, 24), 2.0, 3, None, 1, "uniform", 6_000, (k, e))
       for k, e in WINDOWS if (k, e) != ("KaiserBesselKernel", "FastApproximation")
       and (k, e) != ("BackwardsKaiserBesselKernel", "FastApproximation")},
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("case", list(SPREAD_2D_CASES))
def test_spread_2d_matches_plain_version(cuda_device, case, dtype):
    """Each 2D spread entry point (the tensor-core kernel, a warp a block)
    against its plain version on the kernel's edge cases and every window
    whose taps come from K3, with its launch counts moving."""
    shape, sigma, m, block_dims, C, where, np_, window = SPREAD_2D_CASES[case]
    rng = np.random.default_rng(len(case) + 3)
    real = np.dtype(dtype).type(0).real.dtype
    if where == "uniform":
        pts = rng.uniform(-1.0, 7.0, (2, np_))
    else:  # half the points within 0.3 of an edge, so every edge's halo wraps
        pts = rng.uniform(-0.3, 0.3, (2, np_))
        pts[:, ::2] = rng.uniform(0.0, 2 * np.pi, (2, np_ // 2))
    pts = pts.astype(real)
    kw = {}
    if window is not None:
        kw = dict(kernel=getattr(tnufft, window[0])(),
                  kernel_evalmode=getattr(tnufft, window[1])())
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=block_dims,
                            device=cuda_device, **kw)
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(cuda_device))
    if case == "sparse":
        assert (plan.pstarts[1:] == plan.pstarts[:-1]).any()
    vp = torch.from_numpy(_values(rng, dtype, (C, np_))).to(cuda_device)
    name = blocked.entry_point("spread", plan)
    assert name.startswith("nufft_spread_2d_")
    weights = blocked.WEIGHTS_ENTRY[plan.real_dtype]
    horner = blocked.kernel_coefs(plan)[0] is not None
    assert horner == (window is None)
    before = dict(blocked.LAUNCHES)
    g_k = blocked.spread_blocked(plan, vp)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[name] == before[name] + 1
    assert blocked.LAUNCHES[weights] == before[weights]  # K3 ran in set_points
    g_p = blocked.spread_blocked_plain(plan, vp)
    assert g_k.dtype == g_p.dtype == plan.dtype and g_k.shape == g_p.shape
    assert _rel_err(g_k, g_p) <= KERNEL_TOL[np.dtype(real).itemsize]


# The 3D interpolation kernel's edges (csrc/interp_3d.cu): the spread's, with
# 40,000 points so that most blocks are staged (>= INTERP3D_SPARSE points),
# and (shape, sigma, m, block_dims, transforms, where, points):
INTERP_3D_CASES = {
    **{k: v + (40_000,) for k, v in SPREAD_3D_CASES.items()},
    # 27 blocks of ~740 points: more points in a block than a CTA has threads.
    "dense": ((16, 16, 16), 1.5, 4, (8, 8, 8), 1, "uniform", 20_000),
    # 216 blocks of ~0.7 points, all read from global memory; half of 3,000
    # points in one block (staged), the rest ~7 a block (read from global
    # memory).
    "sparse_gather": ((32, 32, 32), 1.5, 4, (8, 8, 8), 1, "uniform", 150),
    "sparse_mixed": ((32, 32, 32), 1.5, 4, (8, 8, 8), 2, "clustered", 3_000),
    # A grid smaller than the padded window: 35 cells of a 32-cell dim.
    "grid_below_window": ((16, 16, 16), 2.0, 10, (16, 16, 16), 1, "uniform", 6_000),
    # Taps from K3 (a window without coefficients) on ragged blocks.
    "k3_taps": ((20, 24, 16), 1.5, 4, (5, 4, 6), 1, "gaussian", 40_000),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("case", list(INTERP_3D_CASES))
def test_interp_3d_matches_plain_version(cuda_device, case, dtype):
    """Each 3D interpolation entry point (the staged-window kernel) against
    its plain version on the kernel's edge cases, with its launch count
    moving: x-slab passes (m = 10, complex128), empty blocks, blocks on
    both sides of the gather threshold, more points than threads."""
    shape, sigma, m, block_dims, C, where, np_ = INTERP_3D_CASES[case]
    rng = np.random.default_rng(len(case) + 7)
    real = np.dtype(dtype).type(0).real.dtype
    if where in ("uniform", "gaussian"):
        pts = rng.uniform(-1.0, 7.0, (3, np_))
    elif where == "corner":
        pts = rng.uniform(0.0, np.pi / 2, (3, np_))
    elif where == "clustered":
        pts = rng.uniform(0.0, 2 * np.pi, (3, np_))
        pts[:, ::2] = rng.uniform(0.1, 0.9, (3, np_ // 2))
    else:
        pts = rng.uniform(-0.3, 0.3, (3, np_))
        pts[:, ::2] = rng.uniform(0.0, 2 * np.pi, (3, np_ // 2))
    pts = pts.astype(real)
    kw = dict(kernel=tnufft.GaussianKernel()) if where == "gaussian" else {}
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=block_dims,
                            device=cuda_device, **kw)
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(cuda_device))
    counts = plan.pstarts[1:] - plan.pstarts[:-1]
    if case == "dense":
        assert int(counts.max()) > INTERP3D_THREADS
    if case == "sparse_gather":
        assert int(counts.max()) < INTERP3D_SPARSE
    if case == "sparse_mixed":
        assert int(counts.max()) >= INTERP3D_SPARSE
        assert int(((counts > 0) & (counts < INTERP3D_SPARSE)).sum()) > 100
    grid = torch.from_numpy(_values(rng, dtype, (C,) + plan.shape_over)).to(cuda_device)
    name = blocked.entry_point("interp", plan)
    assert name.startswith("nufft_interp_3d_")
    before = blocked.LAUNCHES[name]
    v_k = blocked.interpolate_blocked(plan, grid)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[name] == before + 1
    v_p = blocked.interpolate_blocked_plain(plan, grid)
    assert v_k.dtype == v_p.dtype == plan.dtype and v_k.shape == (C, np_)
    assert _rel_err(v_k, v_p) <= KERNEL_TOL[np.dtype(real).itemsize]


# The 1D spread kernel's edges (csrc/spread_1d.cu): (shape, sigma, m,
# block_dims, transforms, where the points lie, points, window).  The cases
# of tests/test_torch_lowdim_tiles.py:SPREAD1D_CASES, the chooser's own
# pick, points near both ends (the halo wraps), dense cells (~40 points a
# cell, one lane's long walk), and every window whose taps come from K3.
SPREAD_1D_CASES = {
    "main_512": ((1024,), 1.5, 4, (512,), 1, "uniform", 6_000, None),
    "chosen": ((4096,), 1.5, 4, None, 1, "uniform", 20_000, None),
    "m2": ((256,), 2.0, 2, (64,), 1, "uniform", 3_000, None),
    "m8": ((512,), 2.0, 8, (256,), 1, "uniform", 6_000, None),
    "m10": ((512,), 2.0, 10, (128,), 1, "uniform", 6_000, None),
    # One block of 20 cells at m = 10: the padded block (39) exceeds the grid.
    "m10_grid_below_block": ((10,), 2.0, 10, (20,), 1, "uniform", 1_000, None),
    "ragged": ((60,), 1.5, 4, (45,), 1, "uniform", 2_000, None),
    # 40 points over 32 blocks: empty blocks and near-empty rounds.
    "sparse": ((2048,), 1.5, 4, (96,), 1, "uniform", 40, None),
    "three_transforms": ((256,), 1.5, 5, (96,), 3, "uniform", 3_000, None),
    "wrapped_edges": ((512,), 1.5, 4, (64,), 2, "edges", 6_000, None),
    "dense_cells": ((128,), 1.5, 4, (64,), 1, "uniform", 8_000, None),
    **{f"wtaps_{k}_{e}": ((512,), 2.0, 3, (128,), 1, "uniform", 6_000, (k, e))
       for k, e in WINDOWS if (k, e) != ("KaiserBesselKernel", "FastApproximation")
       and (k, e) != ("BackwardsKaiserBesselKernel", "FastApproximation")},
}


def _lowdim_plan(case_row, D, dtype, device, seed):
    shape, sigma, m, block_dims, C, where, np_, window = case_row
    rng = np.random.default_rng(seed)
    real = np.dtype(dtype).type(0).real.dtype
    if where == "uniform":
        pts = rng.uniform(-1.0, 7.0, (D, np_))
    elif where == "clustered":  # 7 points of 8 in one corner
        pts = rng.uniform(0.1, 0.9, (D, np_))
        pts[:, ::8] = rng.uniform(0.0, 2 * np.pi, (D, (np_ + 7) // 8))
    else:  # half the points within 0.3 of an edge, so every edge's halo wraps
        pts = rng.uniform(-0.3, 0.3, (D, np_))
        pts[:, ::2] = rng.uniform(0.0, 2 * np.pi, (D, (np_ + 1) // 2))
    kw = {}
    if window is not None:
        kw = dict(kernel=getattr(tnufft, window[0])(),
                  kernel_evalmode=getattr(tnufft, window[1])())
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, ntransforms=C,
                            spread_method="blocked", block_dims=block_dims,
                            device=device, **kw)
    plan = tnufft.set_points(plan, torch.from_numpy(pts.astype(real)).to(device))
    return plan, rng, KERNEL_TOL[np.dtype(real).itemsize]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("case", list(SPREAD_1D_CASES))
def test_spread_1d_matches_plain_version(cuda_device, case, dtype):
    """Each 1D spread entry point (a lane a cell, rounds of 32 cells)
    against its plain version on the kernel's edge cases and every window
    whose taps come from K3, with its launch counts moving."""
    row = SPREAD_1D_CASES[case]
    plan, rng, tol = _lowdim_plan(row, 1, dtype, cuda_device, len(case) + 11)
    C, np_, window = row[4], row[6], row[7]
    if case == "sparse":
        assert (plan.pstarts[1:] == plan.pstarts[:-1]).any()
    if case == "m10_grid_below_block":
        assert plan.block_dims[0] + 2 * plan.m - 1 > plan.shape_over[0]
    vp = torch.from_numpy(_values(rng, dtype, (C, np_))).to(cuda_device)
    name = blocked.entry_point("spread", plan)
    assert name.startswith("nufft_spread_1d_")
    weights = blocked.WEIGHTS_ENTRY[plan.real_dtype]
    horner = blocked.kernel_coefs(plan)[0] is not None
    assert horner == (window is None)
    before = dict(blocked.LAUNCHES)
    g_k = blocked.spread_blocked(plan, vp)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[name] == before[name] + 1
    assert blocked.LAUNCHES[weights] == before[weights]  # K3 ran in set_points
    g_p = blocked.spread_blocked_plain(plan, vp)
    assert g_k.dtype == g_p.dtype == plan.dtype and g_k.shape == g_p.shape
    assert _rel_err(g_k, g_p) <= tol


# The 2D interpolation kernel's edges (csrc/interp_2d.cu, a thread a point,
# rows read as whole 16-byte chunks or cell by cell with wrap):
# (shape, sigma, m, block_dims, transforms, where, points, window).  The
# main path's (8, 24) blocks at ~90 points a block; sparse points with empty
# blocks; clustered points (7 of 8 in one corner); dense blocks of more than
# a thousand points; a large block at m = 10; a grid smaller than the padded
# window; m = 2, 3, 7, 8, 9 and 10 (odd M: the chunk offsets of float32;
# m = 8-10 in 64-bit: a row of loads at a time), wrapped at m = 7-10; three
# and 32 transforms; ragged block rows; wrapped edges; rows that are not
# whole chunks (45 cells: complex64 reads every cell with wrap) and a grid
# whose base is not 16-byte aligned (a view one value in); every K3 window.
INTERP_2D_CASES = {
    "main_8x24": ((64, 64), 1.5, 4, (8, 24), 1, "uniform", 9_000, None),
    "chosen": ((64, 48), 1.5, 4, None, 1, "uniform", 6_000, None),
    "sparse": ((64, 64), 1.5, 4, (8, 24), 1, "uniform", 200, None),
    "clustered": ((64, 256), 1.5, 4, (8, 64), 2, "clustered", 1_200, None),
    "dense_chunks": ((16, 16), 1.5, 4, (8, 8), 1, "uniform", 12_000, None),
    "m10_large_block": ((64, 64), 2.0, 10, (128, 128), 1, "uniform", 4_000, None),
    "m10_grid_below_window": ((10, 12), 2.0, 10, (20, 24), 1, "uniform", 3_000, None),
    "m2": ((16, 16), 2.0, 2, (4, 8), 1, "uniform", 6_000, None),
    "m8": ((16, 16), 2.0, 8, (8, 8), 1, "uniform", 6_000, None),
    "m3": ((24, 24), 2.0, 3, None, 1, "uniform", 6_000, None),
    "m7_edges": ((24, 24), 2.0, 7, None, 1, "edges", 6_000, None),
    "m9_edges": ((24, 24), 2.0, 9, None, 1, "edges", 6_000, None),
    "m10_edges": ((24, 32), 2.0, 10, None, 2, "edges", 6_000, None),
    "three_transforms": ((20, 24), 1.5, 4, (5, 12), 3, "uniform", 6_000, None),
    "transforms_32": ((32, 48), 1.5, 4, None, 32, "uniform", 3_000, None),
    "ragged_rows": ((40, 256), 1.5, 4, (6, 32), 1, "uniform", 12_000, None),
    "wrapped_edges": ((20, 24), 1.5, 4, None, 2, "edges", 6_000, None),
    "odd_rows": ((20, 21), 2.0, 4, None, 2, "edges", 6_000, None),
    "misaligned_base": ((20, 24), 1.5, 4, None, 2, "edges", 6_000, None),
    **{f"wtaps_{k}_{e}": ((20, 24), 2.0, 3, None, 1, "uniform", 6_000, (k, e))
       for k, e in WINDOWS if (k, e) != ("KaiserBesselKernel", "FastApproximation")
       and (k, e) != ("BackwardsKaiserBesselKernel", "FastApproximation")},
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("case", list(INTERP_2D_CASES))
def test_interp_2d_matches_plain_version(cuda_device, case, dtype):
    """Each 2D interpolation entry point (a thread a point, whole-chunk or
    wrapped rows) against its plain version on the kernel's edge cases and
    every window whose taps come from K3, with its launch counts moving."""
    row = INTERP_2D_CASES[case]
    plan, rng, tol = _lowdim_plan(row, 2, dtype, cuda_device, len(case) + 13)
    C, np_, window = row[4], row[6], row[7]
    counts = plan.pstarts[1:] - plan.pstarts[:-1]
    if case == "dense_chunks":
        assert int(counts.max()) > 1024
    if case in ("sparse", "clustered"):
        assert (counts == 0).any()
    if case == "m10_grid_below_window":
        assert plan.block_dims[0] + 2 * plan.m - 1 > plan.shape_over[0]
    if case == "odd_rows" and np.dtype(dtype).kind == "c":  # a real plan's rows are even
        assert plan.shape_over[1] % 2 == 1
    grid = torch.from_numpy(_values(rng, dtype, (C,) + plan.shape_over)).to(cuda_device)
    if case == "misaligned_base":
        buf = torch.empty(grid.numel() + 1, dtype=grid.dtype, device=cuda_device)
        grid = buf[1:].view(grid.shape).copy_(grid)
        assert grid.data_ptr() % 16 != 0 or grid.element_size() == 16
    name = blocked.entry_point("interp", plan)
    assert name.startswith("nufft_interp_2d_")
    weights = blocked.WEIGHTS_ENTRY[plan.real_dtype]
    horner = blocked.kernel_coefs(plan)[0] is not None
    before = dict(blocked.LAUNCHES)
    v_k = blocked.interpolate_blocked(plan, grid)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[name] == before[name] + 1
    assert blocked.LAUNCHES[weights] == before[weights]  # K3 ran in set_points
    v_p = blocked.interpolate_blocked_plain(plan, grid)
    assert v_k.dtype == v_p.dtype == plan.dtype and v_k.shape == (C, np_)
    assert _rel_err(v_k, v_p) <= tol


# The 1D interpolation kernel's edges (csrc/interp_1d.cu: each dense
# block's window staged in shared memory, sparse blocks read from global
# memory): (shape, sigma, m, block_dims, transforms, where, points, window).
# M = 2..10; a block wider than its grid at m = 10 (the staged window wraps
# more than once); ragged runs; rho = 0.01 (every block read from global
# memory); clustered points (staged and global blocks together); several
# staging passes over the transforms (complex64, float32, float64) or a
# window too wide to stage (complex128); an odd grid, whose second
# transform's row starts off the 16-byte chunks; wrapped edges; outputs
# written sorted and gathered into order (10M points, or two transforms of
# 5M); every K3 window.
INTERP_1D_CASES = {
    "main_512": ((1024,), 1.5, 4, (512,), 1, "uniform", 6_000, None),
    "chosen": ((4096,), 1.5, 4, None, 1, "uniform", 20_000, None),
    **{f"m{m}": ((512,), 2.0, m, (128,), 1, "uniform", 6_000, None)
       for m in range(2, 11) if m != 4},
    "m10_grid_below_block": ((10,), 2.0, 10, (20,), 1, "uniform", 1_000, None),
    "ragged": ((60,), 1.5, 4, (45,), 1, "uniform", 2_000, None),
    "rho_0_01": ((4096,), 1.5, 4, None, 1, "uniform", 41, None),
    "clustered": ((2048,), 1.5, 4, (96,), 2, "clustered", 3_000, None),
    "passes": ((4096,), 1.5, 4, (3072,), 3, "uniform", 30_000, None),
    "odd_grid": ((50,), 1.5, 4, None, 2, "edges", 3_000, None),
    "three_transforms": ((256,), 1.5, 5, (96,), 3, "uniform", 3_000, None),
    "wrapped_edges": ((512,), 1.5, 4, (64,), 2, "edges", 6_000, None),
    # Outputs beyond INTERP1D_GATHER_BYTES: stored sorted, then gathered.
    "gather_10m": ((1 << 20,), 1.5, 4, None, 1, "uniform", 10_000_000, None),
    "gather_two_transforms": ((1 << 20,), 1.5, 4, None, 2, "edges", 5_000_000, None),
    **{f"wtaps_{k}_{e}": ((512,), 2.0, 3, (128,), 1, "uniform", 6_000, (k, e))
       for k, e in WINDOWS if (k, e) != ("KaiserBesselKernel", "FastApproximation")
       and (k, e) != ("BackwardsKaiserBesselKernel", "FastApproximation")},
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("way", ["chosen", "staged"])
@pytest.mark.parametrize("case", list(INTERP_1D_CASES))
def test_interp_1d_matches_plain_version(cuda_device, case, way, dtype, monkeypatch):
    """Each 1D interpolation entry point against its plain version on the
    kernel's edge cases and every window whose taps come from K3, with its
    launch count moving and K3 not launched: the path the wrapper chooses
    (``common.interp1d_gathers``: the point path up to 8 MiB of output),
    and the staged path forced, its blocks staged or read from global
    memory as ``common.interp1d_staged`` says."""
    from nonuniformffts_tpu_torch.ops.kernels.common import (VALUE_TYPES, interp1d_gathers,
                                                             interp1d_staged, interp1d_window)

    row = INTERP_1D_CASES[case]
    if way == "staged":  # before set_points, which then keeps the inverse permutation
        monkeypatch.setattr(blocked, "interp1d_gathers", lambda *args: True)
    plan, rng, tol = _lowdim_plan(row, 1, dtype, cuda_device, len(case) + 19)
    C, np_, window = row[4], row[6], row[7]
    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    win = interp1d_window(plan.block_dims[0], plan.m, blocked.kernel_coefs(plan)[1], sb,
                          ncomp, C)
    staged = [interp1d_staged(int(n), win) for n in (plan.pstarts[1:] - plan.pstarts[:-1])
              if n > 0]
    if case == "rho_0_01":
        assert not any(staged)
    if case in ("main_512", "m10_grid_below_block"):
        assert all(staged)
    assert interp1d_gathers(np_, C, sb * ncomp) == case.startswith("gather")
    assert (plan.sort_perm_inv is not None) == (way == "staged" or case.startswith("gather"))
    if case == "clustered":
        assert any(staged) and not all(staged)
    if case == "passes":
        assert (win.chans == 0) if plan.dtype == torch.complex128 else 0 < win.chans < C
    grid = torch.from_numpy(_values(rng, dtype, (C,) + plan.shape_over)).to(cuda_device)
    name = blocked.entry_point("interp", plan)
    assert name.startswith("nufft_interp_1d_")
    weights = blocked.WEIGHTS_ENTRY[plan.real_dtype]
    assert (blocked.kernel_coefs(plan)[0] is None) == (window is not None)
    before = dict(blocked.LAUNCHES)
    v_k = blocked.interpolate_blocked(plan, grid)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[name] == before[name] + 1
    assert blocked.LAUNCHES[weights] == before[weights]
    v_p = blocked.interpolate_blocked_plain(plan, grid)
    assert v_k.dtype == v_p.dtype == plan.dtype and v_k.shape == (C, np_)
    assert _rel_err(v_k, v_p) <= tol


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("np_", [5_000, 5_001], ids=["whole_vectors", "ragged"])
@pytest.mark.parametrize("shape", [(16, 12, 20), (64, 48), (4096,)], ids=str)
@pytest.mark.parametrize("window", [w for w in WINDOWS if w[1] == "Direct"
                                    or w[0] in ("GaussianKernel", "BSplineKernel")],
                         ids=lambda w: f"{w[0]}-{w[1]}")
def test_window_taps_set_once_per_set_points(cuda_device, window, shape, np_, dtype):
    """K3 launches once in ``set_points`` and never in ``exec_type1`` /
    ``exec_type2``; the plan's taps equal the plain version's, with the
    16-byte stores (a point count of whole vectors) and without (ragged)."""
    rng = np.random.default_rng(np_ + len(shape))
    D = len(shape)
    real = np.dtype(dtype).type(0).real.dtype
    plan = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=2.0, kernel=getattr(tnufft, window[0])(),
                            kernel_evalmode=getattr(tnufft, window[1])(),
                            spread_method="blocked", device=cuda_device)
    weights = blocked.WEIGHTS_ENTRY[plan.real_dtype]
    pts = torch.from_numpy(rng.uniform(-1.0, 7.0, (D, np_)).astype(real)).to(cuda_device)
    n0 = blocked.LAUNCHES[weights]
    plan = tnufft.set_points(plan, pts)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[weights] == n0 + 1
    assert plan.wtaps_sorted.shape == (D, 8, np_) and plan.wtaps_sorted.dtype == plan.real_dtype
    tol = KERNEL_TOL[np.dtype(real).itemsize]
    assert _rel_err(plan.wtaps_sorted, blocked.window_weights_blocked_plain(plan)) <= tol
    uhat = tnufft.exec_type1(plan, torch.from_numpy(_values(rng, dtype, (np_,))).to(cuda_device))
    tnufft.exec_type2(plan, uhat)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[weights] == n0 + 1


#: The main paths' shapes and point counts a dimension (chip_smoke.py).
SET_POINTS_MAIN = {3: ((256, 256, 256), 16_777_216), 2: ((4096, 4096), 16_777_216),
                   1: ((1 << 20,), 10_000_000)}
SET_POINTS_SPANS = {f"nufft:set_points/{part}" for part in (
    "(1) cell split", "(2) bin sort", "(3) sorted copies", "(4) window taps",
    "(5) transform groups")}


def _set_points_case(rng, case: str, plan, real) -> np.ndarray:
    """(D, Np) points of one edge case of the set_points kernels, as
    ``tests/test_torch_blocking.py:set_points_case`` makes them (that file
    imports JAX): unfolded coordinates (negative, beyond 2pi, exact
    multiples of 2pi / N and of 2pi), empty first and last blocks, every
    point in one inner block, one point; ``transform`` takes points in
    [-1/2, 1/2) for a plan whose point transform scales them by 2pi."""
    D = plan.ndim
    if case == "np1":
        return rng.uniform(-7.0, 13.0, (D, 1)).astype(real)
    if case == "transform":
        return rng.uniform(-0.5, 0.5, (D, 3_000)).astype(real)
    if case == "unfolded":
        pts = rng.uniform(-3 * np.pi, 5 * np.pi, (D, 20_000))
        for d, n in enumerate(plan.shape_over):
            pts[d, :2_000] = rng.integers(-2 * n, 3 * n, 2_000) * (2 * np.pi / n)
        pts[:, 2_000:2_004] = np.array([0.0, 2 * np.pi, -2 * np.pi, 4 * np.pi])
        return pts.astype(real)
    lo, hi = [], []
    for n, b in zip(plan.shape_over, plan.block_dims):
        first, last = (b, n - b) if case == "empty_ends" else (b, 2 * b)
        lo.append(first * 2 * np.pi / n)
        hi.append(last * 2 * np.pi / n)
    lo, hi = np.array(lo)[:, None], np.array(hi)[:, None]
    pts = rng.uniform(lo, hi, (D, 5_000))
    return np.clip(pts, lo * 1.0001, hi * 0.9999).astype(real)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("case", ["unfolded", "empty_ends", "one_block", "np1", "transform",
                                  "main"])
@pytest.mark.parametrize("shape", [(32, 32, 32), (64, 48), (4096,)], ids=str)
def test_set_points_kernels_match_plain_version(cuda_device, shape, case, dtype):
    """A CUDA plan's sorted point state from the two set_points kernels
    around the sort (``csrc/bin_sort.cu``) equals the plain chain's
    (``plan._sorted_state_plain``, ``blocking.py``) under ``torch.equal``:
    cells, fractions, order and block starts.  Each ``set_points`` launches
    each kernel once, blocks the host nowhere (sync debug mode "error"),
    and still opens the five ``nufft:set_points/...`` spans.  ``main``
    runs the main path's shape and point count of the dimension."""
    rng = np.random.default_rng(len(shape))
    real = np.dtype(dtype).type(0).real.dtype
    kw = {}
    if case == "transform":
        kw["point_transform"] = lambda x: x * (2 * np.pi)
    if case == "main":
        shape, np_ = SET_POINTS_MAIN[len(shape)]
    plan = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, spread_method="blocked",
                            device=cuda_device, **kw)
    if case == "main":
        gen = torch.Generator(device=cuda_device).manual_seed(np_)
        pts = torch.rand((len(shape), np_), generator=gen, device=cuda_device,
                         dtype=plan.real_dtype) * (2 * np.pi + 2) - 1
    else:
        pts = torch.from_numpy(_set_points_case(rng, case, plan, real)).to(cuda_device)
    names = blocked.BIN_SORT_ENTRIES[plan.real_dtype]
    before = {n: blocked.LAUNCHES[n] for n in names}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tnufft.set_points(plan, pts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert all(blocked.LAUNCHES[n] == before[n] + 1 for n in names)
    labels = {e.name for e in prof.events() if e.name.startswith("nufft:set_points/")}
    assert labels == SET_POINTS_SPANS
    cells, fracs, perm, pstarts, num_points = plan_module._sorted_state_plain(plan, pts)
    assert got.num_points == num_points == pts.shape[1]
    for g, w in ((got.cells_sorted, cells), (got.fracs_sorted, fracs),
                 (got.sort_perm, perm), (got.pstarts, pstarts)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    counts = torch.diff(pstarts)
    if case in ("empty_ends", "one_block"):
        assert counts[0] == 0 and counts[-1] == 0
    if case == "one_block":
        assert int(counts.max()) == pts.shape[1]


def _deconvolve_weights(w_tuple, idx):
    """A uniform callback: a weight growing along the last axis."""
    return tuple(w * (1.0 + 0.25 * idx[-1]) for w in w_tuple)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("fftshift", [False, True], ids=["fftw", "shift"])
@pytest.mark.parametrize("shape", [(64,), (63,), (32, 24), (31, 17), (16, 12, 20), (15, 9, 11)],
                         ids=str)
def test_deconvolve_kernels_match_plain_version(cuda_device, shape, fftshift, C, dtype):
    """Both deconvolution kernels against the plain chain on the plan's own
    ranges and factors: type 1's truncate and type 2's pad, each with and
    without a uniform callback, and the pad with the scaling off that a
    grouped type 2 runs (on the group's slice of the modes, which with C = 3
    may start off a 16-byte boundary).  Each stage launches its kernel once
    and returns a new contiguous tensor within the multiply chain's
    rounding of the plain version; the unscaled pad is a copy, equal bit
    for bit."""
    plan = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, ntransforms=C, fftshift=fftshift,
                            device=cuda_device)
    rng = np.random.default_rng(len(shape) * 7 + C)
    spec = torch.from_numpy(_values(rng, np.complex128, (C,) + plan.spectral_shape_over)).to(
        cuda_device, plan.complex_dtype)
    uhat = torch.from_numpy(_values(rng, np.complex128, (C,) + plan.spectral_shape)).to(
        cuda_device, plan.complex_dtype)
    args1 = (plan.index_ranges, plan.phihat_inv, plan.normfactor)
    args2 = (plan.spectral_shape_over, plan.index_ranges, plan.phihat_inv)
    w = uhat[1:] if C > 1 else uhat
    cases = [
        ("truncate", lambda: ex.t1_deconv_stage(plan, spec),
         lambda: deconvolve.deconvolve_truncate_plain(spec, *args1)),
        ("truncate", lambda: ex.t1_deconv_stage(plan, spec, _deconvolve_weights),
         lambda: deconvolve.deconvolve_truncate_plain(spec, *args1, _deconvolve_weights)),
        ("pad", lambda: ex.t2_pad_stage(plan, uhat),
         lambda: deconvolve.deconvolve_pad_plain(uhat, *args2)),
        ("pad", lambda: ex.t2_pad_stage(plan, uhat, _deconvolve_weights),
         lambda: deconvolve.deconvolve_pad_plain(uhat, *args2, _deconvolve_weights)),
        ("pad", lambda: ex.t2_pad_modes_stage(plan, w),
         lambda: deconvolve.pad_modes_plain(w, plan.spectral_shape_over, plan.index_ranges)),
    ]
    rtol = {torch.float32: 1e-6, torch.float64: 1e-15}[plan.real_dtype]
    for i, (step, kern, plain) in enumerate(cases):
        name = deconvolve_entry_name(step, plan.dtype)
        before = blocked.LAUNCHES[name]
        got = kern()
        torch.cuda.synchronize()
        assert blocked.LAUNCHES[name] == before + 1, (i, name)
        want = plain()
        assert got.is_contiguous() and got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=rtol, atol=0)
        if i == len(cases) - 1:
            assert torch.equal(got, want)
        print(f"{name} case {i}: bit-equal {torch.equal(got, want)}")


@pytest.mark.parametrize("step", ["truncate", "pad"])
def test_deconvolve_kernels_take_transforms_past_2_31_elements(cuda_device, step):
    """864^3 modes over a 1297^3 oversampled spectrum in complex64: 2.18e9
    elements a transform (17.4 GB), one value an access (odd extents).  The
    kernels index elements in 64 bits, so the truncate (factors of one,
    normfactor 1) gathers and the unscaled pad copies each value exactly:
    planes at both ends and in the middle of the grid equal the index map's
    gather, and the pad's zeros are zero."""
    rows = (864,) * 3
    over = (1297,) * 3
    ranges = tuple(deconvolve.truncate_ranges(n, m, r2c=False, fftshift=False)
                   for n, m in zip(rows, over))
    axes = common.deconvolve_axes(ranges, over)
    assert math.prod(over) > 2**31 and common.deconvolve_vector(axes, 8) == 1
    idx = [t.to(cuda_device) for t in (common.source_index(axes, d) if step == "truncate"
                                        else common.mode_index(axes, d) for d in range(3))]
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    blocked.reset_launch_counts()
    if step == "truncate":
        x = torch.randn((1,) + over, dtype=torch.complex64, device=cuda_device, generator=gen)
        ones = [torch.ones(n, dtype=torch.float32, device=cuda_device) for n in rows]
        got = kernels.truncate(x, ranges, ones, 1.0)
        planes = (0, 431, 863)
    else:
        x = torch.randn((1,) + rows, dtype=torch.complex64, device=cuda_device, generator=gen)
        got = kernels.pad(x, over, ranges)
        planes = (0, 431, 600, 865, 1296)  # 600 lies between the runs: zeros
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[deconvolve_entry_name(step, torch.complex64)] == 1
    assert got.is_contiguous() and got.shape == (1,) + (rows if step == "truncate" else over)
    i1, i2 = idx[1], idx[2]
    for i0 in planes:
        j0 = int(idx[0][i0])
        if step == "truncate":
            want = x[0, j0].index_select(0, i1).index_select(1, i2)
        elif j0 < 0:
            want = torch.zeros(over[1:], dtype=x.dtype, device=cuda_device)
        else:
            kept = (i1[:, None] >= 0) & (i2[None, :] >= 0)
            want = x[0, j0].index_select(0, i1.clamp(min=0)).index_select(1, i2.clamp(min=0))
            want = torch.where(kept, want, torch.zeros((), dtype=x.dtype, device=cuda_device))
        assert torch.equal(got[0, i0], want), (step, i0)


def test_deconvolve_kernels_refuse_past_their_item_count(cuda_device):
    """Every entry point refuses, before any launch, a step whose (row,
    chunk) items of one transform reach 2^31 - 1 (the count it indexes in
    32 bits): cudaErrorInvalidValue (1), with no memory behind the
    pointers."""
    lib = build.load()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for rows in ((46341, 46341, 1), (1, 2**30, 257)):
        axes = common.deconvolve_axes(tuple(((0, n),) for n in rows), rows)
        assert common.deconvolve_items(axes, "pad", 1) >= common.DECONVOLVE_MAX_ITEMS
        geom = build.DeconvGeometry.of(1, axes)
        for dtype in common.VALUE_TYPES:
            truncate = getattr(lib, deconvolve_entry_name("truncate", dtype))
            pad = getattr(lib, deconvolve_entry_name("pad", dtype))
            assert truncate(None, None, None, None, None, 1.0, geom, 1, stream) == 1, rows
            assert pad(None, None, None, None, None, 0, geom, 1, stream) == 1, rows
    torch.cuda.synchronize()


@pytest.mark.parametrize("kernel", ["BackwardsKaiserBesselKernel", "GaussianKernel"])
def test_execs_repeat_no_plan_decision(cuda_device, kernel, monkeypatch):
    """The blocked plan's kernel decisions are made once a plan: over three
    exec_type1 / exec_type2 pairs the window is packed once (the first exec
    reads the plan ``set_points`` returned), and neither exec calls
    ``check_kernel_support``, which ran where the plan was made."""
    from nonuniformffts_tpu_torch.ops.windows import window_pack

    packed, checked = [], []
    monkeypatch.setattr(plan_module, "window_pack",
                        lambda *a: packed.append(a) or window_pack(*a))
    monkeypatch.setattr(blocked, "check_kernel_support", checked.append)
    rng = np.random.default_rng(7)
    plan = tnufft.set_points(
        tnufft.PlanNUFFT(np.complex128, (32, 32, 32), m=4, sigma=1.5,
                         kernel=getattr(tnufft, kernel)(), spread_method="blocked",
                         device=cuda_device),
        torch.as_tensor(rng.uniform(0, 2 * np.pi, (3, 2_000)), device=cuda_device))
    v = torch.as_tensor(_values(rng, np.complex128, 2_000), device=cuda_device)
    before = len(packed)
    for _ in range(3):
        tnufft.exec_type2(plan, tnufft.exec_type1(plan, v))
    torch.cuda.synchronize()
    assert len(packed) - before == 1
    assert checked == []


def test_m_above_10_raises(cuda_device):
    with pytest.raises(NotImplementedError, match="documented maximum"):
        tnufft.PlanNUFFT(np.complex64, (64, 64), m=11, sigma=2.0, device=cuda_device)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=str)
@pytest.mark.parametrize(
    "grid_shape,block_dims",
    [((3, 24), (6,)), ((2, 12, 40), (4, 8)), ((1, 96, 64), (96, 16)),
     ((3, 12, 20, 40), (4, 5, 8)), ((2, 24, 64, 32), (24, 16, 32)), ((5, 7, 9, 6), (7, 3, 2)),
     ((3, 12, 10, 6), (4, 5, 3)), ((2, 12, 9), (4, 3)), ((2, 6, 5, 4), (3, 5, 1)),
     ((1, 8, 40, 300), (4, 10, 300)), ((2, 8, 4, 600), (2, 4, 600))],
    ids=str,
)
def test_relayout_kernels_equal_plain_versions(cuda_device, grid_shape, block_dims, dtype):
    """K8b (grid -> block-major) and K8a (the inverse) against their plain
    versions, bit for bit, on every path of the kernels: TMA runs (with a
    partial last chunk; whole blocks), 16-byte and 8-byte register runs, the
    element path (B2 = 1); D = 1 launches nothing."""
    from nonuniformffts_tpu_torch.ops.kernels import relayout

    gen = torch.Generator(device=cuda_device).manual_seed(len(grid_shape))
    g = torch.randn(grid_shape, dtype=dtype, device=cuda_device, generator=gen)
    D = len(block_dims)
    before = dict(relayout.LAUNCHES)
    b = relayout.relayout_to_blocks(g, block_dims)
    back = relayout.relayout_to_grid(b, block_dims)
    torch.cuda.synchronize()
    launched = 0 if D == 1 else 1
    for direction in ("grid", "blocks"):
        name = relayout.entry_point(direction, dtype)
        assert relayout.LAUNCHES[name] == before[name] + launched
    assert torch.equal(b, relayout.relayout_to_blocks_plain(g, block_dims))
    assert torch.equal(back, relayout.relayout_to_grid_plain(b, block_dims))
    assert torch.equal(back, g)


def test_relayout_kernels_take_an_8_byte_aligned_input(cuda_device):
    """A complex64 view that starts 8 bytes past a 16-byte boundary runs the
    8-byte register path and still equals the plain version."""
    from nonuniformffts_tpu_torch.ops.kernels import relayout

    base = torch.randn(1 + 2 * 8 * 64, dtype=torch.complex64, device=cuda_device)
    g = base[1:].view(2, 8, 64)
    assert g.data_ptr() % 16 == 8
    b = relayout.relayout_to_blocks(g, (4, 16))
    assert torch.equal(b, relayout.relayout_to_blocks_plain(g, (4, 16)))
    assert torch.equal(relayout.relayout_to_grid(b, (4, 16)), g)


def test_relayout_kernels_refuse_real_tensors(cuda_device):
    from nonuniformffts_tpu_torch.ops.kernels import relayout

    with pytest.raises(TypeError, match="no relayout kernel"):
        relayout.relayout_to_blocks(torch.zeros((1, 8, 8), device=cuda_device), (4, 4))


# ---------------------------------------------------------------------------
# The plan surface on the card: chunked plans, the direct NUDFT, callbacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape,np_,nchunks", [((4096,), 30_001, 3), ((64, 48), 20_000, 4),
                                               ((32, 32, 32), 50_000, 4)], ids=str)
def test_chunked_matches_unchunked(cuda_device, shape, np_, nchunks, dtype):
    """Chunked plans on the kernels against the unchunked plan on the same
    points; every chunk launches the spread and the interpolation.  In 1D
    each chunk spreads into its own grid: the kernel stores its interior
    cells, so a shared grid would keep only the last chunk's there."""
    rng = np.random.default_rng(np_)
    D = len(shape)
    rdt = np.float32 if np.dtype(dtype) in (np.complex64, np.float32) else np.float64
    pts = rng.uniform(0, 2 * np.pi, (D, np_)).astype(rdt)
    v = _values(rng, dtype, np_)
    kw = dict(m=4, sigma=1.5, spread_method="blocked", device=cuda_device)
    plan = tnufft.set_points(tnufft.PlanNUFFT(dtype, shape, **kw), pts)
    cplan = tnufft.set_points_chunked(
        tnufft.ChunkedPlanNUFFT(dtype, shape, nchunks=nchunks, **kw), pts)
    u = tnufft.exec_type1(plan, v)
    names = [blocked.entry_point(k, plan) for k in ("spread", "interp")]
    before = {n: blocked.LAUNCHES[n] for n in names}
    uc = tnufft.exec_type1_chunked(cplan, v)
    v2c = tnufft.exec_type2_chunked(cplan, u)
    torch.cuda.synchronize()
    assert all(blocked.LAUNCHES[n] == before[n] + nchunks for n in names)
    tol = KERNEL_TOL[np.dtype(rdt).itemsize]
    assert _rel_err(uc, u) <= tol
    assert _rel_err(v2c, tnufft.exec_type2(plan, u)) <= tol


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape,np_", [((32, 32, 32), 500), ((64, 48), 2_000), ((8192,), 300)],
                         ids=str)
def test_direct_with_callers_tf32_on(cuda_device, shape, np_, dtype):
    """The direct NUDFT against exact float64 sums with TF32 switched on by
    the caller: its product runs in float64, which TF32 never touches.  The
    caller's settings come back unchanged."""
    rng = np.random.default_rng(np_)
    D = len(shape)
    pts = rng.uniform(0, 2 * np.pi, (D, np_))
    v = _values(rng, dtype, np_)
    u = _values(rng, dtype, shape)
    plan = tnufft.set_points(tnufft.PlanNUFFT(dtype, shape, spread_method="direct",
                                              device=cuda_device), pts)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        u1 = tnufft.exec_type1(plan, v)
        v2 = tnufft.exec_type2(plan, u)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])
    x = torch.as_tensor(pts, device=cuda_device)
    f = [torch.exp(-1j * torch.outer(plan.kvec[d], x[d])) for d in range(D)]  # (N_d, Np)
    dims = "abc"[:D]
    factors = ",".join(f"{a}j" for a in dims)
    exact1 = torch.einsum(f"{factors},j->{dims}", *f,
                          torch.as_tensor(v, device=cuda_device).to(torch.complex128))
    exact2 = torch.einsum(f"{dims},{factors}->j",
                          torch.as_tensor(u, device=cuda_device).to(torch.complex128),
                          *[fd.conj() for fd in f])
    tol = 2e-6 if dtype == np.complex64 else 1e-12
    assert _rel_err(u1.to(torch.complex128), exact1) <= tol
    assert _rel_err(v2.to(torch.complex128), exact2) <= tol


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(32, 32, 32), (64, 48), (4096,)], ids=str)
def test_callbacks_match_manual(cuda_device, shape, dtype):
    """Both callbacks on the kernels' path (a point weight, a filter on the
    grid positions) against the same operations applied by hand."""
    rng = np.random.default_rng(len(shape))
    D = len(shape)
    rdt = np.float32 if np.dtype(dtype) == np.complex64 else np.float64
    pts = rng.uniform(0, 2 * np.pi, (D, 20_000)).astype(rdt)
    v = _values(rng, dtype, 20_000)
    plan = tnufft.set_points(tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5,
                                              spread_method="blocked", device=cuda_device), pts)
    w = torch.as_tensor(rng.uniform(0.5, 1.5, 20_000).astype(rdt), device=cuda_device)
    grids = torch.meshgrid(*[torch.arange(n, device=cuda_device) for n in plan.spectral_shape],
                           indexing="ij")
    filt = torch.exp(-0.001 * sum(g.to(torch.float64) ** 2 for g in grids)).to(w.dtype)
    cb = tnufft.NUFFTCallbacks(nonuniform=lambda vs, n: tuple(x * w[n] for x in vs),
                               uniform=lambda ws, idx: tuple(x * filt[idx] for x in ws))
    vt = torch.as_tensor(v, device=cuda_device)
    u = tnufft.exec_type1(plan, vt, callbacks=cb)
    tol = 1e-6 if rdt == np.float32 else 1e-12
    assert _rel_err(u, tnufft.exec_type1(plan, vt * w) * filt) <= tol
    v2 = tnufft.exec_type2(plan, u, callbacks=cb)
    assert _rel_err(v2, tnufft.exec_type2(plan, u * filt) * w) <= tol


# ---------------------------------------------------------------------------
# Many transforms: every spread and interpolation entry point at C = 5 and
# 32, and grouped passes against one pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("C", [5, 32])
@pytest.mark.parametrize("shape,np_", [((24, 24, 24), 20_000), ((64, 48), 20_000),
                                       ((4096,), 60_000)], ids=str)
def test_many_transforms_match_plain_versions(cuda_device, shape, np_, C, dtype):
    """Each spread and interpolation entry point with C transforms in one
    launch against its plain version, transform by transform.  In 1D at C =
    32 every output but float32's passes INTERP1D_GATHER_BYTES: the staged
    kernel, its passes of ``chans`` transforms, and the gather."""
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES, interp1d_gathers

    rng = np.random.default_rng(C + len(shape))
    D = len(shape)
    real = np.dtype(dtype).type(0).real.dtype
    plan = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, ntransforms=C,
                            spread_method="blocked", device=cuda_device)
    plan = tnufft.set_points(plan, torch.from_numpy(
        rng.uniform(-1.0, 7.0, (D, np_)).astype(real)).to(cuda_device))
    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    if D == 1:
        gathers = interp1d_gathers(np_, C, sb * ncomp)
        assert gathers == (C == 32 and sb * ncomp > 4)
        assert (plan.sort_perm_inv is not None) == gathers
    vp = torch.from_numpy(_values(rng, dtype, (C, np_))).to(cuda_device)
    grid = torch.from_numpy(_values(rng, dtype, (C,) + plan.shape_over)).to(cuda_device)
    names = [blocked.entry_point(k, plan) for k in ("spread", "interp")]
    before = {n: blocked.LAUNCHES[n] for n in names}
    g_k = blocked.spread_blocked(plan, vp)
    v_k = blocked.interpolate_blocked(plan, grid)
    torch.cuda.synchronize()
    assert all(blocked.LAUNCHES[n] == before[n] + 1 for n in names)
    tol = KERNEL_TOL[np.dtype(real).itemsize]
    for c in range(C):
        assert _rel_err(g_k[c], blocked.spread_blocked_plain(plan, vp[c : c + 1])[0]) <= tol
        assert _rel_err(v_k[c], blocked.interpolate_blocked_plain(plan, grid[c : c + 1])[0]) <= tol


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(24, 24, 24), (64, 48), (4096,)], ids=str)
def test_grouped_matches_one_pass_on_card(cuda_device, shape, dtype):
    """A plan of 8 transforms in groups of 3 against the same plan in one
    pass (the chooser keeps these small plans whole); one spread and one
    interpolation launch a group."""
    import dataclasses

    rng = np.random.default_rng(len(shape))
    C, D = 8, len(shape)
    real = np.dtype(dtype).type(0).real.dtype
    plan = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, ntransforms=C,
                            spread_method="blocked", device=cuda_device)
    plan = tnufft.set_points(plan, rng.uniform(0, 2 * np.pi, (D, 20_000)).astype(real))
    assert plan.transform_chunk is None
    grouped = dataclasses.replace(plan, transform_chunk=3)
    v = torch.from_numpy(_values(rng, dtype, (C, 20_000))).to(cuda_device)
    cdt = np.complex64 if real == np.float32 else np.complex128
    u = torch.from_numpy(_values(rng, cdt, (C,) + plan.spectral_shape)).to(cuda_device)
    names = [blocked.entry_point(k, plan) for k in ("spread", "interp")]
    before = {n: blocked.LAUNCHES[n] for n in names}
    g1, g2 = tnufft.exec_type1(grouped, v), tnufft.exec_type2(grouped, u)
    torch.cuda.synchronize()
    assert all(blocked.LAUNCHES[n] == before[n] + 3 for n in names)
    tol = 1e-6 if real == np.float32 else 1e-12
    assert _rel_err(g1, tnufft.exec_type1(plan, v)) <= tol
    assert _rel_err(g2, tnufft.exec_type2(plan, u)) <= tol


# ---------------------------------------------------------------------------
# Groups of transforms on the chunked, point-sharded and spatial paths
# ---------------------------------------------------------------------------

GROUPS_C, GROUPS_NP, GROUPS_TOL = 5, 20_000, {4: 1e-6, 8: 1e-12}


@pytest.fixture(scope="module")
def nccl_group(tmp_path_factory):
    """An NCCL process group of one rank, this process, on cuda:0."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    rdv = tmp_path_factory.mktemp("nccl") / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0, world_size=1)
    yield torch.device("cuda")
    dist.destroy_process_group()


def _groups_inputs(dtype, D, device, seed=5):
    rng = np.random.default_rng(seed)
    real = np.dtype(dtype).type(0).real.dtype
    pts = torch.from_numpy(rng.uniform(0, 2 * np.pi, (D, GROUPS_NP)).astype(real)).to(device)
    v = torch.from_numpy(_values(rng, dtype, (GROUPS_C, GROUPS_NP))).to(device)
    return pts, v, GROUPS_TOL[np.dtype(real).itemsize]


def _launch_delta(plan, fn):
    """``fn()`` and the spread and interpolation launches it made."""
    names = [blocked.entry_point(k, plan) for k in ("spread", "interp")]
    before = {n: blocked.LAUNCHES[n] for n in names}
    out = fn()
    torch.cuda.synchronize()
    return out, [blocked.LAUNCHES[n] - before[n] for n in names]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=lambda d: np.dtype(d).name)
def test_chunked_groups_match_one_pass_on_card(cuda_device, dtype):
    """A chunked plan (3 chunks) of 5 transforms in groups of 2 against the
    same plan in one pass: one spread and one interpolation launch a chunk
    a group."""
    import dataclasses

    pts, v, tol = _groups_inputs(dtype, 3, cuda_device)
    cplan = tnufft.set_points_chunked(tnufft.ChunkedPlanNUFFT(
        dtype, (24, 24, 24), nchunks=3, m=4, sigma=1.5, ntransforms=GROUPS_C,
        spread_method="blocked", device=cuda_device), pts)
    assert cplan.transform_chunk is None  # the chooser keeps this plan whole
    grouped = dataclasses.replace(cplan, transform_chunk=2)
    u = tnufft.exec_type1_chunked(cplan, v)
    g1, n1 = _launch_delta(cplan.base, lambda: tnufft.exec_type1_chunked(grouped, v))
    g2, n2 = _launch_delta(cplan.base, lambda: tnufft.exec_type2_chunked(grouped, u))
    assert n1 == [9, 0] and n2 == [0, 9]
    assert _rel_err(g1, u) <= tol
    assert _rel_err(g2, tnufft.exec_type2_chunked(cplan, u)) <= tol


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=lambda d: np.dtype(d).name)
def test_point_sharded_groups_match_one_pass_on_card(nccl_group, dtype):
    """``exec_type{1,2}_sharded`` on an NCCL group of one rank, 5 transforms
    with the plan's group size forced to 2, against one pass."""
    import dataclasses

    from nonuniformffts_tpu_torch.parallel import exec_type1_sharded, exec_type2_sharded

    pts, v, tol = _groups_inputs(dtype, 3, nccl_group)
    plan = tnufft.PlanNUFFT(dtype, (24, 24, 24), m=4, sigma=1.5, ntransforms=GROUPS_C,
                            spread_method="blocked", device=nccl_group)
    grouped = dataclasses.replace(plan, transform_chunk=2)
    v_ch = ex.to_channels(v, 1)
    u = exec_type1_sharded(plan, pts, v_ch)
    g1, n1 = _launch_delta(plan, lambda: exec_type1_sharded(grouped, pts, v_ch))
    g2, n2 = _launch_delta(plan, lambda: exec_type2_sharded(grouped, pts, u))
    assert n1 == [3, 0] and n2 == [0, 3]
    assert _rel_err(g1, u) <= tol
    assert _rel_err(g2, exec_type2_sharded(plan, pts, u)) <= tol


@pytest.mark.parametrize("spectrum", ["replicated", "sharded"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=lambda d: np.dtype(d).name)
def test_spatial_groups_match_one_pass_on_card(nccl_group, dtype, spectrum):
    """``SpatialNUFFT`` on an NCCL group of one rank, 5 transforms with the
    slab plan's group size forced to 2 (each group through the whole
    chain), against one pass."""
    import dataclasses

    from nonuniformffts_tpu_torch.parallel import SpatialNUFFT

    pts, v, tol = _groups_inputs(dtype, 3, nccl_group)
    sp = SpatialNUFFT(dtype, (32, 32, 32), m=4, sigma=1.5, ntransforms=GROUPS_C,
                      spectrum=spectrum, device=nccl_group)
    st = sp.set_points(pts)
    assert st.local.transform_chunk is None and st.ranks_on_device == 1
    grouped = dataclasses.replace(st, local=dataclasses.replace(st.local, transform_chunk=2))
    v_ch = ex.to_channels(v, 1)
    u = sp.exec_type1(st, v_ch)
    g1, n1 = _launch_delta(st.local, lambda: sp.exec_type1(grouped, v_ch))
    g2, n2 = _launch_delta(st.local, lambda: sp.exec_type2(grouped, u))
    assert n1 == [3, 0] and n2 == [0, 3]
    assert g1.shape == u.shape
    assert _rel_err(g1, u) <= tol
    assert _rel_err(g2, sp.exec_type2(st, u)) <= tol


def test_device_census_names_the_physical_card(nccl_group):
    """``comm.device_key`` names the card by its UUID, and the group's
    census is taken once: a later call finds its count without a
    collective."""
    import zlib

    import torch.distributed as dist

    from nonuniformffts_tpu_torch.parallel import comm

    key = comm.device_key(nccl_group)
    uuid = str(torch.cuda.get_device_properties(nccl_group).uuid)
    assert key.device.type == "cuda" and int(key[1]) == zlib.crc32(uuid.encode())
    assert comm.ranks_on_device(nccl_group) == 1
    counts = comm._SHARING[dist.group.WORLD]
    assert counts[str(nccl_group)] == 1 and set(counts.values()) == {1}
    assert comm.agreed_chunk(3, 5, nccl_group) == 3
    assert comm.agreed_chunk(None, 5, nccl_group) is None
