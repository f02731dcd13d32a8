#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Phases, in order; the first failure raises and the script exits non-zero:

1. environment: torch and CUDA versions, nvcc, Triton, the card's name and
   power limit; requires ``torch.cuda.is_available()``;
2. build: compiles the CUDA kernels from ``nonuniformffts_tpu_torch/csrc``
   (one nvcc per source, dimension and value type, all at once), prints each
   kernel's registers and spills from ``ptxas -v`` and the atomic and DMMA
   (FP64 tensor-core) instructions its SASS holds (``cuobjdump -sass``);
   every 2D and 3D spread instantiation must hold DMMA and no
   shared-memory atomic;
3. the 3D complex64 kernels against their plain PyTorch versions on the
   card: a 64^3 plan (grid 96^3), 200,000 uniform points, and the
   interpolation kernel's branch for blocks below ``INTERP3D_SPARSE``
   points (read from global memory, not staged) at 2,000 points;
4. the 3D complex64 main path at full size: N = 256^3, m = 4, sigma = 1.5,
   backwards Kaiser-Bessel, FastApproximation, ``spread_method='blocked'``,
   for Np = 1,000,000 and 16,777,216: ``set_points`` -> ``exec_type1`` ->
   ``exec_type2``, stage times (CUDA events, median of 5 after one
   warm-up), accuracy against exact float64 sums, launch counts; at 1M also
   each kernel against its plain version, checked and timed in turns; at
   rho = 1 the float32-accumulation diagnostic (below);
5. 64-bit accuracy at m = 8, sigma = 2, complex128 and float64: 64^3 (grid
   128^3), 256^2 (grid 512^2) and 4096 (grid 8192), 200,000 points each:
   each 64-bit kernel against its plain version, and err1 / err2 against
   exact float64 sums;
6. the 3D 64-bit main path (the reference's protocol point): N = 256^3,
   m = 4, sigma = 1.5, complex128 and float64 (r2c/c2r), at Np = 1,677,722
   (rho = 0.1) and 16,777,216 (rho = 1), measured as in phase 4;
7. the 3D float32 real (r2c/c2r) main path: N = 256^3, m = 4, sigma = 1.5,
   at Np = 1,000,000 and 16,777,216;
8. the 2D main path, N = 4096^2 (grid 6144^2), m = 4, sigma = 1.5, all four
   dtypes: complex64 and float32 at Np = 1,000,000 and 16,777,216,
   complex128 and float64 at 1,677,722 and 16,777,216; at 16,777,216 also
   the spread and the interpolation kernels against their plain versions
   on the row's own points, each timed as one wrapper call;
9. the 1D main path, N = 2^20 (grid 1,572,864), m = 4, sigma = 1.5, all four
   dtypes at Np = 1,000,000 and 10,000,000; at 10,000,000 also the spread
   and interpolation kernels against their plain versions, timed, as in
   phase 8;
10. every window at the full 3D width: N = 256^3, m = 4, sigma = 2 (grid
    512^3), complex64 and complex128 at Np = 1,000,000 and 16,777,216, for
    BKB Fast (the yardstick at this sigma), KB Fast and Direct, BKB
    Direct, Gaussian Fast and Direct and the B-spline, measured as in
    phase 4; then the same windows on the 2D (4096^2, 16,777,216 points)
    and 1D (2^20, 10,000,000 points) complex64 main paths at sigma = 2,
    each with its kernels checked as in phases 8 and 9;
11. m = 10 for every dtype, dimension and window in both modes: 32^3, 128^2
    and 4096 (sigma = 2), 50,000 points; each kernel against its plain
    version (timed), err1 / err2 against exact sums;
12. the NFFT adapter at full width: ``plan_nfft`` in 3D at N = 256^3,
    16,777,216 points in [-1/2, 1/2)^3, complex128, the default reltol 1e-9
    (m = 6, sigma = 2), windows kaiser_bessel, gauss and spline: forward and
    adjoint times, their errors against exact NFFT-convention sums at
    4,096 points and 64 modes, and the plan's interpolation kernel against
    its plain version;
13. the two multi-device modes (``nonuniformffts_tpu_torch.parallel``) at
    N = 256^3, m = 4, sigma = 1.5, BKB FastApproximation, 16,777,216 uniform
    points: first K8a / K8b (``csrc/relayout.cu``) against their plain
    versions, bit for bit, on ragged shapes that reach the register and
    element paths and at the spatial run's five relayout shapes, complex64
    and complex128, each timed as 50 calls back to back over three input
    buffers (kernel, plain version and the library call that computes the
    same copy, in turns) and as one wrapper call; then four gloo ranks
    spawned on the one card (cuda:0) drive ``SpatialNUFFT`` (block form,
    the default engine; n = 4 complex64 and complex128, n = 4 complex64
    with ``spectrum='sharded'``; ``capacity_factor=1.25``), the same at
    n = 2 on a two-rank group (complex64), and ``exec_type{1,2}_sharded``
    (n = 4, complex64); then ``SpatialNUFFT`` on an NCCL group of one rank
    in this process, replicated and sharded.  Each row: set_points /
    exec_type1 / exec_type2 (CUDA-event medians of 3 after one warm-up, per
    rank), the host time of one more call with the time in collectives,
    launch counts per rank (K1, K2, K8a and K8b must each launch on the
    spatial path), each rank's slab-plan interpolation kernel against its
    plain version, err1 (a sharded row's at modes of its own rows of dim
    0) / err2 against exact sums, agreement with the single-card plan on
    the same points (a sharded row's dim-0 shard against the single card's
    rows; <= 1e-5 complex64, <= 1e-12 complex128), and which collectives
    went through host memory.
    The ranks share one card: the times are the port's per-rank cost plus
    gloo's host transport, not a scaling result;
14. the rest of the plan surface at N = 256^3, m = 4, sigma = 1.5, BKB
    FastApproximation, complex64 and complex128: at rho = 1 (16,777,216
    points) the main path with ``Timer(synchronise=True)`` and both
    callbacks (every stage label present; each transform's whole call
    within ``STAGE_GAP_MS`` of its stage sums), then the callbacks (a
    per-point weight, a Gaussian filter in |k|) against the same operations
    applied by hand (<= 1e-6 complex64, <= 1e-12 complex128), timed with
    and without them; ``ChunkedPlanNUFFT`` with 4 chunks against the
    unchunked plan (<= 1e-5 / 1e-12); at rho = 10 (167,772,160 points) the
    unchunked plan's ``set_points`` peak memory and times, then the chunked
    plan's ``set_points_chunked`` / ``exec_type1`` / ``exec_type2`` times,
    peak and err1 / err2; the same chunked-against-unchunked row in 1D
    (2^20, 10,000,000 points, 3 chunks: a grid shared by the chunks would
    lose the interior cells the 1D spread stores); each chunked row's
    spread and interpolation kernels launched once a chunk a call; then the
    direct NUDFT (``spread_method='direct'``) at 256^3 with 1,678 and 16,777
    points and at 2^20 with 1,000, err1 / err2 against exact sums (<= 2e-6
    complex64, <= 1e-12 complex128) beside the blocked path's times, and
    one complex64 call with the caller's TF32 switched on, held to the same
    limits;
15. many transforms over shared points at N = 256^3, m = 4, BKB
    FastApproximation, 1,000,000 uniform points: complex64 and complex128
    at sigma = 1.5 with C = 1, 2, 8 and 32, float32 and float64 (r2c/c2r)
    at C = 8, and complex128 and complex64 at sigma = 2 with C = 32
    (68.7 GB of grid in one pass in complex128; in complex64 groups of 16
    transforms, 2^31 grid values each: they must run in groups, and their
    transforms 0 and 31 are held against one-transform plans, <= 1e-12 /
    1e-6).  Each row: the chosen ``transform_chunk`` and groups,
    ``set_points`` / ``exec_type1`` / ``exec_type2`` in ms a call and a
    transform (CUDA events, median of 5 after one warm-up), each
    transform's err1 / err2 against exact sums, each exec's peak memory
    (``max_memory_allocated`` after ``reset_peak_memory_stats``) and its
    bytes a transform of the largest group against the model's
    (``plan.py:transform_working_set``), and one spread and one
    interpolation launch a group a call.  Then C = 8 in groups of 3
    against the same plan in one pass (<= 1e-6 complex64, <= 1e-12
    complex128), once under ``Timer(synchronise=True)`` with both
    callbacks (every label present, each stage once a group).  Beside the
    sigma = 2 complex128 C = 32 row and on its inputs, the other paths in
    their groups of transforms (each must run in more than one): (a)
    ``ChunkedPlanNUFFT`` with 4 chunks, (b) ``exec_type{1,2}_sharded`` and
    ``SpatialNUFFT`` on an NCCL group of one rank; then (c)
    ``SpatialNUFFT`` complex64, sigma = 2, C = 16 on four gloo ranks
    spawned on the one card, each planning with a quarter of it (timed
    once: gloo moves the tensors through the host); and the 2D (4096^2)
    and 1D (2^20) complex64 rows at C = 32, whose peaks test the model's
    other dimensions, each also in groups of 8 against one pass.  Each of
    these rows: its groups, ms a transform (medians of 3), each exec's
    ``max_memory_allocated`` against the model and the process's share of
    the card (a peak above the share fails), transforms 0 and C - 1
    against exact sums (err1 / err2 <= 1e-5) and against one-transform
    runs of the same path (<= 1e-12 complex128, 1e-6 complex64), and one
    spread and one interpolation launch a group (a chunk a group) a call.
    Then every spread and interpolation entry point, four dtypes, with
    C = 5 and 32 transforms in one launch at 2^20, 4096^2 and 256^3
    (1,000,000 points) against its plain version run a transform at a
    time, with phase 4's limits;
16. the deconvolution kernels (``csrc/deconvolve.cu``) at the main-path
    shapes, N = 256^3 over the 384^3 grid, one transform, all four dtypes:
    type 1's truncate and type 2's pad against the plain torch chain (each
    element within 1e-6 relative in float32, 1e-15 in float64, whether
    bit-equal, one launch a call), timed in turns beside the bound by bytes;
    the pad with the scaling off equal to the plain padding bit for bit.

Each main-path row sets every launch count to 0 just before it drives the
path and reads the counts just after; a kernel of the path that was not
launched fails the run, and so does K3 (a window without coefficients)
launched other than once for each ``set_points`` call or at all by an
exec, and so do the two set_points kernels (``csrc/bin_sort.cu``); the
two deconvolution kernels must each launch on every main path.  At the
smaller Np of each dtype and dimension every kernel is held against its
plain version and timed; the set_points kernels' cells, fractions, order and
block starts must equal the plain chain's under ``torch.equal``.  The
float32-accumulation diagnostic (ROADMAP queue 3, P2) re-spreads the
complex64 rho = 1 row's own float32 values and fractions, widened to
float64, with the float64 kernel and a Z2Z FFT, and prints that err1 beside
the float32 err1 of three calls.  The line before the last is one JSON
object with each of the 42 kernel entry points (24 spread and
interpolation, two window-weights, four relayouts, four set_points, eight
deconvolution; these carry ``bit_equal``):
launches on its main
path, its error against its plain version, both times, the least time the
card could take for the same work (``bound_ms``) and what bounds it, the
library call's time (``library_ms``, the relayouts only), a ``windows`` map
with the same numbers under each window mode and m of phases 10-11, and
for the relayouts a ``shapes`` map (each shape's kernel ``ms`` from calls
back to back beside ``call_ms``, one wrapper call), for the spread and
interpolation entry points a ``transforms`` map (phase 15's results at
C = 5 and 32), for the set_points entry points a ``rows`` map (each
main-path row's comparison; the headline numbers are the first 3D row's);
the last line is
``{"ok": true, "device": {...}}``.

Tolerances: kernels against plain versions <= 1e-5 relative L2 in float32
(atomics add in a run-dependent order; ~1e-7 expected) and <= 1e-12 in
float64 (~1e-16 expected); err1, err2 <= 1e-5 at m = 4, sigma = 1.5 (the
window's own error is ~1.5e-6) and <= 1e-11 at m = 8, sigma = 2 (~2e-14;
anything float32 left on the 64-bit path would floor it near 1e-7).
Phases 10-12 hold err1 / err2 to D times the window's 1D budget at sigma = 2
(``error_budget``, copied from tests/test_accuracy.py: 1.5e-7 for (B)KB,
1.3e-4 for the Gaussian and 4.8e-5 for the B-spline at m = 4), at least
1e-5 for complex64; at m = 10 64-bit (B)KB to 1e-11, the Gaussian and
B-spline to max(D x budget, 1e-11), 32-bit plans to 5e-5; the adapter's KB
to 10 x reltol.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNEL_TOL = {4: 1e-5, 8: 1e-12}  # by the bytes of the plan's real scalar
ERR_TOL = 1e-5
ERR_TOL_64 = 1e-11
SHAPE_3D = (256,) * 3
NP_MAIN = (1_000_000, 16_777_216)
NP_64 = (1_677_722, 16_777_216)
SHAPE_2D = (4096, 4096)
SHAPE_1D = (1 << 20,)
NP_1D = (1_000_000, 10_000_000)
ACC_SHAPES, NP_ACC = ((64,) * 3, (256, 256), (4096,)), 200_000  # phase 5
SIGMA_W = 2.0  # phases 10-12
NP_M10, M10_SHAPES = 50_000, ((32,) * 3, (128, 128), (4096,))  # phase 11
NFFT_RELTOL, NP_NFFT = 1e-9, 16_777_216  # phase 12
# Phase 13: the spatial run's points, ranks, lane slack, repetitions, and
# the agreement with the single-card plan by the bytes of a real scalar.
NP_SPATIAL, SPATIAL_RANKS, SPATIAL_CAPACITY, SPATIAL_REPS = 16_777_216, 4, 1.25, 3
SPATIAL_AGREE = {8: 1e-5, 16: 1e-12}
# Phase 14: rho = 1 and rho = 10 at 256^3, the direct rows (shape, Np), the
# chunks, the 1D chunked row (Np, chunks), and the limits by the bytes of a
# real scalar: callbacks fused against applied by hand, the direct path
# against exact sums, chunked against unchunked; the timer's stage sums
# against its whole call.
NP_RHO1, NP_RHO10, NCHUNKS = 16_777_216, 167_772_160, 4
DIRECT_ROWS = ((SHAPE_3D, (1_678, 16_777)), (SHAPE_1D, (1_000,)))
CHUNKED_1D = (10_000_000, 3)
CALLBACK_TOL = {4: 1e-6, 8: 1e-12}
DIRECT_TOL = {4: 2e-6, 8: 1e-12}
CHUNK_TOL = {4: 1e-5, 8: 1e-12}
STAGE_GAP_MS = 0.5
# Phase 15: the points, the rows (dtype, sigma, transform counts), the
# grouped-against-whole row (C, forced group size) and its limits by the
# bytes of a real scalar, and the kernel checks' transform counts and points.
NT_NP = 1_000_000
NT_ROWS = ((np.complex64, 1.5, (1, 2, 8, 32)), (np.complex128, 1.5, (1, 2, 8, 32)),
           (np.float32, 1.5, (8,)), (np.float64, 1.5, (8,)),
           (np.complex128, 2.0, (32,)), (np.complex64, 2.0, (32,)))
NT_GROUPED = (8, 3)
GROUPED_TOL = {4: 1e-6, 8: 1e-12}
NT_KERNEL_COUNTS, NT_KERNEL_NP = (5, 32), 1_000_000
# Phase 15's other paths: beside the plain row of NT_PATHS (dtype, sigma,
# C), the points-chunked plan (NCHUNKS chunks) and the point-sharded and
# spatial modes on an NCCL group of one rank, timed as medians of
# NT_PATH_REPS; the spatial mode on NT_GLOO ranks of a gloo group sharing
# the card (dtype, sigma, C, ranks), timed once; and the 2D and 1D rows
# NT_LOWDIM (shape, dtype, C, forced group size).
NT_PATHS = (np.complex128, 2.0, 32)
NT_GLOO = (np.complex64, 2.0, 16, 4)
NT_LOWDIM = ((SHAPE_2D, np.complex64, 32, 8), (SHAPE_1D, np.complex64, 32, 8))
NT_PATH_REPS = 3
REPS = 5
ERR_MODES = 64
ERR_POINTS = 4096
PLAIN_CHUNK = 1 << 16
# H100 SXM at 700 W (NVIDIA's data sheet): HBM3 rate, FP32 and FP64 peaks
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}
_CSRC = "nonuniformffts_tpu_torch/csrc"
_Z = "nonuniformffts_tpu/ops/pallas/blocked.py"
_DS = "nonuniformffts_tpu/ops/pallas/blocked_ds.py"
# The TPU kernel each entry point replaces, by (kind, D, 64-bit): in 3D the
# z-form kernels (32-bit) and the double-single kernels (64-bit); in 1D and
# 2D the yz-form kernels, which 64-bit plans run too unless
# precision='double' (then blocked_ds.py, whose 2D form the *_f64 entry
# points also replace).
_REPLACES = {
    ("spread", 3, False): f"{_Z}:639", ("interp", 3, False): f"{_Z}:1393",
    ("spread", 3, True): f"{_DS}:132", ("interp", 3, True): f"{_DS}:314",
    **{(kind, d, w): f"{_Z}:{line}" for kind, line in (("spread", 501), ("interp", 1225))
       for d in (1, 2) for w in (False, True)},
}
KERNELS = {
    **{f"nufft_{kind}_{d}d_{suffix}": dict(source=f"{_CSRC}/{kind}_{d}d.cu",
                                           replaces=_REPLACES[(kind, d, "f64" in suffix)])
       for d in (3, 2, 1) for suffix in ("f32", "real_f32", "f64", "real_f64")
       for kind in ("spread", "interp")},
    # K3: window_weights, which every TPU spread and interpolation kernel
    # calls in its body.
    **{f"nufft_window_weights_{t}": dict(source=f"{_CSRC}/window_weights.cu",
                                         replaces="nonuniformffts_tpu/ops/pallas/common.py:120")
       for t in ("f32", "f64")},
    # K8a / K8b: the block-interleave relayouts, the pack and unpack around
    # the spatial mode's slab transposes.
    **{f"nufft_relayout_to_{d}_{t}": dict(source=f"{_CSRC}/relayout.cu",
                                          replaces=f"nonuniformffts_tpu/ops/pallas/common.py:{line}")
       for d, line in (("grid", 438), ("blocks", 490)) for t in ("f32", "f64")},
    # set_points' key and sorted-state kernels, which replace no TPU kernel.
    **{f"nufft_{kind}_{t}": dict(source=f"{_CSRC}/bin_sort.cu",
                                 replaces="none (JAX set_points is jnp + lax.sort)")
       for kind in ("bin_keys", "sorted_state") for t in ("f32", "f64")},
    # The deconvolution's truncate-and-scale and scale-and-pad, which replace
    # no TPU kernel.
    **{f"nufft_deconvolve_{step}_{t}": dict(source=f"{_CSRC}/deconvolve.cu",
                                            replaces="none (JAX deconvolution is jnp slices, "
                                                     "concatenations and multiplies)")
       for step in ("truncate", "pad") for t in ("f32", "real_f32", "f64", "real_f64")},
}
#: Each main-path row's set_points comparison by entry point, then row label
#: (``compare_set_points``).
SET_POINTS_ROWS = collections.defaultdict(dict)
# Window modes by label: (kernel class, evaluation mode).
WINDOW_MODES = {
    f"{label} {mode}": (cls, ev)
    for label, cls in (("KB", "KaiserBesselKernel"), ("BKB", "BackwardsKaiserBesselKernel"),
                       ("Gaussian", "GaussianKernel"), ("B-spline", "BSplineKernel"))
    for mode, ev in (("Fast", "FastApproximation"), ("Direct", "Direct"))
}
PHASE10_MODES = ("BKB Fast", "KB Fast", "KB Direct", "BKB Direct", "Gaussian Fast",
                 "Gaussian Direct", "B-spline Direct")
MAIN_WINDOW = WINDOW_MODES["BKB Fast"]


def error_budget(kernel: str, m: int) -> float:
    """Relative L2 error budget of one dimension at sigma = 2 (copied from
    tests/test_accuracy.py:error_budget, whose file imports JAX), the
    64-bit floor included."""
    if kernel in ("KaiserBesselKernel", "BackwardsKaiserBesselKernel"):
        return max(6 * 10.0 ** (-1.9 * m), 4e-14)
    if kernel == "GaussianKernel":
        return 10.0 ** (-0.95 * m) * 0.8
    if kernel == "BSplineKernel":
        return 10.0 ** (-0.98 * m) * 0.4
    raise ValueError(kernel)


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def nvidia_smi_line() -> str:
    return run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]


def shape_text(shape) -> str:
    return "x".join(map(str, shape))


def rel_l2(a, b) -> float:
    return float(((a - b).abs().pow(2).sum() / b.abs().pow(2).sum()).sqrt())


def check(name: str, value: float, tol: float) -> None:
    log(f"  {name} = {value:.3e} (limit {tol:.0e})")
    if not (value <= tol):
        raise AssertionError(f"{name} = {value:.3e} exceeds {tol:.0e}")


def cuda_time_ms(fn, reps: int = REPS, warmup: int = 1):
    """Median CUDA-event time of ``fn()`` over ``reps`` runs after
    ``warmup`` runs; returns (ms, last result)."""
    import torch

    out = None
    for _ in range(warmup):
        out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), out


def phase_environment():
    import torch

    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch.version.cuda {torch.version.cuda}")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    log("nvcc: " + (run([nvcc, "--version"]).splitlines()[-1]
                    if Path(nvcc).exists() else "not found"))
    try:
        import triton

        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not installed")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script needs a GPU")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    log(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _kernel_label(mangled: str) -> str:
    """``spread_3d<M=4, double, 2>``, ``interp_1d<M=4, float, 2, taps,
    sorted>``, ``interp_2d<M=4, float, 2, point>`` (a ``*_point_kernel``),
    ``window_weights<kind=1, M=4, double, 2>`` (window kind, M, scalar,
    points a thread) or ``deconvolve_pad<float, 2>`` (scalar, values an
    access) from a mangled kernel name."""
    m = re.search(r"(spread|interp)_(\d)d_(point_)?kernelILi(\d+)E([fd])Li(\d)E(?:Lb([01])E)?"
                  r"(?:Lb([01])E)?", mangled)
    if m:
        return (f"{m[1]}_{m[2]}d<M={m[4]}, {'float' if m[5] == 'f' else 'double'}, {m[6]}"
                + (", taps" if m[7] == "1" else "") + (", sorted" if m[8] == "1" else "")
                + (", point" if m[3] else "") + ">")
    m = re.search(r"(truncate|pad)_kernelI([fd])Li(\d)E", mangled)
    if m:
        return f"deconvolve_{m[1]}<{'float' if m[2] == 'f' else 'double'}, {m[3]}>"
    m = re.search(r"window_weights_kernelILi(\d)ELi(\d+)E([fd])Li(\d)E", mangled)
    if m:
        return (f"window_weights<kind={m[1]}, M={m[2]}, "
                f"{'float' if m[3] == 'f' else 'double'}, {m[4]}>")
    return mangled


def report_ptxas(text: str) -> None:
    """One line per kernel instantiation: registers, spills, stack."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(name=_kernel_label(m[1]))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m[1]), spill_st=int(m[2]), spill_ld=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["regs"] = int(m[1])
            rows.append(cur)
            cur = None
    for r in sorted(rows, key=lambda r: r["name"]):
        log(f"  ptxas {r['name']}: {r['regs']} registers, spill stores "
            f"{r.get('spill_st')} B, loads {r.get('spill_ld')} B, stack {r.get('stack')} B")


def report_sass_atomics(lib_path: Path) -> None:
    """The atomic and FP64 tensor-core instructions of each kernel's SASS: a
    shared-memory add compiled to a compare-and-swap loop shows as
    ATOMS.CAST.SPIN, an ``mma.sync .f64`` as DMMA.  The 2D and 3D spread
    kernels contract on the tensor cores and add in registers: an
    instantiation without DMMA or with a shared-memory atomic fails the
    phase."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("  cuobjdump: not found, SASS not read")
        return
    sass = run([tool, "-sass", str(lib_path)])
    wrong = []
    for part in re.split(r"\n\s+Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        label = _kernel_label(name.strip())
        ops = collections.Counter(re.findall(
            r"\b((?:ATOMS|ATOMG|REDG|RED|ATOM)\.[A-Za-z0-9.]+|DMMA(?:\.[A-Za-z0-9.]+)?)", body))
        log(f"  sass {label}: "
            + (", ".join(f"{k} x{v}" for k, v in sorted(ops.items())) or "no atomics"))
        if label.startswith(("spread_2d<", "spread_3d<")) and (
                any(k.startswith("ATOMS") for k in ops)
                or not any(k.startswith("DMMA") for k in ops)):
            wrong.append(label)
    if wrong:
        raise AssertionError("spread instantiations with a shared-memory atomic or "
                             f"without DMMA: {wrong}")


def phase_build():
    from nonuniformffts_tpu_torch.ops.kernels import build

    log("== phase 2: build")
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    log(f"built and loaded {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if build.PTXAS_LOG.exists():
        text = build.PTXAS_LOG.read_text()
        done = sorted(((float(t), n) for n, t in re.findall(r"^--- (.+) \(([\d.]+) s\)$", text,
                                                            re.M)), reverse=True)
        log("  compiles finished (s after the start), slowest first: "
            + ", ".join(f"{n} {t:.1f}" for t, n in done))
        report_ptxas(text)
    report_sass_atomics(path)


def _uniform_points(gen, D: int, np_: int, dtype, device):
    import torch

    return torch.rand((D, np_), generator=gen, device=device, dtype=dtype) * (2 * math.pi)


def _random_values(gen, shape, dtype, device):
    import torch

    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


# Operations per point and transform of each kernel's loops beyond the taps,
# by D (S = 2M taps a dim, n scalars a value): 3D and 2D spread form the
# trailing tap products and add v * w per tap; 1D spread does one FMA per
# (point, tap) and scalar; interpolation FMAs every level of the
# tensor-product window and scales by normfactor.
_SPREAD_OPS = {
    1: lambda S, n: 2 * n * S,
    2: lambda S, n: S * S * (1 + 2 * n),
    3: lambda S, n: S * S * (1 + n) + 2 * n * S ** 3,
}


def tap_ops(plan) -> float:
    """Operations of one window tap, estimated from the formulas of
    csrc/window.cuh: Horner 2 (ncoef - 1) (an FMA is two); KB Direct ~50
    (y, 1 - y^2, sqrt, beta s and I0's polynomials); BKB Direct ~30 (two exps
    and a division); the Gaussian ~15 (one exp); the B-spline ~2.5 S (de
    Boor's S^2 / 2 updates of about five operations, over S taps)."""
    from nonuniformffts_tpu_torch.ops.windows import WINDOW_KINDS

    S = 2 * plan.m
    by_kind = {"horner": 2 * (plan.m + 3), "kb_direct": 50, "bkb_direct": 30,
               "gaussian": 15, "bspline": 2.5 * S}
    return by_kind[next(k for k, v in WINDOW_KINDS.items() if v == plan.window.kind)]


def kernel_bound(kind: str, plan, C: int):
    """Least time the card could take for a wrapper's work on these inputs:
    the larger of the bytes it must move (each input read once, each output
    written once) over the HBM rate and its operations over the FP32 or FP64
    peak.  ``kind``: 'spread', 'interp' or 'weights' (K3, whose output is
    the taps).  A spread or interpolation kernel of a window without
    coefficients reads the plan's K3 table (its bytes count, its taps no
    operations); one with coefficients evaluates the taps.  Returns (ms,
    'bytes' or 'operations')."""
    from nonuniformffts_tpu_torch.blocking import num_blocks
    from nonuniformffts_tpu_torch.ops.kernels.blocked import kernel_coefs
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    D = plan.ndim
    S, np_ = 2 * plan.m, plan.num_points
    ncoef = kernel_coefs(plan)[1]
    vol = math.prod(plan.shape_over)
    nblocks = math.prod(num_blocks(plan.shape_over, plan.block_dims))
    # cells, fracs, the permutation, and the coefficients or the K3 table;
    # the 1D interpolation needs 4 bytes a point of permutation (its gather
    # reads the int32 inverse), the others read the int64 sort_perm
    perm = 4 if kind == "interp" and D == 1 else 8
    state = (np_ * (D * 4 + D * sb + perm)
             + (D * S * ncoef * sb if ncoef else np_ * D * S * sb))
    taps = D * S * tap_ops(plan)  # the taps' operations, per point
    if kind == "weights":
        nbytes = np_ * D * sb + np_ * D * S * sb
        ops = np_ * taps
    elif kind == "spread":
        nbytes = C * np_ * ncomp * sb + state + (nblocks + 1) * 4 + C * vol * ncomp * sb
        ops = np_ * ((taps if ncoef else 0) + C * _SPREAD_OPS[D](S, ncomp))
    else:
        # the 1D and 3D kernels read the block ranges too
        nbytes = (C * vol * ncomp * sb + state + C * np_ * ncomp * sb
                  + (nblocks + 1) * 4 * (D != 2))
        ops = np_ * ((taps if ncoef else 0) + C * ncomp * 2 * sum(S ** i for i in range(D + 1)))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[sb]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def entry_points(plan):
    """The entry points a plan's transforms launch: spread, interpolation
    and, for a window without coefficients, K3."""
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    names = [blocked.entry_point(k, plan) for k in ("spread", "interp")]
    if blocked.kernel_coefs(plan)[0] is None:
        names.append(blocked.WEIGHTS_ENTRY[plan.real_dtype])
    return names


def deconvolve_entry_points(plan):
    """The deconvolution kernels a plan's transforms launch: type 1's
    truncate and type 2's pad."""
    from nonuniformffts_tpu_torch.ops.kernels.common import deconvolve_entry_name

    return [deconvolve_entry_name(step, plan.dtype) for step in ("truncate", "pad")]


def compare_kernels(plan, vp, grid, timed: bool, plain_chunk: int = PLAIN_CHUNK,
                    plain_reps: int = 3):
    """The plan's spread and interpolation kernels (and K3 for a window
    without coefficients) against their plain versions on the same inputs;
    timed in turns (plain, kernel, kernel, plain) when ``timed``."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import blocked

    plain = dataclasses.replace(plan, chunk_size=plain_chunk)
    tol = KERNEL_TOL[torch.empty((), dtype=plan.real_dtype).element_size()]
    pairs = {
        "spread": (lambda: blocked.spread_blocked(plan, vp),
                   lambda: blocked.spread_blocked_plain(plain, vp)),
        "interp": (lambda: blocked.interpolate_blocked(plan, grid),
                   lambda: blocked.interpolate_blocked_plain(plain, grid)),
    }
    if blocked.kernel_coefs(plan)[0] is None:
        pairs["weights"] = (lambda: blocked.window_weights_blocked(plan),
                            lambda: blocked.window_weights_blocked_plain(plan))
    results = {}
    for kind, (kern, ref) in pairs.items():
        name = (blocked.WEIGHTS_ENTRY[plan.real_dtype] if kind == "weights"
                else blocked.entry_point(kind, plan))
        if timed:
            p1, want = cuda_time_ms(ref, reps=plain_reps)
            k1, got = cuda_time_ms(kern)
            k2, _ = cuda_time_ms(kern)
            p2, _ = cuda_time_ms(ref, reps=plain_reps)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        else:
            got, want = kern(), ref()
            ms = plain_ms = None
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        max_abs = float((got - want).abs().max())
        bound_ms, bound_by = kernel_bound(kind, plan, vp.shape[0])
        log(f"  {name}: rel L2 {err:.3e}, max abs {max_abs:.3e}"
            + (f", kernel {ms:.3f} ms, plain {plain_ms:.3f} ms" if timed else "")
            + f", bound {bound_ms:.4g} ms ({bound_by})")
        check(f"{name} rel L2 vs plain", err, tol)
        results[name] = dict(max_abs_err=max_abs, rel_l2=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        del got, want
    return results


def compare_set_points(label: str, plan, pts):
    """The set_points kernels (``csrc/bin_sort.cu``) against the plain
    chain on ``pts``: the whole sorted state
    (``plan._sorted_state_kernels`` against ``_sorted_state_plain``), the
    key kernel against ``cells_and_fracs`` and ``cell_keys``, and the
    sorted-state kernel against ``block_starts`` and ``sorted_copies`` after
    the same sort, each held equal under ``torch.equal`` and timed in turns
    (plain, kernel, kernel, plain).  Bounds by the function's bytes: the
    keys read D coordinates and write a key a point; the sorted state reads
    a key, an index and D coordinates and writes D cells and D fractions a
    point, and the block starts.  The records the key kernel packs for the
    gather (2 or 4 coordinates in 2D / 3D) are left out of the bound and
    reported beside it (``record_ms``).  Stores each entry point's results
    under ``label`` in ``SET_POINTS_ROWS``."""
    import torch

    from nonuniformffts_tpu_torch import blocking
    from nonuniformffts_tpu_torch import plan as plan_mod
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    geo = (plan.shape_over, plan.block_dims)
    pts = plan_mod._transformed_points(plan, pts).contiguous()

    def in_turns(kern, ref):
        p1, want = cuda_time_ms(ref)
        k1, got = cuda_time_ms(kern)
        k2, _ = cuda_time_ms(kern)
        p2, _ = cuda_time_ms(ref)
        return (k1 + k2) / 2, (p1 + p2) / 2, got, want

    def require_equal(what, got, want):
        if not all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"set_points kernels ({label}): {what} not equal to the "
                                 "plain chain")

    chain_ms, chain_plain_ms, got, want = in_turns(
        lambda: plan_mod._sorted_state_kernels(plan, pts),
        lambda: plan_mod._sorted_state_plain(plan, pts))
    require_equal("cells, fractions, order, block starts", got[:4], want[:4])
    cells, fracs = blocking.cells_and_fracs(plan.kernel_data, pts)
    keys_ms, keys_plain_ms, (keys, records), key_p = in_turns(
        lambda: blocked.bin_keys(pts, *geo),
        lambda: blocking.cell_keys(blocking.cells_and_fracs(plan.kernel_data, pts)[0], *geo))
    require_equal("keys", (keys,), (key_p,))
    skeys, perm = torch.sort(keys, stable=True)
    state_ms, state_plain_ms, got, want = in_turns(
        lambda: blocked.sorted_state(records, skeys, perm, *geo),
        lambda: (*blocking.sorted_copies(cells, fracs, perm),
                 blocking.block_starts(skeys, *geo)))
    require_equal("sorted state", got, want)
    sort_ms, _ = cuda_time_ms(lambda: torch.sort(keys, stable=True))
    D, np_ = pts.shape
    sb = pts.element_size()
    nblocks = math.prod(blocking.num_blocks(*geo))
    rec = blocked.BIN_RECORD[D] * sb if D > 1 else 0
    nbytes = {"keys": np_ * (D * sb + 4),
              "state": np_ * (4 + 8 + D * sb + D * 4 + D * sb) + 4 * (nblocks + 1)}
    record_ms = 1e3 * np_ * (2 * rec - D * sb if rec else 0) / HBM_BYTES_PER_S
    common = dict(np=np_, max_abs_err=0.0, rel_l2=0.0, equal=True, sort_ms=sort_ms,
                  chain_ms=chain_ms, chain_plain_ms=chain_plain_ms, record_ms=record_ms,
                  bound_by="bytes")
    names = dict(zip(("keys", "state"), blocked.BIN_SORT_ENTRIES[pts.dtype]))
    for part, ms, plain_ms in (("keys", keys_ms, keys_plain_ms),
                               ("state", state_ms, state_plain_ms)):
        bound_ms = 1e3 * nbytes[part] / HBM_BYTES_PER_S
        SET_POINTS_ROWS[names[part]][label] = dict(common, ms=ms, plain_ms=plain_ms,
                                                   bound_ms=bound_ms)
        log(f"  {names[part]}: equal, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4g} ms (bytes)")
    log(f"  set_points kernels + sort {chain_ms:.3f} ms (sort {sort_ms:.3f}), plain chain "
        f"{chain_plain_ms:.3f} ms; the records' bytes {record_ms:.4g} ms beside the bounds")


def check_kernel(kind: str, plan, vp, gen):
    """The plan's spread (``kind`` 'spread') or interpolation ('interp')
    kernel against its plain version on the main path's own points (the
    row's values, or a random grid), one wrapper call timed (CUDA events,
    median of 5 after one warm-up) and the plain version run once, with the
    bound of that work."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import blocked

    plain = dataclasses.replace(plan, chunk_size=PLAIN_CHUNK)
    if kind == "spread":
        ms, got = cuda_time_ms(lambda: blocked.spread_blocked(plan, vp))
        want = blocked.spread_blocked_plain(plain, vp)
    else:
        grid = _random_values(gen, (1,) + plan.shape_over, plan.dtype, vp.device)
        ms, got = cuda_time_ms(lambda: blocked.interpolate_blocked(plan, grid))
        want = blocked.interpolate_blocked_plain(plain, grid)
    torch.cuda.synchronize()
    err = rel_l2(got, want)
    max_abs = float((got - want).abs().max())
    bound_ms, bound_by = kernel_bound(kind, plan, vp.shape[0])
    name = blocked.entry_point(kind, plan)
    design = ""
    if kind == "interp" and plan.ndim == 2:  # csrc/interp_2d.cu runs one of two designs
        from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES, interp2d_chunked_rows

        rows = interp2d_chunked_rows(*VALUE_TYPES[plan.dtype][1:], plan.m)
        design = " (whole-chunk rows)" if rows else " (the first design's rolled loop)"
    log(f"  {name}{design} at Np = {plan.num_points:,}: rel L2 {err:.3e}, max abs "
        f"{max_abs:.3e} vs plain, kernel {ms:.3f} ms, bound {bound_ms:.4g} ms ({bound_by})")
    check(f"{name} rel L2 vs plain at Np={plan.num_points}", err,
          KERNEL_TOL[torch.empty((), dtype=plan.real_dtype).element_size()])
    return dict(rel_l2=err, max_abs_err=max_abs, ms=ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_kernels(seed: int):
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch.ops.kernels import blocked
    from nonuniformffts_tpu_torch.ops.kernels.common import INTERP3D_SPARSE

    log("== phase 3: complex64 kernels against their plain versions (64^3, 200,000 points)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    plan = nufft.PlanNUFFT(np.complex64, (64, 64, 64), m=4, sigma=1.5,
                           spread_method="blocked", device=dev)
    plan = nufft.set_points(plan, _uniform_points(gen, 3, 200_000, torch.float32, dev))
    log(f"  grid {plan.shape_over}, block_dims {plan.block_dims}")
    vp = _random_values(gen, (1, 200_000), torch.complex64, dev)
    grid = _random_values(gen, (1,) + plan.shape_over, torch.complex64, dev)
    blocked.reset_launch_counts()
    compare_kernels(plan, vp, grid, timed=False)
    names = [blocked.entry_point(k, plan) for k in ("spread", "interp")]
    log(f"  launches { {n: blocked.LAUNCHES[n] for n in names} }")
    if min(blocked.LAUNCHES[n] for n in names) < 1:
        raise AssertionError("a kernel was not launched in phase 3")
    # 2,000 points over the same blocks: every block holds fewer than
    # INTERP3D_SPARSE points, so the interpolation kernel reads them from
    # global memory rather than staging them.
    sparse = nufft.set_points(plan, _uniform_points(gen, 3, 2_000, torch.float32, dev))
    counts = sparse.pstarts[1:] - sparse.pstarts[:-1]
    log(f"  2,000 points: {int(((counts > 0) & (counts < INTERP3D_SPARSE)).sum())} blocks "
        f"read from global memory, {int((counts >= INTERP3D_SPARSE).sum())} staged")
    err = rel_l2(blocked.interpolate_blocked(sparse, grid),
                 blocked.interpolate_blocked_plain(sparse, grid))
    log(f"  {blocked.entry_point('interp', sparse)} on sparse blocks: rel L2 {err:.3e}")
    check("interp on sparse blocks vs plain", err, KERNEL_TOL[4])


# ---------------------------------------------------------------------------
# Accuracy oracles (exact float64 sums), after bench.py
# ---------------------------------------------------------------------------


def _err1(pts, v, uhat, shape, real: bool, seed: int, modes: int = ERR_MODES,
          rows=None) -> float:
    """Type-1 output against exact float64 sums at ``modes`` random modes,
    computed on the card in point chunks (bench.py:measure_t1_error).  Real plans store
    k = 0..+N/2 on the halved LAST axis: the Nyquist index is POSITIVE there
    (bench.py:336-347), while the full axes fold index N/2 to -N/2.  With
    ``rows`` (start, stop) the modes come from those indices of dim 0 and
    ``uhat`` holds only them (a dim-0 shard)."""
    import torch

    D = len(shape)
    rng = np.random.default_rng(seed + 7)
    kidx = np.stack([rng.integers(0, n, modes) for n in shape], axis=1)
    if real:
        kidx[:, -1] = rng.integers(0, shape[-1] // 2 + 1, modes)
    if rows is not None:
        kidx[:, 0] = rng.integers(rows[0], rows[1], modes)
    n = np.array(shape)
    kval = np.where(kidx >= (n + 1) // 2, kidx - n, kidx).astype(np.float64)
    if real:
        kval[:, -1] = kidx[:, -1]
    k = torch.as_tensor(kval, device=pts.device)
    v = v.to(torch.complex128)
    exact = torch.zeros(modes, dtype=torch.complex128, device=pts.device)
    step = max(1, (1 << 26) // modes)
    for s in range(0, pts.shape[1], step):
        ph = k @ pts[:, s : s + step].to(torch.float64)
        exact += torch.exp(-1j * ph) @ v[s : s + step]
    if rows is not None:
        kidx[:, 0] -= rows[0]
    ki = torch.as_tensor(kidx, device=uhat.device)
    got = uhat[tuple(ki[:, d] for d in range(D))].to(torch.complex128)
    return rel_l2(got, exact)


def _rank1_spectrum(shape, real: bool, seed: int):
    """Per-dim factors of a rank-1 spectrum and the spectrum itself
    (complex128, numpy).  Real plans get the c2r oracle's factors
    (bench.py:386-428): Hermitian full axes with a zero Nyquist bin, and a
    halved last axis of N // 2 + 1 modes with a real k = 0 term."""
    rng = np.random.default_rng(seed + 8)
    if not real:
        a = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)) / n for n in shape]
        return a, functools.reduce(np.multiply.outer, a)

    def herm_full(n):
        f = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / n
        f[0] = f[0].real
        f[n // 2] = 0.0
        f[n // 2 + 1 :] = np.conj(f[1 : n // 2][::-1])
        return f

    H = shape[-1] // 2 + 1
    a_last = (rng.standard_normal(H) + 1j * rng.standard_normal(H)) / shape[-1]
    a_last[0] = a_last[0].real
    a = [herm_full(n) for n in shape[:-1]] + [a_last]
    return a, functools.reduce(np.multiply.outer, a)


def _factor_sums(x, coefs, half: bool = False):
    """``sum_k coefs[k] exp(i k x)`` for each point x (float64, on the
    card), over the FFT-ordered wavenumbers k of a full axis or, for a
    halved axis (``half``), k = 0..len(coefs) - 1; chunked to ~2^24 terms."""
    import torch

    K = len(coefs)
    kv = np.arange(K, dtype=np.float64) if half else np.fft.fftfreq(K, 1.0 / K)
    k = torch.as_tensor(kv, device=x.device)
    c = torch.as_tensor(coefs, device=x.device)
    step = max(1, (1 << 24) // K)
    return torch.cat([torch.exp(1j * torch.outer(x[s : s + step], k)) @ c
                      for s in range(0, len(x), step)])


def _err2(pts, v2, a, real: bool, seed: int, points: int = ERR_POINTS) -> float:
    """Type-2 output for the rank-1 spectrum a_0 x ... x a_{D-1}, whose
    exact values are products of 1D sums (bench.py:measure_t2_error),
    computed on the card.  On real plans the c2r convention doubles every
    stored k > 0 entry of the halved last axis, the +N/2 one included, and
    takes real parts (bench.py:measure_t2_error_real)."""
    import torch

    sel = torch.as_tensor(np.random.default_rng(seed + 9).integers(0, pts.shape[1], points),
                          device=pts.device)
    x = pts[:, sel].double()
    got = v2[sel].to(torch.complex128)
    if not real:
        exact = torch.ones(points, dtype=torch.complex128, device=pts.device)
        for d, ad in enumerate(a):
            exact = exact * _factor_sums(x[d], ad)
    else:
        exact = torch.ones(points, dtype=torch.float64, device=pts.device)
        for d, ad in enumerate(a[:-1]):
            exact = exact * _factor_sums(x[d], ad).real
        last = 2.0 * _factor_sums(x[-1], a[-1], half=True).real - a[-1][0].real
        exact = (exact * last).to(torch.complex128)
    return rel_l2(got, exact)


# ---------------------------------------------------------------------------
# Phases 4-9
# ---------------------------------------------------------------------------


def _window_kw(window=MAIN_WINDOW):
    """The plan keyword arguments of a window, (kernel class, evaluation
    mode) by name."""
    import nonuniformffts_tpu_torch as nufft

    return dict(kernel=getattr(nufft, window[0])(), kernel_evalmode=getattr(nufft, window[1])())


def _plan(dtype, shape, m: int, sigma: float, window=MAIN_WINDOW, **kw):
    import torch

    import nonuniformffts_tpu_torch as nufft

    return nufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma, spread_method="blocked",
                           device=torch.device("cuda"), **_window_kw(window), **kw)


def float32_accumulation_diagnostic(plan, pts, vp, err1_f32: float, seed: int):
    """P2 (ROADMAP queue 3): err1 of two more float32 calls on the same
    inputs (the atomics' order changes between calls), and err1 of the same
    float32 values and fractions widened to float64, spread by the float64
    kernel at the same block geometry and transformed by a Z2Z FFT.  The gap
    is what float32 arithmetic and accumulation add."""
    import torch

    import nonuniformffts_tpu_torch as nufft

    e32 = [err1_f32] + [_err1(pts, vp, nufft.exec_type1(plan, vp), plan.shape,
                              False, seed) for _ in range(2)]
    p64 = dataclasses.replace(
        _plan(np.complex128, plan.shape, plan.m, plan.sigma, block_dims=plan.block_dims),
        cells_sorted=plan.cells_sorted, fracs_sorted=plan.fracs_sorted.double(),
        sort_perm=plan.sort_perm, pstarts=plan.pstarts,
        num_points_static=plan.num_points,
    )
    assert p64.shape_over == plan.shape_over
    e64 = _err1(pts, vp, nufft.exec_type1(p64, vp.to(torch.complex128)), plan.shape,
                False, seed)
    log(f"  P2 diagnostic: err1 float32 path {', '.join(f'{e:.3e}' for e in e32)}; "
        f"same inputs spread and transformed in float64 {e64:.3e}; "
        f"gap {min(e32) - e64:.3e} .. {max(e32) - e64:.3e}")
    del p64
    torch.cuda.empty_cache()
    return dict(err1_f32=e32, err1_f64_same_inputs=e64)


def main_path(label: str, dtype, shape, np_list, compare_np: int, seed: int,
              diagnose_at=None, m: int = 4, sigma: float = 1.5, window=MAIN_WINDOW,
              err_tol: float = ERR_TOL, err_modes: int = ERR_MODES, check_np=None):
    """Drive one dtype's main path at ``shape``, ``m``, ``sigma`` and
    ``window`` (kernel class and evaluation mode names; BKB
    FastApproximation, m = 4, sigma = 1.5 by default) for each Np, holding
    err1 (at ``err_modes`` random modes) and err2 to ``err_tol``; returns (launches summed over the rows,
    kernel comparisons at ``compare_np``).  At Np = ``diagnose_at`` also
    runs ``float32_accumulation_diagnostic``, and at ``check_np``
    ``check_kernel`` for the spread and interpolation kernels of 1D and 2D
    at full density.  A window whose taps come from K3 must launch it once
    for each ``set_points`` call and never in an exec, and so must the two
    set_points kernels; at ``compare_np`` ``compare_set_points`` holds them
    to the plain chain."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    dev = torch.device("cuda")
    D = len(shape)
    plan0 = _plan(dtype, shape, m, sigma, window)
    bin_names = blocked.BIN_SORT_ENTRIES[plan0.real_dtype]
    names = entry_points(plan0) + list(bin_names) + deconvolve_entry_points(plan0)
    log(f"  {label}: grid {plan0.shape_over}, block_dims {plan0.block_dims}, "
        f"kernels {names}")
    a, u_np = _rank1_spectrum(shape, plan0.is_real, seed)
    u_spec = torch.as_tensor(u_np, device=dev).to(plan0.complex_dtype)
    del u_np
    launches = dict.fromkeys(names, 0)
    compared, rows = {}, []
    for np_ in np_list:
        gen = torch.Generator(device=dev).manual_seed(seed + np_)
        pts = _uniform_points(gen, D, np_, plan0.real_dtype, dev)
        vp = _random_values(gen, (np_,), plan0.dtype, dev)
        torch.cuda.synchronize()

        blocked.reset_launch_counts()
        t_set, plan = cuda_time_ms(lambda: nufft.set_points(plan0, pts))
        at_set = {n: blocked.LAUNCHES[n] for n in names}
        t_t1, uhat = cuda_time_ms(lambda: nufft.exec_type1(plan, vp))
        t_t2, v2 = cuda_time_ms(lambda: nufft.exec_type2(plan, u_spec))
        vp_c = vp[None]
        stages = {}
        stages["t1 spread"], g = cuda_time_ms(lambda: ex.t1_spread_stage(plan, vp_c))
        stages["t1 fft"], spec = cuda_time_ms(lambda: ex.t1_fft_stage(plan, g))
        stages["t1 deconvolve"], _ = cuda_time_ms(lambda: ex.t1_deconv_stage(plan, spec))
        del g, spec
        stages["t2 pad"], w = cuda_time_ms(lambda: ex.t2_pad_stage(plan, u_spec[None]))
        stages["t2 fft"], gr = cuda_time_ms(lambda: ex.t2_fft_stage(plan, w))
        stages["t2 interp"], _ = cuda_time_ms(lambda: ex.t2_interp_stage(plan, gr))
        del w, gr
        torch.cuda.synchronize()
        counts = {n: blocked.LAUNCHES[n] for n in names}
        for n in names:
            launches[n] += counts[n]

        log(f"  Np = {np_:,}: launches {counts}")
        if min(counts.values()) < 1:
            raise AssertionError("a kernel of the main path was not launched")
        check_weights_launches(plan, at_set, counts, 1 + REPS)
        if any(at_set[n] != 1 + REPS or counts[n] != at_set[n] for n in bin_names):
            raise AssertionError(f"{bin_names} must launch once per set_points ({1 + REPS} "
                                 f"calls) and never in an exec: {counts}")
        if tuple(uhat.shape) != plan.spectral_shape or tuple(v2.shape) != (np_,):
            raise AssertionError(f"output shapes {tuple(uhat.shape)}, {tuple(v2.shape)}")
        if uhat.dtype != plan.complex_dtype or v2.dtype != plan.dtype:
            raise AssertionError(f"output dtypes {uhat.dtype}, {v2.dtype}")
        if not (torch.isfinite(torch.view_as_real(uhat)).all()
                and torch.isfinite(v2).all()):
            raise AssertionError("non-finite output")
        log(f"  set_points {t_set:.3f} ms, exec_type1 {t_t1:.3f} ms, "
            f"exec_type2 {t_t2:.3f} ms")
        log("  stages: " + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
        e1 = _err1(pts, vp, uhat, shape, plan.is_real, seed, modes=err_modes)
        e2 = _err2(pts, v2, a, plan.is_real, seed)
        check(f"err1 ({label}, Np={np_})", e1, err_tol)
        check(f"err2 ({label}, Np={np_})", e2, err_tol)
        row = dict(dtype=label, np=np_, set_points_ms=t_set, exec_type1_ms=t_t1,
                   exec_type2_ms=t_t2, stages_ms=stages, err1=e1, err2=e2,
                   launches=counts)
        del uhat, v2
        if np_ == diagnose_at:
            row["p2"] = float32_accumulation_diagnostic(plan, pts, vp, e1, seed)
        if np_ == check_np:
            for kind in ("spread", "interp"):
                row[f"{kind}_vs_plain"] = check_kernel(kind, plan, vp_c, gen)
        rows.append(row)
        if np_ == compare_np:
            log("  kernels against their plain versions at this shape:")
            grid = _random_values(gen, (1,) + plan.shape_over, plan.dtype, dev)
            compared = compare_kernels(plan, vp_c, grid, timed=True)
            del grid
            compare_set_points(f"{label}, Np={np_}", plan0, pts)
        del plan, pts, vp, vp_c
        torch.cuda.empty_cache()
    log("  results " + json.dumps(rows))
    return launches, compared


def check_weights_launches(plan, at_set, counts, set_calls: int) -> None:
    """K3 (a window without coefficients) launched once in each of
    ``set_calls`` set_points calls (``at_set``, the counts just after them)
    and never in the execs after them (``counts``, the counts at the end)."""
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    if blocked.kernel_coefs(plan)[0] is not None:
        return
    name = blocked.WEIGHTS_ENTRY[plan.real_dtype]
    by_exec = counts[name] - at_set[name]
    log(f"  {name}: {at_set[name]} launches in {set_calls} set_points calls, {by_exec} "
        "in the execs")
    if at_set[name] != set_calls or by_exec != 0:
        raise AssertionError(f"{name} must launch once per set_points and never in an exec")


def phase_accuracy_64(seed: int):
    """64-bit kernels against their plain versions and err1 / err2 at
    m = 8, sigma = 2, where the window's own error is ~2e-14, in 3D, 2D and
    1D."""
    import torch

    import nonuniformffts_tpu_torch as nufft

    np_ = NP_ACC
    log(f"== phase 5: 64-bit accuracy, m = 8, sigma = 2, {np_:,} points, "
        f"N = {', '.join('x'.join(map(str, s)) for s in ACC_SHAPES)}")
    dev = torch.device("cuda")
    for shape in ACC_SHAPES:
        for dtype in (np.complex128, np.float64):
            plan = _plan(dtype, shape, 8, 2.0)
            label = f"{len(shape)}D {np.dtype(dtype).name}"
            gen = torch.Generator(device=dev).manual_seed(seed + 5)
            pts = _uniform_points(gen, len(shape), np_, torch.float64, dev)
            plan = nufft.set_points(plan, pts)
            log(f"  {label}: grid {plan.shape_over}, block_dims {plan.block_dims}")
            vp = _random_values(gen, (1, np_), plan.dtype, dev)
            grid = _random_values(gen, (1,) + plan.shape_over, plan.dtype, dev)
            compare_kernels(plan, vp, grid, timed=False, plain_chunk=1 << 13)
            a, u_np = _rank1_spectrum(shape, plan.is_real, seed)
            u_spec = torch.as_tensor(u_np, device=dev).to(plan.complex_dtype)
            uhat = nufft.exec_type1(plan, vp[0])
            v2 = nufft.exec_type2(plan, u_spec)
            check(f"err1 ({label}, m=8)", _err1(pts, vp[0], uhat, shape, plan.is_real, seed),
                  ERR_TOL_64)
            check(f"err2 ({label}, m=8)", _err2(pts, v2, a, plan.is_real, seed), ERR_TOL_64)
            del plan, pts, vp, grid, uhat, v2, u_spec
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 10-12: every window, m = 10, the NFFT adapter
# ---------------------------------------------------------------------------


def window_err_tol(kernel: str, m: int, D: int, dtype) -> float:
    """D times the window's 1D budget at sigma = 2; complex64 at least 1e-5
    at m = 4; at m = 10 64-bit (B)KB 1e-11, 64-bit Gaussian and B-spline
    at least 1e-11, 32-bit plans 5e-5 (tests/test_accuracy.py:109-124)."""
    f32 = np.dtype(dtype) in (np.dtype(np.complex64), np.dtype(np.float32))
    if m == 10:
        if f32:
            return 5e-5
        if kernel in ("KaiserBesselKernel", "BackwardsKaiserBesselKernel"):
            return ERR_TOL_64
        return max(D * error_budget(kernel, m), ERR_TOL_64)
    tol = D * error_budget(kernel, m)
    return max(tol, ERR_TOL) if f32 else tol


def phase_windows(seed: int, record, windows):
    """Phase 10: each window mode through the 3D main path at 256^3, m = 4,
    sigma = 2, complex64 and complex128 (BKB Fast too, as the yardstick at
    the same sigma); then the cost of a window on the 2D (4096^2, 16.8M
    points) and 1D (2^20, 10M points) complex64 main paths at sigma = 2,
    with the 2D spread and interpolation and the 1D spread kernels held
    against their plain versions on each row's points.
    err1 samples 1,024 modes: the budgets bound the whole L2 error
    (tests/test_torch_window_paths.py checks that on the CPU), which 64
    random modes estimate only to about a factor of 2 (a 64-mode 1D
    B-spline row read 4.95e-5 against its 4.8e-5)."""
    log(f"== phase 10: every window, N = {'x'.join(map(str, SHAPE_3D))}, m = 4, "
        f"sigma = {SIGMA_W}, complex64 and complex128; 2D and 1D complex64")
    for dtype in (np.complex64, np.complex128):
        for mode in PHASE10_MODES:
            window = WINDOW_MODES[mode]
            label = f"3D {np.dtype(dtype).name} {mode}"
            launches, compared = main_path(
                label, dtype, SHAPE_3D, NP_MAIN, NP_MAIN[0], seed, m=4, sigma=SIGMA_W,
                window=window, err_tol=window_err_tol(window[0], 4, 3, dtype),
                err_modes=1024)
            record((launches, {}))
            for name, res in compared.items():
                windows[name][f"{mode}, m=4"] = res
    for shape, np_ in ((SHAPE_2D, NP_MAIN[1]), (SHAPE_1D, NP_1D[1])):
        for mode in PHASE10_MODES:
            window = WINDOW_MODES[mode]
            record(main_path(f"{len(shape)}D complex64 {mode}", np.complex64, shape, (np_,),
                             0, seed, m=4, sigma=SIGMA_W, window=window,
                             err_tol=window_err_tol(window[0], 4, len(shape), np.complex64),
                             err_modes=1024, check_np=np_))


def phase_m10(seed: int, record, windows):
    """Phase 11: every dtype, dimension and window mode at m = 10, sigma = 2,
    50,000 points: kernels against their plain versions (timed) and
    err1 / err2 against exact sums, with launch counts."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    log(f"== phase 11: m = 10, sigma = {SIGMA_W}, {NP_M10:,} points, every dtype, "
        "dimension and window mode")
    dev = torch.device("cuda")
    for shape in M10_SHAPES:
        D = len(shape)
        for dtype in (np.complex64, np.complex128, np.float32, np.float64):
            for mode, window in WINDOW_MODES.items():
                label = f"{D}D {np.dtype(dtype).name} {mode}"
                plan = _plan(dtype, shape, 10, SIGMA_W, window)
                gen = torch.Generator(device=dev).manual_seed(seed + 11)
                pts = _uniform_points(gen, D, NP_M10, plan.real_dtype, dev)
                vp = _random_values(gen, (1, NP_M10), plan.dtype, dev)
                grid = _random_values(gen, (1,) + plan.shape_over, plan.dtype, dev)
                names = entry_points(plan)
                blocked.reset_launch_counts()
                plan = nufft.set_points(plan, pts)
                at_set = {n: blocked.LAUNCHES[n] for n in names}
                a, u_np = _rank1_spectrum(shape, plan.is_real, seed)
                uhat = nufft.exec_type1(plan, vp[0])
                v2 = nufft.exec_type2(plan, torch.as_tensor(u_np, device=dev).to(
                    plan.complex_dtype))
                torch.cuda.synchronize()
                counts = {n: blocked.LAUNCHES[n] for n in names}
                if min(counts.values()) < 1:
                    raise AssertionError(f"a kernel was not launched ({label}): {counts}")
                record((counts, {}))
                log(f"  {label}: grid {plan.shape_over}, block_dims {plan.block_dims}, "
                    f"launches {counts}")
                check_weights_launches(plan, at_set, counts, 1)
                # The budgets bound the whole L2 error, which 64 modes
                # estimate only to about a factor of 2 (phase_windows): err1
                # and err2 here sample 4,096 modes and 50,000 points.
                tol = window_err_tol(window[0], 10, D, dtype)
                check(f"err1 ({label})", _err1(pts, vp[0], uhat, shape, plan.is_real, seed,
                                               modes=4096), tol)
                check(f"err2 ({label})", _err2(pts, v2, a, plan.is_real, seed,
                                               points=NP_M10), tol)
                compared = compare_kernels(plan, vp, grid, timed=True, plain_chunk=1 << 12,
                                           plain_reps=1)
                for name, res in compared.items():
                    windows[name][f"{mode}, m=10"] = res
                del plan, pts, vp, grid, uhat, v2
                torch.cuda.empty_cache()


def _nfft_factor_sums(x, coefs, sign: float):
    """``sum_k coefs[k] exp(sign 2 pi i k x)`` over k = -N/2 .. N/2 - 1 (the
    adapter's increasing order) for each x, float64 on the card."""
    import torch

    N = len(coefs)
    k = torch.arange(-(N // 2), N - N // 2, dtype=torch.float64, device=x.device)
    c = torch.as_tensor(coefs, device=x.device)
    return torch.exp(sign * 2j * math.pi * torch.outer(x, k)) @ c


def phase_nfft(seed: int, record):
    """Phase 12: the NFFT adapter at 256^3, 16.8M points, complex128, the
    default reltol, three windows: forward and adjoint times (CUDA events,
    median of 5) and errors against exact NFFT-convention sums."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    N = SHAPE_3D
    log(f"== phase 12: NFFT adapter, N = {'x'.join(map(str, N))}, {NP_NFFT:,} points, "
        f"complex128, reltol {NFFT_RELTOL:g}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    x = torch.rand((3, NP_NFFT), generator=gen, dtype=torch.float64, device=dev) - 0.5
    f = _random_values(gen, (NP_NFFT,), torch.complex128, dev)
    rng = np.random.default_rng(seed + 13)
    a = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)) / n for n in N]
    fhat = torch.as_tensor(functools.reduce(np.multiply.outer, a), device=dev)
    sel = torch.as_tensor(rng.integers(0, NP_NFFT, ERR_POINTS), device=dev)
    kidx = rng.integers(0, N[0], (ERR_MODES, 3))
    kval = torch.as_tensor(kidx - N[0] // 2, dtype=torch.float64, device=dev)
    exact_adj = torch.zeros(ERR_MODES, dtype=torch.complex128, device=dev)
    for s in range(0, NP_NFFT, 1 << 20):
        ph = kval @ x[:, s : s + (1 << 20)]
        exact_adj += torch.exp(2j * math.pi * ph) @ f[s : s + (1 << 20)]
    exact_fwd = functools.reduce(
        torch.mul, (_nfft_factor_sums(x[d, sel], a[d], -1.0) for d in range(3)))
    rows = []
    for window in ("kaiser_bessel", "gauss", "spline"):
        blocked.reset_launch_counts()
        t0 = time.perf_counter()
        plan = nufft.plan_nfft(x, N, reltol=NFFT_RELTOL, window=window)
        torch.cuda.synchronize()
        t_plan = 1e3 * (time.perf_counter() - t0)
        at_set = {n: blocked.LAUNCHES[n] for n in entry_points(plan.plan)}
        if (plan.plan.m, plan.plan.sigma) != (6, 2.0):
            raise AssertionError(f"reltol {NFFT_RELTOL:g} gave m={plan.plan.m}, "
                                 f"sigma={plan.plan.sigma}, not 6, 2")
        t_fwd, fx = cuda_time_ms(lambda: plan.forward(fhat))
        t_adj, fh = cuda_time_ms(lambda: plan.H @ f)
        torch.cuda.synchronize()
        names = entry_points(plan.plan)
        counts = {n: blocked.LAUNCHES[n] for n in names}
        if min(counts.values()) < 1:
            raise AssertionError(f"a kernel was not launched ({window}): {counts}")
        check_weights_launches(plan.plan, at_set, counts, 1)
        record((counts, {}))
        e_fwd = rel_l2(fx[sel], exact_fwd)
        e_adj = rel_l2(fh[tuple(torch.as_tensor(kidx[:, d], device=dev) for d in range(3))],
                       exact_adj)
        # The forward transform's interpolation kernel against its plain version.
        g = _random_values(gen, (1,) + tuple(plan.plan.shape_over), torch.complex128, dev)
        e_interp = rel_l2(blocked.interpolate_blocked(plan.plan, g),
                          blocked.interpolate_blocked_plain(
                              dataclasses.replace(plan.plan, chunk_size=PLAIN_CHUNK), g))
        del g
        check(f"{blocked.entry_point('interp', plan.plan)} vs plain ({window})", e_interp,
              KERNEL_TOL[8])
        kind = type(plan.plan.kernel).__name__
        tol = 10 * NFFT_RELTOL if window == "kaiser_bessel" else 3 * error_budget(kind, 6)
        log(f"  {window} ({kind}): grid {plan.plan.shape_over}, block_dims "
            f"{plan.plan.block_dims}, plan_nfft {t_plan:.1f} ms (host clock, set_points "
            f"included), forward {t_fwd:.3f} ms, adjoint {t_adj:.3f} ms, launches {counts}")
        check(f"forward error ({window})", e_fwd, tol)
        check(f"adjoint error ({window})", e_adj, tol)
        rows.append(dict(window=window, m=plan.plan.m, sigma=plan.plan.sigma,
                         block_dims=plan.plan.block_dims,
                         plan_ms=t_plan, forward_ms=t_fwd, adjoint_ms=t_adj,
                         forward_err=e_fwd, adjoint_err=e_adj, interp_vs_plain=e_interp,
                         launches=counts))
        del plan, fx, fh
        torch.cuda.empty_cache()
    log("  results " + json.dumps(rows))


# ---------------------------------------------------------------------------
# Phase 13: the multi-device modes on torch.distributed, K8a / K8b
# ---------------------------------------------------------------------------


def _relayout_cases(dtype, shape, n: int):
    """The relayouts of the spatial run at ``shape`` over ``n`` ranks, one
    channel: (entry point, label, input, block dims).  K8b packs the type-1
    slab (1, N0l, K1p, K2) rank-major and, for block form's sharded
    spectrum, the type-2 dim-0 shard (1, K0l, K1p, K2); K8a unpacks the
    type-2 all_to_all (n, N0l, K1l, K2), the type-1 all_gather (n, K0, K1l,
    K2) and block form's type-1 dim-0 unshard (n, K0l, K1l, K2)."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import relayout

    plan = _plan(dtype, shape, 4, 1.5)
    n0l, k1l, k0l = plan.shape_over[0] // n, -(-shape[1] // n), shape[0] // n
    tail = tuple(shape[2:])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    blocks, grid = relayout.entry_point("blocks", plan.dtype), relayout.entry_point("grid", plan.dtype)

    def rand(*dims):
        return _random_values(gen, dims, plan.dtype, dev)

    return [
        (blocks, "type-1 pack", rand(1, n0l, n * k1l, *tail), (n0l, k1l) + tail),
        (grid, "type-2 unpack", rand(1, 1, n, 1, n0l, k1l, *tail), (n0l, k1l) + tail),
        (grid, "type-1 gather unpack", rand(1, 1, n, 1, shape[0], k1l, *tail),
         (shape[0], k1l) + tail),
        (grid, "type-1 dim-0 unshard", rand(1, 1, n, 1, k0l, k1l, *tail), (k0l, k1l) + tail),
        (blocks, "type-2 dim-0 pack", rand(1, k0l, n * k1l, *tail), (k0l, k1l) + tail),
    ]


#: Ragged relayouts (grid shape with CR, block dims) that reach the register
#: path (runs shorter than 4 KB or not whole 16-byte vectors; B2 = 1 is the
#: element path in complex64) and a TMA path whose runs end in a partial
#: chunk; checked against the plain versions, not timed.
RAGGED_RELAYOUTS = (((3, 12, 10, 6), (4, 5, 3)), ((2, 12, 9), (4, 3)), ((2, 6, 5, 4), (3, 5, 1)),
                    ((1, 96, 64), (96, 16)), ((1, 8, 40, 300), (4, 10, 300)))
RELAYOUT_LAUNCHES = 50


def _back_to_back_ms(fn, inputs, count: int = RELAYOUT_LAUNCHES) -> float:
    """ms per call of ``count`` calls of ``fn`` back to back between two
    events, cycling over ``inputs`` (more bytes than the 50 MB L2)."""
    import torch

    fn(inputs[0])
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(count):
        fn(inputs[i % len(inputs)])
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / count


def check_ragged_relayouts(dtype) -> None:
    """K8a / K8b equal to their plain versions, bit for bit, on
    ``RAGGED_RELAYOUTS`` and on an input that is only 8-byte aligned."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import relayout

    gen = torch.Generator(device="cuda").manual_seed(17)
    cdtype = torch.complex64 if np.dtype(dtype) == np.complex64 else torch.complex128
    cases = [(torch.randn(g, generator=gen, device="cuda", dtype=cdtype), bd)
             for g, bd in RAGGED_RELAYOUTS]
    if cdtype == torch.complex64:
        cases.append((torch.randn(1 + 2 * 8 * 64, generator=gen, device="cuda",
                                  dtype=cdtype)[1:].view(2, 8, 64), (4, 16)))
    for g, bd in cases:
        b = relayout.relayout_to_blocks(g, bd)
        back = relayout.relayout_to_grid(b, bd)
        torch.cuda.synchronize()
        if not (torch.equal(b, relayout.relayout_to_blocks_plain(g, bd))
                and torch.equal(back, g)):
            raise AssertionError(f"K8 differs from its plain version at {tuple(g.shape)} / {bd}")
        geom = relayout.run_geometry(tuple(g.shape), bd)
        log(f"  ragged {cdtype} {tuple(g.shape)} / {bd}: runs {geom.runs} x {geom.run_len}, "
            f"data_ptr % 16 = {g.data_ptr() % 16}: equal to plain")


def compare_relayouts(dtype, shape, n: int, reps: int = 20):
    """K8a / K8b at the spatial run's relayout shapes against their plain
    versions (exact equality) and against one PyTorch call computing the
    same function (``reshape``, ``permute``, ``contiguous``).  Each is timed
    as ``RELAYOUT_LAUNCHES`` calls back to back over three input buffers
    (ms per call: ``ms`` for the kernel, ``plain_ms``, ``library_ms``), in
    turns (plain, kernel, kernel, plain; the library call between), and the
    kernel also as one wrapper call between two events (``call_ms``, median
    of ``reps``).  The headline of each entry point is its first shape."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import relayout

    check_ragged_relayouts(dtype)
    results = {}
    for name, label, x, bd in _relayout_cases(dtype, shape, n):
        D = len(bd)
        xs = [x, x.clone(), x.clone()]
        if "blocks" in name:
            nb = tuple(g // b for g, b in zip(x.shape[1:], bd))
            split = (x.shape[0],) + tuple(v for p in zip(nb, bd) for v in p)
            perm = (0,) + tuple(1 + 2 * d for d in range(D)) + tuple(2 + 2 * d for d in range(D))
            kern = lambda t: relayout.relayout_to_blocks(t, bd)
            plain = lambda t: relayout.relayout_to_blocks_plain(t, bd)
            library = lambda t: t.reshape(split).permute(perm).contiguous()
        else:
            grid = (x.shape[0],) + tuple(b * k for b, k in zip(x.shape[1 : 1 + D], bd))
            perm = (0,) + tuple(v for d in range(D) for v in (1 + d, 1 + D + d))
            kern = lambda t: relayout.relayout_to_grid(t, bd)
            plain = lambda t: relayout.relayout_to_grid_plain(t, bd)
            library = lambda t: t.permute(perm).reshape(grid)
        p1 = _back_to_back_ms(plain, xs)
        k1 = _back_to_back_ms(kern, xs)
        l1 = _back_to_back_ms(library, xs)
        k2 = _back_to_back_ms(kern, xs)
        p2 = _back_to_back_ms(plain, xs)
        call, got = cuda_time_ms(lambda: kern(x), reps=reps)
        want, lib = plain(x), library(x)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(lib, want)):
            raise AssertionError(f"{name} ({label}) differs from its plain version")
        nbytes = 2 * x.numel() * x.element_size()
        geom = relayout.run_geometry(tuple(want.shape if "grid" in name else x.shape), bd)
        res = dict(max_abs_err=0.0, rel_l2=0.0, ms=(k1 + k2) / 2, call_ms=call,
                   plain_ms=(p1 + p2) / 2, library_ms=l1,
                   bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
                   shape=list(x.shape), block_dims=list(bd), runs=[geom.runs, geom.run_len])
        log(f"  {name} {label} {tuple(x.shape)} / {bd}, runs {geom.runs} x {geom.run_len}: "
            f"equal to plain; kernel {k1:.4f} / {k2:.4f} ms, one call {call:.4f} ms, plain "
            f"{p1:.4f} / {p2:.4f} ms, library {l1:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({nbytes / 1e6:.1f} MB)")
        results.setdefault(name, dict(res, shapes={}))["shapes"][label] = res
        del got, want, lib, xs
    return results


def _launch_counts():
    from nonuniformffts_tpu_torch.ops.kernels import blocked, relayout

    return {**blocked.LAUNCHES, **relayout.LAUNCHES}


def _reset_launch_counts():
    from nonuniformffts_tpu_torch.ops.kernels import blocked, relayout

    blocked.reset_launch_counts()
    relayout.reset_launch_counts()


def _global_inputs(dtype, np_total: int, seed: int):
    """The run's points and values, made alike on every rank."""
    import torch

    dev = torch.device("cuda")
    real = torch.float32 if np.dtype(dtype) == np.complex64 else torch.float64
    gen = torch.Generator(device=dev).manual_seed(seed + 130)
    pts = _uniform_points(gen, 3, np_total, real, dev)
    vp = _random_values(gen, (np_total,), torch.complex64 if real == torch.float32
                        else torch.complex128, dev)
    return pts, vp


def _timed_collectives(fn):
    """One more call of ``fn`` with the collective timer on: (host ms of the
    call, ms in collectives)."""
    import torch

    from nonuniformffts_tpu_torch.parallel import comm

    comm.TIMER = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    total = 1e3 * (time.perf_counter() - t0)
    spent = 1e3 * sum(comm.TIMER.values())
    comm.TIMER = None
    return total, spent


def spatial_row(label: str, dtype, group, shape, np_total: int, seed: int,
                reps: int = SPATIAL_REPS, spectrum: str = "replicated"):
    """``SpatialNUFFT`` at ``shape`` over ``group``: set_points -> exec_type1 ->
    exec_type2 on this rank's share of ``np_total`` uniform points, timed
    (CUDA-event medians), with launch counts, the collectives' share,
    err1 / err2 against exact sums and agreement with the single-card plan
    on the same points.  With ``spectrum='sharded'`` (block form: this
    rank's rows of spectral dim 0) type 1 is held against the single card's
    rows and type 2 takes this rank's rows of the spectrum; err1 samples
    modes of those rows.  Raises if a check fails."""
    import torch
    import torch.distributed as dist

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch.ops.kernels import blocked
    from nonuniformffts_tpu_torch.parallel import SpatialNUFFT, comm

    dev = torch.device("cuda")
    n, me = dist.get_world_size(group), dist.get_rank(group)
    npl = np_total // n
    pts, vp = _global_inputs(dtype, np_total, seed)
    sl = slice(me * npl, (me + 1) * npl)
    v_ch = ex.to_channels(vp[sl][None], 1)
    a, u_np = _rank1_spectrum(shape, False, seed)
    u_spec = torch.as_tensor(u_np, device=dev).to(vp.dtype)
    sp = SpatialNUFFT(dtype, shape, group=group, m=4, sigma=1.5, capacity_factor=SPATIAL_CAPACITY,
                      kernel=nufft.BackwardsKaiserBesselKernel(),
                      kernel_evalmode=nufft.FastApproximation(), device=dev, spectrum=spectrum)
    rows = slice(None)
    if spectrum == "sharded":
        rows = slice(me * sp.k0_local, (me + 1) * sp.k0_local)
        assert sp.spectrum_shard_dim == 0, sp.engine
    u_ch = ex.to_channels(u_spec[None, rows], 1)
    torch.cuda.synchronize()
    _reset_launch_counts()
    t_set, st = cuda_time_ms(lambda: sp.set_points(pts[:, sl]), reps=reps)
    t_t1, u = cuda_time_ms(lambda: sp.exec_type1(st, v_ch), reps=reps)
    t_t2, v2 = cuda_time_ms(lambda: sp.exec_type2(st, u_ch), reps=reps)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _launch_counts().items() if v}
    names = entry_points(st.local) + [
        f"nufft_relayout_to_{d}_{'f32' if vp.dtype == torch.complex64 else 'f64'}"
        for d in ("grid", "blocks")]
    if min(counts.get(k, 0) for k in names) < 1:
        raise AssertionError(f"{label}: a kernel of the spatial path was not launched: {counts}")
    share = {k: _timed_collectives(fn) for k, fn in (
        ("set_points", lambda: sp.set_points(pts[:, sl])),
        ("exec_type1", lambda: sp.exec_type1(st, v_ch)),
        ("exec_type2", lambda: sp.exec_type2(st, u_ch)))}
    uc = ex.from_channels(u, 1)[0]
    v2c = ex.from_channels(v2, 1)[0]
    if not (torch.isfinite(torch.view_as_real(uc)).all() and torch.isfinite(v2c).all()):
        raise AssertionError(f"{label}: non-finite output")
    e1 = _err1(pts, vp, uc, shape, False, seed,
               rows=None if spectrum == "replicated" else (rows.start, rows.stop))
    e2 = _err2(pts[:, sl], v2c, a, False, seed)
    # The slab plan's interpolation kernel against its plain version.
    gen = torch.Generator(device=dev).manual_seed(seed + me)
    g_slab = _random_values(gen, (1,) + tuple(st.local.shape_over), vp.dtype, dev)
    slab_interp = rel_l2(blocked.interpolate_blocked(st.local, g_slab),
                         blocked.interpolate_blocked_plain(
                             dataclasses.replace(st.local, chunk_size=PLAIN_CHUNK), g_slab))
    slab_block_dims, cap = list(st.local.block_dims), st.cap
    del st, g_slab
    torch.cuda.empty_cache()
    plan = nufft.set_points(_plan(dtype, shape, 4, 1.5), pts)
    agree1 = rel_l2(uc, nufft.exec_type1(plan, vp)[rows])
    agree2 = rel_l2(v2c, nufft.exec_type2(plan, u_spec)[sl])
    del plan
    torch.cuda.empty_cache()
    tol = SPATIAL_AGREE[np.dtype(dtype).itemsize]
    for what, value, limit in (("err1", e1, ERR_TOL), ("err2", e2, ERR_TOL),
                               ("type-1 vs single card", agree1, tol),
                               ("type-2 vs single card", agree2, tol),
                               ("slab interpolation kernel vs plain", slab_interp,
                                KERNEL_TOL[np.dtype(dtype).itemsize // 2])):
        if not value <= limit:
            raise AssertionError(f"{label} rank {me}: {what} = {value:.3e} exceeds {limit:.0e}")
    return dict(label=label, n=n, rank=me, np_rank=npl, backend=comm.backend(group),
                engine=sp.engine, spectrum=spectrum, uhat_shape=list(uc.shape),
                set_points_ms=t_set, exec_type1_ms=t_t1, exec_type2_ms=t_t2,
                host_and_collective_ms=share, err1=e1, err2=e2, vs_single=[agree1, agree2],
                slab_interp_vs_plain=slab_interp,
                launches=counts, staged=list(comm.staged_ops(group)),
                host_staged=dict(comm.HOST_STAGED), ext_shape=list(sp.ext_shape_over),
                block_dims=slab_block_dims, cap=cap)


def sharded_row(label: str, dtype, group, shape, np_total: int, seed: int,
                reps: int = SPATIAL_REPS):
    """``exec_type{1,2}_sharded`` at ``shape`` with this rank's share of
    ``np_total`` points (a local set_points inside each call), as
    ``spatial_row``."""
    import torch
    import torch.distributed as dist

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch.ops.kernels import blocked
    from nonuniformffts_tpu_torch.parallel import comm, exec_type1_sharded, exec_type2_sharded
    from nonuniformffts_tpu_torch.parallel import shard_points

    dev = torch.device("cuda")
    n, me = dist.get_world_size(group), dist.get_rank(group)
    pts, vp = _global_inputs(dtype, np_total, seed)
    pts_l, v_l = shard_points(pts, ex.to_channels(vp[None], 1), group=group, device=dev)
    sl = slice(me * (np_total // n), (me + 1) * (np_total // n))
    a, u_np = _rank1_spectrum(shape, False, seed)
    u_spec = torch.as_tensor(u_np, device=dev).to(vp.dtype)
    u_ch = ex.to_channels(u_spec[None], 1)
    plan = _plan(dtype, shape, 4, 1.5)
    torch.cuda.synchronize()
    _reset_launch_counts()
    t_t1, u = cuda_time_ms(lambda: exec_type1_sharded(plan, pts_l, v_l, group=group), reps=reps)
    t_t2, v2 = cuda_time_ms(lambda: exec_type2_sharded(plan, pts_l, u_ch, group=group),
                            reps=reps)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _launch_counts().items() if v}
    if min(counts.get(k, 0) for k in entry_points(plan)) < 1:
        raise AssertionError(f"{label}: a kernel of the point-sharded path was not launched")
    share = {k: _timed_collectives(fn) for k, fn in (
        ("exec_type1", lambda: exec_type1_sharded(plan, pts_l, v_l, group=group)),
        ("exec_type2", lambda: exec_type2_sharded(plan, pts_l, u_ch, group=group)))}
    uc = ex.from_channels(u, 1)[0]
    v2c = ex.from_channels(v2, 1)[0]
    e1 = _err1(pts, vp, uc, shape, False, seed)
    e2 = _err2(pts_l, v2c, a, False, seed)
    # The rank's interpolation kernel against its plain version on its points.
    local = nufft.set_points(plan, pts_l)
    gen = torch.Generator(device=dev).manual_seed(seed + me)
    g_loc = _random_values(gen, (1,) + tuple(local.shape_over), vp.dtype, dev)
    slab_interp = rel_l2(blocked.interpolate_blocked(local, g_loc),
                         blocked.interpolate_blocked_plain(
                             dataclasses.replace(local, chunk_size=PLAIN_CHUNK), g_loc))
    del local, g_loc
    single = nufft.set_points(plan, pts)
    agree1 = rel_l2(uc, nufft.exec_type1(single, vp))
    agree2 = rel_l2(v2c, nufft.exec_type2(single, u_spec)[sl])
    del single
    torch.cuda.empty_cache()
    tol = SPATIAL_AGREE[np.dtype(dtype).itemsize]
    for what, value, limit in (("err1", e1, ERR_TOL), ("err2", e2, ERR_TOL),
                               ("type-1 vs single card", agree1, tol),
                               ("type-2 vs single card", agree2, tol),
                               ("interpolation kernel vs plain", slab_interp,
                                KERNEL_TOL[np.dtype(dtype).itemsize // 2])):
        if not value <= limit:
            raise AssertionError(f"{label} rank {me}: {what} = {value:.3e} exceeds {limit:.0e}")
    return dict(label=label, n=n, rank=me, exec_type1_ms=t_t1, exec_type2_ms=t_t2,
                host_and_collective_ms=share, err1=e1, err2=e2, vs_single=[agree1, agree2],
                interp_vs_plain=slab_interp,
                launches=counts)


def _spatial_rank(rank: int, n: int, rdv: str, out_dir: str, shape, np_total: int, seed: int):
    """One gloo rank of phase 13 on cuda:0: the spatial rows at n = 4
    (complex64, complex128, complex64 sharded) and n = 2 (ranks 0 and 1,
    complex64), then the point-sharded row at n = 4.  Writes its rows to
    ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=600))
    rows = []
    for dtype in (np.complex64, np.complex128):
        rows.append(spatial_row(f"spatial n=4 {np.dtype(dtype).name}", dtype, None, shape,
                                np_total, seed))
        dist.barrier()
    rows.append(spatial_row("spatial n=4 complex64 sharded", np.complex64, None, shape, np_total,
                            seed, spectrum="sharded"))
    dist.barrier()
    pair = dist.new_group([0, 1])
    if rank < 2:
        rows.append(spatial_row("spatial n=2 complex64", np.complex64, pair, shape, np_total,
                                seed))
    dist.barrier()
    rows.append(sharded_row("point-sharded n=4 complex64", np.complex64, None, shape, np_total,
                            seed))
    dist.barrier()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rows))
    dist.destroy_process_group()


def _log_rows(rows):
    by_label = collections.defaultdict(list)
    for r in rows:
        by_label[r["label"]].append(r)
    for label, rs in by_label.items():
        mx = {k: max(r[k] for r in rs) for k in ("set_points_ms", "exec_type1_ms",
                                                 "exec_type2_ms", "err1", "err2") if k in rs[0]}
        agree = [max(r["vs_single"][i] for r in rs) for i in (0, 1)]
        log(f"  {label} ({rs[0].get('backend', 'gloo')}, max over {len(rs)} ranks): "
            + ", ".join(f"{k} {v:.4g}" for k, v in mx.items())
            + f", vs single card {agree[0]:.3e} / {agree[1]:.3e}")
        for r in rs:
            share = ", ".join(f"{k} {t:.1f} ms host, {c:.1f} ms in collectives"
                              for k, (t, c) in r["host_and_collective_ms"].items())
            log(f"    rank {r['rank']}: {share}; launches {r['launches']}"
                + (f"; staged through the host: {r['staged']} {r['host_staged']}"
                   if "staged" in r else ""))


def phase_parallel(seed: int, record, compared):
    """Phase 13: K8a / K8b against their plain versions at ragged shapes and
    the spatial run's relayout shapes; then the two multi-device modes with
    four gloo ranks sharing the one card (spatial n = 4 complex64,
    complex128 and complex64 sharded, n = 2 complex64, point-sharded
    n = 4), and the spatial mode on an NCCL group of one rank in this
    process, replicated and sharded."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    log(f"== phase 13: multi-device modes, N = {'x'.join(map(str, SHAPE_3D))}, "
        f"{NP_SPATIAL:,} points, m = 4, sigma = 1.5; K8a / K8b")
    for dtype in (np.complex64, np.complex128):
        for name, res in compare_relayouts(dtype, SHAPE_3D, SPATIAL_RANKS).items():
            compared[name] = res
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(_spatial_rank, args=(SPATIAL_RANKS, f"{tmp}/rendezvous", tmp, SHAPE_3D,
                                                NP_SPATIAL, seed),
                           nprocs=SPATIAL_RANKS, start_method="spawn")
        log(f"  {SPATIAL_RANKS} gloo ranks on cuda:0 (one card shared; gloo's host transport) "
            f"finished in {time.perf_counter() - t0:.1f} s")
        rows = [r for k in range(SPATIAL_RANKS)
                for r in json.loads(Path(tmp, f"rank{k}.json").read_text())]
    with nccl_group_of_one():
        rows.append(spatial_row("spatial n=1 complex64", np.complex64, None, SHAPE_3D,
                                NP_SPATIAL, seed))
        rows.append(spatial_row("spatial n=1 complex64 sharded", np.complex64, None,
                                SHAPE_3D, NP_SPATIAL, seed, spectrum="sharded"))
    _log_rows(rows)
    for r in rows:
        record((r["launches"], {}))
    log("  results " + json.dumps(rows))


# ---------------------------------------------------------------------------
# Phase 14: the timer, callbacks, the direct NUDFT and chunked plans
# ---------------------------------------------------------------------------

T1_LABELS = ("(0) nonuniform callback", "(1) spreading", "(2) forward FFT",
             "(3) deconvolve + truncate")
T2_LABELS = ("(1) deconvolve + pad", "(2) backward FFT", "(3) interpolation",
             "(4) nonuniform callback")


def _check_path_launches(plan, row: str, at_least: int = 1):
    """The spread and interpolation kernels of ``plan`` each launched at
    least ``at_least`` times since the counts were reset; returns the counts."""
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    counts = {n: blocked.LAUNCHES[n] for n in entry_points(plan)}
    log(f"  {row}: launches {counts}")
    for kind in ("spread", "interp"):
        name = blocked.entry_point(kind, plan)
        if counts[name] < at_least:
            raise AssertionError(f"{row}: {name} launched {counts[name]} times, "
                                 f"fewer than {at_least}")
    return counts


def _timer_and_callbacks(plan, vp, u, tol: float):
    """The main path with ``Timer(synchronise=True)``: every label of both
    transforms (callbacks on), the stage sums against the whole call;
    then both callbacks (a per-point weight, a Gaussian filter in |k|)
    against the same operations applied by hand, and the times with and
    without them."""
    import torch

    import nonuniformffts_tpu_torch as nufft

    np_ = plan.num_points
    gen = torch.Generator(device=vp.device).manual_seed(np_ + 14)
    w = torch.rand(np_, generator=gen, device=vp.device, dtype=plan.real_dtype) + 0.5
    k2 = sum(k.view([-1 if e == d else 1 for e in range(plan.ndim)]) ** 2
             for d, k in enumerate(plan.kvec))
    filt = torch.exp(-k2 / (2.0 * (plan.shape[0] / 8) ** 2)).to(plan.real_dtype)
    cb = nufft.NUFFTCallbacks(
        nonuniform=lambda vs, n: tuple(x * w[n] for x in vs),
        uniform=lambda ws, idx: tuple(x * filt[idx] for x in ws),
    )
    timer = nufft.Timer(synchronise=True)
    tplan = dataclasses.replace(plan, timer=timer)
    nufft.exec_type2(tplan, nufft.exec_type1(tplan, vp, cb), cb)
    timer.reset()
    for _ in range(REPS):
        nufft.exec_type1(tplan, vp, cb)
        nufft.exec_type2(tplan, u, cb)
    log("  " + repr(timer).replace("\n", "\n  "))
    gaps = {}
    for top, labels in (("exec_type1", T1_LABELS), ("exec_type2", T2_LABELS)):
        missing = [lb for lb in labels if f"{top}/{lb}" not in timer.times]
        if missing:
            raise AssertionError(f"timer labels missing under {top}: {missing}")
        inner = sum(timer.times[f"{top}/{lb}"] for lb in labels)
        gaps[top] = (timer.times[top] - inner) * 1e3 / timer.counts[top]
        check(f"{top}: whole call minus stage sums, ms a call", gaps[top], STAGE_GAP_MS)
    t_cb1, u_cb = cuda_time_ms(lambda: nufft.exec_type1(plan, vp, cb))
    t_1, u_pl = cuda_time_ms(lambda: nufft.exec_type1(plan, vp))
    e_cb1 = rel_l2(u_cb, nufft.exec_type1(plan, vp * w) * filt)
    t_cb2, v_cb = cuda_time_ms(lambda: nufft.exec_type2(plan, u, cb))
    t_2, _ = cuda_time_ms(lambda: nufft.exec_type2(plan, u))
    e_cb2 = rel_l2(v_cb, nufft.exec_type2(plan, u * filt) * w)
    log(f"  exec_type1 {t_1:.3f} ms, with callbacks {t_cb1:.3f} ms; exec_type2 {t_2:.3f} ms, "
        f"with callbacks {t_cb2:.3f} ms")
    check("type 1 callbacks fused vs by hand", e_cb1, tol)
    check("type 2 callbacks fused vs by hand", e_cb2, tol)
    del u_cb, u_pl, v_cb
    return dict(stage_gap_ms=gaps, timer_ms={k: v * 1e3 / timer.counts[k]
                                             for k, v in timer.times.items()},
                exec_type1_ms=t_1, exec_type1_callbacks_ms=t_cb1, exec_type2_ms=t_2,
                exec_type2_callbacks_ms=t_cb2, callbacks_err=[e_cb1, e_cb2])


def _set_points_peak_and_time(fn, reps: int):
    """The device memory ``fn`` (a set_points call) holds at its peak above
    what was allocated before it, from its first call; then its time, a
    median of ``reps`` more calls (each made while the last one's plan is
    still held); returns (peak bytes, ms, plan)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    ms, plan = cuda_time_ms(fn, reps=reps, warmup=0)
    return peak, ms, plan


def _chunked_row(label, dtype, shape, pts, vp, u, a, nchunks: int, seed: int, plan=None,
                 reps: int = 3):
    """``ChunkedPlanNUFFT`` on the blocked path: set_points_chunked /
    exec_type1 / exec_type2 times, launch counts, err1 / err2 against exact
    sums; against ``plan`` (the unchunked plan on the same points) when
    given."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    kernel, evalmode = MAIN_WINDOW
    cplan0 = nufft.ChunkedPlanNUFFT(
        dtype, shape, nchunks=nchunks, m=4, sigma=1.5, kernel=getattr(nufft, kernel)(),
        kernel_evalmode=getattr(nufft, evalmode)(), spread_method="blocked",
        device=torch.device("cuda"))
    blocked.reset_launch_counts()
    peak, t_set, cplan = _set_points_peak_and_time(
        lambda: nufft.set_points_chunked(cplan0, pts), reps)
    t1, uc = cuda_time_ms(lambda: nufft.exec_type1_chunked(cplan, vp), reps=reps)
    t2, v2 = cuda_time_ms(lambda: nufft.exec_type2_chunked(cplan, u), reps=reps)
    torch.cuda.synchronize()
    counts = _check_path_launches(cplan.base, f"{label} chunked", nchunks * (1 + reps))
    row = dict(row=label, nchunks=nchunks, np=pts.shape[1], set_points_chunked_ms=t_set,
               exec_type1_ms=t1, exec_type2_ms=t2, set_points_peak_bytes=peak,
               launches=counts)
    log(f"  {label}, {nchunks} chunks: set_points_chunked {t_set:.3f} ms (peak "
        f"{peak / 2**30:.2f} GiB above the inputs), exec_type1 {t1:.3f} ms, "
        f"exec_type2 {t2:.3f} ms")
    if plan is not None:
        tol = CHUNK_TOL[torch.finfo(plan.real_dtype).bits // 8]
        row["vs_unchunked"] = [rel_l2(uc, nufft.exec_type1(plan, vp)),
                               rel_l2(v2, nufft.exec_type2(plan, u))]
        check(f"{label} chunked type 1 vs unchunked", row["vs_unchunked"][0], tol)
        check(f"{label} chunked type 2 vs unchunked", row["vs_unchunked"][1], tol)
    row["err1"] = _err1(pts, vp, uc, shape, False, seed)
    row["err2"] = _err2(pts, v2, a, False, seed)
    check(f"err1 ({label} chunked)", row["err1"], ERR_TOL)
    check(f"err2 ({label} chunked)", row["err2"], ERR_TOL)
    del cplan, uc, v2
    torch.cuda.empty_cache()
    return row


def _direct_rows(seed: int):
    """The direct NUDFT against exact float64 sums beside the blocked path's
    times, complex64 and complex128; one complex64 call with the caller's
    TF32 switched on."""
    import torch

    import nonuniformffts_tpu_torch as nufft

    dev = torch.device("cuda")
    rows = []
    for shape, nps in DIRECT_ROWS:
        for dtype in (np.complex64, np.complex128):
            dplan0 = nufft.PlanNUFFT(dtype, shape, spread_method="direct", device=dev)
            bplan0 = _plan(dtype, shape, 4, 1.5)
            tol = DIRECT_TOL[torch.finfo(dplan0.real_dtype).bits // 8]
            a, u_np = _rank1_spectrum(shape, False, seed)
            u = torch.as_tensor(u_np, device=dev).to(dplan0.complex_dtype)
            label = f"{len(shape)}D {np.dtype(dtype).name}"
            for np_ in nps:
                gen = torch.Generator(device=dev).manual_seed(seed + np_)
                pts = _uniform_points(gen, len(shape), np_, dplan0.real_dtype, dev)
                vp = _random_values(gen, (np_,), dplan0.dtype, dev)
                dplan, bplan = nufft.set_points(dplan0, pts), nufft.set_points(bplan0, pts)
                t_d1, u1 = cuda_time_ms(lambda: nufft.exec_type1(dplan, vp), reps=3)
                t_d2, v2 = cuda_time_ms(lambda: nufft.exec_type2(dplan, u), reps=3)
                t_b1, _ = cuda_time_ms(lambda: nufft.exec_type1(bplan, vp), reps=3)
                t_b2, _ = cuda_time_ms(lambda: nufft.exec_type2(bplan, u), reps=3)
                e1 = _err1(pts, vp, u1, shape, False, seed)
                e2 = _err2(pts, v2, a, False, seed)
                log(f"  direct {label}, Np = {np_:,}: exec_type1 {t_d1:.3f} ms (blocked "
                    f"{t_b1:.3f}), exec_type2 {t_d2:.3f} ms (blocked {t_b2:.3f})")
                check(f"err1 (direct {label}, Np={np_})", e1, tol)
                check(f"err2 (direct {label}, Np={np_})", e2, tol)
                row = dict(row=f"direct {label}", np=np_, exec_type1_ms=t_d1,
                           exec_type2_ms=t_d2, blocked_exec_type1_ms=t_b1,
                           blocked_exec_type2_ms=t_b2, err1=e1, err2=e2)
                if dtype == np.complex64 and np_ == nps[0]:
                    flags = (torch.backends.cuda.matmul.allow_tf32,
                             torch.get_float32_matmul_precision())
                    try:
                        torch.backends.cuda.matmul.allow_tf32 = True
                        torch.set_float32_matmul_precision("high")
                        e1 = _err1(pts, vp, nufft.exec_type1(dplan, vp), shape, False, seed)
                        e2 = _err2(pts, nufft.exec_type2(dplan, u), a, False, seed)
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = flags[0]
                        torch.set_float32_matmul_precision(flags[1])
                    check(f"err1 (direct {label}, caller's TF32 on)", e1, tol)
                    check(f"err2 (direct {label}, caller's TF32 on)", e2, tol)
                    row["tf32_on_err"] = [e1, e2]
                rows.append(row)
                del dplan, bplan, pts, vp, u1, v2
                torch.cuda.empty_cache()
    return rows


def phase_plan_surface(seed: int, record):
    """Phase 14 (see the module docstring)."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    dev = torch.device("cuda")
    rows = []
    for dtype in (np.complex64, np.complex128):
        label = f"3D {np.dtype(dtype).name}"
        plan0 = _plan(dtype, SHAPE_3D, 4, 1.5)
        nbytes = torch.finfo(plan0.real_dtype).bits // 8
        a, u_np = _rank1_spectrum(SHAPE_3D, False, seed)
        u = torch.as_tensor(u_np, device=dev).to(plan0.complex_dtype)
        del u_np
        gen = torch.Generator(device=dev).manual_seed(seed + NP_RHO1)
        pts = _uniform_points(gen, 3, NP_RHO1, plan0.real_dtype, dev)
        vp = _random_values(gen, (NP_RHO1,), plan0.dtype, dev)
        plan = nufft.set_points(plan0, pts)
        log(f"  {label}, rho = 1 ({NP_RHO1:,} points): timer and callbacks")
        row = dict(row=f"{label} timer and callbacks", np=NP_RHO1,
                   **_timer_and_callbacks(plan, vp, u, CALLBACK_TOL[nbytes]))
        rows.append(row)
        rows.append(_chunked_row(f"{label} rho = 1", dtype, SHAPE_3D, pts, vp, u, a,
                                 NCHUNKS, seed, plan=plan))
        record((rows[-1]["launches"], {}))
        del plan, pts, vp
        torch.cuda.empty_cache()

        # rho = 10: the unchunked set_points' peak and times, then chunked.
        gen = torch.Generator(device=dev).manual_seed(seed + NP_RHO10)
        pts = _uniform_points(gen, 3, NP_RHO10, plan0.real_dtype, dev)
        vp = _random_values(gen, (NP_RHO10,), plan0.dtype, dev)
        peak, t_set, plan = _set_points_peak_and_time(lambda: nufft.set_points(plan0, pts), 3)
        t1, _ = cuda_time_ms(lambda: nufft.exec_type1(plan, vp), reps=3)
        t2, _ = cuda_time_ms(lambda: nufft.exec_type2(plan, u), reps=3)
        log(f"  {label} rho = 10 unchunked: set_points {t_set:.3f} ms (peak "
            f"{peak / 2**30:.2f} GiB above the inputs), exec_type1 {t1:.3f} ms, "
            f"exec_type2 {t2:.3f} ms")
        del plan
        torch.cuda.empty_cache()
        row = _chunked_row(f"{label} rho = 10", dtype, SHAPE_3D, pts, vp, u, a, NCHUNKS, seed)
        row["unchunked"] = dict(set_points_ms=t_set, set_points_peak_bytes=peak,
                                exec_type1_ms=t1, exec_type2_ms=t2)
        rows.append(row)
        record((row["launches"], {}))
        del pts, vp, u
        torch.cuda.empty_cache()

    # 1D: a chunk's spread stores its interior cells, so a grid shared by
    # the chunks would lose the earlier chunks' sums there.
    np_, k = CHUNKED_1D
    plan0 = _plan(np.complex64, SHAPE_1D, 4, 1.5)
    a, u_np = _rank1_spectrum(SHAPE_1D, False, seed)
    u = torch.as_tensor(u_np, device=dev).to(plan0.complex_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed + np_)
    pts = _uniform_points(gen, 1, np_, plan0.real_dtype, dev)
    vp = _random_values(gen, (np_,), plan0.dtype, dev)
    rows.append(_chunked_row("1D complex64", np.complex64, SHAPE_1D, pts, vp, u, a, k, seed,
                             plan=nufft.set_points(plan0, pts)))
    record((rows[-1]["launches"], {}))
    del pts, vp, u
    torch.cuda.empty_cache()
    rows.extend(_direct_rows(seed))
    log("  results " + json.dumps(rows))


# ---------------------------------------------------------------------------
# Phase 15: many transforms over shared points
# ---------------------------------------------------------------------------


def _rank1_batch(shape, C: int, seed: int, dtype, device):
    """C rank-1 spectra that share their leading factors and differ in the
    last one: the factor lists (numpy, for ``_err2``) and the ``(C,) +
    shape`` spectrum in ``dtype`` on ``device``."""
    import torch

    rng = np.random.default_rng(seed + 15)
    head = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)) / n for n in shape[:-1]]
    last = ((rng.standard_normal((C, shape[-1])) + 1j * rng.standard_normal((C, shape[-1])))
            / shape[-1])
    h = torch.ones((), dtype=torch.complex128, device=device)
    for f in head:
        h = h[..., None] * torch.as_tensor(f, device=device)
    u = h[None, ..., None] * torch.as_tensor(last, device=device).view(
        (C,) + (1,) * (len(shape) - 1) + (shape[-1],))
    return [head + [last[c]] for c in range(C)], u.to(dtype)


def _peak_above(fn):
    """``fn()``, the device memory it held at its peak above what was
    allocated before it, and that peak as ``max_memory_allocated``."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, peak - base, peak


def ntransforms_row(dtype, sigma: float, C: int, seed: int, pts, vp, u, factors,
                    shape=SHAPE_3D):
    """One row of phase 15: ``set_points`` / ``exec_type1`` / ``exec_type2``
    of a C-transform plan at ``shape`` (ms a call and a transform), each
    transform's err1 / err2 against exact sums, the peak memory of each
    exec against the model's (``plan.py:transform_working_set``), the
    chosen ``transform_chunk`` and the launches: one spread and one
    interpolation a group a call.  A row at sigma != 1.5 must run in
    groups, and its first and last transforms are held against
    one-transform plans on the same points."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch import plan as plan_mod
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    label = f"{len(shape)}D {np.dtype(dtype).name} sigma = {sigma} C = {C}"
    plan0 = _plan(dtype, shape, 4, sigma, ntransforms=C)
    blocked.reset_launch_counts()
    t_set, plan = cuda_time_ms(lambda: nufft.set_points(plan0, pts))
    groups = plan_mod.transform_groups(C, plan.transform_chunk)
    gmax = max(g.stop - g.start for g in groups)
    uhat, peak1, abs1 = _peak_above(lambda: nufft.exec_type1(plan, vp))
    v2, peak2, abs2 = _peak_above(lambda: nufft.exec_type2(plan, u))
    if tuple(uhat.shape) != (C,) + plan.spectral_shape or tuple(v2.shape) != (C, pts.shape[1]):
        raise AssertionError(f"{label}: output shapes {tuple(uhat.shape)}, {tuple(v2.shape)}")
    if not (torch.isfinite(torch.view_as_real(uhat)).all() and torch.isfinite(v2).all()):
        raise AssertionError(f"{label}: non-finite output")
    e1 = [_err1(pts, vp[c], uhat[c], shape, plan.is_real, seed) for c in range(C)]
    e2 = [_err2(pts, v2[c], factors[c], plan.is_real, seed) for c in range(C)]
    # The model's bytes, and the measured ones a transform of the largest
    # group: the peak less the exec's whole-C output (and a grouped type
    # 2's scaled copy of its input).
    ws = plan_mod.transform_working_set(
        plan.shape_over, plan.spectral_shape_over, plan.spectral_shape, plan.dtype, C,
        plan.num_points, point_state_bytes=plan_mod.point_state_bytes(plan))
    spec_bytes = uhat.numel() * uhat.element_size()
    out2 = v2.numel() * v2.element_size() + (spec_bytes if len(groups) > 1 else 0)
    grid = math.prod(plan.shape_over) * vp.element_size()  # a transform's
    per1, per2 = (peak1 - spec_bytes) / gmax, (peak2 - out2) / gmax
    row = dict(row=label, dtype=np.dtype(dtype).name, sigma=sigma, ntransforms=C,
               np=pts.shape[1], transform_chunk=plan.transform_chunk, groups=len(groups),
               err1=e1, err2=e2, peak_exec_type1_bytes=peak1, peak_exec_type2_bytes=peak2,
               max_memory_allocated_exec_type1=abs1, max_memory_allocated_exec_type2=abs2,
               per_transform_grids_measured=[per1 / grid, per2 / grid],
               per_transform_grids_model=ws.per_transform / grid,
               model_total_bytes=ws.total(gmax))
    ends = (0, C - 1)
    u_ends, v_ends = uhat[list(ends)], v2[list(ends)]
    del uhat, v2
    torch.cuda.empty_cache()
    # Timed with each call's output dropped before the next call.
    t1, _ = cuda_time_ms(lambda: nufft.exec_type1(plan, vp) is None)
    t2, _ = cuda_time_ms(lambda: nufft.exec_type2(plan, u) is None)
    torch.cuda.synchronize()
    counts = _check_path_launches(plan, label, (2 + REPS) * len(groups))
    for kind in ("spread", "interp"):
        name = blocked.entry_point(kind, plan)
        if counts[name] != (2 + REPS) * len(groups):
            raise AssertionError(f"{label}: {name} launched {counts[name]} times, not one a "
                                 f"group of each of {2 + REPS} calls")
    log(f"  {label}: transform_chunk {plan.transform_chunk}, {len(groups)} groups; "
        f"set_points {t_set:.3f} ms, exec_type1 {t1:.3f} ms ({t1 / C:.3f} a transform), "
        f"exec_type2 {t2:.3f} ms ({t2 / C:.3f} a transform)")
    log(f"    peak above the inputs: exec_type1 {peak1 / 2**30:.3f} GiB "
        f"(max_memory_allocated {abs1 / 2**30:.3f}), exec_type2 {peak2 / 2**30:.3f} GiB "
        f"({abs2 / 2**30:.3f}); a transform of the largest group {per1 / grid:.3f} / "
        f"{per2 / grid:.3f} grids, model {ws.per_transform / grid:.3f} "
        f"(grid {grid / 2**30:.3f} GiB)")
    check(f"max err1 over {C} transforms ({label})", max(e1), ERR_TOL)
    check(f"max err2 over {C} transforms ({label})", max(e2), ERR_TOL)
    row.update(set_points_ms=t_set, exec_type1_ms=t1, exec_type2_ms=t2,
               exec_type1_ms_per_transform=t1 / C, exec_type2_ms_per_transform=t2 / C,
               launches=counts)
    if sigma != 1.5:
        if len(groups) < 2:
            raise AssertionError(f"{label} ran in one pass")
        single = nufft.set_points(_plan(dtype, shape, 4, sigma), pts)
        row["vs_single_transform_plans"] = (
            [rel_l2(u_ends[i], nufft.exec_type1(single, vp[c])) for i, c in enumerate(ends)]
            + [rel_l2(v_ends[i], nufft.exec_type2(single, u[c])) for i, c in enumerate(ends)])
        check(f"{label}: transforms 0 and {C - 1} vs one-transform plans",
              max(row["vs_single_transform_plans"]),
              GROUPED_TOL[torch.finfo(plan.real_dtype).bits // 8])
    return row


def _grouped_against_whole(dtype, seed: int, pts, vp, u):
    """C = NT_GROUPED[0] with ``transform_chunk`` forced to NT_GROUPED[1]
    against the same plan run whole; then once with
    ``Timer(synchronise=True)`` and both callbacks: every label present,
    each stage once a group."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch import plan as plan_mod

    C, chunk = NT_GROUPED
    whole = dataclasses.replace(
        nufft.set_points(_plan(dtype, SHAPE_3D, 4, 1.5, ntransforms=C), pts),
        transform_chunk=None)
    grouped = dataclasses.replace(whole, transform_chunk=chunk)
    tol = GROUPED_TOL[torch.finfo(whole.real_dtype).bits // 8]
    errs = [rel_l2(nufft.exec_type1(grouped, vp), nufft.exec_type1(whole, vp)),
            rel_l2(nufft.exec_type2(grouped, u), nufft.exec_type2(whole, u))]
    label = f"3D {np.dtype(dtype).name} C = {C}, groups of {chunk}"
    check(f"{label}: type 1 grouped vs whole", errs[0], tol)
    check(f"{label}: type 2 grouped vs whole", errs[1], tol)
    w = torch.rand(pts.shape[1], device=pts.device, dtype=whole.real_dtype) + 0.5
    cb = nufft.NUFFTCallbacks(nonuniform=lambda vs, n: tuple(x * w[n] for x in vs),
                              uniform=lambda ws, idx: tuple(x * 0.5 for x in ws))
    timer = nufft.Timer(synchronise=True)
    timed = dataclasses.replace(grouped, timer=timer)
    nufft.exec_type1(timed, vp, cb)
    nufft.exec_type2(timed, u, cb)
    ngroups = len(plan_mod.transform_groups(C, chunk))
    log("  " + repr(timer).replace("\n", "\n  "))
    for top, labels in (("exec_type1", T1_LABELS), ("exec_type2", T2_LABELS)):
        missing = [lb for lb in labels if f"{top}/{lb}" not in timer.times]
        if missing:
            raise AssertionError(f"{label}: timer labels missing under {top}: {missing}")
    for key in ("exec_type1/(1) spreading", "exec_type1/(2) forward FFT",
                "exec_type2/(2) backward FFT", "exec_type2/(3) interpolation"):
        if timer.counts[key] != ngroups:
            raise AssertionError(f"{label}: {key} ran {timer.counts[key]} times, not "
                                 f"once for each of {ngroups} groups")
    return dict(row=label, grouped_vs_whole=errs, timer_counts=dict(timer.counts))


def _ends(label, shape, seed, vp, factors, got, one, tol, pts, pts_local=None):
    """err1 / err2 of transforms 0 and C - 1 against exact sums (type 2 at
    ``pts_local``, this rank's points, when given), and against ``one(c)``,
    the (spectrum, values) of a one-transform run of the same path on the
    same inputs; ``got`` holds the run's own for the two (``_peaks``);
    checks both against their limits; returns them."""
    C = vp.shape[0]
    ends = (0, C - 1)
    e1, e2, vs_one = [], [], []
    for i, c in enumerate(ends):
        uc, v2c = got[0][i], got[1][i]
        u1, w2 = one(c)
        e1.append(_err1(pts, vp[c], uc, shape, False, seed))
        e2.append(_err2(pts if pts_local is None else pts_local, v2c, factors[c], False, seed))
        vs_one.append([rel_l2(uc, u1), rel_l2(v2c, w2)])
    for what, value, limit in ((f"err1 of transforms 0 and {C - 1}", max(e1), ERR_TOL),
                               (f"err2 of transforms 0 and {C - 1}", max(e2), ERR_TOL),
                               ("type 1 vs one-transform runs", max(x[0] for x in vs_one), tol),
                               ("type 2 vs one-transform runs", max(x[1] for x in vs_one), tol)):
        check(f"{label}: {what}", value, limit)
    return dict(err1_ends=e1, err2_ends=e2, vs_one_transform=vs_one)


def _peaks(label, run1, run2, ends, ws, C: int, gmax: int, grid_bytes: int, out1: int,
           out2: int, share: int):
    """Run ``run1`` (type 1) and ``run2`` (type 2) once each for their peak
    device memory; print and return it beside the model: the peak less the
    exec's whole-C output (``out1``, ``out2``) a transform of the largest
    group in grids (``grid_bytes``) against the model's per-transform
    bytes, and ``max_memory_allocated`` against the model's total in these
    groups and in one pass of all C, and the process's share of the card
    (``share``), which it must stay under; beside it the caching
    allocator's ``max_memory_reserved``.  Only ``ends(output)`` of each
    output is kept: the transforms the row checks."""
    import torch

    torch.cuda.empty_cache()
    got, peak1, abs1 = _peak_above(run1)
    res1 = torch.cuda.max_memory_reserved()
    got1 = ends(got)
    del got
    torch.cuda.empty_cache()
    got, peak2, abs2 = _peak_above(run2)
    res2 = torch.cuda.max_memory_reserved()
    got2 = ends(got)
    del got
    per = [(peak1 - out1) / gmax / grid_bytes, (peak2 - out2) / gmax / grid_bytes]
    log(f"    {label}: peak above the inputs {peak1 / 2**30:.3f} / {peak2 / 2**30:.3f} GiB, "
        f"max_memory_allocated {abs1 / 2**30:.3f} / {abs2 / 2**30:.3f} GiB, "
        f"max_memory_reserved {res1 / 2**30:.3f} / {res2 / 2**30:.3f} GiB (share "
        f"{share / 2**30:.3f}, model total {ws.total(gmax) / 2**30:.3f}, in one pass "
        f"{ws.total(C) / 2**30:.3f}); a transform of the "
        f"largest group {per[0]:.3f} / {per[1]:.3f} grids, model "
        f"{ws.per_transform / grid_bytes:.3f} (grid {grid_bytes / 2**30:.3f} GiB)")
    if max(abs1, abs2) > share:
        raise AssertionError(f"{label}: peak {max(abs1, abs2)} bytes above the share {share}")
    return got1, got2, dict(
        peak_exec_type1_bytes=peak1, peak_exec_type2_bytes=peak2,
        max_memory_allocated_exec_type1=abs1, max_memory_allocated_exec_type2=abs2,
        max_memory_reserved_exec_type1=res1, max_memory_reserved_exec_type2=res2,
        per_transform_grids_measured=per, per_transform_grids_model=ws.per_transform / grid_bytes,
        model_total_bytes=ws.total(gmax), model_one_pass_bytes=ws.total(C), share_bytes=share)


def _timed_per_transform(label, C, run1, run2, reps: int):
    """ms of ``run1`` / ``run2`` (CUDA events, median of ``reps`` after one
    warm-up; once when ``reps`` is 1, without the warm-up), a call and a
    transform."""
    warmup = 0 if reps == 1 else 1
    t1, _ = cuda_time_ms(lambda: run1() is None, reps=reps, warmup=warmup)
    t2, _ = cuda_time_ms(lambda: run2() is None, reps=reps, warmup=warmup)
    log(f"  {label}: exec_type1 {t1:.3f} ms ({t1 / C:.3f} a transform), exec_type2 "
        f"{t2:.3f} ms ({t2 / C:.3f} a transform), {'once' if reps == 1 else f'median of {reps}'}")
    return dict(exec_type1_ms=t1, exec_type2_ms=t2, exec_type1_ms_per_transform=t1 / C,
                exec_type2_ms_per_transform=t2 / C, timed_calls=reps)


def nt_chunked_row(dtype, sigma: float, seed: int, pts, vp, u, factors):
    """Phase 15 row (a): ``ChunkedPlanNUFFT`` (NCHUNKS chunks) on the plain
    row's arguments and inputs, in the chunked plan's groups of transforms
    (it must run in more than one), with its peaks against the model
    (all chunks' point state, the accumulator), its ends against exact sums
    and a one-transform chunked plan, and one spread and one interpolation
    launch a chunk a group a call."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch import chunked
    from nonuniformffts_tpu_torch import plan as plan_mod
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    C = vp.shape[0]
    label = f"3D {np.dtype(dtype).name} sigma = {sigma} C = {C}, chunked ({NCHUNKS})"
    kw = dict(m=4, sigma=sigma, spread_method="blocked", device=torch.device("cuda"),
              **_window_kw())
    blocked.reset_launch_counts()
    t_set, cplan = cuda_time_ms(lambda: nufft.set_points_chunked(nufft.ChunkedPlanNUFFT(
        dtype, SHAPE_3D, nchunks=NCHUNKS, ntransforms=C, **kw), pts), reps=1, warmup=0)
    groups = plan_mod.transform_groups(C, cplan.transform_chunk)
    if len(groups) < 2:
        raise AssertionError(f"{label} ran in one pass")
    gmax = max(g.stop - g.start for g in groups)
    whole = chunked.whole_plan(cplan)
    ws = plan_mod.transform_working_set(**{
        **plan_mod.model_arguments(whole), "extra_grids": 1,
        "point_state_bytes": sum(plan_mod.point_state_bytes(p) for p in cplan.plans)})
    spec = C * math.prod(whole.spectral_shape) * vp.element_size()
    *got, row = _peaks(label, lambda: nufft.exec_type1_chunked(cplan, vp),
                       lambda: nufft.exec_type2_chunked(cplan, u), lambda x: x[[0, C - 1]], ws,
                       C, gmax, math.prod(whole.shape_over) * vp.element_size(), spec,
                       vp.numel() * vp.element_size() + spec,
                       plan_mod.device_share_bytes(vp.device))
    one = nufft.set_points_chunked(nufft.ChunkedPlanNUFFT(dtype, SHAPE_3D, nchunks=NCHUNKS,
                                                          **kw), pts)
    row.update(_ends(label, SHAPE_3D, seed, vp, factors, got,
                     lambda c: (nufft.exec_type1_chunked(one, vp[c]),
                                nufft.exec_type2_chunked(one, u[c])),
                     GROUPED_TOL[vp.element_size() // 2], pts))
    del got, one
    torch.cuda.empty_cache()
    blocked.reset_launch_counts()
    row.update(_timed_per_transform(
        label, C, lambda: nufft.exec_type1_chunked(cplan, vp),
        lambda: nufft.exec_type2_chunked(cplan, u), NT_PATH_REPS))
    calls = NT_PATH_REPS + 1
    counts = _check_path_launches(cplan.base, label, calls * NCHUNKS * len(groups))
    log(f"    transform_chunk {cplan.transform_chunk}, {len(groups)} groups; "
        f"set_points_chunked {t_set:.3f} ms")
    row.update(row=label, transform_chunk=cplan.transform_chunk, groups=len(groups),
               set_points_chunked_ms=t_set, launches=counts)
    return row


def _channel_end(x, c: int):
    """Transform ``c`` of a channel-form output as a complex tensor."""
    from nonuniformffts_tpu_torch import execution as ex

    return ex.from_channels(x[c : c + 1], 1)[0]


def nt_sharded_row(dtype, sigma: float, seed: int, pts, vp, u_ch, factors):
    """Phase 15 row (b), point-sharded: ``exec_type{1,2}_sharded`` on the
    NCCL group of one rank that is the default group, on the plain row's
    arguments and inputs (its rank-1 spectra in the channel form,
    ``u_ch``), as ``nt_chunked_row``."""
    import torch

    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch import plan as plan_mod
    from nonuniformffts_tpu_torch.ops.kernels import blocked
    from nonuniformffts_tpu_torch.parallel import comm, sharded

    C = vp.shape[0]
    label = f"3D {np.dtype(dtype).name} sigma = {sigma} C = {C}, point-sharded (nccl, n = 1)"
    plan = _plan(dtype, SHAPE_3D, 4, sigma, ntransforms=C)
    one = _plan(dtype, SHAPE_3D, 4, sigma)
    v_ch = ex.to_channels(vp, 1)
    local = sharded.local_plan(plan, pts, agree=True)  # type 1's
    chunk = local.transform_chunk
    groups = plan_mod.transform_groups(C, chunk)
    if len(groups) < 2:
        raise AssertionError(f"{label} ran in one pass")
    gmax = max(g.stop - g.start for g in groups)
    ws = plan_mod.transform_working_set(**plan_mod.model_arguments(local))
    sharing = comm.ranks_on_device(vp.device)
    del local
    spec = C * math.prod(plan.spectral_shape) * vp.element_size()
    run1 = lambda: sharded.exec_type1_sharded(plan, pts, v_ch)  # noqa: E731
    run2 = lambda: sharded.exec_type2_sharded(plan, pts, u_ch)  # noqa: E731
    *got, row = _peaks(label, run1, run2, lambda x: [_channel_end(x, c) for c in (0, C - 1)],
                       ws, C, gmax, math.prod(plan.shape_over) * vp.element_size(), 2 * spec,
                       2 * vp.numel() * vp.element_size() + 2 * spec,
                       plan_mod.device_share_bytes(vp.device, sharing))
    row.update(_ends(
        label, SHAPE_3D, seed, vp, factors, got,
        lambda c: (_channel_end(sharded.exec_type1_sharded(one, pts, v_ch[c : c + 1]), 0),
                   _channel_end(sharded.exec_type2_sharded(one, pts, u_ch[c : c + 1]), 0)),
        GROUPED_TOL[vp.element_size() // 2], pts))
    del got
    torch.cuda.empty_cache()
    blocked.reset_launch_counts()
    row.update(_timed_per_transform(label, C, run1, run2, NT_PATH_REPS))
    counts = _check_path_launches(plan, label, (NT_PATH_REPS + 1) * len(groups))
    log(f"    transform_chunk {chunk}, {len(groups)} groups, {sharing} rank(s) on the card")
    row.update(row=label, transform_chunk=chunk, groups=len(groups), ranks_on_device=sharing,
               launches=counts)
    return row


def nt_spatial_row(dtype, sigma: float, seed: int, pts, vp, u_ch, factors, reps=NT_PATH_REPS,
                   group=None):
    """Phase 15 rows (b) and (c), spatial: ``SpatialNUFFT`` (replicated
    spectrum, block form) on ``group`` (default: the default group), this
    rank's share of the points and values, the rank-1 spectra in the
    channel form (``u_ch``); its groups from the slab model and the rank's
    share of the card; peaks, ends and launches as ``nt_chunked_row``."""
    import torch
    import torch.distributed as dist

    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch import plan as plan_mod
    from nonuniformffts_tpu_torch.ops.kernels import blocked
    from nonuniformffts_tpu_torch.parallel import SpatialNUFFT, comm

    C = vp.shape[0]
    n, me = dist.get_world_size(group), dist.get_rank(group)
    label = (f"3D {np.dtype(dtype).name} sigma = {sigma} C = {C}, spatial "
             f"({comm.backend(group)}, n = {n})")
    npl = pts.shape[1] // n
    sl = slice(me * npl, (me + 1) * npl)
    kw = dict(group=group, m=4, sigma=sigma, capacity_factor=SPATIAL_CAPACITY,
              device=vp.device, **_window_kw())
    sp = SpatialNUFFT(dtype, SHAPE_3D, ntransforms=C, **kw)
    one = SpatialNUFFT(dtype, SHAPE_3D, **kw)
    v_ch = ex.to_channels(vp[:, sl], 1)
    t_set, st = cuda_time_ms(lambda: sp.set_points(pts[:, sl]), reps=1, warmup=0)
    st_one = one.set_points(pts[:, sl])
    groups = plan_mod.transform_groups(C, st.local.transform_chunk)
    if len(groups) < 2:
        raise AssertionError(f"{label} ran in one pass")
    gmax = max(g.stop - g.start for g in groups)
    spec = C * math.prod(sp.output_shape) * vp.element_size()
    run1 = lambda: sp.exec_type1(st, v_ch)  # noqa: E731
    run2 = lambda: sp.exec_type2(st, u_ch)  # noqa: E731
    *got, row = _peaks(
        f"{label} rank {me}", run1, run2, lambda x: [_channel_end(x, c) for c in (0, C - 1)],
        sp.working_set(st), C, gmax, math.prod(st.local.shape_over) * vp.element_size(), spec,
        2 * v_ch.numel() * v_ch.element_size() + spec,
        plan_mod.device_share_bytes(vp.device, st.ranks_on_device))
    row.update(_ends(
        f"{label} rank {me}", SHAPE_3D, seed, vp, factors, got,
        lambda c: (_channel_end(one.exec_type1(st_one, v_ch[c : c + 1]), 0),
                   _channel_end(one.exec_type2(st_one, u_ch[c : c + 1]), 0)),
        GROUPED_TOL[vp.element_size() // 2], pts, pts_local=pts[:, sl]))
    del got, st_one, one
    torch.cuda.empty_cache()
    blocked.reset_launch_counts()
    row.update(_timed_per_transform(f"{label} rank {me}", C, run1, run2, reps))
    counts = _check_path_launches(st.local, f"{label} rank {me}",
                                  (reps + (reps > 1)) * len(groups))
    log(f"    rank {me}: transform_chunk {st.local.transform_chunk}, {len(groups)} groups, "
        f"{st.ranks_on_device} rank(s) on the card; set_points {t_set:.3f} ms")
    row.update(row=label, rank=me, n=n, transform_chunk=st.local.transform_chunk,
               groups=len(groups), ranks_on_device=st.ranks_on_device, set_points_ms=t_set,
               launches=counts)
    return row


def _nt_inputs(dtype, shape, C: int, seed: int, np_: int = NT_NP):
    """Phase 15's points, values and rank-1 spectra of a complex dtype."""
    import torch

    dev = torch.device("cuda")
    tdtype = getattr(torch, np.dtype(dtype).name)
    gen = torch.Generator(device=dev).manual_seed(seed + np_)
    pts = _uniform_points(gen, len(shape), np_, tdtype.to_real(), dev)
    vp = _random_values(gen, (C, np_), tdtype, dev)
    factors, u = _rank1_batch(shape, C, seed, tdtype, dev)
    return pts, vp, u, factors


def _nt_gloo_rank(rank: int, n: int, rdv: str, out_dir: str, seed: int):
    """One gloo rank of phase 15 row (c) on cuda:0: ``nt_spatial_row`` on
    NT_GLOO, every rank making the same global inputs; writes its row to
    ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=600))
    from nonuniformffts_tpu_torch import execution as ex

    dtype, sigma, C, _ = NT_GLOO
    pts, vp, u, factors = _nt_inputs(dtype, SHAPE_3D, C, seed)
    u_ch = ex.to_channels(u, 1)
    del u
    row = nt_spatial_row(dtype, sigma, seed, pts, vp, u_ch, factors, reps=1)
    dist.barrier()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(row))
    dist.destroy_process_group()


def nt_gloo_rows(seed: int):
    """Phase 15 row (c): NT_GLOO ranks of a gloo group spawned on the one
    card, each planning with its share of it."""
    import tempfile

    import torch.multiprocessing as mp

    n = NT_GLOO[3]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(_nt_gloo_rank, args=(n, f"{tmp}/rendezvous", tmp, seed), nprocs=n,
                           start_method="spawn")
        log(f"  {n} gloo ranks on cuda:0 finished in {time.perf_counter() - t0:.1f} s")
        rows = [json.loads(Path(tmp, f"rank{k}.json").read_text()) for k in range(n)]
    for r in rows:
        peak = max(r["max_memory_allocated_exec_type1"], r["max_memory_allocated_exec_type2"])
        log(f"  {r['row']} rank {r['rank']}: {r['groups']} groups of {r['transform_chunk']}, "
            f"exec_type1 / exec_type2 {r['exec_type1_ms_per_transform']:.3f} / "
            f"{r['exec_type2_ms_per_transform']:.3f} ms a transform (once), peak "
            f"{peak / 2**30:.3f} GiB of its share {r['share_bytes'] / 2**30:.3f} (model total "
            f"{r['model_total_bytes'] / 2**30:.3f}, in one pass "
            f"{r['model_one_pass_bytes'] / 2**30:.3f}), err1 {max(r['err1_ends']):.3e}, err2 "
            f"{max(r['err2_ends']):.3e}, vs one transform {r['vs_one_transform']}")
    return rows


def nt_lowdim_row(shape, dtype, C: int, chunk: int, seed: int):
    """Phase 15's 2D and 1D rows: C transforms at ``shape``, sigma = 1.5, as
    the 3D rows (the model's 2D and 1D terms against the peaks), then the
    same plan in groups of ``chunk`` against one pass."""
    import torch

    import nonuniformffts_tpu_torch as nufft

    pts, vp, u, factors = _nt_inputs(dtype, shape, C, seed)
    row = ntransforms_row(dtype, 1.5, C, seed, pts, vp, u, factors, shape=shape)
    whole = dataclasses.replace(
        nufft.set_points(_plan(dtype, shape, 4, 1.5, ntransforms=C), pts),
        transform_chunk=None)
    grouped = dataclasses.replace(whole, transform_chunk=chunk)
    row["grouped_vs_whole"] = [rel_l2(nufft.exec_type1(grouped, vp), nufft.exec_type1(whole, vp)),
                               rel_l2(nufft.exec_type2(grouped, u), nufft.exec_type2(whole, u))]
    tol = GROUPED_TOL[vp.element_size() // 2]
    check(f"{row['row']}, groups of {chunk}: type 1 grouped vs whole", row["grouped_vs_whole"][0],
          tol)
    check(f"{row['row']}, groups of {chunk}: type 2 grouped vs whole", row["grouped_vs_whole"][1],
          tol)
    del whole, grouped, pts, vp, u
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def nccl_group_of_one():
    """An NCCL process group of this process alone, the default group."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def check_kernels_many(shape, C: int, seed: int, transforms):
    """Each spread and interpolation entry point at ``shape`` (m = 4, sigma =
    1.5, BKB Fast, NT_KERNEL_NP points), four dtypes, C transforms in one
    launch against the plain version run a transform at a time (each
    transform's plain result does not depend on the others); the kernel
    timed as one wrapper call (CUDA events, median of 3 after one warm-up),
    the plain loop once.  Adds each result to ``transforms[name]["C=<C>"]``."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    dev = torch.device("cuda")
    for dtype in (np.complex64, np.float32, np.complex128, np.float64):
        plan0 = _plan(dtype, shape, 4, 1.5, ntransforms=C)
        gen = torch.Generator(device=dev).manual_seed(seed + C + len(shape))
        pts = _uniform_points(gen, len(shape), NT_KERNEL_NP, plan0.real_dtype, dev)
        plan = nufft.set_points(plan0, pts)
        plain = dataclasses.replace(plan, chunk_size=PLAIN_CHUNK)
        tol = KERNEL_TOL[torch.finfo(plan.real_dtype).bits // 8]
        for kind in ("spread", "interp"):
            if kind == "spread":
                x = _random_values(gen, (C, NT_KERNEL_NP), plan.dtype, dev)
                kern, ref = blocked.spread_blocked, blocked.spread_blocked_plain
            else:
                x = _random_values(gen, (C,) + plan.shape_over, plan.dtype, dev)
                kern, ref = blocked.interpolate_blocked, blocked.interpolate_blocked_plain
            ms, got = cuda_time_ms(lambda: kern(plan, x), reps=3)
            num = den = max_abs = 0.0
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for c in range(C):
                want = ref(plain, x[c : c + 1])[0]
                num += float((got[c] - want).abs().pow(2).sum())
                den += float(want.abs().pow(2).sum())
                max_abs = max(max_abs, float((got[c] - want).abs().max()))
            stop.record()
            stop.synchronize()
            err = math.sqrt(num / den)
            name = blocked.entry_point(kind, plan)
            bound_ms, bound_by = kernel_bound(kind, plan, C)
            log(f"  {name}, C = {C}, {shape_text(shape)}: rel L2 {err:.3e}, max abs "
                f"{max_abs:.3e} vs plain, kernel {ms:.3f} ms ({ms / C:.3f} a transform), "
                f"bound {bound_ms:.4g} ms ({bound_by})")
            check(f"{name} rel L2 vs plain at C={C}", err, tol)
            transforms[name][f"C={C}"] = dict(
                rel_l2=err, max_abs_err=max_abs, ms=ms, ms_per_transform=ms / C,
                plain_ms=start.elapsed_time(stop), bound_ms=bound_ms, bound_by=bound_by)
            del got, x
            torch.cuda.empty_cache()
        del plan, plain, pts
        torch.cuda.empty_cache()


def phase_ntransforms(seed: int, record, transforms):
    """Phase 15 (see the module docstring)."""
    import torch

    from nonuniformffts_tpu_torch import execution as ex

    dev = torch.device("cuda")
    rows = []
    for dtype, sigma, counts in NT_ROWS:
        t0 = time.perf_counter()
        tdtype = getattr(torch, np.dtype(dtype).name)
        complex_data = tdtype.is_complex
        cdtype = tdtype if complex_data else tdtype.to_complex()
        gen = torch.Generator(device=dev).manual_seed(seed + NT_NP)
        pts = _uniform_points(gen, 3, NT_NP, cdtype.to_real(), dev)
        for C in counts:
            vp = _random_values(gen, (C, NT_NP), tdtype, dev)
            if complex_data:
                factors, u = _rank1_batch(SHAPE_3D, C, seed, tdtype, dev)
            else:  # the c2r oracle's spectrum, the same for every transform
                a, u_np = _rank1_spectrum(SHAPE_3D, True, seed)
                factors = [a] * C
                u = torch.as_tensor(u_np, device=dev).to(cdtype).expand(
                    (C,) + u_np.shape).contiguous()
                del u_np
            rows.append(ntransforms_row(dtype, sigma, C, seed, pts, vp, u, factors))
            record((rows[-1]["launches"], {}))
            if (dtype, sigma, C) == NT_PATHS:
                rows.append(nt_chunked_row(dtype, sigma, seed, pts, vp, u, factors))
                u = ex.to_channels(u, 1)  # the form the multi-device modes take
                torch.cuda.empty_cache()
                rows.extend(_nccl_rows(dtype, sigma, seed, pts, vp, u, factors))
                for r in rows[-3:]:
                    record((r["launches"], {}))
            del vp, u
            torch.cuda.empty_cache()
        if sigma == 1.5 and complex_data:
            C = NT_GROUPED[0]
            vp = _random_values(gen, (C, NT_NP), tdtype, dev)
            _, u = _rank1_batch(SHAPE_3D, C, seed, tdtype, dev)
            rows.append(_grouped_against_whole(dtype, seed, pts, vp, u))
            del vp, u
        del pts
        torch.cuda.empty_cache()
        log(f"  ({np.dtype(dtype).name} sigma = {sigma} rows: "
            f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    gloo = nt_gloo_rows(seed)
    for r in gloo:
        record((r["launches"], {}))
    rows.extend(gloo)
    log(f"  (gloo rows: {time.perf_counter() - t0:.1f} s)")
    for shape, dtype, C, chunk in NT_LOWDIM:
        t0 = time.perf_counter()
        rows.append(nt_lowdim_row(shape, dtype, C, chunk, seed))
        record((rows[-1]["launches"], {}))
        log(f"  ({len(shape)}D row: {time.perf_counter() - t0:.1f} s)")
    for C in NT_KERNEL_COUNTS:
        t0 = time.perf_counter()
        for shape in (SHAPE_1D, SHAPE_2D, SHAPE_3D):
            check_kernels_many(shape, C, seed, transforms)
        log(f"  (kernels at C = {C}: {time.perf_counter() - t0:.1f} s)")
    log("  results " + json.dumps(rows))


def _nccl_rows(dtype, sigma: float, seed: int, pts, vp, u_ch, factors):
    """Rows (b) of phase 15 beside the plain row of NT_PATHS, on its inputs
    (the spectra in the channel form): the point-sharded and spatial modes
    on an NCCL group of one rank."""
    import torch

    t0 = time.perf_counter()
    with nccl_group_of_one():
        rows = [nt_sharded_row(dtype, sigma, seed, pts, vp, u_ch, factors)]
        torch.cuda.empty_cache()
        rows.append(nt_spatial_row(dtype, sigma, seed, pts, vp, u_ch, factors))
    torch.cuda.empty_cache()
    log(f"  (point-sharded and spatial rows: {time.perf_counter() - t0:.1f} s)")
    return rows


def _launched_only(name: str, count: int, what: str) -> None:
    """Raises unless, since the last reset, ``name`` launched ``count`` times
    and no other entry point launched."""
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    others = {k: v for k, v in blocked.LAUNCHES.items() if v and k != name}
    if blocked.LAUNCHES[name] != count or others:
        raise AssertionError(f"{what}: {name} launched {blocked.LAUNCHES[name]} times, "
                             f"expected {count}; others {others}")


def phase_deconvolve(seed: int):
    """Phase 16: both deconvolution kernels against the plain chain at the
    main-path shapes, N = 256^3 over the 384^3 grid (m = 4, sigma = 1.5),
    one transform, four value types: type 1's truncate (from the oversampled
    spectrum) and type 2's pad (from the modes), each checked (rel L2 within
    the multiply chain's rounding, whether bit-equal, one launch a call),
    timed in turns (plain, kernel, kernel, plain; CUDA-event medians of
    ``REPS``) and beside its bound by bytes (each kept mode read once, each
    output written once); the pad with the scaling off (a grouped type 2's)
    is checked to be a copy, bit for bit.  Launches are read from
    ``blocked.LAUNCHES`` after each call or timed stretch, and each must be
    what the calls made: one a kernel call, none for the plain chain.
    Returns (launches, comparisons)."""
    import torch

    from nonuniformffts_tpu_torch.ops import deconvolve
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    log(f"== phase 16: deconvolution kernels, N = {shape_text(SHAPE_3D)}, m = 4, sigma = 1.5, "
        f"four dtypes")
    launches, compared = collections.Counter(), {}
    rtol = {4: 1e-6, 8: 1e-15}
    for dtype in (np.complex64, np.float32, np.complex128, np.float64):
        plan = _plan(dtype, SHAPE_3D, 4, 1.5)
        gen = torch.Generator(device="cuda").manual_seed(seed + 16)
        spec = _random_values(gen, (1,) + plan.spectral_shape_over, plan.complex_dtype, "cuda")
        uhat = _random_values(gen, (1,) + plan.spectral_shape, plan.complex_dtype, "cuda")
        args1 = (plan.index_ranges, plan.phihat_inv, plan.normfactor)
        args2 = (plan.spectral_shape_over, plan.index_ranges, plan.phihat_inv)
        esize = spec.element_size()
        modes, over = math.prod(plan.spectral_shape), math.prod(plan.spectral_shape_over)
        pairs = {
            "truncate": (lambda: deconvolve.deconvolve_truncate(spec, *args1),
                         lambda: deconvolve.deconvolve_truncate_plain(spec, *args1),
                         2 * modes * esize),
            "pad": (lambda: deconvolve.deconvolve_pad(uhat, *args2),
                    lambda: deconvolve.deconvolve_pad_plain(uhat, *args2),
                    (modes + over) * esize),
        }
        tol = rtol[torch.empty((), dtype=plan.real_dtype).element_size()]
        for step, (kern, plain, nbytes) in pairs.items():
            name = deconvolve_entry_points(plan)[0 if step == "truncate" else 1]
            blocked.reset_launch_counts()
            got = kern()
            torch.cuda.synchronize()
            _launched_only(name, 1, "one call")
            launches[name] += blocked.LAUNCHES[name]
            blocked.reset_launch_counts()
            p1, want = cuda_time_ms(plain)
            k1, _ = cuda_time_ms(kern)
            k2, _ = cuda_time_ms(kern)
            p2, _ = cuda_time_ms(plain)
            torch.cuda.synchronize()
            # the plain chain launches nothing; each timed kernel call one
            _launched_only(name, 2 * (REPS + 1), "the timed calls")
            launches[name] += blocked.LAUNCHES[name]
            if not got.is_contiguous() or got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name}: output {tuple(got.shape)} {got.dtype}, "
                                     f"contiguous {got.is_contiguous()}")
            err = rel_l2(got, want)
            diff, nz = (got - want).abs(), want != 0
            max_rel = float((diff[nz] / want.abs()[nz]).max())
            if bool((diff[~nz] != 0).any()):
                raise AssertionError(f"{name}: a zero of the plain version is not zero")
            equal = bool(torch.equal(got, want))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            log(f"  {name} {tuple(want.shape)}: bit-equal {equal}, rel L2 {err:.3e}, max rel {max_rel:.3e}, "
                f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB, {100 * bound_ms / ms:.1f}% of it)")
            check(f"{name} max rel vs plain", max_rel, tol)
            compared[name] = dict(max_abs_err=float((got - want).abs().max()), rel_l2=err,
                                  ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                                  bit_equal=equal)
            del got, want, diff, nz
        blocked.reset_launch_counts()
        copy = deconvolve.pad_modes(uhat, plan.spectral_shape_over, plan.index_ranges)
        torch.cuda.synchronize()
        pad_name = deconvolve_entry_points(plan)[1]
        _launched_only(pad_name, 1, "the unscaled pad")
        launches[pad_name] += blocked.LAUNCHES[pad_name]
        if not torch.equal(copy, deconvolve.pad_modes_plain(uhat, plan.spectral_shape_over,
                                                            plan.index_ranges)):
            raise AssertionError(f"{np.dtype(dtype).name}: the unscaled pad is not a copy")
        log(f"  {np.dtype(dtype).name}: the unscaled pad equals the plain padding bit for bit")
        del spec, uhat, copy, plan
        torch.cuda.empty_cache()
    return launches, compared


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not (ROOT / "nonuniformffts_tpu_torch" / "__init__.py").exists():
        raise SystemExit(f"nonuniformffts_tpu_torch not found beside {__file__}")
    sys.path.insert(0, str(ROOT))

    import torch

    t0 = time.perf_counter()
    phase_environment()
    phase_build()
    phase_kernels(args.seed)
    launches, compared = collections.Counter(), {}
    windows = collections.defaultdict(dict)

    def record(result):
        launches.update(result[0])
        compared.update(result[1])

    log(f"== phase 4: main path, N = {shape_text(SHAPE_3D)}, m = 4, sigma = 1.5, complex64")
    record(main_path("3D complex64", np.complex64, SHAPE_3D, NP_MAIN, NP_MAIN[0],
                     args.seed, diagnose_at=NP_MAIN[1]))
    phase_accuracy_64(args.seed)
    log(f"== phase 6: 64-bit main path, N = {shape_text(SHAPE_3D)}, m = 4, sigma = 1.5")
    for dtype in (np.complex128, np.float64):
        record(main_path(f"3D {np.dtype(dtype).name}", dtype, SHAPE_3D, NP_64, NP_64[0],
                         args.seed))
    log(f"== phase 7: float32 real main path, N = {shape_text(SHAPE_3D)}, m = 4, sigma = 1.5")
    record(main_path("3D float32", np.float32, SHAPE_3D, NP_MAIN, NP_MAIN[0], args.seed))
    for phase, shape in ((8, SHAPE_2D), (9, SHAPE_1D)):
        log(f"== phase {phase}: {len(shape)}D main path, N = {shape_text(shape)}, "
            f"m = 4, sigma = 1.5, four dtypes")
        for dtype in (np.complex64, np.float32, np.complex128, np.float64):
            nps = NP_1D if len(shape) == 1 else (
                NP_64 if dtype in (np.complex128, np.float64) else NP_MAIN)
            record(main_path(f"{len(shape)}D {np.dtype(dtype).name}", dtype, shape, nps,
                             nps[0], args.seed,
                             check_np=nps[-1]))
    phase_windows(args.seed, record, windows)
    phase_m10(args.seed, record, windows)
    phase_nfft(args.seed, record)
    phase_parallel(args.seed, record, compared)
    log(f"== phase 14: timer, callbacks, direct NUDFT, chunked plans, "
        f"N = {shape_text(SHAPE_3D)} and {shape_text(SHAPE_1D)}")
    phase_plan_surface(args.seed, record)
    log(f"== phase 15: many transforms, N = {shape_text(SHAPE_3D)}, m = 4, sigma = 1.5 and 2, "
        f"{NT_NP:,} points")
    transforms = collections.defaultdict(dict)
    phase_ntransforms(args.seed, record, transforms)
    record(phase_deconvolve(args.seed))

    # K3's headline numbers: KB Direct at 1M points in phase 10 (float32
    # taps from complex64, float64 from complex128).
    for name in ("nufft_window_weights_f32", "nufft_window_weights_f64"):
        compared[name] = windows[name]["KB Direct, m=4"]
    # The set_points kernels' headline numbers: the first 3D row.
    for name, rows in SET_POINTS_ROWS.items():
        compared[name] = dict(next(r for lbl, r in rows.items() if lbl.startswith("3D")),
                              rows=rows)
    missing = sorted(set(KERNELS) - set(compared))
    if missing:
        raise AssertionError(f"kernels not compared with their plain versions: {missing}")
    kernels = [
        dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
             max_abs_err=compared[name]["max_abs_err"], rel_l2=compared[name]["rel_l2"],
             ms=compared[name]["ms"], plain_ms=compared[name]["plain_ms"],
             bound_ms=compared[name]["bound_ms"], bound_by=compared[name]["bound_by"],
             library_ms=compared[name].get("library_ms"),
             windows={mode: {k: res[k] for k in ("rel_l2", "ms", "plain_ms", "bound_ms")}
                      for mode, res in sorted(windows[name].items())},
             **({"shapes": compared[name]["shapes"]} if "shapes" in compared[name] else {}),
             **({"rows": compared[name]["rows"]} if "rows" in compared[name] else {}),
             **({"bit_equal": compared[name]["bit_equal"]}
                if "bit_equal" in compared[name] else {}),
             **({"transforms": transforms[name]} if name in transforms else {}))
        for name in KERNELS
    ]
    log(f"run time {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
