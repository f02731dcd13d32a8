#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Phases, in order; the first failure raises and the script exits non-zero:

1. environment: torch and CUDA versions, nvcc, Triton, the card's name and
   power limit; requires ``torch.cuda.is_available()``;
2. build: compiles the CUDA kernels from ``nonuniformffts_tpu_torch/csrc``
   (one nvcc per source, dimension and value type, all at once), prints each
   kernel's registers and spills from ``ptxas -v`` and the atomic
   instructions its SASS holds (``cuobjdump -sass``);
3. the 3D complex64 kernels against their plain PyTorch versions on the
   card: a 64^3 plan (grid 96^3), 200,000 uniform points;
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
   complex128 and float64 at 1,677,722 and 16,777,216;
9. the 1D main path, N = 2^20 (grid 1,572,864), m = 4, sigma = 1.5, all four
   dtypes at Np = 1,000,000 and 10,000,000;
10. every window at the full 3D width: N = 256^3, m = 4, sigma = 2 (grid
    512^3), complex64 and complex128 at Np = 1,000,000 and 16,777,216, for
    BKB Fast (the yardstick at this sigma), KB Fast and Direct, BKB
    Direct, Gaussian Fast and Direct and the B-spline, measured as in
    phase 4; then the same windows on the 2D (4096^2, 16,777,216 points)
    and 1D (2^20, 10,000,000 points) complex64 main paths at sigma = 2;
11. m = 10 for every dtype, dimension and window in both modes: 32^3, 128^2
    and 4096 (sigma = 2), 50,000 points; each kernel against its plain
    version (timed), err1 / err2 against exact sums;
12. the NFFT adapter at full width: ``plan_nfft`` in 3D at N = 256^3,
    16,777,216 points in [-1/2, 1/2)^3, complex128, the default reltol 1e-9
    (m = 6, sigma = 2), windows kaiser_bessel, gauss and spline: forward and
    adjoint times, and their errors against exact NFFT-convention sums at
    4,096 points and 64 modes.

Each main-path row sets every launch count to 0 just before it drives the
path and reads the counts just after; a kernel of the path that was not
launched fails the run.  At the smaller Np of each dtype and dimension
every kernel is held against its plain version and timed.  The
float32-accumulation diagnostic (ROADMAP queue 3, P2) re-spreads the
complex64 rho = 1 row's own float32 values and fractions, widened to
float64, with the float64 kernel and a Z2Z FFT, and prints that err1 beside
the float32 err1 of three calls.  The line before the last is one JSON
object with each of the 26 kernel entry points (24 spread and
interpolation, two window-weights): launches on its main path, its error
against its plain version, both times, the least time the card could take
for the same work (``bound_ms``) and what bounds it, and a ``windows`` map
with the same numbers under each window mode and m of phases 10-11; the
last line is ``{"ok": true, "device": {...}}``.

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
}
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
    """``spread_3d<M=4, double, 2>`` or ``window_weights<M=4, double>`` from
    a mangled kernel name."""
    m = re.search(r"(spread|interp)_(\d)d_kernelILi(\d+)E([fd])Li(\d)E(Lb1E)?", mangled)
    if m:
        return (f"{m[1]}_{m[2]}d<M={m[3]}, {'float' if m[4] == 'f' else 'double'}, {m[5]}"
                + (", taps>" if m[6] else ">"))
    m = re.search(r"window_weights_kernelILi(\d+)E([fd])E", mangled)
    if m:
        return f"window_weights<M={m[1]}, {'float' if m[2] == 'f' else 'double'}>"
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
    """The atomic instructions of each kernel's SASS: a shared-memory add
    compiled to a compare-and-swap loop shows as ATOMS.CAST.SPIN."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("  cuobjdump: not found, SASS not read")
        return
    sass = run([tool, "-sass", str(lib_path)])
    for part in re.split(r"\n\s+Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        ops = collections.Counter(re.findall(r"\b((?:ATOMS|ATOMG|REDG|RED|ATOM)\.[A-Z0-9.]+)", body))
        log(f"  sass {_kernel_label(name.strip())}: "
            + (", ".join(f"{k} x{v}" for k, v in sorted(ops.items())) or "no atomics"))


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
    the taps).  A spread or interpolation wrapper of a window without
    coefficients launches K3 first: its taps are counted as operations, the
    intermediate taps as no bytes.  Returns (ms, 'bytes' or 'operations')."""
    from nonuniformffts_tpu_torch.blocking import num_blocks
    from nonuniformffts_tpu_torch.ops.kernels.blocked import kernel_coefs
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    _, sb, ncomp = VALUE_TYPES[plan.dtype]
    D = plan.ndim
    S, np_ = 2 * plan.m, plan.num_points
    ncoef = kernel_coefs(plan)[1]
    vol = math.prod(plan.shape_over)
    nblocks = math.prod(num_blocks(plan.shape_over, plan.block_dims))
    # cells, fracs, perm, coefs
    state = np_ * (D * 4 + D * sb + 8) + D * S * ncoef * sb
    horner = D * S * tap_ops(plan)  # the taps, per point
    if kind == "weights":
        nbytes = np_ * D * sb + np_ * D * S * sb
        ops = np_ * horner
    elif kind == "spread":
        nbytes = C * np_ * ncomp * sb + state + (nblocks + 1) * 4 + C * vol * ncomp * sb
        ops = np_ * (horner + C * _SPREAD_OPS[D](S, ncomp))
    else:
        nbytes = C * vol * ncomp * sb + state + C * np_ * ncomp * sb
        ops = np_ * (horner + C * ncomp * 2 * sum(S ** i for i in range(D + 1)))
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


def phase_kernels(seed: int):
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch.ops.kernels import blocked

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


# ---------------------------------------------------------------------------
# Accuracy oracles (exact float64 sums), after bench.py
# ---------------------------------------------------------------------------


def _err1(pts, v, uhat, shape, real: bool, seed: int, modes: int = ERR_MODES) -> float:
    """Type-1 output against exact float64 sums at ``modes`` random modes,
    computed on the card in point chunks (bench.py:measure_t1_error).  Real plans store
    k = 0..+N/2 on the halved LAST axis: the Nyquist index is POSITIVE there
    (bench.py:336-347), while the full axes fold index N/2 to -N/2."""
    import torch

    D = len(shape)
    rng = np.random.default_rng(seed + 7)
    kidx = np.stack([rng.integers(0, n, modes) for n in shape], axis=1)
    if real:
        kidx[:, -1] = rng.integers(0, shape[-1] // 2 + 1, modes)
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


def _plan(dtype, shape, m: int, sigma: float, window=MAIN_WINDOW, **kw):
    import torch

    import nonuniformffts_tpu_torch as nufft

    return nufft.PlanNUFFT(
        dtype, shape, m=m, sigma=sigma,
        kernel=getattr(nufft, window[0])(),
        kernel_evalmode=getattr(nufft, window[1])(),
        spread_method="blocked", device=torch.device("cuda"), **kw,
    )


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
              err_tol: float = ERR_TOL, err_modes: int = ERR_MODES):
    """Drive one dtype's main path at ``shape``, ``m``, ``sigma`` and
    ``window`` (kernel class and evaluation mode names; BKB
    FastApproximation, m = 4, sigma = 1.5 by default) for each Np, holding
    err1 (at ``err_modes`` random modes) and err2 to ``err_tol``; returns (launches summed over the rows,
    kernel comparisons at ``compare_np``).  At Np = ``diagnose_at`` also
    runs ``float32_accumulation_diagnostic``."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    dev = torch.device("cuda")
    D = len(shape)
    plan0 = _plan(dtype, shape, m, sigma, window)
    names = entry_points(plan0)
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
        rows.append(row)
        if np_ == compare_np:
            log("  kernels against their plain versions at this shape:")
            grid = _random_values(gen, (1,) + plan.shape_over, plan.dtype, dev)
            compared = compare_kernels(plan, vp_c, grid, timed=True)
            del grid
        del plan, pts, vp, vp_c
        torch.cuda.empty_cache()
    log("  results " + json.dumps(rows))
    return launches, compared


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
    points) and 1D (2^20, 10M points) complex64 main paths at sigma = 2.
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
                             err_modes=1024))


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
        record((counts, {}))
        e_fwd = rel_l2(fx[sel], exact_fwd)
        e_adj = rel_l2(fh[tuple(torch.as_tensor(kidx[:, d], device=dev) for d in range(3))],
                       exact_adj)
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
                         forward_err=e_fwd, adjoint_err=e_adj, launches=counts))
        del plan, fx, fh
        torch.cuda.empty_cache()
    log("  results " + json.dumps(rows))


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

    def shape_text(shape):
        return "x".join(map(str, shape))

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
                             nps[0], args.seed))
    phase_windows(args.seed, record, windows)
    phase_m10(args.seed, record, windows)
    phase_nfft(args.seed, record)

    # K3's headline numbers: KB Direct at 1M points in phase 10 (float32
    # taps from complex64, float64 from complex128).
    for name in ("nufft_window_weights_f32", "nufft_window_weights_f64"):
        compared[name] = windows[name]["KB Direct, m=4"]
    missing = sorted(set(KERNELS) - set(compared))
    if missing:
        raise AssertionError(f"kernels not compared with their plain versions: {missing}")
    kernels = [
        dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
             max_abs_err=compared[name]["max_abs_err"], rel_l2=compared[name]["rel_l2"],
             ms=compared[name]["ms"], plain_ms=compared[name]["plain_ms"],
             bound_ms=compared[name]["bound_ms"], bound_by=compared[name]["bound_by"],
             library_ms=None,
             windows={mode: {k: res[k] for k in ("rel_l2", "ms", "plain_ms", "bound_ms")}
                      for mode, res in sorted(windows[name].items())})
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
