#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Phases, in order; the first failure raises and the script exits non-zero:

1. environment: torch and CUDA versions, nvcc, Triton, the card's name and
   power limit; requires ``torch.cuda.is_available()``;
2. build: compiles the CUDA kernels from ``nonuniformffts_tpu_torch/csrc``;
3. kernels against their plain PyTorch versions on the card: a 64^3 plan
   (grid 96^3), 200,000 uniform points, complex64;
4. the main path at full size: N = 256^3, m = 4, sigma = 1.5, backwards
   Kaiser-Bessel, FastApproximation, complex64, ``spread_method='blocked'``,
   for Np = 1,000,000 and Np = 16,777,216: ``set_points`` ->
   ``exec_type1`` -> ``exec_type2``, stage times (CUDA events, median of 5
   after one warm-up), accuracy against exact float64 sums, launch counts;
   at 1M also each kernel against its plain version, checked and timed.

The line before the last is one JSON object with each kernel's launches on
the main path, its max abs error against the plain version and both times;
the last line is ``{"ok": true, "device": {...}}``.

Tolerances: kernels against plain versions <= 1e-5 relative L2 (float32
atomics add in a run-dependent order; ~1e-7 expected); transform errors
err1, err2 <= 1e-5 (the f32 pipeline's accuracy at this operating point is
about 1.5e-6).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNEL_TOL = 1e-5
ERR_TOL = 1e-5
N_MAIN = 256
NP_MAIN = (1_000_000, 16_777_216)
REPS = 5
ERR_MODES = 64
ERR_POINTS = 4096
PLAIN_CHUNK = 1 << 16
KERNELS = {
    "nufft_spread_3d_f32": dict(
        source="nonuniformffts_tpu_torch/csrc/spread_3d.cu",
        replaces="nonuniformffts_tpu/ops/pallas/blocked.py:639",
    ),
    "nufft_interp_3d_f32": dict(
        source="nonuniformffts_tpu_torch/csrc/interp_3d.cu",
        replaces="nonuniformffts_tpu/ops/pallas/blocked.py:1393",
    ),
}


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


def phase_build():
    from nonuniformffts_tpu_torch.ops.kernels import build

    log("== phase 2: build")
    t0 = time.perf_counter()
    path = build.build(ptxas_verbose=True)
    build.load()
    log(f"built and loaded {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")


def _uniform_points(gen, np_: int, device):
    import torch

    return torch.rand((3, np_), generator=gen, device=device) * (2 * math.pi)


def _complex_normal(gen, shape, device):
    import torch

    return torch.randn(shape, generator=gen, device=device, dtype=torch.complex64)


def compare_kernels(plan, vp, grid, timed: bool):
    """K1 and K2 against their plain versions on the same inputs."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import blocked

    plain = dataclasses.replace(plan, chunk_size=PLAIN_CHUNK)
    pairs = {
        "nufft_spread_3d_f32": (lambda: blocked.spread_blocked(plan, vp),
                                lambda: blocked.spread_blocked_plain(plain, vp)),
        "nufft_interp_3d_f32": (lambda: blocked.interpolate_blocked(plan, grid),
                                lambda: blocked.interpolate_blocked_plain(plain, grid)),
    }
    results = {}
    for name, (kern, ref) in pairs.items():
        if timed:  # in turns: plain, kernel, kernel, plain
            p1, want = cuda_time_ms(ref, reps=3)
            k1, got = cuda_time_ms(kern)
            k2, _ = cuda_time_ms(kern)
            p2, _ = cuda_time_ms(ref, reps=3)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        else:
            got, want = kern(), ref()
            ms = plain_ms = None
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        max_abs = float((got - want).abs().max())
        log(f"  {name}: rel L2 {err:.3e}, max abs {max_abs:.3e}"
            + (f", kernel {ms:.3f} ms, plain {plain_ms:.3f} ms" if timed else ""))
        check(f"{name} rel L2 vs plain", err, KERNEL_TOL)
        results[name] = dict(max_abs_err=max_abs, rel_l2=err, ms=ms, plain_ms=plain_ms)
    return results


def phase_kernels(seed: int):
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    log("== phase 3: kernels against their plain versions (64^3, 200,000 points)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    plan = nufft.PlanNUFFT(np.complex64, (64, 64, 64), m=4, sigma=1.5,
                           spread_method="blocked", device=dev)
    plan = nufft.set_points(plan, _uniform_points(gen, 200_000, dev))
    log(f"  grid {plan.shape_over}, block_dims {plan.block_dims}")
    vp = _complex_normal(gen, (1, 200_000), dev)
    grid = _complex_normal(gen, (1,) + plan.shape_over, dev)
    blocked.reset_launch_counts()
    compare_kernels(plan, vp, grid, timed=False)
    log(f"  launches {blocked.LAUNCHES}")
    if min(blocked.LAUNCHES.values()) < 1:
        raise AssertionError("a kernel was not launched in phase 3")


def _err1(pts, vp, uhat, seed: int) -> float:
    """Type-1 output against exact float64 sums at random modes, computed on
    the card in point chunks (the oracle of bench.py:measure_t1_error)."""
    import torch

    N = N_MAIN
    rng = np.random.default_rng(seed + 7)
    kidx = rng.integers(0, N, (ERR_MODES, 3))
    kval = np.where(kidx >= (N + 1) // 2, kidx - N, kidx).astype(np.float64)
    k = torch.as_tensor(kval, device=pts.device)
    v = vp[0].to(torch.complex128)
    exact = torch.zeros(ERR_MODES, dtype=torch.complex128, device=pts.device)
    for s in range(0, pts.shape[1], 1 << 20):
        ph = k @ pts[:, s : s + (1 << 20)].to(torch.float64)
        exact += torch.exp(-1j * ph) @ v[s : s + (1 << 20)]
    ki = torch.as_tensor(kidx, device=uhat.device)
    got = uhat[ki[:, 0], ki[:, 1], ki[:, 2]].to(torch.complex128)
    return rel_l2(got, exact)


def _rank1_spectrum(seed: int):
    rng = np.random.default_rng(seed + 8)
    N = N_MAIN
    return [(rng.standard_normal(N) + 1j * rng.standard_normal(N)) / N
            for _ in range(3)]


def _err2(pts, v2, a, seed: int) -> float:
    """Type-2 output for the rank-1 spectrum a0 x a1 x a2, whose exact values
    are products of 1D sums (bench.py:measure_t2_error)."""
    sel = np.random.default_rng(seed + 9).integers(0, pts.shape[1], ERR_POINTS)
    x = pts[:, sel].double().cpu().numpy()
    kval = np.fft.fftfreq(N_MAIN, 1.0 / N_MAIN)
    exact = np.ones(ERR_POINTS, np.complex128)
    for d in range(3):
        exact *= np.exp(1j * np.outer(x[d], kval)) @ a[d]
    got = v2[sel].cpu().numpy().astype(np.complex128)
    return float(np.linalg.norm(got - exact) / np.linalg.norm(exact))


def phase_main(seed: int, np_list):
    import torch

    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    log(f"== phase 4: main path, N = {N_MAIN}^3, m = 4, sigma = 1.5, complex64")
    dev = torch.device("cuda")
    plan0 = nufft.PlanNUFFT(
        np.complex64, (N_MAIN,) * 3, m=4, sigma=1.5,
        kernel=nufft.BackwardsKaiserBesselKernel(),
        kernel_evalmode=nufft.FastApproximation(),
        spread_method="blocked", device=dev,
    )
    log(f"  grid {plan0.shape_over}, block_dims {plan0.block_dims}")
    a = _rank1_spectrum(seed)
    u_rank1 = torch.as_tensor(
        np.einsum("a,b,c->abc", *a).astype(np.complex64), device=dev
    )
    launches = dict.fromkeys(KERNELS, 0)
    compared = {}
    rows = []
    for np_ in np_list:
        gen = torch.Generator(device=dev).manual_seed(seed + np_)
        pts = _uniform_points(gen, np_, dev)
        vp = _complex_normal(gen, (np_,), dev)
        torch.cuda.synchronize()

        blocked.reset_launch_counts()
        t_set, plan = cuda_time_ms(lambda: nufft.set_points(plan0, pts))
        t_t1, uhat = cuda_time_ms(lambda: nufft.exec_type1(plan, vp))
        t_t2, v2 = cuda_time_ms(lambda: nufft.exec_type2(plan, u_rank1))
        vp_c = vp[None]
        stages = {}
        stages["t1 spread"], g = cuda_time_ms(lambda: ex.t1_spread_stage(plan, vp_c))
        stages["t1 fft"], spec = cuda_time_ms(lambda: ex.t1_fft_stage(plan, g))
        stages["t1 deconvolve"], _ = cuda_time_ms(lambda: ex.t1_deconv_stage(plan, spec))
        del g, spec
        stages["t2 pad"], w = cuda_time_ms(lambda: ex.t2_pad_stage(plan, u_rank1[None]))
        stages["t2 fft"], gr = cuda_time_ms(lambda: ex.t2_fft_stage(plan, w))
        stages["t2 interp"], _ = cuda_time_ms(lambda: ex.t2_interp_stage(plan, gr))
        del w, gr
        torch.cuda.synchronize()
        counts = dict(blocked.LAUNCHES)
        for name in KERNELS:
            launches[name] += counts[name]

        log(f"  Np = {np_:,}: launches {counts}")
        if min(counts.values()) < 1:
            raise AssertionError("a kernel of the main path was not launched")
        if tuple(uhat.shape) != (N_MAIN,) * 3 or tuple(v2.shape) != (np_,):
            raise AssertionError(f"output shapes {tuple(uhat.shape)}, {tuple(v2.shape)}")
        if not (torch.isfinite(torch.view_as_real(uhat)).all()
                and torch.isfinite(torch.view_as_real(v2)).all()):
            raise AssertionError("non-finite output")
        log(f"  set_points {t_set:.3f} ms, exec_type1 {t_t1:.3f} ms, "
            f"exec_type2 {t_t2:.3f} ms")
        log("  stages: " + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
        e1 = _err1(pts, vp[None], uhat, seed)
        e2 = _err2(pts, v2, a, seed)
        check(f"err1 (Np={np_})", e1, ERR_TOL)
        check(f"err2 (Np={np_})", e2, ERR_TOL)
        rows.append(dict(np=np_, set_points_ms=t_set, exec_type1_ms=t_t1,
                         exec_type2_ms=t_t2, stages_ms=stages, err1=e1, err2=e2,
                         launches=counts))
        if np_ == NP_MAIN[0]:
            log("  kernels against their plain versions at this shape:")
            grid = _complex_normal(gen, (1,) + plan.shape_over, dev)
            compared = compare_kernels(plan, vp_c, grid, timed=True)
            del grid
        del plan, uhat, v2, pts, vp, vp_c
        torch.cuda.empty_cache()
    log("  results " + json.dumps(rows))
    return launches, compared


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not (ROOT / "nonuniformffts_tpu_torch" / "__init__.py").exists():
        raise SystemExit(f"nonuniformffts_tpu_torch not found beside {__file__}")
    sys.path.insert(0, str(ROOT))

    import torch

    phase_environment()
    phase_build()
    phase_kernels(args.seed)
    launches, compared = phase_main(args.seed, NP_MAIN)
    kernels = [
        dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
             max_abs_err=compared[name]["max_abs_err"], ms=compared[name]["ms"],
             plain_ms=compared[name]["plain_ms"])
        for name in KERNELS
    ]
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
