#!/usr/bin/env python3
"""Time the spread kernel over block geometries on one NVIDIA GPU.

    python3 chip_probe.py [--seed S] [--dim D ...] [--np N ...] [--dtype T ...]

For each dimension (3: N = 256^3, grid 384^3; 2: N = 4096^2, grid 6144^2;
1: N = 2^20, grid 1,572,864), dtype (complex64, complex128, float32,
float64) and point count, at m = 4, sigma = 1.5, uniform random points, the
script times the spread kernel (``ops/kernels/blocked.spread_blocked``, CUDA
events, median of 5 after one warm-up) at the geometry
``blocking.choose_geometry`` picks and at a few others, in the order listed
and then in reverse, and prints one JSON line per dimension, dtype and Np
with the mean of the two passes for each geometry.  It measures what the
chooser's cost model predicts.

In 1D it also times, on the same sorted points, the mapping the library's
1D kernel (``csrc/spread_1d.cu``, a thread per padded cell summing in
registers) replaced: a shared-memory accumulator with the warp's lanes over
(point, tap) pairs, 32 / 2M points a step, adding with ``atomicAdd``.  That
kernel is written below, built by this script with nvcc into
``build/chip_probe/`` and used nowhere else; ``"scatter_ms"`` in the JSON
line.  Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SHAPES = {3: (256,) * 3, 2: (4096, 4096), 1: (1 << 20,)}
DEFAULT_NP = {3: (1_677_722, 16_777_216), 2: (1_000_000, 16_777_216),
              1: (1_000_000, 10_000_000)}
GEOMETRIES = {
    3: ((12, 12, 16), (12, 24, 24), (24, 24, 12), (8, 16, 16), (16, 16, 16),
        (8, 8, 12), (8, 8, 8), (6, 8, 8), (8, 12, 12)),
    2: ((48, 96), (64, 96), (48, 64), (64, 64), (32, 128), (96, 128), (128, 128),
        (32, 64), (16, 128)),
    1: ((256,), (512,), (1024,), (2048,), (3072,), (4096,), (8192,), (16384,)),
}

# The 1D scatter mapping, complex or real values of float or double, M = 4,
# summing in double as the library's kernels do.
_SCATTER_SRC = r"""
#include <cuda_runtime.h>
template <typename T> __device__ T horner(const T* c, int n, T z) {
  T v = c[n - 1];
  for (int q = n - 2; q >= 0; --q) v = v * z + c[q];
  return v;
}
template <typename T, int NCOMP>
__global__ void __launch_bounds__(512) scatter_1d(
    const T* vals, const int* cells, const T* fracs, const int* pstarts,
    const T* coefs, T* grid, int ncoef, int n0, int b0) {
  constexpr int M = 4, S = 2 * M, PER = 32 / S;
  extern __shared__ __align__(16) unsigned char raw[];
  const int bid = blockIdx.x, p0 = pstarts[bid], p1 = pstarts[bid + 1];
  if (p0 == p1) return;
  const int pd = b0 + S - 1, ox = bid * b0, tid = threadIdx.x;
  double* acc = reinterpret_cast<double*>(raw);
  T* cs = reinterpret_cast<T*>(acc + NCOMP * pd);
  for (int i = tid; i < S * ncoef; i += blockDim.x) cs[i] = coefs[i];
  for (int i = tid; i < NCOMP * pd; i += blockDim.x) acc[i] = 0.0;
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int p = lane / S, t = lane % S;
  for (int j = p0 + warp * PER + p; j - p < p1; j += nwarps * PER) {
    if (j < p1) {
      const T w = horner(cs + t * ncoef, ncoef, T(2) * fracs[j] - T(1));
      const int idx = cells[j] - ox + t;
      for (int k = 0; k < NCOMP; ++k)
        atomicAdd(acc + k * pd + idx, double(vals[NCOMP * j + k] * w));
    }
  }
  __syncthreads();
  for (int i = tid; i < pd; i += blockDim.x) {
    int g = ox - (M - 1) + i;
    g = g < 0 ? g + n0 : (g >= n0 ? g - n0 : g);
    for (int k = 0; k < NCOMP; ++k)
      if (acc[k * pd + i] != 0.0) atomicAdd(grid + NCOMP * g + k, T(acc[k * pd + i]));
  }
}
#define ENTRY(NAME, T, NCOMP)                                                     \
  extern "C" int NAME(const void* v, const void* c, const void* f, const void* ps, \
                      const void* cf, void* g, int ncoef, int n0, int b0, void* s) { \
    const size_t smem = sizeof(double) * NCOMP * (b0 + 7) + sizeof(T) * 8 * ncoef; \
    cudaFuncSetAttribute(scatter_1d<T, NCOMP>,                                    \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
    scatter_1d<T, NCOMP><<<n0 / b0, 512, smem, (cudaStream_t)s>>>(                 \
        (const T*)v, (const int*)c, (const T*)f, (const int*)ps, (const T*)cf,    \
        (T*)g, ncoef, n0, b0);                                                    \
    return (int)cudaGetLastError();                                               \
  }
ENTRY(scatter_f32, float, 2)
ENTRY(scatter_f64, double, 2)
ENTRY(scatter_real_f32, float, 1)
ENTRY(scatter_real_f64, double, 1)
"""


def _scatter_library():
    from nonuniformffts_tpu_torch.ops.kernels import build

    out = ROOT / "build" / "chip_probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "scatter_1d.cu", out / "libscatter_1d.so"
    src.write_text(_SCATTER_SRC)
    subprocess.run([build._nvcc(), *build.ARCH_FLAGS, "-O3", "-std=c++17", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def _scatter(lib, plan, vp):
    """The probe's 1D scatter kernel on the plan's sorted state (M = 4, one
    transform); returns the grid."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    fn = getattr(lib, "scatter_" + VALUE_TYPES[plan.dtype][0])
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 6 + [I, I, I, P]
    vals = vp[:, plan.sort_perm].contiguous()
    grid = torch.zeros((1,) + plan.shape_over, dtype=vp.dtype, device=vp.device)
    err = fn(vals.data_ptr(), plan.cells_sorted.data_ptr(), plan.fracs_sorted.data_ptr(),
             plan.pstarts.data_ptr(), plan.coefs.data_ptr(), grid.data_ptr(),
             plan.coefs.shape[-1], plan.shape_over[0], plan.block_dims[0],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"scatter_1d launch failed: cudaError {err}")
    return grid


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dim", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--np", type=int, nargs="+", default=None)
    parser.add_argument("--dtype", nargs="+",
                        default=["complex64", "complex128", "float32", "float64"])
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this script needs a GPU")

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, nvidia_smi_line, rel_l2
    from nonuniformffts_tpu_torch.ops.kernels import blocked
    from nonuniformffts_tpu_torch.ops.kernels.common import (
        MAX_SMEM_BYTES,
        VALUE_TYPES,
        spread_smem_bytes,
    )

    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    scatter_lib = _scatter_library() if 1 in args.dim else None
    for D in args.dim:
        shape = SHAPES[D]
        for name in args.dtype:
            dtype = np.dtype(name)
            plan0 = nufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5,
                                    spread_method="blocked", device=dev)
            _, sb, ncomp = VALUE_TYPES[plan0.dtype]
            dims = [plan0.block_dims] + [
                g for g in GEOMETRIES[D] if g != plan0.block_dims
                and all(n % b == 0 for n, b in zip(plan0.shape_over, g))
                and spread_smem_bytes(g, 4, 8, sb, ncomp) <= MAX_SMEM_BYTES
            ]
            for np_ in args.np or DEFAULT_NP[D]:
                gen = torch.Generator(device=dev).manual_seed(args.seed + np_)
                pts = torch.rand((D, np_), generator=gen, device=dev,
                                 dtype=plan0.real_dtype) * (2 * math.pi)
                vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
                times = {g: [] for g in dims}
                scatter = {g: [] for g in dims} if D == 1 else None
                for order in (dims, dims[::-1]):
                    for g in order:
                        plan = nufft.set_points(dataclasses.replace(plan0, block_dims=g), pts)
                        ms, out = cuda_time_ms(lambda: blocked.spread_blocked(plan, vp))
                        times[g].append(ms)
                        if scatter is not None and (g[0] + 7) * ncomp * 8 <= MAX_SMEM_BYTES:
                            ms, alt = cuda_time_ms(lambda: _scatter(scatter_lib, plan, vp))
                            scatter[g].append(ms)
                            err = rel_l2(alt, out)
                            if not err <= (1e-5 if sb == 4 else 1e-12):
                                raise AssertionError(f"scatter_1d disagrees: {err:.3e}")
                        del plan, out
                        torch.cuda.empty_cache()
                line = {
                    "dim": D, "dtype": name, "np": np_, "chosen": list(plan0.block_dims),
                    "spread_ms": {"x".join(map(str, g)): sum(t) / len(t)
                                  for g, t in times.items()},
                }
                if scatter is not None:
                    line["scatter_ms"] = {"x".join(map(str, g)): sum(t) / len(t)
                                          for g, t in scatter.items() if t}
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
