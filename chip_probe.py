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

    python3 chip_probe.py --gloo

instead asks which ``torch.distributed`` calls the gloo backend runs on CUDA
tensors: two gloo ranks on cuda:0 try each call on CUDA tensors and print
whether it ran and gave the right values, or the error it raised
(``nonuniformffts_tpu_torch/parallel/comm.py:GLOO_CUDA_OPS`` is read from
it; the library itself decides by the backend's name, never by an error).

    python3 chip_probe.py --relayout

instead times the relayout kernels K8a / K8b (``csrc/relayout.cu``) as
variants of their design: the source built with one tunable changed
(``-D`` flags, ``RELAYOUT_VARIANTS``: no L2 policy, other stage counts,
chunk sizes and CTAs an SM, the register path on the long runs; through
``build.py:build_variants``), and the element kernel that the run design
replaced (written below, built into ``build/chip_probe/``).  Each is
launched raw (output preallocated, 50 launches back to back over three
input buffers, two passes) at phase 13's pack and all_gather unpack
shapes, complex64 and complex128, beside PyTorch's copy
(``reshape.permute.contiguous``) before and after them, and held equal to
the plain version.  Then one call (CUDA events, median of 20) and the host
time of one call go through the shipped wrapper and through the first
design's wrapper steps with the element kernel, in turns.  First it prints
the host time of one call
(microseconds, 2,000 calls on a small tensor, the card kept busy) of the
relayout wrapper, the plain version, the library call and their parts.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import subprocess
import sys
import time
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


def _probe_library(stem: str, text: str) -> ctypes.CDLL:
    """Build the probe's own CUDA source ``text`` into ``build/chip_probe/``."""
    from nonuniformffts_tpu_torch.ops.kernels import build

    out = ROOT / "build" / "chip_probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{stem}.cu", out / f"lib{stem}.so"
    src.write_text(text)
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


GLOO_CALLS = ("all_to_all_single", "all_reduce", "all_gather", "all_gather_into_tensor",
              "broadcast", "send_recv", "batch_isend_irecv", "reduce_scatter_tensor")


def _gloo_call(call: str, rank: int) -> bool:
    """Run one torch.distributed call on CUDA tensors between two ranks;
    whether the result is right."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    base = torch.arange(8, dtype=torch.float64, device=dev)
    x, peer = base + 100 * rank, 1 - rank
    if call == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return torch.equal(out, torch.cat([base[4 * rank : 4 * rank + 4] + 100 * s
                                           for s in range(2)]))
    if call == "all_reduce":
        dist.all_reduce(x)
        return torch.equal(x, 2 * base + 100)
    if call == "all_gather":
        outs = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(outs, x)
        return all(torch.equal(o, base + 100 * s) for s, o in enumerate(outs))
    if call == "all_gather_into_tensor":
        out = torch.empty(16, dtype=x.dtype, device=dev)
        dist.all_gather_into_tensor(out, x)
        return torch.equal(out, torch.cat([base, base + 100]))
    if call == "broadcast":
        dist.broadcast(x, 0)
        return torch.equal(x, base)
    if call == "send_recv":
        if rank == 0:
            dist.send(x, 1)
            return True
        y = torch.empty_like(x)
        dist.recv(y, 0)
        return torch.equal(y, base)
    if call == "batch_isend_irecv":
        y = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                           dist.P2POp(dist.irecv, y, peer)]):
            req.wait()
        return torch.equal(y, base + 100 * peer)
    out = torch.empty(4, dtype=x.dtype, device=dev)  # reduce_scatter_tensor
    dist.reduce_scatter_tensor(out, x)
    return torch.equal(out, 2 * base[4 * rank : 4 * rank + 4] + 100)


def _gloo_rank(rank: int, call: str, rdv: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=30))
    try:
        ok = _gloo_call(call, rank)
        torch.cuda.synchronize()
        print(f"  gloo {call} rank {rank}: {'ran, right' if ok else 'ran, WRONG'}", flush=True)
    except RuntimeError as e:  # what this probe asks
        print(f"  gloo {call} rank {rank}: {type(e).__name__}: {str(e)[:160]}", flush=True)
    dist.destroy_process_group()


def probe_gloo() -> None:
    import tempfile

    import torch
    import torch.multiprocessing as mp

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for call in GLOO_CALLS:
        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.start_processes(_gloo_rank, args=(call, f"{tmp}/rendezvous"), nprocs=2,
                                     join=False, start_method="spawn")
            deadline = time.monotonic() + 90
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    print(f"  gloo {call}: no answer in 90 s", flush=True)
                    break


# K8's variants: extra nvcc flags of csrc/relayout.cu's tunables
# (NUFFT_RELAYOUT_*), built by build.py:build_variants.
_REG = "-DNUFFT_RELAYOUT_TMA_MIN_RUN_BYTES=(1LL<<40)"  # every run by registers
RELAYOUT_VARIANTS = {
    "shipped": (),
    "no L2 policy": ("-DNUFFT_RELAYOUT_L2_HINT=0",),
    "8 stages x 8 KB": ("-DNUFFT_RELAYOUT_STAGES=8", "-DNUFFT_RELAYOUT_CHUNK_BYTES=8192"),
    "3 stages x 32 KB": ("-DNUFFT_RELAYOUT_STAGES=3", "-DNUFFT_RELAYOUT_CHUNK_BYTES=32768"),
    "3 CTAs an SM": ("-DNUFFT_RELAYOUT_CTAS_PER_SM=3",),
    "1 CTA an SM, 6 x 32 KB": ("-DNUFFT_RELAYOUT_CTAS_PER_SM=1", "-DNUFFT_RELAYOUT_STAGES=6",
                               "-DNUFFT_RELAYOUT_CHUNK_BYTES=32768"),
    "1 CTA an SM, 12 x 16 KB": ("-DNUFFT_RELAYOUT_CTAS_PER_SM=1", "-DNUFFT_RELAYOUT_STAGES=12"),
    "1 CTA an SM, 3 x 64 KB": ("-DNUFFT_RELAYOUT_CTAS_PER_SM=1", "-DNUFFT_RELAYOUT_STAGES=3",
                               "-DNUFFT_RELAYOUT_CHUNK_BYTES=65536"),
    "4 CTAs an SM, 4 x 8 KB": ("-DNUFFT_RELAYOUT_CTAS_PER_SM=4", "-DNUFFT_RELAYOUT_CHUNK_BYTES=8192"),
    "register path": (_REG,),
    "register path, unroll 8": (_REG, "-DNUFFT_RELAYOUT_UNROLL=8"),
}

# The element kernel that the run design of csrc/relayout.cu replaced: a
# thread per grid column, one 8- or 16-byte value a row, both offsets
# advanced by additions over at least 8 rows.  Used nowhere else.
_ELEMENT_RELAYOUT_SRC = r"""
#include <cuda_runtime.h>
namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 65535;
// Grid rows a CTA walks at least: the divisions are paid once per CTA and
// column.
constexpr int kMinRowsPerCta = 8;

struct Geometry {
  long long rows;       // CR * N0 * N1
  int rows_per_cta;     // consecutive grid rows one CTA walks
  int n1, n2;           // grid dims 1 and 2
  int b0, b1, b2;       // block dims
  long long blk1_step;  // block-side offset of one block along dim 1: nb2 B0 B1 B2
  long long blk0_step;  // one block along dim 0: nb1 * blk1_step
};

template <typename T, bool kToGrid>
__global__ void __launch_bounds__(kThreads) relayout_kernel(
    const T* __restrict__ src, T* __restrict__ dst, const Geometry g) {
  const int g2 = blockIdx.x * kThreads + threadIdx.x;
  if (g2 >= g.n2) return;
  const long long row0 = (long long)blockIdx.y * g.rows_per_cta;
  const long long row_end = row0 + g.rows_per_cta < g.rows ? row0 + g.rows_per_cta : g.rows;
  // Row r = (c N0 + g0) N1 + g1.  Block-major offset of (c, g0, g1, g2):
  // ((c nb0 + blk0) nb1 + blk1) blk1_step + blk2 B0 B1 B2 + (l0 B1 + l1) B2
  // + l2, and (c nb0 + blk0) nb1 blk1_step = (c N0 + g0 - l0) / B0 blk0_step.
  const long long plane = row0 / g.n1;  // c N0 + g0
  int g1 = (int)(row0 - plane * g.n1);
  int l0 = (int)(plane % g.b0), l1 = g1 % g.b1;
  const int blk2 = g2 / g.b2;
  const long long sl0 = (long long)g.b1 * g.b2;
  long long blk_off = (plane - l0) / g.b0 * g.blk0_step + (g1 / g.b1) * g.blk1_step +
                      blk2 * (long long)g.b0 * sl0 + l0 * sl0 + (long long)l1 * g.b2 +
                      (g2 - blk2 * g.b2);
  long long grid_off = row0 * g.n2 + g2;
  for (long long row = row0; row < row_end; ++row) {
    if (kToGrid) dst[grid_off] = src[blk_off];
    else dst[blk_off] = src[grid_off];
    grid_off += g.n2;
    blk_off += g.b2;
    if (++l1 == g.b1) { l1 = 0; blk_off += g.blk1_step - sl0; }
    if (++g1 == g.n1) {  // next plane: back to block 0 along dim 1
      g1 = 0;
      blk_off += sl0 - g.blk0_step;
      if (++l0 == g.b0) { l0 = 0; blk_off += g.blk0_step - (long long)g.b0 * sl0; }
    }
  }
}

template <typename T, bool kToGrid>
int launch(const void* src, void* dst, int cr, int n0, int n1, int n2, int b0,
           int b1, int b2, void* stream) {
  if (cr < 0 || b0 < 1 || b1 < 1 || b2 < 1 || n0 % b0 || n1 % b1 || n2 % b2)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.rows = (long long)cr * n0 * n1;
  if (g.rows == 0 || n2 == 0) return (int)cudaSuccess;
  g.n1 = n1; g.n2 = n2;
  g.b0 = b0; g.b1 = b1; g.b2 = b2;
  g.blk1_step = (long long)(n2 / b2) * b0 * b1 * b2;
  g.blk0_step = (long long)(n1 / b1) * g.blk1_step;
  const long long need = (g.rows + kMaxRowBlocks - 1) / kMaxRowBlocks;
  g.rows_per_cta = (int)(need > kMinRowsPerCta ? need : kMinRowsPerCta);
  const dim3 grid((n2 + kThreads - 1) / kThreads,
                  (unsigned)((g.rows + g.rows_per_cta - 1) / g.rows_per_cta));
  relayout_kernel<T, kToGrid><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), g);
  return (int)cudaGetLastError();
}

}  // namespace
#define ENTRY(NAME, T, TO_GRID)                                                       \
  extern "C" int NAME(const void* src, void* dst, int cr, int n0, int n1, int n2,    \
                      int b0, int b1, int b2, void* stream) {                        \
    return launch<T, TO_GRID>(src, dst, cr, n0, n1, n2, b0, b1, b2, stream);         \
  }
ENTRY(element_to_grid_f32, float2, true)
ENTRY(element_to_blocks_f32, float2, false)
ENTRY(element_to_grid_f64, double2, true)
ENTRY(element_to_blocks_f64, double2, false)
"""


def _first_design_call(lib, direction: str, x, bd):
    """One relayout through the steps of the first design's wrapper: shape
    checks, a new output, the device context, the entry point looked up and
    the current stream's object on every call, then the element kernel."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import relayout

    D = len(bd)
    if direction == "blocks":
        relayout._check_dims(bd, x.shape[1:], "grid")
        grid_shape = tuple(x.shape)
        out_shape = grid_shape[:1] + tuple(n // b for n, b in zip(x.shape[1:], bd)) + tuple(bd)
    else:
        relayout._check_dims(bd, x.shape[1 + D:], "block")
        grid_shape = (x.shape[0],) + tuple(n * b for n, b in zip(x.shape[1 : 1 + D], bd))
        out_shape = grid_shape
    x = x.contiguous()
    if x.data_ptr() % x.element_size():
        x = x.clone()
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"element_to_{direction}_{relayout.SUFFIXES[x.dtype]}")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), *grid_shape, *bd,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"element kernel launch failed: cudaError {err}")
    return out


def _host_us(fn, count: int = 2000) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        fn()
    us = (time.perf_counter() - t0) / count * 1e6
    torch.cuda.synchronize()
    return us


def probe_relayout() -> None:
    import torch

    from chip_smoke import _back_to_back_ms, cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch.ops.kernels import build, relayout

    print(nvidia_smi_line(), flush=True)
    build.load()
    dev = torch.cuda.current_device()
    x = torch.randn((1, 8, 64, 64), dtype=torch.complex64, device="cuda")
    out = torch.empty_like(x)
    fn = build.load().nufft_relayout_to_blocks_f32
    geom = relayout.run_geometry((1, 8, 64, 64), (8, 16, 64))
    stream = torch.cuda.current_stream().cuda_stream
    for label, call in (
        ("wrapper relayout_to_blocks", lambda: relayout.relayout_to_blocks(x, (8, 16, 64))),
        ("plain relayout_to_blocks_plain", lambda: relayout.relayout_to_blocks_plain(
            x, (8, 16, 64))),
        ("library reshape.permute.contiguous", lambda: x.reshape(1, 1, 8, 4, 16, 1, 64)
         .permute(0, 1, 3, 5, 2, 4, 6).contiguous()),
        ("raw ctypes launch", lambda: fn(x.data_ptr(), out.data_ptr(), *geom, stream)),
        ("torch.cuda.current_stream().cuda_stream",
         lambda: torch.cuda.current_stream().cuda_stream),
        ("torch._C._cuda_getCurrentRawStream", lambda: torch._C._cuda_getCurrentRawStream(dev)),
        ("x.new_empty", lambda: x.new_empty((1, 1, 4, 1, 8, 16, 64))),
        ("run_geometry", lambda: relayout.run_geometry((1, 8, 64, 64), (8, 16, 64))),
    ):
        print(f"host {label}: {_host_us(call):.2f} us a call", flush=True)

    libs = build.build_variants(RELAYOUT_VARIANTS)
    element = _probe_library("relayout_element", _ELEMENT_RELAYOUT_SRC)
    cases = (("pack", "blocks", (1, 96, 256, 256), (96, 64, 256)),
             ("all_gather unpack", "grid", (1, 1, 4, 1, 256, 64, 256), (256, 64, 256)))
    for dtype in (torch.complex64, torch.complex128):
        for label, direction, shape, bd in cases:
            xs = [torch.randn(shape, dtype=dtype, device="cuda") for _ in range(3)]
            D = len(bd)
            if direction == "blocks":
                want = relayout.relayout_to_blocks_plain(xs[0], bd)
                grid_shape = shape
                nb = tuple(n // b for n, b in zip(shape[1:], bd))
                split = (shape[0],) + tuple(v for p in zip(nb, bd) for v in p)
                perm = (0,) + tuple(1 + 2 * d for d in range(D)) + tuple(2 + 2 * d for d in range(D))
                library = lambda t: t.reshape(split).permute(perm).contiguous()
            else:
                want = relayout.relayout_to_grid_plain(xs[0], bd)
                grid_shape = tuple(want.shape)
                perm = (0,) + tuple(v for d in range(D) for v in (1 + d, 1 + D + d))
                library = lambda t: t.permute(perm).reshape(grid_shape)
            geom = relayout.run_geometry(grid_shape, bd)
            out = torch.empty_like(want)
            entry = relayout.entry_point(direction, dtype)
            launches = {name: (lambda t, k=getattr(lib, entry): k(
                t.data_ptr(), out.data_ptr(), *geom, stream)) for name, lib in libs.items()}
            k = getattr(element, entry.replace("nufft_relayout", "element"))
            k.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            launches["element kernel (first design)"] = lambda t, k=k: k(
                t.data_ptr(), out.data_ptr(), *grid_shape, *bd, stream)
            line = {"case": f"{label} {dtype}", "shape": list(shape),
                    "bound_ms": 1e3 * 2 * want.numel() * want.element_size() / 3.35e12,
                    "library_ms": [_back_to_back_ms(library, xs)], "variants_ms": {}}
            for name, launch in launches.items():
                t1 = _back_to_back_ms(launch, xs)
                out.zero_()
                if launch(xs[0]) != 0:
                    raise RuntimeError(f"variant {name!r}: launch failed")
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"variant {name!r} differs from the plain version")
                line["variants_ms"][name] = [t1, _back_to_back_ms(launch, xs)]
            line["library_ms"].append(_back_to_back_ms(library, xs))
            # One call each, through the shipped wrapper and the first
            # design's, in turns (shipped, first, first, shipped).
            calls = {"shipped": lambda: (relayout.relayout_to_blocks if direction == "blocks"
                                         else relayout.relayout_to_grid)(xs[0], bd),
                     "first design": lambda: _first_design_call(element, direction, xs[0], bd)}
            line["call_ms"] = {name: [] for name in calls}
            for name in ("shipped", "first design", "first design", "shipped"):
                ms, got = cuda_time_ms(calls[name], reps=20)
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} call differs from the plain version")
                line["call_ms"][name].append(ms)
            # 200 calls: fewer than the launch queue holds, so the host is not
            # held back by the card.
            line["call_host_us"] = {name: _host_us(fn, 200) for name, fn in calls.items()}
            print(json.dumps(line), flush=True)
            del xs, out, want


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dim", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--np", type=int, nargs="+", default=None)
    parser.add_argument("--dtype", nargs="+",
                        default=["complex64", "complex128", "float32", "float64"])
    parser.add_argument("--gloo", action="store_true",
                        help="probe which gloo calls take CUDA tensors, and stop")
    parser.add_argument("--relayout", action="store_true",
                        help="time the relayout kernels' design variants, and stop")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this script needs a GPU")
    if args.gloo:
        probe_gloo()
        return 0
    if args.relayout:
        probe_relayout()
        return 0

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
    scatter_lib = _probe_library("scatter_1d", _SCATTER_SRC) if 1 in args.dim else None
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
