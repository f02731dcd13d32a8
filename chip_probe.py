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

    python3 chip_probe.py --spread3d [--dtype T ...] [--np N ...]

instead times the 3D spread kernel (``csrc/spread_3d.cu``, FP64 tensor
cores) against the shared-memory design it replaced (a CAS loop a tap,
written below as ``_CAS_SPREAD_3D_SRC``, built into ``build/chip_probe/``)
in turns on the same points, then its variants (other MMA shapes, batches
of 32 points; ``build.py:build_variants``) and the geometries around the
chooser's pick, at N = 256^3 for each dtype at its main-path Np and at
16,777,216 (``probe_spread3d``).

    python3 chip_probe.py --spread3d-parts [--dtype T ...] [--np N ...]

times the same kernel beside copies of its source with one phase taken
out (the MMAs, the dense operand build, the tap evaluation, the flush;
``SPREAD3D_PARTS``), to show where its time goes.

    python3 chip_probe.py --spread2d [--spread2d-parts] [--dtype T ...] [--np N ...]

times the 2D spread kernel (``csrc/spread_2d.cu``, FP64 tensor cores, a
warp a block) against the shared-memory design it replaced (a CAS loop a
tap, written below as ``_CAS_SPREAD_2D_SRC``) in turns on the same points,
with err1 of both, the t2 interpolation at both designs' block geometries
and the kernel's ``-D`` variants (``SPREAD2D_VARIANTS``), at N = 4096^2 for
each dtype at its main-path Np, 16,777,216 and rho = 0.01; then the
geometry sweep at 1M and 16,777,216 points and the fit of the 2D chooser's
cost model (``probe_spread2d``).  ``--spread2d-parts`` times copies of its
source with one phase taken out (``SPREAD2D_PARTS``).

    python3 chip_probe.py --interp3d [--dtype T ...] [--np N ...]

times the 3D interpolation kernel (``csrc/interp_3d.cu``: staged windows,
a lane group a point) against the per-point kernel it replaced (written
below as ``_POINT_INTERP_3D_SRC``), in turns on the same points, and its
``-D`` variants (``INTERP3D_VARIANTS``), all built for M = 4 into
``build/chip_probe/``, at N = 256^3 for each dtype at its main-path Np,
167,772 and 16,777,216 points (``probe_interp3d``);
``--interp3d-parts`` times copies of its source with one phase taken out
(``INTERP3D_PARTS``).

    python3 chip_probe.py --spread1d [--spread1d-parts] [--interp2d] [--interp2d-parts]
                          [--m M ...] [--dtype T ...] [--np N ...]

times the 1D spread kernel (``csrc/spread_1d.cu``: a lane a local cell,
rounds of 32 cells rotated by shuffles, interior cells stored) against the
thread-a-padded-cell kernel it replaced (``_CELL_SPREAD_1D_SRC``), with its
wrapper call and host time and its variants (``SPREAD1D_VARIANTS``: copies
of the source with one line changed); and the 2D interpolation kernel
(``csrc/interp_2d.cu``: a thread a point, its rows read as whole 16-byte
chunks) against the per-point kernel it replaced (``_POINT_INTERP_2D_SRC``)
and a staged-window design tried in its place (``_STAGED_INTERP_2D_SRC``),
with its wrapper call and host time and its variants
(``INTERP2D_VARIANTS``); raw launches in turns on the same points, all
built for the M of ``--m`` (4 by default) into ``build/chip_probe/``: 1D
N = 2^20 at 1M, 10M and rho = 0.01, 2D N = 4096^2 at each dtype's
main-path Np, 16,777,216 and rho = 0.01 (``_lowdim_probe``).  The
``-parts`` flags time copies of the shipped sources with one phase taken
out (``SPREAD1D_PARTS``, ``INTERP2D_PARTS``; for the 2D interpolation also
the per-point kernel's, ``POINT_INTERP2D_PARTS``) at the first two point
counts.

    python3 chip_probe.py --interp1d [--interp1d-parts] [--m M ...] [--reps N]
    python3 chip_probe.py --interp1d-sweep [--dtype T ...] [--np N ...] [--reps N]

time the 1D interpolation kernel (``csrc/interp_1d.cu``) the same way
against the per-point kernel it replaced (``_POINT_INTERP_1D_SRC``), with
its variants (``INTERP1D_VARIANTS``) and each of its two paths forced
(``--interp1d-parts``: ``INTERP1D_PARTS``); the sweep times its point path
against its staged path with the gather, one and two transforms, from 1M
to 10M points (``INTERP1D_SWEEP_NP``), where ``INTERP1D_GATHER_BYTES``
chooses between them.

    python3 chip_probe.py --weights [--m M ...] [--np N ...]

times the window-taps kernel K3 (``csrc/window_weights.cu``) as raw
launches against the kernel it replaced (``_OLD_WEIGHTS_SRC``), its
variants (``WEIGHTS_VARIANTS``) and parts (``WEIGHTS_PARTS``), beside its
wrapper call, for the four windows it evaluates, 3D at 1M and 16.8M points
(``probe_weights``).

    python3 chip_probe.py --exec-windows [--root DIR]
    python3 chip_probe.py --exec-1d [--reps N] [--root DIR]

time ``set_points``, ``exec_type1`` and ``exec_type2`` through the public
API: every window of chip_smoke.py phase 10, or the 1D main path (phase 9,
four dtypes at 1M and 10M points), for the package of this tree or of
the tree ``--root`` names, so that two trees are timed in turns in one
call (``probe_exec_windows``).

    python3 chip_probe.py --direct [--dtype complex64 complex128] [--np N ...]

times the direct NUDFT (``spread_method='direct'``) against the blocked
path through the public API at 256^3, 4096^2 and 2^20, Np = 1 to
100,000 (``DIRECT_NP``), with the direct path's errors against exact sums
and, for complex64, the same with complex64 factors; prints each row's
crossover Np and the ``c`` of ``ops/direct.py:prefers_direct`` that
matches it (``probe_direct``).

    python3 chip_probe.py --set-points [--dim D ...] [--dtype T ...] [--np N ...] [--reps N]

times ``set_points``' split and sort on the main paths' shapes (3D 256^3
and 2D 4096^2 at 16,777,216 points, 1D 2^20 at 10M; m = 4, sigma = 1.5):
the bin-key kernel, the sort and the sorted-state kernel
(``csrc/bin_sort.cu``) each alone and together, against the plain chain
they replace on the card (``blocking.py``), in turns, with their outputs
held equal and each kernel's bound by the function's bytes, on uniform
points and on clustered ones (empty end blocks, every point in the first or
the last block; ``probe_set_points``).

    python3 chip_probe.py --deconvolve [--reps N]

times the deconvolution's stages, whose kernels are ``csrc/deconvolve.cu``'s
truncate and pad, at N = 256^3 over the 384^3 grid: complex64 with 32
transforms a call (the 32-coil cell's), then one transform of each value
type against the plain torch chain, in turns, beside the bound by bytes
(``probe_deconvolve``).

    python3 chip_probe.py --alloc-window CELL ... [--seed S] [--seconds T] [--root DIR]

runs each benchmark cell as ``nufftbench/run.py`` does, traced and
untraced, and prints the device allocations made inside its measured
stretches: the caching allocator's new segments (counters and history,
with sizes and the repo's frames) and the ``cudaMalloc`` / ``cudaFree``
calls in the profiled trace (``probe_alloc_window``).  With ``--root`` the
harness and the package are those of another tree, so that two trees are
compared in one call.

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
import re
import statistics
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


def _probe_library(stem: str, text: str, flags=()) -> ctypes.CDLL:
    """Build the probe's own CUDA source ``text`` into ``build/chip_probe/``,
    with ``flags`` added to nvcc's; what ``ptxas -v`` says goes to
    ``<stem>.ptxas.log`` there."""
    from nonuniformffts_tpu_torch.ops.kernels import build

    out = ROOT / "build" / "chip_probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{stem}.cu", out / f"lib{stem}.so"
    src.write_text(text)
    res = subprocess.run([build._nvcc(), *build.ARCH_FLAGS, "-O3", "-std=c++17", "-shared",
                          "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    (out / f"{stem}.ptxas.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem}:\n{res.stderr[-4000:]}")
    return ctypes.CDLL(str(lib))


def _m4_registers(text: str) -> str:
    """Registers of the M = 4 spread_3d instantiations in a ptxas log."""
    regs = re.findall(r"spread_3d_kernelILi4E([fd])Li(\d)E.*?Used (\d+) registers", text, re.S)
    return ", ".join(f"<{t}, {n}> {r}" for t, n, r in regs)


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


# --spread3d: the 3D spread kernel's shared-memory design, which the
# tensor-core kernel (csrc/spread_3d.cu) replaced.  One CTA of 512 threads
# per (block, transform) zeroes a padded block of double accumulators in
# shared memory; each warp takes one point at a time, its lanes split the
# (2M)^2 (y, z) tap pairs and walk the 2M x taps with a shared-memory
# atomicAdd each (a compare-and-swap loop on sm_90), and the CTA adds the
# padded block into the grid with one global atomicAdd a scalar.  Built by
# this script with nvcc into build/chip_probe/ and used nowhere else; same
# C interface as the library's entry points, named cas_spread_3d_*.
# The shared-memory spread kernels' tap evaluation, which the probe's CAS
# sources below add after window.cuh: the D x S taps of sorted point j into
# one warp's scratch taps[d * S + t], lane q taking tap q of the flattened
# (D, S) set; cs: (D, S, ncoef) coefficients.
_CAS_WARP_TAPS = r"""
namespace nufft {
template <int S, int D, typename T>
__device__ __forceinline__ void warp_taps(const T* wtaps, const T* cs,
                                          int ncoef, const T* fracs,
                                          long long np, long long j, int lane,
                                          T* taps) {
  for (int q = lane; q < D * S; q += 32) {
    const int d = q / S;
    taps[q] = wtaps ? wtaps[q * np + j]
                    : horner_tap(cs + q * ncoef, ncoef, T(2) * fracs[d * np + j] - T(1));
  }
}
}  // namespace nufft
"""


def _with_warp_taps(src: str) -> str:
    """A CAS probe source with ``_CAS_WARP_TAPS`` after its window.cuh."""
    anchor = '#include "window.cuh"\n'
    return src.replace(anchor, anchor + _CAS_WARP_TAPS, 1)


_CAS_SPREAD_3D_SRC = r"""
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 512;
using Acc = double;

template <typename T, int NCOMP>
size_t spread_smem_bytes(int m, int ncoef, int b0, int b1, int b2) {
  const size_t s = 2 * m;
  const size_t pv = (size_t)(b0 + s - 1) * (b1 + s - 1) * (b2 + s - 1);
  const size_t ntaps = 3 * s;
  return sizeof(Acc) * NCOMP * pv + sizeof(T) * (ntaps * ncoef + (kThreads / 32) * ntaps);
}

template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kThreads) cas_spread_3d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, long long np, int ncoef, int n0, int n1, int n2,
    int b0, int b1, int b2) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int bid = blockIdx.x;
  const int chan = blockIdx.y;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA

  const int pd1 = b1 + S - 1, pd2 = b2 + S - 1;
  const int plane = pd1 * pd2;
  const int pv = (b0 + S - 1) * plane;
  Acc* acc = reinterpret_cast<Acc*>(smem_raw);      // NCOMP planes of pv
  T* cs = reinterpret_cast<T*>(acc + NCOMP * pv);   // (3, S, ncoef)
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  T* taps = cs + 3 * S * ncoef + warp * 3 * S;  // this warp's (3, S)

  for (int i = tid; i < NCOMP * pv; i += blockDim.x) acc[i] = Acc(0);
  for (int i = tid; i < 3 * S * ncoef; i += blockDim.x) cs[i] = coefs[i];
  __syncthreads();

  const int nb1 = n1 / b1, nb2 = n2 / b2;
  const int ox = (bid / (nb1 * nb2)) * b0;
  const int oy = ((bid / nb2) % nb1) * b1;
  const int oz = (bid % nb2) * b2;
  const nufft::Value<T, NCOMP>* vrow = vals + (long long)chan * np;

  for (long long j = p_begin + warp; j < p_end; j += nwarps) {
    nufft::warp_taps<S, 3>(wtaps, cs, ncoef, fracs, np, j, lane, taps);
    __syncwarp();
    const int lx = cells[j] - ox;
    const int ly = cells[np + j] - oy;
    const int lz = cells[2 * np + j] - oz;
    const nufft::Value<T, NCOMP> v = vrow[j];
    for (int q = lane; q < S * S; q += 32) {
      const int iy = q / S, iz = q - iy * S;
      const T wyz = taps[S + iy] * taps[2 * S + iz];
      T vw[NCOMP];
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) vw[k] = v.c[k] * wyz;
      int idx = (lx * pd1 + ly + iy) * pd2 + lz + iz;
#pragma unroll
      for (int ix = 0; ix < S; ++ix) {
        const T wx = taps[ix];
#pragma unroll
        for (int k = 0; k < NCOMP; ++k) atomicAdd(acc + k * pv + idx, Acc(vw[k] * wx));
        idx += plane;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // Periodic global add of the padded block: padded index i along a dim is
  // grid node origin - (M - 1) + i.
  T* g = grid + (long long)chan * n0 * n1 * n2 * NCOMP;
  for (int i = tid; i < pv; i += blockDim.x) {
    Acc a[NCOMP];
    bool any = false;
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) {
      a[k] = acc[k * pv + i];
      any = any || a[k] != Acc(0);
    }
    if (!any) continue;
    const int i0 = i / plane;
    const int r = i - i0 * plane;
    const int i1 = r / pd2;
    const int i2 = r - i1 * pd2;
    const int gx = nufft::wrap_index(ox - (M - 1) + i0, n0);
    const int gy = nufft::wrap_index(oy - (M - 1) + i1, n1);
    const int gz = nufft::wrap_index(oz - (M - 1) + i2, n2);
    const long long off = NCOMP * (((long long)gx * n1 + gy) * n2 + gz);
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) atomicAdd(g + off + k, T(a[k]));
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* vals, const void* cells, const void* fracs,
                   const void* pstarts, const void* coefs,
                   const void* wtaps, void* grid,
                   long long np, int nchan, int ncoef, int n0, int n1, int n2,
                   int b0, int b1, int b2, cudaStream_t stream) {
  const size_t smem = spread_smem_bytes<T, NCOMP>(M, ncoef, b0, b1, b2);
  cudaError_t err = cudaFuncSetAttribute(
      cas_spread_3d_kernel<M, T, NCOMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks((n0 / b0) * (n1 / b1) * (n2 / b2), nchan);
  cas_spread_3d_kernel<M, T, NCOMP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(vals),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const int*>(pstarts), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps),
      static_cast<T*>(grid), np, ncoef, n0, n1, n2, b0, b1, b2);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* vals, const void* cells, const void* fracs,
             const void* pstarts, const void* coefs,
             const void* wtaps, void* grid, long long np,
             int nchan, int m, int ncoef, int n0, int n1, int n2, int b0,
             int b1, int b2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_SPREAD_CASE(MM)                                                \
  case MM:                                                                   \
    return (int)launch<MM, T, NCOMP>(vals, cells, fracs, pstarts, coefs,     \
                                     wtaps, grid, np, nchan, ncoef, n0, n1,   \
                                     n2, b0, b1, b2, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_SPREAD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_SPREAD_CASE
}

}  // namespace

// The library kernels' C interface (csrc/spread_3d.cu).
#define NUFFT_SPREAD_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* vals, const void* cells, const void* fracs, \
                      const void* pstarts, const void* coefs,                 \
                      const void* wtaps, void* grid,             \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      int n1, int n2, int b0, int b1, int b2, void* stream) { \
    return dispatch<T, NCOMP>(vals, cells, fracs, pstarts, coefs, wtaps, grid,  \
                              np, nchan, m, ncoef, n0, n1, n2, b0, b1, b2,    \
                              stream);                                        \
  }

#if NUFFT_WANT(0)
NUFFT_SPREAD_ENTRY(cas_spread_3d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_SPREAD_ENTRY(cas_spread_3d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_SPREAD_ENTRY(cas_spread_3d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_SPREAD_ENTRY(cas_spread_3d_real_f64, double, 1)
#endif
"""

#: The geometry chooser's 3D picks at grid 384^3, m = 4 for the
#: shared-memory design (its cost model: halo x bank conflicts / CTAs).
CAS_PICKS = {"complex64": (8, 8, 8), "complex128": (8, 8, 12),
             "float32": (12, 12, 16), "float64": (12, 12, 16)}
#: Geometries the tensor-core kernel is also timed at (grid 384^3).
SPREAD3D_GEOMETRIES = ((8, 8, 8), (8, 6, 8), (6, 8, 8), (8, 8, 6), (4, 8, 8), (8, 4, 8),
                       (8, 8, 4), (4, 4, 8), (6, 6, 8), (8, 8, 12), (8, 12, 8),
                       (8, 8, 16), (16, 8, 8), (24, 8, 8), (32, 8, 8), (12, 12, 16))
#: Variants of the tensor-core kernel (-D values of csrc/spread_3d.cu's
#: tunables), built by build.py:build_variants.
SPREAD3D_VARIANTS = {"m8n8k4": ["-DNUFFT_SPREAD3D_ATOM_ROWS=8", "-DNUFFT_SPREAD3D_K=4"],
                     "m16n8k4": ["-DNUFFT_SPREAD3D_K=4"],
                     "batch32": ["-DNUFFT_SPREAD3D_BATCH=32"]}
SPREAD3D_NP = {"complex64": 1_000_000, "float32": 1_000_000,
               "complex128": 1_677_722, "float64": 1_677_722}


def _raw_spread(lib, prefix: str, plan, vals):
    """One launch of a 3D spread entry point (``prefix`` + value suffix) of
    ``lib`` on the plan's sorted state, ``vals`` already in sorted order;
    returns the grid."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    name = prefix + VALUE_TYPES[plan.dtype][0]
    fn = getattr(lib, name)
    fn.argtypes = build._SIGNATURES["nufft_spread_3d_" + VALUE_TYPES[plan.dtype][0]]
    grid = torch.zeros((1,) + plan.shape_over, dtype=vals.dtype, device=vals.device)
    err = fn(vals.data_ptr(), plan.cells_sorted.data_ptr(), plan.fracs_sorted.data_ptr(),
             plan.pstarts.data_ptr(), plan.coefs.data_ptr(), 0, grid.data_ptr(),
             plan.num_points, 1, plan.m, plan.coefs.shape[-1], *plan.shape_over,
             *plan.block_dims, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return grid


def probe_spread3d(seed: int, dtypes, nps) -> None:
    """The tensor-core 3D spread kernel against the shared-memory design it
    replaced, in turns (old, new, new, old), two passes, on the same points
    and values: the old kernel at its chooser's pick (``CAS_PICKS``), the
    new one at its own pick and at the old pick (the old kernel's sorted
    points).  Then the new kernel at ``SPREAD3D_GEOMETRIES`` (in order and
    reversed) and its variants at the pick (``SPREAD3D_VARIANTS``: the
    m8n8k4 and m16n8k4 MMAs, batches of 32 points).  Also err1 against exact
    sums (``chip_smoke._err1``) of each kernel's grid through the plan's FFT
    and deconvolution, three calls each.
    3D, N = 256^3 (grid 384^3), m = 4, sigma = 1.5, BKB FastApproximation,
    uniform points; CUDA events, median of 5 after one warm-up.  One JSON
    line a dtype and Np, with the card's name and power limit."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import _err1, cuda_time_ms, nvidia_smi_line, rel_l2
    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch.ops.kernels import blocked, build

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    cas = _probe_library("cas_spread_3d", _with_warp_taps(_CAS_SPREAD_3D_SRC),
                         ("-I", str(build.CSRC_DIR)))
    variants = build.build_variants(SPREAD3D_VARIANTS, sources=("spread_3d.cu",))
    shipped = build.load()
    logs = {"shipped": build.PTXAS_LOG}
    logs.update({k: build.BUILD_DIR / "variants" / str(i) / "ptxas.log"
                 for i, k in enumerate(SPREAD3D_VARIANTS)})
    for k, path in logs.items():
        print(f"ptxas {k}: {_m4_registers(path.read_text())}", flush=True)
    for name in dtypes:
        dtype = np.dtype(name)
        plan0 = nufft.PlanNUFFT(dtype, SHAPES[3], m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        tol = 1e-5 if plan0.real_dtype == torch.float32 else 1e-12
        for np_ in nps or (SPREAD3D_NP[name], 16_777_216):
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((3, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
            plans = {g: nufft.set_points(dataclasses.replace(plan0, block_dims=g), pts)
                     for g in dict.fromkeys((plan0.block_dims, CAS_PICKS[name]))}
            sorted_vals = {g: vp[:, p.sort_perm].contiguous() for g, p in plans.items()}
            old_g, new_g = CAS_PICKS[name], plan0.block_dims
            runs = {
                "cas": lambda: _raw_spread(cas, "cas_spread_3d_", plans[old_g],
                                           sorted_vals[old_g]),
                "new": lambda: _raw_spread(shipped, "nufft_spread_3d_", plans[new_g],
                                           sorted_vals[new_g]),
                "new_at_cas_pick": lambda: _raw_spread(shipped, "nufft_spread_3d_",
                                                       plans[old_g], sorted_vals[old_g]),
            }
            want = blocked.spread_blocked_plain(
                dataclasses.replace(plans[new_g], chunk_size=1 << 16), vp)
            times = {k: [] for k in runs}
            for _ in range(2):
                for k in ("cas", "new", "new_at_cas_pick", "new_at_cas_pick", "new", "cas"):
                    ms, got = cuda_time_ms(runs[k])
                    times[k].append(ms)
                    err = rel_l2(got, want)
                    if not err <= tol:
                        raise AssertionError(f"{name} {np_} {k}: rel L2 {err:.3e} vs plain")
                    del got
            line = {"probe": "spread3d", "card": card, "dtype": name, "np": np_,
                    "chosen": list(new_g), "cas_pick": list(old_g),
                    "ms": {k: sum(t) / len(t) for k, t in times.items()}}
            line["speedup"] = line["ms"]["cas"] / line["ms"]["new"]
            # err1 of both kernels' grids through the plan's FFT and
            # deconvolution, three calls each: float grids take their adds in
            # a run-dependent order, so err1 varies from call to call.
            line["err1"] = {}
            for k, lib, prefix, g in (("cas", cas, "cas_spread_3d_", old_g),
                                      ("new", shipped, "nufft_spread_3d_", new_g)):
                p = plans[g]
                line["err1"][k] = [
                    _err1(pts, vp[0], ex.t1_deconv_stage(p, ex.t1_fft_stage(
                        p, _raw_spread(lib, prefix, p, sorted_vals[g])))[0],
                        SHAPES[3], p.is_real, seed)
                    for _ in range(3)]
            # The variants at the pick, in turns with the shipped kernel; a
            # variant that disagrees with the plain version is reported with
            # its error and not timed.
            vt = {k: [] for k in ("shipped", *SPREAD3D_VARIANTS)}
            line["variants_err"] = {}
            for order in (list(vt), list(vt)[::-1]):
                for k in order:
                    if line["variants_err"].get(k, 0.0) > tol:
                        continue
                    lib = shipped if k == "shipped" else variants[k]
                    ms, got = cuda_time_ms(lambda: _raw_spread(
                        lib, "nufft_spread_3d_", plans[new_g], sorted_vals[new_g]))
                    err = rel_l2(got, want)
                    line["variants_err"][k] = err
                    if k == "shipped" and not err <= tol:
                        raise AssertionError(f"{name} {np_}: rel L2 {err:.3e} vs plain")
                    if err <= tol:
                        vt[k].append(ms)
                    del got
            line["variants_ms"] = {k: sum(t) / len(t) for k, t in vt.items() if t}
            del plans, sorted_vals, want
            torch.cuda.empty_cache()
            # The geometries, in order and reversed (one plan at a time).
            dims = [g for g in dict.fromkeys((new_g,) + SPREAD3D_GEOMETRIES)
                    if all(n % b == 0 for n, b in zip(plan0.shape_over, g))]
            gt = {g: [] for g in dims}
            for order in (dims, dims[::-1]):
                for g in order:
                    plan = nufft.set_points(dataclasses.replace(plan0, block_dims=g), pts)
                    vals = vp[:, plan.sort_perm].contiguous()
                    ms, _ = cuda_time_ms(lambda: _raw_spread(shipped, "nufft_spread_3d_",
                                                             plan, vals))
                    gt[g].append(ms)
                    del plan, vals
                    torch.cuda.empty_cache()
            line["geometries_ms"] = {"x".join(map(str, g)): sum(t) / len(t)
                                     for g, t in gt.items()}
            print(json.dumps(line), flush=True)


#: Copies of csrc/spread_3d.cu with one phase taken out, for
#: ``--spread3d-parts``: each maps a line of the source (spread_mma.cuh
#: written in place of its include) to its replacement.
#: Their grids are wrong; only their times and registers are read.  Without
#: the flush the compiler drops the accumulators too (40 registers against
#: 128), so "no_flush" times neither; "flush_sum" keeps them live.
SPREAD3D_PARTS = {
    "no_mma": {"mma_f64(acc[c][r], a[r], b);": "acc[c][r][0] += a[r][0] * b[0];"},
    "no_dense": {"for (int e = warp; e < dense; e += nwarps) {":
                 "for (int e = warp; e < 0; e += nwarps) {"},
    "no_taps": {"for (int e = warp; e < 3 * S; e += nwarps) {":
                "for (int e = warp; e < 0; e += nwarps) {"},
    "no_flush": {"    if (!active) continue;\n\n    // Flush.": "    continue;\n\n    // Flush."},
    # The flush's complex64 / complex128 reductions as plain stores, and as
    # no write at all (a store under a condition that never holds).
    "flush_stores": {"  red_v2(p, float(re), float(im));":
                     "  *reinterpret_cast<float2*>(p) = make_float2(float(re), float(im));",
                     "  atomicAdd(p, re);\n  atomicAdd(p + 1, im);": "  p[0] = re;\n  p[1] = im;"},
    # The accumulators kept live by one conditional write of their sum, in
    # place of the flush's code.
    "flush_sum": {"    if (!active) continue;\n\n    // Flush.":
                  "    if (!active) continue;\n    {\n      double sum = 0.0;\n"
                  "#pragma unroll\n      for (int c = 0; c < kColTiles; ++c)\n"
                  "#pragma unroll\n        for (int r = 0; r < kRowTiles; ++r)\n"
                  "#pragma unroll\n          for (int e = 0; e < 2 * kHalves; ++e) sum += acc[c][r][e];\n"
                  "      if (sum == 1.25e-300) gch[tid] = T(sum);\n    }\n    continue;\n\n    // Flush."},
    "flush_no_write": {"  red_v2(p, float(re), float(im));":
                       "  if (re == 1.25e-300) p[0] = float(im);",
                       "  atomicAdd(p, re);\n  atomicAdd(p + 1, im);":
                       "  if (re == 1.25e-300) p[0] = im;"},
}


# The 2D spread kernel the tensor-core design replaced (the first
# csrc/spread_2d.cu): a CTA a (block, transform) with its padded block in
# shared memory as NCOMP double planes, each warp adding one point's
# (2M)^2 tap products by atomicAdd (compare-and-swap loops in SASS), then a
# periodic global add of the padded block.  The same C interface as the
# shipped kernel.  Built by --spread2d into build/chip_probe/.
_CAS_SPREAD_2D_SRC = r"""
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 512;  // ops/kernels/common.py:SPREAD_THREADS
using Acc = double;            // ops/kernels/common.py:ACC_BYTES

// Must match ops/kernels/common.py:spread_smem_bytes for D = 2.
template <typename T, int NCOMP>
size_t spread_smem_bytes(int m, int ncoef, int b0, int b1) {
  const size_t s = 2 * m;
  const size_t pv = (size_t)(b0 + s - 1) * (b1 + s - 1);
  const size_t ntaps = 2 * s;
  return sizeof(Acc) * NCOMP * pv + sizeof(T) * (ntaps * ncoef + (kThreads / 32) * ntaps);
}

template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kThreads) spread_2d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, long long np, int ncoef, int n0, int n1, int b0,
    int b1) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int bid = blockIdx.x;
  const int chan = blockIdx.y;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA

  const int pd1 = b1 + S - 1;
  const int pv = (b0 + S - 1) * pd1;
  Acc* acc = reinterpret_cast<Acc*>(smem_raw);      // NCOMP planes of pv
  T* cs = reinterpret_cast<T*>(acc + NCOMP * pv);   // (2, S, ncoef)
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  T* taps = cs + 2 * S * ncoef + warp * 2 * S;  // this warp's (2, S)

  for (int i = tid; i < NCOMP * pv; i += blockDim.x) acc[i] = Acc(0);
  for (int i = tid; i < 2 * S * ncoef; i += blockDim.x) cs[i] = coefs[i];
  __syncthreads();

  const int nb1 = n1 / b1;
  const int ox = (bid / nb1) * b0;
  const int oy = (bid % nb1) * b1;
  const nufft::Value<T, NCOMP>* vrow = vals + (long long)chan * np;

  for (long long j = p_begin + warp; j < p_end; j += nwarps) {
    nufft::warp_taps<S, 2>(wtaps, cs, ncoef, fracs, np, j, lane, taps);
    __syncwarp();
    const int lx = cells[j] - ox;
    const int ly = cells[np + j] - oy;
    const nufft::Value<T, NCOMP> v = vrow[j];
    for (int q = lane; q < S * S; q += 32) {
      const int ix = q / S, iy = q - ix * S;
      const T w = taps[ix] * taps[S + iy];
      const int idx = (lx + ix) * pd1 + ly + iy;
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) atomicAdd(acc + k * pv + idx, Acc(v.c[k] * w));
    }
    __syncwarp();
  }
  __syncthreads();

  // Periodic global add of the padded block: padded index i along a dim is
  // grid node origin - (M - 1) + i.
  T* g = grid + (long long)chan * n0 * n1 * NCOMP;
  for (int i = tid; i < pv; i += blockDim.x) {
    Acc a[NCOMP];
    bool any = false;
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) {
      a[k] = acc[k * pv + i];
      any = any || a[k] != Acc(0);
    }
    if (!any) continue;
    const int i0 = i / pd1;
    const int i1 = i - i0 * pd1;
    const int gx = nufft::wrap_index(ox - (M - 1) + i0, n0);
    const int gy = nufft::wrap_index(oy - (M - 1) + i1, n1);
    const long long off = NCOMP * ((long long)gx * n1 + gy);
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) atomicAdd(g + off + k, T(a[k]));
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* vals, const void* cells, const void* fracs,
                   const void* pstarts, const void* coefs,
                   const void* wtaps, void* grid,
                   long long np, int nchan, int ncoef, int n0, int n1, int b0,
                   int b1, cudaStream_t stream) {
  const size_t smem = spread_smem_bytes<T, NCOMP>(M, ncoef, b0, b1);
  cudaError_t err = cudaFuncSetAttribute(
      spread_2d_kernel<M, T, NCOMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks((n0 / b0) * (n1 / b1), nchan);
  spread_2d_kernel<M, T, NCOMP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(vals),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const int*>(pstarts), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps),
      static_cast<T*>(grid), np, ncoef, n0, n1, b0, b1);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* vals, const void* cells, const void* fracs,
             const void* pstarts, const void* coefs,
             const void* wtaps, void* grid, long long np,
             int nchan, int m, int ncoef, int n0, int n1, int b0, int b1,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_SPREAD_CASE(MM)                                                \
  case MM:                                                                   \
    return (int)launch<MM, T, NCOMP>(vals, cells, fracs, pstarts, coefs,     \
                                     wtaps, grid, np, nchan, ncoef, n0, n1,   \
                                     b0, b1, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_SPREAD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_SPREAD_CASE
}

}  // namespace

// vals (nchan, np) values in bin-sorted order (complex: re, im interleaved);
// cells (2, np) int32 and fracs (2, np) T, sorted; pstarts (nblocks + 1,)
// int32; coefs (2, 2m, ncoef) T, or ncoef = 0 and no coefficients for a
// window other than kHorner, whose taps come in wtaps (D, 2m, np) T
// (window_weights.cu), null for kHorner;
// grid (nchan, n0, n1) values, zeroed by the caller.  T is float for *_f32,
// double for *_f64.  Launches on `stream`, does not synchronise, allocates
// nothing.
#define NUFFT_SPREAD_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* vals, const void* cells, const void* fracs, \
                      const void* pstarts, const void* coefs,                 \
                      const void* wtaps, void* grid,             \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      int n1, int b0, int b1, void* stream) {                 \
    return dispatch<T, NCOMP>(vals, cells, fracs, pstarts, coefs, wtaps, grid,  \
                              np, nchan, m, ncoef, n0, n1, b0, b1, stream);   \
  }

#if NUFFT_WANT(0)
NUFFT_SPREAD_ENTRY(cas_spread_2d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_SPREAD_ENTRY(cas_spread_2d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_SPREAD_ENTRY(cas_spread_2d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_SPREAD_ENTRY(cas_spread_2d_real_f64, double, 1)
#endif
"""

#: The shared-memory design's geometry chooser's 2D picks at grid 6144^2,
#: m = 4 (its score: halo x bank conflicts / CTAs).
CAS_PICKS_2D = {"complex64": (48, 64), "complex128": (48, 64),
                "float32": (64, 96), "float64": (64, 96)}
#: Geometries the tensor-core 2D kernel is timed at for the cost model's
#: fit (grid 6144^2; the chooser's candidates: divisors up to 128).
SPREAD2D_GEOMETRIES = ((4, 16), (4, 32), (6, 16), (8, 8), (8, 16), (16, 8), (8, 24),
                       (8, 32), (8, 48), (12, 16), (12, 24), (16, 16), (16, 24),
                       (24, 16), (24, 24), (16, 32), (32, 32), (48, 64))
#: Variants of the tensor-core 2D kernel (-D values of csrc/spread_2d.cu's
#: tunables), built by build.py:build_variants: blocks a warp walks, the
#: same for float and double grids.
SPREAD2D_VARIANTS = {f"runs{r}": [f"-DNUFFT_SPREAD2D_RUNS_F32={r}", f"-DNUFFT_SPREAD2D_RUNS_F64={r}"]
                     for r in (1, 2, 4, 8)}
#: Main-path Np of each dtype (phase 8), then 16,777,216 and rho = 0.01.
SPREAD2D_NP = {"complex64": 1_000_000, "float32": 1_000_000,
               "complex128": 1_677_722, "float64": 1_677_722}
SPREAD2D_EXTRA_NP = (16_777_216, 377_487)
#: The densities of the cost model's fit: the main path's two point counts.
SPREAD2D_FIT_NP = (1_000_000, 16_777_216)


def _raw_spread_2d(lib, prefix: str, plan, vals):
    """One launch of a 2D spread entry point (``prefix`` + value suffix) of
    ``lib`` on the plan's sorted state, ``vals`` already in sorted order;
    returns the grid."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    name = prefix + VALUE_TYPES[plan.dtype][0]
    fn = getattr(lib, name)
    fn.argtypes = build._SIGNATURES["nufft_spread_2d_" + VALUE_TYPES[plan.dtype][0]]
    grid = torch.zeros((1,) + plan.shape_over, dtype=vals.dtype, device=vals.device)
    err = fn(vals.data_ptr(), plan.cells_sorted.data_ptr(), plan.fracs_sorted.data_ptr(),
             plan.pstarts.data_ptr(), plan.coefs.data_ptr(), 0, grid.data_ptr(),
             plan.num_points, 1, plan.m, plan.coefs.shape[-1], *plan.shape_over,
             *plan.block_dims, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return grid


def _registers_2d(text: str) -> str:
    """Registers and spills of the M = 4 spread_2d instantiations in a ptxas
    log."""
    regs = re.findall(r"spread_2d_kernelILi4E([fd])Li(\d)E.*?(\d+) bytes spill stores.*?"
                      r"Used (\d+) registers", text, re.S)
    return ", ".join(f"<{t}, {n}> {r} (spill {s} B)" for t, n, s, r in regs)


def fit_spread2d(samples):
    """The 2D cost model's constants for one value type from the sweep:
    ``samples`` of (block dims, m, ncomp, Np, grid cells, seconds).  Each
    time is modelled as the sum of ``blocking.spread2d_counts`` (per cell,
    times the grid's cells) times a constant, fitted by non-negative least
    squares on relative errors.  Returns (constants, mean relative error)."""
    from scipy.optimize import nnls

    from nonuniformffts_tpu_torch import blocking

    rows = []
    for dims, m, ncomp, np_, cells, t in samples:
        counts = blocking.spread2d_counts(dims, m, ncomp, np_ / cells)
        rows.append([c * cells / t for c in counts])
    rows = np.array(rows)
    consts, _ = nnls(rows, np.ones(len(rows)))
    return tuple(float(c) for c in consts), float(np.mean(np.abs(rows @ consts - 1.0)))


def probe_spread2d(seed: int, dtypes, nps) -> None:
    """The tensor-core 2D spread kernel against the shared-memory design it
    replaced (``_CAS_SPREAD_2D_SRC``), in turns (old, new, new, old), two
    passes, on the same points and values: the old kernel at its chooser's
    pick (``CAS_PICKS_2D``), the new one at its own pick and at the old pick
    (the old kernel's sorted points); err1 against exact sums of both
    kernels' grids through the plan's FFT and deconvolution, three calls
    each; the t2 interpolation stage (``csrc/interp_2d.cu``, which reads
    in the bin sort's order) at the old and the new geometry, in turns, six
    samples each; and the kernel's variants (``SPREAD2D_VARIANTS``) at the
    pick, in turns with it.  At each dtype's main-path Np, 16,777,216 and
    rho = 0.01.  Then
    the new kernel at ``SPREAD2D_GEOMETRIES`` (in order and reversed) at
    the two main-path densities, and the cost model fitted to them
    (``fit_spread2d``), with the pick it makes.  2D, N = 4096^2 (grid
    6144^2), m = 4, sigma = 1.5, BKB FastApproximation, uniform points; CUDA
    events, median of 5 after one warm-up.  One JSON line a dtype and Np,
    and one a dtype for the fit, with the card's name and power limit."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import _err1, cuda_time_ms, nvidia_smi_line, rel_l2
    from nonuniformffts_tpu_torch import blocking
    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch.ops.kernels import blocked, build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    cas = _probe_library("cas_spread_2d", _m_only(_with_warp_taps(_CAS_SPREAD_2D_SRC)),
                         ("-I", str(build.CSRC_DIR)))
    shipped = build.load()
    variants = build.build_variants(SPREAD2D_VARIANTS, sources=("spread_2d.cu",))
    print(f"ptxas shipped: {_registers_2d(build.PTXAS_LOG.read_text())}", flush=True)
    print("ptxas cas: " + _registers_2d(
        (ROOT / "build" / "chip_probe" / "cas_spread_2d.ptxas.log").read_text()), flush=True)
    shape = SHAPES[2]
    for name in dtypes:
        dtype = np.dtype(name)
        plan0 = nufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, spread_method="blocked",
                                device=dev)
        _, sb, ncomp = VALUE_TYPES[plan0.dtype]
        tol = 1e-5 if sb == 4 else 1e-12
        old_g, new_g = CAS_PICKS_2D[name], plan0.block_dims
        cells = math.prod(plan0.shape_over)
        for np_ in nps or (SPREAD2D_NP[name],) + SPREAD2D_EXTRA_NP:
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((2, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
            plans = {g: nufft.set_points(dataclasses.replace(plan0, block_dims=g), pts)
                     for g in dict.fromkeys((new_g, old_g))}
            sorted_vals = {g: vp[:, p.sort_perm].contiguous() for g, p in plans.items()}
            runs = {
                "cas": lambda: _raw_spread_2d(cas, "cas_spread_2d_", plans[old_g],
                                              sorted_vals[old_g]),
                "new": lambda: _raw_spread_2d(shipped, "nufft_spread_2d_", plans[new_g],
                                              sorted_vals[new_g]),
                "new_at_cas_pick": lambda: _raw_spread_2d(shipped, "nufft_spread_2d_",
                                                          plans[old_g], sorted_vals[old_g]),
            }
            want = blocked.spread_blocked_plain(
                dataclasses.replace(plans[new_g], chunk_size=1 << 16), vp)
            times = {k: [] for k in runs}
            for _ in range(2):
                for k in ("cas", "new", "new_at_cas_pick", "new_at_cas_pick", "new", "cas"):
                    ms, got = cuda_time_ms(runs[k])
                    times[k].append(ms)
                    err = rel_l2(got, want)
                    if not err <= tol:
                        raise AssertionError(f"{name} {np_} {k}: rel L2 {err:.3e} vs plain")
                    del got
            line = {"probe": "spread2d", "card": card, "dtype": name, "np": np_,
                    "chosen": list(new_g), "cas_pick": list(old_g),
                    "ms": {k: sum(t) / len(t) for k, t in times.items()}}
            line["speedup"] = line["ms"]["cas"] / line["ms"]["new"]
            line["err1"] = {}
            for k, lib, prefix, g in (("cas", cas, "cas_spread_2d_", old_g),
                                      ("new", shipped, "nufft_spread_2d_", new_g)):
                p = plans[g]
                line["err1"][k] = [
                    _err1(pts, vp[0], ex.t1_deconv_stage(p, ex.t1_fft_stage(
                        p, _raw_spread_2d(lib, prefix, p, sorted_vals[g])))[0],
                        shape, p.is_real, seed)
                    for _ in range(3)]
            # The t2 interpolation stage at both geometries, in turns.
            grid = torch.randn((1,) + plan0.shape_over, generator=gen, device=dev,
                               dtype=plan0.dtype)
            it = {g: [] for g in plans}
            for order in (list(plans), list(plans)[::-1]) * 3:
                for g in order:
                    ms, _ = cuda_time_ms(lambda: ex.t2_interp_stage(plans[g], grid))
                    it[g].append(ms)
            line["t2_interp_ms"] = {"x".join(map(str, g)): sum(t) / len(t)
                                    for g, t in it.items()}
            vt = {k: [] for k in ("shipped", *SPREAD2D_VARIANTS)}
            for order in (list(vt), list(vt)[::-1]):
                for k in order:
                    lib = shipped if k == "shipped" else variants[k]
                    ms, got = cuda_time_ms(lambda: _raw_spread_2d(
                        lib, "nufft_spread_2d_", plans[new_g], sorted_vals[new_g]))
                    err = rel_l2(got, want)
                    if not err <= tol:
                        raise AssertionError(f"{name} {np_} {k}: rel L2 {err:.3e} vs plain")
                    vt[k].append(ms)
                    del got
            line["variants_ms"] = {k: sum(t) / len(t) for k, t in vt.items()}
            print(json.dumps(line), flush=True)
            del plans, sorted_vals, want, grid
            torch.cuda.empty_cache()
        # The geometry sweep at the two main-path densities, and the fit.
        dims = [g for g in dict.fromkeys((new_g,) + SPREAD2D_GEOMETRIES)
                if all(n % b == 0 for n, b in zip(plan0.shape_over, g))]
        samples, sweep = [], {}
        for np_ in SPREAD2D_FIT_NP:
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((2, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
            gt = {g: [] for g in dims}
            for order in (dims, dims[::-1]):
                for g in order:
                    plan = nufft.set_points(dataclasses.replace(plan0, block_dims=g), pts)
                    vals = vp[:, plan.sort_perm].contiguous()
                    ms, _ = cuda_time_ms(lambda: _raw_spread_2d(shipped, "nufft_spread_2d_",
                                                                plan, vals))
                    gt[g].append(ms)
                    del plan, vals
                    torch.cuda.empty_cache()
            sweep[np_] = {"x".join(map(str, g)): sum(t) / len(t) for g, t in gt.items()}
            samples += [(g, 4, ncomp, np_, cells, 1e-3 * sum(t) / len(t))
                        for g, t in gt.items()]
        consts, mean_err = fit_spread2d(samples)
        saved = blocking.SPREAD2D_COST[(sb, ncomp)]
        blocking.SPREAD2D_COST[(sb, ncomp)] = consts
        pick = blocking.choose_geometry(plan0.shape_over, 4, sb, ncomp)
        blocking.SPREAD2D_COST[(sb, ncomp)] = saved
        print(json.dumps({"probe": "spread2d_fit", "card": card, "dtype": name,
                          "geometries_ms": sweep, "fit": consts,
                          "fit_mean_rel_err": mean_err, "fit_pick": list(pick),
                          "shipped_pick": list(new_g)}), flush=True)


#: Copies of csrc/spread_2d.cu with one phase taken out, for
#: ``--spread2d-parts``: each maps a line of the source (spread_mma.cuh
#: written in place of its include) to its replacement.  Their grids are
#: wrong; only their times are read.
SPREAD2D_PARTS = {
    "no_mma": {"nufft::mma_f64(acc[c][r], a[r], b);": "acc[c][r][0] += a[r][0] * b[0];"},
    # Every tap a number from z in place of Horner's rule; the staging
    # stores stay.
    "no_taps": {"tap_chunk<S, V>(wtaps, cs_d, ncoef, z, np, j, d, t0, w);":
                "for (int v = 0; v < V; ++v) w[v] = z + T(t0 + v);"},
    # No staging stores, and none of the erasing ones.
    "no_stores": {"col[row * kStride] = double(w[v]) * scale[k];":
                  "{ if (w[v] == T(1.25e-30)) col[row * kStride] = double(w[v]) * scale[k]; }",
                  "col[row * kStride] = 0.0;": "if (row == -7) col[row * kStride] = 0.0;"},
    # The flush's reductions as writes under a condition that never holds.
    "no_flush_write": {"  red_v2(p, float(re), float(im));": "  if (re == 1.25e-300) p[0] = float(im);",
                       "  atomicAdd(p, re);\n  atomicAdd(p + 1, im);":
                       "  if (re == 1.25e-300) p[0] = im;",
                       "nufft::red_v2(p0, float(d0), float(d1));":
                       "if (d0 == 1.25e-300) p0[0] = T(d1);",
                       "if (gy[c][0] >= 0 && d0 != 0.0) atomicAdd(p0, T(d0));":
                       "if (d0 == 1.25e-300) p0[0] = T(d0);",
                       "if (gy[c][1] >= 0 && d1 != 0.0) atomicAdd(line + gy[c][1], T(d1));":
                       "if (d1 == 1.25e-300) line[0] = T(d1);"},
}


def _inlined_source(stem: str) -> str:
    """``csrc/<stem>.cu`` with ``spread_mma.cuh`` written in place of its
    include, so that a probe can edit the header's code too."""
    from nonuniformffts_tpu_torch.ops.kernels import build

    src = (build.CSRC_DIR / f"{stem}.cu").read_text()
    header = (build.CSRC_DIR / "spread_mma.cuh").read_text().replace("#pragma once\n", "")
    return src.replace('#include "spread_mma.cuh"\n', header)


def probe_spread2d_parts(seed: int, dtypes, nps) -> None:
    """Where the 2D spread kernel's time goes: the shipped kernel and copies
    of its source with one phase taken out (``SPREAD2D_PARTS``), each built
    by this script for M = 4 alone into ``build/chip_probe/``, timed in turns at the
    chooser's pick on the same sorted points (CUDA events, median of 5, two
    passes), at each dtype's main-path Np and 16,777,216.  One JSON line a
    dtype and Np."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch.ops.kernels import build

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    src = _m_only(_inlined_source("spread_2d"))
    texts = {}
    for name, edits in SPREAD2D_PARTS.items():
        texts[name] = src
        for old, new in edits.items():
            if old not in src:
                raise AssertionError(f"{name}: {old!r} not in spread_2d.cu")
            texts[name] = texts[name].replace(old, new)
    libs = {"shipped": build.load()}
    with ThreadPoolExecutor(len(texts)) as pool:
        futures = {k: pool.submit(_probe_library, f"spread2d_{k}", text,
                                  ("-I", str(build.CSRC_DIR)))
                   for k, text in texts.items()}
        libs.update({k: f.result() for k, f in futures.items()})
    for name in texts:
        log = ROOT / "build" / "chip_probe" / f"spread2d_{name}.ptxas.log"
        print(f"ptxas {name}: {_registers_2d(log.read_text())}", flush=True)
    for name in dtypes:
        dtype = np.dtype(name)
        plan0 = nufft.PlanNUFFT(dtype, SHAPES[2], m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        for np_ in nps or (SPREAD2D_NP[name], 16_777_216):
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((2, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
            plan = nufft.set_points(plan0, pts)
            vals = vp[:, plan.sort_perm].contiguous()
            times = {k: [] for k in libs}
            for order in (list(libs), list(libs)[::-1]):
                for k in order:
                    ms, _ = cuda_time_ms(lambda: _raw_spread_2d(libs[k], "nufft_spread_2d_",
                                                                plan, vals))
                    times[k].append(ms)
            print(json.dumps({"probe": "spread2d_parts", "card": card, "dtype": name,
                              "np": np_, "block_dims": list(plan.block_dims),
                              "ms": {k: sum(t) / len(t) for k, t in times.items()}}),
                  flush=True)
            del plan, vals
            torch.cuda.empty_cache()


# The 3D interpolation kernel the staged-window design replaced (the first
# csrc/interp_3d.cu): a thread per sorted point gathering its (2M)^3 window
# from global memory with periodic wrap, and the C interface it had (no
# pstarts, no block dims).  Built by --interp3d into build/chip_probe/.
_POINT_INTERP_3D_SRC = r"""
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;

// TAPS: the window's taps come in wtaps (window_weights.cu), else by
// Horner's rule.  The two instantiations keep the Horner one's registers at
// what it needs alone: one kernel for both took 172 registers at M = 4 in
// 3D double, against 128, and halved the resident CTAs.
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kThreads) point_interp_3d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ grid,
    const int* __restrict__ cells, const T* __restrict__ fracs,
    const long long* __restrict__ perm, const T* __restrict__ coefs,
    const T* __restrict__ wtaps, nufft::Value<T, NCOMP>* __restrict__ out,
    long long np, int nchan, int ncoef, int n0, int n1, int n2,
    double normfactor) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // (3, S, ncoef)
  for (int i = threadIdx.x; i < 3 * S * ncoef; i += blockDim.x)
    cs[i] = coefs[i];
  __syncthreads();

  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= np) return;

  T wy[S], wz[S];
  int iy[S], iz[S];
  if constexpr (TAPS) {
#pragma unroll
    for (int t = 0; t < S; ++t) {
      wy[t] = wtaps[(S + t) * np + j];
      wz[t] = wtaps[(2 * S + t) * np + j];
    }
  } else {
    nufft::horner_taps<S>(cs + S * ncoef, ncoef, fracs[np + j], wy);
    nufft::horner_taps<S>(cs + 2 * S * ncoef, ncoef, fracs[2 * np + j], wz);
  }
  const int cx = cells[j] - (M - 1);
  const int cy = cells[np + j] - (M - 1);
  const int cz = cells[2 * np + j] - (M - 1);
#pragma unroll
  for (int t = 0; t < S; ++t) {
    iy[t] = nufft::wrap_index(cy + t, n1);
    iz[t] = nufft::wrap_index(cz + t, n2);
  }
  const T fx = fracs[j];
  const long long dest = perm[j];
  const long long volume = (long long)n0 * n1 * n2;
  const T nf = T(normfactor);

  for (int c = 0; c < nchan; ++c) {
    const nufft::Value<T, NCOMP>* g = grid + c * volume;
    T acc[NCOMP] = {};
    // The x loop stays rolled: unrolling all (2M)^3 taps spills registers
    // from M = 6 on and takes minutes to compile at M = 8.
#pragma unroll 1
    for (int a = 0; a < S; ++a) {
      T wx;
      if constexpr (TAPS) {
        wx = wtaps[a * np + j];
      } else {
        wx = nufft::horner_tap(cs + a * ncoef, ncoef, T(2) * fx - T(1));
      }
      const long long xrow = (long long)nufft::wrap_index(cx + a, n0) * n1;
      T ax[NCOMP] = {};
#pragma unroll
      for (int b = 0; b < S; ++b) {
        const nufft::Value<T, NCOMP>* row = g + (xrow + iy[b]) * n2;
        T r[NCOMP] = {};
#pragma unroll
        for (int e = 0; e < S; ++e) {
          const nufft::Value<T, NCOMP> val = row[iz[e]];
#pragma unroll
          for (int k = 0; k < NCOMP; ++k) r[k] = nufft::fma_t(val.c[k], wz[e], r[k]);
        }
#pragma unroll
        for (int k = 0; k < NCOMP; ++k) ax[k] = nufft::fma_t(r[k], wy[b], ax[k]);
      }
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) acc[k] = nufft::fma_t(ax[k], wx, acc[k]);
    }
    nufft::Value<T, NCOMP> res;
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) res.c[k] = acc[k] * nf;
    out[c * np + dest] = res;
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* grid, const void* cells, const void* fracs,
                   const void* perm, const void* coefs,
                   const void* wtaps, void* out,
                   long long np, int nchan, int ncoef, int n0, int n1, int n2,
                   double normfactor, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 3 * 2 * M * ncoef;
  const long long nblocks = (np + kThreads - 1) / kThreads;
  auto kernel = wtaps ? point_interp_3d_kernel<M, T, NCOMP, true>
                      : point_interp_3d_kernel<M, T, NCOMP, false>;
  kernel<<<(unsigned)nblocks, kThreads, smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(grid),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const long long*>(perm), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps),
      static_cast<nufft::Value<T, NCOMP>*>(out), np, nchan, ncoef, n0, n1,
      n2, normfactor);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* grid, const void* cells, const void* fracs,
             const void* perm, const void* coefs,
             const void* wtaps, void* out, long long np,
             int nchan, int m, int ncoef, int n0, int n1, int n2,
             double normfactor, void* stream) {
  if (np == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_INTERP_CASE(MM)                                               \
  case MM:                                                                  \
    return (int)launch<MM, T, NCOMP>(grid, cells, fracs, perm, coefs, wtaps, \
                                     out, np, nchan, ncoef, n0, n1, n2,     \
                                     normfactor, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_INTERP_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_INTERP_CASE
}

}  // namespace

// The C interface the library's kernel had before it staged blocks.
// grid (nchan, n0, n1, n2) values (complex: re, im interleaved); cells
// (3, np) int32 and fracs (3, np) T in bin-sorted order; perm (np,) int64,
// the original index of each sorted point; coefs (3, 2m, ncoef) T, or
// ncoef = 0 and no coefficients for a window other than kHorner, whose taps
// come in wtaps (3, 2m, np) T (window_weights.cu), null for kHorner; out
// (nchan, np) values in original point order.  T is float for *_f32, double
// for *_f64; normfactor is a double for both.  Launches on `stream`, does
// not synchronise, allocates nothing.
#define NUFFT_INTERP_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* grid, const void* cells, const void* fracs, \
                      const void* perm, const void* coefs,                    \
                      const void* wtaps, void* out,              \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      int n1, int n2, double normfactor, void* stream) {      \
    return dispatch<T, NCOMP>(grid, cells, fracs, perm, coefs, wtaps, out, np,  \
                              nchan, m, ncoef, n0, n1, n2, normfactor,        \
                              stream);                                        \
  }

#if NUFFT_WANT(0)
NUFFT_INTERP_ENTRY(point_interp_3d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_INTERP_ENTRY(point_interp_3d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_INTERP_ENTRY(point_interp_3d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_INTERP_ENTRY(point_interp_3d_real_f64, double, 1)
#endif
"""


#: Variants of the staged-window interpolation kernel (-D values of
#: csrc/interp_3d.cu's tunables), each for every value type: the threshold
#: below which a block is read from global memory (s; 0: every block staged,
#: "all": none), register caps for 2, 3 and 4 resident CTAs an SM (c), tap
#: batches (b), CTAs of 128 threads.
_S, _C, _B = "-DNUFFT_INTERP3D_SPARSE=", "-DNUFFT_INTERP3D_MIN_CTAS=", "-DNUFFT_INTERP3D_BATCH="
INTERP3D_VARIANTS = {"s0": [_S + "0"], "s32": [_S + "32"], "s128": [_S + "128"],
                     "sall": [_S + "(1 << 30)"], "c2": [_C + "2"], "c3": [_C + "3"],
                     "c4": [_C + "4"], "b64": [_B + "64"], "b128": [_B + "128"],
                     "b256": [_B + "256"],
                     "threads128": ["-DNUFFT_INTERP3D_THREADS=128", _C + "6"]}
#: Point counts at N = 256^3 beside each dtype's main-path Np (SPREAD3D_NP):
#: rho = 0.01 and rho = 1.
INTERP3D_EXTRA_NP = (167_772, 16_777_216)


def _m_only(text: str, ms=(4,)) -> str:
    """A kernel source instantiated for the M of ``ms`` alone (M = 4 by
    default: a quick build)."""
    anchor = '#include "window.cuh"\n'
    cases = " ".join(f"CASE({m})" for m in ms)
    return text.replace(anchor, anchor + "#undef NUFFT_FOR_EACH_M\n"
                        f"#define NUFFT_FOR_EACH_M(CASE) {cases}\n", 1)


def _interp_registers(text: str) -> str:
    """Registers and spill stores of the M = 4 3D interpolation
    instantiations in a ptxas log."""
    regs = re.findall(r"interp_3d_kernelILi4E([fd])Li(\d)ELb([01])E.*?(\d+) bytes spill stores"
                      r".*?Used (\d+) registers", text, re.S)
    return ", ".join(f"<{t}, {n}{', taps' if b == '1' else ''}> {r} (spills {sp} B)"
                     for t, n, b, sp, r in regs)


def _raw_interp(lib, name: str, plan, grid, staged: bool = True):
    """One launch of the 3D interpolation entry point ``name`` of ``lib`` on
    the plan's sorted state (BKB Fast, one transform): the staged kernel's
    C interface, or with ``staged`` False the per-point kernel's."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    fn = getattr(lib, name)
    sig = build._SIGNATURES["nufft_interp_3d_" + VALUE_TYPES[plan.dtype][0]]
    # the per-point kernel: no pstarts, no block dims
    fn.argtypes = sig if staged else sig[:4] + sig[5:15] + sig[18:]
    out = torch.empty((1, plan.num_points), dtype=grid.dtype, device=grid.device)
    blocks = ((plan.pstarts.data_ptr(),), plan.block_dims) if staged else ((), ())
    err = fn(grid.data_ptr(), plan.cells_sorted.data_ptr(), plan.fracs_sorted.data_ptr(),
             plan.sort_perm.data_ptr(), *blocks[0], plan.coefs.data_ptr(), 0, out.data_ptr(),
             plan.num_points, 1, plan.m, plan.coefs.shape[-1], *plan.shape_over,
             *blocks[1], float(plan.normfactor), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def probe_interp3d(seed: int, dtypes, nps) -> None:
    """The staged-window 3D interpolation kernel against the per-point kernel
    it replaced (``_POINT_INTERP_3D_SRC``), in turns (old, new, new, old),
    two passes, on the same sorted points and grid, both held against the
    plain version; then its variants (``INTERP3D_VARIANTS``) in turns with
    the shipped build.  The old kernel and the variants are built for M = 4
    alone into ``build/chip_probe/``.  3D, N = 256^3 (grid 384^3), m = 4,
    sigma = 1.5, BKB FastApproximation, uniform points, the chooser's block
    dims; each dtype at its main-path Np, at rho = 0.01 and at rho = 1
    (``INTERP3D_EXTRA_NP``); CUDA events, median of 5 after one warm-up.
    One JSON line a dtype and Np, with the card's name and power limit, the
    bound (``chip_smoke.kernel_bound``) and the points a block."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, kernel_bound, nvidia_smi_line, rel_l2
    from nonuniformffts_tpu_torch.ops.kernels import blocked, build
    from nonuniformffts_tpu_torch.ops.kernels.common import INTERP3D_THREADS, VALUE_TYPES

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    new_src = _m_only((build.CSRC_DIR / "interp_3d.cu").read_text())
    inc = ("-I", str(build.CSRC_DIR))
    jobs = {"old": (_m_only(_POINT_INTERP_3D_SRC), inc),
            **{k: (new_src, inc + tuple(f)) for k, f in INTERP3D_VARIANTS.items()}}
    shipped = build.load()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_probe_library, f"interp3d_{k}", text, flags)
                   for k, (text, flags) in jobs.items()}
        libs = {k: f.result() for k, f in futures.items()}
    print(f"ptxas shipped ({INTERP3D_THREADS} threads): "
          f"{_interp_registers(build.PTXAS_LOG.read_text())}", flush=True)
    for k in jobs:
        log = ROOT / "build" / "chip_probe" / f"interp3d_{k}.ptxas.log"
        print(f"ptxas {k}: {_interp_registers(log.read_text())}", flush=True)
    for name in dtypes:
        dtype = np.dtype(name)
        plan0 = nufft.PlanNUFFT(dtype, SHAPES[3], m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        tol = 1e-5 if plan0.real_dtype == torch.float32 else 1e-12
        entry = "nufft_interp_3d_" + VALUE_TYPES[plan0.dtype][0]
        for np_ in nps or (SPREAD3D_NP[name],) + INTERP3D_EXTRA_NP:
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((3, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            plan = nufft.set_points(plan0, pts)
            grid = torch.randn((1,) + plan.shape_over, generator=gen, device=dev,
                               dtype=plan0.dtype)
            want = blocked.interpolate_blocked_plain(
                dataclasses.replace(plan, chunk_size=1 << 16), grid)
            counts = (plan.pstarts[1:] - plan.pstarts[:-1]).float()
            runs = {"old": lambda: _raw_interp(libs["old"], "point_" + entry[6:], plan, grid,
                                               staged=False),
                    "new": lambda: _raw_interp(shipped, entry, plan, grid)}
            runs.update({k: (lambda lib=libs[k]: _raw_interp(lib, entry, plan, grid))
                         for k in INTERP3D_VARIANTS})
            times = {k: [] for k in runs}
            errs = {}
            order = ["old", "new", "new", "old"]
            variant_order = ["new", *INTERP3D_VARIANTS]
            for rnd in range(2):
                for k in order + (variant_order if rnd == 0 else variant_order[::-1]):
                    ms, got = cuda_time_ms(runs[k])
                    err = rel_l2(got, want)
                    errs[k] = max(errs.get(k, 0.0), err)
                    if k in ("old", "new") and not err <= tol:
                        raise AssertionError(f"{name} {np_} {k}: rel L2 {err:.3e} vs plain")
                    times[k].append(ms)
                    del got
            same = torch.equal(runs["old"](), runs["new"]())  # the same FMAs in the same order
            bound_ms, bound_by = kernel_bound("interp", plan, 1)
            line = {"probe": "interp3d", "card": card, "dtype": name, "np": np_,
                    "block_dims": list(plan.block_dims),
                    "points_a_block": {"mean_nonempty": float(counts[counts > 0].mean()),
                                       "max": int(counts.max()),
                                       "empty_share": float((counts == 0).float().mean())},
                    "ms": {k: statistics.median(t) for k, t in times.items()},
                    "rel_l2": errs, "old_equals_new": same, "bound_ms": bound_ms,
                    "bound_by": bound_by}
            line["speedup"] = line["ms"]["old"] / line["ms"]["new"]
            print(json.dumps(line), flush=True)
            del plan, grid, want, pts
            torch.cuda.empty_cache()


#: Copies of csrc/interp_3d.cu with one phase taken out, for
#: ``--interp3d-parts``: each maps a line of the source to its replacement.
#: Their values are wrong; only their times and registers are read.
INTERP3D_PARTS = {
    "no_stage": {"for (int l = l0; l < w.pd2; l += 32) cp_async":
                 "for (int l = l0; l < 0; l += 32) cp_async"},
    "no_taps": {"s_tap[row * kBatch + p] = tap<M, T, TAPS>(cs, ncoef, "
                "fracs[d * np + pb + p], wtaps, np,":
                "s_tap[row * kBatch + p] = T(0.1) * T(d + 1);\n"
                "      (void)tap<M, T, TAPS>(cs, ncoef, T(0), wtaps, np,"},
    "no_loads": {"[&](int a, int k) { return base[a * w.plane + k * L::kRows * w.pitch]; });":
                 "[&](int a, int k) { V v; v.c[0] = T(a + k); return v; });"},
    "no_reduce": {"for (int off = L::kPerPoint / 2; off >= 1; off /= 2)":
                  "for (int off = 0; off >= 1; off /= 2)"},
    "no_out": {"            *dst = res;": "            if (res.c[0] == T(1.25e-30)) *dst = res;"},
}
INTERP3D_PARTS["no_cells"] = {
    "            const int lx = cells[pb + p] - ox;": "            const int lx = (pb + p) & 7;",
    "            s_pt[kBatch + p] = lx * w.plane + (cells[np + pb + p] - oy) * w.pitch +\n"
    "                               (cells[2 * np + pb + p] - oz);":
    "            s_pt[kBatch + p] = lx * w.plane + ((p >> 3) & 7) * w.pitch + (p & 7);"}
INTERP3D_PARTS["no_contract"] = {
    "          contract_batch<T, NCOMP, L>(nb, s_res, [&](int p) {\n"
    "            if (p >= nb || ze >= S) return V{};":
    "          if (nb < 0) contract_batch<T, NCOMP, L>(nb, s_res, [&](int p) {\n"
    "            if (p >= nb || ze >= S) return V{};"}
# All of the window's copy, the taps and the window's loads out at once: the
# CTAs' skeleton; then also without the output and the cells' loads.
INTERP3D_PARTS["skeleton"] = {k: v for part in ("no_stage", "no_taps", "no_loads")
                              for k, v in INTERP3D_PARTS[part].items()}
INTERP3D_PARTS["skeleton_no_out"] = {**INTERP3D_PARTS["skeleton"], **INTERP3D_PARTS["no_out"]}
INTERP3D_PARTS["skeleton_no_cells"] = {**INTERP3D_PARTS["skeleton_no_out"],
                                       **INTERP3D_PARTS["no_cells"]}


def probe_interp3d_parts(seed: int, dtypes, nps) -> None:
    """Where the 3D interpolation kernel's time goes: the shipped source
    and copies with one phase taken out (``INTERP3D_PARTS``: the window's
    copy, the taps, the window's loads, the lanes' reduction), each built
    for M = 4 into ``build/chip_probe/``, timed in turns on the same sorted
    points (CUDA events, median of 5, two passes).  One JSON line a dtype
    and Np."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    src = _m_only((build.CSRC_DIR / "interp_3d.cu").read_text())
    texts = {"shipped": src}
    for name, edits in INTERP3D_PARTS.items():
        text = src
        for old, new in edits.items():
            if old not in text:
                raise AssertionError(f"{name}: {old!r} not in interp_3d.cu")
            text = text.replace(old, new)
        texts[name] = text
    inc = ("-I", str(build.CSRC_DIR))
    with ThreadPoolExecutor(len(texts)) as pool:
        futures = {k: pool.submit(_probe_library, f"interp3d_part_{k}", t, inc)
                   for k, t in texts.items()}
        libs = {k: f.result() for k, f in futures.items()}
    for k in texts:
        log = ROOT / "build" / "chip_probe" / f"interp3d_part_{k}.ptxas.log"
        print(f"ptxas {k}: {_interp_registers(log.read_text())}", flush=True)
    for name in dtypes:
        plan0 = nufft.PlanNUFFT(np.dtype(name), SHAPES[3], m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        entry = "nufft_interp_3d_" + VALUE_TYPES[plan0.dtype][0]
        for np_ in nps or (SPREAD3D_NP[name], 16_777_216):
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((3, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            plan = nufft.set_points(plan0, pts)
            grid = torch.randn((1,) + plan.shape_over, generator=gen, device=dev,
                               dtype=plan0.dtype)
            times = {k: [] for k in libs}
            for order in (list(libs), list(libs)[::-1]):
                for k in order:
                    ms, _ = cuda_time_ms(lambda: _raw_interp(libs[k], entry, plan, grid))
                    times[k].append(ms)
            print(json.dumps({"probe": "interp3d_parts", "card": card, "dtype": name,
                              "np": np_, "block_dims": list(plan.block_dims),
                              "ms": {k: sum(t) / len(t) for k, t in times.items()}}),
                  flush=True)
            del plan, grid, pts
            torch.cuda.empty_cache()


def probe_spread3d_parts(seed: int, dtypes, nps) -> None:
    """Where the 3D spread kernel's time goes: the shipped kernel and copies
    of its source with one phase taken out (``SPREAD3D_PARTS``: the MMAs,
    the dense operand build, the tap evaluation, the flush), each built by
    this script into ``build/chip_probe/``, timed in turns at the chooser's
    pick on the same sorted points (CUDA events, median of 5, two passes).
    One JSON line a dtype and Np."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch.ops.kernels import build

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    src = _inlined_source("spread_3d")
    libs = {"shipped": build.load()}
    for name, edits in SPREAD3D_PARTS.items():
        text = src
        for old, new in edits.items():
            if old not in text:
                raise AssertionError(f"{name}: {old!r} not in spread_3d.cu")
            text = text.replace(old, new)
        libs[name] = _probe_library(f"spread3d_{name}", text, ("-I", str(build.CSRC_DIR)))
        log = ROOT / "build" / "chip_probe" / f"spread3d_{name}.ptxas.log"
        print(f"ptxas {name}: {_m4_registers(log.read_text())}", flush=True)
    for name in dtypes:
        dtype = np.dtype(name)
        plan0 = nufft.PlanNUFFT(dtype, SHAPES[3], m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        for np_ in nps or (SPREAD3D_NP[name], 16_777_216):
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((3, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
            plan = nufft.set_points(plan0, pts)
            vals = vp[:, plan.sort_perm].contiguous()
            times = {k: [] for k in libs}
            for order in (list(libs), list(libs)[::-1]):
                for k in order:
                    ms, _ = cuda_time_ms(lambda: _raw_spread(libs[k], "nufft_spread_3d_",
                                                             plan, vals))
                    times[k].append(ms)
            print(json.dumps({"probe": "spread3d_parts", "card": card, "dtype": name,
                              "np": np_, "block_dims": list(plan.block_dims),
                              "ms": {k: sum(t) / len(t) for k, t in times.items()}}),
                  flush=True)
            del plan, vals
            torch.cuda.empty_cache()


# The 1D spread kernel the lane-a-cell design replaced (the csrc/spread_1d.cu of
# PRs 3-9): a thread a padded cell summing, over the 2M local cells that
# reach it, each cell's points read from global memory (so each point is
# read 2M times), every padded cell flushed with global atomicAdd; its C
# interface takes the values sorted (no perm).  Built by --spread1d into
# build/chip_probe/.
_CELL_SPREAD_1D_SRC = r"""
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;
using Acc = double;  // ops/kernels/common.py:ACC_BYTES

// Must match ops/kernels/common.py:spread_smem_bytes for D = 1.
template <typename T>
size_t spread_smem_bytes(int m, int ncoef, int b0) {
  return sizeof(T) * (size_t)(2 * m) * ncoef + sizeof(int) * (size_t)(b0 + 1);
}

template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kThreads) spread_1d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, long long np, int ncoef, int n0, int b0) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);                  // (S, ncoef)
  int* starts = reinterpret_cast<int*>(cs + S * ncoef);    // (b0 + 1,)

  const int bid = blockIdx.x;
  const int chan = blockIdx.y;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA

  const int tid = threadIdx.x;
  const int ox = bid * b0;
  for (int i = tid; i < S * ncoef; i += blockDim.x) cs[i] = coefs[i];
  for (int j = p_begin + tid; j < p_end; j += blockDim.x) {
    const int lx = cells[j] - ox;
    const int prev = j == p_begin ? -1 : cells[j - 1] - ox;
    for (int c = prev + 1; c <= lx; ++c) starts[c] = j;
    if (j == p_end - 1)
      for (int c = lx + 1; c <= b0; ++c) starts[c] = p_end;
  }
  __syncthreads();

  const nufft::Value<T, NCOMP>* vrow = vals + (long long)chan * np;
  T* g = grid + (long long)chan * n0 * NCOMP;
  for (int i = tid; i < b0 + S - 1; i += blockDim.x) {
    Acc acc[NCOMP] = {};
    const int c_lo = i - (S - 1) > 0 ? i - (S - 1) : 0;
    const int c_hi = i < b0 - 1 ? i : b0 - 1;
    for (int c = c_lo; c <= c_hi; ++c) {
      const T* cst = cs + (i - c) * ncoef;  // tap i - c
      const int j_end = starts[c + 1];
      for (int j = starts[c]; j < j_end; ++j) {
        const T w = nufft::point_tap<S>(wtaps, cst, ncoef, fracs[j], np, j, 0, i - c);
        const nufft::Value<T, NCOMP> v = vrow[j];
#pragma unroll
        for (int k = 0; k < NCOMP; ++k) acc[k] = nufft::fma_t(Acc(v.c[k]), Acc(w), acc[k]);
      }
    }
    bool any = false;
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) any = any || acc[k] != Acc(0);
    if (!any) continue;
    const long long off = NCOMP * (long long)nufft::wrap_index(ox - (M - 1) + i, n0);
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) atomicAdd(g + off + k, T(acc[k]));
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* vals, const void* cells, const void* fracs,
                   const void* pstarts, const void* coefs, const void* wtaps,
                   void* grid,
                   long long np, int nchan, int ncoef, int n0, int b0,
                   cudaStream_t stream) {
  const size_t smem = spread_smem_bytes<T>(M, ncoef, b0);
  cudaError_t err = cudaFuncSetAttribute(
      spread_1d_kernel<M, T, NCOMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks(n0 / b0, nchan);
  spread_1d_kernel<M, T, NCOMP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(vals),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const int*>(pstarts), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps), static_cast<T*>(grid), np, ncoef, n0, b0);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* vals, const void* cells, const void* fracs,
             const void* pstarts, const void* coefs, const void* wtaps,
             void* grid, long long np, int nchan, int m, int ncoef, int n0,
             int b0, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_SPREAD_CASE(MM)                                            \
  case MM:                                                               \
    return (int)launch<MM, T, NCOMP>(vals, cells, fracs, pstarts, coefs, \
                                     wtaps, grid, np, nchan, ncoef, n0, b0, \
                                     s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_SPREAD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_SPREAD_CASE
}

}  // namespace

// vals (nchan, np) values in bin-sorted order (complex: re, im interleaved);
// cells (1, np) int32 and fracs (1, np) T, sorted; pstarts (nblocks + 1,)
// int32; coefs (1, 2m, ncoef) T, or ncoef = 0 and no coefficients for a
// window other than kHorner, whose taps come in wtaps (1, 2m, np) T
// (window_weights.cu), null for kHorner; grid (nchan, n0) values, zeroed by
// the caller.  T is float for *_f32, double for *_f64.  Launches on `stream`,
// does not synchronise, allocates nothing.
#define NUFFT_SPREAD_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* vals, const void* cells, const void* fracs, \
                      const void* pstarts, const void* coefs,                 \
                      const void* wtaps, void* grid, long long np, int nchan, \
                      int m, int ncoef, int n0, int b0, void* stream) {       \
    return dispatch<T, NCOMP>(vals, cells, fracs, pstarts, coefs, wtaps,      \
                              grid, np, nchan, m, ncoef, n0, b0, stream);     \
  }

#if NUFFT_WANT(0)
NUFFT_SPREAD_ENTRY(cell_spread_1d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_SPREAD_ENTRY(cell_spread_1d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_SPREAD_ENTRY(cell_spread_1d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_SPREAD_ENTRY(cell_spread_1d_real_f64, double, 1)
#endif
"""


# The first 2D interpolation kernel (csrc/interp_2d.cu before its
# redesign): a thread a bin-sorted point, its 2M y taps by horner_taps (a
# runtime loop a tap) or from K3's wtaps, the x loop kept rolled with one x
# tap a step by horner_tap, each row's 2M cells read from global memory with
# periodic wrap at a 64-bit row address, its result scattered to
# out[c, perm[j]].  Kept for --interp2d, which times it in turns with the
# shipped kernel and the staged design, and for --interp2d-parts
# (POINT_INTERP2D_PARTS); the same C interface as the shipped kernel.  Built
# by them into build/chip_probe/.
_POINT_INTERP_2D_SRC = r"""
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;

// TAPS: the window's taps come in wtaps (window_weights.cu), else by
// Horner's rule.  The two instantiations keep the Horner one's registers at
// what it needs alone: one kernel for both took 172 registers at M = 4 in
// 3D double, against 128, and halved the resident CTAs.
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kThreads) interp_2d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ grid,
    const int* __restrict__ cells, const T* __restrict__ fracs,
    const long long* __restrict__ perm, const T* __restrict__ coefs,
    const T* __restrict__ wtaps, nufft::Value<T, NCOMP>* __restrict__ out,
    long long np, int nchan, int ncoef, int n0, int n1, double normfactor) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // (2, S, ncoef)
  for (int i = threadIdx.x; i < 2 * S * ncoef; i += blockDim.x)
    cs[i] = coefs[i];
  __syncthreads();

  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= np) return;

  T wy[S];
  int iy[S];
  if constexpr (TAPS) {
#pragma unroll
    for (int t = 0; t < S; ++t) wy[t] = wtaps[(S + t) * np + j];
  } else {
    nufft::horner_taps<S>(cs + S * ncoef, ncoef, fracs[np + j], wy);
  }
  const int cx = cells[j] - (M - 1);
  const int cy = cells[np + j] - (M - 1);
#pragma unroll
  for (int t = 0; t < S; ++t) iy[t] = nufft::wrap_index(cy + t, n1);
  const T fx = fracs[j];
  const long long dest = perm[j];
  const long long area = (long long)n0 * n1;
  const T nf = T(normfactor);

  for (int c = 0; c < nchan; ++c) {
    const nufft::Value<T, NCOMP>* g = grid + c * area;
    T acc[NCOMP] = {};
#pragma unroll 1
    for (int a = 0; a < S; ++a) {
      T wx;
      if constexpr (TAPS) {
        wx = wtaps[a * np + j];
      } else {
        wx = nufft::horner_tap(cs + a * ncoef, ncoef, T(2) * fx - T(1));
      }
      const nufft::Value<T, NCOMP>* row =
          g + (long long)nufft::wrap_index(cx + a, n0) * n1;
      T r[NCOMP] = {};
#pragma unroll
      for (int b = 0; b < S; ++b) {
        const nufft::Value<T, NCOMP> val = row[iy[b]];
#pragma unroll
        for (int k = 0; k < NCOMP; ++k) r[k] = nufft::fma_t(val.c[k], wy[b], r[k]);
      }
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) acc[k] = nufft::fma_t(r[k], wx, acc[k]);
    }
    nufft::Value<T, NCOMP> res;
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) res.c[k] = acc[k] * nf;
    out[c * np + dest] = res;
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* grid, const void* cells, const void* fracs,
                   const void* perm, const void* coefs,
                   const void* wtaps, void* out,
                   long long np, int nchan, int ncoef, int n0, int n1,
                   double normfactor, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 2 * 2 * M * ncoef;
  const long long nblocks = (np + kThreads - 1) / kThreads;
  auto kernel = wtaps ? interp_2d_kernel<M, T, NCOMP, true>
                      : interp_2d_kernel<M, T, NCOMP, false>;
  kernel<<<(unsigned)nblocks, kThreads, smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(grid),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const long long*>(perm), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps),
      static_cast<nufft::Value<T, NCOMP>*>(out), np, nchan, ncoef, n0, n1,
      normfactor);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* grid, const void* cells, const void* fracs,
             const void* perm, const void* coefs,
             const void* wtaps, void* out, long long np,
             int nchan, int m, int ncoef, int n0, int n1, double normfactor,
             void* stream) {
  if (np == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_INTERP_CASE(MM)                                              \
  case MM:                                                                 \
    return (int)launch<MM, T, NCOMP>(grid, cells, fracs, perm, coefs, wtaps, \
                                     out, np, nchan, ncoef, n0, n1,         \
                                     normfactor, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_INTERP_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_INTERP_CASE
}

}  // namespace

// grid (nchan, n0, n1) values (complex: re, im interleaved); cells (2, np)
// int32 and fracs (2, np) T in bin-sorted order; perm (np,) int64, the
// original index of each sorted point; coefs (2, 2m, ncoef) T, or ncoef = 0
// and no coefficients for a window other than kHorner, whose taps come in
// wtaps (2, 2m, np) T (window_weights.cu), null for kHorner; out
// (nchan, np) values in original point order.  T is float for *_f32, double
// for *_f64; normfactor is a double for both.  Launches on `stream`, does
// not synchronise, allocates nothing.
#define NUFFT_INTERP_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* grid, const void* cells, const void* fracs, \
                      const void* perm, const void* coefs,                    \
                      const void* wtaps, void* out,              \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      int n1, double normfactor, void* stream) {              \
    return dispatch<T, NCOMP>(grid, cells, fracs, perm, coefs, wtaps, out, np,  \
                              nchan, m, ncoef, n0, n1, normfactor, stream);   \
  }

#if NUFFT_WANT(0)
NUFFT_INTERP_ENTRY(point_interp_2d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_INTERP_ENTRY(point_interp_2d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_INTERP_ENTRY(point_interp_2d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_INTERP_ENTRY(point_interp_2d_real_f64, double, 1)
#endif
"""


# A 2D interpolation kernel tried in place of the per-point kernel of
# csrc/interp_2d.cu, kept for --interp2d, which times the two in turns: a CTA
# covers a run of consecutive blocks of one x row of blocks (pstarts); each
# sub-run of blocks whose padded window holds at most kStageCells cells a
# point is staged in shared memory by cp.async (in x-slab passes above
# 227 KB), its points dealt round robin over the banks of a wavefront by
# shared-memory bucket counts and contracted a thread a point from the
# window; the points of sparser sub-runs are read from global memory.  Its C
# interface adds pstarts and the block dims to the shipped kernel's.  Built
# by --interp2d into build/chip_probe/.
_STAGED_INTERP_2D_SRC = r"""
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;
// A sub-run is staged when its padded window holds at most this many cells
// a point.
constexpr int kStageCells = 8;
constexpr int kStageRun = 256;    // most y cells of a staged sub-run's blocks
constexpr int kRunPoints = 1024;  // points of a CTA's staged run at the mean density
constexpr int kChunk = 1024;      // points of a staged sub-run ordered at a time

constexpr int kMaxGroup = 64;  // most spatial blocks one CTA covers
constexpr size_t kMaxSmem = 232448;

// y taps of a coefficient row: 2M rounded up to a power of two (at least 4).
__host__ __device__ constexpr int y_span(int m) {
  return 2 * m <= 4 ? 4 : 2 * m <= 8 ? 8 : 2 * m <= 16 ? 16 : 32;
}

// The staged window of a sub-run of `sub` blocks: cells, x rows pd1 cells
// apart; `rows` x rows staged a pass, `passes` passes; `head` bytes of
// tables before it.
struct Window {
  int pd0, pd1, rows, passes;
  size_t head, smem;
};

template <int M, typename T, int NCOMP>
__host__ __device__ inline Window window_of(int ncoef, int b0, int b1, int sub) {
  Window w;
  w.pd0 = b0 + 2 * M - 1;
  w.pd1 = sub * b1 + 2 * M - 1;
  // The (ncoef, 2, span) coefficient table, the bucket counts, a chunk's
  // order, window offsets and bucket ranks, the CTA's blocks' point ranges.
  constexpr int kBuckets = 128 / int(sizeof(T) * NCOMP);
  const size_t head = sizeof(T) * ncoef * 2 * y_span(M) +
                      sizeof(int) * (kBuckets + 3 * kChunk + kMaxGroup + 1);
  w.head = (head + 15) / 16 * 16;
  const size_t row_bytes = sizeof(T) * NCOMP * (size_t)w.pd1;
  const long long fit = w.head < kMaxSmem ? (long long)((kMaxSmem - w.head) / row_bytes) : 0;
  w.passes = fit >= 1 ? (int)((w.pd0 + fit - 1) / fit) : 0;
  w.rows = w.passes ? (w.pd0 + w.passes - 1) / w.passes : 0;
  w.smem = w.head + row_bytes * w.rows;
  return w;
}

// Blocks of a staged sub-run: at most kStageRun y cells, at least one block.
__host__ __device__ inline int sub_of(int group, int b1) {
  const int fit = kStageRun / b1 > 1 ? kStageRun / b1 : 1;
  return group < fit ? group : fit;
}

// Blocks a CTA covers, at most kMaxGroup and a row of blocks: where a full sub-run at the mean density
// is staged, whole sub-runs of about kRunPoints points; else about a CTA's
// threads' worth of points, each thread's one point read from global
// memory.
__host__ inline int group_of(long long np, int m, int n0, int n1, int b0, int b1) {
  const long long nb1 = n1 / b1, mean = np / ((n0 / b0) * nb1);
  const long long cap = nb1 < kMaxGroup ? nb1 : kMaxGroup;
  const long long fit = sub_of((int)cap, b1);
  long long g;
  if (mean * fit * kStageCells >= (long long)(b0 + 2 * m - 1) * (fit * b1 + 2 * m - 1)) {
    g = kRunPoints / (mean + 1);
    g = g > fit ? g / fit * fit : fit;
  } else {
    g = kThreads / (mean + 1);
  }
  return (int)(g < 1 ? 1 : g > cap ? cap : g);
}

// Whether a sub-run of `points` points whose window has pd0 x pd1 cells
// is staged.
__device__ __forceinline__ bool staged_run(int points, int pd0, int pd1) {
  return points > 0 && (long long)points * kStageCells >= (long long)pd0 * pd1;
}

// window.cuh's (copies of its own beside them were ambiguous by
// argument-dependent lookup).
using nufft::cp_async;
using nufft::cp_async_commit;
using nufft::cp_async_wait_all;
using nufft::mod_index;

// Both dims' 2M taps of sorted point j: from wtaps, or by Horner's rule on
// the coefficient table cs, (ncoef, 2, y_span(M)).
template <int M, typename T, bool TAPS>
__device__ __forceinline__ void point_taps_2d(const T* cs, int ncoef, const T* __restrict__ fracs,
                                              const T* __restrict__ wtaps, long long np,
                                              long long j, T (&w)[2][2 * M]) {
  constexpr int S = 2 * M, kSpan = y_span(M);
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    if constexpr (TAPS) {
#pragma unroll
      for (int t = 0; t < S; ++t) w[d][t] = wtaps[(d * S + t) * np + j];
    } else {
      nufft::horner_rows<S, T, 2 * kSpan>(cs + d * kSpan, ncoef, fracs[d * np + j], w[d]);
    }
  }
}

// One point's sum over x taps a with has_x(a): row by row, each row's y
// taps first (the first design's order), UNROLL rows at a time; at(a, b)
// reads cell (a, b) of the point's window.
template <int M, typename T, int NCOMP, int UNROLL, class HasX, class At>
__device__ __forceinline__ nufft::Value<T, NCOMP> point_sum(const T (&w)[2][2 * M], HasX has_x,
                                                            At at) {
  constexpr int S = 2 * M;
  nufft::Value<T, NCOMP> acc = {};
#pragma unroll UNROLL
  for (int a = 0; a < S; ++a) {
    if (!has_x(a)) continue;
    T r[NCOMP] = {};
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const nufft::Value<T, NCOMP> v = at(a, b);
#pragma unroll
      for (int n = 0; n < NCOMP; ++n) r[n] = nufft::fma_t(v.c[n], w[1][b], r[n]);
    }
#pragma unroll
    for (int n = 0; n < NCOMP; ++n) acc.c[n] = nufft::fma_t(r[n], w[0][a], acc.c[n]);
  }
  return acc;
}

// One CTA covers a run of at most `group` consecutive blocks of one x row
// of blocks, in sub-runs of at most `sub` blocks.  TAPS: the window's taps
// come in wtaps (window_weights.cu), else by Horner's rule.
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
    interp_2d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ grid,
    const int* __restrict__ cells, const T* __restrict__ fracs,
    const long long* __restrict__ perm, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    nufft::Value<T, NCOMP>* __restrict__ out, long long np, int nchan,
    int ncoef, int n0, int n1, int b0, int b1, int group, double normfactor) {
  using V = nufft::Value<T, NCOMP>;
  constexpr int S = 2 * M, kSpan = y_span(M), kCol = 2 * kSpan;
  constexpr int kBuckets = 128 / int(sizeof(V));  // cells of a wavefront
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int nb1 = n1 / b1;
  const int runs = (nb1 + group - 1) / group;  // runs a row of blocks
  const int bx = blockIdx.x / runs;
  const int run = blockIdx.x - bx * runs;
  const int first = bx * nb1 + run * group;
  const int ng = min(group, nb1 - run * group);  // blocks of this CTA
  const int sub = sub_of(group, b1);
  const int nsub = (ng + sub - 1) / sub;  // sub-runs of this CTA

  const Window w = window_of<M, T, NCOMP>(ncoef, b0, b1, sub);
  T* cs = reinterpret_cast<T*>(smem_raw);              // (ncoef, 2, kSpan), zero past 2M
  int* s_cnt = reinterpret_cast<int*>(cs + kCol * ncoef);  // (kBuckets,)
  int* s_order = s_cnt + kBuckets;                     // (kChunk,): a chunk's points in order
  int* s_base = s_order + kChunk;                      // (kChunk,): window offsets
  int* s_rank = s_base + kChunk;                       // (kChunk,): bucket | rank << 8
  int* s_ps = s_rank + kChunk;                         // (ng + 1,): the blocks' point ranges
  V* win = reinterpret_cast<V*>(smem_raw + w.head);    // (rows, pd1)
  const int tid = threadIdx.x;
  for (int i = tid; i <= ng; i += blockDim.x) s_ps[i] = pstarts[first + i];
  for (int i = tid; i < kCol * ncoef; i += blockDim.x) {
    const int c = i / kCol, d = (i - c * kCol) / kSpan, t = i - c * kCol - d * kSpan;
    cs[i] = t < S ? coefs[(d * S + t) * ncoef + c] : T(0);
  }
  __syncthreads();
  const int q_begin = s_ps[0], q_end = s_ps[ng];
  if (q_begin == q_end) return;  // uniform across the CTA
  // Sub-run s: blocks [s sub, min((s + 1) sub, ng)), its window
  // pd0 x (blocks b1 + 2M - 1) cells.
  auto sub_blocks = [&](int s) { return min(sub, ng - s * sub); };
  auto sub_staged = [&](int s) {
    return staged_run(s_ps[s * sub + sub_blocks(s)] - s_ps[s * sub], w.pd0,
                      sub_blocks(s) * b1 + 2 * M - 1);
  };
  // Every thread reads the same table: the branches below are uniform.
  bool any_sparse = false;
  for (int s = 0; s < nsub; ++s)
    any_sparse = any_sparse || (!sub_staged(s) && s_ps[s * sub + sub_blocks(s)] > s_ps[s * sub]);

  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long area = (long long)n0 * n1;
  const T nf = T(normfactor);
  const int ox = bx * b0;

  // The points of sparse sub-runs, a thread a point, each point's window
  // read from global memory with periodic wrap.
  if (any_sparse) {
    for (int j = q_begin + tid; j < q_end; j += blockDim.x) {
      int lo = 0, hi = ng;  // j's block: the last one starting at or before j
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_ps[mid] <= j) lo = mid;
        else hi = mid;
      }
      if (sub_staged(lo / sub)) continue;
      T wt[2][S];
      point_taps_2d<M, T, TAPS>(cs, ncoef, fracs, wtaps, np, j, wt);
      const int cx = cells[j] - (M - 1), cy = cells[np + j] - (M - 1);
      int iy[S];
#pragma unroll
      for (int b = 0; b < S; ++b) iy[b] = nufft::wrap_index(cy + b, n1);
      const long long dest = perm[j];
      for (int c = 0; c < nchan; ++c) {
        const V* g = grid + c * area;
        const V acc = point_sum<M, T, NCOMP, 2>(
            wt, [](int) { return true; },
            [&](int a, int b) { return g[(long long)nufft::wrap_index(cx + a, n0) * n1 + iy[b]]; });
        V res;
#pragma unroll
        for (int n = 0; n < NCOMP; ++n) res.c[n] = acc.c[n] * nf;
        out[c * np + dest] = res;
      }
    }
  }

  // Staged sub-runs, one at a time.
  for (int s = 0; s < nsub; ++s) {
    if (!sub_staged(s)) continue;  // uniform
    const int p_begin = s_ps[s * sub], p_end = s_ps[s * sub + sub_blocks(s)];
    const int pd1 = sub_blocks(s) * b1 + 2 * M - 1;
    const int oy = (first - bx * nb1 + s * sub) * b1;
    // Staging lanes: rows of the window by sub-warps of pd1 lanes (as many
    // as fit in 32), a lane a y cell; a row longer than 32 cells takes a
    // warp.  Padded index i along a dim is grid node origin - (M - 1) + i,
    // wrapped (more than once where the grid is smaller than the window).
    const int rpw = pd1 <= 32 ? 32 / pd1 : 1;
    const int part = pd1 <= 32 ? lane / pd1 : 0;
    const int l0 = lane - part * (pd1 <= 32 ? pd1 : 0);
    for (int c = 0; c < nchan; ++c) {
      const V* g = grid + c * area;
      for (int pass = 0; pass < w.passes; ++pass) {
        const int x0 = pass * w.rows;
        const int nx = min(w.rows, w.pd0 - x0);
        __syncthreads();  // the last window and chunk are read
        // Copy x rows x0 .. x0 + nx of the window.
        if (part < rpw) {
          for (int i = warp * rpw + part; i < nx; i += nwarps * rpw) {
            const V* src = g + (long long)mod_index(ox - (M - 1) + x0 + i, n0) * n1;
            V* dst = win + (long long)i * pd1;
            for (int l = l0; l < pd1; l += 32)
              cp_async<sizeof(V)>(dst + l, src + mod_index(oy - (M - 1) + l, n1));
          }
        }
        cp_async_commit();

        for (int cb = p_begin; cb < p_end; cb += kChunk) {
          const int nc = min(kChunk, p_end - cb);
          if (cb > p_begin) __syncthreads();  // the last chunk is read
          for (int i = tid; i < kBuckets; i += blockDim.x) s_cnt[i] = 0;
          __syncthreads();
          // Each point's window offset (x0's row first), its bucket and its
          // rank there.
          for (int p = tid; p < nc; p += blockDim.x) {
            const long long j = cb + p;
            const int base = (cells[j] - ox - x0) * pd1 + (cells[np + j] - oy);
            const int r = base & (kBuckets - 1);
            s_base[p] = base;
            s_rank[p] = r | atomicAdd(&s_cnt[r], 1) << 8;
          }
          __syncthreads();
          // Round robin over the buckets: the point of rank k in bucket r
          // goes after every point of lower rank and the rank-k points of
          // lower buckets.
          for (int p = tid; p < nc; p += blockDim.x) {
            const int r = s_rank[p] & 255, k = s_rank[p] >> 8;
            int pos = 0;
#pragma unroll
            for (int q = 0; q < kBuckets; ++q) {
              const int n = s_cnt[q];
              pos += min(n, k) + (q < r && n > k);
            }
            s_order[pos] = p;
          }
          cp_async_wait_all();
          __syncthreads();
          for (int i = tid; i < nc; i += blockDim.x) {
            const int p = s_order[i];
            const long long j = cb + p;
            T wt[2][S];
            point_taps_2d<M, T, TAPS>(cs, ncoef, fracs, wtaps, np, j, wt);
            const V* base = win + s_base[p];
            const int lx = w.passes == 1 ? 0 : cells[j] - ox - x0;  // x row past x0
            const V acc = point_sum<M, T, NCOMP, S>(
                wt, [&](int a) { return w.passes == 1 || (unsigned)(lx + a) < (unsigned)nx; },
                [&](int a, int b) { return base[a * pd1 + b]; });
            V* dst = out + c * np + perm[j];
            V res;
            if (pass == 0) {
#pragma unroll
              for (int n = 0; n < NCOMP; ++n) res.c[n] = acc.c[n] * nf;
            } else {
              res = *dst;
#pragma unroll
              for (int n = 0; n < NCOMP; ++n) res.c[n] += acc.c[n] * nf;
            }
            *dst = res;
          }
        }
      }
    }
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* grid, const void* cells, const void* fracs,
                   const void* perm, const void* pstarts, const void* coefs,
                   const void* wtaps, void* out, long long np, int nchan,
                   int ncoef, int n0, int n1, int b0, int b1, double normfactor,
                   cudaStream_t stream) {
  const int group = group_of(np, M, n0, n1, b0, b1);
  const Window w = window_of<M, T, NCOMP>(ncoef, b0, b1, sub_of(group, b1));
  if (w.passes == 0) return cudaErrorInvalidValue;
  auto kernel = wtaps ? interp_2d_kernel<M, T, NCOMP, true>
                      : interp_2d_kernel<M, T, NCOMP, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)w.smem);
  if (err != cudaSuccess) return err;
  const int nb1 = n1 / b1;
  const unsigned ctas = (unsigned)((n0 / b0) * ((nb1 + group - 1) / group));
  kernel<<<ctas, kThreads, w.smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(grid),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const long long*>(perm), static_cast<const int*>(pstarts),
      static_cast<const T*>(coefs), static_cast<const T*>(wtaps),
      static_cast<nufft::Value<T, NCOMP>*>(out), np, nchan, ncoef, n0, n1, b0, b1,
      group, normfactor);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* grid, const void* cells, const void* fracs,
             const void* perm, const void* pstarts, const void* coefs,
             const void* wtaps, void* out, long long np, int nchan, int m,
             int ncoef, int n0, int n1, int b0, int b1, double normfactor,
             void* stream) {
  if (np == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_INTERP_CASE(MM)                                                  \
  case MM:                                                                     \
    return (int)launch<MM, T, NCOMP>(grid, cells, fracs, perm, pstarts, coefs, \
                                     wtaps, out, np, nchan, ncoef, n0, n1, b0, \
                                     b1, normfactor, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_INTERP_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_INTERP_CASE
}

}  // namespace

// grid (nchan, n0, n1) values (complex: re, im interleaved); cells (2, np)
// int32 and fracs (2, np) T in bin-sorted order; perm (np,) int64, the
// original index of each sorted point; pstarts (nblocks + 1,) int32, block
// b's points being sorted positions [pstarts[b], pstarts[b + 1]) for blocks
// (b0, b1) numbered row-major; coefs (2, 2m, ncoef) T, or ncoef = 0 and no
// coefficients for a window other than kHorner, whose taps come in wtaps
// (2, 2m, np) T (window_weights.cu), null for kHorner; out (nchan, np)
// values in original point order.  T is float for *_f32, double for *_f64;
// normfactor is a double for both.  Launches on `stream`, does not
// synchronise, allocates nothing.
#define NUFFT_INTERP_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* grid, const void* cells, const void* fracs, \
                      const void* perm, const void* pstarts,                  \
                      const void* coefs, const void* wtaps, void* out,        \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      int n1, int b0, int b1, double normfactor,              \
                      void* stream) {                                         \
    return dispatch<T, NCOMP>(grid, cells, fracs, perm, pstarts, coefs,       \
                              wtaps, out, np, nchan, m, ncoef, n0, n1, b0,    \
                              b1, normfactor, stream);                        \
  }

#if NUFFT_WANT(0)
NUFFT_INTERP_ENTRY(staged_interp_2d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_INTERP_ENTRY(staged_interp_2d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_INTERP_ENTRY(staged_interp_2d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_INTERP_ENTRY(staged_interp_2d_real_f64, double, 1)
#endif
"""


#: Variants of the 1D spread kernel, each a line of csrc/spread_1d.cu
#: replaced: CTAs of 128 and 512 threads; register caps for 1 to 4 resident
#: CTAs an SM at every M and value type (c1 .. c4); and the shipped caps
#: but two CTAs for complex64 past M = 8 (complex64_two_past_8).
_COMPLEX64_PAST_8 = "  if (scalar_bytes == 4 && ncomp == 2 && m > 8) return 1;\n"
_MIN_CTAS = _COMPLEX64_PAST_8 + "  return (scalar_bytes == 4 ? 3 : 2) - (m > 4 ? 1 : 0);"
SPREAD1D_VARIANTS = {
    "threads128": {"constexpr int kThreads = 256;": "constexpr int kThreads = 128;"},
    "threads512": {"constexpr int kThreads = 256;": "constexpr int kThreads = 512;"},
    **{f"c{c}": {_MIN_CTAS: f"  return {c};"} for c in (1, 2, 3, 4)},
    "complex64_two_past_8": {_COMPLEX64_PAST_8: ""},
}
#: Point counts at N = 2^20 (grid 1,572,864): the main path's 1M, its
#: 10,000,000 and rho = 0.01.
SPREAD1D_NP = (1_000_000, 10_000_000, 15_729)

#: Copies of csrc/spread_1d.cu with one phase taken out, for
#: ``--spread1d-parts``: each maps a line of the source to its replacement.
#: Their grids are wrong; only their times are read.
SPREAD1D_PARTS = {
    # Every tap a number from the fraction in place of Horner's rule.
    "no_taps": {"nufft::horner_rows<S>(cs, ncoef, f_cur, w);":
                "for (int t = 0; t < S; ++t) w[t] = f_cur + T(t);"},
    # The points' fractions and values made up in place of read.
    "no_loads": {"      f = fracs[j];\n      v = vrow[perm[j]];":
                 "      f = T(0.25);\n      v.c[0] = T(0.5);",
                 "        f = fracs[j + 1];\n        v = vrow[q_next];":
                 "        f = T(j & 7);\n        v.c[0] = f;"},
    # No lane walks its cell's points (the first point's loads stay).
    "no_walk": {"for (; j < j_end; ++j) {": "for (; j < j_end && j < 0; ++j) {"},
    # The rounds' rotation by shuffles.
    "no_shuffle": {"__shfl_sync(0xffffffffu, acc[t][k], (lane - t) & 31)": "acc[t][k]"},
    # The flush's stores and reductions as writes under a condition that
    # never holds.
    "no_flush_write": {
        "    *reinterpret_cast<nufft::Value<T, NCOMP>*>(dst) = v;":
        "    if (v.c[0] == T(1.25e-30)) *reinterpret_cast<nufft::Value<T, NCOMP>*>(dst) = v;",
        "    nufft::add_complex(dst, sum[0], sum[1]);":
        "    if (sum[0] == 1.25e-300) dst[0] = T(sum[1]);",
        "    atomicAdd(dst, T(sum[0]));": "    if (sum[0] == 1.25e-300) dst[0] = T(sum[0]);"},
}

#: Point counts at N = 4096^2 (grid 6144^2) beside each dtype's main-path Np
#: (SPREAD2D_NP): 16,777,216 and rho = 0.01.
INTERP2D_EXTRA_NP = (16_777_216, 377_487)

#: Copies of csrc/interp_2d.cu with one phase taken out, for
#: ``--interp2d-parts``.  Their values are wrong; only their times are read.
_OUT = "      out[c * np + dest] = res;"
INTERP2D_PARTS = {
    # Every tap a number from the fraction in place of Horner's rule.
    "no_taps": {"    nufft::horner_rows<S>(cs, ncoef, fracs[j], wx);\n"
                "    nufft::horner_rows<S>(cs + kPitch * ncoef, ncoef, fracs[np + j], wy);":
                "    for (int t = 0; t < S; ++t) {\n"
                "      wx[t] = fracs[j] + T(t);\n"
                "      wy[t] = fracs[np + j] * T(t + 1);\n"
                "    }"},
    # The window's cells made up in place of read (whole chunks and cell by
    # cell), with their addresses.
    "no_loads": {"            for (int q = 0; q < kChunks; ++q) ch[b][q] = row[q];":
                 "            for (int q = 0; q < kChunks; ++q) {\n"
                 "              ch[b][q] = Chunk<V, kPer>{};\n"
                 "              ch[b][q].v[0].c[0] = T(y0 + q) + T(row == nullptr);\n"
                 "            }",
                 "          const V val = row[iy[b]];":
                 "          V val = {};\n          val.c[0] = T(iy[b]);"},
    # The results written under a condition that never holds.
    "no_out": {_OUT: _OUT.replace("out[", "if (res.c[0] == T(1.25e-30)) out[")},
    # Each result at its sorted position, not scattered to perm[j].
    "out_sorted": {_OUT: "      out[c * np + j] = res;"},
    # The point state made up from j in place of read, as the per-point
    # kernel's no_point_state.
    "no_point_state": {
        "fracs[j], wx);": "T(j & 7) * T(0.125), wx);",
        "fracs[np + j], wy);": "T(j & 15) * T(0.0625), wy);",
        "  const int cx = cells[j] - (M - 1);\n  const int cy = cells[np + j] - (M - 1);":
        "  const long long lin = j * ((long long)n0 * n1) / np;\n"
        "  const int cx = int(lin / n1) - (M - 1);\n"
        "  const int cy = int(lin % n1) - (M - 1);",
        "  const long long dest = perm[j];":
        "  const long long dest = (long long)(((unsigned long long)((unsigned)j * 2654435761u)"
        " * (unsigned long long)np) >> 32);"},
}
#: Variants of csrc/interp_2d.cu for ``--interp2d``, each a line replaced;
#: their values are right.  Every row read cell by cell (no 16-byte
#: chunks); the batches of rows in a rolled loop (loads cannot move above
#: the last batch's FMAs; the x taps then sit in local memory); this
#: design at every M and value type, where the shipped source keeps the
#: per-point loop for some (``rows_everywhere``; ``rows_c1`` .. ``rows_c3``
#: with registers capped for 1 to 3 resident CTAs an SM); 32 or 128
#: registers of loaded cells in flight; registers capped for 1 to 4
#: resident CTAs an SM at every M and value type (c1 .. c4).
_MIN_CTAS_2D = "  return scalar_bytes == 4 ? (m > 4 ? 2 : 3) : (m > 8 ? 1 : 2);"
_ROWS_2D = {"  return (rows_mask(scalar_bytes, ncomp) >> m) & 1u;": "  return true;"}
INTERP2D_VARIANTS = {
    "unchunked": {"constexpr bool kChunkRows = true;": "constexpr bool kChunkRows = false;"},
    "rolled_batches": {"#pragma unroll\n      for (int a0 = 0; a0 < S; a0 += kBatch) {":
                       "#pragma unroll 1\n      for (int a0 = 0; a0 < S; a0 += kBatch) {"},
    # Whole-chunk rows at every M and value type (``chunked_rows``), with
    # the shipped register caps or capped for 1 to 3 resident CTAs an SM.
    "rows_everywhere": _ROWS_2D,
    **{f"rows_c{c}": {**_ROWS_2D, _MIN_CTAS_2D: f"  return {c};"} for c in (1, 2, 3)},
    **{f"load_regs{r}": {"constexpr int kLoadRegs = 64;": f"constexpr int kLoadRegs = {r};"}
       for r in (32, 128)},
    **{f"c{c}": {_MIN_CTAS_2D: f"  return {c};"} for c in (1, 2, 3, 4)},
}


#: Copies of ``_POINT_INTERP_2D_SRC`` (the first, per-point kernel)
#: with one phase taken out or changed, for ``--interp2d-parts``, beside
#: the same copy unedited (``point``).  The first four are that kernel's
#: first parts; the last three place what those left unplaced.  Only their
#: times are read.
_POINT_X_LOOP = """#pragma unroll 1
    for (int a = 0; a < S; ++a) {
      T wx;
      if constexpr (TAPS) {
        wx = wtaps[a * np + j];
      } else {
        wx = nufft::horner_tap(cs + a * ncoef, ncoef, T(2) * fx - T(1));
      }
"""
_POINT_NF = "  const T nf = T(normfactor);\n"
_POINT_X_TAPS = """  T wxs[S];
  if constexpr (TAPS) {
#pragma unroll
    for (int t = 0; t < S; ++t) wxs[t] = wtaps[t * np + j];
  } else {
    nufft::horner_taps<S>(cs, ncoef, fx, wxs);
  }
"""
_POINT_UNROLLED = {
    _POINT_NF: _POINT_NF + _POINT_X_TAPS,
    _POINT_X_LOOP: "#pragma unroll\n    for (int a = 0; a < S; ++a) {\n      const T wx = wxs[a];\n",
}
POINT_INTERP2D_PARTS = {
    # Every tap a number in place of Horner's rule.
    "no_taps": {"nufft::horner_taps<S>(cs + S * ncoef, ncoef, fracs[np + j], wy);":
                "for (int t = 0; t < S; ++t) wy[t] = T(0.1) * T(t + 1);",
                "wx = nufft::horner_tap(cs + a * ncoef, ncoef, T(2) * fx - T(1));":
                "wx = fx + T(a);"},
    # The window's cells made up in place of read from the grid.
    "no_loads": {"const nufft::Value<T, NCOMP> val = row[iy[b]];":
                 "nufft::Value<T, NCOMP> val = {};\n        val.c[0] = T(iy[b]);"},
    # The result written under a condition that never holds.
    "no_out": {"    out[c * np + dest] = res;":
               "    if (res.c[0] == T(1.25e-30)) out[c * np + dest] = res;"},
    # Each result at its sorted position, not scattered to perm[j].
    "out_sorted": {"    out[c * np + dest] = res;": "    out[c * np + j] = res;"},
    # The point state made up from j in place of read: cells walking the
    # grid row-major at the points' density, fractions from j's low bits,
    # the destination a multiplicative hash of j over [0, np) (a scatter
    # like perm's, with no load).
    "no_point_state": {
        "fracs[np + j], wy);": "T(j & 15) * T(0.0625), wy);",
        "  const int cx = cells[j] - (M - 1);\n  const int cy = cells[np + j] - (M - 1);":
        "  const long long lin = j * ((long long)n0 * n1) / np;\n"
        "  const int cx = int(lin / n1) - (M - 1);\n"
        "  const int cy = int(lin % n1) - (M - 1);",
        "  const T fx = fracs[j];": "  const T fx = T(j & 7) * T(0.125);",
        "  const long long dest = perm[j];":
        "  const long long dest = (long long)(((unsigned long long)((unsigned)j * 2654435761u)"
        " * (unsigned long long)np) >> 32);"},
    # The x loop unrolled, with the 2M x taps computed before it.
    "x_unrolled": _POINT_UNROLLED,
    # As x_unrolled, and both dimensions' taps by horner_rows on a
    # coefficient-major table in shared memory (the 2M chains together).
    "rows_taps": {
        **_POINT_UNROLLED,
        "  T* cs = reinterpret_cast<T*>(smem_raw);  // (2, S, ncoef)\n"
        "  for (int i = threadIdx.x; i < 2 * S * ncoef; i += blockDim.x)\n"
        "    cs[i] = coefs[i];":
        "  constexpr int kPitch = nufft::row_pitch<S, T>();\n"
        "  T* cs = reinterpret_cast<T*>(smem_raw);  // (2, ncoef, kPitch)\n"
        "  for (int i = threadIdx.x; i < 2 * kPitch * ncoef; i += blockDim.x) {\n"
        "    const int d = i / (kPitch * ncoef), r = i - d * kPitch * ncoef;\n"
        "    const int q = r / kPitch, t = r - q * kPitch;\n"
        "    cs[i] = t < S ? coefs[(d * S + t) * ncoef + q] : T(0);\n"
        "  }",
        "nufft::horner_taps<S>(cs + S * ncoef, ncoef, fracs[np + j], wy);":
        "nufft::horner_rows<S>(cs + kPitch * ncoef, ncoef, fracs[np + j], wy);",
        _POINT_X_TAPS: _POINT_X_TAPS.replace("nufft::horner_taps<S>(cs, ncoef, fx, wxs);",
                                             "nufft::horner_rows<S>(cs, ncoef, fx, wxs);"),
        "  const size_t smem = sizeof(T) * 2 * 2 * M * ncoef;":
        "  const size_t smem = sizeof(T) * 2 * nufft::row_pitch<2 * M, T>() * ncoef;"},
}

#: Copies of csrc/interp_1d.cu with one phase of its staged path (the one
#: outputs above ``INTERP1D_GATHER_BYTES`` take) taken out, for
#: ``--interp1d-parts``.  Their values are wrong; only their times are read.
#: (The per-point kernel's parts, PERF.md, were the same edits of
#: ``_POINT_INTERP_1D_SRC`` when it was the shipped source.)
_STORE = "        out[(c0 + c) * np + j] = res;"
INTERP1D_PARTS = {
    # The sorted results written under a condition that never holds.
    "no_out": {_STORE: _STORE.replace("out[", "if (res.c[0] == T(1.25e-30)) out[")},
    # No gather into the caller's order.
    "no_gather": {"  gather_kernel<V><<<": "  if (np < 0) gather_kernel<V><<<"},
    # The window's cells made up in place of read (staged and global).
    "no_loads": {"{ return sw[t]; }": "{ V v = {}; v.c[0] = T(cx + t); return v; }",
                 "return g[nufft::wrap_index(cx - (M - 1) + t, n0)];":
                 "V v = {};\n            v.c[0] = T(cx + t);\n            return v;"},
    # Every tap a number from the fraction in place of Horner's rule (both
    # paths).
    "no_taps": {"nufft::horner_rows<S>(cs, ncoef, fracs[j], w);":
                "for (int t = 0; t < S; ++t) w[t] = fracs[j] + T(t);"},
    # No window staged: only the copy into shared memory taken out (the
    # points read the uninitialised window).
    "no_stage": {"          cp_async<16>(dst, row + gc);": "          if (gc < -n0) cp_async<16>(dst, row + gc);"},
}
#: Variants of csrc/interp_1d.cu for ``--interp1d``, each a line replaced;
#: their values are right.  Streaming stores (``__stcs``, evict-first in
#: L2) of the point path's scattered results; every block of the staged
#: path read from global memory, or every block staged; 256-thread CTAs;
#: registers capped for 8 or 12 resident
#: CTAs an SM.  (The shipped build also runs each path whatever the wrapper
#: would choose: ``shipped_scatter``, the point path; ``shipped_gather``,
#: the staged path.)
_POINT_STORE = ("    out[c * np + dest] =\n        contract<S, T, NCOMP>(w, nf, [&](int t) "
                "{ return g[nufft::wrap_index(cx + t, n0)]; });")
_STCS = """    const nufft::Value<T, NCOMP> res =
        contract<S, T, NCOMP>(w, nf, [&](int t) { return g[nufft::wrap_index(cx + t, n0)]; });
    nufft::Value<T, NCOMP>* dst = out + c * np + dest;
    if constexpr (sizeof(res) == 16)
      __stcs(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(&res));
    else if constexpr (sizeof(res) == 8)
      __stcs(reinterpret_cast<float2*>(dst), *reinterpret_cast<const float2*>(&res));
    else
      __stcs(reinterpret_cast<float*>(dst), *reinterpret_cast<const float*>(&res));"""
INTERP1D_VARIANTS = {
    "stcs": {_POINT_STORE: _STCS},
    "global_reads": {"constexpr int kSparse = 8;": "constexpr int kSparse = 0;"},
    "stage_all": {"constexpr int kSparse = 8;": "constexpr int kSparse = 1 << 20;"},
    "threads256": {"constexpr int kThreads = 128;": "constexpr int kThreads = 256;"},
    **{f"cap{c}": {"__global__ void __launch_bounds__(kThreads) interp_1d_kernel(":
                   f"__global__ void __launch_bounds__(kThreads, {c}) interp_1d_kernel("}
       for c in (8, 12)},
    # The point path's registers capped for 4 resident CTAs an SM (64).
    "point_cap4": {"__launch_bounds__(kPointThreads) interp_1d_point_kernel(":
                   "__launch_bounds__(kPointThreads, 4) interp_1d_point_kernel("},
}


def _edited_sources(stem: str, parts, ms=(4,), source=None, base="shipped") -> dict:
    """``csrc/<stem>.cu`` (or the text ``source``) for the M of ``ms``
    alone as ``base``, and a copy for each entry of ``parts`` with its lines
    replaced, as ``name`` (``<base>_<name>`` when ``base`` is not
    ``shipped``)."""
    from nonuniformffts_tpu_torch.ops.kernels import build

    text0 = (build.CSRC_DIR / f"{stem}.cu").read_text() if source is None else source
    src = _m_only(text0, ms)
    texts = {base: src}
    for name, edits in parts.items():
        text = src
        for old, new in edits.items():
            if old not in text:
                raise AssertionError(f"{name}: {old!r} not in {stem}.cu")
            text = text.replace(old, new)
        texts[name if base == "shipped" else f"{base}_{name}"] = text
    return texts


def _build_all(prefix: str, jobs) -> dict:
    """``{name: (source text, nvcc flags)}`` built at once into
    ``build/chip_probe/`` as ``<prefix><name>``; returns ``{name: loaded
    library}``."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_probe_library, prefix + k, text, flags)
                   for k, (text, flags) in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _lowdim_registers(stem: str, kernel: str) -> str:
    """Registers and spill stores of the instantiations of ``kernel`` in
    ``build/chip_probe/<stem>.ptxas.log``."""
    text = (ROOT / "build" / "chip_probe" / f"{stem}.ptxas.log").read_text()
    regs = re.findall(r"(" + kernel + r")I(?:Li\dE)?Li(\d+)E([fd])(?:Li(\d)E)?(?:Lb([01])E)?.*?"
                      r"(\d+) bytes spill stores.*?Used (\d+) registers", text, re.S)
    return ", ".join(f"{k} <M={m}, {t}{', ' + n if n else ''}{', taps' if b == '1' else ''}> "
                     f"{r} (spills {sp} B, {_resident_ctas(int(r))} CTAs of 256 an SM)"
                     for k, m, t, n, b, sp, r in regs)


def _resident_ctas(registers: int, threads: int = 256) -> int:
    """CTAs of ``threads`` an H100 SM holds at ``registers`` a thread (65,536
    registers, allocated a warp at a time in units of 256, at most 64 warps
    and 32 CTAs), shared memory aside.  (The 1D interpolation's staged
    kernel runs CTAs of 128: it holds twice as many.)"""
    per_warp = -(-registers * 32 // 256) * 256
    warps = threads // 32
    return min(65536 // (per_warp * warps), 64 // warps, 32)


def _raw_spread_1d(lib, prefix: str, plan, vals, shipped: bool = True):
    """One launch of a 1D spread entry point (``prefix`` + value suffix) of
    ``lib`` on the plan's sorted state: the shipped kernel's C interface,
    ``vals`` in the caller's order, read through ``plan.sort_perm``; or with
    ``shipped`` False the thread-a-padded-cell kernel's, ``vals`` in sorted
    order.  Returns the grid."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    name = prefix + VALUE_TYPES[plan.dtype][0]
    fn = getattr(lib, name)
    sig = build._SIGNATURES["nufft_spread_1d_" + VALUE_TYPES[plan.dtype][0]]
    fn.argtypes = sig if shipped else sig[:7] + sig[8:]
    perm = (plan.sort_perm.data_ptr(),) if shipped else ()
    grid = torch.zeros((1,) + plan.shape_over, dtype=vals.dtype, device=vals.device)
    err = fn(vals.data_ptr(), plan.cells_sorted.data_ptr(), plan.fracs_sorted.data_ptr(),
             plan.pstarts.data_ptr(), plan.coefs.data_ptr(), 0, grid.data_ptr(), *perm,
             plan.num_points, 1, plan.m, plan.coefs.shape[-1], *plan.shape_over,
             *plan.block_dims, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return grid


def _raw_interp_2d(lib, name: str, plan, grid, staged: bool = False):
    """One launch of the 2D interpolation entry point ``name`` of ``lib`` on
    the plan's sorted state (BKB Fast, one transform): the shipped kernel's
    C interface, or with ``staged`` the staged kernel's, which adds pstarts
    and the block dims."""
    import ctypes as ct

    import torch

    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    fn = getattr(lib, name)
    sig = build._SIGNATURES["nufft_interp_2d_" + VALUE_TYPES[plan.dtype][0]]
    fn.argtypes = sig[:4] + [ct.c_void_p] + sig[4:-2] + [ct.c_int] * 2 + sig[-2:] if staged else sig
    out = torch.empty((1, plan.num_points), dtype=grid.dtype, device=grid.device)
    blocks = ((plan.pstarts.data_ptr(),), plan.block_dims) if staged else ((), ())
    err = fn(grid.data_ptr(), plan.cells_sorted.data_ptr(), plan.fracs_sorted.data_ptr(),
             plan.sort_perm.data_ptr(), *blocks[0], plan.coefs.data_ptr(), 0, out.data_ptr(),
             plan.num_points, 1, plan.m, plan.coefs.shape[-1], *plan.shape_over,
             *blocks[1], float(plan.normfactor), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def _raw_interp_1d(lib, name: str, plan, grid, shipped: bool = True, gather=None, inv=None):
    """One launch of the 1D interpolation entry point ``name`` of ``lib`` on
    the plan's sorted state (BKB Fast, the transforms of ``grid``), with the
    shipped kernel's C interface (``build._SIGNATURES``; the results
    scattered to ``perm[j]`` or, with ``gather``, stored sorted and gathered
    into order through ``inv``, by default the plan's ``sort_perm_inv``:
    by default as the wrapper chooses, ``common.interp1d_gathers``), or with
    ``shipped`` False the per-point kernel's (``_POINT_INTERP_1D_SRC``)."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES, interp1d_gathers

    fn = getattr(lib, name)
    sig = build._SIGNATURES["nufft_interp_1d_" + VALUE_TYPES[plan.dtype][0]]
    fn.argtypes = sig if shipped else _POINT_INTERP_1D_SIG
    C = grid.shape[0]
    out = torch.empty((C, plan.num_points), dtype=grid.dtype, device=grid.device)
    if gather is None:
        gather = interp1d_gathers(plan.num_points, C, out.element_size())
    scratch = torch.empty_like(out) if shipped and gather else None
    if scratch is not None and inv is None:
        inv = plan.sort_perm_inv if plan.sort_perm_inv is not None else _inverse(plan.sort_perm)
    blocks = ((plan.pstarts.data_ptr(),), plan.block_dims) if shipped else ((), ())
    order = (() if not shipped else (0, 0) if scratch is None
             else (scratch.data_ptr(), inv.data_ptr()))
    err = fn(grid.data_ptr(), plan.cells_sorted.data_ptr(), plan.fracs_sorted.data_ptr(),
             plan.sort_perm.data_ptr(), *blocks[0], plan.coefs.data_ptr(), 0, out.data_ptr(),
             *order, plan.num_points, C, plan.m, plan.coefs.shape[-1], *plan.shape_over,
             *blocks[1], float(plan.normfactor), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def _inverse(perm, how: str = "index_put"):
    """The sorted position of each point, int32, from ``perm``: as
    ``set_points`` makes it (``blocked.interp1d_inverse``, ``index_put``) or
    by ``scatter_``."""
    import torch

    src = torch.arange(perm.shape[0], dtype=torch.int32, device=perm.device)
    inv = torch.empty(perm.shape, dtype=torch.int32, device=perm.device)
    if how == "index_put":
        inv[perm] = src
    else:
        inv.scatter_(0, perm, src)
    return inv


#: Point counts of ``--interp1d-sweep`` (the main path's 1D grid, 2^20
#: modes, sigma = 1.5): from the main path's 1M to its 10M.
INTERP1D_SWEEP_NP = (1_000_000, 1_500_000, 2_000_000, 3_000_000, 4_000_000, 5_000_000,
                     6_000_000, 8_000_000, 10_000_000)


def probe_interp1d_sweep(seed: int, dtypes, nps, reps: int) -> None:
    """The shipped 1D interpolation's two paths on the same points, both
    forced whatever ``common.interp1d_gathers`` would choose: the point path
    (results scattered to ``perm[j]``) and the staged path (stored sorted,
    then gathered through the inverse permutation), raw launches in turns
    (scatter, gather, gather, scatter, twice; CUDA events, median of
    ``reps`` after one warm-up), one and two transforms, the four dtypes, at
    each point count of ``nps`` (default ``INTERP1D_SWEEP_NP``), M = 4,
    BKB Fast, uniform points.  The two outputs must agree to the kernel
    tolerance (both sum in the same order).  One JSON line a dtype, C and
    Np, with the output's bytes, where ``INTERP1D_GATHER_BYTES`` sets the
    wrapper's choice, and the time of the inverse permutation that the
    gather reads and ``set_points`` makes (``index_put`` as it does, and
    ``scatter_``; the later of two timings each)."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, nvidia_smi_line, rel_l2
    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import (INTERP1D_GATHER_BYTES,
                                                             VALUE_TYPES, interp1d_gathers)

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    lib = build.load()
    for name in dtypes:
        plan0 = nufft.PlanNUFFT(np.dtype(name), SHAPES[1], m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        suffix, sb, ncomp = VALUE_TYPES[plan0.dtype]
        entry = "nufft_interp_1d_" + suffix
        tol = 1e-6 if sb == 4 else 1e-14
        for np_ in nps or INTERP1D_SWEEP_NP:
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((1, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            plan = nufft.set_points(plan0, pts)
            perm = plan.sort_perm
            inverse_ms = {how: cuda_time_ms(lambda how=how: _inverse(perm, how), reps=reps)[0]
                          for how in ("index_put", "scatter", "index_put", "scatter")}
            inv = _inverse(perm)
            if not torch.equal(inv, _inverse(perm, "scatter")):
                raise AssertionError("the two inverse permutations differ")
            for C in (1, 2):
                grid = torch.randn((C,) + plan.shape_over, generator=gen, device=dev,
                                   dtype=plan0.dtype)
                runs = {way: (lambda way=way: _raw_interp_1d(
                    lib, entry, plan, grid, gather=way == "gather", inv=inv))
                    for way in ("scatter", "gather")}
                times = {k: [] for k in runs}
                outs = {}
                for _ in range(2):
                    for k in ("scatter", "gather", "gather", "scatter"):
                        ms_, outs[k] = cuda_time_ms(runs[k], reps=reps)
                        times[k].append(ms_)
                err = rel_l2(outs["gather"], outs["scatter"])
                if not err <= tol:
                    raise AssertionError(f"interp1d sweep {name} C={C} {np_}: the paths "
                                         f"differ, rel L2 {err:.3e}")
                med = {k: statistics.median(t) for k, t in times.items()}
                nbytes = C * np_ * sb * ncomp
                print(json.dumps({
                    "probe": "interp1d_sweep", "card": card, "dtype": name, "C": C, "np": np_,
                    "out_bytes": nbytes, "ms": med, "all_ms": times,
                    "scatter_over_gather": med["scatter"] / med["gather"],
                    "inverse_ms": inverse_ms,
                    "equal": bool(torch.equal(outs["gather"], outs["scatter"])),
                    "wrapper_gathers": interp1d_gathers(np_, C, sb * ncomp),
                    "threshold_bytes": INTERP1D_GATHER_BYTES}), flush=True)
                del grid, outs, runs
            del plan, pts, perm, inv
            torch.cuda.empty_cache()


# The 1D interpolation kernel that csrc/interp_1d.cu replaced: a
# thread a bin-sorted point, its 2M taps by horner_taps (a runtime loop a
# tap) or from K3's wtaps, its 2M cells read from global memory with
# periodic wrap, its result scattered to out[c, perm[j]].  Kept for
# --interp1d, which times the two in turns; built by it into
# build/chip_probe/.
_POINT_INTERP_1D_SRC = r"""
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;

template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kThreads) interp_1d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ grid,
    const int* __restrict__ cells, const T* __restrict__ fracs,
    const long long* __restrict__ perm, const T* __restrict__ coefs,
    const T* __restrict__ wtaps, nufft::Value<T, NCOMP>* __restrict__ out,
    long long np, int nchan, int ncoef, int n0, double normfactor) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // (S, ncoef)
  for (int i = threadIdx.x; i < S * ncoef; i += blockDim.x) cs[i] = coefs[i];
  __syncthreads();

  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= np) return;

  T w[S];
  int ix[S];
  nufft::point_taps<S>(wtaps, cs, ncoef, fracs, np, j, 0, w);
  const int cx = cells[j] - (M - 1);
#pragma unroll
  for (int t = 0; t < S; ++t) ix[t] = nufft::wrap_index(cx + t, n0);
  const long long dest = perm[j];
  const T nf = T(normfactor);

  for (int c = 0; c < nchan; ++c) {
    const nufft::Value<T, NCOMP>* g = grid + (long long)c * n0;
    T acc[NCOMP] = {};
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const nufft::Value<T, NCOMP> val = g[ix[t]];
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) acc[k] = nufft::fma_t(val.c[k], w[t], acc[k]);
    }
    nufft::Value<T, NCOMP> res;
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) res.c[k] = acc[k] * nf;
    out[c * np + dest] = res;
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* grid, const void* cells, const void* fracs,
                   const void* perm, const void* coefs,
                   const void* wtaps, void* out,
                   long long np, int nchan, int ncoef, int n0,
                   double normfactor, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 2 * M * ncoef;
  const long long nblocks = (np + kThreads - 1) / kThreads;
  interp_1d_kernel<M, T, NCOMP><<<(unsigned)nblocks, kThreads, smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(grid),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const long long*>(perm), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps),
      static_cast<nufft::Value<T, NCOMP>*>(out), np, nchan, ncoef, n0,
      normfactor);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* grid, const void* cells, const void* fracs,
             const void* perm, const void* coefs,
             const void* wtaps, void* out, long long np,
             int nchan, int m, int ncoef, int n0, double normfactor,
             void* stream) {
  if (np == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_INTERP_CASE(MM)                                              \
  case MM:                                                                 \
    return (int)launch<MM, T, NCOMP>(grid, cells, fracs, perm, coefs, wtaps, \
                                     out, np, nchan, ncoef, n0, normfactor, \
                                     s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_INTERP_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_INTERP_CASE
}

}  // namespace

// grid (nchan, n0) values (complex: re, im interleaved); cells (1, np) int32
// and fracs (1, np) T in bin-sorted order; perm (np,) int64, the original
// index of each sorted point; coefs (1, 2m, ncoef) T, or ncoef = 0 and no
// coefficients for a window other than kHorner, whose taps come in wtaps
// (1, 2m, np) T (window_weights.cu), null for kHorner; out (nchan, np) values
// in original point order.  T is float for *_f32, double for *_f64;
// normfactor is a double for both.  Launches on `stream`, does not
// synchronise, allocates nothing.
#define NUFFT_INTERP_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* grid, const void* cells, const void* fracs, \
                      const void* perm, const void* coefs,                    \
                      const void* wtaps, void* out,              \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      double normfactor, void* stream) {                      \
    return dispatch<T, NCOMP>(grid, cells, fracs, perm, coefs, wtaps, out, np,  \
                              nchan, m, ncoef, n0, normfactor, stream);       \
  }

#if NUFFT_WANT(0)
NUFFT_INTERP_ENTRY(point_interp_1d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_INTERP_ENTRY(point_interp_1d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_INTERP_ENTRY(point_interp_1d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_INTERP_ENTRY(point_interp_1d_real_f64, double, 1)
#endif
"""
#: The per-point kernel's C interface: grid, cells, fracs, perm, coefs,
#: wtaps, out, np, nchan, m, ncoef, n0, normfactor, stream.
_POINT_INTERP_1D_SIG = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                        + [ctypes.c_double, ctypes.c_void_p])


#: What ``_lowdim_probe`` times, by kind: the shipped source's stem and
#: kernel name, the other designs' names in the JSON line (each also its
#: entry points' prefix), the dimension.
LOWDIM_KINDS = {
    "spread1d": ("spread_1d", "spread_1d_kernel", ("old",), 1),
    "interp2d": ("interp_2d", "interp_2d_(?:point_)?kernel", ("point", "staged"), 2),
    "interp1d": ("interp_1d", "interp_1d_(?:point_)?kernel", ("point",), 1),
}


def _other_design(kind: str, name: str) -> str:
    """The source of another design ``name`` of ``LOWDIM_KINDS[kind]``."""
    return {("spread1d", "old"): _CELL_SPREAD_1D_SRC,
            ("interp2d", "point"): _POINT_INTERP_2D_SRC,
            ("interp2d", "staged"): _STAGED_INTERP_2D_SRC,
            ("interp1d", "point"): _POINT_INTERP_1D_SRC}[(kind, name)]


def _lowdim_probe(kind: str, seed: int, dtypes, nps, ms, with_variants: bool,
                  reps: int = 5, only=None) -> None:
    """The body of ``--spread1d`` / ``--interp2d`` / ``--interp1d`` (``kind``
    a key of ``LOWDIM_KINDS``) and of their ``-parts`` twins
    (``with_variants`` False): the shipped kernel against the other designs
    (the 1D spread's old kernel, ``_CELL_SPREAD_1D_SRC``; the 2D
    interpolation's per-point kernel, ``_POINT_INTERP_2D_SRC``, and staged
    kernel, ``_STAGED_INTERP_2D_SRC``; the 1D interpolation's per-point
    kernel, ``_POINT_INTERP_1D_SRC``), in turns (others, shipped, shipped,
    others in reverse), two passes, raw launches on the same sorted points,
    all held against the plain version; the shipped wrapper call (the
    grid's zeroing or the output's allocation and the launch path) and its
    host time; then the variants or the parts copies in turns with the
    shipped build (for ``interp2d`` the parts of the per-point kernel too,
    ``POINT_INTERP2D_PARTS``, beside its unedited copy).  Everything for the M of ``ms`` alone in
    ``build/chip_probe/``.  sigma = 1.5, BKB FastApproximation, uniform
    points, the chooser's block dims; CUDA events, median of ``reps`` after
    one warm-up.  ``only``: the names of the variants to time (default
    all).  One JSON line a dtype, M and Np, with the card's name and power
    limit, the bound (``chip_smoke.kernel_bound``) and the points a
    block."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, kernel_bound, nvidia_smi_line, rel_l2
    from nonuniformffts_tpu_torch.ops.kernels import blocked, build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    spread = kind == "spread1d"
    stem, kernel, others, D = LOWDIM_KINDS[kind]
    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    inc = ("-I", str(build.CSRC_DIR))
    variants = {"spread1d": SPREAD1D_VARIANTS, "interp2d": INTERP2D_VARIANTS,
                "interp1d": INTERP1D_VARIANTS}[kind]
    variants = {k: v for k, v in variants.items() if only is None or k in only}
    parts = {"spread1d": SPREAD1D_PARTS, "interp2d": INTERP2D_PARTS,
             "interp1d": INTERP1D_PARTS}[kind]
    if with_variants:
        texts = _edited_sources(stem, variants, ms)
        texts.update({o: _m_only(_other_design(kind, o), ms) for o in others})
        prefix = f"{kind}_"
    else:
        texts = _edited_sources(stem, parts, ms)
        if kind == "interp2d":
            texts.update(_edited_sources(stem, POINT_INTERP2D_PARTS, ms,
                                         _POINT_INTERP_2D_SRC, "point"))
        prefix = f"{kind}_part_"
    libs = _build_all(prefix, {k: (t, inc) for k, t in texts.items()})
    for k in libs:
        print(f"ptxas {k}: {_lowdim_registers(prefix + k, kernel)}", flush=True)
    for name in dtypes:
        for m in ms:
            plan0 = nufft.PlanNUFFT(np.dtype(name), SHAPES[D], m=m, sigma=1.5,
                                    spread_method="blocked", device=dev)
            _, sb, _ = VALUE_TYPES[plan0.dtype]
            tol = 1e-5 if sb == 4 else 1e-12
            suffix = VALUE_TYPES[plan0.dtype][0]
            default = (SPREAD1D_NP if D == 1 else (SPREAD2D_NP[name],) + INTERP2D_EXTRA_NP)
            for np_ in nps or (default if with_variants else default[:2]):
                gen = torch.Generator(device=dev).manual_seed(seed + np_)
                pts = torch.rand((D, np_), generator=gen, device=dev,
                                 dtype=plan0.real_dtype) * (2 * math.pi)
                plan = nufft.set_points(plan0, pts)
                chunked = dataclasses.replace(plan, chunk_size=1 << 16)
                if spread:
                    vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
                    vals = vp[:, plan.sort_perm].contiguous()
                    want = blocked.spread_blocked_plain(chunked, vp)
                    runs = {k: (lambda lib=lib, k=k: _raw_spread_1d(
                        lib, ("cell" if k == "old" else "nufft") + "_spread_1d_", plan,
                        vals if k == "old" else vp, shipped=k != "old"))
                        for k, lib in libs.items()}
                    wrapper = lambda: blocked.spread_blocked(plan, vp)  # noqa: E731
                else:
                    grid = torch.randn((1,) + plan.shape_over, generator=gen, device=dev,
                                       dtype=plan0.dtype)
                    want = blocked.interpolate_blocked_plain(chunked, grid)
                    raw = _raw_interp_2d if D == 2 else _raw_interp_1d
                    design = {k: next((o for o in others if k == o or k.startswith(o + "_")),
                                      "nufft") for k in libs}
                    runs = {k: (lambda lib=lib, k=k: raw(
                        lib, design[k] + f"_interp_{D}d_" + suffix, plan, grid,
                        (design[k] == "staged") if D == 2 else (design[k] != "point")))
                        for k, lib in libs.items()}
                    if kind == "interp1d":  # the shipped build, each way to the output
                        inv = (plan.sort_perm_inv if plan.sort_perm_inv is not None
                               else _inverse(plan.sort_perm))
                        for way in ("scatter", "gather"):
                            runs[f"shipped_{way}"] = lambda way=way: _raw_interp_1d(
                                libs["shipped"], "nufft_interp_1d_" + suffix, plan, grid,
                                gather=way == "gather", inv=inv)
                    wrapper = lambda: blocked.interpolate_blocked(plan, grid)  # noqa: E731
                head = ([*others, "shipped", "shipped", *others[::-1]] if with_variants
                        else [])
                rest = [k for k in runs if k not in (*head, "shipped")]
                times, errs = {k: [] for k in runs}, {}
                for rnd in range(2):
                    for k in head + ["shipped"] + (rest if rnd == 0 else rest[::-1]):
                        ms_, got = cuda_time_ms(runs[k], reps=reps)
                        times[k].append(ms_)
                        err = rel_l2(got, want)
                        errs[k] = max(errs.get(k, 0.0), err)
                        # The parts copies compute wrong values by design.
                        if (with_variants or k in ("shipped", *others)) and not err <= tol:
                            raise AssertionError(f"{kind} {name} m={m} {np_} {k}: rel L2 "
                                                 f"{err:.3e} vs plain")
                        del got
                call_ms, got = cuda_time_ms(wrapper)
                err = rel_l2(got, want)
                if not err <= tol:
                    raise AssertionError(f"{kind} {name} m={m} {np_} wrapper: rel L2 {err:.3e}")
                del got
                counts = (plan.pstarts[1:] - plan.pstarts[:-1]).float()
                bound_ms, bound_by = kernel_bound("spread" if spread else "interp", plan, 1)
                line = {"probe": kind if with_variants else kind + "_parts", "card": card,
                        "dtype": name, "m": m, "np": np_, "block_dims": list(plan.block_dims),
                        "points_a_block": {"mean": float(counts.mean()),
                                           "max": int(counts.max()),
                                           "empty_share": float((counts == 0).float().mean())},
                        "ms": {k: statistics.median(t) for k, t in times.items()},
                        "call_ms": call_ms, "call_host_us": _host_us(wrapper, 100),
                        "rel_l2": errs, "bound_ms": bound_ms, "bound_by": bound_by}
                for o in others:
                    if o in line["ms"]:
                        line[f"{o}_over_shipped"] = line["ms"][o] / line["ms"]["shipped"]
                print(json.dumps(line), flush=True)
                del plan, chunked, want, pts, runs, wrapper
                torch.cuda.empty_cache()


# The window-weights kernel that csrc/window_weights.cu replaced:
# a thread a (dimension, point), its 2M direct taps one at a time in a
# rolled loop, each store coalesced across the warp.  Kept for --weights,
# which times the two in turns; built by it into build/chip_probe/.
_OLD_WEIGHTS_SRC = r"""
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;

template <int M, typename T>
__global__ void __launch_bounds__(kThreads) window_weights_kernel(
    const T* __restrict__ fracs, const nufft::WindowParams win,
    T* __restrict__ out, long long np, int ndim) {
  constexpr int S = 2 * M;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np * ndim) return;
  const int d = (int)(i / np);
  const long long j = i - d * np;
  const T X = fracs[i];  // fracs (ndim, np): entry d * np + j
  T* o = out + d * S * np + j;  // tap t at o[t * np]
  switch (win.kind) {
    case nufft::kKBDirect: {
      const T beta = T(win.beta[d]), inv_peak = T(win.inv_peak[d]);
      for (int t = 0; t < S; ++t) o[t * np] = nufft::kb_direct_tap(beta, inv_peak, M, t, X);
      break;
    }
    case nufft::kBKBDirect: {
      const T beta = T(win.beta[d]), pref = T(win.pref[d]);
      const T exp_mbeta = T(win.exp_mbeta[d]);
      for (int t = 0; t < S; ++t)
        o[t * np] = nufft::bkb_direct_tap(beta, pref, exp_mbeta, M, t, X);
      break;
    }
    case nufft::kGaussian: {
      const T dx = T(win.dx[d]), inv_tau = T(win.inv_tau[d]);
      for (int t = 0; t < S; ++t) o[t * np] = nufft::gaussian_tap(dx, inv_tau, M, t, X);
      break;
    }
    default: {  // kBSpline
      T b[S];
      nufft::bspline_taps<S>(X, b);
#pragma unroll
      for (int t = 0; t < S; ++t) o[t * np] = b[t];
    }
  }
}

template <int M, typename T>
cudaError_t launch(const void* fracs, const nufft::WindowParams& win, void* out,
                   long long np, int ndim, cudaStream_t stream) {
  const long long nblocks = (np * ndim + kThreads - 1) / kThreads;
  window_weights_kernel<M, T><<<(unsigned)nblocks, kThreads, 0, stream>>>(
      static_cast<const T*>(fracs), win, static_cast<T*>(out), np, ndim);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* fracs, const nufft::WindowParams* win, void* out,
             long long np, int ndim, int m, void* stream) {
  if (np == 0) return (int)cudaSuccess;
  if (win->kind == nufft::kHorner) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_WEIGHTS_CASE(MM) \
  case MM:                     \
    return (int)launch<MM, T>(fracs, *win, out, np, ndim, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_WEIGHTS_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_WEIGHTS_CASE
}

}  // namespace

// fracs (ndim, np) T in bin-sorted order; win, a host pointer to the
// window's scalars (any kind but kHorner); out (ndim, 2m, np) T.  T is float
// for *_f32, double for *_f64.  Launches on `stream`, does not synchronise,
// allocates nothing.
#define NUFFT_WEIGHTS_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* fracs, const nufft::WindowParams* win, \
                      void* out, long long np, int ndim, int m,          \
                      void* stream) {                                    \
    return dispatch<T>(fracs, win, out, np, ndim, m, stream);            \
  }

// Built once per scalar type: NUFFT_ONLY 0 (complex64) and 1 (complex128)
// carry the float and double entry points; 2 and 3 carry none.
#if NUFFT_WANT(0)
NUFFT_WEIGHTS_ENTRY(old_window_weights_f32, float)
#endif
#if NUFFT_WANT(1)
NUFFT_WEIGHTS_ENTRY(old_window_weights_f64, double)
#endif
"""


#: Copies of csrc/window_weights.cu with one phase taken out, for
#: ``--weights``: the taps' evaluation (each tap a number from the fraction)
#: and their stores (the taps summed into a register that is written under
#: a condition that never holds).  Their taps are wrong; only their times
#: are read.
WEIGHTS_PARTS = {
    "no_eval": {
        "      for (int v = 0; v < V; ++v) w.c[v] = direct_tap<KIND, M, T>(win, d, t, X.c[v]);":
        "      for (int v = 0; v < V; ++v) w.c[v] = X.c[v] + T(t);",
        "    for (int v = 0; v < V; ++v) nufft::bspline_taps<S>(X.c[v], b[v]);":
        "    for (int v = 0; v < V; ++v)\n      for (int t = 0; t < S; ++t) b[v][t] = X.c[v] + T(t);"},
    "no_store": {
        "      o[t * groups] = w;\n    }\n  }\n}\n":
        "      for (int v = 0; v < V; ++v) sink += w.c[v];\n    }\n  }\n"
        "  if (sink == T(1.25e-30)) o[0].c[0] = sink;\n}\n",
        "  Vec<T, V>* o = reinterpret_cast<Vec<T, V>*>(out + d * S * np + j);":
        "  Vec<T, V>* o = reinterpret_cast<Vec<T, V>*>(out + d * S * np + j);\n  T sink = T(0);",
        "      o[t * groups] = w;": "      for (int v = 0; v < V; ++v) sink += w.c[v];"},
}
#: Variants of csrc/window_weights.cu for ``--weights``, each a line or two
#: replaced; their taps are right.  A point a thread at every M (no 16-byte
#: vectors of points), with the taps unrolled up to ``kUnrollM`` as shipped
#: or rolled at every M as in the kernel it replaced: what each of the two
#: changes gives at M <= 4.
_ONE_POINT = {"  constexpr int kVec = M <= kUnrollM ? 16 / int(sizeof(T)) : 1;":
              "  constexpr int kVec = 1;"}
WEIGHTS_VARIANTS = {
    "scalar": _ONE_POINT,
    "scalar_rolled": {**_ONE_POINT, "  } else if constexpr (M <= kUnrollM) {":
                      "  } else if constexpr (M < 0) {"},
}
#: The windows of ``--weights``: every kind K3 evaluates (WINDOW_MODES keys
#: of chip_smoke.py).
WEIGHTS_WINDOWS = ("KB Direct", "BKB Direct", "Gaussian Direct", "B-spline Direct")
#: Point counts at N = 256^3 (sigma = 2, grid 512^3): the main path's two.
WEIGHTS_NP = (1_000_000, 16_777_216)
#: Points on which each raw launch is held against the plain version.
WEIGHTS_CHECKED = 1 << 20


def _raw_weights(lib, name: str, plan, params, out):
    """One launch of the window-weights entry point ``name`` of ``lib`` on
    the plan's sorted fractions into ``out`` (D, 2M, Np)."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import build

    fn = getattr(lib, name)
    fn.argtypes = build._SIGNATURES["nufft_window_weights_" + name.rsplit("_", 1)[1]]
    err = fn(plan.fracs_sorted.data_ptr(), params, out.data_ptr(), plan.num_points,
             plan.ndim, plan.m, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def probe_weights(seed: int, nps, ms) -> None:
    """K3 alone: raw launches of the shipped window-weights kernel, of the
    kernel it replaced where this script keeps one (``_OLD_WEIGHTS_SRC``),
    of its variants (``WEIGHTS_VARIANTS``) and of the parts copies
    (``WEIGHTS_PARTS``), in turns on the same
    sorted points into one preallocated table (two passes, CUDA events,
    median of 5 after one warm-up), beside the wrapper call
    (``blocked.window_weights_blocked``: the table's allocation and the
    launch) and its host time, for every K3 window, float taps
    (complex64 plans) and double taps (complex128), N = 256^3, sigma = 2,
    the M of ``ms``, uniform points.  Each raw launch but the parts' is
    held against the plain version on the first ``WEIGHTS_CHECKED``
    points.  The bound by bytes reads each fraction once and writes each
    tap once; the bound by operations counts ``chip_smoke.tap_ops`` a tap
    (its I0 / exp / sqrt estimates) over the FP32 or FP64 peak.  One JSON
    line a window, dtype, M and Np."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import (HBM_BYTES_PER_S, PEAK_FLOPS, WINDOW_MODES, cuda_time_ms,
                            nvidia_smi_line, rel_l2, tap_ops)
    from nonuniformffts_tpu_torch.ops.kernels import blocked, build

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    texts = _edited_sources("window_weights", WEIGHTS_PARTS, ms)
    variants = _edited_sources("window_weights", WEIGHTS_VARIANTS, ms)
    texts.update((k, variants[k]) for k in WEIGHTS_VARIANTS)
    old = globals().get("_OLD_WEIGHTS_SRC")
    if old is not None:
        texts["old"] = _m_only(old, ms)
    libs = _build_all("weights_", {k: (t, ("-I", str(build.CSRC_DIR)))
                                   for k, t in texts.items()})
    for k in libs:
        print(f"ptxas {k}: {_lowdim_registers('weights_' + k, 'window_weights_kernel')}",
              flush=True)
    order = (["old"] if old is not None else []) + ["shipped", "shipped"] + (
        ["old"] if old is not None else [])
    parts = list(WEIGHTS_VARIANTS) + list(WEIGHTS_PARTS)
    for dtype in (np.complex64, np.complex128):
        for m in ms:
            for mode in WEIGHTS_WINDOWS:
                kernel, evalmode = WINDOW_MODES[mode]
                plan0 = nufft.PlanNUFFT(dtype, (256,) * 3, m=m, sigma=2.0,
                                        kernel=getattr(nufft, kernel)(),
                                        kernel_evalmode=getattr(nufft, evalmode)(),
                                        spread_method="blocked", device=dev)
                suffix = "f32" if plan0.real_dtype == torch.float32 else "f64"
                sb = 4 if suffix == "f32" else 8
                tol = 1e-5 if sb == 4 else 1e-12
                params = build.WindowParams.from_pack(plan0.window)
                for np_ in nps or WEIGHTS_NP:
                    gen = torch.Generator(device=dev).manual_seed(seed + np_)
                    pts = torch.rand((3, np_), generator=gen, device=dev,
                                     dtype=plan0.real_dtype) * (2 * math.pi)
                    plan = nufft.set_points(plan0, pts)
                    head = dataclasses.replace(
                        plan, fracs_sorted=plan.fracs_sorted[:, :WEIGHTS_CHECKED].contiguous())
                    want = blocked.window_weights_blocked_plain(head)
                    out = torch.empty((3, 2 * m, np_), dtype=plan0.real_dtype, device=dev)
                    times, errs = {k: [] for k in libs}, {}
                    for rnd in range(2):
                        for k in order + ["shipped"] + (parts if rnd == 0 else parts[::-1]):
                            ms_, _ = cuda_time_ms(lambda k=k: _raw_weights(
                                libs[k], f"{'old' if k == 'old' else 'nufft'}_window_weights_"
                                f"{suffix}", plan, params, out))
                            times[k].append(ms_)
                            if k not in WEIGHTS_PARTS:
                                err = rel_l2(out[:, :, :WEIGHTS_CHECKED], want)
                                errs[k] = max(errs.get(k, 0.0), err)
                                if not err <= tol:
                                    raise AssertionError(f"weights {mode} {suffix} m={m} {np_} "
                                                         f"{k}: rel L2 {err:.3e} vs plain")
                    wrapper = lambda: blocked.window_weights_blocked(plan)  # noqa: E731
                    call_ms, got = cuda_time_ms(wrapper)
                    err = rel_l2(got[:, :, :WEIGHTS_CHECKED], want)
                    if not err <= tol:
                        raise AssertionError(f"weights {mode} wrapper: rel L2 {err:.3e}")
                    del got
                    S = 2 * m
                    bound_bytes = 1e3 * (np_ * 3 * sb * (1 + S)) / HBM_BYTES_PER_S
                    bound_ops = 1e3 * np_ * 3 * S * tap_ops(plan) / PEAK_FLOPS[sb]
                    line = {"probe": "weights", "card": card, "window": mode, "taps": suffix,
                            "m": m, "np": np_,
                            "ms": {k: statistics.median(t) for k, t in times.items()},
                            "call_ms": call_ms, "call_host_us": _host_us(wrapper, 100),
                            "rel_l2": errs, "bound_bytes_ms": bound_bytes,
                            "bound_ops_ms": bound_ops, "tap_ops": tap_ops(plan)}
                    if old is not None:
                        line["old_over_shipped"] = line["ms"]["old"] / line["ms"]["shipped"]
                    print(json.dumps(line), flush=True)
                    del plan, head, want, out, pts
                    torch.cuda.empty_cache()


#: The rows of ``--exec-windows``: chip_smoke.py phase 10's, (label,
#: shape, dtype, point counts).
EXEC_WINDOWS_ROWS = (
    ("3D", (256,) * 3, "complex64", (1_000_000, 16_777_216)),
    ("3D", (256,) * 3, "complex128", (1_000_000, 16_777_216)),
    ("2D", (4096, 4096), "complex64", (16_777_216,)),
    ("1D", (1 << 20,), "complex64", (10_000_000,)),
)


#: The rows of ``--exec-1d``: chip_smoke.py phase 9's, the 1D main path.
EXEC_1D_ROWS = tuple(("1D", (1 << 20,), d, (1_000_000, 10_000_000))
                     for d in ("complex64", "complex128", "float32", "float64"))


def probe_exec_windows(seed: int, rows=EXEC_WINDOWS_ROWS, modes=None, sigma: float = 2.0,
                       reps: int = 5, probe: str = "exec_windows") -> None:
    """set_points, exec_type1 and exec_type2 (CUDA events, median of
    ``reps`` after one warm-up, through the public API alone) of every
    window of ``modes`` (default chip_smoke.py phase 10's: BKB Fast and the
    windows whose taps come from K3) at the shapes of ``rows``, m = 4,
    ``sigma``, uniform points.  The package is the one ``--root`` puts
    first on the path, so that one call can time two trees in turns.  One
    JSON line a row, with set_points plus each transform."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import PHASE10_MODES, WINDOW_MODES, cuda_time_ms, nvidia_smi_line

    card = nvidia_smi_line()
    dev = torch.device("cuda")
    print(f"{card}; package {Path(nufft.__file__).resolve().parent}", flush=True)
    for dim, shape, dtype, nps in rows:
        for mode in modes or PHASE10_MODES:
            kernel, evalmode = WINDOW_MODES[mode]
            plan0 = nufft.PlanNUFFT(np.dtype(dtype), shape, m=4, sigma=sigma,
                                    kernel=getattr(nufft, kernel)(),
                                    kernel_evalmode=getattr(nufft, evalmode)(),
                                    spread_method="blocked", device=dev)
            D = len(shape)
            u = torch.randn((1,) + plan0.spectral_shape, dtype=plan0.complex_dtype,
                            device=dev)[0]
            for np_ in nps:
                gen = torch.Generator(device=dev).manual_seed(seed + np_)
                pts = torch.rand((D, np_), generator=gen, device=dev,
                                 dtype=plan0.real_dtype) * (2 * math.pi)
                vp = torch.randn((np_,), generator=gen, device=dev, dtype=plan0.dtype)
                t_set, plan = cuda_time_ms(lambda: nufft.set_points(plan0, pts), reps=reps)
                t_t1, _ = cuda_time_ms(lambda: nufft.exec_type1(plan, vp), reps=reps)
                t_t2, _ = cuda_time_ms(lambda: nufft.exec_type2(plan, u), reps=reps)
                print(json.dumps({"probe": probe, "card": card, "dim": dim,
                                  "dtype": dtype, "window": mode, "np": np_,
                                  "set_points_ms": t_set, "exec_type1_ms": t_t1,
                                  "exec_type2_ms": t_t2, "set_plus_type1_ms": t_set + t_t1,
                                  "set_plus_type2_ms": t_set + t_t2}), flush=True)
                del plan, pts, vp
                torch.cuda.empty_cache()


DIRECT_NP = (1, 3, 10, 30, 100, 300, 1_000, 3_000, 10_000, 30_000, 100_000)
#: A row's direct path is not run past this multiple of the blocked time.
DIRECT_STOP = 10.0


def probe_direct(seed: int, dtypes, nps, reps: int = 3) -> None:
    """The direct NUDFT (``ops/direct.py``) against the blocked main path
    (m = 4, sigma = 1.5, BKB FastApproximation), both through the public
    API: set_points, exec_type1 and exec_type2 (CUDA events, median of
    ``reps`` after one warm-up), at 256^3, 4096^2 and 2^20 for each of
    ``dtypes`` and Np in ``nps``, uniform points, with the direct path's
    err1 / err2 against exact float64 sums (``chip_smoke._err1`` /
    ``_err2``).  For complex64 also the direct path with complex64 factors
    and product (``direct.FACTOR_DTYPE`` patched, TF32 off): its time and
    errors.  A row stops running the direct path once its exec_type1 +
    exec_type2 exceeds ``DIRECT_STOP`` times the blocked path's.  Per row,
    the crossover Np (log-linear between the last Np where direct wins and
    the first where it loses) and the ``c`` of ``direct.prefers_direct``
    that puts the model's crossover there."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import _err1, _err2, _rank1_spectrum, cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch.ops import direct

    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    dev = torch.device("cuda")
    print(card, flush=True)
    summary = []
    for D in (3, 2, 1):
        shape = SHAPES[D]
        for name in dtypes:
            dtype = np.dtype(name)
            bplan0 = nufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, spread_method="blocked",
                                     device=dev)
            dplan0 = nufft.PlanNUFFT(dtype, shape, spread_method="direct", device=dev)
            a, u_np = _rank1_spectrum(shape, False, seed)
            u = torch.as_tensor(u_np, device=dev).to(bplan0.complex_dtype)
            del u_np
            rows, running = [], True
            for np_ in nps:
                gen = torch.Generator(device=dev).manual_seed(seed + np_)
                pts = torch.rand((D, np_), generator=gen, device=dev,
                                 dtype=bplan0.real_dtype) * (2 * math.pi)
                vp = torch.randn((np_,), generator=gen, device=dev, dtype=bplan0.dtype)
                row = {"probe": "direct", "card": card, "dim": D, "dtype": name, "np": np_}
                for label, plan0 in (("blocked", bplan0), ("direct", dplan0)):
                    if label == "direct" and not running:
                        break
                    t_set, plan = cuda_time_ms(lambda: nufft.set_points(plan0, pts), reps=reps)
                    t1, u1 = cuda_time_ms(lambda: nufft.exec_type1(plan, vp), reps=reps)
                    t2, v2 = cuda_time_ms(lambda: nufft.exec_type2(plan, u), reps=reps)
                    row[label] = dict(set_points_ms=t_set, exec_type1_ms=t1, exec_type2_ms=t2,
                                      err1=_err1(pts, vp, u1, shape, False, seed),
                                      err2=_err2(pts, v2, a, False, seed))
                    if label == "direct" and name == "complex64":
                        old = direct.FACTOR_DTYPE
                        direct.FACTOR_DTYPE = torch.complex64
                        try:
                            t1, u1 = cuda_time_ms(lambda: nufft.exec_type1(plan, vp), reps=reps)
                            t2, v2 = cuda_time_ms(lambda: nufft.exec_type2(plan, u), reps=reps)
                        finally:
                            direct.FACTOR_DTYPE = old
                        row["direct_complex64_factors"] = dict(
                            exec_type1_ms=t1, exec_type2_ms=t2,
                            err1=_err1(pts, vp, u1, shape, False, seed),
                            err2=_err2(pts, v2, a, False, seed))
                    del plan, u1, v2
                    torch.cuda.empty_cache()
                if "direct" in row:
                    b, d = row["blocked"], row["direct"]
                    row["direct_over_blocked"] = ((d["exec_type1_ms"] + d["exec_type2_ms"])
                                                  / (b["exec_type1_ms"] + b["exec_type2_ms"]))
                    running = row["direct_over_blocked"] <= DIRECT_STOP
                    rows.append(row)
                print(json.dumps(row), flush=True)
                del pts, vp
                torch.cuda.empty_cache()
            first_loss = next((i for i, r in enumerate(rows)
                               if r["direct_over_blocked"] >= 1.0), None)
            if first_loss is None:
                crossover = None
            elif first_loss == 0:
                crossover = 0.0
            else:
                (n0, r0), (n1, r1) = ((r["np"], r["direct_over_blocked"])
                                      for r in rows[first_loss - 1:first_loss + 1])
                f = math.log(r0) / (math.log(r0) - math.log(r1))
                crossover = math.exp(math.log(n0) + f * (math.log(n1) - math.log(n0)))
            over = bplan0.shape_over
            c = (None if crossover is None else
                 direct.direct_macs(crossover, bplan0.spectral_shape)
                 / direct.blocked_dft_macs(over))
            summary.append({"probe": "direct_crossover", "card": card, "dim": D, "dtype": name,
                            "crossover_np": crossover, "c": c})
            print(json.dumps(summary[-1]), flush=True)
    print(json.dumps({"probe": "direct_summary", "rows": summary}), flush=True)


#: Point counts of ``--set-points`` a dimension: the main paths'.
SET_POINTS_NP = {3: (16_777_216,), 2: (16_777_216,), 1: (10_000_000,)}
#: ``--set-points``' point layouts: uniform over [-1, 2pi + 1) (some fold);
#: every block empty but the inner ones (``empty_ends``); every point in the
#: first block, or in the last (one thread of the sorted-state kernel then
#: writes every other block's start).
SET_POINTS_CASES = ("uniform", "empty_ends", "first_block", "last_block")


def _set_points_layout(case: str, gen, plan, np_: int):
    """(D, Np) card points of one ``SET_POINTS_CASES`` layout."""
    import torch

    D = plan.ndim
    u = torch.rand((D, np_), generator=gen, device="cuda", dtype=torch.float64)
    if case == "uniform":
        return (u * (2 * math.pi + 2) - 1).to(plan.real_dtype)
    rows = []
    for d, (n, b) in enumerate(zip(plan.shape_over, plan.block_dims)):
        first, last = {"empty_ends": (b, n - b), "first_block": (0, b),
                       "last_block": (n - b, n)}[case]
        lo, hi = first * 2 * math.pi / n, last * 2 * math.pi / n
        # inside [lo, hi) after rounding to the points' type
        rows.append(lo + (hi - lo) * (0.0001 + 0.9998 * u[d]))
    return torch.stack(rows).to(plan.real_dtype)


def probe_set_points(seed: int, dims, dtypes, nps, reps: int, cases=SET_POINTS_CASES) -> None:
    """``set_points``' split and sort (``plan._sorted_state_kernels``: the
    bin-key kernel, the stable sort, the sorted-state kernel) against their
    plain version on the card (``plan._sorted_state_plain``), at
    ``SHAPES`` and ``SET_POINTS_NP`` (m = 4, sigma = 1.5) for each point
    layout of ``cases`` (``SET_POINTS_CASES``), CUDA events, median of
    ``reps`` after one warm-up, in turns plain, kernels, kernels, plain;
    also the whole ``set_points`` and each of the three alone (the wrappers
    ``blocked.bin_keys`` and ``sorted_state``, ``torch.sort``), and
    ``blocking.block_starts`` (the plain chain's block starts, one binary
    search a block) on the same sorted keys.  The kernels' cells,
    fractions, order and block starts are held equal to the plain chain's.
    Bounds by the function's bytes, each input read once and each output
    written once: the keys D coordinates in, a key out a point; the sorted
    state a key, an index and D coordinates in, D cells and D fractions out
    a point, and the block starts.  The records that the key kernel packs
    for the gather (2 or 4 coordinates in 2D / 3D: written once, read once
    in place of the D coordinates) are left out of the bounds and reported
    beside them (``record_ms``).  One JSON line a row."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import HBM_BYTES_PER_S, cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch import blocking
    from nonuniformffts_tpu_torch import plan as plan_mod
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    for D in dims:
        for name in dtypes:
            plan = nufft.PlanNUFFT(np.dtype(name), SHAPES[D], m=4, sigma=1.5,
                                   spread_method="blocked", device=dev)
            geo = (plan.shape_over, plan.block_dims)
            for np_ in nps or SET_POINTS_NP[D]:
                for case in cases:
                    gen = torch.Generator(device=dev).manual_seed(seed + np_)
                    pts = _set_points_layout(case, gen, plan, np_)
                    calls = {
                        "plain": lambda: plan_mod._sorted_state_plain(plan, pts),
                        "kernels": lambda: plan_mod._sorted_state_kernels(plan, pts),
                    }
                    times = {k: [] for k in calls}
                    for k in ("plain", "kernels", "kernels", "plain"):
                        ms_, out = cuda_time_ms(calls[k], reps=reps)
                        times[k].append(ms_)
                        if k == "kernels":
                            got = out
                        else:
                            want = out
                    if not all(torch.equal(g, w) for g, w in zip(got[:4], want[:4])):
                        raise AssertionError(f"set_points kernels {D}D {name} {np_} {case}: "
                                             "not equal to the plain chain")
                    del got, want, out
                    whole_ms, _ = cuda_time_ms(lambda: nufft.set_points(plan, pts), reps=reps)
                    keys_ms, (keys, records) = cuda_time_ms(
                        lambda: blocked.bin_keys(pts, *geo), reps=reps)
                    sort_ms, (skeys, perm) = cuda_time_ms(
                        lambda: torch.sort(keys, stable=True), reps=reps)
                    state_ms, _ = cuda_time_ms(
                        lambda: blocked.sorted_state(records, skeys, perm, *geo), reps=reps)
                    starts_ms, _ = cuda_time_ms(
                        lambda: blocking.block_starts(skeys, *geo), reps=reps)
                    sb = pts.element_size()
                    rec = blocked.BIN_RECORD[D] * sb if D > 1 else 0
                    nblocks, _ = blocking.bin_counts(*geo)
                    keys_bytes = np_ * (D * sb + 4)
                    state_bytes = np_ * (4 + 8 + D * sb + D * 4 + D * sb) + 4 * (nblocks + 1)
                    record_bytes = np_ * (2 * rec - D * sb) if rec else 0
                    print(json.dumps({
                        "probe": "set_points", "card": card, "dim": D, "dtype": name,
                        "np": np_, "case": case, "block_dims": list(plan.block_dims),
                        "nblocks": nblocks,
                        "plain_ms": times["plain"], "kernels_ms": times["kernels"],
                        "set_points_ms": whole_ms, "keys_ms": keys_ms, "sort_ms": sort_ms,
                        "state_ms": state_ms, "block_starts_ms": starts_ms,
                        "keys_bound_ms": 1e3 * keys_bytes / HBM_BYTES_PER_S,
                        "state_bound_ms": 1e3 * state_bytes / HBM_BYTES_PER_S,
                        "record_ms": 1e3 * record_bytes / HBM_BYTES_PER_S,
                        "equal": True}), flush=True)
                    del pts, keys, records, skeys, perm
                    torch.cuda.empty_cache()


#: ``--deconvolve``'s rows: value type and transforms a call (the 32-coil
#: cell's call, then one transform of each main path).
DECONVOLVE_ROWS = (("complex64", 32), ("complex64", 1), ("float32", 1), ("complex128", 1),
                   ("float64", 1))


def probe_deconvolve(seed: int, reps: int) -> None:
    """The deconvolution's three stages (``execution.py``: type 1's
    ``t1_deconv_stage``, type 2's ``t2_pad_stage`` and the unscaled
    ``t2_pad_modes_stage`` of a grouped call) at N = 256^3 over the 384^3
    grid (m = 4, sigma = 1.5) for ``DECONVOLVE_ROWS``, CUDA events, median
    of ``reps`` after one warm-up, beside their bound by bytes (each kept
    mode read once, each output written once); with one transform also the
    plain torch chain (``deconvolve_truncate_plain``,
    ``deconvolve_pad_plain``), in turns kernel, plain, plain, kernel.  One
    JSON line a stage."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import HBM_BYTES_PER_S, cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch.ops import deconvolve

    card = nvidia_smi_line()
    print(card, flush=True)
    for name, C in DECONVOLVE_ROWS:
        plan = nufft.PlanNUFFT(np.dtype(name), SHAPES[3], m=4, sigma=1.5, ntransforms=C,
                               device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed + C)
        spec = torch.randn((C,) + plan.spectral_shape_over, generator=gen, device="cuda",
                           dtype=plan.complex_dtype)
        uhat = torch.randn((C,) + plan.spectral_shape, generator=gen, device="cuda",
                           dtype=plan.complex_dtype)
        modes, over = math.prod(plan.spectral_shape), math.prod(plan.spectral_shape_over)
        nbytes = {"truncate": 2 * modes, "pad": modes + over, "pad_unscaled": modes + over}
        stages = {
            "truncate": (lambda: ex.t1_deconv_stage(plan, spec),
                         lambda: deconvolve.deconvolve_truncate_plain(
                             spec, plan.index_ranges, plan.phihat_inv, plan.normfactor)),
            "pad": (lambda: ex.t2_pad_stage(plan, uhat),
                    lambda: deconvolve.deconvolve_pad_plain(
                        uhat, plan.spectral_shape_over, plan.index_ranges, plan.phihat_inv)),
            "pad_unscaled": (lambda: ex.t2_pad_modes_stage(plan, uhat), None),
        }
        for stage, (kernel, plain) in stages.items():
            times = {"kernel": [], "plain": []}
            order = ("kernel", "plain", "plain", "kernel") if plain and C == 1 else ("kernel",)
            for side in order:
                ms, _ = cuda_time_ms(kernel if side == "kernel" else plain, reps=reps)
                times[side].append(ms)
            bound_ms = 1e3 * C * nbytes[stage] * spec.element_size() / HBM_BYTES_PER_S
            kernel_ms = statistics.mean(times["kernel"])
            print(json.dumps({
                "probe": "deconvolve", "card": card, "dtype": name, "transforms": C,
                "stage": stage, "kernel_ms": times["kernel"], "plain_ms": times["plain"] or None,
                "bound_ms": bound_ms, "bound_share": bound_ms / kernel_ms}), flush=True)
        del spec, uhat, plan
        torch.cuda.empty_cache()


#: The caching allocator's counters ``--alloc-window`` reads around each
#: stretch of steps.
ALLOC_COUNTERS = ("segment.all.allocated", "segment.all.freed", "num_alloc_retries",
                  "num_device_alloc", "num_device_free")


def _our_frames(frames, count: int = 4) -> list:
    """The innermost ``count`` Python frames of the repo's packages."""
    return [f"{Path(f['filename']).name}:{f['line']}:{f['name']}" for f in frames
            if "nonuniformffts_tpu_torch" in f["filename"] or "nufftbench" in f["filename"]][:count]


def probe_alloc_window(root: Path, cells, seed: int, seconds: float) -> None:
    """Which device allocations the benchmark's own runs make inside their
    measured stretches (``nufftbench/harness.py``), for the package the
    harness imports (this tree's, or ``--root``'s).  Each cell runs once
    traced and once untraced through ``harness.run_cell``; around each
    stretch of steps (``Window.run``: the untraced window, the traced run's
    profiled stretch and its timed part) the caching allocator's counters
    (``ALLOC_COUNTERS``) are read, and its history records each segment it
    maps or frees there with the size and the repo's innermost frames.  The
    profiled stretch's trace is also searched for ``cudaMalloc`` and
    ``cudaFree`` calls inside the window (any library's, the caching
    allocator's included), each with its duration and the ``nufft:`` span
    and host operation around it.  One JSON line a run."""
    import torch

    from chip_smoke import nvidia_smi_line
    from nufftbench import harness

    card = nvidia_smi_line()
    print(card, flush=True)
    found = []
    run, summarise = harness.Window.run, harness.tracing.summarise_file

    def counters():
        stats = torch.cuda.memory_stats()
        return {k: stats.get(k, 0) for k in ALLOC_COUNTERS}

    def window_run(win, step, k0, secs, timed=True):
        torch.cuda.synchronize()
        before = counters()
        torch.cuda.memory._record_memory_history(stacks="python", max_entries=200_000)
        try:
            return run(win, step, k0, secs, timed)
        finally:
            torch.cuda.synchronize()
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            after = counters()
            events = [e for trace in snap["device_traces"] for e in trace
                      if e["action"] not in ("alloc", "free_requested", "free_completed")]
            found.append({
                "stretch": "timed" if timed else "profiled", "first_step": k0,
                "counters": {k: after[k] - before[k] for k in after},
                "reserved_gib": torch.cuda.memory_reserved() / 2**30,
                "segments": [{"action": e["action"], "bytes": e["size"],
                              "at": _our_frames(e.get("frames", []))} for e in events[:20]]})

    def summarise_file(path):
        with open(path) as f:
            spans = [e for e in json.load(f).get("traceEvents", [])
                     if e.get("ph") == "X" and "dur" in e]
        win = [e for e in spans if e.get("name") == harness.tracing.WINDOW]
        if win:
            lo, hi = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
            host = [e for e in spans if e.get("cat") in ("user_annotation", "cpu_op")]
            calls = []
            for e in spans:
                if e.get("cat") != "cuda_runtime" or e.get("name") not in (
                        "cudaMalloc", "cudaFree") or not lo <= float(e["ts"]) <= hi:
                    continue
                a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
                around = sorted((h for h in host if float(h["ts"]) <= a
                                 and float(h["ts"]) + float(h["dur"]) >= b),
                                key=lambda h: float(h["ts"]))
                labels = [h["name"] for h in around if h["name"].startswith("nufft:")]
                ops = [h["name"] for h in around if h.get("cat") == "cpu_op"]
                calls.append({"call": e["name"], "ms": (b - a) * 1e-3,
                              "at_ms": (a - lo) * 1e-3, "span": labels[-1] if labels else None,
                              "op": ops[-1] if ops else None})
            found.append({"stretch": "profiled trace", "runtime_calls": calls})
        return summarise(path)

    harness.Window.run, harness.tracing.summarise_file = window_run, summarise_file
    try:
        for name in cells:
            cell = harness.load_cell(root, name)
            for trace in (True, False):
                found.clear()
                result = harness.run_cell(cell, seed, seconds, trace, "cuda")
                metrics = {k: v["value"] for k, v in result["metrics"].items()
                           if k in ("device_idle_pct", "step_ms")}
                print(json.dumps({
                    "probe": "alloc_window", "card": card, "cell": name, "trace": trace,
                    "correct": result["correct"], "metrics": metrics,
                    "idle_gaps": result.get("breakdown", {}).get("idle_gaps", [])[:4],
                    "peak_bytes": result["device"]["memory_peak_bytes"],
                    "stretches": found}), flush=True)
                torch.cuda.empty_cache()
    finally:
        harness.Window.run, harness.tracing.summarise_file = run, summarise


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
    parser.add_argument("--spread3d", action="store_true",
                        help="time the 3D spread kernel against the design it replaced, "
                             "its variants and geometries, and stop")
    parser.add_argument("--interp3d", action="store_true",
                        help="time the 3D interpolation kernel against the design it "
                             "replaced and its variants, and stop")
    parser.add_argument("--interp3d-parts", action="store_true",
                        help="time the 3D interpolation kernel with each phase taken out, "
                             "and stop")
    parser.add_argument("--spread3d-parts", action="store_true",
                        help="time the 3D spread kernel with each phase taken out, and stop")
    parser.add_argument("--spread2d", action="store_true",
                        help="time the 2D spread kernel against the design it replaced, "
                             "the t2 interpolation at both geometries, and the geometry "
                             "sweep with the cost model's fit, and stop")
    parser.add_argument("--spread2d-parts", action="store_true",
                        help="time the 2D spread kernel with each phase taken out, and stop")
    parser.add_argument("--spread1d", action="store_true",
                        help="time the 1D spread kernel against the design it replaced, "
                             "its wrapper call and its variants, and stop")
    parser.add_argument("--spread1d-parts", action="store_true",
                        help="time the 1D spread kernel with each phase taken out, and stop")
    parser.add_argument("--interp2d", action="store_true",
                        help="time the 2D interpolation kernel against the per-point kernel "
                             "it replaced and the staged design tried in its place, its "
                             "wrapper call and its variants, and stop")
    parser.add_argument("--interp2d-parts", action="store_true",
                        help="time the 2D interpolation kernel and the per-point kernel "
                             "with each phase taken out, and stop")
    parser.add_argument("--interp1d", action="store_true",
                        help="time the 1D interpolation kernel against the per-point "
                             "kernel it replaced, its wrapper call and its variants, "
                             "and stop")
    parser.add_argument("--interp1d-parts", action="store_true",
                        help="time the 1D interpolation kernel with each phase taken out, "
                             "and stop")
    parser.add_argument("--weights", action="store_true",
                        help="time the window-weights kernel K3 (raw launches and the "
                             "wrapper call) for four windows in 3D, and stop")
    parser.add_argument("--exec-windows", action="store_true",
                        help="time set_points and both transforms for every window of "
                             "chip_smoke.py phase 10, and stop")
    parser.add_argument("--exec-1d", action="store_true",
                        help="time set_points and both transforms on the 1D main path "
                             "(chip_smoke.py phase 9), and stop")
    parser.add_argument("--direct", action="store_true",
                        help="time the direct NUDFT against the blocked path from 1 to "
                             "100,000 points in 3D, 2D and 1D, and stop")
    parser.add_argument("--interp1d-sweep", action="store_true",
                        help="time the 1D interpolation's point and staged paths against "
                             "each other from 1M to 10M points, and stop")
    parser.add_argument("--set-points", action="store_true",
                        help="time set_points' key and sorted-state kernels and the sort "
                             "against the plain chain on the main paths' shapes, and stop")
    parser.add_argument("--deconvolve", action="store_true",
                        help="time the deconvolution's stages (the kernels of "
                             "csrc/deconvolve.cu) against the plain chain and their "
                             "bounds at 256^3 over 384^3, and stop")
    parser.add_argument("--alloc-window", nargs="+", default=None, metavar="CELL",
                        help="run each benchmark cell traced and untraced, count the "
                             "device allocations inside its measured stretches, and stop")
    parser.add_argument("--seconds", type=float, default=10.0,
                        help="the measured window of --alloc-window's runs")
    parser.add_argument("--root", default=None,
                        help="import nonuniformffts_tpu_torch from this tree (default: "
                             "the script's own)")
    parser.add_argument("--reps", type=int, default=5,
                        help="timed launches a median of --spread1d, --interp2d, --interp1d, "
                             "their -parts twins, --interp1d-sweep, --exec-1d and "
                             "--set-points")
    parser.add_argument("--variants", nargs="+", default=None,
                        help="the variants of --spread1d, --interp2d and --interp1d to time "
                             "(default: all)")
    parser.add_argument("--m", type=int, nargs="+", default=[4],
                        help="the M of --spread1d, --interp2d, --interp1d, --weights and "
                             "the -parts twins")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.root is not None:
        sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this script needs a GPU")
    if args.gloo:
        probe_gloo()
        return 0
    if args.relayout:
        probe_relayout()
        return 0
    if args.spread3d:
        probe_spread3d(args.seed, args.dtype, args.np)
        return 0
    if args.interp3d:
        probe_interp3d(args.seed, args.dtype, args.np)
        return 0
    if args.interp3d_parts:
        probe_interp3d_parts(args.seed, args.dtype, args.np)
        return 0
    if args.spread3d_parts:
        probe_spread3d_parts(args.seed, args.dtype, args.np)
        return 0
    if args.weights:
        probe_weights(args.seed, args.np, args.m)
        return 0
    if args.exec_windows:
        probe_exec_windows(args.seed)
        return 0
    if args.exec_1d:
        probe_exec_windows(args.seed, EXEC_1D_ROWS, ("BKB Fast",), 1.5, args.reps, "exec_1d")
        return 0
    if args.set_points:
        probe_set_points(args.seed, args.dim, args.dtype, args.np, args.reps)
        return 0
    if args.deconvolve:
        probe_deconvolve(args.seed, args.reps)
        return 0
    if args.alloc_window:
        probe_alloc_window(Path(args.root).resolve() if args.root else ROOT, args.alloc_window,
                           args.seed, args.seconds)
        return 0
    if args.interp1d_sweep:
        probe_interp1d_sweep(args.seed, args.dtype, args.np, args.reps)
        return 0
    if args.direct:
        probe_direct(args.seed, [d for d in args.dtype if d.startswith("complex")],
                     args.np or DIRECT_NP, min(args.reps, 3))
        return 0
    lowdim = [(kind, parts) for kind in LOWDIM_KINDS
              for parts in (False, True) if getattr(args, kind + ("_parts" if parts else ""))]
    for kind, parts in lowdim:
        _lowdim_probe(kind, args.seed, args.dtype, args.np, args.m, with_variants=not parts,
                      reps=args.reps, only=args.variants)
    if lowdim:
        return 0
    if args.spread2d or args.spread2d_parts:
        if args.spread2d:
            probe_spread2d(args.seed, args.dtype, args.np)
        if args.spread2d_parts:
            probe_spread2d_parts(args.seed, args.dtype, args.np)
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
