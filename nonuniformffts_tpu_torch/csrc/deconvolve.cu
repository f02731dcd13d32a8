// The deconvolution between the oversampled spectrum and the output modes,
// one pass each way:
//
//   nufft_deconvolve_truncate_<type>  type 1, step 3: each output mode read
//                                     from its place in the oversampled
//                                     spectrum, times normfactor and
//                                     1 / phi_hat of each axis
//   nufft_deconvolve_pad_<type>       type 2, step 1: each element of the
//                                     oversampled spectrum, a kept mode times
//                                     1 / phi_hat of each axis (or as it is,
//                                     with the scaling off), else zero
//
// <type> is f32 or f64 (complex64, complex128 plans) or real_f32, real_f64
// (real-data plans, whose spectra are complex64 and complex128 too: the same
// code under its own name, so that a run counts the real plans' launches
// apart).  Built once per value type (build.py's NUFFT_ONLY 0-3).
//
// Replaces no TPU kernel: the JAX package's deconvolution is jnp slices,
// concatenations and broadcast multiplies (nonuniformffts_tpu/ops/
// deconvolve.py).  The plain version is the same chain in torch
// (ops/deconvolve.py:deconvolve_truncate_plain, deconvolve_pad_plain), which
// CPU tensors run.  On the card that chain made about 7 passes over 256^3 to
// 384^3 grids for type 1 (a torch.cat an axis, the normfactor, a multiply an
// axis) and about 9 for type 2 (three multiplies, then a zeroed grid and its
// copies an axis): 4.7 and 6.1 GB a complex128 transform at 256^3 over
// 384^3, against 0.54 and 1.17 GB that the work needs.
//
// What bounds them on the H100: bytes.  Truncate reads each kept mode once
// and writes each output mode once; pad reads each kept mode once and writes
// each oversampled element once, zeros included.  The design moves no other
// byte:
//
// - The index map is the plan's index_ranges: each axis keeps at most two
//   runs (start0, len0) and (start1, out - len0) of the oversampled axis, in
//   output order (FFTW order, fftshift, or the one run of an r2c plan's
//   halved last axis).  Output index i reads source(i); oversampled index j
//   holds mode(j), or -1 where pad writes a zero.  ops/kernels/common.py
//   mirrors both for the CPU tests.
// - A warp takes a chunk of one row along the last axis (32 lanes x kUnroll
//   accesses, all loads in flight before the stores), so the reads are runs
//   of the source row and the writes runs of the destination row, each
//   coalesced; the row's two leading indices and their factors are formed
//   once a chunk, in 32-bit arithmetic, and a row of pad outside the kept
//   modes of an axis is written as zeros without a read.  A CTA holds
//   kWarps chunks, so a short row (129 values of an r2c plan's halved axis)
//   does not cost a CTA of its own.  Grid y walks the transforms, so one
//   launch covers the C' transforms of a group.
// - Accesses are 16 bytes where the value type allows: one complex128, or
//   two complex64 where the last axis's extents and run bounds are even (the
//   wrapper passes vec = 2 then, ops/kernels/common.py:deconvolve_vector);
//   else 8-byte complex64 values.
// - Each component is multiplied in the plain chain's order, normfactor
//   (type 1), then axis 0, 1 and 2, by real factors: a complex times a
//   real (p, 0) in torch rounds each component's product once, so the
//   result equals the plain chain bit for bit.  Missing leading axes (1D and
//   2D plans) have length 1 and a factor of 1, which is exact.
// - The outputs are new contiguous grids (torch.empty), written whole; the
//   chain's intermediates and its zero fill are gone.
#include <cuda_runtime.h>

#ifdef NUFFT_ONLY
#define NUFFT_WANT(IDX) (NUFFT_ONLY == (IDX))
#else
#define NUFFT_WANT(IDX) 1
#endif

// The spectra as the caller gives them (ops/kernels/build.py:DeconvGeometry,
// from ops/kernels/common.py:deconvolve_axes): three axes, missing leading
// ones of length 1; on axis d output index i < len0 reads start0 + i, the
// others start1 + i - len0.
struct DeconvGeometry {
  long long transforms;  // C'
  int out[3];            // output modes an axis
  int over[3];           // oversampled spectral extents an axis
  int start0[3], len0[3], start1[3];
};

namespace {

constexpr int kWarps = 4;   // warps of a CTA, an item each
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;  // accesses in flight a lane
constexpr int kItemVecs = 32 * kUnroll;  // accesses of one item
constexpr unsigned kMaxGridY = 65535;
// Items of one transform the kernels take (refuse): below 2^31, so that an
// item index plus the grid's stride stays inside 32 unsigned bits.
constexpr unsigned long long kMaxItems = 0x7fffffffULL;

template <typename R, int V>
struct alignas(2 * V * sizeof(R)) Vec {
  R x[2 * V];
};

__device__ __forceinline__ int source(const DeconvGeometry& g, int d, int i) {
  return i < g.len0[d] ? g.start0[d] + i : g.start1[d] + (i - g.len0[d]);
}

__device__ __forceinline__ int mode(const DeconvGeometry& g, int d, int j) {
  const unsigned a = static_cast<unsigned>(j - g.start0[d]);
  if (a < static_cast<unsigned>(g.len0[d])) return static_cast<int>(a);
  const unsigned b = static_cast<unsigned>(j - g.start1[d]);
  if (b < static_cast<unsigned>(g.out[d] - g.len0[d])) return g.len0[d] + static_cast<int>(b);
  return -1;
}

template <typename R>
__device__ __forceinline__ R factor(const R* __restrict__ p, int i) {
  return p ? __ldg(p + i) : R(1);
}

// Type 1: out (C', out0, out1, out2) from in (C', over0, over1, over2).
template <typename R, int V>
__global__ void __launch_bounds__(kThreads)
    truncate_kernel(const R* __restrict__ in, R* __restrict__ out, const R* __restrict__ p0,
                    const R* __restrict__ p1, const R* __restrict__ p2, R nf,
                    DeconvGeometry g, unsigned chunks) {
  using T = Vec<R, V>;
  const int row_vecs = g.out[2] / V;
  const unsigned items = static_cast<unsigned>(g.out[0]) * g.out[1] * chunks;
  const int lane = threadIdx.x & 31;
  for (long long c = blockIdx.y; c < g.transforms; c += gridDim.y) {
    for (unsigned item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < items;
         item += gridDim.x * kWarps) {
      const unsigned row = item / chunks;
      const int chunk = static_cast<int>(item - row * chunks);
      const int i0 = static_cast<int>(row / g.out[1]);
      const int i1 = static_cast<int>(row - static_cast<unsigned>(i0) * g.out[1]);
      const R f0 = factor(p0, i0), f1 = factor(p1, i1);
      const R* src = in + 2 * (((c * g.over[0] + source(g, 0, i0)) * g.over[1] +
                                source(g, 1, i1)) * g.over[2]);
      R* dst = out + 2 * ((c * g.out[0] + i0) * g.out[1] + i1) * g.out[2];
      const int first = chunk * kItemVecs + lane;
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jv = first + 32 * u;
        if (jv < row_vecs) v[u] = *reinterpret_cast<const T*>(src + 2 * source(g, 2, jv * V));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jv = first + 32 * u;
        if (jv < row_vecs) {
#pragma unroll
          for (int k = 0; k < 2 * V; ++k) {
            v[u].x[k] = v[u].x[k] * nf * f0 * f1 * factor(p2, jv * V + k / 2);
          }
          *reinterpret_cast<T*>(dst + 2 * jv * V) = v[u];
        }
      }
    }
  }
}

// Type 2: out (C', over0, over1, over2) from in (C', out0, out1, out2), the
// kept modes scaled when `scale`, zeros elsewhere.
template <typename R, int V>
__global__ void __launch_bounds__(kThreads)
    pad_kernel(const R* __restrict__ in, R* __restrict__ out, const R* __restrict__ p0,
               const R* __restrict__ p1, const R* __restrict__ p2, int scale,
               DeconvGeometry g, unsigned chunks) {
  using T = Vec<R, V>;
  const int row_vecs = g.over[2] / V;
  const unsigned items = static_cast<unsigned>(g.over[0]) * g.over[1] * chunks;
  const int lane = threadIdx.x & 31;
  for (long long c = blockIdx.y; c < g.transforms; c += gridDim.y) {
    for (unsigned item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < items;
         item += gridDim.x * kWarps) {
      const unsigned row = item / chunks;
      const int chunk = static_cast<int>(item - row * chunks);
      const int j0 = static_cast<int>(row / g.over[1]);
      const int j1 = static_cast<int>(row - static_cast<unsigned>(j0) * g.over[1]);
      const int m0 = mode(g, 0, j0), m1 = mode(g, 1, j1);
      R* dst = out + 2 * ((c * g.over[0] + j0) * g.over[1] + j1) * g.over[2];
      const int first = chunk * kItemVecs + lane;
      if (m0 < 0 || m1 < 0) {
        const T zero{};
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jv = first + 32 * u;
          if (jv < row_vecs) *reinterpret_cast<T*>(dst + 2 * jv * V) = zero;
        }
        continue;
      }
      const R f0 = scale ? factor(p0, m0) : R(1), f1 = scale ? factor(p1, m1) : R(1);
      const R* src = in + 2 * ((c * g.out[0] + m0) * g.out[1] + m1) * g.out[2];
      T v[kUnroll];
      int m2[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jv = first + 32 * u;
        m2[u] = jv < row_vecs ? mode(g, 2, jv * V) : -1;
        v[u] = m2[u] >= 0 ? *reinterpret_cast<const T*>(src + 2 * m2[u]) : T{};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jv = first + 32 * u;
        if (jv >= row_vecs) continue;
        if (scale && m2[u] >= 0) {
#pragma unroll
          for (int k = 0; k < 2 * V; ++k) {
            v[u].x[k] = v[u].x[k] * f0 * f1 * factor(p2, m2[u] + k / 2);
          }
        }
        *reinterpret_cast<T*>(dst + 2 * jv * V) = v[u];
      }
    }
  }
}

// The (row, chunk) items of one transform, over rows (rows[0], rows[1]) of
// rows[2] values, a warp's kItemVecs accesses of `vec` values an item.
unsigned long long items_of(const int* rows, int vec, unsigned* chunks) {
  *chunks = (rows[2] / vec + kItemVecs - 1) / kItemVecs;
  return 1ULL * rows[0] * rows[1] * *chunks;
}

// Refuses (cudaErrorInvalidValue, before any launch) what the kernels do not
// take: a vector width other than 1 or 16 / (2 sizeof R), or one whose last
// axis is not made of whole vectors; runs outside their axis; or a step
// whose items of one transform over `rows` (out for truncate, over for pad)
// reach kMaxItems: the kernels count items, rows and the CTAs of grid x in
// 32-bit arithmetic.  Element offsets are 64-bit, so a transform may hold
// more than 2^31 elements.
template <typename R>
bool refuse(const DeconvGeometry& g, int vec, const int* rows) {
  if (vec != 1 && !(vec == 2 && sizeof(R) == 4)) return true;
  for (int d = 0; d < 3; ++d) {
    if (g.out[d] < 0 || g.over[d] < 0 || g.len0[d] < 0 || g.len0[d] > g.out[d]) return true;
  }
  if (vec == 2 && ((g.out[2] | g.over[2] | g.start0[2] | g.len0[2] | g.start1[2]) & 1)) {
    return true;
  }
  unsigned chunks;
  return items_of(rows, vec, &chunks) >= kMaxItems;
}

// The launch grid: x over the items of one transform, kWarps a CTA, y over
// the transforms; false when there is nothing to write.
bool grid_of(const DeconvGeometry& g, const int* rows, int vec, unsigned* chunks, dim3* grid) {
  const unsigned long long items = items_of(rows, vec, chunks);
  if (items == 0 || g.transforms <= 0) return false;
  grid->x = static_cast<unsigned>((items + kWarps - 1) / kWarps);
  grid->y = static_cast<unsigned>(g.transforms < kMaxGridY ? g.transforms : kMaxGridY);
  grid->z = 1;
  return true;
}

template <typename R>
int launch_truncate(const void* in, void* out, const void* p0, const void* p1, const void* p2,
                    double normfactor, const DeconvGeometry* geom, int vec, void* stream_ptr) {
  const DeconvGeometry g = *geom;
  if (refuse<R>(g, vec, g.out)) return static_cast<int>(cudaErrorInvalidValue);
  unsigned chunks;
  dim3 grid;
  if (!grid_of(g, g.out, vec, &chunks, &grid)) return 0;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const R* x = static_cast<const R*>(in);
  R* y = static_cast<R*>(out);
  const R *f0 = static_cast<const R*>(p0), *f1 = static_cast<const R*>(p1),
          *f2 = static_cast<const R*>(p2);
  const R nf = static_cast<R>(normfactor);
  if constexpr (sizeof(R) == 4) {
    if (vec == 2) {
      truncate_kernel<R, 2><<<grid, kThreads, 0, stream>>>(x, y, f0, f1, f2, nf, g, chunks);
      return static_cast<int>(cudaGetLastError());
    }
  }
  truncate_kernel<R, 1><<<grid, kThreads, 0, stream>>>(x, y, f0, f1, f2, nf, g, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_pad(const void* in, void* out, const void* p0, const void* p1, const void* p2,
               int scale, const DeconvGeometry* geom, int vec, void* stream_ptr) {
  const DeconvGeometry g = *geom;
  if (refuse<R>(g, vec, g.over)) return static_cast<int>(cudaErrorInvalidValue);
  unsigned chunks;
  dim3 grid;
  if (!grid_of(g, g.over, vec, &chunks, &grid)) return 0;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const R* x = static_cast<const R*>(in);
  R* y = static_cast<R*>(out);
  const R *f0 = static_cast<const R*>(p0), *f1 = static_cast<const R*>(p1),
          *f2 = static_cast<const R*>(p2);
  if constexpr (sizeof(R) == 4) {
    if (vec == 2) {
      pad_kernel<R, 2><<<grid, kThreads, 0, stream>>>(x, y, f0, f1, f2, scale, g, chunks);
      return static_cast<int>(cudaGetLastError());
    }
  }
  pad_kernel<R, 1><<<grid, kThreads, 0, stream>>>(x, y, f0, f1, f2, scale, g, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nufft_deconvolve_truncate_<type>: in (C', over0, over1, over2) and out
// (C', out0, out1, out2), complex, contiguous, aligned to 16 bytes when
// vec = 2 (else to a value); p0, p1, p2 the axes' 1 / phi_hat in the real
// type at the output modes, null for a missing axis; geom a host pointer.
//
// nufft_deconvolve_pad_<type>: in (C', out0, out1, out2) and out (C', over0,
// over1, over2) as above; the factors are read only when scale != 0.
//
// Both launch on `stream`, do not synchronise, allocate nothing, write the
// whole output, and return the launch's cudaError_t (cudaErrorInvalidValue
// for a geometry they refuse, before any launch).
#define NUFFT_DECONVOLVE_ENTRIES(SUFFIX, R)                                                    \
  extern "C" int nufft_deconvolve_truncate_##SUFFIX(                                          \
      const void* in, void* out, const void* p0, const void* p1, const void* p2,              \
      double normfactor, const DeconvGeometry* geom, int vec, void* stream) {                 \
    return launch_truncate<R>(in, out, p0, p1, p2, normfactor, geom, vec, stream);            \
  }                                                                                           \
  extern "C" int nufft_deconvolve_pad_##SUFFIX(                                               \
      const void* in, void* out, const void* p0, const void* p1, const void* p2, int scale,   \
      const DeconvGeometry* geom, int vec, void* stream) {                                    \
    return launch_pad<R>(in, out, p0, p1, p2, scale, geom, vec, stream);                      \
  }

#if NUFFT_WANT(0)
NUFFT_DECONVOLVE_ENTRIES(f32, float)
#endif
#if NUFFT_WANT(1)
NUFFT_DECONVOLVE_ENTRIES(f64, double)
#endif
#if NUFFT_WANT(2)
NUFFT_DECONVOLVE_ENTRIES(real_f32, float)
#endif
#if NUFFT_WANT(3)
NUFFT_DECONVOLVE_ENTRIES(real_f64, double)
#endif
