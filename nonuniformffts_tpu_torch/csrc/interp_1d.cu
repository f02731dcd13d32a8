// K5 (1D): type-2 interpolation from the 1D oversampled grid at the
// non-uniform points, one kernel template over the value type:
//
//   nufft_interp_1d_f32       complex64
//   nufft_interp_1d_f64       complex128
//   nufft_interp_1d_real_f32  float32
//   nufft_interp_1d_real_f64  float64
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_interp_kernel (the
// yz-form Pallas kernel, which every 1D plan runs) with the
// common.halo_gather pass before it.  On the TPU halo_gather copied each
// padded block out of the grid, the kernel contracted it with a dense
// weight matrix on the MXU, and a masked sort restored input order.
//
// The first design here (PERF.md) took
// a thread a point: horner_taps' runtime loop a tap, 2M cells from global
// memory, the result scattered to out[c, perm[j]].  Taken apart at 10M
// points and M = 4 (chip_probe.py --interp1d-parts) it spent 55-65% of its
// time in that scatter, and at M = 8-10 in float32 and float64 a quarter
// to a third in the taps and the cell loads.  The API returns the caller's
// point order, and the sort put neighbours in the grid, not in that order,
// side by side.  So there are two paths, by the size of the output (the
// wrapper's choice, ops/kernels/common.py:interp1d_gathers):
//
// - An output of up to 8 MiB (the main path's 1M points but complex128):
//   a thread a sorted point, as the first design, its taps by Horner on
//   coefficient-major rows in shared memory (window.cuh:horner_rows, the
//   2M chains together, as spread_1d.cu) or from K3's table (wtaps); its
//   result stored at out[c, perm[j]], a scattered store.  Up to there it
//   ran as fast as the staged path below or faster (0.79-1.01x its time);
//   past 11 MiB the staged path won in every value type
//   (chip_probe.py --interp1d-sweep).
// - A larger output (10M points: the scatter cost 0.6 of 0.74 ms in
//   complex64 once the rest was fast): one CTA per spatial block of b0
//   cells, whose points are the block's run of the bin-sorted arrays (the
//   plan's pstarts), sorted by cell.  A run with at least one point for
//   every kSparse cells of its window (the block's b0 cells and the 2M - 1
//   halo) stages that window, for as many transforms at a time as
//   kStageBytes hold, in shared memory: 16-byte cp.async chunks from the
//   chunk that holds the window's first cell, with periodic wrap cell by
//   cell where a chunk crosses the grid's ends.  A sparser run reads the
//   grid in global memory.  Each thread takes a point at a time.  The
//   results go to their sorted positions in a scratch table, coalesced,
//   and gather_kernel puts them in order, out[c, i] = sorted[c, inv[i]]:
//   scattered reads and coalesced writes in place of scattered writes.
// - Both sum in T in the first design's order, so the results are the
//   first design's bit for bit.
//
// What bounds it on the H100: at 10M points putting the results in the
// caller's order, which no layout of the sorted points makes coalesced;
// then the point state (cells, fractions, permutation) and the taps.  The
// grid (12.6 MB complex64, 25 MB complex128) stays in L2.  There are no
// atomics.
#include <cstdint>

#include "window.cuh"

namespace {

// kStageBytes and kSparse must match ops/kernels/common.py
// (INTERP1D_STAGE_BYTES, INTERP1D_SPARSE).
// Threads of one CTA of interp_1d_kernel, a point each at a time.
constexpr int kThreads = 128;
// Threads of one CTA of interp_1d_point_kernel.
constexpr int kPointThreads = 256;
// A run is staged when it holds a point for every kSparse cells of its
// window.
constexpr int kSparse = 8;
// Shared memory for the staged windows of one pass over the transforms.
constexpr int kStageBytes = 32768;

// The staged window of a CTA, for a block of b0 cells: `span` cells (the
// block and the 2M - 1 halo), staged from the 16-byte chunk that holds the
// first, so `cells` cells a transform (whole chunks, for the worst offset);
// `chans` transforms a pass, 0 when one window exceeds kStageBytes (then no
// run is staged); `smem` the CTA's dynamic shared memory, the
// coefficient-major coefficients first.
struct Geometry {
  int span, cells, chans;
  size_t smem;
};

template <int M, typename T, int NCOMP>
__host__ __device__ inline Geometry geometry_of(int ncoef, int b0, int nchan) {
  constexpr int kChunk = 16 / int(sizeof(T) * NCOMP);
  Geometry g;
  g.span = b0 + 2 * M - 1;
  g.cells = (g.span + 2 * (kChunk - 1)) / kChunk * kChunk;
  const int bytes = g.cells * int(sizeof(T)) * NCOMP;
  g.chans = bytes <= kStageBytes ? (nchan < kStageBytes / bytes ? nchan : kStageBytes / bytes)
                                 : 0;
  g.smem = sizeof(T) * (size_t)nufft::row_pitch<2 * M, T>() * ncoef + (size_t)g.chans * bytes;
  return g;
}

using nufft::cp_async;
using nufft::cp_async_commit;
using nufft::cp_async_wait_all;
using nufft::mod_index;

// The sum of cell(t) times tap t over the S taps, in T and in the order of
// the first design, times nf.
template <int S, typename T, int NCOMP, typename Cell>
__device__ __forceinline__ nufft::Value<T, NCOMP> contract(const T (&w)[S], T nf, Cell cell) {
  T acc[NCOMP] = {};
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const nufft::Value<T, NCOMP> val = cell(t);
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) acc[k] = nufft::fma_t(val.c[k], w[t], acc[k]);
  }
  nufft::Value<T, NCOMP> res;
#pragma unroll
  for (int k = 0; k < NCOMP; ++k) res.c[k] = acc[k] * nf;
  return res;
}

// The coefficient-major (ncoef, kPitch) rows that horner_rows reads, from
// the tap-major (S, ncoef) coefficients, by the CTA's threads.
template <int S, typename T>
__device__ __forceinline__ void coefficient_rows(const T* coefs, int ncoef, T* cs) {
  constexpr int kPitch = nufft::row_pitch<S, T>();
  for (int i = threadIdx.x; i < kPitch * ncoef; i += blockDim.x) {
    const int q = i / kPitch, t = i - q * kPitch;
    cs[i] = t < S ? coefs[t * ncoef + q] : T(0);
  }
}

// Outputs of up to 8 MiB: a thread a sorted point, its taps by horner_rows
// (or from wtaps), its 2M cells read from the grid with periodic wrap, its
// result stored at out[c, perm[j]].  TAPS: the window's taps come in wtaps
// (window_weights.cu), else by Horner's rule (two instantiations, so that
// the Horner one keeps the registers it needs alone).
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kPointThreads) interp_1d_point_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ grid, const int* __restrict__ cells,
    const T* __restrict__ fracs, const long long* __restrict__ perm,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    nufft::Value<T, NCOMP>* __restrict__ out, long long np, int nchan, int ncoef, int n0,
    double normfactor) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // (ncoef, row_pitch)
  if constexpr (!TAPS) coefficient_rows<S>(coefs, ncoef, cs);
  __syncthreads();
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= np) return;
  T w[S];
  if constexpr (TAPS) {
#pragma unroll
    for (int t = 0; t < S; ++t) w[t] = wtaps[t * np + j];
  } else {
    nufft::horner_rows<S>(cs, ncoef, fracs[j], w);
  }
  const int cx = cells[j] - (M - 1);
  const long long dest = perm[j];
  const T nf = T(normfactor);
  for (int c = 0; c < nchan; ++c) {
    const nufft::Value<T, NCOMP>* g = grid + (long long)c * n0;
    out[c * np + dest] =
        contract<S, T, NCOMP>(w, nf, [&](int t) { return g[nufft::wrap_index(cx + t, n0)]; });
  }
}

// Larger outputs: a CTA a block, each result stored at its
// sorted position, out[c, j], for gather_kernel to put in the caller's
// order.  TAPS as in interp_1d_point_kernel.
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kThreads) interp_1d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ grid, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    nufft::Value<T, NCOMP>* __restrict__ out, long long np, int nchan, int ncoef, int n0,
    int b0, double normfactor) {
  using V = nufft::Value<T, NCOMP>;
  constexpr int S = 2 * M, kPitch = nufft::row_pitch<S, T>();
  constexpr int kChunk = 16 / int(sizeof(V));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);                  // (ncoef, kPitch)
  V* win = reinterpret_cast<V*>(cs + kPitch * ncoef);      // (chans, geo.cells)

  const int bid = blockIdx.x;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA
  const int tid = threadIdx.x;
  if constexpr (!TAPS) coefficient_rows<S>(coefs, ncoef, cs);
  const Geometry geo = geometry_of<M, T, NCOMP>(ncoef, b0, nchan);
  const bool staged = geo.chans > 0 && (long long)kSparse * (p_end - p_begin) >= geo.span;
  const int ox = bid * b0;
  // The window's first cell, ox - (M - 1), and the chunk that holds it.
  const int s0 = ox - (M - 1);
  const int a0 = (s0 >= 0 ? s0 : s0 - (kChunk - 1)) / kChunk * kChunk;
  const int lo = s0 - a0;
  const int nchunks = (lo + geo.span + kChunk - 1) / kChunk;
  const int chans = staged ? geo.chans : nchan;
  const T nf = T(normfactor);

  for (int c0 = 0; c0 < nchan; c0 += chans) {
    const int cn = min(chans, nchan - c0);
    if (staged) {
      if (c0 > 0) __syncthreads();  // the last pass's reads of the window
      for (int i = tid; i < cn * nchunks; i += kThreads) {
        const int c = i / nchunks, k = i - c * nchunks;
        const int gc = a0 + k * kChunk;
        const V* row = grid + (long long)(c0 + c) * n0;
        V* dst = win + c * geo.cells + k * kChunk;
        if (gc >= 0 && gc + kChunk <= n0 && (reinterpret_cast<uintptr_t>(row + gc) & 15) == 0) {
          cp_async<16>(dst, row + gc);
        } else {
#pragma unroll
          for (int e = 0; e < kChunk; ++e)
            cp_async<int(sizeof(V))>(dst + e, row + mod_index(gc + e, n0));
        }
      }
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();  // the coefficients and the staged window
    for (int j = p_begin + tid; j < p_end; j += kThreads) {
      const int cx = cells[j];
      T w[S];
      if constexpr (TAPS) {
#pragma unroll
        for (int t = 0; t < S; ++t) w[t] = wtaps[t * np + j];
      } else {
        nufft::horner_rows<S>(cs, ncoef, fracs[j], w);
      }
      for (int c = 0; c < cn; ++c) {
        V res;
        if (staged) {  // the point's first cell at cx - ox + lo of the staged window
          const V* sw = win + c * geo.cells + lo + (cx - ox);
          res = contract<S, T, NCOMP>(w, nf, [&](int t) { return sw[t]; });
        } else {
          const V* g = grid + (long long)(c0 + c) * n0;
          res = contract<S, T, NCOMP>(w, nf, [&](int t) {
            return g[nufft::wrap_index(cx - (M - 1) + t, n0)];
          });
        }
        out[(c0 + c) * np + j] = res;
      }
    }
  }
}

// out[c, i] = sorted[c, inv[i]]: the sorted results in the caller's order.
// The reads are scattered, the writes coalesced, kGather outputs a thread in
// flight together.
constexpr int kGather = 4;

template <typename V>
__global__ void __launch_bounds__(256) gather_kernel(const V* __restrict__ sorted,
                                                     const int* __restrict__ inv,
                                                     V* __restrict__ out, long long np,
                                                     int nchan) {
  const long long i0 = ((long long)blockIdx.x * blockDim.x) * kGather + threadIdx.x;
  int src[kGather];
#pragma unroll
  for (int u = 0; u < kGather; ++u) {
    const long long i = i0 + u * blockDim.x;
    src[u] = i < np ? inv[i] : 0;
  }
  for (int c = 0; c < nchan; ++c) {
    V v[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) v[u] = sorted[c * np + src[u]];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const long long i = i0 + u * blockDim.x;
      if (i < np) out[c * np + i] = v[u];
    }
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* grid, const void* cells, const void* fracs, const void* perm,
                   const void* pstarts, const void* coefs, const void* wtaps, void* out,
                   void* sorted, const void* inv, long long np, int nchan, int ncoef, int n0,
                   int b0, double normfactor, cudaStream_t stream) {
  using V = nufft::Value<T, NCOMP>;
  if (!sorted) {
    auto kernel = wtaps ? interp_1d_point_kernel<M, T, NCOMP, true>
                        : interp_1d_point_kernel<M, T, NCOMP, false>;
    const size_t smem = sizeof(T) * (size_t)nufft::row_pitch<2 * M, T>() * ncoef;
    kernel<<<(unsigned)((np + kPointThreads - 1) / kPointThreads), kPointThreads, smem,
             stream>>>(static_cast<const V*>(grid), static_cast<const int*>(cells),
                       static_cast<const T*>(fracs), static_cast<const long long*>(perm),
                       static_cast<const T*>(coefs), static_cast<const T*>(wtaps),
                       static_cast<V*>(out), np, nchan, ncoef, n0, normfactor);
    return cudaGetLastError();
  }
  const Geometry geo = geometry_of<M, T, NCOMP>(ncoef, b0, nchan);
  auto kernel = wtaps ? interp_1d_kernel<M, T, NCOMP, true> : interp_1d_kernel<M, T, NCOMP, false>;
  kernel<<<n0 / b0, kThreads, geo.smem, stream>>>(
      static_cast<const V*>(grid), static_cast<const int*>(cells),
      static_cast<const T*>(fracs), static_cast<const int*>(pstarts),
      static_cast<const T*>(coefs), static_cast<const T*>(wtaps), static_cast<V*>(sorted), np,
      nchan, ncoef, n0, b0, normfactor);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_cta = 256LL * kGather;
  gather_kernel<V><<<(unsigned)((np + per_cta - 1) / per_cta), 256, 0, stream>>>(
      static_cast<const V*>(sorted), static_cast<const int*>(inv), static_cast<V*>(out), np,
      nchan);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* grid, const void* cells, const void* fracs, const void* perm,
             const void* pstarts, const void* coefs, const void* wtaps, void* out,
             void* sorted, const void* inv, long long np, int nchan, int m, int ncoef, int n0,
             int b0, double normfactor, void* stream) {
  if (np == 0) return (int)cudaSuccess;
  if ((sorted == nullptr) != (inv == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_INTERP_CASE(MM)                                                        \
  case MM:                                                                           \
    return (int)launch<MM, T, NCOMP>(grid, cells, fracs, perm, pstarts, coefs, wtaps, \
                                     out, sorted, inv, np, nchan, ncoef, n0, b0,     \
                                     normfactor, s);
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
// index of each sorted point; pstarts (n0 / b0 + 1,) int32, block b's
// points at sorted positions [pstarts[b], pstarts[b + 1]); coefs (1, 2m,
// ncoef) T, or ncoef = 0 and no coefficients for a window other than
// kHorner, whose taps come in wtaps (1, 2m, np) T (window_weights.cu), null
// for kHorner; out (nchan, np) values in original point order.  sorted and
// inv both null: the point path, each result stored at out[c, perm[j]];
// else the staged path, sorted (nchan, np) values, scratch, taking the
// results in sorted order and a second kernel putting them in place,
// out[c, i] = sorted[c, inv[i]], inv (np,) int32 the sorted position of
// original point i.  T is float for
// *_f32, double for *_f64; normfactor is a double for both.  Launches on
// `stream`, does not synchronise, allocates nothing.
#define NUFFT_INTERP_ENTRY(NAME, T, NCOMP)                                              \
  extern "C" int NAME(const void* grid, const void* cells, const void* fracs,           \
                      const void* perm, const void* pstarts, const void* coefs,         \
                      const void* wtaps, void* out, void* sorted, const void* inv,      \
                      long long np, int nchan, int m, int ncoef, int n0, int b0,        \
                      double normfactor, void* stream) {                                \
    return dispatch<T, NCOMP>(grid, cells, fracs, perm, pstarts, coefs, wtaps, out,     \
                              sorted, inv, np, nchan, m, ncoef, n0, b0, normfactor,     \
                              stream);                                                  \
  }

#if NUFFT_WANT(0)
NUFFT_INTERP_ENTRY(nufft_interp_1d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_INTERP_ENTRY(nufft_interp_1d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_INTERP_ENTRY(nufft_interp_1d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_INTERP_ENTRY(nufft_interp_1d_real_f64, double, 1)
#endif
