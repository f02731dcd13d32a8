// K5 (2D): type-2 interpolation from the 2D oversampled grid at the
// non-uniform points, one kernel template over the value type:
//
//   nufft_interp_2d_f32       complex64
//   nufft_interp_2d_f64       complex128
//   nufft_interp_2d_real_f32  float32
//   nufft_interp_2d_real_f64  float64
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_interp_kernel (the
// yz-form Pallas kernel launched by interpolate_blocked) with the
// common.halo_gather pass before it, and, for the float64 instantiations,
// blocked_ds.py:_interp_kernel_ds in 2D.  On the TPU halo_gather copied each
// padded block out of the grid, the kernel contracted it with dense weight
// matrices on the MXU, and a masked sort put the results back in input
// order.
//
// The first design here (interp_2d_point_kernel below) took a thread
// a bin-sorted point with its x loop rolled: each step evaluated one x tap
// by a runtime Horner loop, then loaded one row of 2M cells at 64-bit
// addresses.  Taken apart on the H100 (chip_probe.py --interp2d-parts,
// PERF.md) it spent, at M = 8, 70-78% of its time in the window's loads
// and 29-50% in the taps; at M = 4 the largest parts were the scattered
// store and the point state, and unrolling its x loop (253 registers, one
// CTA an SM) made it 2.2-2.7x slower.  This design keeps a thread a point
// and its scattered store, and changes what the thread issues:
//
// - Both dimensions' 2M taps at once, before any load: horner_rows on a
//   coefficient-major (2, ncoef, row_pitch) table in shared memory (the 2M
//   chains advance together), or K3's table (wtaps) for the other windows.
// - Every row is one base address and whole 16-byte loads at constant
//   offsets from it: the row's window from the 16-byte chunk that holds its
//   first cell, kChunks chunks (2M + 2 cells for complex64 and float64,
//   2M rounded up past the offset for float32, 2M for complex128).  The
//   point's y taps are shifted once to that chunk's offset, with zero taps
//   on the cells past its window, so the row's sum runs over the loaded
//   cells in order and equals the first design's sum bit for bit (a zero
//   tap adds an exact zero).  A point whose window wraps in y, or a grid
//   whose rows are not whole chunks, reads its 2M cells one at a time with
//   periodic wrap, in the same order.
// - The x loop is unrolled and its rows are issued kRowsInFlight at a time
//   before their FMAs, as many as kLoadRegs registers of loaded cells hold;
//   __launch_bounds__ caps the registers by value type and M (min_ctas).
// - Offsets are 32-bit cells from the transform's base (bin_sort keeps the
//   grid below 2^31 cells).  One pass over the point's taps serves all
//   nchan transforms.
//
// It runs where it was as fast as the first design at 16.8M points and at
// the main path's, and within 5% at 377,487 (rows_mask): mostly from M = 7
// (1.1-1.8x at 16.8M points), where the window's loads and taps dominate.
// Elsewhere, at M = 4 in three of the four value types among them, the
// instantiation keeps the first design's loop: there the scattered store
// and the point state set the time, which neither design changes.
//
// Every value type sums in T with FMAs, in the first design's order, and
// multiplies by normfactor, passed as a double so that FP64 plans keep every
// bit.  There are no atomics and no TF32.
//
// What bounds it on the H100: the window's loads, served from L1 and L2
// ((2M)^2 cells a point; the grid itself is read from HBM about once), and
// the scattered store of each result to out[c, perm[j]] (a sorted store
// would take 0.3-0.5 ms off 1.5 at M = 4 and 16.8M points, before the
// gather that would put the results in order).
#include <climits>
#include <cstdint>

#include "window.cuh"

namespace {

// Must match ops/kernels/common.py (INTERP2D_THREADS, INTERP2D_LOAD_REGS,
// INTERP2D_ROWS_M, interp2d_rows, interp2d_min_ctas, interp2d_smem_bytes).
constexpr int kThreads = 256;
// Registers of loaded cells a thread keeps in flight: the rows issued
// together before their FMAs.
constexpr int kLoadRegs = 64;
// Each row's cells are read as whole 16-byte chunks.
constexpr bool kChunkRows = true;

// Bit m set: the instantiation for M = m and a value of ncomp scalars of
// scalar_bytes reads whole-chunk rows (this design); the others keep the
// first design's rolled x loop, which was as fast there on the H100, in
// the same runs (chip_probe.py --interp2d --m 2 .. 10, PERF.md): complex64
// from M = 7, complex128 at M = 4, 9 and 10, float32 at M = 2 and from 7,
// float64 from 5.
__host__ __device__ constexpr unsigned rows_mask(int scalar_bytes, int ncomp) {
  return scalar_bytes == 4 ? (ncomp == 2 ? 0x780u : 0x784u) : (ncomp == 2 ? 0x610u : 0x7E0u);
}

__host__ __device__ constexpr bool chunked_rows(int scalar_bytes, int ncomp, int m) {
  return (rows_mask(scalar_bytes, ncomp) >> m) & 1u;
}

// Resident CTAs of kThreads an SM that interp_2d_kernel's register cap
// leaves room for, by the bytes of the value type's scalar and M.  Three
// CTAs (80 registers) spilled up to 2 KB past M = 4; one (255) left too few
// warps below M = 9 in 64-bit.
constexpr int min_ctas(int scalar_bytes, int m) {
  return scalar_bytes == 4 ? (m > 4 ? 2 : 3) : (m > 8 ? 1 : 2);
}

// The cells of one 16-byte load.
template <typename V, int P>
struct alignas(sizeof(V) * P) Chunk {
  V v[P];
};

// A row's window geometry for value type V and S taps: kPer cells a chunk,
// kChunks chunks a row, kWidth cells loaded.
template <typename V, int S>
struct RowGeometry {
  static constexpr int kPer = kChunkRows ? 16 / int(sizeof(V)) : 1;
  static constexpr int kChunks = (S + kPer - 1 + kPer - 1) / kPer;
  static constexpr int kWidth = kChunks * kPer;
  static constexpr int kRowRegs = kChunks * kPer * int(sizeof(V)) / 4;
  static constexpr int kRowsInFlight =
      kLoadRegs / kRowRegs < 1 ? 1 : (kLoadRegs / kRowRegs > S ? S : kLoadRegs / kRowRegs);
};

// The coefficient-major (D, ncoef, row_pitch) rows that horner_rows reads,
// from the tap-major (D, S, ncoef) coefficients, by the CTA's threads.
template <int D, int S, typename T>
__device__ __forceinline__ void coefficient_rows(const T* coefs, int ncoef, T* cs) {
  constexpr int kPitch = nufft::row_pitch<S, T>();
  const int per_dim = kPitch * ncoef;
  for (int i = threadIdx.x; i < D * per_dim; i += blockDim.x) {
    const int d = i / per_dim, r = i - d * per_dim;
    const int q = r / kPitch, t = r - q * kPitch;
    cs[i] = t < S ? coefs[(d * S + t) * ncoef + q] : T(0);
  }
}

// The first design, for the instantiations that keep it (chunked_rows), as
// it was: its 2M y taps by horner_taps on the tap-major (2, S, ncoef)
// coefficients or from wtaps, the x loop rolled with one x tap a step, each
// row's 2M cells read with periodic wrap.  Its own __launch_bounds__ (no
// minimum of CTAs): with a minimum of one, ptxas gave it up to 24 more
// registers and it ran up to 1.5x slower.
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kThreads) interp_2d_point_kernel(
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

// This design: both dims' taps first, whole-chunk rows issued kBatch at a
// time.  TAPS: the window's taps come in wtaps (window_weights.cu), else by
// Horner's rule (two instantiations, so that the Horner one keeps the
// registers it needs alone).  chunked: the grid's rows are whole 16-byte
// chunks from a 16-byte aligned base (the launcher's test).
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kThreads, min_ctas(sizeof(T), M)) interp_2d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ grid, const int* __restrict__ cells,
    const T* __restrict__ fracs, const long long* __restrict__ perm,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    nufft::Value<T, NCOMP>* __restrict__ out, long long np, int nchan, int ncoef, int n0,
    int n1, bool chunked, double normfactor) {
  using V = nufft::Value<T, NCOMP>;
  constexpr int S = 2 * M, kPitch = nufft::row_pitch<S, T>();
  using G = RowGeometry<V, S>;
  constexpr int kPer = G::kPer, kChunks = G::kChunks, kWidth = G::kWidth;
  constexpr int kBatch = G::kRowsInFlight;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // (2, ncoef, kPitch)
  if constexpr (!TAPS) coefficient_rows<2, S>(coefs, ncoef, cs);
  __syncthreads();

  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= np) return;

  T wx[S], wy[S];
  if constexpr (TAPS) {
#pragma unroll
    for (int t = 0; t < S; ++t) {
      wx[t] = wtaps[t * np + j];
      wy[t] = wtaps[(S + t) * np + j];
    }
  } else {
    nufft::horner_rows<S>(cs, ncoef, fracs[j], wx);
    nufft::horner_rows<S>(cs + kPitch * ncoef, ncoef, fracs[np + j], wy);
  }
  const int cx = cells[j] - (M - 1);
  const int cy = cells[np + j] - (M - 1);
  const long long dest = perm[j];
  const long long area = (long long)n0 * n1;
  const T nf = T(normfactor);

  // The row window starts at the chunk that holds cell cy: `shift` cells
  // before it, whose taps (and those past the window) are zero.
  const int shift = cy >= 0 ? cy % kPer : 0;
  const int y0 = cy - shift;
  const bool whole = chunked && cy >= 0 && y0 + kWidth <= n1;

  if (whole) {
    T ws[kWidth];
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      T w = T(0);
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        if (k - q >= 0 && k - q < S) w = shift == q ? wy[k - q] : w;
      ws[k] = w;
    }
    for (int c = 0; c < nchan; ++c) {
      const V* g = grid + c * area;
      T acc[NCOMP] = {};
#pragma unroll
      for (int a0 = 0; a0 < S; a0 += kBatch) {
        Chunk<V, kPer> ch[kBatch][kChunks];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (a0 + b < S) {
            const Chunk<V, kPer>* row = reinterpret_cast<const Chunk<V, kPer>*>(
                g + (nufft::wrap_index(cx + a0 + b, n0) * n1 + y0));
#pragma unroll
            for (int q = 0; q < kChunks; ++q) ch[b][q] = row[q];
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (a0 + b < S) {
            T r[NCOMP] = {};
#pragma unroll
            for (int k = 0; k < kWidth; ++k) {
#pragma unroll
              for (int e = 0; e < NCOMP; ++e)
                r[e] = nufft::fma_t(ch[b][k / kPer].v[k % kPer].c[e], ws[k], r[e]);
            }
#pragma unroll
            for (int e = 0; e < NCOMP; ++e) acc[e] = nufft::fma_t(r[e], wx[a0 + b], acc[e]);
          }
        }
      }
      V res;
#pragma unroll
      for (int e = 0; e < NCOMP; ++e) res.c[e] = acc[e] * nf;
      out[c * np + dest] = res;
    }
  } else {
    int iy[S];
#pragma unroll
    for (int t = 0; t < S; ++t) iy[t] = nufft::wrap_index(cy + t, n1);
    for (int c = 0; c < nchan; ++c) {
      const V* g = grid + c * area;
      T acc[NCOMP] = {};
#pragma unroll
      for (int a = 0; a < S; ++a) {
        const V* row = g + nufft::wrap_index(cx + a, n0) * n1;
        T r[NCOMP] = {};
#pragma unroll
        for (int b = 0; b < S; ++b) {
          const V val = row[iy[b]];
#pragma unroll
          for (int e = 0; e < NCOMP; ++e) r[e] = nufft::fma_t(val.c[e], wy[b], r[e]);
        }
#pragma unroll
        for (int e = 0; e < NCOMP; ++e) acc[e] = nufft::fma_t(r[e], wx[a], acc[e]);
      }
      V res;
#pragma unroll
      for (int e = 0; e < NCOMP; ++e) res.c[e] = acc[e] * nf;
      out[c * np + dest] = res;
    }
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* grid, const void* cells, const void* fracs, const void* perm,
                   const void* coefs, const void* wtaps, void* out, long long np, int nchan,
                   int ncoef, int n0, int n1, double normfactor, cudaStream_t stream) {
  using V = nufft::Value<T, NCOMP>;
  if ((long long)n0 * n1 > INT_MAX) return cudaErrorInvalidValue;
  const unsigned nblocks = (unsigned)((np + kThreads - 1) / kThreads);
  const auto* g = static_cast<const V*>(grid);
  const auto* c = static_cast<const int*>(cells);
  const auto* f = static_cast<const T*>(fracs);
  const auto* p = static_cast<const long long*>(perm);
  const auto* cf = static_cast<const T*>(coefs);
  const auto* w = static_cast<const T*>(wtaps);
  auto* o = static_cast<V*>(out);
  if constexpr (chunked_rows(sizeof(T), NCOMP, M)) {
    constexpr int kPer = RowGeometry<V, 2 * M>::kPer;
    const bool chunked = reinterpret_cast<uintptr_t>(grid) % 16 == 0 && n1 % kPer == 0;
    const size_t smem = sizeof(T) * 2 * (size_t)nufft::row_pitch<2 * M, T>() * ncoef;
    auto kernel = wtaps ? interp_2d_kernel<M, T, NCOMP, true> : interp_2d_kernel<M, T, NCOMP, false>;
    kernel<<<nblocks, kThreads, smem, stream>>>(g, c, f, p, cf, w, o, np, nchan, ncoef, n0, n1,
                                                chunked, normfactor);
  } else {
    const size_t smem = sizeof(T) * 2 * 2 * M * (size_t)ncoef;
    auto kernel = wtaps ? interp_2d_point_kernel<M, T, NCOMP, true>
                        : interp_2d_point_kernel<M, T, NCOMP, false>;
    kernel<<<nblocks, kThreads, smem, stream>>>(g, c, f, p, cf, w, o, np, nchan, ncoef, n0, n1,
                                                normfactor);
  }
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* grid, const void* cells, const void* fracs, const void* perm,
             const void* coefs, const void* wtaps, void* out, long long np, int nchan, int m,
             int ncoef, int n0, int n1, double normfactor, void* stream) {
  if (np == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_INTERP_CASE(MM)                                                         \
  case MM:                                                                            \
    return (int)launch<MM, T, NCOMP>(grid, cells, fracs, perm, coefs, wtaps, out, np, \
                                     nchan, ncoef, n0, n1, normfactor, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_INTERP_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_INTERP_CASE
}

}  // namespace

// grid (nchan, n0, n1) values (complex: re, im interleaved), fewer than 2^31
// cells a transform; cells (2, np) int32 and fracs (2, np) T in bin-sorted
// order; perm (np,) int64, the original index of each sorted point; coefs
// (2, 2m, ncoef) T, or ncoef = 0 and no coefficients for a window other
// than kHorner, whose taps come in wtaps (2, 2m, np) T (window_weights.cu),
// null for kHorner; out (nchan, np) values in original point order.  T is
// float for *_f32, double for *_f64; normfactor is a double for both.
// Launches on `stream`, does not synchronise, allocates nothing.
#define NUFFT_INTERP_ENTRY(NAME, T, NCOMP)                                               \
  extern "C" int NAME(const void* grid, const void* cells, const void* fracs,            \
                      const void* perm, const void* coefs, const void* wtaps, void* out, \
                      long long np, int nchan, int m, int ncoef, int n0, int n1,         \
                      double normfactor, void* stream) {                                 \
    return dispatch<T, NCOMP>(grid, cells, fracs, perm, coefs, wtaps, out, np, nchan, m, \
                              ncoef, n0, n1, normfactor, stream);                        \
  }

#if NUFFT_WANT(0)
NUFFT_INTERP_ENTRY(nufft_interp_2d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_INTERP_ENTRY(nufft_interp_2d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_INTERP_ENTRY(nufft_interp_2d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_INTERP_ENTRY(nufft_interp_2d_real_f64, double, 1)
#endif
