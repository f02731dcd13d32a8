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
// order.  Here, as in K2 (interp_3d.cu):
//
// - One thread per bin-sorted point; neighbouring threads hold points of the
//   same block, so their windows share L1/L2 lines.  There is no halo copy:
//   the thread reads the grid with periodic wrap.
// - The thread evaluates its 2M y taps (Horner in T, window.cuh, or reads
//   them from the window-weights kernel's output for the other windows) and
//   wrapped y indices into registers; the x loop stays rolled and takes one
//   x tap per step.  It gathers the
//   (2M)^2 window of each transform, accumulates in T FMAs and multiplies by
//   normfactor, passed as a double so that FP64 plans keep every bit.
// - It writes out[c, perm[j]] directly: no key row, no sort.
//
// What bounds it on the H100: the gathers, (2M)^2 reads of NCOMP scalars per
// point served from L1/L2.  There are no atomics.
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
