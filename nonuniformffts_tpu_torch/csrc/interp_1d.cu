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
// weight matrix on the MXU, and a masked sort restored input order.  Here:
//
// - One thread per bin-sorted point: its 2M taps (Horner in T, window.cuh,
//   or read from the window-weights kernel's output for the other windows)
//   and wrapped indices live in registers, and it reads the 2M cells of
//   each transform from the grid with periodic wrap (no halo copy);
//   neighbouring threads read overlapping, mostly identical lines.
// - It accumulates in T FMAs, multiplies by normfactor (a double argument)
//   and writes out[c, perm[j]] directly: no key row, no sort.
//
// What bounds it on the H100: the point state and the scattered output
// write, plus 2M cached reads of NCOMP scalars per point.  There are no
// atomics.
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
