// K2 and K6b: type-2 interpolation from the 3D oversampled grid at the
// non-uniform points, one kernel template over the value type:
//
//   nufft_interp_3d_f32       complex64   (K2)
//   nufft_interp_3d_f64       complex128  (K6b)
//   nufft_interp_3d_real_f32  float32     (K2, real rows)
//   nufft_interp_3d_real_f64  float64     (K6b, real rows)
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_interp_kernel_z (the
// Pallas kernel launched by interpolate_blocked) and
// nonuniformffts_tpu/ops/pallas/blocked_ds.py:_interp_kernel_ds (launched by
// interpolate_blocked_ds).  On the TPU each program read a halo-gathered
// padded block, contracted it with dense weight matrices on the MXU (in
// (hi, lo) float32 pairs with int8 limb cascades for the ds kernel, with
// normfactor as a ds pair), wrote per-slot results plus a key row, and a
// masked sort put the results back in input order because the TPU cannot
// scatter.  Here:
//
// - One thread per bin-sorted point.  Neighbouring threads hold points of
//   the same block, so their windows overlap and the gathers share L1/L2
//   lines.
// - The thread evaluates its 2M y and z taps (Horner in T, window.cuh, or
//   reads them from the window-weights kernel's output for the other
//   windows) and the wrapped y and z node indices into registers; the x loop
//   stays rolled and takes one x tap per step, so no tap array is indexed
//   at run time.  It gathers the (2M)^3 window of each transform from the
//   global grid with periodic wrap, accumulates in T FMAs and multiplies by
//   normfactor, passed as a double so that FP64 plans keep every bit.
// - It writes out[c, perm[j]] directly: the un-permute is a scatter, with
//   no key row and no sort.
//
// What bounds it on the H100: the gather, (2M)^3 reads of NCOMP scalars per
// point (4 KB at M = 4 for complex64, 8 KB for complex128) served from
// L1/L2, not arithmetic.  This first version relies on the caches and the
// sorted order for reuse; staging each block in shared memory is the next
// step.
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;

// TAPS: the window's taps come in wtaps (window_weights.cu), else by
// Horner's rule.  The two instantiations keep the Horner one's registers at
// what it needs alone: one kernel for both took 172 registers at M = 4 in
// 3D double, against 128, and halved the resident CTAs.
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kThreads) interp_3d_kernel(
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
  auto kernel = wtaps ? interp_3d_kernel<M, T, NCOMP, true>
                      : interp_3d_kernel<M, T, NCOMP, false>;
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
NUFFT_INTERP_ENTRY(nufft_interp_3d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_INTERP_ENTRY(nufft_interp_3d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_INTERP_ENTRY(nufft_interp_3d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_INTERP_ENTRY(nufft_interp_3d_real_f64, double, 1)
#endif
