// Window-tap evaluation and value access shared by the spread and
// interpolation kernels.
//
// Port of nonuniformffts_tpu/ops/pallas/common.py:window_weights for the
// (backwards) Kaiser-Bessel FastApproximation mode: each of the 2M taps of
// one dimension is a polynomial in z = 2X - 1 (X the in-cell fraction),
// evaluated by Horner's rule in FMAs of the kernel's scalar type T (float
// or double).  Tap t is the weight of grid node c - M + 1 + t.  The
// coefficients come tap-major, (2M, ncoef) per dimension
// (ops/kernels/common.py:coefficient_stack), so one tap reads ncoef
// consecutive scalars.
#pragma once

#include <cuda_runtime.h>

namespace nufft {

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__device__ __forceinline__ T horner_tap(const T* cs_t, int ncoef, T z) {
  T v = cs_t[ncoef - 1];
  for (int q = ncoef - 2; q >= 0; --q) v = fma_t(v, z, cs_t[q]);
  return v;
}

// All 2M taps of one dimension; cs points at that dimension's (2M, ncoef)
// coefficients.
template <int S, typename T>
__device__ __forceinline__ void window_taps(const T* cs, int ncoef, T X,
                                            T (&w)[S]) {
  const T z = T(2) * X - T(1);
#pragma unroll
  for (int t = 0; t < S; ++t) w[t] = horner_tap(cs + t * ncoef, ncoef, z);
}

// One non-uniform value or grid cell: NCOMP scalars of T (re, im for complex
// values; one for real values), aligned so that it moves in one load.
template <typename T, int NCOMP>
struct alignas(sizeof(T) * NCOMP) Value {
  T c[NCOMP];
};

// Periodic wrap of an index in [-n, 2n); the plan guarantees 2M <= n.
__device__ __forceinline__ int wrap_index(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

}  // namespace nufft

// Defines `extern "C" int NAME(ARGS)` for a kernel entry point only when
// the translation unit is built for all value types or for this one
// (ops/kernels/build.py compiles each source once per value type, in
// parallel, with -DNUFFT_ONLY=<index>).
#ifdef NUFFT_ONLY
#define NUFFT_WANT(IDX) (NUFFT_ONLY == (IDX))
#else
#define NUFFT_WANT(IDX) 1
#endif
