// Window-tap evaluation shared by the spread and interpolation kernels.
//
// Port of nonuniformffts_tpu/ops/pallas/common.py:window_weights for the
// (backwards) Kaiser-Bessel FastApproximation mode: each of the 2M taps of
// one dimension is a polynomial in z = 2X - 1 (X the in-cell fraction),
// evaluated by Horner's rule in FP32 FMAs.  Tap t is the weight of grid node
// c - M + 1 + t.  The coefficients come tap-major, (2M, ncoef) per dimension
// (ops/kernels/common.py:coefficient_stack), so one tap reads ncoef
// consecutive floats.
#pragma once

#include <cuda_runtime.h>

namespace nufft {

__device__ __forceinline__ float horner_tap(const float* cs_t, int ncoef,
                                            float z) {
  float v = cs_t[ncoef - 1];
  for (int q = ncoef - 2; q >= 0; --q) v = fmaf(v, z, cs_t[q]);
  return v;
}

// All 2M taps of one dimension; cs points at that dimension's (2M, ncoef)
// coefficients.
template <int S>
__device__ __forceinline__ void window_taps(const float* cs, int ncoef,
                                            float X, float (&w)[S]) {
  const float z = 2.f * X - 1.f;
#pragma unroll
  for (int t = 0; t < S; ++t) w[t] = horner_tap(cs + t * ncoef, ncoef, z);
}

// Periodic wrap of an index in [-n, 2n); the plan guarantees 2M <= n.
__device__ __forceinline__ int wrap_index(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

}  // namespace nufft
