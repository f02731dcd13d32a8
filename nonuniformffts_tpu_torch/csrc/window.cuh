// Window-tap evaluation and value access shared by the spread and
// interpolation kernels and by the window-weights kernel.
//
// Port of nonuniformffts_tpu/ops/pallas/common.py:window_weights, all four
// windows in both evaluation modes.  Tap t of a dimension is the weight of
// grid node c - M + 1 + t for in-cell fraction X in [0, 1).  The window is
// fixed per launch (WindowParams::kind, the same in every dimension):
//
// - kHorner, (backwards) Kaiser-Bessel FastApproximation: each tap is a
//   polynomial in z = 2X - 1 (Horner's rule, FMAs in T) on tap-major
//   coefficients, (2M, ncoef) per dimension
//   (ops/kernels/common.py:coefficient_stack), so one tap reads ncoef
//   consecutive scalars.  The spread and interpolation kernels evaluate
//   these taps themselves.
// - kKBDirect: y = (M - 1 - t + X) / M, I0(beta sqrt(1 - y^2)) / peak, with
//   the CUDA math library's I0 (the TPU kernel's besseli0_poly is a Mosaic
//   workaround).
// - kBKBDirect: sinh(beta s) e^-beta / (beta s) * pref with shifted
//   exponents, so every intermediate stays <= 1 (the raw sinh overflows
//   float32 from M = 6 on), and e^-beta at beta s == 0.
// - kGaussian (both modes, as the TPU kernel): exp(-y^2 / tau) with
//   y = (M - 1 - t + X) dx, one exp per node.
// - kBSpline (both modes): de Boor's recurrence of order 2M at 1 - X, which
//   yields all 2M taps at once; list entry t is tap t.
//
// The last four run in window_weights.cu, which writes every sorted point's
// taps, (D, 2M, np), for the spread and interpolation kernels to read
// (their `wtaps` argument).  Inside those kernels they cost the Horner path
// 14-62 registers (I0 and exp in double, de Boor's 2M live values) and the
// build 24 -> 67-107 s: every unrolled tap held a copy.
//
// The scalars come in T: each of WindowParams' doubles is rounded to T, as
// the JAX kernel rounds its Python floats.  expf / exp, sqrtf / sqrt and
// cyl_bessel_i0f / cyl_bessel_i0 are the accurate library functions: the
// build uses no fast-math flag.
#pragma once

#include <cuda_runtime.h>

namespace nufft {

// Must match ops/windows.py:WINDOW_KINDS.
enum WindowKind : int {
  kHorner = 0,
  kKBDirect = 1,
  kBKBDirect = 2,
  kGaussian = 3,
  kBSpline = 4,
};

// The per-dimension scalars of the plan's window (ops/windows.py:
// window_pack), passed to window_weights.cu by value.  Must match
// ops/kernels/build.py:WindowParams.
struct WindowParams {
  int kind;
  double beta[3];
  double inv_peak[3];
  double pref[3];       // BKB: beta / (-expm1(-2 beta) / 2)
  double exp_mbeta[3];  // BKB: e^-beta, the beta s == 0 limit
  double inv_tau[3];    // Gaussian: 1 / tau
  double dx[3];         // Gaussian: grid step 2 pi / n
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float i0_t(float x) { return cyl_bessel_i0f(x); }
__device__ __forceinline__ double i0_t(double x) { return cyl_bessel_i0(x); }

template <typename T>
__device__ __forceinline__ T horner_tap(const T* cs_t, int ncoef, T z) {
  T v = cs_t[ncoef - 1];
  for (int q = ncoef - 2; q >= 0; --q) v = fma_t(v, z, cs_t[q]);
  return v;
}

// sqrt(1 - y^2) for y = (M - 1 - t + X) / M, clamped at 0.
template <typename T>
__device__ __forceinline__ T kb_arg(int M, int t, T X) {
  const T y = (T(M - 1 - t) + X) / T(M);
  const T u = T(1) - y * y;
  return sqrt_t(u > T(0) ? u : T(0));
}

template <typename T>
__device__ __forceinline__ T kb_direct_tap(T beta, T inv_peak, int M, int t, T X) {
  return i0_t(beta * kb_arg(M, t, X)) * inv_peak;
}

template <typename T>
__device__ __forceinline__ T bkb_direct_tap(T beta, T pref, T exp_mbeta, int M,
                                            int t, T X) {
  const T bs = beta * kb_arg(M, t, X);
  const T sinh_s = T(0.5) * (exp_t(bs - beta) - exp_t(-bs - beta));
  const T ratio = bs == T(0) ? exp_mbeta : sinh_s / bs;
  return ratio * pref;
}

template <typename T>
__device__ __forceinline__ T gaussian_tap(T dx, T inv_tau, int M, int t, T X) {
  const T y = (T(M - 1 - t) + X) * dx;
  return exp_t(-(y * y) * inv_tau);
}

// The S = 2M B-spline taps of order S at 1 - X by de Boor's recurrence
// (ops/windows.py:bspline_values_list), updated in place from the top.
template <int S, typename T>
__device__ __forceinline__ void bspline_taps(T X, T (&b)[S]) {
  const T xp = T(1) - X;
  b[0] = T(1);
#pragma unroll
  for (int q = 2; q <= S; ++q) {
    const T alpha = T(1.0 / (q - 1));
    b[q - 1] = (T(1) - (xp + T(q - 2)) * alpha) * b[q - 2];
#pragma unroll
    for (int j = q - 2; j >= 1; --j)
      b[j] = (T(1) - (xp + T(j - 1)) * alpha) * b[j - 1] + (xp + T(j)) * alpha * b[j];
    b[0] = xp * alpha * b[0];
  }
}

// All S = 2M Horner taps of one dimension; cs points at that dimension's
// (2M, ncoef) coefficients.
template <int S, typename T>
__device__ __forceinline__ void horner_taps(const T* cs, int ncoef, T X,
                                            T (&out)[S]) {
  const T z = T(2) * X - T(1);
#pragma unroll
  for (int t = 0; t < S; ++t) out[t] = horner_tap(cs + t * ncoef, ncoef, z);
}

// All S taps of dimension d of sorted point j into out: read from wtaps
// ((D, S, np), window_weights.cu) when the window has them there, else by
// Horner's rule on cs (that dimension's (S, ncoef) coefficients).
template <int S, typename T>
__device__ __forceinline__ void point_taps(const T* wtaps, const T* cs,
                                           int ncoef, const T* fracs,
                                           long long np, long long j, int d,
                                           T (&out)[S]) {
  if (wtaps) {
    const T* src = wtaps + d * S * np + j;
#pragma unroll
    for (int t = 0; t < S; ++t) out[t] = src[t * np];
  } else {
    horner_taps<S>(cs, ncoef, fracs[d * np + j], out);
  }
}

// Tap t of dimension d of sorted point j, of fraction X, as point_taps;
// cs_t: tap t's ncoef coefficients.
template <int S, typename T>
__device__ __forceinline__ T point_tap(const T* wtaps, const T* cs_t, int ncoef,
                                       T X, long long np, long long j, int d,
                                       int t) {
  if (wtaps) return wtaps[(d * S + t) * np + j];
  return horner_tap(cs_t, ncoef, T(2) * X - T(1));
}

// The D x S taps of sorted point j into one warp's scratch taps[d * S + t]
// (the 2D and 3D spread kernels): lane q takes tap q of the flattened
// (D, S) set.  cs: (D, S, ncoef) coefficients.
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

// The half-supports M every kernel is instantiated for
// (ops/kernels/common.py:KERNEL_M_RANGE): a switch over m that calls
// CASE(M) for each.
#define NUFFT_FOR_EACH_M(CASE) \
  CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)

// Defines `extern "C" int NAME(ARGS)` for a kernel entry point only when
// the translation unit is built for all value types or for this one
// (ops/kernels/build.py compiles each source once per value type, in
// parallel, with -DNUFFT_ONLY=<index>).
#ifdef NUFFT_ONLY
#define NUFFT_WANT(IDX) (NUFFT_ONLY == (IDX))
#else
#define NUFFT_WANT(IDX) 1
#endif
