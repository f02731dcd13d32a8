// K3: the window taps of every sorted point, for every window that the
// spread and interpolation kernels do not evaluate by Horner's rule:
//
//   nufft_window_weights_f32   float taps (complex64, float32 plans)
//   nufft_window_weights_f64   double taps (complex128, float64 plans)
//
// Replaces nonuniformffts_tpu/ops/pallas/common.py:window_weights, which
// the TPU kernels (_spread_kernel, _interp_kernel, _spread_kernel_z,
// _interp_kernel_z) call on each point batch in their bodies: KB and BKB in
// Direct mode, the Gaussian (one exp per node in both modes) and the
// B-spline (de Boor, both modes).  Here the taps are a kernel of their own,
// launched by the spread and interpolation wrappers before their kernel
// (ops/kernels/blocked.py), and written once to device memory tap-major,
// (D, 2M, np): the interpolation kernels' thread-per-point reads of one tap
// are then consecutive across a warp (PERF.md: with (np, D, 2M) the 2D
// interpolation took 2.5-2.9x its Horner time), and the 2D/3D spread's warps,
// which take neighbouring points together, share each tap row's lines.
// Evaluating them inside the spread and interpolation kernels instead cost
// their Horner path (the main path's) 14-62 more registers and tripled the
// build (window.cuh).
//
// - One thread per (dimension, point), the points of a dimension
//   consecutive: it reads the fraction, evaluates the 2M taps (window.cuh:
//   direct taps one at a time in a rolled loop, the B-spline's all at once
//   in registers) and writes them, each write coalesced across the warp.
//
// What bounds it on the H100: the writes, np D 2M scalars, and at m = 10 in
// float64 the I0 and exp evaluations.  There is no TF32.
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
NUFFT_WEIGHTS_ENTRY(nufft_window_weights_f32, float)
#endif
#if NUFFT_WANT(1)
NUFFT_WEIGHTS_ENTRY(nufft_window_weights_f64, double)
#endif
