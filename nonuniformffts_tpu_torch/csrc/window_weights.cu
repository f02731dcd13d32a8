// K3: the window taps of every sorted point, for every window that the
// spread and interpolation kernels do not evaluate by Horner's rule:
//
//   nufft_window_weights_f32   float taps (complex64, float32 plans)
//   nufft_window_weights_f64   double taps (complex128, float64 plans)
//
// Replaces nonuniformffts_tpu/ops/pallas/common.py:window_weights and
// window_weights_ds, which the TPU kernels (_spread_kernel, _interp_kernel,
// _spread_kernel_z, _interp_kernel_z and their double-single forms) call on
// each point batch in their bodies: KB and BKB in Direct mode, the Gaussian
// (one exp per node in both modes) and the B-spline (de Boor, both modes).
// Here the taps depend only on the points, so set_points launches this
// kernel once (ops/kernels/blocked.py:window_taps) and the plan keeps its
// table, (D, 2M, np) tap-major, for every exec's spread and interpolation
// kernels to read: their thread-per-point reads of one tap are consecutive
// across a warp, and the 2D/3D spread's warps, which take neighbouring
// points together, share each tap row's lines.  Evaluating the taps inside
// those kernels instead cost their Horner path (the main path's) 14-62 more
// registers and tripled the build (window.cuh).
//
// - One thread per (dimension, V consecutive points), V = 16 bytes of T
//   (4 floats, 2 doubles) for M <= kUnrollM when the point count allows
//   whole 16-byte vectors, else 1: it loads its V fractions at once and,
//   for each tap (in an unrolled loop up to kUnrollM), evaluates the tap of
//   its V points (V independent chains) and writes them with one store,
//   coalesced across the warp.  The B-spline's de Boor recurrence yields all
//   2M taps of a point at once, in registers.  The window's kind is a
//   template parameter, so that each instantiation holds one kind's taps.
// - The vectors are what gains: at M = 4 in float, 16.8M points in 3D, KB
//   and BKB Direct ran 1.17x and 1.26x faster than a point a thread with
//   the same unrolled taps, which ran no faster than with rolled ones
//   (PERF.md); in double and for the
//   store-bound Gaussian and B-spline all three ran within 3%.
//
// What bounds it on the H100 (chip_probe.py --weights): the writes, np D 2M
// scalars, for the Gaussian and the B-spline, whose stores alone run at
// 1.2-1.3x the byte bound (16-byte stores did not move that); the I0 or exp
// evaluations for KB and BKB (the SFU and, in double, the FP64 pipe), which
// take 1.4-3x the time of the stores alone.  There is no TF32.
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;
// Up to this M a thread takes a 16-byte vector of points and unrolls the
// taps; past it one point and a rolled loop over the taps, as the first
// design: at M = 10 the unrolled taps ran 0.68-0.90x its time (KB, BKB in
// float; KB in double) and the vector B-spline 0.75-0.81x (chip_probe.py
// --weights).
constexpr int kUnrollM = 4;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T c[V];
};

// Tap t of fraction X of dimension d under window KIND (any but kHorner
// and kBSpline).
template <int KIND, int M, typename T>
__device__ __forceinline__ T direct_tap(const nufft::WindowParams& win, int d, int t, T X) {
  if constexpr (KIND == nufft::kKBDirect) {
    return nufft::kb_direct_tap(T(win.beta[d]), T(win.inv_peak[d]), M, t, X);
  } else if constexpr (KIND == nufft::kBKBDirect) {
    return nufft::bkb_direct_tap(T(win.beta[d]), T(win.pref[d]), T(win.exp_mbeta[d]), M, t,
                                 X);
  } else {
    return nufft::gaussian_tap(T(win.dx[d]), T(win.inv_tau[d]), M, t, X);
  }
}

// KIND: the window (WindowParams::kind, any but kHorner), one instantiation
// each, so that each holds only its own unrolled taps.
template <int KIND, int M, typename T, int V>
__global__ void __launch_bounds__(kThreads) window_weights_kernel(
    const T* __restrict__ fracs, const nufft::WindowParams win, T* __restrict__ out,
    long long np, int ndim) {
  constexpr int S = 2 * M;
  const long long groups = np / V;  // np % V == 0 (the launch's choice of V)
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups * ndim) return;
  const int d = (int)(i / groups);
  const long long j = (i - d * groups) * V;
  // fracs (ndim, np): entry d * np + j; tap t of the V points at
  // out[(d * S + t) * np + j ..], a vector `groups` vectors after tap t - 1.
  const Vec<T, V> X = *reinterpret_cast<const Vec<T, V>*>(fracs + d * np + j);
  Vec<T, V>* o = reinterpret_cast<Vec<T, V>*>(out + d * S * np + j);
  if constexpr (KIND == nufft::kBSpline) {
    T b[V][S];
#pragma unroll
    for (int v = 0; v < V; ++v) nufft::bspline_taps<S>(X.c[v], b[v]);
#pragma unroll
    for (int t = 0; t < S; ++t) {
      Vec<T, V> w;
#pragma unroll
      for (int v = 0; v < V; ++v) w.c[v] = b[v][t];
      o[t * groups] = w;
    }
  } else if constexpr (M <= kUnrollM) {
#pragma unroll
    for (int t = 0; t < S; ++t) {
      Vec<T, V> w;
#pragma unroll
      for (int v = 0; v < V; ++v) w.c[v] = direct_tap<KIND, M, T>(win, d, t, X.c[v]);
      o[t * groups] = w;
    }
  } else {
#pragma unroll 1
    for (int t = 0; t < S; ++t) {
      Vec<T, V> w;
#pragma unroll
      for (int v = 0; v < V; ++v) w.c[v] = direct_tap<KIND, M, T>(win, d, t, X.c[v]);
      o[t * groups] = w;
    }
  }
}

template <int KIND, int M, typename T>
cudaError_t launch_kind(const void* fracs, const nufft::WindowParams& win, void* out,
                        long long np, int ndim, cudaStream_t stream) {
  constexpr int kVec = M <= kUnrollM ? 16 / int(sizeof(T)) : 1;
  const bool vec = kVec > 1 && np % kVec == 0 && (reinterpret_cast<uintptr_t>(fracs) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long threads = ndim * (vec ? np / kVec : np);
  const unsigned nblocks = (unsigned)((threads + kThreads - 1) / kThreads);
  auto kernel = vec ? window_weights_kernel<KIND, M, T, kVec>
                    : window_weights_kernel<KIND, M, T, 1>;
  kernel<<<nblocks, kThreads, 0, stream>>>(static_cast<const T*>(fracs), win,
                                           static_cast<T*>(out), np, ndim);
  return cudaGetLastError();
}

template <int M, typename T>
cudaError_t launch(const void* fracs, const nufft::WindowParams& win, void* out,
                   long long np, int ndim, cudaStream_t stream) {
  switch (win.kind) {
    case nufft::kKBDirect:
      return launch_kind<nufft::kKBDirect, M, T>(fracs, win, out, np, ndim, stream);
    case nufft::kBKBDirect:
      return launch_kind<nufft::kBKBDirect, M, T>(fracs, win, out, np, ndim, stream);
    case nufft::kGaussian:
      return launch_kind<nufft::kGaussian, M, T>(fracs, win, out, np, ndim, stream);
    case nufft::kBSpline:
      return launch_kind<nufft::kBSpline, M, T>(fracs, win, out, np, ndim, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
