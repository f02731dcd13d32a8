// K2, nufft_interp_3d_f32: type-2 interpolation of complex64 values from
// the 3D oversampled grid at the non-uniform points.
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_interp_kernel_z (the
// Pallas kernel launched by interpolate_blocked).  On the TPU each program
// read a halo-gathered padded block, contracted it with dense weight
// matrices on the MXU, wrote per-slot results plus a key row, and a masked
// sort put the results back in input order because the TPU cannot scatter.
// Here:
//
// - One thread per bin-sorted point.  Neighbouring threads hold points of
//   the same block, so their windows overlap and the gathers share L1/L2
//   lines.
// - The thread evaluates its 3 x 2M taps (Horner, window.cuh) and the
//   wrapped node indices into registers, gathers the (2M)^3 window of each
//   transform from the global grid with periodic wrap, accumulates in FP32
//   FMAs and multiplies by normfactor.
// - It writes out[c, perm[j]] directly: the un-permute is a scatter, with
//   no key row and no sort.
//
// What bounds it on the H100: the gather, (2M)^3 8-byte reads per point
// (4 KB at M = 4) served from L1/L2, not arithmetic.  This first version
// relies on the caches and the sorted order for reuse; staging each block in
// shared memory is the next step.
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;

template <int M>
__global__ void __launch_bounds__(kThreads) interp_3d_f32_kernel(
    const float2* __restrict__ grid, const int* __restrict__ cells,
    const float* __restrict__ fracs, const long long* __restrict__ perm,
    const float* __restrict__ coefs, float2* __restrict__ out, long long np,
    int nchan, int ncoef, int n0, int n1, int n2, float normfactor) {
  constexpr int S = 2 * M;
  extern __shared__ float cs[];  // (3, S, ncoef)
  for (int i = threadIdx.x; i < 3 * S * ncoef; i += blockDim.x)
    cs[i] = coefs[i];
  __syncthreads();

  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= np) return;

  float wx[S], wy[S], wz[S];
  int ix[S], iy[S], iz[S];
  nufft::window_taps<S>(cs, ncoef, fracs[j], wx);
  nufft::window_taps<S>(cs + S * ncoef, ncoef, fracs[np + j], wy);
  nufft::window_taps<S>(cs + 2 * S * ncoef, ncoef, fracs[2 * np + j], wz);
  const int cx = cells[j] - (M - 1);
  const int cy = cells[np + j] - (M - 1);
  const int cz = cells[2 * np + j] - (M - 1);
#pragma unroll
  for (int t = 0; t < S; ++t) {
    ix[t] = nufft::wrap_index(cx + t, n0);
    iy[t] = nufft::wrap_index(cy + t, n1);
    iz[t] = nufft::wrap_index(cz + t, n2);
  }
  const long long dest = perm[j];
  const long long volume = (long long)n0 * n1 * n2;

  for (int c = 0; c < nchan; ++c) {
    const float2* g = grid + c * volume;
    float ar = 0.f, ai = 0.f;
    // The x loop stays rolled: unrolling all (2M)^3 taps spills registers
    // from M = 6 on and takes minutes to compile at M = 8.
#pragma unroll 1
    for (int a = 0; a < S; ++a) {
#pragma unroll
      for (int b = 0; b < S; ++b) {
        const float2* row = g + ((long long)ix[a] * n1 + iy[b]) * n2;
        float rr = 0.f, ri = 0.f;
#pragma unroll
        for (int e = 0; e < S; ++e) {
          const float2 val = __ldg(row + iz[e]);
          rr = fmaf(val.x, wz[e], rr);
          ri = fmaf(val.y, wz[e], ri);
        }
        const float wxy = wx[a] * wy[b];
        ar = fmaf(rr, wxy, ar);
        ai = fmaf(ri, wxy, ai);
      }
    }
    out[c * np + dest] = make_float2(ar * normfactor, ai * normfactor);
  }
}

template <int M>
cudaError_t launch(const void* grid, const void* cells, const void* fracs,
                   const void* perm, const void* coefs, void* out,
                   long long np, int nchan, int ncoef, int n0, int n1, int n2,
                   float normfactor, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * 2 * M * ncoef;
  const long long nblocks = (np + kThreads - 1) / kThreads;
  interp_3d_f32_kernel<M><<<(unsigned)nblocks, kThreads, smem, stream>>>(
      static_cast<const float2*>(grid), static_cast<const int*>(cells),
      static_cast<const float*>(fracs), static_cast<const long long*>(perm),
      static_cast<const float*>(coefs), static_cast<float2*>(out), np, nchan,
      ncoef, n0, n1, n2, normfactor);
  return cudaGetLastError();
}

}  // namespace

// grid (nchan, n0, n1, n2) complex64; cells (3, np) int32 and fracs (3, np)
// float32 in bin-sorted order; perm (np,) int64, the original index of each
// sorted point; coefs (3, 2m, ncoef) float32; out (nchan, np) complex64 in
// original point order.  Launches on `stream`, does not synchronise,
// allocates nothing.
extern "C" int nufft_interp_3d_f32(const void* grid, const void* cells,
                                   const void* fracs, const void* perm,
                                   const void* coefs, void* out, long long np,
                                   int nchan, int m, int ncoef, int n0, int n1,
                                   int n2, float normfactor, void* stream) {
  if (np == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_INTERP_CASE(MM)                                                \
  case MM:                                                                   \
    return (int)launch<MM>(grid, cells, fracs, perm, coefs, out, np, nchan,  \
                           ncoef, n0, n1, n2, normfactor, s);
  switch (m) {
    NUFFT_INTERP_CASE(2)
    NUFFT_INTERP_CASE(3)
    NUFFT_INTERP_CASE(4)
    NUFFT_INTERP_CASE(5)
    NUFFT_INTERP_CASE(6)
    NUFFT_INTERP_CASE(7)
    NUFFT_INTERP_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_INTERP_CASE
}
