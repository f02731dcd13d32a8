// K1, nufft_spread_3d_f32: type-1 spreading of complex64 values onto the
// 3D oversampled grid.
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_spread_kernel_z (the
// Pallas kernel launched by spread_blocked).  On the TPU each program owned
// one spatial block, built dense per-dimension weight matrices and
// contracted them with the point batch on the MXU into a halo-first padded
// block; the halo merge lived in the DFT factors.  Here:
//
// - One CTA per (spatial block, transform).  The block's points are a
//   contiguous range of the bin-sorted arrays (pstarts).  An empty block
//   returns before touching shared memory.
// - The CTA zeroes a padded (B0+2M-1)(B1+2M-1)(B2+2M-1) accumulator in
//   dynamic shared memory, kept as two float planes (re, im) rather than
//   float2 so that the 32 lanes of a warp hit 32 consecutive banks.
// - Each warp takes one point at a time.  Its lanes evaluate the 3 x 2M taps
//   (Horner, window.cuh) into a per-warp scratch, then split the (2M)^2
//   (y, z) tap pairs among themselves and walk the 2M x taps, adding
//   v * wx * wy * wz into shared memory with atomicAdd.  Lanes of one warp
//   write distinct addresses, consecutive along z.
// - The CTA then adds its padded block, halo included, into the global grid
//   with periodic wrap and global atomicAdd.  This replaces the TPU's halo
//   merge inside the DFT factors: there is no separate fold pass.
//
// What bounds it on the H100: the shared-memory atomics, (2M)^3 complex
// adds per point (1024 float atomics at M = 4), and at low density the
// global atomics of the block flush (about 2.3x the grid at the default
// geometry).  The design keeps the per-point atomics conflict-free within a
// warp and in shared memory; the flush skips cells no point reached.
// Everything accumulates in FP32; there is no TF32 anywhere.
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 512;  // ops/kernels/common.py:SPREAD_THREADS

// Must match ops/kernels/common.py:spread_smem_bytes.
size_t spread_smem_bytes(int m, int ncoef, int b0, int b1, int b2) {
  const size_t s = 2 * m;
  const size_t pv = (size_t)(b0 + s - 1) * (b1 + s - 1) * (b2 + s - 1);
  const size_t ntaps = 3 * s;
  return 4 * (2 * pv + ntaps * ncoef + (kThreads / 32) * ntaps);
}

template <int M>
__global__ void __launch_bounds__(kThreads) spread_3d_f32_kernel(
    const float2* __restrict__ vals, const int* __restrict__ cells,
    const float* __restrict__ fracs, const int* __restrict__ pstarts,
    const float* __restrict__ coefs, float2* __restrict__ grid,
    long long np, int ncoef, int n0, int n1, int n2, int b0, int b1, int b2) {
  constexpr int S = 2 * M;
  extern __shared__ float smem[];

  const int bid = blockIdx.x;
  const int chan = blockIdx.y;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA

  const int pd1 = b1 + S - 1, pd2 = b2 + S - 1;
  const int plane = pd1 * pd2;
  const int pv = (b0 + S - 1) * plane;
  float* acc_re = smem;
  float* acc_im = acc_re + pv;
  float* cs = acc_im + pv;  // (3, S, ncoef)
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  float* taps = cs + 3 * S * ncoef + warp * 3 * S;  // this warp's (3, S)

  for (int i = tid; i < pv; i += blockDim.x) {
    acc_re[i] = 0.f;
    acc_im[i] = 0.f;
  }
  for (int i = tid; i < 3 * S * ncoef; i += blockDim.x) cs[i] = coefs[i];
  __syncthreads();

  const int nb1 = n1 / b1, nb2 = n2 / b2;
  const int ox = (bid / (nb1 * nb2)) * b0;
  const int oy = ((bid / nb2) % nb1) * b1;
  const int oz = (bid % nb2) * b2;
  const float2* vrow = vals + (long long)chan * np;

  for (long long j = p_begin + warp; j < p_end; j += nwarps) {
    for (int q = lane; q < 3 * S; q += 32) {
      const int d = q / S;
      const float z = 2.f * fracs[d * np + j] - 1.f;
      taps[q] = nufft::horner_tap(cs + q * ncoef, ncoef, z);
    }
    __syncwarp();
    const int lx = cells[j] - ox;
    const int ly = cells[np + j] - oy;
    const int lz = cells[2 * np + j] - oz;
    const float2 v = vrow[j];
    for (int q = lane; q < S * S; q += 32) {
      const int iy = q / S, iz = q - iy * S;
      const float wyz = taps[S + iy] * taps[2 * S + iz];
      const float vr = v.x * wyz, vi = v.y * wyz;
      int idx = (lx * pd1 + ly + iy) * pd2 + lz + iz;
#pragma unroll
      for (int ix = 0; ix < S; ++ix) {
        const float wx = taps[ix];
        atomicAdd(acc_re + idx, vr * wx);
        atomicAdd(acc_im + idx, vi * wx);
        idx += plane;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // Periodic global add of the padded block: padded index i along a dim is
  // grid node origin - (M - 1) + i.
  float* g = reinterpret_cast<float*>(grid + (long long)chan * n0 * n1 * n2);
  for (int i = tid; i < pv; i += blockDim.x) {
    const float re = acc_re[i], im = acc_im[i];
    if (re == 0.f && im == 0.f) continue;
    const int i0 = i / plane;
    const int r = i - i0 * plane;
    const int i1 = r / pd2;
    const int i2 = r - i1 * pd2;
    const int gx = nufft::wrap_index(ox - (M - 1) + i0, n0);
    const int gy = nufft::wrap_index(oy - (M - 1) + i1, n1);
    const int gz = nufft::wrap_index(oz - (M - 1) + i2, n2);
    const long long off = 2 * (((long long)gx * n1 + gy) * n2 + gz);
    atomicAdd(g + off, re);
    atomicAdd(g + off + 1, im);
  }
}

template <int M>
cudaError_t launch(const void* vals, const void* cells, const void* fracs,
                   const void* pstarts, const void* coefs, void* grid,
                   long long np, int nchan, int ncoef, int n0, int n1, int n2,
                   int b0, int b1, int b2, cudaStream_t stream) {
  const size_t smem = spread_smem_bytes(M, ncoef, b0, b1, b2);
  cudaError_t err = cudaFuncSetAttribute(
      spread_3d_f32_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks((n0 / b0) * (n1 / b1) * (n2 / b2), nchan);
  spread_3d_f32_kernel<M><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float2*>(vals), static_cast<const int*>(cells),
      static_cast<const float*>(fracs), static_cast<const int*>(pstarts),
      static_cast<const float*>(coefs), static_cast<float2*>(grid), np, ncoef,
      n0, n1, n2, b0, b1, b2);
  return cudaGetLastError();
}

}  // namespace

// vals (nchan, np) complex64 in bin-sorted order; cells (3, np) int32 and
// fracs (3, np) float32, sorted; pstarts (nblocks + 1,) int32; coefs
// (3, 2m, ncoef) float32; grid (nchan, n0, n1, n2) complex64, zeroed by the
// caller.  Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int nufft_spread_3d_f32(const void* vals, const void* cells,
                                   const void* fracs, const void* pstarts,
                                   const void* coefs, void* grid, long long np,
                                   int nchan, int m, int ncoef, int n0, int n1,
                                   int n2, int b0, int b1, int b2,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_SPREAD_CASE(MM)                                               \
  case MM:                                                                  \
    return (int)launch<MM>(vals, cells, fracs, pstarts, coefs, grid, np,    \
                           nchan, ncoef, n0, n1, n2, b0, b1, b2, s);
  switch (m) {
    NUFFT_SPREAD_CASE(2)
    NUFFT_SPREAD_CASE(3)
    NUFFT_SPREAD_CASE(4)
    NUFFT_SPREAD_CASE(5)
    NUFFT_SPREAD_CASE(6)
    NUFFT_SPREAD_CASE(7)
    NUFFT_SPREAD_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_SPREAD_CASE
}
