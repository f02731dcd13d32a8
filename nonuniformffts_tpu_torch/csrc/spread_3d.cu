// K1 and K6a: type-1 spreading of non-uniform values onto the 3D
// oversampled grid, one kernel template over the value type:
//
//   nufft_spread_3d_f32       complex64   (K1)
//   nufft_spread_3d_f64       complex128  (K6a)
//   nufft_spread_3d_real_f32  float32     (K1, real rows)
//   nufft_spread_3d_real_f64  float64     (K6a, real rows)
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_spread_kernel_z (the
// Pallas kernel launched by spread_blocked, complex and real rows) and
// nonuniformffts_tpu/ops/pallas/blocked_ds.py:_spread_kernel_ds (launched
// by spread_blocked_ds).  On the TPU each program owned one spatial block,
// built dense per-dimension weight matrices and contracted them with the
// point batch on the MXU into a padded block; the halo merge lived in the
// DFT factors.  The ds kernel did the same with float64 emulated as (hi, lo)
// float32 pairs, ds Horner taps and int8 limb contractions.  Here the card
// has native FP64, so one template serves both precisions:
//
// - One CTA per (spatial block, transform).  The block's points are a
//   contiguous range of the bin-sorted arrays (pstarts).  An empty block
//   returns before touching shared memory.
// - The CTA zeroes a padded (B0+2M-1)(B1+2M-1)(B2+2M-1) accumulator in
//   dynamic shared memory, NCOMP planes of double (re and im for complex
//   values, one plane for real values), so the lanes of a warp hit
//   consecutive words.  The accumulator is double for float values too: at
//   rho = 1 a cell sums ~150 terms, and float32 sums put err1 at 1.8e-6
//   against 1.5e-6 for the JAX package's float32 kernels, which sum each
//   128-point batch inside one matmul (ROADMAP queue 3, P2).
// - Each warp takes one point at a time.  Its lanes evaluate the 3 x 2M taps
//   (Horner in T, window.cuh, or read from the window-weights kernel's
//   output for the other windows) into a per-warp scratch, then split the
//   (2M)^2 (y, z) tap pairs among themselves and walk the 2M x taps, adding
//   v * wx * wy * wz (formed in T) into shared memory with atomicAdd.
//   Lanes of one warp write distinct addresses, consecutive along z.
// - The CTA then rounds its padded block, halo included, to T and adds it
//   into the global grid with periodic wrap and global atomicAdd.  This
//   replaces the TPU's halo merge inside the DFT factors: there is no
//   separate fold pass.
//
// What bounds it on the H100: the shared-memory atomics, NCOMP (2M)^3 adds
// per point (1024 at M = 4 for complex values, each a 64-bit
// compare-and-swap loop), and at low density the global atomics of the
// block flush (about 2-3x the grid at the chosen geometry).  The design
// keeps the per-point atomics conflict-free within a warp and in shared
// memory; the flush skips cells no point reached.  A double padded block
// takes twice a float one's shared memory, so the geometry chooser
// (blocking.py) takes smaller blocks to keep several CTAs resident.
// Values, fractions, taps and coefficients are T, accumulators double;
// cells are int32.  There is no TF32 anywhere.  Only a Horner window stages
// coefficients (ncoef > 0); the others read their taps (wtaps).
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 512;  // ops/kernels/common.py:SPREAD_THREADS
using Acc = double;            // ops/kernels/common.py:ACC_BYTES

// Must match ops/kernels/common.py:spread_smem_bytes.
template <typename T, int NCOMP>
size_t spread_smem_bytes(int m, int ncoef, int b0, int b1, int b2) {
  const size_t s = 2 * m;
  const size_t pv = (size_t)(b0 + s - 1) * (b1 + s - 1) * (b2 + s - 1);
  const size_t ntaps = 3 * s;
  return sizeof(Acc) * NCOMP * pv + sizeof(T) * (ntaps * ncoef + (kThreads / 32) * ntaps);
}

template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kThreads) spread_3d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, long long np, int ncoef, int n0, int n1, int n2,
    int b0, int b1, int b2) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int bid = blockIdx.x;
  const int chan = blockIdx.y;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA

  const int pd1 = b1 + S - 1, pd2 = b2 + S - 1;
  const int plane = pd1 * pd2;
  const int pv = (b0 + S - 1) * plane;
  Acc* acc = reinterpret_cast<Acc*>(smem_raw);      // NCOMP planes of pv
  T* cs = reinterpret_cast<T*>(acc + NCOMP * pv);   // (3, S, ncoef)
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  T* taps = cs + 3 * S * ncoef + warp * 3 * S;  // this warp's (3, S)

  for (int i = tid; i < NCOMP * pv; i += blockDim.x) acc[i] = Acc(0);
  for (int i = tid; i < 3 * S * ncoef; i += blockDim.x) cs[i] = coefs[i];
  __syncthreads();

  const int nb1 = n1 / b1, nb2 = n2 / b2;
  const int ox = (bid / (nb1 * nb2)) * b0;
  const int oy = ((bid / nb2) % nb1) * b1;
  const int oz = (bid % nb2) * b2;
  const nufft::Value<T, NCOMP>* vrow = vals + (long long)chan * np;

  for (long long j = p_begin + warp; j < p_end; j += nwarps) {
    nufft::warp_taps<S, 3>(wtaps, cs, ncoef, fracs, np, j, lane, taps);
    __syncwarp();
    const int lx = cells[j] - ox;
    const int ly = cells[np + j] - oy;
    const int lz = cells[2 * np + j] - oz;
    const nufft::Value<T, NCOMP> v = vrow[j];
    for (int q = lane; q < S * S; q += 32) {
      const int iy = q / S, iz = q - iy * S;
      const T wyz = taps[S + iy] * taps[2 * S + iz];
      T vw[NCOMP];
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) vw[k] = v.c[k] * wyz;
      int idx = (lx * pd1 + ly + iy) * pd2 + lz + iz;
#pragma unroll
      for (int ix = 0; ix < S; ++ix) {
        const T wx = taps[ix];
#pragma unroll
        for (int k = 0; k < NCOMP; ++k) atomicAdd(acc + k * pv + idx, Acc(vw[k] * wx));
        idx += plane;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // Periodic global add of the padded block: padded index i along a dim is
  // grid node origin - (M - 1) + i.
  T* g = grid + (long long)chan * n0 * n1 * n2 * NCOMP;
  for (int i = tid; i < pv; i += blockDim.x) {
    Acc a[NCOMP];
    bool any = false;
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) {
      a[k] = acc[k * pv + i];
      any = any || a[k] != Acc(0);
    }
    if (!any) continue;
    const int i0 = i / plane;
    const int r = i - i0 * plane;
    const int i1 = r / pd2;
    const int i2 = r - i1 * pd2;
    const int gx = nufft::wrap_index(ox - (M - 1) + i0, n0);
    const int gy = nufft::wrap_index(oy - (M - 1) + i1, n1);
    const int gz = nufft::wrap_index(oz - (M - 1) + i2, n2);
    const long long off = NCOMP * (((long long)gx * n1 + gy) * n2 + gz);
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) atomicAdd(g + off + k, T(a[k]));
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* vals, const void* cells, const void* fracs,
                   const void* pstarts, const void* coefs,
                   const void* wtaps, void* grid,
                   long long np, int nchan, int ncoef, int n0, int n1, int n2,
                   int b0, int b1, int b2, cudaStream_t stream) {
  const size_t smem = spread_smem_bytes<T, NCOMP>(M, ncoef, b0, b1, b2);
  cudaError_t err = cudaFuncSetAttribute(
      spread_3d_kernel<M, T, NCOMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks((n0 / b0) * (n1 / b1) * (n2 / b2), nchan);
  spread_3d_kernel<M, T, NCOMP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(vals),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const int*>(pstarts), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps),
      static_cast<T*>(grid), np, ncoef, n0, n1, n2, b0, b1, b2);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* vals, const void* cells, const void* fracs,
             const void* pstarts, const void* coefs,
             const void* wtaps, void* grid, long long np,
             int nchan, int m, int ncoef, int n0, int n1, int n2, int b0,
             int b1, int b2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_SPREAD_CASE(MM)                                                \
  case MM:                                                                   \
    return (int)launch<MM, T, NCOMP>(vals, cells, fracs, pstarts, coefs,     \
                                     wtaps, grid, np, nchan, ncoef, n0, n1,   \
                                     n2, b0, b1, b2, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_SPREAD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_SPREAD_CASE
}

}  // namespace

// vals (nchan, np) values in bin-sorted order (complex: re, im interleaved);
// cells (3, np) int32 and fracs (3, np) T, sorted; pstarts (nblocks + 1,)
// int32; coefs (3, 2m, ncoef) T, or ncoef = 0 and no coefficients for a
// window other than kHorner, whose taps come in wtaps (D, 2m, np) T
// (window_weights.cu), null for kHorner;
// grid (nchan, n0, n1, n2) values, zeroed by the caller.  T is float for
// *_f32, double for *_f64.  Launches on `stream`, does not synchronise,
// allocates nothing.
#define NUFFT_SPREAD_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* vals, const void* cells, const void* fracs, \
                      const void* pstarts, const void* coefs,                 \
                      const void* wtaps, void* grid,             \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      int n1, int n2, int b0, int b1, int b2, void* stream) { \
    return dispatch<T, NCOMP>(vals, cells, fracs, pstarts, coefs, wtaps, grid,  \
                              np, nchan, m, ncoef, n0, n1, n2, b0, b1, b2,    \
                              stream);                                        \
  }

#if NUFFT_WANT(0)
NUFFT_SPREAD_ENTRY(nufft_spread_3d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_SPREAD_ENTRY(nufft_spread_3d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_SPREAD_ENTRY(nufft_spread_3d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_SPREAD_ENTRY(nufft_spread_3d_real_f64, double, 1)
#endif
