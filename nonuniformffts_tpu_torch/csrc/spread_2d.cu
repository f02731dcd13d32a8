// K4 (2D): type-1 spreading of non-uniform values onto the 2D oversampled
// grid, one kernel template over the value type:
//
//   nufft_spread_2d_f32       complex64
//   nufft_spread_2d_f64       complex128
//   nufft_spread_2d_real_f32  float32
//   nufft_spread_2d_real_f64  float64
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_spread_kernel (the
// yz-form Pallas kernel launched by spread_blocked for every plan that is not
// a z-form plan) followed by common.overlap_add, and, for the float64
// instantiations, blocked_ds.py:_spread_kernel_ds in 2D.  On the TPU each
// program accumulated its block into a (CR * pd0, pd1) buffer by dense
// weight-matrix contractions on the MXU, wrote the padded blocks out, and a
// separate overlap_add pass (relayout to the grid plus halo adds) folded
// them into the grid.  Here each CTA accumulates its block in shared
// memory (spread_3d.cu contracts on the FP64 tensor cores instead; the same
// design would serve here, ROADMAP queue 2):
//
// - One CTA per (spatial block, transform); the block's points are a
//   contiguous range of the bin-sorted arrays (pstarts).  An empty block
//   returns before touching shared memory.
// - The CTA zeroes a padded (B0+2M-1)(B1+2M-1) accumulator in dynamic shared
//   memory, NCOMP planes of double, for float values too (ROADMAP queue 3,
//   P2).
// - Each warp takes one point at a time: its lanes evaluate the 2 x 2M taps
//   (Horner in T, window.cuh, or read from the window-weights kernel's
//   output for the other windows) into a per-warp scratch, then split the
//   (2M)^2 (x, y) tap pairs among themselves and add v * wx * wy (formed in
//   T) into shared memory with atomicAdd.  Lane q writes word (q / 2M) * pd1 +
//   q % 2M: distinct addresses within a warp, consecutive along y.
// - The CTA then rounds its padded block, halo included, to T and adds it
//   into the global grid with periodic wrap and global atomicAdd: no
//   overlap_add, no relayout.
//
// What bounds it on the H100: the shared-memory atomics (NCOMP (2M)^2 per
// point, compare-and-swap loops in SASS) and, at low density, the global
// atomics of the flush.  The geometry chooser (blocking.py) keeps several
// CTAs resident and the tap loop at two lanes a bank.  Values, fractions,
// taps and coefficients are T, accumulators double; there is no TF32.  Only
// a Horner window stages coefficients (ncoef > 0).
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 512;  // ops/kernels/common.py:SPREAD_THREADS
using Acc = double;            // ops/kernels/common.py:ACC_BYTES

// Must match ops/kernels/common.py:spread_smem_bytes for D = 2.
template <typename T, int NCOMP>
size_t spread_smem_bytes(int m, int ncoef, int b0, int b1) {
  const size_t s = 2 * m;
  const size_t pv = (size_t)(b0 + s - 1) * (b1 + s - 1);
  const size_t ntaps = 2 * s;
  return sizeof(Acc) * NCOMP * pv + sizeof(T) * (ntaps * ncoef + (kThreads / 32) * ntaps);
}

template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kThreads) spread_2d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, long long np, int ncoef, int n0, int n1, int b0,
    int b1) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int bid = blockIdx.x;
  const int chan = blockIdx.y;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA

  const int pd1 = b1 + S - 1;
  const int pv = (b0 + S - 1) * pd1;
  Acc* acc = reinterpret_cast<Acc*>(smem_raw);      // NCOMP planes of pv
  T* cs = reinterpret_cast<T*>(acc + NCOMP * pv);   // (2, S, ncoef)
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  T* taps = cs + 2 * S * ncoef + warp * 2 * S;  // this warp's (2, S)

  for (int i = tid; i < NCOMP * pv; i += blockDim.x) acc[i] = Acc(0);
  for (int i = tid; i < 2 * S * ncoef; i += blockDim.x) cs[i] = coefs[i];
  __syncthreads();

  const int nb1 = n1 / b1;
  const int ox = (bid / nb1) * b0;
  const int oy = (bid % nb1) * b1;
  const nufft::Value<T, NCOMP>* vrow = vals + (long long)chan * np;

  for (long long j = p_begin + warp; j < p_end; j += nwarps) {
    nufft::warp_taps<S, 2>(wtaps, cs, ncoef, fracs, np, j, lane, taps);
    __syncwarp();
    const int lx = cells[j] - ox;
    const int ly = cells[np + j] - oy;
    const nufft::Value<T, NCOMP> v = vrow[j];
    for (int q = lane; q < S * S; q += 32) {
      const int ix = q / S, iy = q - ix * S;
      const T w = taps[ix] * taps[S + iy];
      const int idx = (lx + ix) * pd1 + ly + iy;
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) atomicAdd(acc + k * pv + idx, Acc(v.c[k] * w));
    }
    __syncwarp();
  }
  __syncthreads();

  // Periodic global add of the padded block: padded index i along a dim is
  // grid node origin - (M - 1) + i.
  T* g = grid + (long long)chan * n0 * n1 * NCOMP;
  for (int i = tid; i < pv; i += blockDim.x) {
    Acc a[NCOMP];
    bool any = false;
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) {
      a[k] = acc[k * pv + i];
      any = any || a[k] != Acc(0);
    }
    if (!any) continue;
    const int i0 = i / pd1;
    const int i1 = i - i0 * pd1;
    const int gx = nufft::wrap_index(ox - (M - 1) + i0, n0);
    const int gy = nufft::wrap_index(oy - (M - 1) + i1, n1);
    const long long off = NCOMP * ((long long)gx * n1 + gy);
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) atomicAdd(g + off + k, T(a[k]));
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* vals, const void* cells, const void* fracs,
                   const void* pstarts, const void* coefs,
                   const void* wtaps, void* grid,
                   long long np, int nchan, int ncoef, int n0, int n1, int b0,
                   int b1, cudaStream_t stream) {
  const size_t smem = spread_smem_bytes<T, NCOMP>(M, ncoef, b0, b1);
  cudaError_t err = cudaFuncSetAttribute(
      spread_2d_kernel<M, T, NCOMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks((n0 / b0) * (n1 / b1), nchan);
  spread_2d_kernel<M, T, NCOMP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(vals),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const int*>(pstarts), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps),
      static_cast<T*>(grid), np, ncoef, n0, n1, b0, b1);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* vals, const void* cells, const void* fracs,
             const void* pstarts, const void* coefs,
             const void* wtaps, void* grid, long long np,
             int nchan, int m, int ncoef, int n0, int n1, int b0, int b1,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_SPREAD_CASE(MM)                                                \
  case MM:                                                                   \
    return (int)launch<MM, T, NCOMP>(vals, cells, fracs, pstarts, coefs,     \
                                     wtaps, grid, np, nchan, ncoef, n0, n1,   \
                                     b0, b1, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_SPREAD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_SPREAD_CASE
}

}  // namespace

// vals (nchan, np) values in bin-sorted order (complex: re, im interleaved);
// cells (2, np) int32 and fracs (2, np) T, sorted; pstarts (nblocks + 1,)
// int32; coefs (2, 2m, ncoef) T, or ncoef = 0 and no coefficients for a
// window other than kHorner, whose taps come in wtaps (D, 2m, np) T
// (window_weights.cu), null for kHorner;
// grid (nchan, n0, n1) values, zeroed by the caller.  T is float for *_f32,
// double for *_f64.  Launches on `stream`, does not synchronise, allocates
// nothing.
#define NUFFT_SPREAD_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* vals, const void* cells, const void* fracs, \
                      const void* pstarts, const void* coefs,                 \
                      const void* wtaps, void* grid,             \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      int n1, int b0, int b1, void* stream) {                 \
    return dispatch<T, NCOMP>(vals, cells, fracs, pstarts, coefs, wtaps, grid,  \
                              np, nchan, m, ncoef, n0, n1, b0, b1, stream);   \
  }

#if NUFFT_WANT(0)
NUFFT_SPREAD_ENTRY(nufft_spread_2d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_SPREAD_ENTRY(nufft_spread_2d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_SPREAD_ENTRY(nufft_spread_2d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_SPREAD_ENTRY(nufft_spread_2d_real_f64, double, 1)
#endif
