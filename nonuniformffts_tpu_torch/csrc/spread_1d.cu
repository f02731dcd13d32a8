// K4 (1D): type-1 spreading of non-uniform values onto the 1D oversampled
// grid, one kernel template over the value type:
//
//   nufft_spread_1d_f32       complex64
//   nufft_spread_1d_f64       complex128
//   nufft_spread_1d_real_f32  float32
//   nufft_spread_1d_real_f64  float64
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_spread_kernel (the
// yz-form Pallas kernel, which every 1D plan runs: the z form needs D >= 2)
// followed by common.overlap_add.  On the TPU each program contracted its
// point batches with a dense (2M-tap) weight matrix on the MXU into a padded
// block, and overlap_add folded the blocks into the grid.
//
// A 1D window has only 2M taps, so K1's mapping (a warp per point, lanes
// over its taps) would leave 32 - 2M lanes idle, and a lane per (point, tap)
// pair would send neighbouring sorted points, which share cells, to the same
// shared-memory address in one instruction: at 10M points on 1.57M cells
// every cell holds ~6 points, and each shared atomicAdd is a
// compare-and-swap loop that retries on such collisions.  This kernel turns
// the scatter around instead:
//
// - One CTA per (spatial block of B cells, transform).  The block's points
//   are a contiguous range of the bin-sorted arrays, sorted by cell.
// - The CTA builds starts[c], the first sorted point of local cell c, for
//   c = 0..B: each thread writes the entries between its point's cell and
//   the previous point's cell, so every entry is written once, without
//   atomics or a scan.
// - Each thread then owns padded cells i (grid node origin - (M-1) + i) and
//   sums, over local cells c in [i - 2M + 1, i] and their points j, the tap
//   t = i - c of point j (Horner in T, window.cuh, or read from the
//   window-weights kernel's output for the other windows, whose B-spline
//   yields all 2M taps together) times its value, in double registers (as
//   K1: ROADMAP queue 3, P2).  Every (point, tap) pair is evaluated (or
//   read) once, by the one thread that owns its cell: no shared-memory
//   atomics, and a sum whose order does not depend on
//   scheduling.
// - The thread rounds its sums to T and adds them into the global grid with
//   periodic wrap and global atomicAdd (neighbouring blocks' halos overlap).
//
// What bounds it on the H100: at high density the taps and the L1
// reads of the points (each point's value and fraction are read by the 2M
// threads whose cells it reaches); at low density the per-block start table
// and the flush.  Values, fractions, taps and coefficients are T, sums
// double; there is no TF32.
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;
using Acc = double;  // ops/kernels/common.py:ACC_BYTES

// Must match ops/kernels/common.py:spread_smem_bytes for D = 1.
template <typename T>
size_t spread_smem_bytes(int m, int ncoef, int b0) {
  return sizeof(T) * (size_t)(2 * m) * ncoef + sizeof(int) * (size_t)(b0 + 1);
}

template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kThreads) spread_1d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, long long np, int ncoef, int n0, int b0) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);                  // (S, ncoef)
  int* starts = reinterpret_cast<int*>(cs + S * ncoef);    // (b0 + 1,)

  const int bid = blockIdx.x;
  const int chan = blockIdx.y;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA

  const int tid = threadIdx.x;
  const int ox = bid * b0;
  for (int i = tid; i < S * ncoef; i += blockDim.x) cs[i] = coefs[i];
  for (int j = p_begin + tid; j < p_end; j += blockDim.x) {
    const int lx = cells[j] - ox;
    const int prev = j == p_begin ? -1 : cells[j - 1] - ox;
    for (int c = prev + 1; c <= lx; ++c) starts[c] = j;
    if (j == p_end - 1)
      for (int c = lx + 1; c <= b0; ++c) starts[c] = p_end;
  }
  __syncthreads();

  const nufft::Value<T, NCOMP>* vrow = vals + (long long)chan * np;
  T* g = grid + (long long)chan * n0 * NCOMP;
  for (int i = tid; i < b0 + S - 1; i += blockDim.x) {
    Acc acc[NCOMP] = {};
    const int c_lo = i - (S - 1) > 0 ? i - (S - 1) : 0;
    const int c_hi = i < b0 - 1 ? i : b0 - 1;
    for (int c = c_lo; c <= c_hi; ++c) {
      const T* cst = cs + (i - c) * ncoef;  // tap i - c
      const int j_end = starts[c + 1];
      for (int j = starts[c]; j < j_end; ++j) {
        const T w = nufft::point_tap<S>(wtaps, cst, ncoef, fracs[j], np, j, 0, i - c);
        const nufft::Value<T, NCOMP> v = vrow[j];
#pragma unroll
        for (int k = 0; k < NCOMP; ++k) acc[k] = nufft::fma_t(Acc(v.c[k]), Acc(w), acc[k]);
      }
    }
    bool any = false;
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) any = any || acc[k] != Acc(0);
    if (!any) continue;
    const long long off = NCOMP * (long long)nufft::wrap_index(ox - (M - 1) + i, n0);
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) atomicAdd(g + off + k, T(acc[k]));
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* vals, const void* cells, const void* fracs,
                   const void* pstarts, const void* coefs, const void* wtaps,
                   void* grid,
                   long long np, int nchan, int ncoef, int n0, int b0,
                   cudaStream_t stream) {
  const size_t smem = spread_smem_bytes<T>(M, ncoef, b0);
  cudaError_t err = cudaFuncSetAttribute(
      spread_1d_kernel<M, T, NCOMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks(n0 / b0, nchan);
  spread_1d_kernel<M, T, NCOMP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(vals),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const int*>(pstarts), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps), static_cast<T*>(grid), np, ncoef, n0, b0);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* vals, const void* cells, const void* fracs,
             const void* pstarts, const void* coefs, const void* wtaps,
             void* grid, long long np, int nchan, int m, int ncoef, int n0,
             int b0, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_SPREAD_CASE(MM)                                            \
  case MM:                                                               \
    return (int)launch<MM, T, NCOMP>(vals, cells, fracs, pstarts, coefs, \
                                     wtaps, grid, np, nchan, ncoef, n0, b0, \
                                     s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_SPREAD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_SPREAD_CASE
}

}  // namespace

// vals (nchan, np) values in bin-sorted order (complex: re, im interleaved);
// cells (1, np) int32 and fracs (1, np) T, sorted; pstarts (nblocks + 1,)
// int32; coefs (1, 2m, ncoef) T, or ncoef = 0 and no coefficients for a
// window other than kHorner, whose taps come in wtaps (1, 2m, np) T
// (window_weights.cu), null for kHorner; grid (nchan, n0) values, zeroed by
// the caller.  T is float for *_f32, double for *_f64.  Launches on `stream`,
// does not synchronise, allocates nothing.
#define NUFFT_SPREAD_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* vals, const void* cells, const void* fracs, \
                      const void* pstarts, const void* coefs,                 \
                      const void* wtaps, void* grid, long long np, int nchan, \
                      int m, int ncoef, int n0, int b0, void* stream) {       \
    return dispatch<T, NCOMP>(vals, cells, fracs, pstarts, coefs, wtaps,      \
                              grid, np, nchan, m, ncoef, n0, b0, stream);     \
  }

#if NUFFT_WANT(0)
NUFFT_SPREAD_ENTRY(nufft_spread_1d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_SPREAD_ENTRY(nufft_spread_1d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_SPREAD_ENTRY(nufft_spread_1d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_SPREAD_ENTRY(nufft_spread_1d_real_f64, double, 1)
#endif
