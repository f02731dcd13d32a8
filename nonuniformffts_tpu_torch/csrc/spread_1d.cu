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
// A 1D window has 2M taps, so a dense product would do (B + 2M - 1) / 2M
// times the work (about 65 at B = 512), and the FP64 tensor cores have
// nothing to do here.  The kernel moves data instead.  The first design, a
// thread a padded cell, read each point's fraction and value from global
// memory once for each of the 2M cells it reaches, in loops of dependent
// loads whose trip counts differ from thread to thread.  Here each point is
// read once:
//
// - One CTA per (spatial block of B cells, transform).  The block's points
//   are a contiguous range of the bin-sorted arrays, sorted by cell; the CTA
//   builds starts[c], the first sorted point of local cell c, for c = 0..B,
//   each thread writing the entries between its point's cell and the
//   previous point's cell (no atomics, no scan), four points' cells loaded
//   at once.
// - A lane owns a local cell.  A warp walks rounds of 32 consecutive cells
//   (its rounds are one contiguous run of the block's); lane l of round r
//   takes the points of cell 32 r + l, reads each one's fraction and value
//   once, the next point's loads issued before the current one's
//   arithmetic (the value in the caller's order, through the sort
//   permutation, so that the wrapper makes no sorted copy of the values),
//   evaluates its 2M taps once (Horner in T on coefficient-major rows,
//   window.cuh:horner_rows, the 2M chains advancing together; or K3's
//   wtaps) and sums tap t times the value, widened to double, into register
//   t: the cell's 2M tap sums (as K1: ROADMAP queue 3, P2).
// - Padded cell p = c + t takes tap t of cell c.  One shuffle a tap rotates
//   the round's tap sums by t lanes: lane l receives tap t of cell
//   32 r + l - t, which is padded cell 32 r + l when t <= l and padded cell
//   32 (r + 1) + l (the next round's) when t > l.  So each lane ends a round
//   with its padded cell's sum and a carry for the next round's; carries
//   stay in registers within a warp, and a warp's last carry reaches the next
//   warp through shared memory after the one barrier.  No two threads add to
//   one address, and no atomics sit in the loop.
// - The flush: interior padded cells p in [2M - 1, B), which no other block
//   reaches, are written with plain stores; the 2(2M - 1) halo cells with
//   periodic wrap and global reductions (red.global.add.v2.f32 for
//   complex64).  Cells whose sum is zero are skipped: the caller zeroes the
//   grid, and a block with no point writes nothing.
//
// What bounds it on the H100 (chip_probe.py --spread1d-parts at 10M
// points, complex64): the random reads of the values through the
// permutation, about half the time; then the latency of the loop over a
// cell's points, whose trip count is Poisson (about 6 points a cell at 10M
// points on 1.57M cells: a warp runs its busiest lane's count), each
// point's Horner steps and 2M NCOMP double FMAs; the sums take registers,
// so the CTAs an SM are set by __launch_bounds__ (min_ctas).  Values,
// fractions, taps and coefficients are T, sums double; there is no TF32.
#include <cstdint>

#include "spread_mma.cuh"
#include "window.cuh"

namespace {

// Must match ops/kernels/common.py:SPREAD1D_THREADS and ACC_BYTES.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using Acc = double;

// The CTAs an SM that a kernel's registers must leave room for
// (__launch_bounds__): 3 for float values and 2 for double up to M = 4,
// one fewer past it, where the 2M NCOMP double sums take more registers;
// one for complex64 past M = 8, whose 4M double sums spill at two (460 B at
// M = 10, 21% slower at 10M points; PERF.md).
constexpr int min_ctas(int scalar_bytes, int ncomp, int m) {
  if (scalar_bytes == 4 && ncomp == 2 && m > 8) return 1;
  return (scalar_bytes == 4 ? 3 : 2) - (m > 4 ? 1 : 0);
}

// Must match ops/kernels/common.py:spread_smem_bytes for D = 1: the
// coefficient-major (ncoef, row_pitch) coefficients, each warp's carry
// (2M - 1 padded cells of NCOMP doubles), the int32 start table of B + 1
// entries.
template <int M, typename T, int NCOMP>
size_t spread_smem_bytes(int ncoef, int b0) {
  return sizeof(T) * (size_t)nufft::row_pitch<2 * M, T>() * ncoef +
         sizeof(Acc) * (size_t)kWarps * (2 * M - 1) * NCOMP + sizeof(int) * (size_t)(b0 + 1);
}

// Adds padded cell p's sum into the grid row g (n0 cells), or stores it
// when p is an interior cell, [2M - 1, b0): no other block reaches those.
template <int M, typename T, int NCOMP>
__device__ __forceinline__ void flush(T* g, const Acc (&sum)[NCOMP], int p, int ox, int n0,
                                      int b0) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < NCOMP; ++k) any = any || sum[k] != Acc(0);
  if (!any || p >= b0 + 2 * M - 1) return;
  T* dst = g + NCOMP * (long long)nufft::wrap_index(ox - (M - 1) + p, n0);
  if (p >= 2 * M - 1 && p < b0) {
    nufft::Value<T, NCOMP> v;
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) v.c[k] = T(sum[k]);
    *reinterpret_cast<nufft::Value<T, NCOMP>*>(dst) = v;
  } else if constexpr (NCOMP == 2) {
    nufft::add_complex(dst, sum[0], sum[1]);
  } else {
    atomicAdd(dst, T(sum[0]));
  }
}

// TAPS: the window's taps come in wtaps (window_weights.cu), else by
// Horner's rule (two instantiations, so that the Horner one keeps the
// registers it needs alone).
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kThreads, min_ctas(sizeof(T), NCOMP, M)) spread_1d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, const long long* __restrict__ perm, long long np, int ncoef,
    int n0, int b0) {
  using V = nufft::Value<T, NCOMP>;
  constexpr int S = 2 * M, kPitch = nufft::row_pitch<S, T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);                        // (ncoef, kPitch)
  Acc* s_carry = reinterpret_cast<Acc*>(cs + kPitch * ncoef);    // (kWarps, S - 1, NCOMP)
  int* starts = reinterpret_cast<int*>(s_carry + kWarps * (S - 1) * NCOMP);  // (b0 + 1,)

  const int bid = blockIdx.x;
  const int chan = blockIdx.y;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ox = bid * b0;
  // The coefficients transposed to coefficient-major rows (horner_rows).
  for (int i = tid; i < kPitch * ncoef; i += kThreads) {
    const int q = i / kPitch, t = i - q * kPitch;
    cs[i] = t < S ? coefs[t * ncoef + q] : T(0);
  }
  // The start table, kUnroll points a thread at a time: their cells are
  // loaded together, so that the loop waits once for each kUnroll points.
  constexpr int kUnroll = 4;
  for (int j0 = p_begin + tid; j0 < p_end; j0 += kUnroll * kThreads) {
    int lx[kUnroll], prev[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kThreads;
      lx[u] = j < p_end ? cells[j] - ox : b0;
      prev[u] = j < p_end && j > p_begin ? cells[j - 1] - ox : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kThreads;
      if (j >= p_end) break;
      for (int c = prev[u] + 1; c <= lx[u]; ++c) starts[c] = j;
      if (j == p_end - 1)
        for (int c = lx[u] + 1; c <= b0; ++c) starts[c] = p_end;
    }
  }
  __syncthreads();

  const V* vrow = vals + (long long)chan * np;
  T* g = grid + (long long)chan * n0 * NCOMP;
  // This warp's rounds of 32 cells: one contiguous run.
  const int rounds = (b0 + 31) / 32;
  const int per_warp = (rounds + kWarps - 1) / kWarps;
  const int r_begin = warp * per_warp;
  const int r_end = min(r_begin + per_warp, rounds);
  Acc head[NCOMP] = {};   // the first round's sum, lanes < S - 1: waits for the carry-in
  Acc carry[NCOMP] = {};  // lane q < S - 1: padded cell 32 r + q from the last round
  for (int r = r_begin; r < r_end; ++r) {
    const int c = 32 * r + lane;
    Acc acc[S][NCOMP] = {};
    int j = c < b0 ? starts[c] : 0;
    const int j_end = c < b0 ? starts[c + 1] : 0;
    // The values come in the caller's order: point j's is vrow[perm[j]],
    // its index loaded a point ahead of the value.
    T f = T(0);
    V v = {};
    long long q_next = 0;
    if (j < j_end) {
      f = fracs[j];
      v = vrow[perm[j]];
      if (j + 1 < j_end) q_next = perm[j + 1];
    }
    for (; j < j_end; ++j) {
      const T f_cur = f;
      const V v_cur = v;
      if (j + 1 < j_end) {
        f = fracs[j + 1];
        v = vrow[q_next];
        if (j + 2 < j_end) q_next = perm[j + 2];
      }
      T w[S];
      if constexpr (TAPS) {
#pragma unroll
        for (int t = 0; t < S; ++t) w[t] = wtaps[t * np + j];
      } else {
        nufft::horner_rows<S>(cs, ncoef, f_cur, w);
      }
#pragma unroll
      for (int t = 0; t < S; ++t)
#pragma unroll
        for (int k = 0; k < NCOMP; ++k) acc[t][k] = nufft::fma_t(Acc(v_cur.c[k]), Acc(w[t]), acc[t][k]);
    }
    // Lane l takes tap t of lane (l - t) mod 32: padded cell 32 r + l
    // (t <= l) or the next round's 32 (r + 1) + l (t > l).
    Acc in[NCOMP], out[NCOMP] = {};
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) in[k] = carry[k];
#pragma unroll
    for (int t = 0; t < S; ++t)
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) {
        const Acc x = __shfl_sync(0xffffffffu, acc[t][k], (lane - t) & 31);
        if (t <= lane) in[k] += x;
        else out[k] += x;
      }
    if (r == r_begin && lane < S - 1) {
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) head[k] = in[k];
    } else {
      flush<M, T, NCOMP>(g, in, 32 * r + lane, ox, n0, b0);
    }
#pragma unroll
    for (int k = 0; k < NCOMP; ++k) carry[k] = out[k];
  }
  // The last round's carry: the next warp's first cells, or the block's
  // right halo.
  const bool last = r_end == rounds;
  if (r_begin < r_end && lane < S - 1) {
    if (last) {
      flush<M, T, NCOMP>(g, carry, 32 * r_end + lane, ox, n0, b0);
    } else {
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) s_carry[(warp * (S - 1) + lane) * NCOMP + k] = carry[k];
    }
  }
  __syncthreads();
  if (r_begin < r_end && lane < S - 1) {
    if (warp > 0) {
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) head[k] += s_carry[((warp - 1) * (S - 1) + lane) * NCOMP + k];
    }
    flush<M, T, NCOMP>(g, head, 32 * r_begin + lane, ox, n0, b0);
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* vals, const void* cells, const void* fracs,
                   const void* pstarts, const void* coefs, const void* wtaps,
                   void* grid, const void* perm, long long np, int nchan, int ncoef,
                   int n0, int b0, cudaStream_t stream) {
  const size_t smem = spread_smem_bytes<M, T, NCOMP>(ncoef, b0);
  auto kernel = wtaps ? spread_1d_kernel<M, T, NCOMP, true> : spread_1d_kernel<M, T, NCOMP, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks(n0 / b0, nchan);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(vals),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const int*>(pstarts), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps), static_cast<T*>(grid),
      static_cast<const long long*>(perm), np, ncoef, n0, b0);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* vals, const void* cells, const void* fracs,
             const void* pstarts, const void* coefs, const void* wtaps,
             void* grid, const void* perm, long long np, int nchan, int m, int ncoef,
             int n0, int b0, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_SPREAD_CASE(MM)                                                 \
  case MM:                                                                    \
    return (int)launch<MM, T, NCOMP>(vals, cells, fracs, pstarts, coefs,      \
                                     wtaps, grid, perm, np, nchan, ncoef, n0, \
                                     b0, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_SPREAD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_SPREAD_CASE
}

}  // namespace

// vals (nchan, np) values in the caller's point order (complex: re, im
// interleaved); cells (1, np) int32 and fracs (1, np) T, sorted; pstarts
// (nblocks + 1,) int32; coefs (1, 2m, ncoef) T, or ncoef = 0 and no
// coefficients for a window other than kHorner, whose taps come in wtaps
// (1, 2m, np) T (window_weights.cu), null for kHorner; grid (nchan, n0)
// values, zeroed by the caller; perm (np,) int64, the caller's index of
// each sorted point.  T is float for *_f32, double for *_f64.  Launches on
// `stream`, does not synchronise, allocates nothing.
#define NUFFT_SPREAD_ENTRY(NAME, T, NCOMP)                                      \
  extern "C" int NAME(const void* vals, const void* cells, const void* fracs,   \
                      const void* pstarts, const void* coefs,                   \
                      const void* wtaps, void* grid, const void* perm,          \
                      long long np, int nchan, int m, int ncoef, int n0, int b0, \
                      void* stream) {                                           \
    return dispatch<T, NCOMP>(vals, cells, fracs, pstarts, coefs, wtaps,        \
                              grid, perm, np, nchan, m, ncoef, n0, b0, stream); \
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
