// K2 and K6b: type-2 interpolation from the 3D oversampled grid at the
// non-uniform points, one kernel template over the value type:
//
//   nufft_interp_3d_f32       complex64   (K2)
//   nufft_interp_3d_f64       complex128  (K6b)
//   nufft_interp_3d_real_f32  float32     (K2, real rows)
//   nufft_interp_3d_real_f64  float64     (K6b, real rows)
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_interp_kernel_z (the
// Pallas kernel launched by interpolate_blocked) and
// nonuniformffts_tpu/ops/pallas/blocked_ds.py:_interp_kernel_ds (launched by
// interpolate_blocked_ds).  On the TPU each program copied its spatial
// block's halo-padded window into VMEM once, contracted it with dense weight
// matrices on the MXU (in (hi, lo) float32 pairs with int8 limb cascades for
// the ds kernel, with normfactor as a ds pair), wrote per-slot results plus
// a key row, and a masked sort put the results back in input order because
// the TPU cannot scatter.  Here:
//
// - A CTA covers a run of consecutive spatial blocks (one at rho = 1, about
//   a CTA's threads' worth of points at lower densities), whose points are
//   one contiguous range of the bin-sorted arrays (pstarts).  CTAs are
//   numbered z-fastest, so the CTAs in flight share an x plane of blocks.
// - A block of at least kSparse points is staged: the CTA copies its
//   padded window, (B0 + 2M - 1, B1 + 2M - 1, B2 + 2M - 1) cells of one
//   transform's grid with periodic wrap, into shared memory once (cp.async
//   element copies, lanes along z rows so that a row's reads coalesce, the
//   wrapped x, y and z offsets from small tables, so that a grid smaller
//   than the window, which wraps more than once, needs no special case).
//   A window above the 227 KB a CTA can use is staged in x-slab passes of
//   as many x planes as fit: each point adds the x taps that fall in the
//   staged planes and writes (first pass) or adds (later passes) its
//   partial result.
// - The points' taps are evaluated once, in batches of kBatch points, into
//   shared memory (a thread a tap and point; Horner on a coefficient table
//   laid out so that a warp reads one word, or K3's wtaps), with each
//   point's cells.
// - A point is contracted by a group of lanes (Lanes: 8 for complex128, 16
//   for complex64 and float64, 32 for float32 at M = 4), one z tap a lane,
//   each lane walking x and its rows with a separate sum a row: a load
//   instruction reads each point's whole z runs, one 128-byte wavefront a
//   point with no bank conflict (the z pitch is chosen for it,
//   interp_tiles), where a thread a point read 32 scattered cells and ran
//   2-3 wavefronts a load.  The group's parts meet by shuffles, and the
//   batch's results are written by all threads at once.
// - A block of fewer than kSparse points is not staged: its lanes read
//   the points' windows from global memory with periodic wrap, whole z runs
//   a load, and a CTA covers enough such blocks to fill its warps.  The
//   branch is per block, uniform across the CTA.
// - FMAs in T (float32 stays float, as the JAX kernel's bf16x6
//   contraction); normfactor passed as a double so that FP64 plans keep
//   every bit; results written to out[c, perm[j]] directly: the un-permute
//   is a scatter, with no key row and no sort.
//
// What bounds it on the H100: the floor is the shared-memory reads, (2M)^3
// cells a point and transform (16.8M complex64 points read 68.7 GB, about
// 2.3 ms at 128 B a clock on 132 SMs); on the card the latency of each
// block's short phases between barriers at 2-3 CTAs an SM weighs more
// (chip_probe.py --interp3d-parts: without the copy, the taps and the loads
// a complex64 run at rho = 1 still takes about half its time), so the
// kernel runs 1.03-1.27x the per-point form it replaced there and 1.1-1.8x
// below (PERF.md).
#include <cstdint>

#include "window.cuh"

namespace {

// Must match ops/kernels/common.py:INTERP3D_* and MAX_SMEM_BYTES.
constexpr int kThreads = 256;  // threads of one CTA
// Blocks with fewer points are read from global memory.
constexpr int kSparse = 64;
constexpr int kMaxGroup = 64;  // most spatial blocks one CTA covers

// Points whose taps the CTA holds at a time, as measured on the H100 at
// the main path's block dims (PERF.md): 64 for float64 (its (24, 8, 8)
// window leaves room for no more at two CTAs an SM), 128 for complex values
// (more takes L1 from the sparse blocks' reads), 256 for float32; halved
// while the taps exceed 64 KB.
template <int M, typename T, int NCOMP>
__host__ __device__ constexpr int batch_of() {
  int b = NCOMP == 2 ? 128 : sizeof(T) == 8 ? 64 : 256;
  while (b * 6 * M * int(sizeof(T)) > 65536) b /= 2;
  return b;
}
// Resident CTAs an SM the register allocation must allow: 3 for float, 2
// for double values, as measured on the H100 (PERF.md).
template <typename T>
constexpr int min_ctas_of() {
  return sizeof(T) == 4 ? 3 : 2;
}
constexpr size_t kMaxSmem = 232448;

// z taps a lane group spans: 2M rounded up to a power of two (at least 4).
__host__ __device__ constexpr int z_span(int m) {
  return 2 * m <= 4 ? 4 : 2 * m <= 8 ? 8 : 2 * m <= 16 ? 16 : 32;
}

// The lanes that contract one point (ops/kernels/common.py:interp_lanes):
// as many as one 128-byte shared-memory wavefront holds cells (8 complex128,
// 16 complex64 or float64, 32 float32), at least z_span.  Lane q takes
// z tap e = q % kSpan of window rows q / kSpan + kRows k, k < kK.
template <int M, typename T, int NCOMP>
struct Lanes {
  static constexpr int kSpan = z_span(M);
  static constexpr int kCells = 128 / int(sizeof(T) * NCOMP);  // cells a wavefront
  static constexpr int kPerPoint = kSpan > kCells ? kSpan : kCells;
  static constexpr int kRows = kPerPoint / kSpan;
  static constexpr int kK = (2 * M + kRows - 1) / kRows;
  static_assert(kPerPoint <= 32, "a point's lanes lie in one warp");
};

// The staged window of one padded block (ops/kernels/common.py:
// interp_tiles): cells, with z rows `pitch` cells apart and x planes `plane`
// apart; `planes` x planes staged a pass, `passes` passes (0 if one plane
// does not fit); `head` bytes of tables before it.
// The pitch is the least >= pd2 that is z_span(m) modulo the cells of a
// wavefront where z_span(m) is fewer: the kRows rows one load instruction
// of a point reads then fall on distinct banks.
struct Window {
  int pd0, pd1, pd2, pitch, plane, planes, passes;
  size_t head, smem;
};

template <int M, typename T, int NCOMP>
__host__ __device__ inline Window window_of(int ncoef, int b0, int b1, int b2) {
  constexpr int m = M;
  Window w;
  w.pd0 = b0 + 2 * m - 1;
  w.pd1 = b1 + 2 * m - 1;
  w.pd2 = b2 + 2 * m - 1;
  const int cells = 128 / int(sizeof(T) * NCOMP), span = z_span(m);
  w.pitch = span < cells ? w.pd2 + ((span - w.pd2) % cells + cells) % cells : w.pd2;
  w.plane = w.pd1 * w.pitch;
  // A batch's sums, the (ncoef, 3, span) coefficient table, a batch's
  // (3, 2M, kBatch) taps and (3, kBatch) cells, the CTA's blocks' point
  // ranges, the x, y and z offset tables.
  const size_t batch = batch_of<M, T, NCOMP>();
  const size_t head = sizeof(T) * (NCOMP * batch + ncoef * 3 * span + 3 * 2 * m * batch) +
                      sizeof(int) * (3 * batch + kMaxGroup + 1 + w.pd0 + w.pd1 + w.pd2);
  w.head = (head + 15) / 16 * 16;
  const size_t plane_bytes = sizeof(T) * NCOMP * (size_t)w.plane;
  const long long fit = w.head < kMaxSmem ? (long long)((kMaxSmem - w.head) / plane_bytes) : 0;
  w.passes = fit >= 1 ? (int)((w.pd0 + fit - 1) / fit) : 0;
  w.planes = w.passes ? (w.pd0 + w.passes - 1) / w.passes : 0;
  w.smem = w.head + plane_bytes * w.planes;
  return w;
}

using nufft::cp_async;
using nufft::cp_async_commit;
using nufft::cp_async_wait_all;
using nufft::mod_index;

// Tap t of dimension d of sorted point j, of fraction X: from wtaps, or by
// Horner's rule on the coefficient table cst, (ncoef, 3, z_span(M)) with
// each tap's coefficients a column, so that lanes evaluating neighbouring
// taps read neighbouring words.
template <int M, typename T, bool TAPS>
__device__ __forceinline__ T tap(const T* cst, int ncoef, T X, const T* wtaps,
                                 long long np, long long j, int d, int t) {
  if constexpr (TAPS) return wtaps[(d * 2 * M + t) * np + j];
  constexpr int kCol = 3 * z_span(M);
  const T* c = cst + d * z_span(M) + t;
  const T z = T(2) * X - T(1);
  T v = c[(ncoef - 1) * kCol];
  for (int q = ncoef - 2; q >= 0; --q) v = nufft::fma_t(v, z, c[q * kCol]);
  return v;
}

// One lane's part of a point's sum: z tap ze of window rows row0 + kRows
// k, over the x taps a with has_x(a); the taps come from the batch's table
// (3, 2M, kBatch), at(a, k) reads the cell.  The rows' sums are separate
// chains, weighted by their y taps at the end.
template <int M, typename T, int NCOMP, class L, class HasX, class At>
__device__ __forceinline__ nufft::Value<T, NCOMP> lane_sum(const T* s_tap, int p, int row0,
                                                           int ze, HasX has_x, At at) {
  constexpr int S = 2 * M, kBatch = batch_of<M, T, NCOMP>();
  constexpr bool kRagged = S % L::kRows != 0;  // rows past 2M exist
  // The x loop unrolled whole up to M = 5; beyond, by two, which keeps the
  // build's time near that of the other kernels.
  constexpr int kUnrollX = M <= 5 ? S : 2;
  T wy[L::kK];
#pragma unroll
  for (int k = 0; k < L::kK; ++k) {
    const int b = row0 + k * L::kRows;
    wy[k] = !kRagged || b < S ? s_tap[(S + b) * kBatch + p] : T(0);
  }
  T rs[L::kK][NCOMP] = {};
#pragma unroll kUnrollX
  for (int a = 0; a < S; ++a) {
    if (has_x(a)) {
      const T wx = s_tap[a * kBatch + p];
#pragma unroll
      for (int k = 0; k < L::kK; ++k) {
        if (!kRagged || row0 + k * L::kRows < S) {
          const nufft::Value<T, NCOMP> val = at(a, k);
#pragma unroll
          for (int n = 0; n < NCOMP; ++n) rs[k][n] = nufft::fma_t(val.c[n], wx, rs[k][n]);
        }
      }
    }
  }
  nufft::Value<T, NCOMP> acc = {};
#pragma unroll
  for (int k = 0; k < L::kK; ++k)
#pragma unroll
    for (int n = 0; n < NCOMP; ++n) acc.c[n] = nufft::fma_t(rs[k][n], wy[k], acc.c[n]);
  const T wz = s_tap[(2 * S + ze) * kBatch + p];
#pragma unroll
  for (int n = 0; n < NCOMP; ++n) acc.c[n] *= wz;
  return acc;
}

// The batch's nb points, L::kPerPoint lanes a point, into s_res: the loop
// is uniform across each warp, which reduces a point's parts by shuffles.
// part(p) is this lane's part of point p (zero past nb).
template <typename T, int NCOMP, class L, class Part>
__device__ __forceinline__ void contract_batch(int nb, nufft::Value<T, NCOMP>* s_res, Part part) {
  constexpr int kPointsPerWarp = 32 / L::kPerPoint;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int p0 = warp * kPointsPerWarp; p0 < nb; p0 += nwarps * kPointsPerWarp) {
    const int p = p0 + lane / L::kPerPoint;
    nufft::Value<T, NCOMP> acc = part(p);
#pragma unroll
    for (int off = L::kPerPoint / 2; off >= 1; off /= 2)
#pragma unroll
      for (int n = 0; n < NCOMP; ++n) acc.c[n] += __shfl_xor_sync(0xffffffffu, acc.c[n], off);
    if (p < nb && lane % L::kPerPoint == 0) s_res[p] = acc;
  }
}

// One CTA covers `group` consecutive spatial blocks.  TAPS: the window's
// taps come in wtaps (window_weights.cu), else by Horner's rule.
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kThreads, min_ctas_of<T>()) interp_3d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ grid,
    const int* __restrict__ cells, const T* __restrict__ fracs,
    const long long* __restrict__ perm, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    nufft::Value<T, NCOMP>* __restrict__ out, long long np, int nchan,
    int ncoef, int n0, int n1, int n2, int b0, int b1, int b2, int group,
    double normfactor) {
  using V = nufft::Value<T, NCOMP>;
  using L = Lanes<M, T, NCOMP>;
  constexpr int S = 2 * M, kBatch = batch_of<M, T, NCOMP>();
  constexpr int kCol = 3 * L::kSpan;
  constexpr int kSkip = -(1 << 30);  // a batch point of a dense block
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int nb1 = n1 / b1, nb2 = n2 / b2;
  const int nblocks = (n0 / b0) * nb1 * nb2;
  const int first = blockIdx.x * group;
  const int ng = min(group, nblocks - first);  // blocks of this CTA

  const Window w = window_of<M, T, NCOMP>(ncoef, b0, b1, b2);
  V* s_res = reinterpret_cast<V*>(smem_raw);        // (kBatch,): a batch's sums
  T* cs = reinterpret_cast<T*>(s_res + kBatch);     // (ncoef, 3, kSpan), zero past 2M
  T* s_tap = cs + kCol * ncoef;                     // (3, S, kBatch): a batch's taps
  int* s_pt = reinterpret_cast<int*>(s_tap + 3 * S * kBatch);  // (3, kBatch): cells
  int* s_ps = s_pt + 3 * kBatch;      // (ng + 1,): the blocks' point ranges
  int* xoff = s_ps + kMaxGroup + 1;   // (pd0,): x n1 n2
  int* yoff = xoff + w.pd0;           // (pd1,): y n2
  int* zoff = yoff + w.pd1;           // (pd2,): z
  V* win = reinterpret_cast<V*>(smem_raw + w.head);  // (planes, pd1, pitch)
  const int tid = threadIdx.x;
  for (int i = tid; i <= ng; i += blockDim.x) s_ps[i] = pstarts[first + i];
  for (int i = tid; i < kCol * ncoef; i += blockDim.x) {
    const int c = i / kCol, d = (i - c * kCol) / L::kSpan, t = i - c * kCol - d * L::kSpan;
    cs[i] = t < S ? coefs[(d * S + t) * ncoef + c] : T(0);
  }
  __syncthreads();
  const int q_begin = s_ps[0], q_end = s_ps[ng];
  if (q_begin == q_end) return;  // uniform across the CTA
  bool sparse = false, dense = false;
  for (int g = tid; g < ng; g += blockDim.x) {
    const int n = s_ps[g + 1] - s_ps[g];
    sparse = sparse || (n > 0 && n < kSparse);
    dense = dense || n >= kSparse;
  }
  const bool any_dense = __syncthreads_or(dense);
  const bool any_sparse = __syncthreads_or(sparse);

  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  // Contraction lanes: this lane's z tap and first row.
  const int q = lane % L::kPerPoint;
  const int ze = q % L::kSpan, row0 = L::kRows == 1 ? 0 : q / L::kSpan;
  const long long volume = (long long)n0 * n1 * n2;
  const T nf = T(normfactor);
  // A batch's taps, (3, 2M, kBatch), a thread a (tap, point) with the
  // points fastest: Horner's threads of a warp read one coefficient, and
  // the stores hit consecutive words.
  auto stage_taps = [&](int pb, int nb) {
    for (int e = tid; e < 3 * S * nb; e += blockDim.x) {
      const int row = e / nb, p = e - row * nb, d = row / S;
      s_tap[row * kBatch + p] = tap<M, T, TAPS>(cs, ncoef, fracs[d * np + pb + p], wtaps, np,
                                                pb + p, d, row - d * S);
    }
  };

  // Sparse blocks: the CTA's points in batches, each point's window read
  // from global memory with periodic wrap by its lanes.
  if (any_sparse) {
    for (int qb = q_begin; qb < q_end; qb += kBatch) {
      const int nb = min(kBatch, q_end - qb);
      __syncthreads();  // the last batch is written out
      stage_taps(qb, nb);
      for (int p = tid; p < nb; p += blockDim.x) {
        const int j = qb + p;
        int lo = 0, hi = ng;  // j's block: the last one starting at or before j
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (s_ps[mid] <= j) lo = mid;
          else hi = mid;
        }
        const bool mine = s_ps[lo + 1] - s_ps[lo] < kSparse;
#pragma unroll
        for (int d = 0; d < 3; ++d) s_pt[d * kBatch + p] = mine ? cells[d * np + j] - (M - 1) : kSkip;
      }
      __syncthreads();
      for (int c = 0; c < nchan; ++c) {
        if (c > 0) __syncthreads();  // the last transform is written out
        const V* g = grid + c * volume;
        contract_batch<T, NCOMP, L>(nb, s_res, [&](int p) {
          if (p >= nb || ze >= S || s_pt[p] == kSkip) return V{};
          const int cx = s_pt[p];
          int yo[L::kK];
#pragma unroll
          for (int k = 0; k < L::kK; ++k)
            yo[k] = nufft::wrap_index(s_pt[kBatch + p] + row0 + k * L::kRows, n1) * n2;
          const int zo = nufft::wrap_index(s_pt[2 * kBatch + p] + ze, n2);
          return lane_sum<M, T, NCOMP, L>(
              s_tap, p, row0, ze, [](int) { return true; },
              [&](int a, int k) { return g[nufft::wrap_index(cx + a, n0) * n1 * n2 + yo[k] + zo]; });
        });
        __syncthreads();
        for (int p = tid; p < nb; p += blockDim.x) {
          if (s_pt[p] != kSkip) {
            V res;
#pragma unroll
            for (int n = 0; n < NCOMP; ++n) res.c[n] = s_res[p].c[n] * nf;
            out[c * np + perm[qb + p]] = res;
          }
        }
      }
    }
  }
  if (!any_dense) return;  // uniform

  // Dense blocks, one at a time: the window staged in shared memory.
  // Staging lanes: rows of the window by sub-warps of pd2 lanes (as many
  // as fit in 32), a lane a z cell; a row longer than 32 cells takes a warp.
  const int rpw = w.pd2 <= 32 ? 32 / w.pd2 : 1;
  const int sub = w.pd2 <= 32 ? lane / w.pd2 : 0;
  const int l0 = lane - sub * (w.pd2 <= 32 ? w.pd2 : 0);
  const int rstep = nwarps * rpw;
  for (int g = 0; g < ng; ++g) {
    const int bid = first + g;
    const int p_begin = s_ps[g], p_end = s_ps[g + 1];
    if (p_end - p_begin < kSparse || p_end == p_begin) continue;  // uniform
    const int ox = (bid / (nb1 * nb2)) * b0;
    const int oy = ((bid / nb2) % nb1) * b1;
    const int oz = (bid % nb2) * b2;
    __syncthreads();  // the last block's window and tables are read
    // Padded index i along a dim is grid node origin - (M - 1) + i, wrapped.
    for (int i = tid; i < w.pd0 + w.pd1 + w.pd2; i += blockDim.x) {
      if (i < w.pd0)
        xoff[i] = mod_index(ox - (M - 1) + i, n0) * n1 * n2;
      else if (i < w.pd0 + w.pd1)
        yoff[i - w.pd0] = mod_index(oy - (M - 1) + i - w.pd0, n1) * n2;
      else
        zoff[i - w.pd0 - w.pd1] = mod_index(oz - (M - 1) + i - w.pd0 - w.pd1, n2);
    }
    __syncthreads();

    for (int c = 0; c < nchan; ++c) {
      const V* g = grid + c * volume;
      for (int pass = 0; pass < w.passes; ++pass) {
        const int x0 = pass * w.planes;
        const int nx = min(w.planes, w.pd0 - x0);
        if (c > 0 || pass > 0) __syncthreads();  // the window is read
        // Copy planes x0 .. x0 + nx of the window.  Row r = i pd1 + j, with
        // (i, j) carried along so that no lane divides.
        if (sub < rpw) {
          int r = warp * rpw + sub;
          int i = r / w.pd1, jr = r - i * w.pd1;
          for (; i < nx; r += rstep) {
            const V* src = g + xoff[x0 + i] + yoff[jr];
            V* dst = win + (long long)r * w.pitch;
            for (int l = l0; l < w.pd2; l += 32) cp_async<sizeof(V)>(dst + l, src + zoff[l]);
            jr += rstep;
            while (jr >= w.pd1) {
              jr -= w.pd1;
              ++i;
            }
          }
        }
        cp_async_commit();

        for (int pb = p_begin; pb < p_end; pb += kBatch) {
          const int nb = min(kBatch, p_end - pb);
          if (pb > p_begin) __syncthreads();  // the last batch is written out
          stage_taps(pb, nb);
          // Each point's x cell and window offset.
          for (int p = tid; p < nb; p += blockDim.x) {
            const int lx = cells[pb + p] - ox;
            s_pt[p] = lx;
            s_pt[kBatch + p] = lx * w.plane + (cells[np + pb + p] - oy) * w.pitch +
                               (cells[2 * np + pb + p] - oz);
          }
          cp_async_wait_all();
          __syncthreads();
          contract_batch<T, NCOMP, L>(nb, s_res, [&](int p) {
            if (p >= nb || ze >= S) return V{};
            const int lx = s_pt[p];
            // This pass holds x taps a with x0 <= lx + a < x0 + nx.
            const V* base = win + s_pt[kBatch + p] - x0 * w.plane + row0 * w.pitch + ze;
            return lane_sum<M, T, NCOMP, L>(
                s_tap, p, row0, ze,
                [&](int a) { return (unsigned)(lx - x0 + a) < (unsigned)nx; },
                [&](int a, int k) { return base[a * w.plane + k * L::kRows * w.pitch]; });
          });
          __syncthreads();
          // The batch's results, a thread a point: out[c, perm[j]] times
          // normfactor, added to the earlier passes' sum after the first.
          for (int p = tid; p < nb; p += blockDim.x) {
            V* dst = out + c * np + perm[pb + p];
            V res;
            if (pass == 0) {
#pragma unroll
              for (int n = 0; n < NCOMP; ++n) res.c[n] = s_res[p].c[n] * nf;
            } else {
              res = *dst;
#pragma unroll
              for (int n = 0; n < NCOMP; ++n) res.c[n] += s_res[p].c[n] * nf;
            }
            *dst = res;
          }
        }
      }
    }
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* grid, const void* cells, const void* fracs,
                   const void* perm, const void* pstarts, const void* coefs,
                   const void* wtaps, void* out, long long np, int nchan,
                   int ncoef, int n0, int n1, int n2, int b0, int b1, int b2,
                   double normfactor, cudaStream_t stream) {
  const Window w = window_of<M, T, NCOMP>(ncoef, b0, b1, b2);
  if (w.passes == 0) return cudaErrorInvalidValue;
  auto kernel = wtaps ? interp_3d_kernel<M, T, NCOMP, true>
                      : interp_3d_kernel<M, T, NCOMP, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)w.smem);
  if (err != cudaSuccess) return err;
  // Blocks a CTA: about a CTA's threads' worth of points at the mean
  // density, so that sparse blocks gather with full warps.
  const long long nblocks = (long long)(n0 / b0) * (n1 / b1) * (n2 / b2);
  const long long mean = np / nblocks;
  const long long fill = kThreads / (mean + 1);
  const int group = (int)(fill < 1 ? 1 : fill > kMaxGroup ? kMaxGroup : fill);
  const unsigned ctas = (unsigned)((nblocks + group - 1) / group);
  kernel<<<ctas, kThreads, w.smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(grid),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const long long*>(perm), static_cast<const int*>(pstarts),
      static_cast<const T*>(coefs), static_cast<const T*>(wtaps),
      static_cast<nufft::Value<T, NCOMP>*>(out), np, nchan, ncoef, n0, n1, n2,
      b0, b1, b2, group, normfactor);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* grid, const void* cells, const void* fracs,
             const void* perm, const void* pstarts, const void* coefs,
             const void* wtaps, void* out, long long np, int nchan, int m,
             int ncoef, int n0, int n1, int n2, int b0, int b1, int b2,
             double normfactor, void* stream) {
  if (np == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_INTERP_CASE(MM)                                                  \
  case MM:                                                                     \
    return (int)launch<MM, T, NCOMP>(grid, cells, fracs, perm, pstarts, coefs, \
                                     wtaps, out, np, nchan, ncoef, n0, n1, n2, \
                                     b0, b1, b2, normfactor, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_INTERP_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_INTERP_CASE
}

}  // namespace

// grid (nchan, n0, n1, n2) values (complex: re, im interleaved); cells
// (3, np) int32 and fracs (3, np) T in bin-sorted order; perm (np,) int64,
// the original index of each sorted point; pstarts (nblocks + 1,) int32,
// block b's points being sorted positions [pstarts[b], pstarts[b + 1]) for
// blocks (b0, b1, b2) numbered row-major; coefs (3, 2m, ncoef) T, or
// ncoef = 0 and no coefficients for a window other than kHorner, whose taps
// come in wtaps (3, 2m, np) T (window_weights.cu), null for kHorner; out
// (nchan, np) values in original point order.  T is float for *_f32,
// double for *_f64; normfactor is a double for both.  Launches on `stream`,
// does not synchronise, allocates nothing.
#define NUFFT_INTERP_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* grid, const void* cells, const void* fracs, \
                      const void* perm, const void* pstarts,                  \
                      const void* coefs, const void* wtaps, void* out,        \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      int n1, int n2, int b0, int b1, int b2,                 \
                      double normfactor, void* stream) {                      \
    return dispatch<T, NCOMP>(grid, cells, fracs, perm, pstarts, coefs,       \
                              wtaps, out, np, nchan, m, ncoef, n0, n1, n2,    \
                              b0, b1, b2, normfactor, stream);                \
  }

#if NUFFT_WANT(0)
NUFFT_INTERP_ENTRY(nufft_interp_3d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_INTERP_ENTRY(nufft_interp_3d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_INTERP_ENTRY(nufft_interp_3d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_INTERP_ENTRY(nufft_interp_3d_real_f64, double, 1)
#endif
