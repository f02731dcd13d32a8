// K4 (2D) and K6a (2D): type-1 spreading of non-uniform values onto the 2D
// oversampled grid, one kernel template over the value type:
//
//   nufft_spread_2d_f32       complex64   (K4)
//   nufft_spread_2d_f64       complex128  (K6a)
//   nufft_spread_2d_real_f32  float32     (K4, real rows)
//   nufft_spread_2d_real_f64  float64     (K6a, real rows)
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_spread_kernel (the
// yz-form Pallas kernel launched by spread_blocked for every plan that is not
// a z-form plan) followed by common.overlap_add, and, for the float64
// instantiations, blocked_ds.py:_spread_kernel_ds in 2D.  On the TPU each
// program contracted dense per-dimension weight matrices with its block's
// points on the MXU into a (CR * pd0, pd1) buffer, and a separate
// overlap_add pass folded the padded blocks into the grid.  Here the same
// contraction runs on Hopper's FP64 tensor cores (mma.sync m16n8k8 .f64,
// spread_mma.cuh), in native double for every value type, and the flush
// adds into the grid with periodic wrap, so there is no overlap_add:
//
// - A warp owns one spatial block at a time and walks a run of kRuns of
//   them (4 for float grids, 1 for double ones), kWarps apart; a CTA of
//   kWarps warps covers kWarps kRuns consecutive blocks.  A block's points
//   are a contiguous range of the bin-sorted arrays (pstarts); an empty
//   block costs its range's load.
//   With padded dims pd = B + 2M - 1 the block's sum is
//     G (NCOMP pd0 x pd1) += A (NCOMP pd0 x P) . B (P x pd1),
//   A[(i, k), p] = v_p[k] wx_p[i - lx_p], B[p, j] = wy_p[j - ly_p] (zero
//   outside the point's 2M taps), lx, ly the point's cell relative to the
//   block's origin; rows (i, k) with k fastest, columns padded to a
//   multiple of 8.  This is spread_3d.cu's product with the z factor
//   dropped.
// - G is cut into units of 32 rows x 4 n-tiles (ops/kernels/common.py:
//   spread2d_units), and the warp keeps one unit in registers (32 doubles
//   a lane) across the block's points.  The main path's blocks are one
//   unit (complex (8, 16): 30 rows x 23 columns); a block of more units
//   (m >= 6 complex, or larger blocks) walks its points once per unit.
// - Points come in batches of kBatch = 16, two k-steps, staged by the warp
//   alone into its own slice of shared memory: lane (d, p) = (lane / 16,
//   lane % 16) evaluates point p's 2M taps of dimension d (Horner in T for
//   (B)KB FastApproximation, else the taps of the window-weights kernel,
//   wtaps) and writes them, in double, into column p of the unit's dense
//   rows: x taps times the value into A's rows, y taps into B's.  The CTA
//   stages the coefficients coefficient-major, (2, ncoef, 2M), so that one
//   16-byte load gives a Horner step's coefficient for 4 float or 2 double
//   taps (8 bytes, 2 float taps, for odd M): a lane runs its taps' Horner
//   chains that many at a time.  The rows are zero once at the start and
//   each lane writes zero back over its own entries after the batch's MMAs,
//   so a batch writes (NCOMP + 1) 2M entries a point, not the unit's 64
//   rows.  Rows lie kStride doubles apart, so a fragment's 8 rows x 4
//   points fall on distinct bank pairs.  The next batch's cells, fractions
//   and values are loaded while this one is staged and contracted, the
//   next block's point range while this block runs, and its first batch
//   before this block's last flush; a warp's first range and batch load
//   before the CTA's one barrier, beside the coefficients.
// - Each k-step loads the A fragments (serving the unit's n-tiles) and one
//   B fragment per n-tile and runs the MMAs: no index arithmetic, no
//   branch on the data, no shared-memory atomic, and only __syncwarp.
// - The flush adds each lane's accumulators into the grid with periodic
//   wrap, skipping cells no point reached: for complex values re and im sit
//   in lanes 4 apart, and one shuffle gives each lane one whole cell.  A
//   complex64 cell goes in one vector reduction (red.global.add.v2.f32), as
//   do two float32 cells where they are contiguous and aligned; double
//   grids use the native scalar f64 reduction.
//
// What bounds it on the H100: the FP64 tensor cores on the dense product
// (NCOMP pd0 rounded to 16, times pd1 rounded to 8, FMAs a point; 768 at
// the complex main path's (8, 16), against 128 useful), the staging that
// feeds them (2 x 2M taps and (NCOMP + 1) 2M shared stores a point), and at
// low density the flush's global reductions over the halo.  The design it
// replaced, a CTA a block with its sum in shared memory and each warp
// adding one point's (2M)^2 tap products by atomicAdd (compare-and-swap
// loops in SASS, NCOMP (2M)^2 a point), ran 4.9-5.4x slower (PERF.md).
// Products and sums are double: float values and taps are widened on their
// way into shared memory, so there is no TF32 anywhere and float32 plans
// keep the double sums that ROADMAP queue 3, P2 asked for.
#include <cstdint>
#include <type_traits>

#include "spread_mma.cuh"
#include "window.cuh"

namespace {

// Must match ops/kernels/common.py:SPREAD2D_*.
constexpr int kWarps = 8;       // SPREAD2D_WARPS: warps of one CTA, a block each at a time
constexpr int kBatch = 16;      // SPREAD2D_BATCH: points staged at a time
constexpr int kUnitRows = 32;   // SPREAD2D_UNIT_ROWS: two m16 row tiles
constexpr int kColTiles = 4;    // SPREAD2D_UNIT_COL_TILES: n-tiles of 8 columns
constexpr int kRowTiles = kUnitRows / 16;
constexpr int kUnitCols = 8 * kColTiles;
// Doubles from one staged row to the next: 4 past the batch, so the 8 rows
// x 4 points of a fragment load fall on distinct bank pairs.
constexpr int kStride = kBatch + 4;
// Blocks a warp walks, 4 for float and 1 for double grids: with float
// values a run hides each block's loads behind the block before it; double
// grids spend their low-density time in the flush's f64 reductions, and
// ran fastest a block a warp (PERF.md).
template <typename T>
__host__ __device__ constexpr int runs_of() {
  return sizeof(T) == 4 ? 4 : 1;
}
// Doubles of one warp's slice: the unit's A rows, then its B rows.
constexpr int kWarpDoubles = (kUnitRows + kUnitCols) * kStride;
static_assert(kBatch % 8 == 0 && 2 * kBatch == 32, "a lane a point and dimension");
static_assert(kUnitRows == kUnitCols, "A and B rows staged alike");

// The unit geometry of one padded block (ops/kernels/common.py:
// spread2d_units).
struct Units {
  int pd0, pd1;
  int row_tiles;   // ceil(NCOMP pd0 / 16)
  int col_tiles;   // ceil(pd1 / 8)
  int col_groups;  // ceil(col_tiles / kColTiles)
  int units;       // ceil(row_tiles / kRowTiles) col_groups
};

template <int NCOMP>
__host__ __device__ inline Units units_of(int m, int b0, int b1) {
  Units u;
  u.pd0 = b0 + 2 * m - 1;
  u.pd1 = b1 + 2 * m - 1;
  u.row_tiles = (NCOMP * u.pd0 + 15) / 16;
  u.col_tiles = (u.pd1 + 7) / 8;
  u.col_groups = (u.col_tiles + kColTiles - 1) / kColTiles;
  u.units = ((u.row_tiles + kRowTiles - 1) / kRowTiles) * u.col_groups;
  return u;
}

// Elements of T from one dimension's staged coefficients to the next's
// (ops/kernels/common.py:spread2d_coef_stride): the (ncoef, 2M) stack
// rounded up to 16 bytes past a multiple of 128, so that the two halves of
// a warp, reading one chunk of each dimension at a time, hit different
// banks, and every chunk stays aligned.
__host__ __device__ inline int coef_stride(int m, int ncoef, int bytes) {
  const int stack = 2 * m * ncoef * bytes;
  return (stack + ((16 - stack) % 128 + 128) % 128) / bytes;
}

// Must match ops/kernels/common.py:spread_smem_bytes (2D): each warp's
// dense rows, then the two dimensions' coefficients in T.  The block dims
// do not enter.
template <typename T>
size_t spread_smem_bytes(int m, int ncoef) {
  return sizeof(double) * kWarps * kWarpDoubles +
         sizeof(T) * (coef_stride(m, ncoef, sizeof(T)) + 2 * m * ncoef);
}

// V taps of T that one Horner step's coefficient load serves: 16 bytes, or
// 8 where 2M taps of float are no multiple of 16 bytes (odd M).
template <int S, typename T>
__host__ __device__ constexpr int chunk_taps() {
  return (S * sizeof(T)) % 16 == 0 ? 16 / sizeof(T) : 8 / sizeof(T);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T c[V];
};

// Taps t0 .. t0 + V - 1 of dimension d of sorted point j, as
// window.cuh:point_tap gives them: from wtaps ((D, S, np)) where the window
// has them there, else by Horner's rule in z = 2X - 1 on cs, that
// dimension's coefficient-major (ncoef, S) stack, one chunk load a step.
template <int S, int V, typename T>
__device__ __forceinline__ void tap_chunk(const T* wtaps, const T* cs, int ncoef, T z,
                                          long long np, long long j, int d, int t0,
                                          T (&w)[V]) {
  if (wtaps) {
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = wtaps[(d * S + t0 + v) * np + j];
    return;
  }
  const Chunk<T, V>* col = reinterpret_cast<const Chunk<T, V>*>(cs + t0);
  Chunk<T, V> c = col[(ncoef - 1) * (S / V)];
#pragma unroll
  for (int v = 0; v < V; ++v) w[v] = c.c[v];
  for (int q = ncoef - 2; q >= 0; --q) {
    c = col[q * (S / V)];
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = nufft::fma_t(w[v], z, c.c[v]);
  }
}

template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kWarps * 32, 2) spread_2d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, long long np, int ncoef, int n0, int n1, int b0,
    int b1) {
  constexpr int S = 2 * M;
  constexpr int V = chunk_taps<S, T>();
  constexpr int kRuns = runs_of<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  double* s_a = reinterpret_cast<double*>(smem_raw) + warp * kWarpDoubles;  // (32, kStride)
  double* s_b = s_a + kUnitRows * kStride;                                   // (32, kStride)
  T* s_cs = reinterpret_cast<T*>(reinterpret_cast<double*>(smem_raw) + kWarps * kWarpDoubles);
  // Staging: lane (d, p) takes dimension d of the batch's point p.
  const int d = lane >> 4, p = lane & (kBatch - 1);
  const nufft::Value<T, NCOMP>* vrow = vals + (long long)blockIdx.y * np;

  // The warp's run of blocks: kRuns blocks kWarps apart from the CTA's
  // first.  Its first block's point range, the CTA's coefficients and the
  // first batch's point data are all in flight before the one barrier;
  // each next block's range loads while the block before it runs, and its
  // first batch before that block's last flush.
  const int nb1 = n1 / b1;
  const int nblocks = (n0 / b0) * nb1;
  const int bid0 = blockIdx.x * kWarps * kRuns + warp;
  auto range = [&](int b, int& lo, int& hi) {
    lo = hi = 0;
    if (b < nblocks) {
      lo = pstarts[b];
      hi = pstarts[b + 1];
    }
  };
  int p_begin, p_end;
  range(bid0, p_begin, p_end);
  const int cstride = coef_stride(M, ncoef, sizeof(T));
  for (int i = tid; i < 2 * S * ncoef; i += blockDim.x) {
    const int dt = i / ncoef, q = i - dt * ncoef;  // coefs: (2, S, ncoef)
    const int dd = dt / S;
    s_cs[dd * cstride + q * S + dt - dd * S] = coefs[i];
  }
  // The next batch's point data, loaded a batch ahead: points from, from +
  // kBatch of those before end.
  int nx_cell = 0;
  T nx_frac = T(0);
  nufft::Value<T, NCOMP> nx_v{};
  auto prefetch = [&](int from, int end) {
    if (from + p < end) {
      const long long j = (long long)from + p;
      nx_cell = cells[d * np + j];
      nx_frac = fracs[d * np + j];
      if (!d) nx_v = vrow[j];
    }
  };
  prefetch(p_begin, p_end);
  __syncthreads();  // the only CTA-wide barrier: from here on a warp is alone
  if (bid0 >= nblocks) return;  // uniform across the warp

  for (int i = lane; i < kWarpDoubles; i += 32) s_a[i] = 0.0;
  __syncwarp();

  const Units u = units_of<NCOMP>(M, b0, b1);
  const int g = lane >> 2, t4 = lane & 3;
  const int rs = d ? 1 : NCOMP;  // staged rows a tap: (i, k) in A, j in B
  const T* cs_d = s_cs + d * cstride;
  T* gch = grid + (long long)blockIdx.y * n0 * n1 * NCOMP;

  for (int run = 0; run < kRuns; ++run) {
    const int bid = bid0 + run * kWarps;
    if (bid >= nblocks) break;
    int q_begin = 0, q_end = 0;  // the next block's points
    if (run + 1 < kRuns) range(bid + kWarps, q_begin, q_end);
    const int ox = (bid / nb1) * b0;
    const int oy = (bid % nb1) * b1;
    for (int unit = 0; p_begin < p_end && unit < u.units; ++unit) {
      const int rt0 = (unit / u.col_groups) * kRowTiles;
      const int ct0 = (unit % u.col_groups) * kColTiles;
      const int nr = min(kRowTiles, u.row_tiles - rt0);  // this unit's row tiles
      const int nc = min(kColTiles, u.col_tiles - ct0);  // and n-tiles
      // This lane's column of the unit's A (d = 0) or B (d = 1) rows, and the
      // first row of G those rows start at.
      double* col = (d ? s_b : s_a) + p;
      const int first = d ? 8 * ct0 : 16 * rt0;
      double acc[kColTiles][kRowTiles][4];
#pragma unroll
      for (int c = 0; c < kColTiles; ++c)
#pragma unroll
        for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][r][e] = 0.0;

      if (unit > 0) prefetch(p_begin, p_end);
      for (int p0 = p_begin; p0 < p_end; p0 += kBatch) {
        const int nb = min(kBatch, p_end - p0);
        const bool live = p < nb;
        const long long j = (long long)p0 + p;
        const int base = (nx_cell - (d ? oy : ox)) * rs - first;  // staged row of tap 0
        const T z = T(2) * nx_frac - T(1);
        double scale[NCOMP];
#pragma unroll
        for (int k = 0; k < NCOMP; ++k) scale[k] = d ? (k == 0 ? 1.0 : 0.0) : double(nx_v.c[k]);
        prefetch(p0 + kBatch, p_end);
        // Stage: tap t of dimension d into staged rows base + t rs + k, those
        // within the unit.
        if (live) {
#pragma unroll
          for (int t0 = 0; t0 < S; t0 += V) {
            T w[V];
            tap_chunk<S, V>(wtaps, cs_d, ncoef, z, np, j, d, t0, w);
#pragma unroll
            for (int v = 0; v < V; ++v)
#pragma unroll
              for (int k = 0; k < NCOMP; ++k) {
                const int row = base + (t0 + v) * rs + k;
                if ((k == 0 || !d) && (unsigned)row < (unsigned)kUnitRows)
                  col[row * kStride] = double(w[v]) * scale[k];
              }
          }
        }
        __syncwarp();
#pragma unroll 1
        for (int s = 0; s < nb; s += 8) {
          double a[kRowTiles][4];
#pragma unroll
          for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                a[r][q * 2 + h] = s_a[(16 * r + 8 * h + g) * kStride + s + 4 * q + t4];
#pragma unroll
          for (int c = 0; c < kColTiles; ++c) {
            if (c >= nc) break;
            double b[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) b[q] = s_b[(8 * c + g) * kStride + s + 4 * q + t4];
#pragma unroll
            for (int r = 0; r < kRowTiles; ++r) {
              if (r >= nr) break;
              nufft::mma_f64(acc[c][r], a[r], b);
            }
          }
        }
        __syncwarp();
        // Zero back this lane's entries for the next batch.
        if (live) {
#pragma unroll
          for (int t = 0; t < S; ++t)
#pragma unroll
            for (int k = 0; k < NCOMP; ++k) {
              const int row = base + t * rs + k;
              if ((k == 0 || !d) && (unsigned)row < (unsigned)kUnitRows) col[row * kStride] = 0.0;
            }
        }
      }
      if (unit == u.units - 1) prefetch(q_begin, q_end);

      // Flush.  Lane (g, t4) of tile (r, c) holds rows 8h + g, columns
      // 2 t4 + e; padded index i along a dim is grid node origin - (M - 1) +
      // i.  Complex: rows 2i and 2i + 1 (lanes 4 apart) hold re and im of
      // cell row i, and one shuffle gives the even lane column 2 t4 and the
      // odd lane column 2 t4 + 1, one reduction each.  Real: a lane adds its
      // two cells, in one reduction where they are contiguous and aligned.
      // Cells of zeros (no point reached them) are skipped.  Each of the
      // lane's cells' y node, or -1 outside the padded block: complex, its
      // one cell; real, columns 2 t4 and 2 t4 + 1.
      int gy[kColTiles][2];
      bool pair[kColTiles];  // real: both cells valid and contiguous
#pragma unroll
      for (int c = 0; c < kColTiles; ++c) {
        const int jc = 8 * (ct0 + c) + 2 * t4 + (NCOMP == 2 ? (g & 1) : 0);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gy[c][e] = c < nc && jc + e < u.pd1 ? nufft::wrap_index(oy - (M - 1) + jc + e, n1) : -1;
        pair[c] = gy[c][0] >= 0 && gy[c][1] == gy[c][0] + 1;
      }
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r) {
        if (r >= nr) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = (16 * (rt0 + r) + 8 * h + g) / NCOMP;
          const bool xok = i < u.pd0;
          T* line = gch + (long long)NCOMP * n1 * nufft::wrap_index(ox - (M - 1) + (xok ? i : 0), n0);
#pragma unroll
          for (int c = 0; c < kColTiles; ++c) {
            if (c >= nc) break;
            const double d0 = acc[c][r][2 * h], d1 = acc[c][r][2 * h + 1];
            if constexpr (NCOMP == 2) {
              const bool odd = g & 1;
              const double got = __shfl_xor_sync(0xffffffffu, odd ? d0 : d1, 4);
              const double re = odd ? got : d0, im = odd ? d1 : got;
              if (xok && gy[c][0] >= 0 && (re != 0.0 || im != 0.0))
                nufft::add_complex(line + 2 * gy[c][0], re, im);
            } else {
              if (!xok) continue;
              T* p0 = line + gy[c][0];
              if constexpr (std::is_same<T, float>::value) {
                if (pair[c] && d0 != 0.0 && d1 != 0.0 &&
                    (reinterpret_cast<uintptr_t>(p0) & 7) == 0) {
                  nufft::red_v2(p0, float(d0), float(d1));
                  continue;
                }
              }
              if (gy[c][0] >= 0 && d0 != 0.0) atomicAdd(p0, T(d0));
              if (gy[c][1] >= 0 && d1 != 0.0) atomicAdd(line + gy[c][1], T(d1));
            }
          }
        }
      }
    }
    if (p_begin == p_end) prefetch(q_begin, q_end);
    p_begin = q_begin;
    p_end = q_end;
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* vals, const void* cells, const void* fracs,
                   const void* pstarts, const void* coefs,
                   const void* wtaps, void* grid,
                   long long np, int nchan, int ncoef, int n0, int n1, int b0,
                   int b1, cudaStream_t stream) {
  const size_t smem = spread_smem_bytes<T>(M, ncoef);
  cudaError_t err = cudaFuncSetAttribute(
      spread_2d_kernel<M, T, NCOMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nblocks = (n0 / b0) * (n1 / b1);
  const int per_cta = kWarps * runs_of<T>();
  const dim3 blocks((nblocks + per_cta - 1) / per_cta, nchan);
  spread_2d_kernel<M, T, NCOMP><<<blocks, kWarps * 32, smem, stream>>>(
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
