// K1 and K6a: type-1 spreading of non-uniform values onto the 3D
// oversampled grid, two kernel templates over the value type:
//
//   nufft_spread_3d_f32       complex64   (K1)
//   nufft_spread_3d_f64       complex128  (K6a)
//   nufft_spread_3d_real_f32  float32     (K1, real rows)
//   nufft_spread_3d_real_f64  float64     (K6a, real rows)
//
// Replaces nonuniformffts_tpu/ops/pallas/blocked.py:_spread_kernel_z (the
// Pallas kernel launched by spread_blocked, complex and real rows) and
// nonuniformffts_tpu/ops/pallas/blocked_ds.py:_spread_kernel_ds (launched
// by spread_blocked_ds).  On the TPU each program owned one spatial block
// and contracted dense per-dimension weight matrices with the point batch
// on the MXU into a padded block; the ds kernel did the same with float64
// emulated as (hi, lo) float32 pairs.  Here the same contraction runs on
// Hopper's FP64 tensor cores (mma.sync m16n8k8 .f64), in native double for
// every value type.  A launch of one transform runs spread_3d_kernel; one
// of several runs spread_3d_shared_kernel where a CTA serves more than one
// of them (below).
//
// - One CTA per (spatial block, transform).  The block's points are a
//   contiguous range of the bin-sorted arrays (pstarts); an empty block
//   returns at once.  With padded dims pd = B + 2M - 1, the block's sum is
//     G (NCOMP pd0 x pd1 pd2) += A (NCOMP pd0 x P) . B (P x pd1 pd2),
//   A[(i, k), p] = v_p[k] wx_p[i - lx_p], B[p, (j, l)] = wy_p[j - ly_p]
//   wz_p[l - lz_p] (zero outside the point's 2M taps), with lx, ly, lz the
//   point's cell relative to the block's origin.  Rows are (i, k), k
//   fastest; columns (j, l) with l padded to a multiple of 8, so an
//   n-tile of 8 columns lies in one z row of the padded block.
// - G is cut into units of 32 rows x 4 n-tiles (ops/kernels/common.py:
//   spread_tiles).  A warp keeps one unit in registers (32 doubles a lane)
//   across all the block's points; a CTA runs up to 16 warps, and a block
//   with more units than that walks its points once per pass of 16.  The
//   main path's blocks take one pass (complex64 at (8, 8, 8): 8 units).
// - Points come in batches of 64, staged by all threads in two steps.
//   First the compact taps (one thread a point, dim and tap: Horner in T on
//   the staged coefficient stack for (B)KB FastApproximation, else the taps
//   of the window-weights kernel, wtaps), the values and the local cells,
//   in double.  Then the dense operands: A's rows and the y and z taps at
//   every padded row, a column a point, zero outside the point's taps.
//   Points are the fastest index of every staged array, so the stores hit
//   consecutive words, and operand rows lie kStride doubles apart, so a
//   fragment's 8 rows x 4 points fall on distinct bank pairs.
// - Each warp then walks the batch eight points (one k = 8 step) at a
//   time.  Its lanes' operand offsets are fixed for the unit, so a step is
//   shared loads of the A fragments (serving the unit's 4 n-tiles), two
//   loads and a multiply per B fragment element (serving its row tiles) and
//   the MMAs: no index arithmetic, no branch on the data, no shared-memory
//   atomic.  Three __syncthreads a batch.
// - The flush adds each lane's accumulators into the grid with periodic
//   wrap, skipping cells no point reached.  A lane holds two neighbouring
//   cells of one z row; for complex values re and im sit in lanes 4 apart,
//   and one shuffle gives each lane one whole cell.  A complex64 cell goes
//   in one vector reduction (red.global.add.v2.f32), as do two float32
//   cells where they are contiguous and aligned; double grids use the
//   native scalar f64 reduction.
//
// Many transforms (nchan > 1): spread_3d_shared_kernel, one CTA a spatial
// block and a group of its transforms (where a group holds one transform,
// the per-transform kernel runs).  Nothing but the values depends on
// the transform, so the CTA stages the block's point state once for the
// group: pstarts, the coefficient stack, the cells, the compact taps and
// the dense tap rows of all three dims (x too: A is not staged).  A block
// whose points fit one batch (kBatch) stages them once, reads the group's
// values in the same pass (one global-latency hop for all of them), and
// then its warps take (unit, transform) items with no barrier between
// them: zeroed accumulators, the MMAs with A's fragments formed in
// registers as x tap times value (the same double products as the staged
// A), and the flush into that transform's grid.  A larger block restages
// each batch for each transform, as the per-transform kernel does.  A
// group (common.py:spread3d_cta_transforms) covers at most 448 KiB of
// padded blocks (kCtaGridBytes: 16 complex64 or float32 transforms at the
// main paths' blocks, 8 complex128 or float64), and its values fit in
// shared memory beside the rest while the SM still holds the CTAs its
// register file allows at 128 registers a thread.  With all 32 in one CTA
// the halos that neighbouring CTAs add to fell out of L2 between their
// flushes, and 32 float64 or complex128 transforms ran slower than 32
// launches of one (PERF.md, Findings).
//
// What bounds it on the H100: the FP64 tensor cores on the dense product
// (NCOMP pd0 rounded to the MMA's rows, times pd1 times pd2 rounded to 8,
// FMAs a point; 7,680 at the complex64 main path's (8, 8, 8), against
// 1,024 useful), the instructions that feed them, and at low density the
// flush's global reductions over the halo.  On the card the staging and
// the latency of each block's short phases weigh more than the MMAs
// (chip_probe.py --spread3d-parts, PERF.md); the shared kernel pays them
// once a block and group rather than once a transform, which leaves it the
// MMAs, the fragments' loads and the flush a transform.  A first form
// that built each fragment element from compact taps (index arithmetic and
// a window test per element) and skipped the tiles a step's points miss
// ran 1.7x slower at rho = 1.  Products and sums are double: float values
// and taps are widened on their way into shared memory, so there is no
// TF32 anywhere and float32 plans keep the double sums that ROADMAP queue
// 3, P2 asked for.  The MMA shape is m16n8k8 (sm_90): 7-11% faster than
// m16n8k4 at rho = 1 and 1-3% at the main path's smaller Np, and ahead of
// m8n8k4 (sm_80; PERF.md).  A k = 8 step carries the work of an unrolled
// pair of k = 4 steps: unrolled itself, it spilled at 128 registers.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "spread_mma.cuh"
#include "window.cuh"

namespace {

// Must match ops/kernels/common.py:SPREAD3D_*.
constexpr int kMaxWarps = 16;                          // SPREAD3D_MAX_WARPS
constexpr int kBatch = 64;                             // SPREAD3D_BATCH
constexpr int kAtomRows = 16;                          // SPREAD3D_ATOM_ROWS
constexpr int kK = 8;                                  // points an MMA takes
constexpr int kUnitRows = 32;                          // SPREAD3D_UNIT_ROWS
constexpr int kColTiles = 4;                           // SPREAD3D_UNIT_COL_TILES
constexpr int kRowTiles = kUnitRows / kAtomRows;
constexpr int kHalves = kAtomRows / 8;  // 8-row halves of one MMA tile
constexpr int kQuads = kK / 4;          // 4-point quarters of one MMA's k
// Doubles from one dense operand row to the next: 4 past the batch, so the
// 8 rows x 4 points of a fragment load fall on distinct bank pairs.
constexpr int kStride = kBatch + 4;
static_assert(kBatch % kK == 0, "a batch is whole k-steps");
// Registers of one SM and the most a thread takes (__launch_bounds__ of
// kMaxWarps warps), shared memory of one SM, the 1 KB the system keeps a
// CTA and the most one CTA may opt in to (ops/kernels/common.py:
// SM_REGISTERS, SM_SMEM_BYTES, SMEM_RESERVED_PER_CTA, MAX_SMEM_BYTES).
constexpr int kSmRegs = 65536;
constexpr int kMaxRegs = kSmRegs / (kMaxWarps * 32);
constexpr size_t kSmSmem = 233472, kCtaReserved = 1024, kMaxSmem = 232448;
// Grid bytes that the transforms of one shared-staging CTA cover at most
// (ops/kernels/common.py:SPREAD3D_CTA_GRID_BYTES): a CTA adds its sums into
// one padded block of each of its transforms' grids, and with more the
// halos that neighbouring CTAs add to fall out of L2 between their flushes.
constexpr size_t kCtaGridBytes = 448 * 1024;

// The tile geometry of one padded block (ops/kernels/common.py:spread_tiles).
struct Tiles {
  int pd0, pd1, pd2;
  int row_tiles;   // ceil(NCOMP pd0 / kAtomRows)
  int z_tiles;     // ceil(pd2 / 8): n-tiles of one z row
  int col_tiles;   // pd1 z_tiles
  int col_groups;  // ceil(col_tiles / kColTiles)
  int units;       // ceil(row_tiles / kRowTiles) col_groups
};

template <int NCOMP>
__host__ __device__ inline Tiles tiles_of(int m, int b0, int b1, int b2) {
  Tiles t;
  t.pd0 = b0 + 2 * m - 1;
  t.pd1 = b1 + 2 * m - 1;
  t.pd2 = b2 + 2 * m - 1;
  t.row_tiles = (NCOMP * t.pd0 + kAtomRows - 1) / kAtomRows;
  t.z_tiles = (t.pd2 + 7) / 8;
  t.col_tiles = t.pd1 * t.z_tiles;
  t.col_groups = (t.col_tiles + kColTiles - 1) / kColTiles;
  t.units = ((t.row_tiles + kRowTiles - 1) / kRowTiles) * t.col_groups;
  return t;
}

// Must match ops/kernels/common.py:spread_smem_bytes (3D): the dense
// operands of one batch (A's rows, the y and z taps at every padded row, a
// column a point, rows kStride doubles apart), the batch's compact taps and
// values (double) and local cells (int32), then the (3, 2M, ncoef)
// coefficient stack in T.
template <typename T, int NCOMP>
size_t spread_smem_bytes(int m, int ncoef, int b0, int b1, int b2) {
  const Tiles t = tiles_of<NCOMP>(m, b0, b1, b2);
  const size_t s = 2 * m;
  const size_t dense = (size_t)t.row_tiles * kAtomRows + t.pd1 + 8 * t.z_tiles;
  return sizeof(double) * (kStride * dense + (3 * s + NCOMP) * kBatch) +
         sizeof(int) * 3 * kBatch + sizeof(T) * 3 * s * ncoef;
}

// Must match ops/kernels/common.py:spread_smem_bytes (3D, nchan > 1): the
// dense tap rows of one batch (x at NCOMP pd0 rounded to the MMA's rows,
// over NCOMP; y at pd1; z at pd2 rounded to 8), `ctrans` transforms' values
// (NCOMP rows each), all kStride doubles apart, the batch's compact taps
// (double) and local cells (int32), then the (3, 2M, ncoef) coefficient
// stack in T.
template <typename T, int NCOMP>
size_t shared_smem_bytes(int m, int ncoef, int b0, int b1, int b2, int ctrans) {
  const Tiles t = tiles_of<NCOMP>(m, b0, b1, b2);
  const size_t s = 2 * m;
  const size_t rows = (size_t)t.row_tiles * kAtomRows / NCOMP + t.pd1 + 8 * t.z_tiles;
  return sizeof(double) * (kStride * (rows + (size_t)NCOMP * ctrans) + 3 * s * kBatch) +
         sizeof(int) * 3 * kBatch + sizeof(T) * 3 * s * ncoef;
}

// Transforms one CTA serves (must match ops/kernels/common.py:
// spread3d_cta_transforms): as many of nchan as keep their padded blocks
// within kCtaGridBytes and their values within the CTA's shared memory
// beside the rest, while an SM still holds the CTAs of `warps` warps that
// its register file allows at kMaxRegs a thread; at least one.  One runs
// spread_3d_kernel, more spread_3d_shared_kernel.
template <typename T, int NCOMP>
int cta_transforms(int m, int ncoef, int b0, int b1, int b2, int warps, int nchan) {
  const Tiles t = tiles_of<NCOMP>(m, b0, b1, b2);
  const size_t block = sizeof(T) * NCOMP * t.pd0 * t.pd1 * t.pd2;
  const int ctas = std::max(1, kSmRegs / (kMaxRegs * 32 * warps));
  const size_t budget = std::min(kMaxSmem, kSmSmem / ctas - kCtaReserved);
  const size_t base = shared_smem_bytes<T, NCOMP>(m, ncoef, b0, b1, b2, 0);
  const size_t per = sizeof(double) * kStride * NCOMP;
  const size_t fit = budget > base ? (budget - base) / per : 0;
  return (int)std::max<size_t>(1, std::min({(size_t)nchan, kCtaGridBytes / block, fit}));
}

// The tensor-core product and the flush's reductions (spread_mma.cuh).
using nufft::add_complex;
using nufft::mma_f64;
using nufft::red_v2;

// Adds a warp's unit of sums (acc: row tiles rt0 .. rt0 + nr - 1, n-tiles
// ct0 .. ct0 + nc - 1) into one transform's grid gch at the block whose
// origin is (ox, oy, oz).
template <int M, typename T, int NCOMP>
__device__ __forceinline__ void flush_unit(
    const double (&acc)[kColTiles][kRowTiles][2 * kHalves], T* gch,
    const Tiles& tl, int rt0, int ct0, int nr, int nc, int g, int t4, int ox, int oy,
    int oz, int n0, int n1, int n2) {
  // Flush.  Lane (g, t4) of tile (rt, ct) holds rows 8h + g, columns
  // l, l + 1 with l = l0 + 2 t4; padded index i along a dim is grid node
  // origin - (M - 1) + i.  Complex: rows 2i and 2i + 1 (lanes 4 apart)
  // hold re and im of cell row i, and one shuffle gives the even lane
  // cell l and the odd lane cell l + 1, one reduction each.  Real: a lane
  // adds its two cells, in one reduction where they are contiguous and
  // aligned.  Cells of zeros (no point reached them) are skipped.
  // Each of the lane's cells' offset in its x plane, or -1 outside the
  // padded block: complex, its one cell; real, cells l and l + 1.
  const int zbase = oz - (M - 1);
  int yz[kColTiles][2];
  bool pair[kColTiles];  // real: both cells valid and contiguous
#pragma unroll
  for (int c = 0; c < kColTiles; ++c) {
    const int ct = c < nc ? ct0 + c : 0;
    const int j = ct / tl.z_tiles;
    const int l = 8 * (ct - j * tl.z_tiles) + 2 * t4 + (NCOMP == 2 ? (g & 1) : 0);
    const int gy = nufft::wrap_index(oy - (M - 1) + j, n1) * n2;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      yz[c][e] = l + e < tl.pd2 ? gy + nufft::wrap_index(zbase + l + e, n2) : -1;
    pair[c] = yz[c][0] >= 0 && yz[c][1] == yz[c][0] + 1;
  }
#pragma unroll
  for (int r = 0; r < kRowTiles; ++r) {
    if (r >= nr) break;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const int i = ((rt0 + r) * kAtomRows + 8 * h + g) / NCOMP;
      const bool xok = i < tl.pd0;
      T* plane = gch + (long long)NCOMP * n1 * n2 * nufft::wrap_index(ox - (M - 1) + (xok ? i : 0), n0);
#pragma unroll
      for (int c = 0; c < kColTiles; ++c) {
        if (c >= nc) break;
        const double d0 = acc[c][r][2 * h], d1 = acc[c][r][2 * h + 1];
        if constexpr (NCOMP == 2) {
          const bool odd = g & 1;
          const double got = __shfl_xor_sync(0xffffffffu, odd ? d0 : d1, 4);
          const double re = odd ? got : d0, im = odd ? d1 : got;
          if (xok && yz[c][0] >= 0 && (re != 0.0 || im != 0.0))
            add_complex(plane + 2 * yz[c][0], re, im);
        } else {
          if (!xok) continue;
          T* p0 = plane + yz[c][0];
          if constexpr (std::is_same<T, float>::value) {
            if (pair[c] && d0 != 0.0 && d1 != 0.0 &&
                (reinterpret_cast<uintptr_t>(p0) & 7) == 0) {
              red_v2(p0, float(d0), float(d1));
              continue;
            }
          }
          if (yz[c][0] >= 0 && d0 != 0.0) atomicAdd(p0, T(d0));
          if (yz[c][1] >= 0 && d1 != 0.0) atomicAdd(plane + yz[c][1], T(d1));
        }
      }
    }
  }
}

template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kMaxWarps * 32) spread_3d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, long long np, int ncoef, int n0, int n1, int n2,
    int b0, int b1, int b2) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int nb1 = n1 / b1, nb2 = n2 / b2;
  const int bid = blockIdx.x;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA

  const Tiles tl = tiles_of<NCOMP>(M, b0, b1, b2);
  const int rows = tl.row_tiles * kAtomRows, zrow = 8 * tl.z_tiles;
  const int dense = rows + tl.pd1 + zrow;
  double* s_a = reinterpret_cast<double*>(smem_raw);  // (rows, kStride): A
  double* s_wy = s_a + rows * kStride;                 // (pd1, kStride): y taps
  double* s_wz = s_wy + tl.pd1 * kStride;              // (zrow, kStride): z taps
  double* s_tap = s_wz + zrow * kStride;               // (3, S, kBatch)
  double* s_v = s_tap + 3 * S * kBatch;                // (NCOMP, kBatch)
  int* s_lc = reinterpret_cast<int*>(s_v + NCOMP * kBatch);  // (3, kBatch)
  T* s_cs = reinterpret_cast<T*>(s_lc + 3 * kBatch);         // (3, S, ncoef)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  for (int i = tid; i < 3 * S * ncoef; i += blockDim.x) s_cs[i] = coefs[i];

  const int ox = (bid / (nb1 * nb2)) * b0;
  const int oy = ((bid / nb2) % nb1) * b1;
  const int oz = (bid % nb2) * b2;
  const nufft::Value<T, NCOMP>* vrow = vals + (long long)blockIdx.y * np;
  T* gch = grid + (long long)blockIdx.y * n0 * n1 * n2 * NCOMP;

  for (int first_unit = 0; first_unit < tl.units; first_unit += nwarps) {
    const int unit = first_unit + warp;
    const bool active = unit < tl.units;  // uniform across the warp
    const int rt0 = (unit / tl.col_groups) * kRowTiles;
    const int ct0 = (unit % tl.col_groups) * kColTiles;
    const int nr = min(kRowTiles, tl.row_tiles - rt0);  // this unit's row tiles
    const int nc = min(kColTiles, tl.col_tiles - ct0);  // and n-tiles
    // Each lane's operand offsets, fixed for the unit: A row 8h + g of row
    // tile r, the y row j and z row l0 + g of n-tile c; point t4 of a step.
    int a_off[kRowTiles][kHalves], y_off[kColTiles], z_off[kColTiles];
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
        a_off[r][h] = r < nr ? ((rt0 + r) * kAtomRows + 8 * h + g) * kStride + t4 : t4;
#pragma unroll
    for (int c = 0; c < kColTiles; ++c) {
      const int ct = c < nc ? ct0 + c : 0;
      const int j = ct / tl.z_tiles;
      y_off[c] = j * kStride + t4;
      z_off[c] = (8 * (ct - j * tl.z_tiles) + g) * kStride + t4;
    }
    double acc[kColTiles][kRowTiles][2 * kHalves];
#pragma unroll
    for (int c = 0; c < kColTiles; ++c)
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
        for (int e = 0; e < 2 * kHalves; ++e) acc[c][r][e] = 0.0;

    for (int p0 = p_begin; p0 < p_end; p0 += kBatch) {
      const int nb = min(kBatch, p_end - p0);
      const int nbr = (nb + kK - 1) / kK * kK;  // whole k-steps; the extra points are zero
      __syncthreads();  // the coefficients are in; the last batch is done
      // Stage 1: the batch's taps (a warp a (dim, tap) row, a lane a point:
      // the global reads coalesce and the shared stores hit consecutive
      // words), values and local cells.
      for (int e = warp; e < 3 * S; e += nwarps) {
        const int d = e / S, tap = e - d * S;
        const T* cs_t = s_cs + e * ncoef;
        for (int p = lane; p < nbr; p += 32) {
          const long long j = (long long)p0 + p;
          double w = 0.0;
          if (p < nb)
            w = double(nufft::point_tap<S>(wtaps, cs_t, ncoef, fracs[d * np + j], np, j, d, tap));
          s_tap[e * kBatch + p] = w;
        }
      }
      for (int p = tid; p < nbr; p += blockDim.x) {
        nufft::Value<T, NCOMP> v{};
        int lc[3] = {0, 0, 0};
        if (p < nb) {
          v = vrow[p0 + p];
          lc[0] = cells[p0 + p] - ox;
          lc[1] = cells[np + p0 + p] - oy;
          lc[2] = cells[2 * np + p0 + p] - oz;
        }
#pragma unroll
        for (int k = 0; k < NCOMP; ++k) s_v[k * kBatch + p] = double(v.c[k]);
#pragma unroll
        for (int d = 0; d < 3; ++d) s_lc[d * kBatch + p] = lc[d];
      }
      __syncthreads();
      // Stage 2: the dense operands, a column a point: A[(i, k), p] =
      // v_p[k] wx_p[i - lx_p], and the y and z taps at their padded rows,
      // zero outside the point's 2M taps.  A warp a row.
      for (int e = warp; e < dense; e += nwarps) {
        if (e < rows) {
          const int i = e / NCOMP, k = e - i * NCOMP;
          for (int p = lane; p < nbr; p += 32) {
            const int t = i - s_lc[p];
            s_a[e * kStride + p] = (unsigned)t < (unsigned)S
                                       ? s_tap[t * kBatch + p] * s_v[k * kBatch + p]
                                       : 0.0;
          }
        } else {
          const bool y = e < rows + tl.pd1;
          const int row = y ? e - rows : e - rows - tl.pd1;
          const int* lc = s_lc + (y ? kBatch : 2 * kBatch);
          const double* tp = s_tap + (y ? S : 2 * S) * kBatch;
          double* dst = (y ? s_wy : s_wz) + row * kStride;
          for (int p = lane; p < nbr; p += 32) {
            const int t = row - lc[p];
            dst[p] = (unsigned)t < (unsigned)S ? tp[t * kBatch + p] : 0.0;
          }
        }
      }
      __syncthreads();
      if (!active) continue;

#pragma unroll 1
      for (int p = 0; p < nbr; p += kK) {
        double a[kRowTiles][kQuads * kHalves];
#pragma unroll
        for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
          for (int q = 0; q < kQuads; ++q)
#pragma unroll
            for (int h = 0; h < kHalves; ++h) a[r][q * kHalves + h] = s_a[a_off[r][h] + p + 4 * q];
#pragma unroll
        for (int c = 0; c < kColTiles; ++c) {
          if (c >= nc) break;
          double b[kQuads];
#pragma unroll
          for (int q = 0; q < kQuads; ++q)
            b[q] = s_wy[y_off[c] + p + 4 * q] * s_wz[z_off[c] + p + 4 * q];
#pragma unroll
          for (int r = 0; r < kRowTiles; ++r) {
            if (r >= nr) break;
            mma_f64(acc[c][r], a[r], b);
          }
        }
      }
    }
    if (!active) continue;

    // Flush: each lane's sums into the transform's grid (flush_unit).
    flush_unit<M, T, NCOMP>(acc, gch, tl, rt0, ct0, nr, nc, g, t4, ox, oy, oz, n0, n1, n2);
  }
}

// Many transforms: one CTA a spatial block and a group of `ctrans` of the
// nchan transforms (blockIdx.y; the head of this file).  Where the block's
// points fit one batch they are staged once and the group's values beside
// them; else each batch is staged again for each transform.
template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kMaxWarps * 32) spread_3d_shared_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, long long np, int nchan, int ctrans, int ncoef, int n0, int n1,
    int n2, int b0, int b1, int b2) {
  constexpr int S = 2 * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int nb1 = n1 / b1, nb2 = n2 / b2;
  const int bid = blockIdx.x;
  const int p_begin = pstarts[bid];
  const int p_end = pstarts[bid + 1];
  if (p_begin == p_end) return;  // uniform across the CTA

  const Tiles tl = tiles_of<NCOMP>(M, b0, b1, b2);
  const int xrows = tl.row_tiles * kAtomRows / NCOMP, zrow = 8 * tl.z_tiles;
  const int dense = xrows + tl.pd1 + zrow;
  // The dense tap rows of the three dims lie one after another, kStride
  // doubles apart: (xrows, kStride) x, (pd1, kStride) y, (zrow, kStride) z.
  double* s_wx = reinterpret_cast<double*>(smem_raw);
  double* s_wy = s_wx + xrows * kStride;
  double* s_wz = s_wy + tl.pd1 * kStride;
  double* s_v = s_wz + zrow * kStride;                 // (ctrans, NCOMP, kStride)
  double* s_tap = s_v + ctrans * NCOMP * kStride;      // (3, S, kBatch)
  int* s_lc = reinterpret_cast<int*>(s_tap + 3 * S * kBatch);  // (3, kBatch)
  T* s_cs = reinterpret_cast<T*>(s_lc + 3 * kBatch);           // (3, S, ncoef)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  for (int i = tid; i < 3 * S * ncoef; i += blockDim.x) s_cs[i] = coefs[i];

  const int ox = (bid / (nb1 * nb2)) * b0;
  const int oy = ((bid / nb2) % nb1) * b1;
  const int oz = (bid % nb2) * b2;
  const long long gstride = (long long)n0 * n1 * n2 * NCOMP;

  // A batch's compact taps and local cells, as spread_3d_kernel's stage 1.
  auto stage_points = [&](int p0, int nb, int nbr) {
    for (int e = warp; e < 3 * S; e += nwarps) {
      const int d = e / S, tap = e - d * S;
      const T* cs_t = s_cs + e * ncoef;
      for (int p = lane; p < nbr; p += 32) {
        const long long j = (long long)p0 + p;
        double w = 0.0;
        if (p < nb)
          w = double(nufft::point_tap<S>(wtaps, cs_t, ncoef, fracs[d * np + j], np, j, d, tap));
        s_tap[e * kBatch + p] = w;
      }
    }
    for (int p = tid; p < nbr; p += blockDim.x) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        s_lc[d * kBatch + p] = p < nb ? cells[d * np + p0 + p] - (d == 0 ? ox : d == 1 ? oy : oz)
                                      : 0;
    }
  };
  // The batch's values of transforms c0 .. c0 + count - 1, every read
  // issued before the first is needed; zero past the batch's points.
  auto stage_values = [&](int c0, int count, int p0, int nb, int nbr) {
#pragma unroll 4
    for (int e = tid; e < count * nbr; e += blockDim.x) {
      const int c = e / nbr, p = e - c * nbr;
      nufft::Value<T, NCOMP> v{};
      if (p < nb) v = vals[(long long)(c0 + c) * np + p0 + p];
#pragma unroll
      for (int k = 0; k < NCOMP; ++k) s_v[(c * NCOMP + k) * kStride + p] = double(v.c[k]);
    }
  };
  // The dense tap rows of the three dims, a column a point, zero outside
  // the point's 2M taps.  A warp a row.
  auto stage_dense = [&](int nbr) {
    for (int e = warp; e < dense; e += nwarps) {
      const int d = e < xrows ? 0 : e < xrows + tl.pd1 ? 1 : 2;
      const int row = e - (d == 0 ? 0 : d == 1 ? xrows : xrows + tl.pd1);
      const int* lc = s_lc + d * kBatch;
      const double* tp = s_tap + d * S * kBatch;
      double* dst = s_wx + e * kStride;
      for (int p = lane; p < nbr; p += 32) {
        const int t = row - lc[p];
        dst[p] = (unsigned)t < (unsigned)S ? tp[t * kBatch + p] : 0.0;
      }
    }
  };

  // This CTA's transforms: cbeg .. cend - 1.  A block whose points fit one
  // batch stages them and all the group's values once; a larger one
  // restages each batch for each transform.
  const int cbeg = blockIdx.y * ctrans, cend = min(nchan, cbeg + ctrans);
  const bool once = p_end - p_begin <= kBatch;  // uniform across the CTA
  if (once) {
    const int nb = p_end - p_begin, nbr = (nb + kK - 1) / kK * kK;
    __syncthreads();  // the coefficients are in
    stage_points(p_begin, nb, nbr);
    stage_values(cbeg, cend - cbeg, p_begin, nb, nbr);
    __syncthreads();
    stage_dense(nbr);
    __syncthreads();
  }
  const int step = once ? cend - cbeg : 1;
  for (int c0 = cbeg; c0 < cend; c0 += step) {
    // Work items (unit, transform), unit fastest, dealt to the warps in
    // passes; everything an item needs is derived from it, so nothing of
    // one item's operands is held across its flush.  A restaged batch
    // (step 1) walks the units as spread_3d_kernel does.
    const int items = tl.units * step;
    for (int first = 0; first < items; first += nwarps) {
      const int item = first + warp;
      const bool active = item < items;  // uniform across the warp
      const int unit = item % tl.units, ch = item / tl.units;
      const int rt0 = (unit / tl.col_groups) * kRowTiles;
      const int ct0 = (unit % tl.col_groups) * kColTiles;
      const int nr = min(kRowTiles, tl.row_tiles - rt0);
      const int nc = min(kColTiles, tl.col_tiles - ct0);
      // Each lane's operand offsets: x row (8h + g) / NCOMP of row tile
      // r lies (r 16 + 8h) / NCOMP rows past x_row; the value component
      // is the row's (g's for complex rows); the y row j and z row l0 + g
      // of n-tile c; point t4 of a step.  Row tiles past nr are not read.
      const int x_row = (rt0 * kAtomRows + g) / NCOMP * kStride + t4;
      const double* s_vc =
          s_v + (ch * NCOMP + (NCOMP == 2 ? (g & 1) : 0)) * kStride + t4;
      int y_off[kColTiles], z_off[kColTiles];
#pragma unroll
      for (int c = 0; c < kColTiles; ++c) {
        const int ct = c < nc ? ct0 + c : 0;
        const int j = ct / tl.z_tiles;
        y_off[c] = j * kStride + t4;
        z_off[c] = (8 * (ct - j * tl.z_tiles) + g) * kStride + t4;
      }
      double acc[kColTiles][kRowTiles][2 * kHalves];
#pragma unroll
      for (int c = 0; c < kColTiles; ++c)
#pragma unroll
        for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
          for (int e = 0; e < 2 * kHalves; ++e) acc[c][r][e] = 0.0;

      for (int p0 = p_begin; p0 < p_end; p0 += kBatch) {
        const int nb = min(kBatch, p_end - p0);
        const int nbr = (nb + kK - 1) / kK * kK;
        if (!once) {
          __syncthreads();  // the coefficients are in; the last batch is done
          stage_points(p0, nb, nbr);
          stage_values(c0, 1, p0, nb, nbr);
          __syncthreads();
          stage_dense(nbr);
          __syncthreads();
        }
        if (!active) continue;

        // Row tiles outer: a row tile's A fragments are formed once a
        // k-step (x tap times value), its B fragments again for each row
        // tile; held for both row tiles beside the sums they would spill.
#pragma unroll 1
        for (int p = 0; p < nbr; p += kK) {
          double v[kQuads];
#pragma unroll
          for (int q = 0; q < kQuads; ++q) v[q] = s_vc[p + 4 * q];
#pragma unroll
          for (int r = 0; r < kRowTiles; ++r) {
            if (r >= nr) break;
            double a[kQuads * kHalves];
#pragma unroll
            for (int q = 0; q < kQuads; ++q)
#pragma unroll
              for (int h = 0; h < kHalves; ++h)
                a[q * kHalves + h] =
                    s_wx[x_row + (r * kAtomRows + 8 * h) / NCOMP * kStride + p + 4 * q] * v[q];
#pragma unroll
            for (int c = 0; c < kColTiles; ++c) {
              if (c >= nc) break;
              double b[kQuads];
#pragma unroll
              for (int q = 0; q < kQuads; ++q)
                b[q] = s_wy[y_off[c] + p + 4 * q] * s_wz[z_off[c] + p + 4 * q];
              mma_f64(acc[c][r], a, b);
            }
          }
        }
      }
      if (!active) continue;

      flush_unit<M, T, NCOMP>(acc, grid + (c0 + ch) * gstride, tl, rt0, ct0, nr, nc, g, t4,
                              ox, oy, oz, n0, n1, n2);
    }
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* vals, const void* cells, const void* fracs,
                   const void* pstarts, const void* coefs,
                   const void* wtaps, void* grid,
                   long long np, int nchan, int ncoef, int n0, int n1, int n2,
                   int b0, int b1, int b2, cudaStream_t stream) {
  // As few passes over the points as 16 warps allow, the units spread
  // evenly over them (ops/kernels/common.py:spread_tiles).
  const Tiles tl = tiles_of<NCOMP>(M, b0, b1, b2);
  const int passes = (tl.units + kMaxWarps - 1) / kMaxWarps;
  const int warps = (tl.units + passes - 1) / passes;
  const int nblocks = (n0 / b0) * (n1 / b1) * (n2 / b2);
  const auto* v = static_cast<const nufft::Value<T, NCOMP>*>(vals);
  // One transform a CTA: the per-transform kernel, a CTA a (block,
  // transform); more: the shared-staging kernel.
  const int ctrans = cta_transforms<T, NCOMP>(M, ncoef, b0, b1, b2, warps, nchan);
  if (ctrans == 1) {
    const size_t smem = spread_smem_bytes<T, NCOMP>(M, ncoef, b0, b1, b2);
    cudaError_t err = cudaFuncSetAttribute(
        spread_3d_kernel<M, T, NCOMP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    spread_3d_kernel<M, T, NCOMP><<<dim3(nblocks, nchan), 32 * warps, smem, stream>>>(
        v, static_cast<const int*>(cells), static_cast<const T*>(fracs),
        static_cast<const int*>(pstarts), static_cast<const T*>(coefs),
        static_cast<const T*>(wtaps),
        static_cast<T*>(grid), np, ncoef, n0, n1, n2, b0, b1, b2);
    return cudaGetLastError();
  }
  const size_t smem = shared_smem_bytes<T, NCOMP>(M, ncoef, b0, b1, b2, ctrans);
  cudaError_t err = cudaFuncSetAttribute(
      spread_3d_shared_kernel<M, T, NCOMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks(nblocks, (nchan + ctrans - 1) / ctrans);
  spread_3d_shared_kernel<M, T, NCOMP><<<blocks, 32 * warps, smem, stream>>>(
      v, static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const int*>(pstarts), static_cast<const T*>(coefs),
      static_cast<const T*>(wtaps),
      static_cast<T*>(grid), np, nchan, ctrans, ncoef, n0, n1, n2, b0, b1, b2);
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
// *_f32, double for *_f64.  One transform a CTA runs spread_3d_kernel,
// more spread_3d_shared_kernel (cta_transforms).  Launches on `stream`, does not synchronise,
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
