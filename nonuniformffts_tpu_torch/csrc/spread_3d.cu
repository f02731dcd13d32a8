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
// - One transform a CTA (spread_3d_kernel): persistent CTAs, as many as
//   the SMs keep resident (the register file: two of 8 warps at the main
//   paths' blocks), which take the (block, transform) items in launch order
//   (item = transform nblocks + block) from a counter of the launch, one
//   at a time as each needs one, so that the CTAs at work at one time hold
//   neighbouring blocks and flush their shared halos while L2 holds them
//   (a fixed deal, CTA k taking items k, k + G, .., let the CTAs drift
//   apart, and with the halos out of L2 a sparse grid spread slower than
//   one CTA a block).  A block's points are a contiguous range of the
//   bin-sorted arrays (pstarts); an empty block is skipped without a
//   barrier.  With
//   padded dims pd = B + 2M - 1, the block's sum is
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
// - Points come in batches of 64, and the CTA's batches form one chain:
//   the next batch is the block's next 64 points, its first batch again
//   for the next pass, or the first batch of the CTA's next non-empty
//   block.  The batches are software-pipelined over two buffers of dense
//   operands: before a batch's k-steps each thread issues cp.async copies
//   of the next batch's point state for its slots (a slot: one point and
//   one task, a task: a dim's rows, the x dim's split in two halves for
//   the Horner window) - its cells, fractions or window-weights taps
//   (wtaps) and, for an x task, its value; after its k-steps and, where
//   the block ends, the flush (whose reductions go out fire-and-forget;
//   the walk's state waits in shared memory meanwhile, so that the flush
//   has the registers without spilling) it waits for its own copies and
//   builds its slots' columns of the next
//   batch's dense operands in the free buffer: A's rows and the y and z
//   taps at every padded row, zero outside the point's taps (Horner in T on
//   the staged coefficient stack for (B)KB FastApproximation, four or two
//   taps' chains advancing together on its coefficient-major copy, else
//   the copied taps; widened to double).  So the copies' latency runs under
//   the k-steps, a warp that is done with its k-steps builds while the
//   others still contract, and one __syncthreads a batch hands both
//   buffers over (three a batch before).  Every warp both contracts and
//   builds: a staging warpgroup would need registers that the 16 MMA warps
//   an SM at 128 registers already take (65,536).  Where two buffers do not
//   fit beside the CTAs that the register file keeps resident
//   (spread_buffers), one does: the build then waits for every warp's
//   k-steps, and only the copies overlap them.  A device counter adds the
//   batches each CTA staged and those it staged while another's k-steps
//   ran (nufft_spread_3d_batches_*).  The operands, the k order and the
//   double products and sums are the one-CTA-a-block design's: a block's
//   sums are unchanged, and the grid differs only in the order of the
//   atomic adds across blocks.
// - Operand rows lie kStride doubles apart, points the fastest index, so a
//   slot's stores of one row hit consecutive words across the warp's lanes
//   and a fragment's 8 rows x 4 points fall on distinct bank pairs.
// - Each warp walks a batch eight points (one k = 8 step) at a time.  Its
//   lanes' operand offsets are fixed for the unit, so a step is shared
//   loads of the A fragments (serving the unit's 4 n-tiles), two loads and
//   a multiply per B fragment element (serving its row tiles) and the
//   MMAs: no index arithmetic, no branch on the data, no shared-memory
//   atomic.
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
// the latency of each batch's short phases weighed about as much as the
// MMAs (chip_probe.py --spread3d-parts, PERF.md): the one-transform kernel
// runs them beside the k-steps of the batch before; the shared kernel pays
// them once a block and group rather than once a transform, which leaves it
// the
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
#include <climits>
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

// Tasks of the slots of one batch's build (spread_3d_kernel): for the
// Horner window the x dim's padded cells in two halves, y and z; for
// window-weights taps, whose S taps a slot copies, x, y and z.
__host__ __device__ inline int build_tasks(bool tapped) { return tapped ? 3 : 4; }

// Must match ops/kernels/common.py:spread_smem_bytes (3D, one transform a
// CTA): `nbuf` buffers of one batch's dense operands (A's rows, the y and z
// taps at every padded row, a column a point, rows kStride doubles apart),
// the copies of one batch's point state, a slot each (the values of the x
// tasks, then the fractions of every task, or the (3, 2M) window-weights
// taps, in T, then the int32 cells of every task), then the coefficient
// stack in T, coefficient-major: (3, ncoef, 2M).  ncoef = 0: taps from
// window_weights.cu.
template <typename T, int NCOMP>
size_t spread_smem_bytes(int m, int ncoef, int b0, int b1, int b2, int nbuf) {
  const Tiles t = tiles_of<NCOMP>(m, b0, b1, b2);
  const size_t s = 2 * m;
  const size_t dense = (size_t)t.row_tiles * kAtomRows + t.pd1 + 8 * t.z_tiles;
  const size_t tasks = build_tasks(ncoef == 0);
  const size_t state = (tasks - 2) * sizeof(nufft::Value<T, NCOMP>) + tasks * sizeof(int) +
                       sizeof(T) * (ncoef == 0 ? 3 * s : tasks);
  return sizeof(double) * kStride * dense * nbuf + state * kBatch + sizeof(T) * 3 * s * ncoef;
}

// Dense operand buffers of one spread_3d_kernel CTA of `warps` warps (must
// match ops/kernels/common.py:spread3d_buffers): two where they fit beside
// the CTAs that the register file keeps resident an SM at kMaxRegs a
// thread, else one.
template <typename T, int NCOMP>
int spread_buffers(int m, int ncoef, int b0, int b1, int b2, int warps) {
  const int ctas = std::max(1, kSmRegs / (kMaxRegs * 32 * warps));
  const size_t budget = std::min(kMaxSmem, kSmSmem / ctas - kCtaReserved);
  return spread_smem_bytes<T, NCOMP>(m, ncoef, b0, b1, b2, 2) <= budget ? 2 : 1;
}

// The constants of one spread_3d_kernel launch, computed by its launch and
// read from the kernel's parameter space, so that none of them holds a
// register across the k-steps, the flush and the build.
struct Launch {
  Tiles tl;
  int nb1, nb2, nblocks, items;  // blocks along y and z; blocks; (block, transform) items
  int rows, dense, passes;       // A's rows; a buffer's dense rows; passes over the units
  int tasks, xhalf, nbuf;        // build tasks; where the x tasks split; operand buffers
  int off_v, off_f, off_c, off_cs;  // shared-memory byte offsets of the copies, the stack
};

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

// The batches and the batches staged while another batch's k-steps ran, of
// every spread_3d_kernel launch since the library was loaded: each CTA adds
// its counts once, at its end (nufft_spread_3d_batches_*).
__device__ unsigned long long g_batches[2];

// One batch of a CTA's walk: points p0 .. min(p0 + kBatch, pend) - 1 of
// item `item`'s block (item = transform nblocks + block; its points end at
// pend), in pass `pass` over the block's units; item < 0: none.
struct Batch {
  int item, pass, p0, pend;
};

template <int M, typename T, int NCOMP>
__global__ void __launch_bounds__(kMaxWarps * 32) spread_3d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ vals, const int* __restrict__ cells,
    const T* __restrict__ fracs, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    T* __restrict__ grid, int* __restrict__ work, long long np, int ncoef, int n0, int n1,
    int n2, int b0, int b1, int b2, const Launch L) {
  using V = nufft::Value<T, NCOMP>;
  constexpr int S = 2 * M;
  constexpr int kTaps = S % 4 == 0 ? 4 : 2;  // taps a build step evaluates together
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const Tiles tl = L.tl;
  const int nb1 = L.nb1, nb2 = L.nb2, nblocks = L.nblocks, items = L.items, ctas = gridDim.x;
  const int rows = L.rows, dense = L.dense, tasks = L.tasks, xhalf = L.xhalf, nbuf = L.nbuf;
  const bool tapped = wtaps != nullptr;
  // (nbuf, dense, kStride): A's rows, then the y and z taps, a buffer each.
  double* s_dense = reinterpret_cast<double*>(smem_raw);
  V* s_v = reinterpret_cast<V*>(smem_raw + L.off_v);    // (tasks - 2, kBatch)
  T* s_f = reinterpret_cast<T*>(smem_raw + L.off_f);    // (tasks, kBatch) or (3, S, kBatch)
  int* s_c = reinterpret_cast<int*>(smem_raw + L.off_c);  // (tasks, kBatch)
  T* s_cs = reinterpret_cast<T*>(smem_raw + L.off_cs);  // (3, ncoef, S): coefficient-major

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int passes = L.passes;

  // The walk.  Thread 0 hands the CTA its items in launch order from the
  // launch's counter `work` (so that the CTAs at work at one time hold
  // neighbouring blocks, whose halos their flushes share in L2), an item
  // ahead: as the walk enters an item it takes the next index, and after
  // the batch's k-steps it resolves it, past empty blocks, to the next
  // non-empty item and its point range, {item, pbeg, pend} in slot `side`
  // of s_ahead (item -1: none left), which the walk reads as it leaves the
  // item.  s_ahead lies in the 4 doubles past the batch of buffer 0's first
  // row, which no k-step reads and no build writes.
  int* s_ahead = reinterpret_cast<int*>(s_dense + kBatch);
  // Thread 0: index it, whose block's pstarts pb, pe (read when it < items)
  // are on their way, or the next non-empty item past it, into dst.
  auto resolve = [&](int it, int pb, int pe, int* dst) {
    while (it < items && pb == pe) {
      it = atomicAdd(work, 1);
      if (it < items) {
        pb = pstarts[it % nblocks];
        pe = pstarts[it % nblocks + 1];
      }
    }
    dst[0] = it < items ? it : -1;
    dst[1] = pb;
    dst[2] = pe;
  };
  auto take = [&](int* dst) {
    const int it = atomicAdd(work, 1);
    resolve(it, it < items ? pstarts[it % nblocks] : 0,
            it < items ? pstarts[it % nblocks + 1] : 0, dst);
  };
  int side = 0;  // parity of the items the walk entered: s_ahead's slot
  auto next_batch = [&](const Batch& b) -> Batch {
    if (b.p0 + kBatch < b.pend) return {b.item, b.pass, b.p0 + kBatch, b.pend};
    if (b.pass + 1 < passes) return {b.item, b.pass + 1, pstarts[b.item % nblocks], b.pend};
    const int* a = s_ahead + 3 * side;
    return {a[0], 0, a[1], a[2]};
  };

  // The slots of this thread: q = tid, tid + blockDim.x, .. < tasks kBatch,
  // task q / kBatch and point q % kBatch of the batch (a warp's slots share
  // a task).  Task k: dim d = max(0, k - (tasks - 3)), padded cells
  // [lo, hi) along it (the x halves for the Horner window).
  auto task_dim = [&](int k) { return max(0, k - (tasks - 3)); };
  // Issues the copies of batch b's point state for this thread's slots.
  auto issue = [&](const Batch& b) {
    const int nb = min(kBatch, b.pend - b.p0);
    const V* vrow = vals + (long long)(b.item / nblocks) * np;
    for (int q = tid; q < tasks * kBatch; q += blockDim.x) {
      const int k = q / kBatch, p = q - k * kBatch, d = task_dim(k);
      if (p >= nb) continue;
      const long long j = (long long)b.p0 + p;
      nufft::cp_async<4>(s_c + q, cells + d * np + j);
      if (tapped) {
#pragma unroll
        for (int t = 0; t < S; ++t)
          nufft::cp_async<sizeof(T)>(s_f + (d * S + t) * kBatch + p, wtaps + (d * S + t) * np + j);
      } else {
        nufft::cp_async<sizeof(T)>(s_f + q, fracs + d * np + j);
      }
      if (d == 0) nufft::cp_async<sizeof(V)>(s_v + q, vrow + j);
    }
    nufft::cp_async_commit();
  };
  // Builds batch b's dense operands into dst from this thread's copies:
  // slot (task, p) writes point p's column of its task's rows (A's: the
  // value times the x tap, NCOMP rows a padded cell; else the tap), zero
  // outside the point's 2M taps and, up to whole k-steps, past the batch's
  // points.  The products are the double products of the staged compact
  // taps and values.
  auto build = [&](const Batch& b, double* dst) {
    const int nb = min(kBatch, b.pend - b.p0), nbr = (nb + kK - 1) / kK * kK;
    const int bid = b.item % nblocks;
    const int ox = (bid / (nb1 * nb2)) * b0, oy = ((bid / nb2) % nb1) * b1,
              oz = (bid % nb2) * b2;
    for (int q = tid; q < tasks * kBatch; q += blockDim.x) {
      const int k = q / kBatch, p = q - k * kBatch, d = task_dim(k);
      if (p >= nbr) continue;
      const int per = d == 0 ? NCOMP : 1;  // rows a padded cell
      const int pd = d == 0 ? tl.pd0 : d == 1 ? tl.pd1 : tl.pd2;
      const int lo = k == 1 && tasks == 4 ? xhalf : 0;
      const int hi = k == 0 && tasks == 4 ? xhalf : pd;
      double* col = dst + (d == 0 ? 0 : d == 1 ? rows : rows + tl.pd1) * kStride + p;
      int lc = pd;  // past the batch's points: every row zero
      double v[NCOMP];
#pragma unroll
      for (int c = 0; c < NCOMP; ++c) v[c] = 1.0;
      if (p < nb) {
        lc = s_c[q] - (d == 0 ? ox : d == 1 ? oy : oz);
        if (d == 0) {
          const V val = s_v[q];
#pragma unroll
          for (int c = 0; c < NCOMP; ++c) v[c] = double(val.c[c]);
        }
      }
      for (int i = lo * per; i < min(hi, lc) * per; ++i) col[i * kStride] = 0.0;
      if (p < nb) {
        // kTaps taps at a time, their Horner chains advancing together on
        // the coefficient-major stack (horner_tap's FMAs, a tap each).
        const T z = tapped ? T(0) : T(2) * s_f[q] - T(1);
        const T* cs = s_cs + d * ncoef * S;
#pragma unroll 1
        for (int t0 = 0; t0 < S; t0 += kTaps) {
          if (lc + t0 + kTaps <= lo || lc + t0 >= hi) continue;
          T w[kTaps];
          if (tapped) {
#pragma unroll
            for (int u = 0; u < kTaps; ++u) w[u] = s_f[(d * S + t0 + u) * kBatch + p];
          } else {
#pragma unroll
            for (int u = 0; u < kTaps; ++u) w[u] = cs[(ncoef - 1) * S + t0 + u];
            for (int c = ncoef - 2; c >= 0; --c)
#pragma unroll
              for (int u = 0; u < kTaps; ++u) w[u] = nufft::fma_t(w[u], z, cs[c * S + t0 + u]);
          }
#pragma unroll
          for (int u = 0; u < kTaps; ++u) {
            const int i = lc + t0 + u;
            if (i < lo || i >= hi) continue;
            double* row = col + i * per * kStride;
#pragma unroll
            for (int c = 0; c < NCOMP; ++c)
              if (c < per) row[c * kStride] = d == 0 ? double(w[u]) * v[c] : double(w[u]);
          }
        }
      }
      for (int i = max(lo, lc + S) * per; i < hi * per; ++i) col[i * kStride] = 0.0;
    }
  };

  // The coefficients and the dense buffers (whose padding rows stay zero);
  // then the CTA's first item (slot 1) and the one after it (slot 0).
  for (int i = tid; i < 3 * S * ncoef; i += blockDim.x) {
    const int d = i / (S * ncoef), t = i / ncoef - d * S, c = i % ncoef;
    s_cs[(d * ncoef + c) * S + t] = coefs[i];
  }
  for (int i = tid; i < nbuf * dense * kStride; i += blockDim.x) s_dense[i] = 0.0;
  __syncthreads();
  if (tid == 0) {
    take(s_ahead + 3);
    if (s_ahead[3] >= 0) take(s_ahead);
  }
  __syncthreads();
  if (s_ahead[3] < 0) return;  // uniform across the CTA
  Batch cur{s_ahead[3], 0, s_ahead[4], s_ahead[5]};
  issue(cur);
  nufft::cp_async_wait_all();
  build(cur, s_dense);
  __syncthreads();

  double acc[kColTiles][kRowTiles][2 * kHalves];
#pragma unroll
  for (int c = 0; c < kColTiles; ++c)
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
      for (int e = 0; e < 2 * kHalves; ++e) acc[c][r][e] = 0.0;

  int buf = 0;
  unsigned staged = 1;
  int cand = 0;  // thread 0: the counter's index taken as the walk entered an item
  int cand_b = 0, cand_e = 0;  // thread 0: its block's pstarts
  while (true) {
    Batch nxt = next_batch(cur);
    bool more = nxt.item >= 0;
    bool enters = more && nxt.item != cur.item;
    if (enters) {
      side ^= 1;
      if (tid == 0) cand = atomicAdd(work, 1);  // resolved after the k-steps
    }
    if (more) issue(nxt);  // lands while this batch's k-steps run
    const bool unit_end = !more || nxt.item != cur.item || nxt.pass != cur.pass;
    // The warp's unit in this batch's pass: its row tiles and n-tiles, and
    // each lane's operand offsets (A row 8h + g of row tile r, the y row j
    // and z row l0 + g of n-tile c; point t4 of a step), derived here so
    // that nothing of them is held across the flush and the build.
    const int unit = cur.pass * nwarps + warp;
    const bool active = unit < tl.units;  // uniform across the warp
    if (active) {
      const int rt0 = (unit / tl.col_groups) * kRowTiles;
      const int ct0 = (unit % tl.col_groups) * kColTiles;
      const int nr = min(kRowTiles, tl.row_tiles - rt0);
      const int nc = min(kColTiles, tl.col_tiles - ct0);
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
      const int nbr = (min(kBatch, cur.pend - cur.p0) + kK - 1) / kK * kK;
      const double* s_a = s_dense + buf * dense * kStride;
      const double* s_wy = s_a + rows * kStride;
      const double* s_wz = s_wy + tl.pd1 * kStride;
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
    if (active && unit_end) {
      // Flush: each lane's sums into the transform's grid (flush_unit),
      // fire-and-forget, and zeroed sums for the next unit.  The walk's
      // state waits in the 4 doubles past the batch of buffer 0's row
      // 1 + warp meanwhile, so that the flush has the registers to itself.
      int* keep = reinterpret_cast<int*>(s_dense + (1 + warp) * kStride + kBatch);
      if (lane == 0) {
        keep[0] = nxt.item;
        keep[1] = nxt.pass;
        keep[2] = nxt.p0;
        keep[3] = nxt.pend;
        keep[4] = (int)staged;
        keep[5] = cand;
        keep[6] = int(more) | int(enters) << 1 | side << 2 | buf << 3;
      }
      const int rt0 = (unit / tl.col_groups) * kRowTiles;
      const int ct0 = (unit % tl.col_groups) * kColTiles;
      const int bid = cur.item % nblocks;
      flush_unit<M, T, NCOMP>(acc, grid + (long long)(cur.item / nblocks) * n0 * n1 * n2 * NCOMP,
                              tl, rt0, ct0, min(kRowTiles, tl.row_tiles - rt0),
                              min(kColTiles, tl.col_tiles - ct0), g, t4, (bid / (nb1 * nb2)) * b0,
                              ((bid / nb2) % nb1) * b1, (bid % nb2) * b2, n0, n1, n2);
#pragma unroll
      for (int c = 0; c < kColTiles; ++c)
#pragma unroll
        for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
          for (int e = 0; e < 2 * kHalves; ++e) acc[c][r][e] = 0.0;
      __syncwarp();
      nxt = {keep[0], keep[1], keep[2], keep[3]};
      staged = (unsigned)keep[4];
      cand = keep[5];
      const int bits = keep[6];
      more = bits & 1;
      enters = bits >> 1 & 1;
      side = bits >> 2 & 1;
      buf = bits >> 3 & 1;
    }
    if (enters && tid == 0 && cand < items) {  // read under the build
      cand_b = pstarts[cand % nblocks];
      cand_e = pstarts[cand % nblocks + 1];
    }
    if (more) {
      if (nbuf == 1) __syncthreads();  // every warp is done with the one buffer
      buf = nbuf - 1 - buf;
      nufft::cp_async_wait_all();
      build(nxt, s_dense + buf * dense * kStride);
    }
    if (enters && tid == 0) resolve(cand, cand_b, cand_e, s_ahead + 3 * side);
    if (!more) break;
    __syncthreads();  // the next batch is built; this one's k-steps are done
    cur = nxt;
    ++staged;
  }
  if (tid == 0) {
    atomicAdd(&g_batches[0], (unsigned long long)staged);
    atomicAdd(&g_batches[1], nbuf == 2 ? staged - 1ull : 0ull);
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
                   const void* wtaps, void* grid, void* work,
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
    // As many persistent CTAs as the SMs keep resident, at most one a
    // (block, transform) item.
    const long long items = (long long)nblocks * nchan;
    if (items > INT_MAX / 2) return cudaErrorInvalidValue;
    Launch L;
    L.tl = tl;
    L.nb1 = n1 / b1;
    L.nb2 = n2 / b2;
    L.nblocks = nblocks;
    L.items = (int)items;
    L.rows = tl.row_tiles * kAtomRows;
    L.dense = L.rows + tl.pd1 + 8 * tl.z_tiles;
    L.passes = passes;
    L.tasks = build_tasks(ncoef == 0);
    L.xhalf = (tl.pd0 + 1) / 2;
    L.nbuf = spread_buffers<T, NCOMP>(M, ncoef, b0, b1, b2, warps);
    // The layout of spread_smem_bytes: the buffers, the values, the
    // fractions or taps, the cells, the coefficients.
    L.off_v = (int)(sizeof(double) * kStride * L.dense * L.nbuf);
    L.off_f = L.off_v + (int)sizeof(nufft::Value<T, NCOMP>) * (L.tasks - 2) * kBatch;
    L.off_c = L.off_f + (int)sizeof(T) * (ncoef == 0 ? 3 * 2 * M : L.tasks) * kBatch;
    L.off_cs = L.off_c + (int)sizeof(int) * L.tasks * kBatch;
    const size_t smem = spread_smem_bytes<T, NCOMP>(M, ncoef, b0, b1, b2, L.nbuf);
    const auto kernel = spread_3d_kernel<M, T, NCOMP>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem);
    if (err != cudaSuccess) return err;
    const int ctas = (int)std::min<long long>(items, (long long)std::max(1, per_sm) * sms);
    kernel<<<ctas, 32 * warps, smem, stream>>>(
        v, static_cast<const int*>(cells), static_cast<const T*>(fracs),
        static_cast<const int*>(pstarts), static_cast<const T*>(coefs),
        static_cast<const T*>(wtaps),
        static_cast<T*>(grid), static_cast<int*>(work), np, ncoef, n0, n1, n2, b0, b1, b2, L);
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
             const void* wtaps, void* grid, void* work, long long np,
             int nchan, int m, int ncoef, int n0, int n1, int n2, int b0,
             int b1, int b2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_SPREAD_CASE(MM)                                                \
  case MM:                                                                   \
    return (int)launch<MM, T, NCOMP>(vals, cells, fracs, pstarts, coefs,     \
                                     wtaps, grid, work, np, nchan, ncoef, n0, \
                                     n1, n2, b0, b1, b2, s);
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
// grid (nchan, n0, n1, n2) values, zeroed by the caller; work one int32,
// zeroed by the caller, the counter from which spread_3d_kernel's CTAs take
// their items (unread by spread_3d_shared_kernel).  T is float for *_f32,
// double for *_f64.  One transform a CTA runs spread_3d_kernel, more
// spread_3d_shared_kernel (cta_transforms).  Launches on `stream`, does not
// synchronise, allocates nothing.  nufft_spread_3d_batches_*: copies the value type's
// spread_3d_kernel batch counts (staged; staged while another batch's
// k-steps ran) into counts[2], waiting for the device.
#define NUFFT_SPREAD_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* vals, const void* cells, const void* fracs, \
                      const void* pstarts, const void* coefs,                 \
                      const void* wtaps, void* grid, void* work,              \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      int n1, int n2, int b0, int b1, int b2, void* stream) { \
    return dispatch<T, NCOMP>(vals, cells, fracs, pstarts, coefs, wtaps, grid,  \
                              work, np, nchan, m, ncoef, n0, n1, n2, b0, b1,  \
                              b2, stream);                                    \
  }

#define NUFFT_BATCHES_ENTRY(NAME)                                              \
  extern "C" int NAME(unsigned long long* counts) {                           \
    return (int)cudaMemcpyFromSymbol(counts, g_batches, sizeof(g_batches));    \
  }

#if NUFFT_WANT(0)
NUFFT_SPREAD_ENTRY(nufft_spread_3d_f32, float, 2)
NUFFT_BATCHES_ENTRY(nufft_spread_3d_batches_f32)
#endif
#if NUFFT_WANT(1)
NUFFT_SPREAD_ENTRY(nufft_spread_3d_f64, double, 2)
NUFFT_BATCHES_ENTRY(nufft_spread_3d_batches_f64)
#endif
#if NUFFT_WANT(2)
NUFFT_SPREAD_ENTRY(nufft_spread_3d_real_f32, float, 1)
NUFFT_BATCHES_ENTRY(nufft_spread_3d_batches_real_f32)
#endif
#if NUFFT_WANT(3)
NUFFT_SPREAD_ENTRY(nufft_spread_3d_real_f64, double, 1)
NUFFT_BATCHES_ENTRY(nufft_spread_3d_batches_real_f64)
#endif
