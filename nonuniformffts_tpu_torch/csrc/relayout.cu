// K8a / K8b: the block-interleave relayout between the grid layout
// (CR, N0, N1, N2) and the block-major layout (CR, nb0, nb1, nb2, B0, B1, B2),
// N_d = nb_d * B_d:
//
//   nufft_relayout_to_grid_<type>    block-major -> grid   (K8a)
//   nufft_relayout_to_blocks_<type>  grid -> block-major   (K8b)
//
// <type> is f32 (complex64, moved as float2) or f64 (complex128, double2):
// each value moves whole, 8 or 16 bytes.  The transposes move spectra, which
// are complex for real-data plans too (after the r2c), so there is no real
// entry point: build.py's NUFFT_ONLY 0 and 1 carry these, 2 and 3 none.
//
// Replaces nonuniformffts_tpu/ops/pallas/common.py:relayout_to_grid_pallas
// (:438) and relayout_to_blocks_pallas (:490).  In the port they are the
// pack and unpack around the slab transposes of the spatial mode
// (parallel/spatial.py): a dim-0-sharded slab (C, N0l, K1, K2) is packed
// rank-major with block dims (N0l, K1/n, K2), nb = (1, n, 1) before an
// all_to_all, and unpacked after one.  A 2D relayout is the 3D one with
// nb0 = B0 = 1; a 1D relayout is a free reshape (the wrapper launches
// nothing).
//
// - The grid side is walked in rows (c, g0, g1): blockIdx.y picks a run of
//   at least 8 consecutive rows and thread x the column g2.  The grid side
//   is then read or written fully coalesced; the block side in contiguous
//   runs of B2 elements (coalesced where a run spans a 32-byte sector: B2 of
//   at least 4 complex64 values).  A thread divides once, for its first row;
//   from one row to the next both offsets advance by additions, since a copy
//   has no instructions to spare for a division per element.
// - No shared memory: a tiled transpose pays only where B2 is shorter than a
//   sector, which the slab shapes never are (B2 = K2).  Keeping several
//   rows' loads in flight a thread was tried and measured slower than one
//   row at a time (PERF.md).
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once: 2 x 8 B per complex64 value over 3.35 TB/s.
#include <cuda_runtime.h>

#ifdef NUFFT_ONLY
#define NUFFT_WANT(IDX) (NUFFT_ONLY == (IDX))
#else
#define NUFFT_WANT(IDX) 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 65535;
// Grid rows a CTA walks at least: the divisions are paid once per CTA and
// column.
constexpr int kMinRowsPerCta = 8;

struct Geometry {
  long long rows;       // CR * N0 * N1
  int rows_per_cta;     // consecutive grid rows one CTA walks
  int n1, n2;           // grid dims 1 and 2
  int b0, b1, b2;       // block dims
  long long blk1_step;  // block-side offset of one block along dim 1: nb2 B0 B1 B2
  long long blk0_step;  // one block along dim 0: nb1 * blk1_step
};

template <typename T, bool kToGrid>
__global__ void __launch_bounds__(kThreads) relayout_kernel(
    const T* __restrict__ src, T* __restrict__ dst, const Geometry g) {
  const int g2 = blockIdx.x * kThreads + threadIdx.x;
  if (g2 >= g.n2) return;
  const long long row0 = (long long)blockIdx.y * g.rows_per_cta;
  const long long row_end = row0 + g.rows_per_cta < g.rows ? row0 + g.rows_per_cta : g.rows;
  // Row r = (c N0 + g0) N1 + g1.  Block-major offset of (c, g0, g1, g2):
  // ((c nb0 + blk0) nb1 + blk1) blk1_step + blk2 B0 B1 B2 + (l0 B1 + l1) B2
  // + l2, and (c nb0 + blk0) nb1 blk1_step = (c N0 + g0 - l0) / B0 blk0_step.
  const long long plane = row0 / g.n1;  // c N0 + g0
  int g1 = (int)(row0 - plane * g.n1);
  int l0 = (int)(plane % g.b0), l1 = g1 % g.b1;
  const int blk2 = g2 / g.b2;
  const long long sl0 = (long long)g.b1 * g.b2;
  long long blk_off = (plane - l0) / g.b0 * g.blk0_step + (g1 / g.b1) * g.blk1_step +
                      blk2 * (long long)g.b0 * sl0 + l0 * sl0 + (long long)l1 * g.b2 +
                      (g2 - blk2 * g.b2);
  long long grid_off = row0 * g.n2 + g2;
  for (long long row = row0; row < row_end; ++row) {
    if (kToGrid) dst[grid_off] = src[blk_off];
    else dst[blk_off] = src[grid_off];
    grid_off += g.n2;
    blk_off += g.b2;
    if (++l1 == g.b1) { l1 = 0; blk_off += g.blk1_step - sl0; }
    if (++g1 == g.n1) {  // next plane: back to block 0 along dim 1
      g1 = 0;
      blk_off += sl0 - g.blk0_step;
      if (++l0 == g.b0) { l0 = 0; blk_off += g.blk0_step - (long long)g.b0 * sl0; }
    }
  }
}

template <typename T, bool kToGrid>
int launch(const void* src, void* dst, int cr, int n0, int n1, int n2, int b0,
           int b1, int b2, void* stream) {
  if (cr < 0 || b0 < 1 || b1 < 1 || b2 < 1 || n0 % b0 || n1 % b1 || n2 % b2)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.rows = (long long)cr * n0 * n1;
  if (g.rows == 0 || n2 == 0) return (int)cudaSuccess;
  g.n1 = n1; g.n2 = n2;
  g.b0 = b0; g.b1 = b1; g.b2 = b2;
  g.blk1_step = (long long)(n2 / b2) * b0 * b1 * b2;
  g.blk0_step = (long long)(n1 / b1) * g.blk1_step;
  const long long need = (g.rows + kMaxRowBlocks - 1) / kMaxRowBlocks;
  g.rows_per_cta = (int)(need > kMinRowsPerCta ? need : kMinRowsPerCta);
  const dim3 grid((n2 + kThreads - 1) / kThreads,
                  (unsigned)((g.rows + g.rows_per_cta - 1) / g.rows_per_cta));
  relayout_kernel<T, kToGrid><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), g);
  return (int)cudaGetLastError();
}

}  // namespace

// to_grid: src (cr, nb0, nb1, nb2, b0, b1, b2), dst (cr, n0, n1, n2);
// to_blocks: the reverse.  Both contiguous, of the entry point's type,
// aligned to the element's size.  Launches on `stream`, does not
// synchronise, allocates nothing; returns the launch's cudaError_t.
#define NUFFT_RELAYOUT_ENTRIES(SUFFIX, T)                                         \
  extern "C" int nufft_relayout_to_grid_##SUFFIX(                                 \
      const void* src, void* dst, int cr, int n0, int n1, int n2, int b0, int b1, \
      int b2, void* stream) {                                                     \
    return launch<T, true>(src, dst, cr, n0, n1, n2, b0, b1, b2, stream);         \
  }                                                                               \
  extern "C" int nufft_relayout_to_blocks_##SUFFIX(                               \
      const void* src, void* dst, int cr, int n0, int n1, int n2, int b0, int b1, \
      int b2, void* stream) {                                                     \
    return launch<T, false>(src, dst, cr, n0, n1, n2, b0, b1, b2, stream);        \
  }

#if NUFFT_WANT(0)
NUFFT_RELAYOUT_ENTRIES(f32, float2)
#endif
#if NUFFT_WANT(1)
NUFFT_RELAYOUT_ENTRIES(f64, double2)
#endif
