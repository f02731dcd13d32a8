// set_points' two passes around its one stable sort, on the blocked path:
//
//   nufft_bin_keys_<type>      raw points -> the int32 bin key of each point
//                              and, in 2D and 3D, the point's coordinates
//                              packed into one record
//   nufft_sorted_state_<type>  sorted keys, the sort's permutation and the
//                              records (in 1D the raw points) -> sorted
//                              cells, sorted fractions and the per-block
//                              point ranges (pstarts)
//
// <type> is f32 or f64, the coordinates' (and the fractions') type.
// build.py's NUFFT_ONLY 2 (float32) and 3 (float64) carry them, 0 and 1 none.
//
// Replaces no TPU kernel: the JAX package's set_points is jnp arithmetic and
// one lax.sort (nonuniformffts_tpu/blocking.py:packed_layout).  Its plain
// version is the torch chain in blocking.py (cells_and_fracs, bin_order,
// sorted_copies), which CPU plans run and which the card test holds these
// kernels to, equal under torch.equal.  They were added because that chain
// took 7.1 device ms a step at 16.8M points in 3D, about 6x its bytes, in
// some twenty passes of split, key, histogram, prefix sum and gathers, and
// made the host wait on the card three times a step (its histogram,
// bincount, read the ids' least and largest values to the host).
//
// What bounds them on the H100: bytes, and in the sorted state the number
// of places it reads at random.  The keys read D coordinates and write 4
// bytes a point (and the record); the sorted state reads a key, the
// permutation and one point's coordinates at a random place, and writes D
// cells and D fractions a point.  The design moves no other byte:
//
// - One key a point holds everything the sort needs and everything the
//   cells need: key = bid * cells_per_block + lcell, the block id and the
//   local cell of the folded cell, row-major, as cell_keys forms it.  So
//   the sorted cells are decoded from the sorted keys and never gathered,
//   and no unsorted cells, fractions or block ids are stored.
// - The gather through the permutation reads each point at a random place,
//   a DRAM access a coordinate when the coordinates lie in D arrays.  The
//   key pass therefore packs a point's coordinates into one record of 8, 16
//   or 32 bytes (2D float, 2D double or 3D float, 3D double, padded), so
//   that the gather reads one sector a point, not D: at 16.8M points in 3D
//   double the sorted state took 0.82 ms with the records and 1.85 ms
//   gathering from the D arrays, for 0.22 ms more in the key pass
//   (PERF.md).  1D reads the raw points, one sector either way.
// - The fraction is recomputed from the gathered raw coordinate by the same
//   device function as the key's cell: one IEEE multiply by the host's
//   N / 2pi and one subtract of the floor, each by an _rn intrinsic, so that
//   no FMA contraction can make them differ from the plain version's two
//   passes: the sorted state equals it bit for bit.
// - The fold takes floor(r) mod N by a multiply with 1 / N in double and
//   one correction, where r lies outside [0, N): a 64-bit integer remainder
//   a dimension cost the key pass half its time on points that had moved
//   out of [0, 2pi).
// - pstarts needs no histogram: block b starts at the first sorted key of
//   block b or above, so a thread a block finds it by a binary search over
//   the sorted keys (as blocking.py:block_starts does).  Clustered points
//   cost it nothing more: a fill from the block boundaries left one thread
//   to write every empty block's start where the points sat in one block.
//   Nothing is read back to the host.
#include <cuda_runtime.h>

#include <cstdint>

#ifdef NUFFT_ONLY
#define NUFFT_WANT(IDX) (NUFFT_ONLY == (IDX))
#else
#define NUFFT_WANT(IDX) 1
#endif

// The grid and its blocks as the caller gives them
// (ops/kernels/build.py:BinGeometry): dims past ndim are ignored.
struct BinGeometry {
  int ndim;
  int n[3];          // oversampled grid dims
  int b[3];          // block dims, each dividing its grid dim
  double scale[3];   // N / 2pi a dim, in float64 (ops/windows.py:cell_scale)
};

namespace {

constexpr int kThreads = 256;

// BinGeometry with what the kernels derive from it.
struct Bins {
  int n[3], b[3], nb[3];
  double scale[3], inv_n[3];
  int cells_per_block;
  int nblocks;
};

// A point's coordinates in one record: D of them, padded to 4 in 3D.
template <int D>
constexpr int kRecord = D == 3 ? 4 : D;

template <typename T, int L>
struct alignas(sizeof(T) * L) Record {
  T c[L];
};

// r = x N / 2pi in float64: one rounding, never fused with what follows.
template <typename T>
__device__ __forceinline__ double scaled(T x, double scale) {
  return __dmul_rn(static_cast<double>(x), scale);
}

// The folded cell of r in [0, n): floor(r) mod n, non-negative.  Below
// 2^52 cells q = floor(f / n) is at most one off, and f - q n is exact.
__device__ __forceinline__ int folded_cell(double r, int n, double inv_n) {
  const double f = floor(r);
  if (f >= 0.0 && f < n) return static_cast<int>(f);
  if (fabs(f) < 0x1p52) {
    double c = f - floor(f * inv_n) * n;
    c = c < 0.0 ? c + n : (c >= n ? c - n : c);
    return static_cast<int>(c);
  }
  const long long c = static_cast<long long>(f) % n;
  return static_cast<int>(c < 0 ? c + n : c);
}

// The in-cell fraction r - floor(r), rounded once to T.
template <typename T>
__device__ __forceinline__ T cell_fraction(double r) {
  return static_cast<T>(__dsub_rn(r, floor(r)));
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    bin_keys_kernel(const T* __restrict__ pts, const Bins g, int* __restrict__ keys,
                    T* __restrict__ records, long long np) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= np) return;
  Record<T, kRecord<D>> x;
#pragma unroll
  for (int d = 0; d < kRecord<D>; ++d) x.c[d] = d < D ? pts[d * np + i] : T(0);
  if (D > 1) reinterpret_cast<Record<T, kRecord<D>>*>(records)[i] = x;
  int bid = 0, lcell = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int c = folded_cell(scaled(x.c[d], g.scale[d]), g.n[d], g.inv_n[d]);
    const int q = c / g.b[d];
    bid = bid * g.nb[d] + q;
    lcell = lcell * g.b[d] + (c - q * g.b[d]);
  }
  keys[i] = bid * g.cells_per_block + lcell;
}

// src: the records, or in 1D the raw points.  Thread j sorts point j
// (j < np) and finds block j's start (j <= nblocks).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    sorted_state_kernel(const T* __restrict__ src, const int* __restrict__ skeys,
                        const long long* __restrict__ perm, const Bins g, int* __restrict__ cells,
                        T* __restrict__ fracs, int* __restrict__ pstarts, long long np) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j <= g.nblocks) {
    // The first sorted key at or above block j's first key (below 2^31).
    const int first = static_cast<int>(j) * g.cells_per_block;
    long long lo = 0, hi = np;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (skeys[mid] < first) lo = mid + 1; else hi = mid;
    }
    pstarts[j] = static_cast<int>(lo);
  }
  if (j >= np) return;
  const long long p = perm[j];
  const Record<T, kRecord<D>> x = reinterpret_cast<const Record<T, kRecord<D>>*>(src)[p];
  const int key = skeys[j];
  const int bid = key / g.cells_per_block;
  int lcell = key - bid * g.cells_per_block;
  int rest = bid;
#pragma unroll
  for (int d = D - 1; d >= 0; --d) {
    const int ql = lcell / g.b[d];
    const int qb = rest / g.nb[d];
    cells[d * np + j] = (rest - qb * g.nb[d]) * g.b[d] + (lcell - ql * g.b[d]);
    lcell = ql;
    rest = qb;
    fracs[d * np + j] = cell_fraction<T>(scaled(x.c[d], g.scale[d]));
  }
}

// The derived geometry, or false where the caller's is out of range (the
// wrapper raises before: blocking.py:bin_counts).
bool derive(const BinGeometry& in, Bins* g) {
  if (in.ndim < 1 || in.ndim > 3) return false;
  long long cells = 1, blocks = 1;
  for (int d = 0; d < 3; ++d) {
    const bool on = d < in.ndim;
    g->n[d] = on ? in.n[d] : 1;
    g->b[d] = on ? in.b[d] : 1;
    g->scale[d] = on ? in.scale[d] : 0.0;
    if (g->n[d] < 1 || g->b[d] < 1 || g->n[d] % g->b[d]) return false;
    g->inv_n[d] = 1.0 / g->n[d];
    g->nb[d] = g->n[d] / g->b[d];
    cells *= g->b[d];
    blocks *= g->nb[d];
  }
  if (cells * blocks >= (1LL << 31)) return false;
  g->cells_per_block = static_cast<int>(cells);
  g->nblocks = static_cast<int>(blocks);
  return true;
}

unsigned ctas(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

template <typename T>
int launch_keys(const void* pts, const BinGeometry* geom, void* keys, void* records,
                long long np, void* stream_ptr) {
  Bins g;
  if (np < 0 || np >= (1LL << 31) || !derive(*geom, &g)) return (int)cudaErrorInvalidValue;
  if (np == 0) return (int)cudaSuccess;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (geom->ndim > 1 && records == nullptr) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(pts);
  int* k = static_cast<int*>(keys);
  T* r = static_cast<T*>(records);
  switch (geom->ndim) {
    case 1: bin_keys_kernel<1, T><<<ctas(np), kThreads, 0, stream>>>(x, g, k, r, np); break;
    case 2: bin_keys_kernel<2, T><<<ctas(np), kThreads, 0, stream>>>(x, g, k, r, np); break;
    default: bin_keys_kernel<3, T><<<ctas(np), kThreads, 0, stream>>>(x, g, k, r, np); break;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_state(const void* src, const void* skeys, const void* perm, const BinGeometry* geom,
                 void* cells, void* fracs, void* pstarts, long long np, void* stream_ptr) {
  Bins g;
  if (np < 0 || np >= (1LL << 31) || !derive(*geom, &g)) return (int)cudaErrorInvalidValue;
  if (np == 0) return (int)cudaSuccess;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const T* x = static_cast<const T*>(src);
  const int* k = static_cast<const int*>(skeys);
  const long long* pm = static_cast<const long long*>(perm);
  int* c = static_cast<int*>(cells);
  T* f = static_cast<T*>(fracs);
  int* ps = static_cast<int*>(pstarts);
  const unsigned n = ctas(np > g.nblocks ? np : g.nblocks + 1LL);
  switch (geom->ndim) {
    case 1:
      sorted_state_kernel<1, T><<<n, kThreads, 0, stream>>>(x, k, pm, g, c, f, ps, np);
      break;
    case 2:
      sorted_state_kernel<2, T><<<n, kThreads, 0, stream>>>(x, k, pm, g, c, f, ps, np);
      break;
    default:
      sorted_state_kernel<3, T><<<n, kThreads, 0, stream>>>(x, k, pm, g, c, f, ps, np);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// nufft_bin_keys_<type>: pts (ndim, np) T, contiguous; geom, a host
// pointer; keys (np,) int32; records (np, R) T with R = 2 in 2D and 4 in
// 3D, aligned to R elements (unused in 1D, may be null there).
//
// nufft_sorted_state_<type>: src, the records (the raw points in 1D); skeys
// (np,) int32, the keys in sorted order; perm (np,) int64, perm[j] the
// original index of sorted point j; cells (ndim, np) int32, fracs (ndim,
// np) T and pstarts (nblocks + 1,) int32 are written whole.
//
// Both launch on `stream`, do not synchronise, allocate nothing, and return
// the launch's cudaError_t (cudaErrorInvalidValue for a geometry out of
// range, np >= 2^31 or missing records, before any launch).
#define NUFFT_BIN_SORT_ENTRIES(SUFFIX, T)                                                     \
  extern "C" int nufft_bin_keys_##SUFFIX(const void* pts, const BinGeometry* geom,            \
                                         void* keys, void* records, long long np,             \
                                         void* stream) {                                      \
    return launch_keys<T>(pts, geom, keys, records, np, stream);                              \
  }                                                                                           \
  extern "C" int nufft_sorted_state_##SUFFIX(const void* src, const void* skeys,              \
                                             const void* perm, const BinGeometry* geom,       \
                                             void* cells, void* fracs, void* pstarts,         \
                                             long long np, void* stream) {                    \
    return launch_state<T>(src, skeys, perm, geom, cells, fracs, pstarts, np, stream);        \
  }

#if NUFFT_WANT(2)
NUFFT_BIN_SORT_ENTRIES(f32, float)
#endif
#if NUFFT_WANT(3)
NUFFT_BIN_SORT_ENTRIES(f64, double)
#endif
