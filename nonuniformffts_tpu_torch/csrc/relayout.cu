// K8a / K8b: the block-interleave relayout between the grid layout
// (CR, N0, N1, N2) and the block-major layout (CR, nb0, nb1, nb2, B0, B1, B2),
// N_d = nb_d * B_d:
//
//   nufft_relayout_to_grid_<type>    block-major -> grid   (K8a)
//   nufft_relayout_to_blocks_<type>  grid -> block-major   (K8b)
//
// <type> is f32 (complex64, 8-byte values) or f64 (complex128, 16 bytes).  A
// copy moves bytes, so the value type sets only the element size.  The
// transposes move spectra, which are complex for real-data plans too (after
// the r2c), so there is no real entry point: build.py's NUFFT_ONLY 0 and 1
// carry these, 2 and 3 none.
//
// Replaces nonuniformffts_tpu/ops/pallas/common.py:relayout_to_grid_pallas
// (:438) and relayout_to_blocks_pallas (:490).  In the port they are the
// pack and unpack around the slab transposes of the spatial mode
// (parallel/spatial.py): a dim-0-sharded slab (C, N0l, K1p, K2) is packed
// rank-major with block dims (N0l, K1l, K2), nb = (1, n, 1), before an
// all_to_all, and unpacked after one; block form's sharded spectrum packs
// and unpacks (K0l, K1p, K2) the same way.  A 2D relayout is the 3D one with
// nb0 = B0 = 1; a 1D relayout is a free reshape (the wrapper launches
// nothing).
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once, 2 x 8 B (complex64) or 2 x 16 B (complex128) over 3.35 TB/s.  At
// the port's shapes every design measured reaches 75-87% of that rate:
// this one, other rings, the element kernel it replaced and PyTorch's copy
// (PERF.md); the element kernel is 0-3% faster on the unpacks.
//
// The design: runs, not elements.  Both layouts keep the block's last dim
// contiguous, so the copy is R runs of L elements that are contiguous on
// both sides, L the longest such stretch: B2 if B2 < N2, else B1 B2 if
// B1 < N1, else B0 B1 B2 (ops/kernels/relayout.py:run_geometry, which
// passes the run geometry in).  Run r starts at grid offset r L and at the
// block-major offset that one division chain per run gives
// (block_run).  At the spatial mode's shapes B2 = N2 and a run is a row of
// B1 B2 elements, 128 KB in complex64 at 256^3 and n = 4.
//
// - Long runs (L x size >= kTmaMinRunBytes, 16-byte aligned on both sides:
//   every call site of the port): TMA bulk copies through shared memory.  A
//   persistent grid of kCtasPerSm CTAs per SM walks over (run, chunk) work
//   items.  In each CTA one thread issues cp.async.bulk loads of up to
//   kChunkBytes into a ring of kStages stages, each completing on its
//   mbarrier, and writes each stage out with a cp.async.bulk store as soon
//   as it lands; the other stages' loads stay in flight meanwhile (up to
//   kStages - 1 loads, 48 KB, a CTA).  No thread computes an address per
//   element, and the grid is one wave.  Loads and stores carry an L2
//   evict-first policy: every byte is read once and written once.
// - Short runs, or runs whose ends are not 16-byte aligned: a register path.
//   A group of up to 32 lanes copies one run in 16-byte vectors (two
//   complex64 values or one complex128), kUnroll loads in flight a lane
//   before their stores, over a grid-stride loop sized to the card.  Where
//   a run is not made of whole 16-byte vectors (complex64 with an odd L, or
//   a base address that is only 8-byte aligned) the same kernel moves
//   8-byte values; with L = 1 that is the element path.
// - The wrapper resolves the entry point once and checks its input once;
//   this file caches the SM count and the shared-memory opt-in per device.
//
// The constants below are the design's; each was timed on the H100 against
// other values (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#ifdef NUFFT_ONLY
#define NUFFT_WANT(IDX) (NUFFT_ONLY == (IDX))
#else
#define NUFFT_WANT(IDX) 1
#endif

namespace {

constexpr int kStages = 4;                   // TMA ring stages a CTA
constexpr int kChunkBytes = 16384;           // bytes a stage
constexpr long long kTmaMinRunBytes = 4096;  // shorter runs: register path
constexpr int kCtasPerSm = 2;                // TMA path
constexpr int kThreads = 256;                // register path
constexpr int kUnroll = 4;                   // register path: loads in flight a lane
constexpr int kRegCtasPerSm = 8;             // register path: 2,048 threads an SM
constexpr int kMaxDevices = 64;

// The run decomposition (ops/kernels/relayout.py:RunGeometry): run r =
// ((c n0 + g0) n1 + g1) nb2 + j2 starts at grid offset r L.
struct Runs {
  long long runs, run_len;  // R, L (elements)
  int n0, b0, n1, b1, nb2;
};

// Block-major offset of run r in units of L: one division chain per run.
__device__ __forceinline__ long long block_run(const Runs& g, long long r) {
  const long long t0 = r / g.nb2;
  const int j2 = (int)(r - t0 * g.nb2);
  const long long t1 = t0 / g.n1;
  const int g1 = (int)(t0 - t1 * g.n1);
  const long long c = t1 / g.n0;
  const int g0 = (int)(t1 - c * g.n0);
  const long long blk =
      ((c * (g.n0 / g.b0) + g0 / g.b0) * (g.n1 / g.b1) + g1 / g.b1) * g.nb2 + j2;
  return (blk * g.b0 + g0 % g.b0) * g.b1 + g1 % g.b1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Long runs: see the note above.  Launched with 32 threads; thread 0 works.
template <bool kToGrid>
__global__ void __launch_bounds__(32) relayout_tma_kernel(const char* __restrict__ src,
                                                          char* __restrict__ dst, const Runs g,
                                                          const int elem_bytes,
                                                          const long long chunks) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) unsigned long long full[kStages];
  if (threadIdx.x != 0) return;
  const long long run_bytes = g.run_len * elem_bytes;
  const long long items = g.runs * chunks;
  const long long mine =
      blockIdx.x < items ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&full[s])),
                 "r"(1u)
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // Every byte is read once and written once: keep neither in L2.
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));

  char* out[kStages];
  uint32_t out_bytes[kStages];
  // Load this CTA's k-th work item into stage k % kStages.
  auto load = [&](long long k) {
    const long long item = blockIdx.x + k * gridDim.x;
    const long long run = item / chunks;
    const long long off = (item - run * chunks) * kChunkBytes;
    const uint32_t bytes =
        (uint32_t)(run_bytes - off < kChunkBytes ? run_bytes - off : kChunkBytes);
    const long long grid_off = run * run_bytes + off;
    const long long blk_off = block_run(g, run) * run_bytes + off;
    const int s = (int)(k % kStages);
    out[s] = dst + (kToGrid ? grid_off : blk_off);
    out_bytes[s] = bytes;
    const uint32_t bar = smem_addr(&full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;\n"
        ::"r"(smem_addr(stage + s * kChunkBytes)), "l"(src + (kToGrid ? blk_off : grid_off)),
        "r"(bytes), "r"(bar), "l"(policy)
        : "memory");
  };

  for (long long k = 0; k < mine && k < kStages; ++k) load(k);
  for (long long k = 0; k < mine; ++k) {
    const int s = (int)(k % kStages);
    wait_parity(smem_addr(&full[s]), (uint32_t)((k / kStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
                 " [%0], [%1], %2, %3;\n"
                 ::"l"(out[s]), "r"(smem_addr(stage + s * kChunkBytes)), "r"(out_bytes[s]),
                 "l"(policy)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (k >= 1 && k - 1 + kStages < mine) {
      // Item k - 1's store has read its stage: refill that stage.
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(k - 1 + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Short or misaligned runs: a group of 2^group_log2 lanes copies one run of
// `vecs` values of type V, kUnroll loads in flight a lane.
template <typename V, bool kToGrid>
__global__ void __launch_bounds__(kThreads) relayout_reg_kernel(const V* __restrict__ src,
                                                                V* __restrict__ dst,
                                                                const Runs g,
                                                                const long long vecs,
                                                                const int group_log2) {
  const int group = 1 << group_log2;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = (int)(tid & (group - 1));
  const long long groups = ((long long)gridDim.x * kThreads) >> group_log2;
  for (long long run = tid >> group_log2; run < g.runs; run += groups) {
    const long long blk = block_run(g, run);
    const V* from = src + (kToGrid ? blk : run) * vecs;
    V* to = dst + (kToGrid ? run : blk) * vecs;
    for (long long v = lane; v < vecs; v += (long long)kUnroll * group) {
      V buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (v + u * group < vecs) buf[u] = from[v + u * group];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (v + u * group < vecs) to[v + u * group] = buf[u];
    }
  }
}

// Per-device caches: the SM count, and whether the TMA kernel may take its
// dynamic shared memory.  A device past kMaxDevices asks every time.
int sm_count(int dev) {
  static int cache[kMaxDevices];
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (dev < kMaxDevices) cache[dev] = sms;
  return sms;
}

template <bool kToGrid>
cudaError_t allow_tma_smem(int dev) {
  static bool done[kMaxDevices];
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(relayout_tma_kernel<kToGrid>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kStages * kChunkBytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename V, bool kToGrid>
void launch_reg(const void* src, void* dst, const Runs& g, long long vecs, int sms,
                cudaStream_t stream) {
  int group_log2 = 0;
  while (group_log2 < 5 && (1LL << group_log2) < vecs) ++group_log2;
  const long long threads = g.runs << group_log2;
  long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kRegCtasPerSm) blocks = (long long)sms * kRegCtasPerSm;
  relayout_reg_kernel<V, kToGrid><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), g, vecs, group_log2);
}

template <int kElemBytes, bool kToGrid>
int launch(const void* src, void* dst, long long runs, long long run_len, int n0, int b0, int n1,
           int b1, int nb2, void* stream_ptr) {
  if (runs < 0 || run_len < 1 || n0 < 1 || b0 < 1 || n1 < 1 || b1 < 1 || nb2 < 1 ||
      n0 % b0 || n1 % b1)
    return (int)cudaErrorInvalidValue;
  if (runs == 0) return (int)cudaSuccess;
  const Runs g{runs, run_len, n0, b0, n1, b1, nb2};
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(dev);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const long long run_bytes = run_len * kElemBytes;
  const bool vec16 = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dst) % 16 == 0 && run_bytes % 16 == 0;
  if (vec16 && run_bytes >= kTmaMinRunBytes) {
    err = allow_tma_smem<kToGrid>(dev);
    if (err != cudaSuccess) return (int)err;
    const long long chunks = (run_bytes + kChunkBytes - 1) / kChunkBytes;
    const long long items = runs * chunks;
    const long long ctas = (long long)sms * kCtasPerSm < items ? (long long)sms * kCtasPerSm : items;
    relayout_tma_kernel<kToGrid><<<(unsigned)ctas, 32, kStages * kChunkBytes, stream>>>(
        static_cast<const char*>(src), static_cast<char*>(dst), g, kElemBytes, chunks);
  } else if (vec16) {
    launch_reg<float4, kToGrid>(src, dst, g, run_bytes / 16, sms, stream);
  } else {  // 8-byte values (complex64) whose runs are not whole 16-byte vectors
    launch_reg<float2, kToGrid>(src, dst, g, run_bytes / 8, sms, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// to_grid: src block-major (CR, nb0, nb1, nb2, B0, B1, B2), dst the grid
// (CR, N0, N1, N2); to_blocks: the reverse.  The shapes come as their run
// geometry (relayout.py:run_geometry): `runs` runs of `run_len` elements and
// the dims n0, b0, n1, b1, nb2 of the division chain.  Both contiguous, of
// the entry point's type, aligned to the element's size.  Launches on
// `stream`, does not synchronise, allocates nothing; returns the launch's
// cudaError_t.
#define NUFFT_RELAYOUT_ENTRIES(SUFFIX, BYTES)                                                 \
  extern "C" int nufft_relayout_to_grid_##SUFFIX(const void* src, void* dst, long long runs,  \
                                                 long long run_len, int n0, int b0, int n1,   \
                                                 int b1, int nb2, void* stream) {             \
    return launch<BYTES, true>(src, dst, runs, run_len, n0, b0, n1, b1, nb2, stream);         \
  }                                                                                           \
  extern "C" int nufft_relayout_to_blocks_##SUFFIX(const void* src, void* dst, long long runs,\
                                                   long long run_len, int n0, int b0, int n1, \
                                                   int b1, int nb2, void* stream) {           \
    return launch<BYTES, false>(src, dst, runs, run_len, n0, b0, n1, b1, nb2, stream);        \
  }

#if NUFFT_WANT(0)
NUFFT_RELAYOUT_ENTRIES(f32, 8)
#endif
#if NUFFT_WANT(1)
NUFFT_RELAYOUT_ENTRIES(f64, 16)
#endif
