// Fused CSR-tile daemon program: gather + MSGGen + segmented MSGMerge per
// dst-sorted edge tile (graph/compaction.py layout).
//
// Replaces the TPU kernel src/repro/kernels/edge_block.py::csr_tile_pallas
// (_csr_tile_kernel).  The TPU version gathers and merges with one-hot
// matrices on the matrix unit; here a direct index gather and a run-wise
// reduce do the same work without the (ET, RT) one-hot.
//
// Design: one CTA per tile, in two phases.
//  1. Every thread takes edge slots in turn (coalesced loads of lsrc, seg,
//     w and emask), gathers the src row and aux by index and writes the
//     slot's messages, its seg and its live flag into shared memory; it
//     also writes the monoid identity and a zero count into every row slot
//     of the tile's output.  All the tile's gathers are in flight at once.
//  2. Each thread takes the edge positions that start a run of equal `seg`
//     values and walks the run in shared memory.  Because `seg` is sorted
//     within a tile, a row's live edges are contiguous, so every row is
//     reduced by exactly one thread, in edge order, with no atomics.
//     Padding slots sit at the tile's tail with seg 0 and a zero emask; a
//     run that starts past position 0 with seg 0 is that padding and is
//     skipped (its slot already holds the identity).
//
// Bound on the card: memory.  Per tile it must read lsrc, seg, w and emask
// of each live edge slot (16 B) and the emask alone of a dead or padded one
// (4 B; the kernel also reads a dead slot's seg to find the runs), the src
// rows it gathers (K floats and one aux float per distinct live src), and
// write RT*K partials and RT counts; bytes / 3.35 TB/s is the bound
// chip_smoke.py reports beside the measured time (PERF.md).
// None of the five message functions reads the dst state, so `rowst` is
// not read.  Phase 1 keeps the CTA's global loads independent of each
// other; what stays serial is phase 2's walk of a long run (a hub row that
// fills a whole tile is reduced by one thread), now over shared memory.
#include "common.cuh"

namespace gxplug {

struct CsrParams {
  const float* vsrc;   // (T, ST, K)
  const float* vaux;   // (T, ST, A)
  const int* lsrc;     // (T, ET)
  const int* seg;      // (T, ET) sorted tile-local row index
  const float* w;      // (T, ET)
  const float* emask;  // (T, ET) 1.0 live / 0.0 dead
  float* partial;      // (T, RT, K)
  int* counts;         // (T, RT)
  int T, ET, ST, RT, K, A;
  float ident;
  cudaStream_t stream;
};

constexpr int kCsrThreads = 128;

// Dynamic shared memory of one CTA: seg (int) and messages (K floats) per
// edge slot, then one live byte per slot.
__host__ __device__ inline size_t csr_smem_bytes(int ET, int K) {
  return static_cast<size_t>(ET) * (4 + 4 * K + 1);
}

template <int OP, int M>
__global__ void __launch_bounds__(kCsrThreads) csr_tile_kernel(CsrParams p) {
  extern __shared__ int smem[];
  int* sseg = smem;                                              // (ET,)
  float* smsg = reinterpret_cast<float*>(sseg + p.ET);           // (ET, K)
  unsigned char* slive =
      reinterpret_cast<unsigned char*>(smsg + p.ET * p.K);       // (ET,)

  const int t = blockIdx.x;
  const int64_t eb = static_cast<int64_t>(t) * p.ET;
  const int64_t rb = static_cast<int64_t>(t) * p.RT;
  float* part = p.partial + rb * p.K;
  int* cnts = p.counts + rb;
  for (int i = threadIdx.x; i < p.RT * p.K; i += blockDim.x) part[i] = p.ident;
  for (int r = threadIdx.x; r < p.RT; r += blockDim.x) cnts[r] = 0;

  // Phase 1: messages of every live edge slot into shared memory.
  const float* vsrc = p.vsrc + static_cast<int64_t>(t) * p.ST * p.K;
  const float* vaux = p.vaux + static_cast<int64_t>(t) * p.ST * p.A;
  for (int e = threadIdx.x; e < p.ET; e += blockDim.x) {
    const bool live = p.emask[eb + e] != 0.0f;
    sseg[e] = p.seg[eb + e];
    slive[e] = live;
    if (!live) continue;
    const int s = p.lsrc[eb + e];
    const float a0 = vaux[static_cast<int64_t>(s) * p.A];
    const float wj = p.w[eb + e];
    const float* srow = vsrc + static_cast<int64_t>(s) * p.K;
    for (int k = 0; k < p.K; ++k) {
      smsg[e * p.K + k] = gen<OP>(srow[k], wj, a0);
    }
  }
  __syncthreads();

  // Phase 2: one thread per run of equal seg, in edge order.
  for (int e = threadIdx.x; e < p.ET; e += blockDim.x) {
    const int r = sseg[e];
    if (e > 0 && (sseg[e - 1] == r || r == 0)) continue;  // not a run head
    if (r < 0 || r >= p.RT) continue;
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = p.ident;
    int cnt = 0;
    for (int j = e; j < p.ET && sseg[j] == r; ++j) {
      if (!slive[j]) continue;
      ++cnt;
      const float* m = smsg + j * p.K;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < p.K) acc[k] = combine<M>(acc[k], m[k]);
      }
    }
    float* out = part + static_cast<int64_t>(r) * p.K;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < p.K) out[k] = acc[k];
    }
    cnts[r] = cnt;
  }
}

template <int OP, int M>
struct CsrLaunch {
  static cudaError_t run(const CsrParams& p) {
    const size_t smem = csr_smem_bytes(p.ET, p.K);
    if (smem > 48 * 1024) {  // above 48 KB only by opting in
      const cudaError_t err = cudaFuncSetAttribute(
          csr_tile_kernel<OP, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    csr_tile_kernel<OP, M><<<p.T, kCsrThreads, smem, p.stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace gxplug

// C entry (bound with ctypes by repro_torch/kernels/build.py).  Tensors are
// contiguous float32/int32 on the current device; returns the
// cudaGetLastError() of the launch (0 on success), or cudaErrorInvalidValue
// for shapes the kernel does not take (K above kMaxK, a tile whose staged
// messages exceed the 227 KB of shared memory a CTA may use).
extern "C" int gx_csr_tile(const void* vsrc, const void* vaux,
                           const void* lsrc, const void* seg, const void* w,
                           const void* emask, void* partial, void* counts,
                           int T, int ET, int ST, int RT, int K, int A,
                           int gen_op, int monoid, float ident,
                           void* stream) {
  using namespace gxplug;
  if (K < 1 || K > kMaxK || A < 1 || T < 1 || ET < 1 || RT < 1 || ST < 1 ||
      csr_smem_bytes(ET, K) > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CsrParams p{static_cast<const float*>(vsrc), static_cast<const float*>(vaux),
              static_cast<const int*>(lsrc), static_cast<const int*>(seg),
              static_cast<const float*>(w), static_cast<const float*>(emask),
              static_cast<float*>(partial), static_cast<int*>(counts),
              T, ET, ST, RT, K, A, ident, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<CsrLaunch>(gen_op, monoid, p));
}
