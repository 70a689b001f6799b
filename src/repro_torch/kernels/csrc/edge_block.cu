// Edge-block daemon program: per edge block, gather the src row from the
// paired vertex block, MSGGen, and merge into the block's vertex slots.
//
// Replaces the TPU kernel src/repro/kernels/edge_block.py::edge_block_pallas
// (_kernel).  The TPU version builds (B, VB) one-hot matrices and gathers and
// merges on the matrix unit.  At the block sizes the host loop picks for a
// real graph (block_size="auto": up to 65,536 edges per block, vertex blocks
// of tens of thousands of slots) that one-hot would be gigabytes per block,
// so this kernel does not carry it over.
//
// Design: a flat grid over every (block, edge) slot, one thread per edge.
// The thread reads its edge's lsrc/ldst/w/emask, gathers the src row of
// vstate and the src aux by index, and merges each message column into
// partial[b, ldst, k] with a global atomic (`ldst` is the np.unique inverse
// of the block's endpoints, not sorted, so rows are not contiguous).  Sum
// is atomicAdd; min and max use the sign-aware integer-ordering atomics of
// common.cuh.  The wrapper fills `partial` with the identity and `counts`
// with zeros before the launch.
//
// Bound on the card: memory.  It must read lsrc, ldst, w and emask of each
// live edge slot (16 B) and the emask alone of a dead or padded one (4 B),
// the gathered src rows and aux (K+1 floats per distinct live src), and write nb*VB*K partials and nb*VB counts; bytes / 3.35 TB/s is the bound
// chip_smoke.py reports beside the measured time (PERF.md).  Atomics on
// hub rows serialise; the vertex block of a power-law graph concentrates
// them, which is the cost a later version (a per-CTA shared-memory merge of
// the block's hottest rows) would cut.
#include "common.cuh"

namespace gxplug {

struct BlockParams {
  const float* vstate;  // (nb, VB, K)
  const float* vaux;    // (nb, VB, A)
  const int* lsrc;      // (nb, B)
  const int* ldst;      // (nb, B)
  const float* w;       // (nb, B)
  const float* emask;   // (nb, B)
  float* partial;       // (nb, VB, K), identity-filled
  int* counts;          // (nb, VB), zero-filled
  int64_t total;        // nb * B
  int B, VB, K, A;
  cudaStream_t stream;
};

constexpr int kBlockThreads = 256;

template <int OP, int M>
__global__ void __launch_bounds__(kBlockThreads) edge_block_kernel(
    BlockParams p) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.total || p.emask[i] == 0.0f) return;
  const int64_t vb = (i / p.B) * p.VB;  // this edge block's first vertex slot
  const int64_t s = vb + p.lsrc[i];
  const int64_t d = vb + p.ldst[i];
  const float a0 = p.vaux[s * p.A];
  const float wi = p.w[i];
  const float* srow = p.vstate + s * p.K;
  float* drow = p.partial + d * p.K;
  for (int k = 0; k < p.K; ++k) {
    atomic_combine<M>(drow + k, gen<OP>(srow[k], wi, a0));
  }
  atomicAdd(p.counts + d, 1);
}

template <int OP, int M>
struct BlockLaunch {
  static cudaError_t run(const BlockParams& p) {
    const int64_t grid = (p.total + kBlockThreads - 1) / kBlockThreads;
    edge_block_kernel<OP, M>
        <<<static_cast<unsigned int>(grid), kBlockThreads, 0, p.stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace gxplug

// C entry (bound with ctypes by repro_torch/kernels/build.py).  Tensors are
// contiguous float32/int32 on the current device; returns the
// cudaGetLastError() of the launch (0 on success).
extern "C" int gx_edge_block(const void* vstate, const void* vaux,
                             const void* lsrc, const void* ldst,
                             const void* w, const void* emask, void* partial,
                             void* counts, int nb, int B, int VB, int K,
                             int A, int gen_op, int monoid, void* stream) {
  using namespace gxplug;
  const int64_t total = static_cast<int64_t>(nb) * B;
  const int64_t grid = (total + kBlockThreads - 1) / kBlockThreads;
  if (K < 1 || A < 1 || VB < 1 || total < 1 || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockParams p{static_cast<const float*>(vstate),
                static_cast<const float*>(vaux),
                static_cast<const int*>(lsrc), static_cast<const int*>(ldst),
                static_cast<const float*>(w), static_cast<const float*>(emask),
                static_cast<float*>(partial), static_cast<int*>(counts),
                total, B, VB, K, A, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<BlockLaunch>(gen_op, monoid, p));
}
