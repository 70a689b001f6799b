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
// Design: a flat grid over every (block, edge) slot, 4 consecutive edges a
// thread.  A thread reads its edges' lsrc/ldst/w/emask with one 16-byte load
// each, gathers the 4 src rows and aux by index (all in flight together),
// and then merges each live edge's messages into its dst slot with global
// atomics (`ldst` is the np.unique inverse of the block's endpoints, not
// sorted, so rows are not contiguous).  K is a template constant for 1, 4
// and 8 (common.cuh dispatch_width).
//  * Sum: the messages and the count go to a (K+1)-wide float staging row
//    per vertex slot, padded to 2 (K=1) or a multiple of 4 floats, by vector
//    atomicAdd: one float2 reduction per live edge at K=1 in place of a
//    value and a count atomic, one float4 per 4 columns above.  Counts are
//    exact in float (the C entry takes at most 2^24 edges a block).
//    A split pass then writes `partial` and the int32 `counts` from the
//    staging rows; the C entry zeroes the staging rows first.
//  * Min and max: one sign-aware integer-ordering atomic per column
//    (common.cuh) into `partial` and an atomicAdd into `counts`, which the
//    C entry first fills with the identity and zeros.
// A per-CTA shared-memory merge of hot rows would save little: among 2,048
// consecutive live edges of a scale-20 R-MAT block 92.9% of the
// destinations are distinct, so such a merge cuts at most ~7% of the
// atomics.
//
// Bound on the card: memory.  It must read lsrc, ldst, w and emask of each
// live edge slot (16 B) and the emask alone of a dead or padded one (4 B),
// the gathered src rows and aux (K+1 floats per distinct live src), and
// write nb*VB*K partials and nb*VB counts; bytes / 3.35 TB/s is the bound
// chip_smoke.py reports beside the measured time (PERF.md).  The rate of
// reductions in the L2 (60-65 G/s on this unsorted layout, PERF.md §5)
// holds it above that bound: edges a thread, CTA size and the fills move
// it by 2% at most.
#include "common.cuh"

namespace gxplug {

struct BlockParams {
  const float* vstate;  // (nb, VB, K)
  const float* vaux;    // (nb, VB, A)
  const int* lsrc;      // (nb, B)
  const int* ldst;      // (nb, B)
  const float* w;       // (nb, B)
  const float* emask;   // (nb, B)
  float* partial;       // (nb, VB, K)
  int* counts;          // (nb, VB)
  float* staging;       // (nb, VB, SW) for sum; unused otherwise
  int64_t total;        // nb * B
  int64_t rows;         // nb * VB
  int B, VB, K, A, SW;
  int vec;              // 16-byte loads of 4 edges (B % 4 == 0, aligned)
  float ident;
  cudaStream_t stream;
};

constexpr int kBlockThreads = 128;
constexpr int kEdges = 4;  // consecutive edges a thread

// A thread's kEdges consecutive edge values in one load (16 bytes at 4).
template <class T>
__device__ __forceinline__ void load_edges(T (&out)[kEdges], const T* src) {
  struct alignas(sizeof(T) * kEdges) Edges {
    T v[kEdges];
  };
  const Edges e = *reinterpret_cast<const Edges*>(src);
#pragma unroll
  for (int j = 0; j < kEdges; ++j) out[j] = e.v[j];
}

// Width of a sum's staging row: K messages and the count, padded to 2 or to
// a multiple of 4 floats so that vector atomics stay aligned.
__host__ __device__ inline int staging_width(int K) {
  return K + 1 <= 2 ? 2 : (K + 1 + 3) / 4 * 4;
}

// Column c of a sum's staging row for one edge: message, count or padding.
template <int KT>
__device__ __forceinline__ float staged(const float (&m)[width<KT>()], int c,
                                        int K) {
  return c < K ? m[c < width<KT>() ? c : 0] : (c == K ? 1.0f : 0.0f);
}

template <int KT>
__device__ __forceinline__ void stage_edge(float* row,
                                           const float (&m)[width<KT>()],
                                           int K) {
  if (KT == 1 || (KT == 0 && K == 1)) {
    atomicAdd(reinterpret_cast<float2*>(row), make_float2(m[0], 1.0f));
  } else {
#pragma unroll
    for (int c = 0; c < width<KT>() + 1; c += 4) {
      if (c > K) break;
      if (c == K) {  // the count alone
        atomicAdd(row + c, 1.0f);
      } else {
        atomicAdd(reinterpret_cast<float4*>(row + c),
                  make_float4(staged<KT>(m, c, K), staged<KT>(m, c + 1, K),
                              staged<KT>(m, c + 2, K),
                              staged<KT>(m, c + 3, K)));
      }
    }
  }
}

template <int OP, int M, int KT>
__global__ void __launch_bounds__(kBlockThreads) edge_block_kernel(
    BlockParams p) {
  constexpr int W = width<KT>();
  const int K = KT > 0 ? KT : p.K;
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kBlockThreads + threadIdx.x) *
      kEdges;
  if (i0 >= p.total) return;
  int ls[kEdges], ld[kEdges];
  float wv[kEdges], mv[kEdges];
  int64_t vb[kEdges];  // each edge's block's first vertex slot
  if (p.vec) {  // the thread's edges are aligned and in one block
    load_edges(ls, p.lsrc + i0);
    load_edges(ld, p.ldst + i0);
    load_edges(wv, p.w + i0);
    load_edges(mv, p.emask + i0);
    const int64_t b0 = (i0 / p.B) * p.VB;
#pragma unroll
    for (int j = 0; j < kEdges; ++j) vb[j] = b0;
  } else {
#pragma unroll
    for (int j = 0; j < kEdges; ++j) {
      const int64_t i = i0 + j;
      const bool in = i < p.total;
      ls[j] = in ? p.lsrc[i] : 0;
      ld[j] = in ? p.ldst[i] : 0;
      wv[j] = in ? p.w[i] : 0.0f;
      mv[j] = in ? p.emask[i] : 0.0f;
      vb[j] = in ? (i / p.B) * p.VB : 0;
    }
  }

  // every live edge's messages first, so that the gathers are in flight
  // together; then the merges
  float msg[kEdges][W];
#pragma unroll
  for (int j = 0; j < kEdges; ++j) {
    if (mv[j] == 0.0f) continue;
    const int64_t s = vb[j] + ls[j];
    gen_row<OP, KT>(msg[j], p.vstate + s * K, wv[j], p.vaux[s * p.A], K);
  }
#pragma unroll
  for (int j = 0; j < kEdges; ++j) {
    if (mv[j] == 0.0f) continue;
    const int64_t d = vb[j] + ld[j];
    if constexpr (M == kSum) {
      stage_edge<KT>(p.staging + d * p.SW, msg[j], K);
    } else {
      float* drow = p.partial + d * K;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (KT > 0 || k < K) atomic_combine<M>(drow + k, msg[j][k]);
      }
      atomicAdd(p.counts + d, 1);
    }
  }
}

// Sum: partial and counts from the staging rows.
template <int KT>
__global__ void __launch_bounds__(kBlockThreads) edge_block_split(
    BlockParams p) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kBlockThreads + threadIdx.x;
  if (r >= p.rows) return;
  const int K = KT > 0 ? KT : p.K;
  const float* src = p.staging + r * p.SW;
  float* out = p.partial + r * K;
  if (KT == 1 || (KT == 0 && K == 1)) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    out[0] = v.x;
    p.counts[r] = __float2int_rn(v.y);
  } else {
#pragma unroll
    for (int k = 0; k < width<KT>(); ++k) {
      if (KT > 0 || k < K) out[k] = src[k];
    }
    p.counts[r] = __float2int_rn(src[K]);
  }
}

// Min and max: partial = identity (4 floats a thread, one 16-byte store
// when aligned); the C entry zeroes the counts.
__global__ void __launch_bounds__(kBlockThreads) edge_block_fill(
    BlockParams p) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kBlockThreads + threadIdx.x) * 4;
  const int64_t n = p.rows * p.K;
  if (i >= n) return;
  if (p.vec && i + 4 <= n) {
    *reinterpret_cast<float4*>(p.partial + i) =
        make_float4(p.ident, p.ident, p.ident, p.ident);
  } else {
    for (int64_t j = i; j < n && j < i + 4; ++j) p.partial[j] = p.ident;
  }
}

inline unsigned int grid_for(int64_t n) {
  return static_cast<unsigned int>((n + kBlockThreads - 1) / kBlockThreads);
}

template <int OP, int M, int KT>
struct BlockLaunch {
  static cudaError_t run(const BlockParams& p) {
    cudaError_t err;
    if constexpr (M == kSum) {
      err = cudaMemsetAsync(p.staging, 0,
                            static_cast<size_t>(p.rows) * p.SW * 4, p.stream);
    } else {
      edge_block_fill<<<grid_for((p.rows * p.K + 3) / 4), kBlockThreads, 0,
                        p.stream>>>(p);
      err = cudaGetLastError();
      if (err == cudaSuccess) {
        err = cudaMemsetAsync(p.counts, 0, static_cast<size_t>(p.rows) * 4,
                              p.stream);
      }
    }
    if (err != cudaSuccess) return err;
    edge_block_kernel<OP, M, KT>
        <<<grid_for((p.total + kEdges - 1) / kEdges), kBlockThreads, 0,
           p.stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess || M != kSum) return err;
    edge_block_split<KT><<<grid_for(p.rows), kBlockThreads, 0, p.stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace gxplug

// C entry (bound with ctypes by repro_torch/kernels/build.py).  Tensors are
// contiguous float32/int32 on the current device; `staging` holds
// nb*VB*gx_edge_block_staging_width(K) floats for the sum monoid and may be
// null otherwise.  Writes every element of `partial` and `counts`; returns
// the cudaGetLastError() of the launches (0 on success).
extern "C" int gx_edge_block(const void* vstate, const void* vaux,
                             const void* lsrc, const void* ldst,
                             const void* w, const void* emask, void* partial,
                             void* counts, void* staging, int nb, int B,
                             int VB, int K, int A, int gen_op, int monoid,
                             float ident, void* stream) {
  using namespace gxplug;
  const int64_t total = static_cast<int64_t>(nb) * B;
  const int64_t rows = static_cast<int64_t>(nb) * VB;
  if (K < 1 || K > kMaxK || A < 1 || VB < 1 || total < 1 || B > (1 << 24) ||
      (total + kEdges - 1) / kEdges / kBlockThreads >= 0x7fffffffLL ||
      rows / kBlockThreads >= 0x7fffffffLL ||
      (monoid == kSum && staging == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // vector loads and atomics need aligned rows; a tensor that
  // starts elsewhere (a view) runs the run-time-K instantiation with
  // scalar loads
  bool aligned = true;
  for (const void* ptr : {vstate, vaux, lsrc, ldst, w, emask,
                          const_cast<const void*>(partial),
                          const_cast<const void*>(staging)}) {
    aligned &= reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  }
  BlockParams p{static_cast<const float*>(vstate),
                static_cast<const float*>(vaux),
                static_cast<const int*>(lsrc), static_cast<const int*>(ldst),
                static_cast<const float*>(w), static_cast<const float*>(emask),
                static_cast<float*>(partial), static_cast<int*>(counts),
                static_cast<float*>(staging), total, rows, B, VB, K, A,
                staging_width(K), aligned && B % kEdges == 0, ident,
                static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      dispatch<BlockLaunch>(gen_op, monoid, aligned ? K : 0, p));
}

// Floats per vertex slot of the sum's staging rows.
extern "C" int gx_edge_block_staging_width(int K) {
  return gxplug::staging_width(K);
}
