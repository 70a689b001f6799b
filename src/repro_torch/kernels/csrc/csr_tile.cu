// Fused CSR-tile daemon program: gather + MSGGen + segmented MSGMerge per
// dst-sorted edge tile (graph/compaction.py layout).
//
// Replaces the TPU kernel src/repro/kernels/edge_block.py::csr_tile_pallas
// (_csr_tile_kernel).  The TPU version gathers and merges with one-hot
// matrices on the matrix unit; here a direct index gather and a segmented
// reduce in registers do the same work without the (ET, RT) one-hot.
//
// Design: one CTA of 128 threads per tile, walking the tile's edge slots in
// rounds of 512 (one round at the default ET = 512).  In a round:
//  1. Each thread takes 4 consecutive slots: one 16-byte load each of seg,
//     lsrc, w and emask, then the 4 slots' source rows and aux gathered by
//     index, all independent of each other.  A dead slot (emask 0, frontier
//     or padding) holds the monoid identity and a count of 0.
//  2. Run heads and tails come from seg[e] != seg[e-1] and seg[e] !=
//     seg[e+1] (neighbours' seg by warp shuffle).  Each thread folds its 4
//     slots into the (head flag, messages, count) of the run that is open
//     at its last slot, and a 5-step __shfl_up_sync segmented scan over the
//     warp combines those; the warps' totals meet in shared memory, where
//     each warp folds the totals of the warps before it and of the earlier
//     rounds into its carry.  So every run, up to a hub row filling the
//     whole tile, costs log steps and no thread walks it.
//  3. Each thread walks its own 4 slots once more from its carry, and the
//     thread holding a run's tail writes that row's K partials and count.
//     seg is sorted within a tile's real slots, so each row has one tail
//     and is written once, with no atomics.  Padding sits at the tile's
//     tail with seg 0 after larger rows; its run, which ends at the last
//     slot, writes nothing.
// K, the message width, is a template constant for 1, 4 and 8 (the widths
// of the repository's programs; common.cuh dispatch_width); other K up to
// kMaxK run the KT = 0 instantiation, which reads K at run time.
// Only the rows the tile does not write are filled with the identity and a
// count of 0: those after the tile's last row, cooperatively by the CTA at
// the end, and any left between two rows (none in compaction's layout),
// by the tail before the gap.
//
// Bound on the card: memory.  Per tile it must read lsrc, seg, w and emask
// of each live edge slot (16 B) and the emask alone of a dead or padded one
// (4 B), the src rows it gathers (K floats and one aux float per distinct
// live src), and write RT*K partials and RT counts; bytes / 3.35 TB/s is the
// bound chip_smoke.py reports beside the measured time (PERF.md).  The
// kernel reads every slot's seg, lsrc and w as well, to find the runs and
// to keep its loads 16 bytes wide.  None of the five message functions
// reads the dst state, so `rowst` is not read.
#include <climits>

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
  int vec;             // 16-byte loads of 4 slots (ET % 4 == 0, aligned)
  float ident;
  cudaStream_t stream;
};

constexpr int kCsrThreads = 128;
constexpr int kCsrWarps = kCsrThreads / 32;
constexpr int kSlots = 4;                      // consecutive slots a thread
constexpr int kRound = kCsrThreads * kSlots;   // slots per round
constexpr int kPastTile = -2;                  // seg of a slot past ET
constexpr int kBeforeTile = INT_MIN;           // seg "before" slot 0

// A partial reduction of one run: K messages and the live count.
template <int M, int KT>
struct Run {
  float v[width<KT>()];
  int n;

  __device__ __forceinline__ void clear(float ident) {
#pragma unroll
    for (int k = 0; k < width<KT>(); ++k) v[k] = ident;
    n = 0;
  }
  // this = this ⊕ later
  __device__ __forceinline__ void add(const float* later, int later_n,
                                      int K) {
#pragma unroll
    for (int k = 0; k < width<KT>(); ++k) {
      if (KT > 0 || k < K) v[k] = combine<M>(v[k], later[k]);
    }
    n += later_n;
  }
  // this = earlier ⊕ this
  __device__ __forceinline__ void add_before(const float* earlier,
                                             int earlier_n, int K) {
#pragma unroll
    for (int k = 0; k < width<KT>(); ++k) {
      if (KT > 0 || k < K) v[k] = combine<M>(earlier[k], v[k]);
    }
    n += earlier_n;
  }
};

// Row r of the tile's output: K partials (float4 stores when K is a
// multiple of 4) and the count.
template <int KT>
__device__ __forceinline__ void store_row(float* part, int* cnts, int r,
                                          const float* v, int n, int K) {
  float* out = part + static_cast<int64_t>(r) * K;
  if constexpr (KT > 0 && KT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < KT; c += 4)
      *reinterpret_cast<float4*>(out + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < width<KT>(); ++k) {
      if (KT > 0 || k < K) out[k] = v[k];
    }
  }
  cnts[r] = n;
}

__device__ __forceinline__ void fill_rows(float* part, int* cnts, int r0,
                                          int r1, int K, float ident) {
  for (int r = r0; r < r1; ++r) {
    for (int k = 0; k < K; ++k) part[static_cast<int64_t>(r) * K + k] = ident;
    cnts[r] = 0;
  }
}

template <int OP, int M, int KT>
__global__ void __launch_bounds__(kCsrThreads) csr_tile_kernel(CsrParams p) {
  constexpr int W = width<KT>();
  using R = Run<M, KT>;
  const int K = KT > 0 ? KT : p.K;
  // warp totals, double-buffered by round parity, and the tile's last row
  __shared__ float s_val[2][kCsrWarps][W];
  __shared__ int s_cnt[2][kCsrWarps];
  __shared__ int s_head[2][kCsrWarps];
  __shared__ int s_last_row;

  const int t = blockIdx.x;
  const int64_t eb = static_cast<int64_t>(t) * p.ET;
  const int64_t rb = static_cast<int64_t>(t) * p.RT;
  float* part = p.partial + rb * K;
  int* cnts = p.counts + rb;
  const float* vsrc = p.vsrc + static_cast<int64_t>(t) * p.ST * K;
  const float* vaux = p.vaux + static_cast<int64_t>(t) * p.ST * p.A;
  const int* seg = p.seg + eb;
  const int* lsrc = p.lsrc + eb;
  const float* wt = p.w + eb;
  const float* em = p.emask + eb;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    s_last_row = -1;
    // rows before the tile's first row (none in compaction's layout)
    fill_rows(part, cnts, 0, min(seg[0], p.RT), K, p.ident);
  }

  R carry;  // the run open at the round's start, from earlier rounds
  carry.clear(p.ident);
  bool nonzero = false;  // some slot so far has a seg other than 0

  for (int base = 0, round = 0; base < p.ET; base += kRound, ++round) {
    const int buf = round & 1;
    const int e0 = base + kSlots * threadIdx.x;
    int key[kSlots], ls[kSlots];
    float wv[kSlots], mv[kSlots];
    if (p.vec && e0 + kSlots <= p.ET) {
      const int4 k4 = *reinterpret_cast<const int4*>(seg + e0);
      const int4 l4 = *reinterpret_cast<const int4*>(lsrc + e0);
      const float4 w4 = *reinterpret_cast<const float4*>(wt + e0);
      const float4 m4 = *reinterpret_cast<const float4*>(em + e0);
      key[0] = k4.x; key[1] = k4.y; key[2] = k4.z; key[3] = k4.w;
      ls[0] = l4.x; ls[1] = l4.y; ls[2] = l4.z; ls[3] = l4.w;
      wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
      mv[0] = m4.x; mv[1] = m4.y; mv[2] = m4.z; mv[3] = m4.w;
    } else {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int e = e0 + j;
        const bool in = e < p.ET;
        key[j] = in ? seg[e] : kPastTile;
        ls[j] = in ? lsrc[e] : 0;
        wv[j] = in ? wt[e] : 0.0f;
        mv[j] = in ? em[e] : 0.0f;
      }
    }

    // messages: all of the thread's gathers are in flight together
    float msg[kSlots][W];
    bool live[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      live[j] = mv[j] != 0.0f;
#pragma unroll
      for (int k = 0; k < W; ++k) msg[j][k] = p.ident;
      if (live[j]) {
        const int64_t s = ls[j];
        gen_row<OP, KT>(msg[j], vsrc + s * K, wv[j], vaux[s * p.A], K);
      }
    }

    // run heads and tails, from the neighbouring slots' seg
    int kp = __shfl_up_sync(kFullMask, key[kSlots - 1], 1);
    int kn = __shfl_down_sync(kFullMask, key[0], 1);
    if (lane == 0) {
      kp = e0 == 0 ? kBeforeTile : (e0 - 1 < p.ET ? seg[e0 - 1] : kPastTile);
    }
    if (lane == 31) kn = e0 + kSlots < p.ET ? seg[e0 + kSlots] : kPastTile;
    bool head[kSlots], tail[kSlots];
    bool mine_nonzero = false;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      head[j] = key[j] != (j == 0 ? kp : key[j - 1]);
      tail[j] = key[j] != (j == kSlots - 1 ? kn : key[j + 1]);
      mine_nonzero |= e0 + j < p.ET && key[j] != 0;
    }

    // the run open at the thread's last slot, and whether it began here
    R agg;
    agg.clear(p.ident);
    bool began = false;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (head[j]) {
        agg.clear(p.ident);
        began = true;
      }
      agg.add(msg[j], live[j], K);
    }

    // inclusive segmented scan over the warp's lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const bool up_began = __shfl_up_sync(kFullMask, began, off);
      const int up_n = __shfl_up_sync(kFullMask, agg.n, off);
      float up_v[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (KT > 0 || k < K) up_v[k] = __shfl_up_sync(kFullMask, agg.v[k], off);
      }
      if (lane >= off) {
        if (!began) agg.add_before(up_v, up_n, K);
        began |= up_began;
      }
    }
    // the warp's total to shared memory; the lane before's into this lane
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < W; ++k) s_val[buf][warp][k] = agg.v[k];
      s_cnt[buf][warp] = agg.n;
      s_head[buf][warp] = began;
    }
    R in;  // the run open just before the thread's first slot
    bool in_began = __shfl_up_sync(kFullMask, began, 1);
    in.n = __shfl_up_sync(kFullMask, agg.n, 1);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (KT > 0 || k < K) in.v[k] = __shfl_up_sync(kFullMask, agg.v[k], 1);
    }
    if (lane == 0) {
      in.clear(p.ident);
      in_began = false;
    }
    nonzero |= __syncthreads_or(mine_nonzero) != 0;

    // fold the earlier warps' totals into the round's carry: the warp's
    // carry, then, over all warps, the next round's
    R wc = carry;
#pragma unroll
    for (int u = 0; u < kCsrWarps; ++u) {
      if (u == warp && !in_began) in.add_before(wc.v, wc.n, K);
      if (s_head[buf][u]) wc.clear(p.ident);
      wc.add(s_val[buf][u], s_cnt[buf][u], K);
    }
    carry = wc;

    // walk the thread's slots from the carry; a run's tail writes its row
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (head[j]) in.clear(p.ident);
      in.add(msg[j], live[j], K);
      const int r = key[j];
      const int e = e0 + j;
      if (!tail[j] || r < 0) continue;
      if (e == p.ET - 1) {
        if (r == 0 && nonzero) continue;  // the padding run
        s_last_row = r;
      } else {
        const int next = j == kSlots - 1 ? kn : key[j + 1];
        if (next > r) {
          fill_rows(part, cnts, r + 1, min(next, p.RT), K, p.ident);
        } else {
          s_last_row = r;  // padding follows
        }
      }
      if (r < p.RT) store_row<KT>(part, cnts, r, in.v, in.n, K);
    }
  }

  // rows after the tile's last row: identity and count 0
  __syncthreads();
  const int first = s_last_row + 1;
  for (int i = first * K + threadIdx.x; i < p.RT * K; i += kCsrThreads)
    part[i] = p.ident;
  for (int r = first + threadIdx.x; r < p.RT; r += kCsrThreads) cnts[r] = 0;
}

template <int OP, int M, int KT>
struct CsrLaunch {
  static cudaError_t run(const CsrParams& p) {
    csr_tile_kernel<OP, M, KT><<<p.T, kCsrThreads, 0, p.stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace gxplug

// C entry (bound with ctypes by repro_torch/kernels/build.py).  Tensors are
// contiguous float32/int32 on the current device; returns the
// cudaGetLastError() of the launch (0 on success), or cudaErrorInvalidValue
// for shapes the kernel does not take (K above kMaxK).
extern "C" int gx_csr_tile(const void* vsrc, const void* vaux,
                           const void* lsrc, const void* seg, const void* w,
                           const void* emask, void* partial, void* counts,
                           int T, int ET, int ST, int RT, int K, int A,
                           int gen_op, int monoid, float ident,
                           void* stream) {
  using namespace gxplug;
  if (K < 1 || K > kMaxK || A < 1 || T < 1 || ET < 1 || RT < 1 || ST < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte vector loads and stores need aligned rows; a tensor that
  // starts elsewhere (a view) runs the run-time-K instantiation with
  // scalar loads
  bool aligned = true;
  for (const void* ptr : {vsrc, lsrc, seg, w, emask,
                          const_cast<const void*>(partial)}) {
    aligned &= reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  }
  CsrParams p{static_cast<const float*>(vsrc), static_cast<const float*>(vaux),
              static_cast<const int*>(lsrc), static_cast<const int*>(seg),
              static_cast<const float*>(w), static_cast<const float*>(emask),
              static_cast<float*>(partial), static_cast<int*>(counts),
              T, ET, ST, RT, K, A, aligned && ET % kSlots == 0, ident,
              static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      dispatch<CsrLaunch>(gen_op, monoid, aligned ? K : 0, p));
}
