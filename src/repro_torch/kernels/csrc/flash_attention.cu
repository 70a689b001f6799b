// Flash attention (forward) in float32 on Hopper's tensor cores, by 3xTF32.
// bfloat16 inputs take the Hopper kernel of flash_attention_sm90.cu; this
// file holds the float32 kernel and the C entry that routes each dtype to
// its one kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (_kernel).  The TPU version walks a sequential
// (bh, q block, k block) grid and carries the running max, normaliser and
// accumulator in VMEM scratch from one k step to the next.  Here one CTA
// owns one (batch·head, 64-row query tile) and walks the key tiles in a loop
// inside the block, carrying those three in registers.
//
// Bound on the card: operations.  Per (query, key) pair the function does
// 4·D flops (2·D for q·k, 2·D for p·v).  Held to float32 accuracy on the
// tensor cores each product is three TF32 products, so the least time is
// 3·4·D flops per pair at the 495 TFLOP/s of dense TF32 (whisper-base's
// head dim, D=64, S=4096, 8 heads, full: 1.03e11 flops, 0.208 ms, against
// 0.513 ms for the 3.4e10 flops on the 67 TFLOP/s float32 FMA units, and
// 0.034 GB at 3.35 TB/s).
//
// Design (warp-level mma.sync, no wgmma, TMA or warp specialisation):
//   * q (B·Hq, S, d), k and v (B·Hkv, S, d), float32, d any multiple of 8
//     up to 128, run by the instantiation at D = d rounded up to 16 (16, 32,
//     ..., 128): columns d..D-1 load as zeros, which add nothing to q·kᵀ
//     and give zero columns of O, which are not stored.
//   * 128 threads, 4 warps of 16 query rows each.  q, times `scale` as the
//     TPU kernel does, is split once per CTA into TF32 big and small parts
//     held in shared memory.  k and v tiles come in by 16-byte cp.async,
//     double-buffered, with zero-fill (src-size 0) for rows past S and
//     columns past d.  A key tile is 64 keys up to D=64, 32 at D=80 and 96,
//     16 at D=112 and 128: the largest that lets two CTAs share an SM's
//     shared memory (on an H100 SXM, 32 heads at D=80, S=4096, causal took
//     2.43 ms with 64-key tiles and one CTA an SM, 1.68 ms with 32; PERF.md
//     §5).  Rows are padded to D+4 floats: the B-fragment loads of k (rows
//     g, column t) and of v (rows 2t and 2t+1, column g) then fall in 32
//     distinct banks, and rows stay 16-byte aligned for cp.async.
//   * Each product is mma.sync m16n8k8 TF32 with float32 accumulation, three
//     times: x = big + small and a·b = a_s·b_b + a_b·b_s + a_b·b_b, small
//     terms first, into one accumulator (a_s·b_s, near 2^-22 of a·b, is
//     left out).  big is x rounded as cvt.rna.tf32.f32 rounds it, done in
//     two integer instructions (cvt.rna itself is emulated in about five on
//     sm_90: with it, the whisper-base case above took 0.99 ms on an H100
//     SXM against 0.65 ms; PERF.md §5); small = x - big is exact, and the
//     tensor cores read its top 19 bits.  k and v are split as their
//     fragments are loaded.
//   * P never goes through shared memory.  A C fragment of S holds keys 2t
//     and 2t+1 of an 8-key block; P·V takes key 2t as k-index t and key 2t+1
//     as k-index t+4, so P's A fragment is the S accumulator reordered in
//     registers (a0 = c0, a1 = c2, a2 = c1, a3 = c3) and V's B fragment is
//     V[2t][g], V[2t+1][g].  A sum over keys does not care about their order.
//   * The online softmax runs in registers: a row's values sit in one quad,
//     whose max takes two __shfl_xor_sync; p = 2^(s·log2e - m·log2e) by one
//     FFMA and ex2.approx; l is summed per thread and over the quad at the
//     end; O is rescaled by alpha in registers.
//   * Causal: key tiles wholly above the diagonal are skipped, not masked
//     (the same rule as the TPU kernel's pl.when).  Key tiles are walked
//     forwards from tile 0, and every query row sees key 0 there, so each
//     row's running max is a real logit from the first tile on.  In a tile
//     that reaches past S or past a warp's first row, a masked key's logit
//     is the sentinel -1e30 and its p is forced to 0.
//   * l is clamped at 1e-30 before the divide.
//   * kv head of row bh: batch bh / Hq, kv head (bh % Hq) / (Hq / Hkv) — no
//     repeated copy of k or v.
//
// Why three products.  scripts/tf32_split_sim.py runs this online softmax on
// the CPU with every operand split as here: one TF32 product per matmul
// leaves elements over chip_smoke.py's f32 check (1e-4·max(1, max |want|))
// at S=4096, D=64, and q·kᵀ split with P·V in one or two products leaves
// elements over the cuda tests' atol 2e-5; only three products on both stay
// inside both, near float32's own error.
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attention.cuh"
#include "tf32.cuh"

namespace gxattn {
namespace {

constexpr int kBQ = 64;                // query rows per CTA
constexpr int kWarps = kBQ / 16;       // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one CTA at head dim D and bk keys a tile: q big and
// small, and two buffers each of k and v, in rows of D+4 floats.
constexpr int smem_bytes(int D, int bk) {
  return (2 * kBQ + 4 * bk) * (D + 4) * static_cast<int>(sizeof(float));
}
// Two CTAs on an SM share its 228 KB, less 1 KB reserved for each.
constexpr int kSmemFor2 = 228 * 1024 / 2 - 1024;
// Keys per tile at head dim D: the largest of 64, 32, 16 at which two CTAs
// fit on an SM (64 up to D=64, 32 at D=80 and 96, 16 at D=112 and 128).
constexpr int key_tile(int D) {
  return smem_bytes(D, 64) <= kSmemFor2   ? 64
         : smem_bytes(D, 32) <= kSmemFor2 ? 32
                                          : 16;
}

// The key tile and shared memory, in floats: q big, q small (kBQ rows
// each), then two buffers each of k and v (kBK rows each); rows of D+4.
template <int D>
struct Smem {
  static constexpr int kBK = key_tile(D);
  static constexpr int kStride = D + 4;
  static constexpr int kQTile = kBQ * kStride;
  static constexpr int kKVTile = kBK * kStride;
  static constexpr int kQBig = 0;
  static constexpr int kQSmall = kQTile;
  static constexpr int kK = 2 * kQTile;       // k[2]
  static constexpr int kV = kK + 2 * kKVTile;  // v[2]
  static constexpr size_t kBytes = (kV + 2 * kKVTile) * sizeof(float);
  static_assert(kBytes == smem_bytes(D, kBK), "layout and size agree");
};

// The split, mma/mma3, exp2_approx and the cp.async copies are in
// tf32.cuh, shared with ssd_scan.cu.
using gxtf32::cp_async16;
using gxtf32::cp_async_commit;
using gxtf32::cp_async_wait;
using gxtf32::exp2_approx;
using gxtf32::mma3;
using gxtf32::split;

// One kBK-row k or v tile from row k0 on, by 16-byte cp.async; rows past S
// and columns past d are zero-filled (nothing is read for them).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int k0, int s, int hd) {
  constexpr int kBK = Smem<D>::kBK;
  constexpr int kChunks = D / 4;  // 16-byte chunks in a row
  constexpr int kN = kBK * kChunks;
#pragma unroll
  for (int i = 0; i < (kN + kThreads - 1) / kThreads; ++i) {
    const int e = i * kThreads + threadIdx.x;
    if (kN % kThreads != 0 && e >= kN) break;
    const int r = e / kChunks, c = (e % kChunks) * 4;
    const bool in = k0 + r < s && c < hd;
    cp_async16(dst + r * Smem<D>::kStride + c,
               in ? src + static_cast<int64_t>(k0 + r) * hd + c : src, in);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    attn_tf32_kernel(AttnParams p) {
  using L = Smem<D>;
  constexpr int kBK = L::kBK;
  constexpr int kS = L::kStride;
  constexpr int kDK = D / 8;   // k-steps of q·kᵀ, n-blocks of P·V
  constexpr int kNB = kBK / 8;  // n-blocks of q·kᵀ, k-steps of P·V
  extern __shared__ __align__(16) float smem[];
  float* qbig = smem + L::kQBig;
  float* qsmall = smem + L::kQSmall;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;

  // Query tiles in reverse, so that under a causal mask the CTAs with the
  // most key tiles start first.
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int group = p.hq / p.hkv;
  const int kvh = (bh / p.hq) * p.hkv + (bh % p.hq) / group;
  const int hd = p.d;  // the real head dim, <= D
  const int64_t qoff = static_cast<int64_t>(bh) * p.s * hd;
  const int64_t kvoff = static_cast<int64_t>(kvh) * p.s * hd;
  const float* qg = static_cast<const float*>(p.q) + qoff;
  const float* kg = static_cast<const float*>(p.k) + kvoff;
  const float* vg = static_cast<const float*>(p.v) + kvoff;
  float* og = static_cast<float*>(p.out) + qoff;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // the warp's first row in the tile

  // Causal: a key tile runs when its first key is at or before the tile's
  // last query; later tiles are wholly masked and skipped.
  const int kend = CAUSAL ? min(p.s, q0 + kBQ) : p.s;
  const int tiles = (kend + kBK - 1) / kBK;

  // Tile 0 is in flight while q is split.
  load_tile<D>(ks, kg, 0, p.s, hd);
  load_tile<D>(vs, vg, 0, p.s, hd);
  cp_async_commit();

  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kBQ * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < p.s && c < hd)
      x = *reinterpret_cast<const float4*>(
          qg + static_cast<int64_t>(q0 + r) * hd + c);
    uint4 big, small;
    split(x.x * p.scale, big.x, small.x);
    split(x.y * p.scale, big.y, small.y);
    split(x.z * p.scale, big.z, small.z);
    split(x.w * p.scale, big.w, small.w);
    *reinterpret_cast<uint4*>(qbig + r * kS + c) = big;
    *reinterpret_cast<uint4*>(qsmall + r * kS + c) = small;
  }

  float o[kDK][4];
#pragma unroll
  for (int j = 0; j < kDK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  // rows g and g+8 of the warp's 16: running max, this thread's share of l
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kBK;
    if (it + 1 < tiles) {
      const int nb = (it + 1) & 1;
      load_tile<D>(ks + nb * L::kKVTile, kg, k0 + kBK, p.s, hd);
      load_tile<D>(vs + nb * L::kKVTile, vg, k0 + kBK, p.s, hd);
    }
    cp_async_commit();  // empty on the last tile, so one wait fits all
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks + (it & 1) * L::kKVTile;
    const float* vt = vs + (it & 1) * L::kKVTile;

    // S = (q·scale)·kᵀ for the warp's 16 rows and the tile's 64 keys
    float sacc[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      const float* qb = qbig + (r0 + g) * kS + kk * 8 + t;
      const float* qs = qsmall + (r0 + g) * kS + kk * 8 + t;
      const uint32_t ab[4] = {
          __float_as_uint(qb[0]), __float_as_uint(qb[8 * kS]),
          __float_as_uint(qb[4]), __float_as_uint(qb[8 * kS + 4])};
      const uint32_t as[4] = {
          __float_as_uint(qs[0]), __float_as_uint(qs[8 * kS]),
          __float_as_uint(qs[4]), __float_as_uint(qs[8 * kS + 4])};
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const float* kp = kt + (j * 8 + g) * kS + kk * 8 + t;
        uint32_t bb0, bs0, bb1, bs1;
        split(kp[0], bb0, bs0);
        split(kp[4], bb1, bs1);
        mma3(sacc[j], ab, as, bb0, bb1, bs0, bs1);
      }
    }

    // keys past S, and under a causal mask keys after the query
    if (k0 + kBK > p.s || (CAUSAL && k0 + kBK - 1 > q0 + r0)) {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          const int qpos = q0 + r0 + g + 8 * (e >> 1);
          if (kpos >= p.s || (CAUSAL && kpos > qpos)) sacc[j][e] = kNegInf;
        }
    }

    // online softmax: c0, c1 are row g; c2, c3 row g+8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sacc[j][0], sacc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sacc[j][2], sacc[j][3]));
    }
    // exp(s - m) = 2^(s·log2e - m·log2e), one FFMA and the MUFU
    float alpha[2], mlog2e[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2_approx((m[i] - mx[i]) * kLog2e);
      m[i] = mx[i];
      mlog2e[i] = mx[i] * kLog2e;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = sacc[j][e];
        const float pe = exp2_approx(fmaf(s, kLog2e, -mlog2e[e >> 1]));
        sacc[j][e] = s == kNegInf ? 0.0f : pe;
        l[e >> 1] += sacc[j][e];
      }
#pragma unroll
    for (int j = 0; j < kDK; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P·V, P's A fragment from S's accumulator (keys 2t, 2t+1 as
    // k-indices t, t+4)
#pragma unroll
    for (int kk = 0; kk < kNB; ++kk) {
      uint32_t pb[4], ps[4];
      split(sacc[kk][0], pb[0], ps[0]);
      split(sacc[kk][2], pb[1], ps[1]);
      split(sacc[kk][1], pb[2], ps[2]);
      split(sacc[kk][3], pb[3], ps[3]);
      const float* vp = vt + (kk * 8 + 2 * t) * kS + g;
#pragma unroll
      for (int j = 0; j < kDK; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        split(vp[j * 8], bb0, bs0);
        split(vp[kS + j * 8], bb1, bs1);
        mma3(o[j], pb, ps, bb0, bb1, bs0, bs1);
      }
    }
    __syncthreads();  // this buffer is refilled on the tile after next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + r0 + g + 8 * i;
    if (qpos >= p.s) continue;
    float* row = og + static_cast<int64_t>(qpos) * hd + 2 * t;
#pragma unroll
    for (int j = 0; j < kDK; ++j) {
      if (j * 8 < hd)
        *reinterpret_cast<float2*>(row + j * 8) =
            make_float2(o[j][2 * i] / l[i], o[j][2 * i + 1] / l[i]);
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch(const AttnParams& p, int bhq, cudaStream_t stream) {
  auto kernel = attn_tf32_kernel<D, CAUSAL>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bhq, (p.s + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_causal(const AttnParams& p, int bhq, int causal,
                          cudaStream_t stream) {
  return causal ? launch<D, true>(p, bhq, stream)
                : launch<D, false>(p, bhq, stream);
}

cudaError_t launch_f32(const AttnParams& p, int bhq, int causal,
                       cudaStream_t stream) {
  // cp.async and the q loads read 16 bytes at a time; the epilogue stores 8
  for (const void* ptr : {p.q, p.k, p.v, static_cast<const void*>(p.out)}) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return cudaErrorMisalignedAddress;
  }
  switch ((p.d + 15) / 16) {
    case 1: return launch_causal<16>(p, bhq, causal, stream);
    case 2: return launch_causal<32>(p, bhq, causal, stream);
    case 3: return launch_causal<48>(p, bhq, causal, stream);
    case 4: return launch_causal<64>(p, bhq, causal, stream);
    case 5: return launch_causal<80>(p, bhq, causal, stream);
    case 6: return launch_causal<96>(p, bhq, causal, stream);
    case 7: return launch_causal<112>(p, bhq, causal, stream);
    case 8: return launch_causal<128>(p, bhq, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace gxattn

// C entry (bound with ctypes by repro_torch/kernels/build.py).  q, k, v and
// out are contiguous (B·Hq, S, D) / (B·Hkv, S, D) tensors of one dtype
// (0 float32: the 3xTF32 kernel above; 1 bfloat16: the Hopper kernel of
// flash_attention_sm90.cu) on the current device; returns the
// cudaGetLastError() of the launch (0 on success).
extern "C" int gx_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int bhq, int hq, int hkv, int s,
                                  int d, int dtype, int causal, float scale,
                                  void* stream) {
  using namespace gxattn;
  if (bhq < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || bhq % hq != 0 ||
      s < 1 || (s + kBQ - 1) / kBQ > 65535 || !head_dim_ok(d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AttnParams p{q, k, v, out, hq, hkv, s, d, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32(p, bhq, causal, st);
  } else if (dtype == 1) {
    err = launch_bf16_sm90(p, bhq, causal, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
