// Flash attention (forward) in float32: online softmax over key tiles, GQA
// by index.  bfloat16 inputs take the Hopper kernel of
// flash_attention_sm90.cu; this file holds the float32 kernel and the C entry
// that routes each dtype to its one kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (_kernel).  The TPU version walks a sequential
// (bh, q block, k block) grid and carries the running max, normaliser and
// accumulator in VMEM scratch from one k step to the next.  Here one CTA
// owns one (batch·head, 64-row query tile) and walks the key tiles in a loop
// inside the block, carrying those three in shared memory and registers.
//
// Design (a first kernel that is right, not yet fast):
//   * q (B·Hq, S, d), k and v (B·Hkv, S, d), float32, d any multiple of 8
//     up to 128, run by the instantiation at D = d rounded up to 16 (16, 32,
//     ..., 128): columns d..D-1 load as zeros, which add nothing to q·kᵀ,
//     and are not stored.  Every product and sum in float32 FMAs.  The CTA
//     stages its q tile, pre-multiplied by `scale` as the TPU kernel does,
//     and one 64-row k and v tile at a time in shared memory, rows padded
//     to D+1 floats so a warp's 16 key rows fall in 16 banks.
//   * 256 threads.  For the logits each thread owns a 4x4 block of the
//     (64, 64) tile (query rows 4*ty.., key columns tx + 16*j).  Each warp then
//     takes 8 query rows through the online softmax (warp-shuffle max and
//     sum), writes p back into shared memory and the rescale factor alpha per
//     row.  For p·v each thread owns 4 query rows x D/16 output columns in
//     registers.
//   * Causal: key tiles wholly above the diagonal are skipped, not masked
//     (the same rule as the TPU kernel's pl.when).  Inside the diagonal tile
//     a key after its query gets the logit sentinel -1e30.  Key tiles are
//     walked forwards from tile 0, and every query row sees key 0 there, so
//     each row's running max is a real logit from the first tile on; p is
//     also set to 0 wherever the logit is the sentinel, so a wholly masked
//     row in a tile never adds exp(0) = 1 for its masked keys.
//   * S need not be a multiple of 64: rows past S load as zeros, keys past S
//     get the sentinel, and rows past S are never stored.
//   * l is clamped at 1e-30 before the divide.
//   * kv head of row bh: batch bh / Hq, kv head (bh % Hq) / (Hq / Hkv) — no
//     repeated copy of k or v.
//
// Bound on the card: operations.  Per causal (query, key) pair it does 4·D
// flops (2·D for q·k, 2·D for p·v) on float32 operands, so the FMA units'
// 67 TFLOP/s bound it (whisper-base's head dim, D=64, S=4096, 8 heads,
// full: 3.4e10 flops, 0.513 ms, against 0.034 GB at 3.35 TB/s).  It runs
// from shared memory, one shared load for every two FMAs in the logits
// loop; tensor cores on float32 (3xTF32 or a bf16 triple split) are the
// redesign.
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attention.cuh"

namespace gxattn {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads; 8 warps
constexpr float kNegInf = -1e30f;

// Shared-memory layout, in floats.
template <int D>
struct AttnSmem {
  static constexpr int kStride = D + 1;  // padded row of q, k, v
  static constexpr int kPStride = kBK + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kStride;
  static constexpr int kV = kK + kBK * kStride;
  static constexpr int kP = kV + kBK * kStride;  // (kBQ, kBK) logits, then p
  static constexpr int kM = kP + kBQ * kPStride;  // running max
  static constexpr int kL = kM + kBQ;             // running normaliser
  static constexpr int kAlpha = kL + kBQ;         // this tile's rescale
  static constexpr int kFloats = kAlpha + kBQ;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) attn_kernel(AttnParams p) {
  using L = AttnSmem<D>;
  constexpr int kCJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem + L::kQ;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* ps = smem + L::kP;
  float* ms = smem + L::kM;
  float* ls = smem + L::kL;
  float* alphas = smem + L::kAlpha;

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

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int qpos = q0 + r;
    qs[r * L::kStride + c] =
        qpos < p.s && c < hd ? qg[static_cast<int64_t>(qpos) * hd + c] * p.scale
                            : 0.0f;
  }
  if (tid < kBQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.0f;
  }

  float acc[4][kCJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCJ; ++j) acc[i][j] = 0.0f;

  // Causal: a key tile runs when its first key is at or before the tile's
  // last query; later tiles are wholly masked and skipped.
  const int kend = CAUSAL ? min(p.s, q0 + kBQ) : p.s;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's p and v are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int kpos = k0 + r;
      const bool in = kpos < p.s && c < hd;
      const int64_t g = static_cast<int64_t>(kpos) * hd + c;
      ks[r * L::kStride + c] = in ? kg[g] : 0.0f;
      vs[r * L::kStride + c] = in ? vg[g] : 0.0f;
    }
    __syncthreads();

    // logits = (q·scale)·kᵀ for this thread's 4x4 block
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * L::kStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * L::kStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool live = kpos < p.s && (!CAUSAL || kpos <= q0 + r);
        ps[r * L::kPStride + c] = live ? sacc[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows 8w .. 8w+7, two keys per lane
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float s0 = ps[r * L::kPStride + lane];
      const float s1 = ps[r * L::kPStride + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = s0 == kNegInf ? 0.0f : expf(s0 - m_new);
      const float p1 = s1 == kNegInf ? 0.0f : expf(s1 - m_new);
      ps[r * L::kPStride + lane] = p0;
      ps[r * L::kPStride + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ls[r] = alpha * ls[r] + sum;
        ms[r] = m_new;
        alphas[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc·alpha + p·v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = alphas[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[kCJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * L::kPStride + c];
#pragma unroll
      for (int j = 0; j < kCJ; ++j) vv[j] = vs[c * L::kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qpos = q0 + r;
    if (qpos >= p.s) continue;
    const float l = fmaxf(ls[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCJ; ++j) {
      const int c = tx + 16 * j;
      if (c < hd) og[static_cast<int64_t>(qpos) * hd + c] = acc[i][j] / l;
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch(const AttnParams& p, int bhq, cudaStream_t stream) {
  auto kernel = attn_kernel<D, CAUSAL>;
  const size_t smem = AttnSmem<D>::kBytes;
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

}  // namespace gxattn

// C entry (bound with ctypes by repro_torch/kernels/build.py).  q, k, v and
// out are contiguous (B·Hq, S, D) / (B·Hkv, S, D) tensors of one dtype
// (0 float32: the FMA kernel above; 1 bfloat16: the Hopper kernel of
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
