// Flash attention (forward) in bfloat16 on Hopper's tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (_kernel) for bfloat16 q, k, v; float32 inputs take
// the 3xTF32 kernel of flash_attention.cu.  It computes what _kernel computes:
// forward attention with an online softmax, causal or full; a query head's
// KV head by index, kvh = (bh / Hq)·Hkv + (bh % Hq) / (Hq / Hkv), with no
// repeated copy; key tiles wholly above a CTA's diagonal skipped; masked
// logits set to the -1e30 sentinel and their p to 0; l clamped at 1e-30;
// float32 sums; the output rounded to bfloat16 with round-to-nearest-even.
//
// Bound on the card: operations.  Per causal (query, key) pair the function
// does 4·D flops (2·D for q·k, 2·D for p·v).  At qwen2-72b's width (64 query
// heads, 8 KV heads, D=128, S=4096, causal) that is 2.75e11 flops against
// 0.15 GB of q, k, v and out: 0.278 ms at the tensor cores' 989 TFLOP/s
// (bf16, dense) against 0.045 ms at 3.35 TB/s.
//
// Design (warp-specialised, after the CUDA guide's TMA / WGMMA / mbarrier
// sections):
//   * One CTA per (batch·head, 128 query rows): two consumer warpgroups of
//     64 rows each and one producer warpgroup (384 threads), of which one
//     thread issues every TMA load.  setmaxnreg moves registers from the
//     producer (40 a thread) to the consumers (232), from the 168 each
//     thread starts with.  Query tiles are launched heaviest first
//     (reversed), as causal rows near the end walk the most key tiles.
//   * Loads by TMA over a 3-D tensor map of (B·H, S, D), so that a ragged
//     last tile is zero-filled past S instead of reading the next head's
//     rows.  q is loaded once; k and v go through a ring of kStages = 3
//     stages of 128 keys with a "full" and an "empty" mbarrier per stage.
//     The swizzle follows D: 32 B at D=16, 64 B at D=32, 128 B with
//     64-column boxes at D>=64 (two boxes per row at D=128), and the wgmma
//     descriptors name the same swizzle.
//   * S = q·kᵀ: wgmma m64n128k16 bf16 -> f32, both operands K-major in
//     shared memory, on the raw bf16 values; scale·log2(e) is applied in
//     f32 afterwards, then the mask.
//   * Online softmax in registers, following the accumulator's rows: each
//     row's max is reduced over the 4 threads (a quad) that hold it; l is
//     summed per thread from the f32 p and reduced over the quad at the end.
//   * P·V on the tensor cores with P split in two: P_hi = bf16(p) and
//     P_lo = bf16(p - P_hi), and O += P_hi·V + P_lo·V, two wgmma m64nDk16
//     per 16 keys with A from registers (an m64n128 f32 accumulator is, pair
//     by pair, the A-register fragment of the k16 steps) and B = V MN-major
//     in shared memory (the transpose bit).  O is rescaled by alpha in
//     registers between the products.
//   * Overlap: a warpgroup issues tile t's q·kᵀ together with tile t-1's
//     P·V and runs tile t's softmax while that P·V is on the tensor cores;
//     the two warpgroups take turns issuing (named barriers), so one's
//     softmax also runs under the other's products.  For the turns to pair
//     up, both walk all of the CTA's key tiles: under a causal mask the
//     first warpgroup's last tile is masked at least in part.
//   * Epilogue: O / l, rounded to bf16, stored from registers for rows < S.
//   * Head dims: instantiations at D = 16, 32, 64 and 128; a head dim d
//     that is a multiple of 8 runs the smallest D >= d (zamba2-2.7b's 80
//     runs D = 128).  The tensor maps span the real d columns (row stride
//     2d bytes, a multiple of TMA's 16), so TMA fills columns d..D-1 of q,
//     k and v with zeros: they add nothing to q·kᵀ and give zero columns of
//     O, which the epilogue does not store.  The expect-tx counts stay the
//     full boxes', as for rows past S.  Such a head dim costs the flops of
//     D, 1.6x the work at d = 80.
//
// Why P is split.  The port holds bf16 outputs per element to one bf16 ulp
// (|Δ| <= 2^-7·|want| + 1e-5) against float32 attention, as the JAX kernel
// computes p·v in f32.  scripts/p_rounding_sim.py runs this online softmax
// on the CPU (randn inputs rounded to bf16, 64- and 128-key tiles; S=4096,
// D=128 causal, and S in {192, 1000}, D in {16, 32, 64, 128}) with P
// rounded three ways: one bf16 value leaves ~10% of elements over the bound
// (53,093 of 524,288 at S=4096, D=128), up to 19-87x it; TF32 0.2-0.5%, up
// to 2-13x; the hi/lo pair none, at most 0.98 of an element's bound
// (one-ulp ties).  The split costs 6·D flops per pair instead of 4·D, so
// this kernel's own floor is 1.5 x 0.278 = 0.417 ms at qwen2-72b's width.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attention.cuh"

namespace gxattn {
namespace {

constexpr int kWG = 2;  // consumer warpgroups; they take turns (barriers 1, 2)
constexpr int kRows = 64;                 // query rows per warpgroup
constexpr int kBQ = kRows * kWG;          // query rows per CTA
constexpr int kBK = 128;                  // keys per stage
constexpr int kStages = 3;
constexpr int kThreads = 128 * (kWG + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// The fewest registers a thread may start with for the consumers' setmaxnreg
// to be met from what the producer warpgroup gives back.
constexpr int kMinEntryRegs =
    (kConsumerRegs * 128 * kWG + kProducerRegs * 128 + kThreads - 1) /
    kThreads;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory tiles of one head dim, in bytes.  A tile of `rows` rows is
// kBoxes column boxes of rows x kRowBytes, each swizzled by TMA.
template <int D>
struct Tiles {
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kBoxCols * 2;  // 32, 64 or 128
  static constexpr int kBoxes = D / kBoxCols;
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr int kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : (kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B);
  static constexpr int kQBytes = kRows * D * 2;  // one warpgroup's q
  static constexpr int kKVBytes = kBK * D * 2;   // one stage of k (or v)
  static constexpr int kK = kWG * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // full[kStages], empty[kStages], q; plus 1 KiB to align the base
  static constexpr int kSmem = kBar + (2 * kStages + 1) * 8 + 1024;
};

// ---- PTX wrappers ------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the completion of the barrier's phase of this parity.  A wait
// that lasts beyond ~2^33 cycles (seconds, where a whole launch takes
// milliseconds) traps, so that a fault in the ring's bookkeeping ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 33)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 and 2 (0 is __syncthreads'): bar.sync waits until
// `count` threads have arrived, counting its own warp's; bar.arrive counts
// without waiting.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Ties registers that an asynchronous wgmma reads or writes to this point
// of the program, so the compiler neither reads an accumulator before the
// wait nor reuses an A fragment's register while the wgmma may read it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                             uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// K-major operand (q or k: rows x D, D contiguous), the k16 step kk: 16
// columns = 32 bytes into box kk / (kBoxCols/16).  Rows advance by 8 per
// 8·kRowBytes (SBO); LBO is unused by swizzled K-major layouts.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int kk) {
  using T = Tiles<D>;
  constexpr int kSteps = T::kBoxCols / 16;  // k16 steps per box
  const uint32_t addr = tile + (kk / kSteps) * rows * T::kRowBytes +
                        (kk % kSteps) * 32;
  return smem_desc(addr, 16, 8 * T::kRowBytes, T::kLayout);
}

// MN-major operand (v: keys x D, D contiguous) for keys 16kk..16kk+15:
// 8 keys per 8·kRowBytes (SBO), the next 64-column box kBK·kRowBytes on
// (LBO).
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using T = Tiles<D>;
  return smem_desc(tile + kk * 16 * T::kRowBytes, kBK * T::kRowBytes,
                   8 * T::kRowBytes, T::kLayout);
}

#define GX_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 128) = A (64 x 16) · B (16 x 128), both K-major in shared memory;
// scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : GX_D8(0), GX_D8(8), GX_D8(16), GX_D8(24), GX_D8(32), GX_D8(40),
        GX_D8(48), GX_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N) += A (64 x 16, bf16 pairs in registers) · B (16 x N, MN-major
// in shared memory).
__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : GX_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : GX_D8(0), GX_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : GX_D8(0), GX_D8(8), GX_D8(16), GX_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : GX_D8(0), GX_D8(8), GX_D8(16), GX_D8(24), GX_D8(32), GX_D8(40),
        GX_D8(48), GX_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef GX_D8

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) {
    wgmma_rs_m64n16(d, a, db);
  } else if constexpr (N == 32) {
    wgmma_rs_m64n32(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_rs_m64n64(d, a, db);
  } else {
    wgmma_rs_m64n128(d, a, db);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = q·kᵀ of one key tile: D/16 k16 steps, issued and committed as one
// group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[kBK / 2],
                                         uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n128(sacc, kmajor_desc<D>(q_tile, kRows, kk),
                    kmajor_desc<D>(k_tile, kBK, kk), kk > 0);
  wgmma_commit();
}

// O += P_hi·V + P_lo·V over one key tile, committed as one group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p_hi)[kBK / 16][4],
                                         const uint32_t (&p_lo)[kBK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dv = mnmajor_desc<D>(v_tile, kk);
    wgmma_rs<D>(o, p_hi[kk], dv);
    wgmma_rs<D>(o, p_lo[kk], dv);
  }
  wgmma_commit();
}

// One key tile of the online softmax, in place: logits (this thread's kBK/2
// of the m64n128 accumulator) -> p.  Scales by scale·log2(e), masks keys past S
// and (causal) after the query, reduces each row's max over its quad,
// updates the running max m and this thread's share of l, and gives the
// rescale factor alpha of each of the thread's two rows.
template <bool CAUSAL>
__device__ __forceinline__ void online_softmax(float (&sacc)[kBK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0,
                                               int s, int qrow0, int row0,
                                               int col0, float scale_log2) {
  const bool masked = k0 + kBK > s || (CAUSAL && k0 + kBK - 1 > qrow0);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    float x = sacc[i] * scale_log2;
    if (masked) {
      const int kpos = k0 + 8 * (i / 4) + col0 + (i % 2);
      const int qpos = row0 + 8 * ((i / 2) % 2);
      if (kpos >= s || (CAUSAL && kpos > qpos)) x = kNegInf;
    }
    sacc[i] = x;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
  }
  // p from the f32 logits; l from the f32 p
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int r = (i / 2) % 2;
    const float x = sacc[i];
    const float p = (masked && x == kNegInf) ? 0.0f : exp2_ftz(x - m[r]);
    sacc[i] = p;
    sum[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
}

// P = P_hi + P_lo as A fragments: the k16 step kk takes accumulator
// registers 8kk .. 8kk+7 in pairs.
__device__ __forceinline__ void split_p(const float (&sacc)[kBK / 2],
                                        uint32_t (&p_hi)[kBK / 16][4],
                                        uint32_t (&p_lo)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = sacc[8 * kk + 2 * j];
      const float b = sacc[8 * kk + 2 * j + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      p_hi[kk][j] = bf16x2_bits(hi);
      p_lo[kk][j] = bf16x2_bits(
          __floats2bfloat162_rn(a - __low2float(hi), b - __high2float(hi)));
    }
}

// ---- the kernel --------------------------------------------------------
// Accumulator layout of an m64nN wgmma, per thread of warp wl of its
// warpgroup: register i holds row 16·wl + lane/4 + 8·((i/2) % 2), column
// 8·(i/4) + 2·(lane % 4) + i % 2.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    attn_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ out, int hq, int hkv, int s,
                     int hd, float scale_log2) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + T::kK, v_s = base + T::kV;
  const uint32_t bars = base + T::kBar;
  auto full_bar = [&](int st) { return bars + 8 * st; };
  auto empty_bar = [&](int st) { return bars + 8 * (kStages + st); };
  const uint32_t q_bar = bars + 16 * kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  // Causal: key tiles after the CTA's last query row are skipped.
  const int kend = CAUSAL ? min(s, q0 + kBQ) : s;
  const int ntiles = (kend + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), 4 * kWG);  // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kWG) {
    // ---- producer: q once, then k and v through the ring ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kWG && lane == 0) {
      // q rows of the warpgroups that have any row below S
      const int live_wg = min(kWG, (s - q0 + kRows - 1) / kRows);
      mbar_expect_tx(q_bar, live_wg * T::kQBytes);
      for (int w = 0; w < live_wg; ++w)
        for (int b = 0; b < T::kBoxes; ++b)
          tma_load_3d(q_s + w * T::kQBytes + b * kRows * T::kRowBytes, &tq,
                      q_bar, b * T::kBoxCols, q0 + w * kRows, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty_bar(st), (t / kStages - 1) & 1);
        mbar_expect_tx(full_bar(st), 2 * T::kKVBytes);
        for (int b = 0; b < T::kBoxes; ++b) {
          const uint32_t off = st * T::kKVBytes + b * kBK * T::kRowBytes;
          tma_load_3d(k_s + off, &tk, full_bar(st), b * T::kBoxCols,
                      t * kBK, kvh);
          tma_load_3d(v_s + off, &tv, full_bar(st), b * T::kBoxCols,
                      t * kBK, kvh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup -------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int qrow0 = q0 + wg * kRows;
    const int row0 = qrow0 + 16 * (warp % 4) + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    // Both warpgroups walk all of the CTA's key tiles, so that they can take
    // turns issuing their products (under a causal mask the first one's
    // last tile is masked at least in part; a masked p is 0).  A turn runs
    // from bar.sync on the warpgroup's own barrier to bar.arrive on the
    // other's.  A warpgroup whose rows are all past S only takes its turns.
    const int ntw = qrow0 < s ? ntiles : 0;
    const uint32_t q_tile = q_s + wg * T::kQBytes;
    auto turn_begin = [&]() { named_bar_sync(1 + wg, 2 * 128); };
    // The second warpgroup's last turn hands on nothing: the first has
    // none left to take.
    auto turn_end = [&](bool last) {
      if (wg == 0 || !last) named_bar_arrive(2 - wg, 2 * 128);
    };
    if (wg == 1) named_bar_arrive(1, 2 * 128);  // the first turn is wg 0's

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float sacc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sacc[i] = 0.0f;
    uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
    float m[2] = {kNegInf, kNegInf};  // running max, log2 units
    float l[2] = {0.0f, 0.0f};        // this thread's share of the sum
    float alpha[2];
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));
    };
    auto k_tile = [&](int st) { return k_s + st * T::kKVBytes; };
    auto v_tile = [&](int st) { return v_s + st * T::kKVBytes; };

    // Tile t's q·kᵀ is issued together with tile t-1's P·V, and its softmax
    // runs while that P·V is on the tensor cores; a stage is released once
    // its P·V is done.
    if (ntw > 0) {
      mbar_wait(q_bar, 0);
      mbar_wait(full_bar(0), 0);
      turn_begin();
      wgmma_fence();
      issue_qk<D>(sacc, q_tile, k_tile(0));
      turn_end(false);
      wgmma_wait<0>();
      hold(sacc);
      online_softmax<CAUSAL>(sacc, m, l, alpha, 0, s, qrow0, row0, col0,
                             scale_log2);
      split_p(sacc, p_hi, p_lo);
      for (int t = 1; t < ntw; ++t) {
        const int st = t % kStages, prev = (t - 1) % kStages;
        mbar_wait(full_bar(st), (t / kStages) & 1);
        turn_begin();
        wgmma_fence();
        issue_qk<D>(sacc, q_tile, k_tile(st));
        issue_pv<D>(o, p_hi, p_lo, v_tile(prev));
        turn_end(false);
        wgmma_wait<1>();  // q·kᵀ of tile t done; P·V of t-1 may run on
        hold(sacc);
        online_softmax<CAUSAL>(sacc, m, l, alpha, t * kBK, s, qrow0, row0,
                               col0, scale_log2);
        wgmma_wait<0>();
        hold(o);
        hold(p_hi);
        hold(p_lo);
        release(prev);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
        split_p(sacc, p_hi, p_lo);
      }
      const int last = (ntw - 1) % kStages;
      turn_begin();
      wgmma_fence();
      issue_pv<D>(o, p_hi, p_lo, v_tile(last));
      turn_end(true);
      wgmma_wait<0>();
      hold(o);
      hold(p_hi);
      hold(p_lo);
      release(last);
    } else {
      for (int t = 0; t <= ntiles; ++t) {
        turn_begin();
        turn_end(t == ntiles);
        if (t < ntiles) {
          mbar_wait(full_bar(t % kStages), (t / kStages) & 1);
          release(t % kStages);
        }
      }
    }

    if (ntw > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
      }
      // hd is a multiple of 8, so a column pair is wholly inside or out
      __nv_bfloat16* og = out + static_cast<int64_t>(bh) * s * hd;
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int r = (i / 2) % 2;
        const int row = row0 + 8 * r;
        const int col = 8 * (i / 4) + col0;
        if (row < s && col < hd) {
          *reinterpret_cast<__nv_bfloat162*>(
              og + static_cast<int64_t>(row) * hd + col) =
              __floats2bfloat162_rn(o[i] / l[r], o[i + 1] / l[r]);
        }
      }
    }
  }
}

// ---- host side ---------------------------------------------------------
// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links without -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A 3-D map over a contiguous (heads, S, d) bf16 tensor, boxes of
// box_cols x box_rows x 1; rows past S and columns past d read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int heads, int s, int d, int box_cols, int box_rows,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool CAUSAL>
cudaError_t launch(const AttnParams& p, int bhq, cudaStream_t stream) {
  using T = Tiles<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int bhkv = bhq / p.hq * p.hkv;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, p.q, bhq, p.s, p.d, T::kBoxCols, kRows,
                T::kSwizzle) ||
      !make_map(encode, &tk, p.k, bhkv, p.s, p.d, T::kBoxCols, kBK,
                T::kSwizzle) ||
      !make_map(encode, &tv, p.v, bhkv, p.s, p.d, T::kBoxCols, kBK,
                T::kSwizzle)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = attn_sm90_kernel<D, CAUSAL>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  // setmaxnreg.inc would wait forever for registers the CTA never had
  if (attr.numRegs < kMinEntryRegs) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhq, (p.s + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(p.out), p.hq, p.hkv, p.s, p.d,
      p.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_causal(const AttnParams& p, int bhq, int causal,
                          cudaStream_t stream) {
  return causal ? launch<D, true>(p, bhq, stream)
                : launch<D, false>(p, bhq, stream);
}

}  // namespace

cudaError_t launch_bf16_sm90(const AttnParams& p, int bhq, int causal,
                             cudaStream_t stream) {
  // TMA reads from 16-byte aligned addresses; the epilogue stores 4 bytes
  for (const void* ptr : {p.q, p.k, p.v, static_cast<const void*>(p.out)}) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return cudaErrorMisalignedAddress;
  }
  if (!head_dim_ok(p.d)) return cudaErrorInvalidValue;
  if (p.d <= 16) return launch_causal<16>(p, bhq, causal, stream);
  if (p.d <= 32) return launch_causal<32>(p, bhq, causal, stream);
  if (p.d <= 64) return launch_causal<64>(p, bhq, causal, stream);
  return launch_causal<128>(p, bhq, causal, stream);
}

}  // namespace gxattn
