// Mamba2 SSD within-chunk step (state-space duality) on Hopper's tensor
// cores, by 3xTF32 on mma.sync.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_chunk_pallas
// (_kernel).  Per (batch, chunk, head) and chunk of L positions it computes
//   cum_t   = cumsum(a·dt)_t
//   y_t     = Σ_{s≤t} (C_t·B_s) · exp(cum_t − cum_s) · dt_s · x_s
//   state   = Σ_s dt_s · exp(cum_{L−1} − cum_s) · B_sᵀ x_s        (N, P)
//   decay   = exp(cum_{L−1}),  gate_t = exp(cum_t)
// The TPU version holds the whole (L, L) gate and C·Bᵀ of one head in VMEM
// and recomputes C·Bᵀ for every head.  Here C·Bᵀ is formed once per block of
// R heads of one group, and every product runs on the tensor cores.
//
// Bound on the card: operations.  The function needs C·Bᵀ once per (batch,
// chunk, group), 2N·L(L+1)/2 flops, and per (batch, chunk, head) 2P·L(L+1)/2
// for y and 2·L·N·P for the state.  At mamba2-1.3b's width (64 heads, G=1,
// P=64, N=128, L=256, S=4096) that is 8.74e9 flops.  Held to float32
// accuracy each product is three TF32 products, so the least time is
// 3 × 8.74e9 flops at the 495 TFLOP/s of dense TF32, 0.0530 ms; the 0.17 GB
// the function moves take 0.0520 ms at 3.35 TB/s.
//
// Design (warp-level mma.sync m16n8k8, 256 threads a CTA, no wgmma: TF32
// wgmma takes K-major operands only, and x in W·x and both operands of the
// state product are MN-major):
//   * One launch, two kinds of CTA, heaviest first.  A y CTA owns (batch,
//     chunk, group, block of R heads of that group, 64-row target tile t0);
//     a state CTA owns (batch, chunk, head, 128 state rows).  At
//     mamba2-1.3b, R = 16: 16 chunks × 4 head blocks × 4 target tiles = 256
//     y CTAs (the 64 with t0 = 192 first), then 16 × 64 × 1 = 1,024 state
//     CTAs.  A head block never spans two groups; where H/G is not a
//     multiple of R the last block is partial, and at G = H (the JAX
//     layout) R = 1.
//   * R by measurement (scripts/time_ssd.py's cut copies, PERF.md §5): on an
//     H100 at mamba2-1.3b, R = 1, 4, 8, 16, 32 took 0.68, 0.39, 0.33–0.35,
//     0.31–0.32 and 0.50 ms.  At R = 16 every y CTA is resident in the
//     first wave (two CTAs an SM on 132 SMs); at 32 the heaviest CTAs'
//     walk over 32 heads is the critical path.
//   * C·Bᵀ once per head block.  The y CTA forms the panel C·Bᵀ of its 64
//     target rows against source columns 0 .. t0+63 in shared memory (64 KB
//     at L = 256), by K-chunks of 32 of N: C and B stage by cp.async,
//     double-buffered, so shared memory does not grow with N.  Warp w takes
//     16 target rows (w % 4) and half the 8-column blocks (w / 4); blocks
//     past a warp's last row in the diagonal tile are skipped.
//   * Flops issued at mamba2-1.3b (8.74e9 needed): C·Bᵀ 16 × 4 × 8.5 tiles
//     × 2·64·64·128 = 5.7e8 (1.35e8 needed), W·x 4.56e9 (4.31e9 needed;
//     the diagonal tiles' 8-row steps past a warp's last row are skipped),
//     the state 4.29e9: 9.42e9 in all, against 1.72e10 for the FMA kernel
//     that computed C·Bᵀ for every head.
//   * W·x per head of the block: warp w takes 16 target rows (w % 4) and
//     half (w / 4) of each 64-row source tile's 8-row steps; the two halves'
//     sums meet once a head through shared memory.  W = C·Bᵀ ∘ gate ∘ dt is
//     formed in registers as the A fragment, read from the panel, with
//     gate = exp(cum_t − cum_s): above the diagonal (and on rows past L) the
//     exponent is set to 0 before exp and W to 0 after, so exp is never
//     taken of a positive difference; gate is never factored into
//     exp(cum_t)·exp(−cum_s), which overflows (cum reaches −100 in a
//     256-long chunk).  exp is ex2.approx of one multiply.  x tiles (64
//     rows) and the next head's dt come in by cp.async, double-buffered
//     across heads, so each y CTA reads x once a head and B, C once.
//   * The state, (ws ∘ B)ᵀ·x with ws = dt·exp(cum_{L−1} − cum_s), K = L,
//     runs in CTAs of its own: 128 state rows a CTA; warp w takes 32 rows
//     (w % 4, two m-tiles, so each split x fragment feeds two products) and
//     half the P columns (w / 4); B and x tiles by cp.async,
//     double-buffered; the A fragment is ws·B formed as it is read.
//     Separate CTAs, not a share of each y CTA: the state's K runs over the
//     whole chunk while a y CTA's runs to its diagonal, so a state share
//     would need every x tile in every y CTA; as CTAs of their own they are
//     small and uniform and fill the SMs beside the long y CTAs.  The
//     state CTA for rows n < 128 also writes gate and decay (expf, as the
//     FMA kernel did).
//   * cum = cumsum(a·dt) is an inclusive scan in shared memory by warp 0
//     of each CTA (a run of positions per lane, then a shuffle scan of the
//     lane totals), so it adds in another order than a sequential cumsum;
//     results agree within a float32 tolerance, never bit for bit.
//   * Every product is mma.sync m16n8k8 TF32 three times (a_s·b_b + a_b·b_s
//     + a_b·b_b, tf32.cuh), as the float32 attention kernel does it
//     (scripts/ssd_tf32_sim.py: one or two products on any of the three
//     break the tolerance).  Rows are padded (C·Bᵀ stages 32+4 floats, x
//     P+8, the state's B 128+8, the panel 64·⌈L/64⌉+4) so that every
//     fragment load falls in 32 banks.
//   * Loads: x rows by 16-byte cp.async when x starts on 16 bytes; B and C
//     rows when they start on 16 bytes and N is a multiple of 4 (then so
//     is G·N).  Otherwise one float at a time (cp.async of 4 bytes), still
//     zero-filled past L and past N: any N ≥ 1 and any alignment of a
//     float32 view is read correctly.
//   * Shared memory depends on L and P only: 108 KiB at L = 256, P = 64
//     (two CTAs an SM, 128 registers a thread), 140 KiB at P = 128 (one).
//     A chunk whose panel does not fit (L > 704 at P = 64, L > 576 at
//     P = 128) is refused by cudaFuncSetAttribute before anything launches.
//   * Where the time goes (PERF.md §5): at mamba2-1.3b the kernel runs at
//     about 17% of the TF32 peak; the y CTAs alone take ~0.28 ms, the state
//     CTAs alone ~0.12.  One TF32 product in place of three saves only a
//     third, so the HMMAs do not bound it: each 8-column block is a chain
//     of shared load, split and three dependent HMMAs, at ~8 instructions
//     per HMMA between barriers.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tf32.cuh"

namespace gxssd {
namespace {

using gxtf32::cp_async16;
using gxtf32::cp_async4;
using gxtf32::cp_async_commit;
using gxtf32::cp_async_wait;
using gxtf32::exp2_approx;
using gxtf32::mma3;
using gxtf32::split;

constexpr int kT = 64;          // rows of a target or source tile
constexpr int kThreads = 256;   // 8 warps: 4 row groups x 2 halves
constexpr int kKC = 32;         // columns of N in a C·Bᵀ stage
constexpr int kCS = kKC + 4;    // row stride of the C and B stages
constexpr int kSR = 128;        // state rows of a state CTA
constexpr int kBS = kSR + 8;    // row stride of the state's B tile
constexpr int kHeadBlock = 16;  // R: heads that share one C·Bᵀ panel
constexpr float kLog2e = 1.4426950408889634f;

struct SsdParams {
  const float* x;   // (B, NC, L, H, P)
  const float* dt;  // (B, NC, L, H)
  const float* a;   // (H,)
  const float* bm;  // (B, NC, L, G, N)
  const float* cm;  // (B, NC, L, G, N)
  float* y;         // (B, NC, L, H, P)
  float* state;     // (B, NC, H, N, P)
  float* decay;     // (B, NC, H)
  float* gate;      // (B, NC, L, H)
  int bsz, nc, l, h, g, n;
  int r;       // heads in a head block (R)
  int hb;      // head blocks in a group, ⌈(H/G) / R⌉
  int nt;      // 64-row tiles in a chunk, ⌈L / 64⌉
  int nb;      // 128-row state blocks, ⌈N / 128⌉
  int y_ctas;  // CTAs of the y kind; the state CTAs follow
  int vec_x;   // x may be read 16 bytes at a time
  int vec_bc;  // B and C may be read 16 bytes at a time
};

// Shared memory, in floats: cum, dt (two buffers) and ws per position of
// the chunk padded to whole tiles, then the stages; a y CTA's panel follows
// its stages, a state CTA's stages take the place of both.
struct Layout {
  int lp;     // L rounded up to whole tiles
  int ps;     // row stride of the panel
  int cum, dts, ws, stage, panel;
  int total;
};

__host__ __device__ inline Layout layout(int l, int p) {
  Layout s;
  s.lp = (l + kT - 1) / kT * kT;
  s.ps = s.lp + 4;
  const int xs = p + 8;
  s.cum = 0;
  s.dts = s.lp;
  s.ws = 3 * s.lp;
  s.stage = 4 * s.lp;
  const int cb = 2 * 2 * kT * kCS, xb = 2 * kT * xs;
  const int stage_y = cb > xb ? cb : xb;
  s.panel = s.stage + stage_y;
  const int y_end = s.panel + kT * s.ps;
  const int state_end = s.stage + 2 * kT * xs + 2 * kT * kBS;
  s.total = y_end > state_end ? y_end : state_end;
  return s;
}

// Rows [r0, r0 + 64) and columns [c0, c0 + COLS) of a slab of `rows` rows
// and `width` columns (row stride `ld` floats) into a tile of row stride
// `sld`, by cp.async; rows past `rows` and columns past `width` are
// zero-filled.  With `vec`, 16 bytes at a time (src, ld and c0 multiples of
// 4 floats, and so is width).
template <int COLS>
__device__ __forceinline__ void stage_tile(float* dst, int sld,
                                           const float* src, int64_t ld,
                                           int r0, int rows, int c0,
                                           int width, bool vec) {
  if (vec) {
    constexpr int kChunks = COLS / 4;
    for (int e = threadIdx.x; e < kT * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 4;
      const bool in = r0 + r < rows && c0 + c < width;
      cp_async16(dst + r * sld + c,
                 in ? src + (r0 + r) * ld + c0 + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < kT * COLS; e += kThreads) {
      const int r = e / COLS, c = e % COLS;
      const bool in = r0 + r < rows && c0 + c < width;
      cp_async4(dst + r * sld + c, in ? src + (r0 + r) * ld + c0 + c : src,
                in);
    }
  }
}

// dt of one head, L values at stride `ld`, into lp floats (0 past L).
__device__ __forceinline__ void stage_dt(float* dst, const float* src,
                                         int64_t ld, int l, int lp) {
  for (int t = threadIdx.x; t < lp; t += kThreads) {
    const bool in = t < l;
    cp_async4(dst + t, in ? src + t * ld : src, in);
  }
}

// cum = cumsum(a·dt) over [0, L), 0 on [L, lp).  Warp 0 alone: a run of
// positions per lane, then a shuffle scan of the lane totals.
__device__ __forceinline__ void scan_cum(const float* dts, float* cum, int l,
                                         int lp, float av) {
  const int lane = threadIdx.x;
  const int per = (l + 31) / 32;
  const int beg = min(l, lane * per), end = min(l, beg + per);
  float run = 0.0f;
  for (int t = beg; t < end; ++t) {
    run += av * dts[t];
    cum[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  // the sum of the runs before this lane's
  float offset = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) offset = 0.0f;
  for (int t = beg; t < end; ++t) cum[t] += offset;
  for (int t = l + lane; t < lp; t += 32) cum[t] = 0.0f;
}

// W[t][s] = panel · exp(cum_t − cum_s) · dt_s for s ≤ t < L, else 0; the
// exponent is set to 0 before exp where the pair is not live.
__device__ __forceinline__ float gated(float cb, float cum_t, int t, int s,
                                      int l, const float* cum,
                                      const float* dts) {
  const bool live = s <= t && t < l;
  const float diff = live ? cum_t - cum[s] : 0.0f;
  const float w = cb * exp2_approx(diff * kLog2e) * dts[s];
  return live ? w : 0.0f;
}

// y for one (batch, chunk, group, head block, target tile).
template <int P>
__device__ __forceinline__ void y_cta(const SsdParams& p, float* smem,
                                      int i) {
  constexpr int PJ = P / 8;  // n-blocks of W·x
  constexpr int XS = P + 8;
  const Layout lay = layout(p.l, P);
  const int L = p.l, N = p.n, H = p.h;
  const int per_tile = p.bsz * p.nc * p.g * p.hb;
  const int tt = p.nt - 1 - i / per_tile;  // heaviest target tiles first
  int rest = i % per_tile;
  const int hb = rest % p.hb;
  rest /= p.hb;
  const int gi = rest % p.g;
  const int64_t cell = rest / p.g;  // b · NC + chunk
  const int hpg = H / p.g;
  const int h0 = gi * hpg + hb * p.r;
  const int nh = min(p.r, hpg - hb * p.r);
  const int t0 = tt * kT;

  float* cum = smem + lay.cum;
  float* dts = smem + lay.dts;
  float* stage = smem + lay.stage;
  float* panel = smem + lay.panel;
  const int ps = lay.ps;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int r0 = (warp % 4) * 16;  // the warp's first row in the tile
  // the warp's half: of the panel's 8-column blocks in C·Bᵀ, of each
  // source tile's 8-row steps in W·x
  const int half = warp / 4;

  // ---- C·Bᵀ panel: target rows t0.., source columns 0 .. t0+63 ---------
  const int64_t bld = static_cast<int64_t>(p.g) * N;
  const float* bg = p.bm + (cell * L * p.g + gi) * N;
  const float* cg = p.cm + (cell * L * p.g + gi) * N;
  const int kchunks = (N + kKC - 1) / kKC;
  const int cb_items = (tt + 1) * kchunks;
  const bool vec_bc = p.vec_bc != 0;
  auto stage_cb = [&](int it) {
    const int st = it / kchunks, kc = it % kchunks;
    float* cs = stage + (it & 1) * 2 * kT * kCS;
    stage_tile<kKC>(cs, kCS, cg, bld, t0, L, kc * kKC, N, vec_bc);
    stage_tile<kKC>(cs + kT * kCS, kCS, bg, bld, st * kT, L, kc * kKC, N,
                    vec_bc);
  };
  stage_cb(0);
  cp_async_commit();
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  for (int it = 0; it < cb_items; ++it) {
    if (it + 1 < cb_items) stage_cb(it + 1);
    cp_async_commit();  // empty on the last item, so one wait fits all
    cp_async_wait<1>();
    __syncthreads();
    const int st = it / kchunks, kc = it % kchunks;
    const float* cs = stage + (it & 1) * 2 * kT * kCS;
    const float* bs = cs + kT * kCS;
    const int ksteps = (min(kKC, N - kc * kKC) + 7) / 8;
    // in the diagonal tile, only the columns up to the warp's last row
    const int jmax = st < tt ? 8 : r0 / 8 + 2;
#pragma unroll
    for (int kk = 0; kk < kKC / 8; ++kk) {
      if (kk >= ksteps) break;
      const float* ca = cs + (r0 + g) * kCS + kk * 8 + q;
      uint32_t ab[4], as[4];
      split(ca[0], ab[0], as[0]);
      split(ca[8 * kCS], ab[1], as[1]);
      split(ca[4], ab[2], as[2]);
      split(ca[8 * kCS + 4], ab[3], as[3]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = half * 4 + jj;
        if (j >= jmax) break;
        const float* bp = bs + (j * 8 + g) * kCS + kk * 8 + q;
        uint32_t bb0, bs0, bb1, bs1;
        split(bp[0], bb0, bs0);
        split(bp[4], bb1, bs1);
        mma3(acc[jj], ab, as, bb0, bb1, bs0, bs1);
      }
    }
    if (kc == kchunks - 1) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float* row = panel + (r0 + g) * ps + st * kT + (half * 4 + jj) * 8 +
                     2 * q;
        *reinterpret_cast<float2*>(row) = make_float2(acc[jj][0], acc[jj][1]);
        *reinterpret_cast<float2*>(row + 8 * ps) =
            make_float2(acc[jj][2], acc[jj][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][e] = 0.0f;
      }
    }
    __syncthreads();  // this stage is refilled on the item after next
  }

  // ---- y = (C·Bᵀ ∘ gate ∘ dt)·x, head by head ---------------------------
  const int64_t xld = static_cast<int64_t>(H) * P;
  const float* xcell = p.x + cell * L * xld;
  const float* dtcell = p.dt + cell * L * H;
  const int per_head = tt + 1;
  const int x_items = nh * per_head;
  const bool vec_x = p.vec_x != 0;
  auto stage_x = [&](int it) {
    const int r = it / per_head, st = it % per_head;
    const int hh = h0 + r;
    stage_tile<P>(stage + (it & 1) * kT * XS, XS, xcell + hh * P, xld,
                  st * kT, L, 0, P, vec_x);
    if (st == 0) stage_dt(dts + (r & 1) * lay.lp, dtcell + hh, H, L, lay.lp);
  };
  stage_x(0);
  cp_async_commit();
  float yacc[PJ][4];
  const int ta = t0 + r0 + g, tb = ta + 8;  // this thread's two rows
  float cum_a = 0.0f, cum_b = 0.0f;
  for (int it = 0; it < x_items; ++it) {
    const int r = it / per_head, st = it % per_head;
    const int hh = h0 + r;
    if (it + 1 < x_items) stage_x(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* dh = dts + (r & 1) * lay.lp;
    if (st == 0) {  // a new head: its cum, and y from 0
      if (warp == 0) scan_cum(dh, cum, L, lay.lp, p.a[hh]);
      __syncthreads();
      cum_a = cum[ta];
      cum_b = cum[tb];
#pragma unroll
      for (int j = 0; j < PJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.0f;
    }
    const float* xt = stage + (it & 1) * kT * XS;
    const float* pa = panel + (r0 + g) * ps + st * kT + q;
    // in the diagonal tile, only the source rows up to the warp's last row
    const int kmax = st < tt ? 8 : r0 / 8 + 2;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      const int kk = half * 4 + kq;
      if (kk >= kmax) break;
      const int s = st * kT + kk * 8 + q;
      uint32_t ab[4], as[4];
      split(gated(pa[kk * 8], cum_a, ta, s, L, cum, dh), ab[0], as[0]);
      split(gated(pa[8 * ps + kk * 8], cum_b, tb, s, L, cum, dh), ab[1],
            as[1]);
      split(gated(pa[kk * 8 + 4], cum_a, ta, s + 4, L, cum, dh), ab[2],
            as[2]);
      split(gated(pa[8 * ps + kk * 8 + 4], cum_b, tb, s + 4, L, cum, dh),
            ab[3], as[3]);
      const float* xp = xt + (kk * 8 + q) * XS + g;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        split(xp[j * 8], bb0, bs0);
        split(xp[4 * XS + j * 8], bb1, bs1);
        mma3(yacc[j], ab, as, bb0, bb1, bs0, bs1);
      }
    }
    if (st == tt) {
      // the two halves' sums meet in this x tile's buffer, now read
      __syncthreads();
      float* red = stage + (it & 1) * kT * XS;
      if (half == 1) {
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          float* rp = red + (r0 + g) * XS + j * 8 + 2 * q;
          *reinterpret_cast<float2*>(rp) = make_float2(yacc[j][0], yacc[j][1]);
          *reinterpret_cast<float2*>(rp + 8 * XS) =
              make_float2(yacc[j][2], yacc[j][3]);
        }
      }
      __syncthreads();
      if (half == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = i ? tb : ta;
          if (t >= L) continue;
          const float* rp = red + (r0 + g + 8 * i) * XS + 2 * q;
          float* row = p.y + (cell * L + t) * xld + hh * P + 2 * q;
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const float2 o = *reinterpret_cast<const float2*>(rp + j * 8);
            *reinterpret_cast<float2*>(row + j * 8) = make_float2(
                yacc[j][2 * i] + o.x, yacc[j][2 * i + 1] + o.y);
          }
        }
      }
    }
    __syncthreads();  // this stage (and at a head's end, cum) is reused
  }
}

// The state rows n0 .. n0+127 of one (batch, chunk, head); the CTA of rows
// 0..127 also writes the head's gate and decay.  Warp w holds rows
// 32·(w % 4) .. +31 (two 16-row m-tiles, so each split x fragment feeds two
// products) and half w / 4 of the P columns.
template <int P>
__device__ __forceinline__ void state_cta(const SsdParams& p, float* smem,
                                          int i) {
  constexpr int PJ2 = P / 16;  // n-blocks of a warp's half of P
  constexpr int XS = P + 8;
  const Layout lay = layout(p.l, P);
  const int L = p.l, N = p.n, H = p.h;
  const int nb = i % p.nb;
  const int hh = (i / p.nb) % H;
  const int64_t cell = i / p.nb / H;
  const int gi = hh / (H / p.g);
  const int n0 = nb * kSR;

  float* cum = smem + lay.cum;
  float* dts = smem + lay.dts;
  float* ws = smem + lay.ws;
  float* xbuf = smem + lay.stage;
  float* bbuf = xbuf + 2 * kT * XS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int r0 = (warp % 4) * 32;
  const int c0 = (warp / 4) * PJ2 * 8;  // the warp's first P column

  const int64_t xld = static_cast<int64_t>(H) * P;
  const float* xg = p.x + cell * L * xld + hh * P;
  const int64_t bld = static_cast<int64_t>(p.g) * N;
  const float* bg = p.bm + (cell * L * p.g + gi) * N;
  const bool vec_x = p.vec_x != 0, vec_bc = p.vec_bc != 0;
  auto stage_s = [&](int st) {
    stage_tile<P>(xbuf + (st & 1) * kT * XS, XS, xg, xld, st * kT, L, 0, P,
                  vec_x);
    stage_tile<kSR>(bbuf + (st & 1) * kT * kBS, kBS, bg, bld, st * kT, L, n0,
                    N, vec_bc);
  };
  // dt first, so that the scan overlaps tile 0's copy
  stage_dt(dts, p.dt + cell * L * H + hh, H, L, lay.lp);
  cp_async_commit();
  stage_s(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (warp == 0) scan_cum(dts, cum, L, lay.lp, p.a[hh]);
  __syncthreads();
  const float cum_last = cum[L - 1];
  for (int t = threadIdx.x; t < lay.lp; t += kThreads) {
    ws[t] = t < L ? dts[t] * expf(cum_last - cum[t]) : 0.0f;
    if (nb == 0 && t < L) p.gate[(cell * L + t) * H + hh] = expf(cum[t]);
  }
  if (nb == 0 && threadIdx.x == 0) p.decay[cell * H + hh] = expf(cum_last);

  float sacc[2][PJ2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < PJ2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[m][j][e] = 0.0f;
  // the warp's m-tiles that hold a state row
  const int mtiles = min(2, max(0, (N - n0 - r0 + 15) / 16));
  for (int st = 0; st < p.nt; ++st) {
    if (st + 1 < p.nt) stage_s(st + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (mtiles > 0) {
      const float* xt = xbuf + (st & 1) * kT * XS;
      const float* bt = bbuf + (st & 1) * kT * kBS;
      const int ksteps = (min(kT, L - st * kT) + 7) / 8;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= ksteps) break;
        const int s = st * kT + kk * 8 + q;
        const float wa = ws[s], wb = ws[s + 4];
        // A[n][s] = ws_s · B[s][n]: rows n = r0+16m+g, +8; columns s, s+4
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* bp = bt + (kk * 8 + q) * kBS + r0 + 16 * m + g;
          split(wa * bp[0], ab[m][0], as[m][0]);
          split(wa * bp[8], ab[m][1], as[m][1]);
          split(wb * bp[4 * kBS], ab[m][2], as[m][2]);
          split(wb * bp[4 * kBS + 8], ab[m][3], as[m][3]);
        }
        const float* xp = xt + (kk * 8 + q) * XS + c0 + g;
#pragma unroll
        for (int j = 0; j < PJ2; ++j) {
          uint32_t bb0, bs0, bb1, bs1;
          split(xp[j * 8], bb0, bs0);
          split(xp[4 * XS + j * 8], bb1, bs1);
          mma3(sacc[0][j], ab[0], as[0], bb0, bb1, bs0, bs1);
          if (mtiles > 1) mma3(sacc[1][j], ab[1], as[1], bb0, bb1, bs0, bs1);
        }
      }
    }
    __syncthreads();  // this stage is refilled on the tile after next
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int n = n0 + r0 + 16 * m + g + 8 * i2;
      if (n >= N) continue;
      float* row = p.state + ((cell * H + hh) * N + n) * P + c0 + 2 * q;
#pragma unroll
      for (int j = 0; j < PJ2; ++j)
        *reinterpret_cast<float2*>(row + j * 8) =
            make_float2(sacc[m][j][2 * i2], sacc[m][j][2 * i2 + 1]);
    }
}

template <int P>
__global__ void __launch_bounds__(kThreads, P <= 64 ? 2 : 1)
    ssd_chunk_kernel(SsdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.x;
  if (i < p.y_ctas) {
    y_cta<P>(p, smem, i);
  } else {
    state_cta<P>(p, smem, i - p.y_ctas);
  }
}

template <int P>
cudaError_t launch(const SsdParams& p, int ctas, cudaStream_t stream) {
  // A chunk too long for shared memory is refused here: the attribute
  // call fails with cudaErrorInvalidValue above the device's opt-in limit
  // (227 KiB a CTA on sm_90), before anything is launched.
  const size_t smem = static_cast<size_t>(layout(p.l, P).total) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<P><<<ctas, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace
}  // namespace gxssd

// C entry (bound with ctypes by repro_torch/kernels/build.py).  Every
// tensor is contiguous float32 on the current device, in the shapes of
// SsdParams; P is 16, 32, 64 or 128.  One launch (y CTAs and state CTAs).
// Returns the cudaGetLastError() of the launch (0 on success).
extern "C" int gx_ssd_chunk(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, void* y,
                            void* state, void* decay, void* gate, int bsz,
                            int nc, int l, int h, int p, int g, int n,
                            void* stream) {
  using namespace gxssd;
  if (bsz < 1 || nc < 1 || l < 1 || h < 1 || g < 1 || n < 1 || h % g != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hpg = h / g;
  const int r = hpg < kHeadBlock ? hpg : kHeadBlock;
  const int hb = (hpg + r - 1) / r;
  const int nt = (l + kT - 1) / kT;
  const int nb = (n + kSR - 1) / kSR;

  const int64_t cells = static_cast<int64_t>(bsz) * nc;
  const int64_t y_ctas = cells * g * hb * nt;
  const int64_t ctas = y_ctas + cells * h * nb;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const SsdParams prm{static_cast<const float*>(x),
                      static_cast<const float*>(dt),
                      static_cast<const float*>(a),
                      static_cast<const float*>(bm),
                      static_cast<const float*>(cm),
                      static_cast<float*>(y),
                      static_cast<float*>(state),
                      static_cast<float*>(decay),
                      static_cast<float*>(gate),
                      bsz, nc, l, h, g, n, r, hb, nt, nb,
                      static_cast<int>(y_ctas),
                      aligned16(x),
                      aligned16(bm) && aligned16(cm) && n % 4 == 0};
  const int total = static_cast<int>(ctas);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 16: return static_cast<int>(launch<16>(prm, total, st));
    case 32: return static_cast<int>(launch<32>(prm, total, st));
    case 64: return static_cast<int>(launch<64>(prm, total, st));
    case 128: return static_cast<int>(launch<128>(prm, total, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
