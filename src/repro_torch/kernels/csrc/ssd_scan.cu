// Mamba2 SSD within-chunk step (state-space duality), one CTA per
// (batch, head, chunk).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_chunk_pallas
// (_kernel).  Per chunk of L positions it computes
//   cum_t   = cumsum(a·dt)_t
//   y_t     = Σ_{s≤t} (C_t·B_s) · exp(cum_t − cum_s) · dt_s · x_s
//   state   = Σ_s dt_s · exp(cum_{L−1} − cum_s) · B_sᵀ x_s        (N, P)
//   decay   = exp(cum_{L−1}),  gate_t = exp(cum_t)
// The TPU version holds the whole (L, L) gate and C·Bᵀ in VMEM.  At
// mamba2-1.3b's chunk L=256 each is 256 KiB of float32, above the 227 KiB a
// CTA may have, so this kernel tiles over 64 target rows t and, for each,
// walks only the 64-row source tiles at or below the diagonal.
//
// Design (a first kernel that is right, not yet fast):
//   * Inputs stay in the layout ops.ssd_scan gives them, with no transpose:
//     x (B, NC, L, H, P), dt (B, NC, L, H), B and C (B, NC, L, G, N).  Head h
//     reads B and C of group h / (H / G) directly, so the (B, S, H, N)
//     repeated copy the JAX wrapper builds is never made.
//   * cum is an inclusive scan in shared memory by warp 0 (each lane sums a
//     run of positions, then a shuffle scan of the lane totals), so it adds
//     in another order than a sequential cumsum; results agree within a
//     float32 tolerance, never bit for bit.
//   * For each (target tile, source tile) the CTA stages the C and B tiles
//     (rows padded to N+1 floats) and the x tile, forms W = C·Bᵀ ∘ gate ∘ dt
//     in shared memory (each of 256 threads a 4x4 block), and accumulates
//     y += W·x in registers (4 rows x P/16 columns a thread).  Above the
//     diagonal the exponent is set to 0 before exp and the gate to 0 after:
//     exp is never taken of a positive difference.
//   * The state is a second pass over the source tiles, 64 state rows n at
//     a time: state[n, p] += (dt_s·exp(cum_{L−1} − cum_s)·B_s[n])·x_s[p].
//   * Every product and sum is a float32 FMA (no tensor cores yet).
//
// Bound on the card: operations.  The function needs C·Bᵀ once per
// (batch, chunk, group), 2N·L(L+1)/2 flops, and per (batch, chunk, head)
// 2P·L(L+1)/2 for y and 2·L·N·P for the state; at mamba2-1.3b's width (64
// heads, G=1, P=64, N=128, L=256, S=4096) that is 8.74e9 flops against
// 0.17 GB moved, so the 67 TFLOP/s of float32 FMAs bound it, not the
// 3.35 TB/s of memory.  This kernel recomputes C·Bᵀ for every head (1.72e10
// flops in all, twice what is needed at G=1): computing it once per (chunk,
// group), and running the products on tensor cores, is the redesign.
#include <cuda_runtime.h>

#include <cstdint>

namespace gxssd {

constexpr int kT = 64;         // target / source / state rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kWStride = kT + 1;

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
  int nc, l, h, p, g, n;
};

// Shared memory in floats: cum, dt and state weight per position, the C
// and B tiles, the x tile and the W tile.
__host__ __device__ inline int64_t ssd_smem_floats(int l, int p, int n) {
  return 3LL * l + 2LL * kT * (n + 1) + static_cast<int64_t>(kT) * p +
         kT * kWStride;
}

// Rows [r0, r0 + kT) of a (L, width) slab with row stride `ld` in device
// memory into a (kT, width) tile with row stride `sld`; rows past L are 0.
__device__ __forceinline__ void load_tile(float* dst, int sld,
                                          const float* src, int64_t ld,
                                          int r0, int l, int width) {
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int r = e / width, c = e % width;
    const int t = r0 + r;
    dst[r * sld + c] = t < l ? src[t * ld + c] : 0.0f;
  }
}

template <int PJ>  // P / 16 output columns per thread
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(SsdParams p) {
  constexpr int P = PJ * 16;
  extern __shared__ float smem[];
  const int L = p.l, N = p.n;
  const int ns = N + 1;  // padded row of the C and B tiles
  float* cum = smem;
  float* dts = cum + L;
  float* ws = dts + L;
  float* cs = ws + L;
  float* bs = cs + kT * ns;
  float* xs = bs + kT * ns;
  float* wt = xs + kT * P;

  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int gi = hh / (p.h / p.g);
  const int64_t cell = static_cast<int64_t>(b) * p.nc + c;  // (b, chunk)
  // Row t of each operand: base + t * row stride.
  const float* xg = p.x + (cell * L * p.h + hh) * P;
  const int64_t xld = static_cast<int64_t>(p.h) * P;
  const float* dtg = p.dt + cell * L * p.h + hh;
  const float* bg = p.bm + (cell * L * p.g + gi) * N;
  const float* cg = p.cm + (cell * L * p.g + gi) * N;
  const int64_t bld = static_cast<int64_t>(p.g) * N;
  float* yg = p.y + (cell * L * p.h + hh) * P;
  float* gg = p.gate + cell * L * p.h + hh;
  float* sg = p.state + (cell * p.h + hh) * static_cast<int64_t>(N) * P;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float av = p.a[hh];

  // cum = cumsum(a·dt): warp 0, a run of positions per lane, then a
  // shuffle scan of the lane totals.
  for (int t = tid; t < L; t += kThreads) {
    const float d = dtg[static_cast<int64_t>(t) * p.h];
    dts[t] = d;
    cum[t] = av * d;
  }
  __syncthreads();
  if (tid < 32) {
    const int per = (L + 31) / 32;
    const int beg = min(L, tid * per), end = min(L, beg + per);
    float run = 0.0f;
    for (int t = beg; t < end; ++t) {
      run += cum[t];
      cum[t] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    // the sum of the runs before this lane's
    float offset = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) offset = 0.0f;
    for (int t = beg; t < end; ++t) cum[t] += offset;
  }
  __syncthreads();
  const float cum_last = cum[L - 1];
  for (int t = tid; t < L; t += kThreads) {
    gg[static_cast<int64_t>(t) * p.h] = expf(cum[t]);
    ws[t] = dts[t] * expf(cum_last - cum[t]);
  }
  if (tid == 0) p.decay[cell * p.h + hh] = expf(cum_last);

  // y: target tiles t0, source tiles s0 <= t0 (tiles above the diagonal
  // hold no live pair and are skipped).
  for (int t0 = 0; t0 < L; t0 += kT) {
    float acc[4][PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = 0.0f;
    __syncthreads();  // the previous target tile's C tile is consumed
    load_tile(cs, ns, cg, bld, t0, L, N);
    for (int s0 = 0; s0 <= t0; s0 += kT) {
      __syncthreads();  // the previous source tile's W and x are consumed
      load_tile(bs, ns, bg, bld, s0, L, N);
      load_tile(xs, P, xg, xld, s0, L, P);
      __syncthreads();
      float w[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) w[i][j] = 0.0f;
      for (int k = 0; k < N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty * 4 + i) * ns + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * ns + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = fmaf(cv[i], bv[j], w[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + tx + 16 * j;
          const bool live = s <= t && t < L;
          const float diff = live ? cum[t] - cum[s] : 0.0f;
          const float gt = live ? expf(diff) : 0.0f;
          wt[(ty * 4 + i) * kWStride + tx + 16 * j] =
              live ? w[i][j] * gt * dts[s] : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kT; ++s) {
        float wv[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = wt[(ty * 4 + i) * kWStride + s];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = xs[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= L) continue;
#pragma unroll
      for (int j = 0; j < PJ; ++j) yg[t * xld + tx + 16 * j] = acc[i][j];
    }
  }

  // state: 64 rows n at a time, over every source tile.
  for (int n0 = 0; n0 < N; n0 += kT) {
    float acc[4][PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = 0.0f;
    for (int s0 = 0; s0 < L; s0 += kT) {
      __syncthreads();  // the previous tiles are consumed
      load_tile(bs, ns, bg, bld, s0, L, N);
      load_tile(xs, P, xg, xld, s0, L, P);
      __syncthreads();
      const int rows = min(kT, L - s0);
      for (int s = 0; s < rows; ++s) {
        const float wsv = ws[s0 + s];
        float bv[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = n0 + ty * 4 + i;
          bv[i] = k < N ? wsv * bs[s * ns + k] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = xs[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = n0 + ty * 4 + i;
      if (k >= N) continue;
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        sg[static_cast<int64_t>(k) * P + tx + 16 * j] = acc[i][j];
    }
  }
}

template <int PJ>
cudaError_t launch(const SsdParams& p, int bsz, cudaStream_t stream) {
  // A chunk too long for shared memory is refused here: the attribute
  // call fails with cudaErrorInvalidValue above the device's opt-in limit
  // (227 KiB a CTA on sm_90), before anything is launched.
  const size_t smem = ssd_smem_floats(p.l, p.p, p.n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<PJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nc, p.h, bsz);
  ssd_chunk_kernel<PJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace gxssd

// C entry (bound with ctypes by repro_torch/kernels/build.py).  Every
// tensor is contiguous float32 on the current device, in the shapes of
// SsdParams; P is 16, 32, 64 or 128.  Returns the cudaGetLastError() of the
// launch (0 on success).
extern "C" int gx_ssd_chunk(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, void* y,
                            void* state, void* decay, void* gate, int bsz,
                            int nc, int l, int h, int p, int g, int n,
                            void* stream) {
  using namespace gxssd;
  if (bsz < 1 || nc < 1 || l < 1 || h < 1 || g < 1 || n < 1 || h % g != 0 ||
      h > 65535 || bsz > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SsdParams prm{static_cast<const float*>(x),
                      static_cast<const float*>(dt),
                      static_cast<const float*>(a),
                      static_cast<const float*>(bm),
                      static_cast<const float*>(cm),
                      static_cast<float*>(y),
                      static_cast<float*>(state),
                      static_cast<float*>(decay),
                      static_cast<float*>(gate),
                      nc, l, h, p, g, n};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 16: return static_cast<int>(launch<1>(prm, bsz, st));
    case 32: return static_cast<int>(launch<2>(prm, bsz, st));
    case 64: return static_cast<int>(launch<4>(prm, bsz, st));
    case 128: return static_cast<int>(launch<8>(prm, bsz, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
