// Shared device helpers of the GX-Plug graph kernels: the message functions
// (MSGGen) the kernels compile in, and the monoid merges (MSGMerge).
//
// A program names its message function in repro_torch.core.template.GEN_OPS;
// the integer there is the GenOp value below.  Every arithmetic step uses a
// round-to-nearest intrinsic, so the compiler cannot contract it into an FMA
// and each message is bit-equal to the plain PyTorch version's.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace gxplug {

enum GenOp : int {
  kPrDivDeg = 0,   // s / max(a0, 1)   pagerank
  kAddWeight = 1,  // s + w            sssp_bf
  kMulWeight = 2,  // s * w            label_prop
  kCopySrc = 3,    // s                wcc
  kAddOne = 4,     // s + 1            bfs
};

// "or" over {0, 1} indicators runs as kMax (exact), as in the JAX package.
enum MonoidOp : int { kSum = 0, kMin = 1, kMax = 2 };

// Largest state width K the kernels keep in registers per thread.
constexpr int kMaxK = 16;
constexpr unsigned kFullMask = 0xffffffffu;

// The message width a thread keeps in registers for a template width KT: K
// itself, or kMaxK when K is read at run time (KT = 0; columns from K on are
// then unused).
template <int KT>
__host__ __device__ constexpr int width() {
  return KT > 0 ? KT : kMaxK;
}

template <int OP>
__device__ __forceinline__ float gen(float s, float w, float a0) {
  if constexpr (OP == kPrDivDeg) {
    return __fdiv_rn(s, fmaxf(a0, 1.0f));
  } else if constexpr (OP == kAddWeight) {
    return __fadd_rn(s, w);
  } else if constexpr (OP == kMulWeight) {
    return __fmul_rn(s, w);
  } else if constexpr (OP == kCopySrc) {
    return s;
  } else {
    return __fadd_rn(s, 1.0f);
  }
}

template <int M>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (M == kSum) {
    return __fadd_rn(a, b);
  } else if constexpr (M == kMin) {
    return fminf(a, b);
  } else {
    return fmaxf(a, b);
  }
}

// Atomic merge into device memory.  Sum is atomicAdd.  Min and max use the
// sign-aware integer-ordering trick, one atomic per value and no CAS loop:
// for floats with the sign bit clear, the int32 order of the bits is the
// float order; with the sign bit set, the uint32 order is the reverse.  So a
// value whose sign bit is clear merges with a signed atomicMin/Max, and one
// whose sign bit is set with the opposite unsigned atomic.  The test is on
// the sign bit, not on v >= 0, so -0.0 takes the negative path.
template <int M>
__device__ __forceinline__ void atomic_combine(float* addr, float v) {
  if constexpr (M == kSum) {
    atomicAdd(addr, v);
  } else if constexpr (M == kMin) {
    if (__float_as_int(v) >= 0) {
      atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
    } else {
      atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
    }
  } else {
    if (__float_as_int(v) >= 0) {
      atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
    } else {
      atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
    }
  }
}

// Instantiates LAUNCH<OP, M, KT>::run(p) for the runtime (gen_op, monoid,
// K) triple.  The state widths the repository's programs use (1: pagerank,
// wcc, bfs; 4: sssp_bf from four sources; 8: label_prop) get K as a
// template constant (KT = K); every other K up to kMaxK runs the KT = 0
// instantiation of the same kernel, which reads K at run time.  Returns
// cudaErrorInvalidValue for a pair outside the tables.
template <template <int, int, int> class LAUNCH, int OP, int M, class P>
cudaError_t dispatch_width(int k, const P& p) {
  switch (k) {
    case 1: return LAUNCH<OP, M, 1>::run(p);
    case 4: return LAUNCH<OP, M, 4>::run(p);
    case 8: return LAUNCH<OP, M, 8>::run(p);
    default: return LAUNCH<OP, M, 0>::run(p);
  }
}

template <template <int, int, int> class LAUNCH, int OP, class P>
cudaError_t dispatch_monoid(int monoid, int k, const P& p) {
  switch (monoid) {
    case kSum: return dispatch_width<LAUNCH, OP, kSum>(k, p);
    case kMin: return dispatch_width<LAUNCH, OP, kMin>(k, p);
    case kMax: return dispatch_width<LAUNCH, OP, kMax>(k, p);
    default: return cudaErrorInvalidValue;
  }
}

template <template <int, int, int> class LAUNCH, class P>
cudaError_t dispatch(int gen_op, int monoid, int k, const P& p) {
  switch (gen_op) {
    case kPrDivDeg: return dispatch_monoid<LAUNCH, kPrDivDeg>(monoid, k, p);
    case kAddWeight: return dispatch_monoid<LAUNCH, kAddWeight>(monoid, k, p);
    case kMulWeight: return dispatch_monoid<LAUNCH, kMulWeight>(monoid, k, p);
    case kCopySrc: return dispatch_monoid<LAUNCH, kCopySrc>(monoid, k, p);
    case kAddOne: return dispatch_monoid<LAUNCH, kAddOne>(monoid, k, p);
    default: return cudaErrorInvalidValue;
  }
}

// Gathers one source row of K floats (KT when fixed; float4 loads when it
// is a multiple of 4, whose rows are then 16-byte aligned) and turns it
// into K messages.  With KT = 0 the first K of kMaxK columns are live.
template <int OP, int KT>
__device__ __forceinline__ void gen_row(float (&m)[width<KT>()],
                                        const float* __restrict__ srow,
                                        float w, float a0, int K) {
  if constexpr (KT > 0 && KT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < KT; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(srow + c);
      m[c] = gen<OP>(v.x, w, a0);
      m[c + 1] = gen<OP>(v.y, w, a0);
      m[c + 2] = gen<OP>(v.z, w, a0);
      m[c + 3] = gen<OP>(v.w, w, a0);
    }
  } else {
#pragma unroll
    for (int k = 0; k < width<KT>(); ++k) {
      if (KT > 0 || k < K) m[k] = gen<OP>(srow[k], w, a0);
    }
  }
}

}  // namespace gxplug
