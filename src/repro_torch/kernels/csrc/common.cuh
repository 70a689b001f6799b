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

// Instantiates LAUNCH<OP, M>(p) for the runtime (gen_op, monoid) pair;
// returns cudaErrorInvalidValue for a pair outside the tables.
template <template <int, int> class LAUNCH, int OP, class P>
cudaError_t dispatch_monoid(int monoid, const P& p) {
  switch (monoid) {
    case kSum: return LAUNCH<OP, kSum>::run(p);
    case kMin: return LAUNCH<OP, kMin>::run(p);
    case kMax: return LAUNCH<OP, kMax>::run(p);
    default: return cudaErrorInvalidValue;
  }
}

template <template <int, int> class LAUNCH, class P>
cudaError_t dispatch(int gen_op, int monoid, const P& p) {
  switch (gen_op) {
    case kPrDivDeg: return dispatch_monoid<LAUNCH, kPrDivDeg>(monoid, p);
    case kAddWeight: return dispatch_monoid<LAUNCH, kAddWeight>(monoid, p);
    case kMulWeight: return dispatch_monoid<LAUNCH, kMulWeight>(monoid, p);
    case kCopySrc: return dispatch_monoid<LAUNCH, kCopySrc>(monoid, p);
    case kAddOne: return dispatch_monoid<LAUNCH, kAddOne>(monoid, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gxplug
