// What the two flash-attention sources share: the launch parameters and the
// bfloat16 route, which flash_attention.cu's C entry calls for dtype 1.
#pragma once

#include <cuda_runtime.h>

namespace gxattn {

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int hq, hkv, s;
  int d;  // head dim; each kernel instantiation D >= d zero-pads the rest
  float scale;
};

// Head dims both kernels take: multiples of 8 from 8 to 128.
inline bool head_dim_ok(int d) { return d >= 8 && d <= 128 && d % 8 == 0; }

// The Hopper kernel of flash_attention_sm90.cu: q, k, v, out bfloat16, p.d
// a head dim head_dim_ok takes.  Returns the launch's error (cudaSuccess
// when it was queued).
cudaError_t launch_bf16_sm90(const AttnParams& p, int bhq, int causal,
                             cudaStream_t stream);

}  // namespace gxattn
