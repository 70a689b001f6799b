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
  float scale;
};

// The Hopper kernel of flash_attention_sm90.cu: q, k, v, out bfloat16,
// d in {16, 32, 64, 128}.  Returns the launch's error (cudaSuccess when it
// was queued).
cudaError_t launch_bf16_sm90(const AttnParams& p, int bhq, int d, int causal,
                             cudaStream_t stream);

}  // namespace gxattn
