// A tower layer's bias, rounding and ReLU on its float32 convolution
// sums, which the towers' kernels (csrc/tower.cu's bias kernel and the
// convolutions' epilogues in csrc/conv.cu) share, so that the fused
// epilogue gives the bias kernel's bits.
//
// Storage codes S (the compute dtype's rounding): 0 float32 (none), 1
// bfloat16, 2 float16, each round to nearest even by cvt.rn (torch's casts
// on the card), the rounded value held widened to float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <int S>
__device__ __forceinline__ float round_s(float v) {
  if (S == 1) return __bfloat162float(__float2bfloat16_rn(v));
  if (S == 2) return __half2float(__float2half_rn(v));
  return v;
}

// torch.relu on the card: clamp_min(x, 0), NaN kept
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// act(round_S(x + b)): the float32 add rounded once (never contracted),
// then the round to the compute dtype, then ReLU or nothing
template <int S, bool RELU>
__device__ __forceinline__ float bias_act(float x, float b) {
  const float v = round_s<S>(__fadd_rn(x, b));
  return RELU ? relu(v) : v;
}
