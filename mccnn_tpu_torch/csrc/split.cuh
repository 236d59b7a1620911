// The float32 -> 16-bit rounding and the three-level bf16 split that the
// join (csrc/join.cu) and the towers' convolutions (csrc/conv.cu) share:
// their float32 products on the tensor cores are the products of these
// levels, which ops/join.py _split emulates.

#pragma once

#include <stdint.h>

// Two values rounded to nearest even into one word of bf16 (or of f16
// with F16), lo in the low half.
template <bool F16 = false>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t d;
  if constexpr (F16)
    asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The LV bf16 levels of the pair (v0, v1), v0 in the low halves: level l
// is what is left after levels 0 .. l - 1, rounded to nearest even. v0
// and v1 are left as the residuals past the last level.
template <int LV>
__device__ __forceinline__ void split2(float& v0, float& v1, uint32_t (&w)[LV]) {
#pragma unroll
  for (int l = 0; l < LV; ++l) {
    w[l] = pack2(v0, v1);
    v0 -= __uint_as_float(w[l] << 16);
    v1 -= __uint_as_float(w[l] & 0xffff0000u);
  }
}
