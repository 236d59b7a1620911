// Left-right consistency labels.
//
// Replaces the TPU kernel mccnn_tpu/ops/outlier_pallas.py::_outlier_kernel
// (behavior contract: outlier_detection, adcensus.cu:878-918). Per left
// pixel, with d0i = (int)d0 (truncation, as astype(int32)):
//   1 (occlusion) if x - d0i < 0;
//   else 0 (match)    if 0 <= d0i < D and |d0 - d1[y, x - d0i]| < 1.1;
//   else 2 (mismatch) if some d in [0, D) with x - d >= 0 has
//                     |d - d1[y, x - d]| < 1.1;
//   else 1 (occlusion).
// Labels are float32 0/1/2, bit-exact with the JAX forms.
//
// The "exists" test is D compares a pixel, but the function needs O(W)
// work a row: with j = x - d it holds iff some right pixel j of the row
// has |(float)(x - j) - d1[j]| < 1.1f with 0 <= x - j < D. For a value
// v = d1[j] in (-3, D + 3) only d within 1.1 of v can pass (the float
// difference of d and v is 2 or more wherever the real one is), so d in
// [floor(v) - 1, floor(v) + 2]; the kernel tests the five d in
// [floor(v) - 2, floor(v) + 2] with the same float expression and sets
// a flag at x = j + d. No d passes for a NaN, an infinity or any other
// value outside (-3, D + 3), so those are skipped before any conversion
// to int. The flags are those of the D-long loop bit for bit, and
// writes of the same value to one flag race harmlessly.
//
// Bound on the H100: at KITTI size (370 x 1226, D = 228) it moves 5.4 MB
// (1.6 us at 3.35 TB/s); its ~8 M f32 instructions take 0.2 us at the
// instruction rate: the bytes bound it, and at this size a launch's
// latency dominates. Design: one block per image row (at the KITTI and
// Middlebury sizes every block resident in one wave);
// each thread issues its loads of both rows before it uses any (one
// memory latency), stages them and zeroes the flags in shared memory
// (smem_bytes: 9 bytes a column), then scatters its columns' candidates,
// then labels its columns and writes them coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads a block
constexpr int P = 8;     // columns a thread loads before it stores any

__host__ __device__ constexpr int smem_bytes(int W) { return 9 * W; }

__global__ void __launch_bounds__(NT)
outlier_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
               float* __restrict__ out, int W, int D) {
  extern __shared__ float r0[];  // row y of d0, then of d1, then W flags
  float* r1 = r0 + W;
  unsigned char* exists = reinterpret_cast<unsigned char*>(r1 + W);
  const size_t row = (size_t)blockIdx.x * W;
  for (int x0 = 0; x0 < W; x0 += NT * P) {
    float a[P], b[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int x = x0 + k * NT + threadIdx.x;
      a[k] = x < W ? d0[row + x] : 0.f;
      b[k] = x < W ? d1[row + x] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int x = x0 + k * NT + threadIdx.x;
      if (x < W) {
        r0[x] = a[k];
        r1[x] = b[k];
        exists[x] = 0;
      }
    }
  }
  __syncthreads();
  const float vmax = (float)(D + 3);
  for (int j = threadIdx.x; j < W; j += NT) {
    const float v = r1[j];
    if (!(v > -3.f && v < vmax)) continue;  // NaN, inf, far: no d passes
    const int lo = (int)floorf(v) - 2;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int d = lo + k;
      if (d >= 0 && d < D && j + d < W && fabsf((float)d - v) < 1.1f)
        exists[j + d] = 1;
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += NT) {
    const float v0 = r0[x];
    const int d0i = (int)v0;
    float label;
    if (x - d0i < 0) {
      label = 1.f;
    } else {
      const bool match =
          d0i >= 0 && d0i < D && fabsf(v0 - r1[x - d0i]) < 1.1f;
      label = match ? 0.f : (exists[x] ? 2.f : 1.f);
    }
    out[row + x] = label;
  }
}

}  // namespace

// The dynamic shared memory a block takes for rows of W columns (mirrored
// by ops/outlier.py smem_bytes); the wrapper refuses more than a block's.
extern "C" int outlier_smem_bytes(int W) { return smem_bytes(W); }

// d0, d1, out: (H, W) float32, contiguous. Returns cudaGetLastError().
// Raises the kernel's shared-memory limit only for rows that need more
// than the default 48 KB (more than 5461 columns).
extern "C" int outlier_launch(const float* d0, const float* d1, float* out,
                              int H, int W, int D, cudaStream_t stream) {
  const int smem = smem_bytes(W);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        outlier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  outlier_kernel<<<H, NT, smem, stream>>>(d0, d1, out, W, D);
  return (int)cudaGetLastError();
}
