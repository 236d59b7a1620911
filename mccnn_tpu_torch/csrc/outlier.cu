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
// Bound on the H100: at KITTI size (370 x 1226, D = 228) it moves 5.4 MB
// (1.6 us) and does about four operations per (pixel, d), 0.41 G in all
// (6 us at 67 TFLOP/s): the operations bound it. Design: one block per
// image row; the row of d1 is staged in shared memory, so the D lookups
// of each pixel hit shared memory; one thread per pixel loops d over
// [0, D) without an early exit, so the work does not depend on the data.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
outlier_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
               float* __restrict__ out, int W, int D) {
  extern __shared__ float r1[];  // row y of d1
  const int y = blockIdx.x;
  for (int x = threadIdx.x; x < W; x += NT) r1[x] = d1[(size_t)y * W + x];
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += NT) {
    const float v0 = d0[(size_t)y * W + x];
    const int d0i = (int)v0;
    float label;
    if (x - d0i < 0) {
      label = 1.f;
    } else {
      const bool match =
          d0i >= 0 && d0i < D && fabsf(v0 - r1[x - d0i]) < 1.1f;
      bool exists = false;
      const int dmax = min(D - 1, x);  // x - d >= 0
      for (int d = 0; d <= dmax; ++d)
        exists |= fabsf((float)d - r1[x - d]) < 1.1f;
      label = match ? 0.f : (exists ? 2.f : 1.f);
    }
    out[(size_t)y * W + x] = label;
  }
}

}  // namespace

// d0, d1, out: (H, W) float32, contiguous. Returns cudaGetLastError().
extern "C" int outlier_launch(const float* d0, const float* d1, float* out,
                              int H, int W, int D, cudaStream_t stream) {
  const size_t smem = (size_t)W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      outlier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  outlier_kernel<<<H, NT, smem, stream>>>(d0, d1, out, W, D);
  return (int)cudaGetLastError();
}
