// Thresholded-Gaussian blur.
//
// Replaces the TPU kernel mccnn_tpu/ops/blur_pallas.py::_blur_kernel
// (behavior contract: mean2d, adcensus.cu:1241-1261):
//   out[y, x] = sum_t w_t v_t / sum_t w_t
// over the in-frame taps t of the k x k window whose value v_t differs
// from the centre by less than thresh (w_t the Gaussian weight, rows
// outer, columns inner, as post.mean2d sums them). Inputs are finite by
// contract. Out-of-frame taps are staged as NaN, which fails the
// threshold compare: the bounds check, with the semantics of the JAX
// kernel's 1e30 pad.
//
// Bound on the H100: at KITTI size (370 x 1226, k = 49) it moves 3.6 MB
// (1 us) and does about seven f32 operations per tap, 7.6 G in all
// (0.11 ms at 67 TFLOP/s): the operations bound it. Design: one thread
// per pixel, a 32 x 16 output tile per block with its (16 + 2r) x (32 + 2r)
// input halo and the k x k weights in shared memory (29 KB at k = 49), so
// every tap reads shared memory; a warp reads 32 consecutive halo values
// per tap and one broadcast weight.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 16;

__global__ void __launch_bounds__(TX * TY)
blur_kernel(const float* __restrict__ img, const float* __restrict__ kern,
            float* __restrict__ out, int H, int W, int ksz, float thresh) {
  extern __shared__ float sm[];
  const int r = ksz / 2;
  const int SW = TX + 2 * r, SH = TY + 2 * r;
  float* tile = sm;             // SH x SW
  float* wk = sm + SH * SW;     // ksz x ksz
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int X0 = blockIdx.x * TX - r, Y0 = blockIdx.y * TY - r;
  const float qnan = __int_as_float(0x7fc00000);
  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int yy = Y0 + i / SW, xx = X0 + i % SW;
    tile[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? img[(size_t)yy * W + xx] : qnan;
  }
  for (int i = tid; i < ksz * ksz; i += TX * TY) wk[i] = kern[i];
  __syncthreads();

  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const float c = tile[(threadIdx.y + r) * SW + threadIdx.x + r];
  float acc = 0.f, cnt = 0.f;
  for (int dy = 0; dy < ksz; ++dy) {
    const float* trow = tile + (threadIdx.y + dy) * SW + threadIdx.x;
    const float* wrow = wk + dy * ksz;
    for (int dx = 0; dx < ksz; ++dx) {
      const float v = trow[dx];
      if (fabsf(v - c) < thresh) {  // false for NaN (out of frame)
        acc = fmaf(wrow[dx], v, acc);
        cnt += wrow[dx];
      }
    }
  }
  out[(size_t)y * W + x] = acc / cnt;
}

}  // namespace

// img, out: (H, W) float32; kern: (ksz, ksz) float32, ksz odd; all
// contiguous. Returns cudaGetLastError().
extern "C" int blur_launch(const float* img, const float* kern, float* out,
                           int H, int W, int ksz, float thresh,
                           cudaStream_t stream) {
  const int r = ksz / 2;
  const size_t smem =
      ((size_t)(TY + 2 * r) * (TX + 2 * r) + (size_t)ksz * ksz) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  blur_kernel<<<grid, dim3(TX, TY), smem, stream>>>(img, kern, out, H, W, ksz,
                                                    thresh);
  return (int)cudaGetLastError();
}
