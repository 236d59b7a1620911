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
// (1 us); each in-frame tap (1.04e9) takes four f32 instructions (the
// subtract, the compare of its magnitude with thresh, a fused multiply-add
// and an add, the last two predicated on the compare), 0.12 ms at the f32
// instruction rate (128 lanes a clock an SM): the operations bound it.
//
// Design: a thread computes P adjacent outputs of one row, a block TY
// rows of TX * P columns. The block stages its input halo, (TY + k - 1)
// rows of TX * P + KW values (KW = k rounded up to 4), and the k x KW
// weights (zero-padded) in shared memory. For each kernel row a thread
// walks its window of P + k - 1 values in registers: one 16-byte load
// brings four values, and each value serves up to P taps; one 16-byte
// broadcast load brings the weights of four columns, each serving P taps.
// So a tap costs 1/16 of a shared-memory instruction instead of two (the
// halo value and the weight), and the instruction rate sets the pace: the tap
// loop compiles to about 5.1 instructions a tap (the four, the window's
// shift and the addressing), and at KITTI size the busiest SM holds two
// blocks where the mean is 1.8. A thread's window starts 16-byte aligned;
// lanes P = 8 floats apart meet two-way bank conflicts on a 16-byte load,
// which at one load in 32 taps costs nothing that shows. Each output keeps
// the summation order of mean2d (kernel rows outer, columns inner, fmaf
// then the weight sum), so the result does not depend on P.

#include <cuda_runtime.h>

namespace {

constexpr int P = 8;          // outputs a thread, adjacent in a row
constexpr int TX = 32;        // threads along a row: one warp
constexpr int TY = 8;         // rows a block
constexpr int TW = TX * P;    // columns a block

__host__ __device__ constexpr int padded(int k) { return (k + 3) & ~3; }

// Bytes of dynamic shared memory a block needs for a k x k kernel
// (mirrored by ops/blur.py smem_bytes).
__host__ __device__ constexpr int smem_bytes(int k) {
  return ((TY + k - 1) * (TW + padded(k)) + k * padded(k)) * 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// win[OFF + q .. OFF + q + 3] = t
template <int OFF>
__device__ __forceinline__ void put4(float* win, int q, float4 t) {
  win[OFF + q] = t.x;
  win[OFF + q + 1] = t.y;
  win[OFF + q + 2] = t.z;
  win[OFF + q + 3] = t.w;
}

// The taps of kernel column dx0 + U for the P outputs: output j's value
// is win[j + U], the column's weight w.
template <int U>
__device__ __forceinline__ void taps(const float (&win)[P + 4], float w,
                                     const float (&c)[P], float (&acc)[P],
                                     float (&cnt)[P], float thresh) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float v = win[j + U];
    if (fabsf(v - c[j]) < thresh) {  // false for NaN (out of frame)
      acc[j] = fmaf(w, v, acc[j]);
      cnt[j] += w;
    }
  }
}

__global__ void __launch_bounds__(TX * TY)
blur_kernel(const float* __restrict__ img, const float* __restrict__ kern,
            float* __restrict__ out, int H, int W, int ksz, float thresh) {
  extern __shared__ __align__(16) float sm[];
  const int r = ksz / 2;
  const int KW = padded(ksz);
  const int SW = TW + KW, SH = TY + ksz - 1;
  float* tile = sm;             // SH x SW
  float* wk = sm + SH * SW;     // ksz x KW, 16-byte aligned: SW % 4 == 0
  const int X0 = blockIdx.x * TW - r, Y0 = blockIdx.y * TY - r;
  const float qnan = __int_as_float(0x7fc00000);
  for (int i = threadIdx.y; i < SH; i += TY) {
    const int yy = Y0 + i;
    for (int j = threadIdx.x; j < SW; j += TX) {
      const int xx = X0 + j;
      tile[i * SW + j] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                             ? img[(size_t)yy * W + xx] : qnan;
    }
  }
  for (int i = threadIdx.y; i < ksz; i += TY)
    for (int j = threadIdx.x; j < KW; j += TX)
      wk[i * KW + j] = j < ksz ? kern[i * ksz + j] : 0.f;
  __syncthreads();

  const int y = blockIdx.y * TY + threadIdx.y;
  const int x = blockIdx.x * TW + threadIdx.x * P;  // the first of P columns
  if (y >= H || x >= W) return;
  // the window of output j at kernel column dx: base[dy * SW + j + dx]
  const float* base = tile + threadIdx.y * SW + threadIdx.x * P;
  float c[P], acc[P], cnt[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    c[j] = base[r * SW + r + j];
    acc[j] = 0.f;
    cnt[j] = 0.f;
  }
  for (int dy = 0; dy < ksz; ++dy) {
    const float* trow = base + dy * SW;
    const float* wrow = wk + dy * KW;
    float win[P + 4];  // win[j + u]: output j's value at kernel column dx0 + u
#pragma unroll
    for (int q = 0; q < P; q += 4) put4<0>(win + 0, q, ld4(trow + q));
    int dx0 = 0;
    for (; dx0 + 4 <= ksz; dx0 += 4) {
      put4<P>(win, 0, ld4(trow + dx0 + P));
      const float4 w = ld4(wrow + dx0);
      taps<0>(win, w.x, c, acc, cnt, thresh);
      taps<1>(win, w.y, c, acc, cnt, thresh);
      taps<2>(win, w.z, c, acc, cnt, thresh);
      taps<3>(win, w.w, c, acc, cnt, thresh);
#pragma unroll
      for (int i = 0; i < P; ++i) win[i] = win[i + 4];
    }
    // the last ksz - dx0 columns (1 to 3: ksz is odd)
    put4<P>(win, 0, ld4(trow + dx0 + P));
    const float4 w = ld4(wrow + dx0);
    const int rem = ksz - dx0;
    taps<0>(win, w.x, c, acc, cnt, thresh);
    if (rem > 1) taps<1>(win, w.y, c, acc, cnt, thresh);
    if (rem > 2) taps<2>(win, w.z, c, acc, cnt, thresh);
  }
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (x + j < W) out[(size_t)y * W + x + j] = acc[j] / cnt[j];
}

}  // namespace

// img, out: (H, W) float32; kern: (ksz, ksz) float32, ksz odd, with
// blur_smem_bytes(ksz) at most the card's shared memory a block; all
// contiguous. Returns cudaGetLastError().
extern "C" int blur_launch(const float* img, const float* kern, float* out,
                           int H, int W, int ksz, float thresh,
                           cudaStream_t stream) {
  const int smem = smem_bytes(ksz);
  cudaError_t err = cudaFuncSetAttribute(
      blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TY - 1) / TY);
  blur_kernel<<<grid, dim3(TX, TY), smem, stream>>>(img, kern, out, H, W, ksz,
                                                    thresh);
  return (int)cudaGetLastError();
}

// The dynamic shared memory blur_launch gives a block for a ksz x ksz
// kernel, in bytes.
extern "C" int blur_smem_bytes(int ksz) { return smem_bytes(ksz); }
