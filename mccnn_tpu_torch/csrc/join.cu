// Fast-arch cost-volume join in the disparity-minor (Hp, Wp, Dp) layout.
//
// Replaces the TPU kernel mccnn_tpu/ops/join_pallas.py::_join_plus:
//   out[y, x, d] = -<a[y, :, x], b[y, :, x + d]>
// NaN where x + d >= W, d >= D or y >= H; rows x < n_fix of the first
// column tile replaced by row n_fix, NaNs included (fix_border,
// main.lua:922-927). Both reference sides run this kernel: the left side
// on x-flipped maps (the mirror identity), so its volume comes out
// x-reversed.
//
// Bound on the H100: at KITTI size (H=370, W=1226, C=64, D=228) one side
// needs 13.2 GFLOP of f32 FMA (0.20 ms at 67 TFLOP/s) and writes a
// 503 MB volume (0.15 ms at 3.35 TB/s): the f32 pipes bound it. The dot
// is plain f32 FMA, not TF32: TF32 moves WTA decisions, and the JAX dot
// is a bf16x3 split good to about 1e-7.
//
// Design: one block per (row y, 128-column tile). The (C, 128) reference
// tile and the (C, 128 + Dp) match slab are staged in shared memory
// (128 KB at C=64, Dp=256: dynamic shared memory above 48 KB). A TPU
// shear is not needed: threads index b[x + d] directly. Each thread
// computes an 8 (x) by 8 (d) register tile, so one k-step reads 8 a
// values and 15 b values (six 16-byte loads) for 64 FMAs; consecutive
// threads own consecutive d-chunks, so the stores are 1 KB runs.

#include <cuda_runtime.h>

namespace {

constexpr int XT = 128;  // output columns per block
constexpr int NT = 256;  // threads per block

__global__ void __launch_bounds__(NT)
join_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ out, int H, int W, int C, int Wp, int Wb,
            int Dp, int D, int n_fix) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // C x XT
  const int SL = XT + Dp;
  float* Bs = As + C * XT;                      // C x SL
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * XT;

  const float* arow = a + (size_t)y * C * Wp + x0;
  for (int i = threadIdx.x; i < C * (XT / 4); i += NT) {
    const int c = i / (XT / 4), j = i % (XT / 4);
    reinterpret_cast<float4*>(As + c * XT)[j] =
        reinterpret_cast<const float4*>(arow + (size_t)c * Wp)[j];
  }
  const float* brow = b + (size_t)y * C * Wb + x0;
  for (int i = threadIdx.x; i < C * (SL / 4); i += NT) {
    const int c = i / (SL / 4), j = i % (SL / 4);
    reinterpret_cast<float4*>(Bs + c * SL)[j] =
        reinterpret_cast<const float4*>(brow + (size_t)c * Wb)[j];
  }
  __syncthreads();

  const int ndc = Dp / 8;
  const int items = (XT / 8) * ndc;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int dc = it % ndc, xc = it / ndc;
    const int xb = xc * 8, d0 = dc * 8;
    float acc[8][8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

    for (int c = 0; c < C; ++c) {
      const float4* ar = reinterpret_cast<const float4*>(As + c * XT + xb);
      const float4* br = reinterpret_cast<const float4*>(Bs + c * SL + xb + d0);
      float av[8], bv[16];
      float4 t;
      t = ar[0]; av[0] = t.x; av[1] = t.y; av[2] = t.z; av[3] = t.w;
      t = ar[1]; av[4] = t.x; av[5] = t.y; av[6] = t.z; av[7] = t.w;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        t = br[q];
        bv[4 * q] = t.x; bv[4 * q + 1] = t.y;
        bv[4 * q + 2] = t.z; bv[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc[j][k] = fmaf(av[j], bv[j + k], acc[j][k]);
    }

    const float qnan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = x0 + xb + j;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = d0 + k;
        const bool keep = (x + d < W) && (d < D) && (y < H);
        acc[j][k] = keep ? -acc[j][k] : qnan;
      }
    }
    // fix_border: in the first tile, rows x < n_fix are copies of row
    // n_fix (n_fix < 8, so all in this thread's first chunk). Only static
    // register indices: a runtime acc[n_fix] would put the tile in local
    // memory.
    const bool fix = x0 == 0 && xb == 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (fix && j < n_fix) continue;  // written from row n_fix below
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (jj != j && !(fix && j == n_fix && jj < n_fix)) continue;
        float4* o = reinterpret_cast<float4*>(
            out + ((size_t)y * Wp + x0 + xb + jj) * Dp + d0);
        o[0] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        o[1] = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
      }
    }
  }
}

}  // namespace

// a: (Hp, C, Wp), b: (Hp, C, Wb) with Wb >= Wp + Dp, out: (Hp, Wp, Dp),
// all float32 and contiguous. Wp % 128 == 0, Dp % 128 == 0,
// 0 <= n_fix < 8. Returns cudaGetLastError().
extern "C" int join_launch(const float* a, const float* b, float* out, int H,
                           int W, int C, int Hp, int Wp, int Wb, int Dp, int D,
                           int n_fix, cudaStream_t stream) {
  const size_t smem = (size_t)C * (2 * XT + Dp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Wp / XT, Hp);
  join_kernel<<<grid, NT, smem, stream>>>(a, b, out, H, W, C, Wp, Wb, Dp, D,
                                          n_fix);
  return (int)cudaGetLastError();
}
