// Cross-based cost aggregation (CBCA): the support arms and one
// aggregation iteration.
//
// The JAX package runs both in XLA with no Pallas kernel
// (mccnn_tpu/ops/cross.py: cross_arms :20, cbca :67; reference
// adcensus.cu:280-341 and :343-400): the arms from a static unroll over arm
// length, the aggregation as 2K - 1 masked shifted adds a direction
// (K = max(2, L1)) under one lax.map over disparity, which XLA fuses. Eager
// PyTorch runs that formulation as some 7 launches a tap (ops/cross.py, the
// *_plain functions): at the Middlebury shape about 5,600 launches a CBCA
// iteration, each streaming a slab of the volume. These two kernels take
// their place, one launch a call, and give the plain versions' bits:
//
// cbca: a block takes one disparity and a tile of TY rows x TX columns. It
//   stages the volume (NaN read as 0) for its rows and columns and K - 1 more
//   on each side in shared memory; then, for every staged row and each of
//   its TX columns, the horizontal sum and count over the columns strictly
//   between the tighter of the two pixels' horizontal arms (the right image's
//   at x + d * dir, shifted back); then each output sums those over the rows
//   strictly between its own tighter vertical arms and divides. The plain
//   version adds where(mask, v, 0) for k = -(K-1) .. K-1 in ascending order
//   from +0; its masks cut one contiguous interval out of the window, and an
//   accumulator that starts at +0 is never -0, so adding the masked +0s
//   changes nothing: a loop over just the interval, clipped to the window and
//   to the frame, in ascending order from +0.0f, gives the same bits. No
//   prefix sum or other reordering: that would move the roundings. The
//   division is the IEEE quotient (__fdiv_rn) that torch's CUDA division
//   gives; the counts are exact integers (at most (2K - 1)^2). Cells whose
//   x + d * dir lies out of frame pass the volume through, NaN bits included,
//   and never read the right image's arms. On a row slab (the row-sharded
//   path) the halo rows' arms may point outside the slab: the clip to the
//   frame keeps every read inside it. Out of place: the halo reads forbid
//   in place. Bound: bytes, the volume read and written once and the two arm
//   stacks read (8 H W + 8 D H W bytes; 0.25 ms at KITTI size, 0.72 ms at
//   Middlebury's); the adds, 2 (2K - 1) a cell at most, stay below that at
//   the f32 instruction rate.
//
// cross_arms: a thread a pixel walks each of its four arms, k = 2 .. K - 1,
//   to the first in-frame probe with |c - p| >= tau1 (the subtraction in
//   round-to-nearest, the compare against tau1 as the f32 torch compares
//   with), caps the break at the frame and stores the exclusive end as a
//   float: exact. Bound: bytes, the image read and four planes written
//   (20 H W bytes).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;            // threads a block
constexpr int TX = 128, TY = 32;   // a cbca block's outputs: columns x rows

// the cbca block's staged volume ((TY + 2R) x (TX + 2R) floats, R = K - 1)
// and its rows' horizontal sums and counts ((TY + 2R) x TX each)
__host__ __device__ constexpr int cbca_smem(int K) {
  return ((TY + 2 * (K - 1)) * (TX + 2 * (K - 1))
          + 2 * (TY + 2 * (K - 1)) * TX) * 4;
}

// vol, out: (D, H, W); x0c, x1c: (4, H, W) exclusive arm ends as floats
__global__ void __launch_bounds__(NT)
cbca_kernel(const float* __restrict__ vol, const float* __restrict__ x0c,
            const float* __restrict__ x1c, float* __restrict__ out, int H,
            int W, int K, int dir) {
  extern __shared__ float smem[];
  const int R = K - 1;
  const int rows = TY + 2 * R, cols = TX + 2 * R;
  float* sv = smem;                                    // rows x cols
  float* sh = sv + rows * cols;                        // rows x TX
  int* sc = reinterpret_cast<int*>(sh + rows * TX);    // rows x TX
  const int d = blockIdx.z;
  const int bx = blockIdx.x * TX, by = blockIdx.y * TY;
  const int delta = d * dir;
  const size_t plane = (size_t)H * W;
  const float* v = vol + d * plane;

  for (int i = threadIdx.x; i < rows * cols; i += NT) {
    const int y = by - R + i / cols, x = bx - R + i % cols;
    float t = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      t = v[(size_t)y * W + x];
      if (isnan(t)) t = 0.f;
    }
    sv[i] = t;
  }
  __syncthreads();

  // each staged row's horizontal sum and count at the block's columns
  for (int i = threadIdx.x; i < rows * TX; i += NT) {
    const int r = i / TX, c = i % TX;
    const int y = by - R + r, x = bx + c;
    float s = 0.f;
    int n = 0;
    if (y >= 0 && y < H && x < W && x + delta >= 0 && x + delta < W) {
      const size_t p = (size_t)y * W + x;
      const int xs = max((int)x0c[p], (int)x1c[p + delta] - delta);
      const int xt = min((int)x0c[plane + p],
                         (int)x1c[plane + p + delta] - delta);
      const int lo = max(max(xs + 1, x - R), 0);
      const int hi = min(min(xt - 1, x + R), W - 1);
      const int row = r * cols + R - bx;  // + xx: column xx of the row
      for (int xx = lo; xx <= hi; ++xx) s = __fadd_rn(s, sv[row + xx]);
      n = max(hi - lo + 1, 0);
    }
    sh[i] = s;
    sc[i] = n;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TY * TX; i += NT) {
    const int y = by + i / TX, c = i % TX, x = bx + c;
    if (y >= H || x >= W) continue;
    const size_t p = (size_t)y * W + x;
    float o;
    if (x + delta < 0 || x + delta >= W) {
      o = v[p];
    } else {
      const int ys = max((int)x0c[2 * plane + p],
                         (int)x1c[2 * plane + p + delta]);
      const int yt = min((int)x0c[3 * plane + p],
                         (int)x1c[3 * plane + p + delta]);
      const int lo = max(max(ys + 1, y - R), 0);
      const int hi = min(min(yt - 1, y + R), H - 1);
      float s = 0.f;
      int n = 0;
      for (int yy = lo; yy <= hi; ++yy) {
        const int q = (yy - by + R) * TX + c;
        s = __fadd_rn(s, sh[q]);
        n += sc[q];
      }
      o = __fdiv_rn(s, fmaxf((float)n, 1.f));
    }
    out[d * plane + p] = o;
  }
}

// img: (H, W); arms: (4, H, W): [0] -x, [1] +x (column ends), [2] -y,
// [3] +y (row ends)
__global__ void __launch_bounds__(NT)
cross_arms_kernel(const float* __restrict__ img, float* __restrict__ arms,
                  int H, int W, int K, float tau1) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x, y = blockIdx.y;
  if (x >= W) return;
  const size_t p = (size_t)y * W + x;
  const float c = img[p];
  for (int a = 0; a < 4; ++a) {
    const bool horiz = a < 2;
    const int sign = (a & 1) ? 1 : -1;
    const int coord = horiz ? x : y, n = horiz ? W : H;
    int kb = K;
    for (int k = 2; k < K; ++k) {
      const int q = coord + sign * k;
      if (q < 0 || q >= n) break;  // every later probe is out of frame too
      const float t = horiz ? img[(size_t)y * W + q] : img[(size_t)q * W + x];
      if (fabsf(__fsub_rn(c, t)) >= tau1) {
        kb = k;
        break;
      }
    }
    kb = min(kb, sign < 0 ? coord + 1 : n - coord);
    arms[a * (size_t)H * W + p] = (float)(coord + sign * kb);
  }
}

}  // namespace

// Every entry: float32 tensors, contiguous, on the card; returns
// cudaGetLastError() after its one launch on `stream`.

extern "C" int cbca_smem_bytes(int K) { return cbca_smem(K); }

// One CBCA iteration: out = cbca(x0c, x1c, vol, dir, K) over vol (D, H, W).
extern "C" int cbca_launch(const float* vol, const float* x0c,
                           const float* x1c, float* out, int D, int H, int W,
                           int K, int dir, cudaStream_t stream) {
  const int smem = cbca_smem(K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cbca_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, D);
  cbca_kernel<<<grid, NT, smem, stream>>>(vol, x0c, x1c, out, H, W, K, dir);
  return (int)cudaGetLastError();
}

extern "C" int cross_arms_launch(const float* img, float* arms, int H, int W,
                                 int K, float tau1, cudaStream_t stream) {
  const dim3 grid((W + NT - 1) / NT, H);
  cross_arms_kernel<<<grid, NT, 0, stream>>>(img, arms, H, W, K, tau1);
  return (int)cudaGetLastError();
}
