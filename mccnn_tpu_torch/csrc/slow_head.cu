// Slow-arch cost volume: the FC head's fused MLP chain over every disparity.
//
// Replaces the TPU kernel _head_chain_kernel / slow_head_volume_mxu of
// mccnn_tpu/ops/slow_head_pallas.py. For every cell (d, y, x):
//   h0 = relu(A[y, x] + B[y, x - d])                      float32
//   h  = relu(bf16(h) @ bf16(W_m) + b_m)  per mid layer,  float32 accumulate
//   s  = sigmoid(h . w_last + b_last)                      float32
// with bf16 rounding by __float2bfloat16_rn (round to nearest even, as
// astype(bfloat16)); a bf16 x bf16 product is exact in float32, so this
// kernel and the plain chain differ only in summation order. A and B are
// the factored head layer 0 (A carries its bias); the last mid layer's
// output enters the final dot unrounded, as on the TPU.
//
// Bound on the H100: operations. Each cell needs 2 * n_mid * C^2 flops,
// 8.3e13 at KITTI size (370x1226, D=228, C=384, three mid layers, cells
// with x >= d only): 84 ms at the 989 TFLOP/s bf16 dense peak; the bytes
// (A and B read once, the (D, H, W) volume written once) are about 1.8 GB,
// 0.5 ms. So the tensor cores must do the work (on the CUDA cores at the
// 67 TFLOP/s float32 peak it would take 1.2 s).
//
// Design (simple and right first; wgmma and TMA are for a later version):
// - A tile is 128 cells of one (y, d): columns x0 .. x0+127. h0 is built
//   from A and B straight from global memory (L2: tiles are ordered with d
//   fastest, so the blocks running together share A's strip and overlap in
//   B's) and stored as bf16 in shared memory, 128 x C, rows padded by 16
//   bytes so that ldmatrix is free of bank conflicts.
// - The mid weights (3 x 384 x 384 bf16 = 864 KB) do not fit in shared
//   memory: they stream through it as K-slabs of 64 rows (all C output
//   columns), double-buffered with cp.async, one slab ahead of the
//   compute (208 KB of shared memory at C = 384, one block per SM). The
//   weights arrive as (out, in) rows, so A and B fragments are both plain
//   ldmatrix.x4 loads. (64-row slabs measured 9% faster than 32-row ones,
//   though they spill a few registers.)
// - 16 warps in a 4 (rows) x 4 (columns) grid; each warp owns a 32 x C/4
//   tile of the layer's output in registers (mma.sync.m16n8k16 bf16 ->
//   f32). After the K loop the epilogue adds the bias, applies ReLU and
//   writes bf16 back over the activation tile (one buffer: every warp has
//   finished reading it), or, after the last mid layer, reduces h . w_last
//   across the quad and the four column warps.
// - Persistent blocks, as many as fit on the SMs (one per SM), walk the
//   tiles; the weight stream runs on across layer and tile boundaries.
//   Tiles whose 128 columns all have x < d are skipped (about 9% of the
//   work at KITTI size).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // cells per tile
constexpr int KS = 64;            // rows of one weight slab
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 4;
constexpr int MIN_BLOCKS = 1;     // resident blocks per SM the registers allow
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MT = BM / WARPS_M / 16;  // m16 tiles per warp

template <int CP>
struct Tile {
  static constexpr int WN = CP / WARPS_N;  // output columns per warp
  static constexpr int NT = WN / 8;        // n8 tiles per warp
  static constexpr int ACT_LD = CP + 8;    // bf16 per activation row
  static constexpr int W_LD = KS + 8;      // bf16 per weight slab row
  static constexpr int SLABS = CP / KS;    // slabs per layer
  static constexpr int ACT_BYTES = BM * ACT_LD * 2;
  static constexpr int WBUF_BYTES = CP * W_LD * 2;
  static constexpr int SMEM = ACT_BYTES + 2 * WBUF_BYTES + BM * WARPS_N * 4;
  static_assert(CP % (WARPS_N * 16) == 0, "C must be a multiple of 64");
  static_assert(CP % KS == 0, "C must be a multiple of the slab depth");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the cp.async copies of weight slab q (layer q / SLABS, input rows
// k0 .. k0 + KS) into buf: (out, in) weights, row n of the slab = output n.
template <int CP>
__device__ __forceinline__ void load_slab(__nv_bfloat16* buf,
                                          const __nv_bfloat16* __restrict__ wt,
                                          int q) {
  using T = Tile<CP>;
  const int m = q / T::SLABS;
  const int k0 = (q % T::SLABS) * KS;
  const __nv_bfloat16* src = wt + (size_t)m * CP * CP + k0;
  constexpr int CHUNKS = KS / 8;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < CP * CHUNKS; i += THREADS) {
    const int n = i / CHUNKS, c = i % CHUNKS;
    cp_async16(buf + n * T::W_LD + c * 8, src + (size_t)n * CP + c * 8);
  }
}

template <int CP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    head_chain_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      const __nv_bfloat16* __restrict__ wt,
                      const float* __restrict__ mids_b,
                      const float* __restrict__ w_last, float b_last,
                      float* __restrict__ out, int H, int W, int D, int n_mid,
                      int n_strips, long long n_tiles) {
  using T = Tile<CP>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem + T::ACT_BYTES);
  float* red = reinterpret_cast<float*>(smem + T::ACT_BYTES + 2 * T::WBUF_BYTES);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_slabs = n_mid * T::SLABS;  // per tile, the weight stream's period

  // ldmatrix lane offsets: A rows (lane & 15), k half (lane >> 4); B output
  // rows (lane & 7) + 8 * (lane >> 4), k half ((lane >> 3) & 1)
  const __nv_bfloat16* a_base =
      act + (wm * (BM / WARPS_M) + (lane & 15)) * T::ACT_LD + (lane >> 4) * 8;
  const int b_off = (wn * T::WN + (lane & 7) + ((lane >> 4) << 3)) * T::W_LD +
                    ((lane >> 3) & 1) * 8;

  load_slab<CP>(wbuf, wt, 0);
  cp_async_commit();
  int q = 0, buf = 0;  // slab in flight to buf, modulo n_slabs

  float acc[MT][T::NT][4];
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int d = (int)(tile % D);
    const long long rest = tile / D;
    const int x0 = (int)(rest % n_strips) * BM;
    const int y = (int)(rest / n_strips);
    if (x0 + BM - 1 < d) continue;  // every cell has x - d < 0

    // h0 = relu(A + B_shifted) -> bf16 activation tile
    const float* arow = A + (size_t)y * W * CP;
    const float* brow = B + (size_t)y * W * CP;
    for (int i = tid; i < BM * (CP / 4); i += THREADS) {
      const int r = i / (CP / 4), c = (i % (CP / 4)) * 4;
      const int x = min(x0 + r, W - 1);
      const int xb = max(min(x0 + r - d, W - 1), 0);
      const float4 a = __ldg(reinterpret_cast<const float4*>(arow + (size_t)x * CP + c));
      const float4 b = __ldg(reinterpret_cast<const float4*>(brow + (size_t)xb * CP + c));
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(act + r * T::ACT_LD + c);
      dst[0] = __floats2bfloat162_rn(fmaxf(a.x + b.x, 0.f), fmaxf(a.y + b.y, 0.f));
      dst[1] = __floats2bfloat162_rn(fmaxf(a.z + b.z, 0.f), fmaxf(a.w + b.w, 0.f));
    }

    for (int m = 0; m < n_mid; ++m) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

      for (int s = 0; s < T::SLABS; ++s) {
        // the next slab streams in while this one is multiplied
        const int qn = q + 1 == n_slabs ? 0 : q + 1;
        load_slab<CP>(wbuf + (buf ^ 1) * (T::WBUF_BYTES / 2), wt, qn);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const __nv_bfloat16* wb = wbuf + buf * (T::WBUF_BYTES / 2) + b_off;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 16) {
          uint32_t af[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i)
            ldmatrix_x4(af[i], a_base + i * 16 * T::ACT_LD + s * KS + kk);
#pragma unroll
          for (int j = 0; j < T::NT; j += 2) {
            uint32_t bf[4];
            ldmatrix_x4(bf, wb + j * 8 * T::W_LD + kk);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
              mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
            }
          }
        }
        __syncthreads();  // every warp is done with buf and, at the end, act
        q = qn;
        buf ^= 1;
      }

      // epilogue: bias + ReLU; bf16 into act for the next layer, or the
      // final dot with w_last
      const float* bias = mids_b + (size_t)m * CP;
      const bool last = m == n_mid - 1;
      float part[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) part[i][0] = part[i][1] = 0.f;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int col = wn * T::WN + j * 8 + 2 * t4;
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
        const float w0 = last ? __ldg(w_last + col) : 0.f;
        const float w1 = last ? __ldg(w_last + col + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float h00 = fmaxf(acc[i][j][0] + b0, 0.f);
          const float h01 = fmaxf(acc[i][j][1] + b1, 0.f);
          const float h10 = fmaxf(acc[i][j][2] + b0, 0.f);
          const float h11 = fmaxf(acc[i][j][3] + b1, 0.f);
          if (last) {
            part[i][0] += h00 * w0 + h01 * w1;
            part[i][1] += h10 * w0 + h11 * w1;
          } else {
            const int r = wm * (BM / WARPS_M) + i * 16 + g;
            *reinterpret_cast<__nv_bfloat162*>(act + r * T::ACT_LD + col) =
                __floats2bfloat162_rn(h00, h01);
            *reinterpret_cast<__nv_bfloat162*>(act + (r + 8) * T::ACT_LD + col) =
                __floats2bfloat162_rn(h10, h11);
          }
        }
      }
      if (last) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = part[i][h];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (t4 == 0) red[(wm * (BM / WARPS_M) + i * 16 + g + 8 * h) * WARPS_N + wn] = v;
          }
        }
        __syncthreads();
        if (tid < BM && x0 + tid < W) {
          float z = b_last;
#pragma unroll
          for (int w = 0; w < WARPS_N; ++w) z += red[tid * WARPS_N + w];
          out[((size_t)d * H + y) * W + x0 + tid] = 1.f / (1.f + expf(-z));
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int CP>
int launch(const float* A, const float* B, const __nv_bfloat16* wt,
           const float* mids_b, const float* w_last, float b_last, float* out,
           int H, int W, int D, int n_mid, cudaStream_t stream) {
  using T = Tile<CP>;
  cudaError_t err = cudaFuncSetAttribute(
      head_chain_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, head_chain_kernel<CP>,
                                                      THREADS, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_strips = (W + BM - 1) / BM;
  const long long n_tiles = (long long)H * n_strips * D;
  if (n_tiles == 0) return 0;
  const long long slots = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(n_tiles < slots ? n_tiles : slots);
  head_chain_kernel<CP><<<grid, THREADS, T::SMEM, stream>>>(
      A, B, wt, mids_b, w_last, b_last, out, H, W, D, n_mid, n_strips, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// A, B: (H, W, C) float32; wt: (n_mid, C, C) bf16, each layer as (out, in)
// rows; mids_b: (n_mid, C) float32; w_last: (C,) float32; out: (D, H, W)
// float32, cells with x - d < 0 may be left unwritten. C is 384 (the nh2 of
// every configuration) or 64 (narrow heads; the caller zero-pads other
// widths up to one of these); n_mid >= 1. Returns cudaGetLastError() (or
// the error of raising the kernel's shared memory limit); 1
// (cudaErrorInvalidValue) for a width it has no instance of.
extern "C" int slow_head(const float* A, const float* B, const __nv_bfloat16* wt,
                         const float* mids_b, const float* w_last, float b_last,
                         float* out, int H, int W, int D, int C, int n_mid,
                         cudaStream_t stream) {
  switch (C) {
    case 64:
      return launch<64>(A, B, wt, mids_b, w_last, b_last, out, H, W, D, n_mid, stream);
    case 384:
      return launch<384>(A, B, wt, mids_b, w_last, b_last, out, H, W, D, n_mid, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
