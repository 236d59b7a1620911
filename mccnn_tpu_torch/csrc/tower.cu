// The towers' passes after each convolution, and the slow volumes' masks.
//
// Replace the plain torch passes of models/towers.py (the bias add, the
// rounding to the compute dtype, ReLU, l2_normalize), ops/join.py (_prep,
// the join's zero-padded channel-major operands) and ops/slow_head.py /
// ops/costs.py / pipeline.py (masked_volumes, fix_border, the disp_true
// mask), the counterparts of what XLA fuses into the convolution's epilogue
// and the join's operand prep on the TPU (mccnn_tpu/models/towers.py:84-100,
// mccnn_tpu/ops/join_pallas.py:306-312, mccnn_tpu/ops/slow_head_pallas.py:
// 218-226, mccnn_tpu/ops/costs.py:180, mccnn_tpu/pipeline.py:120-125). Each
// does its plain version's float32 operations in its order, rounded where
// it rounds, so each gives its bits. All three are bound by their bytes.
//
// Storage codes S (the compute dtype's rounding): 0 float32 (none), 1
// bfloat16, 2 float16, each round to nearest even by cvt.rn (torch's casts
// on the card), the rounded value held widened to float32 (round_s, and
// bias_act for a layer's bias and ReLU, in csrc/epilogue.cuh, which the
// convolutions' fused epilogue shares).
//
// tower_bias_act_kernel (entry tower_bias_act): in place on the (N, C, H, W)
// output of a bias-free convolution, x = act(round_S(x + b[c])), act ReLU as
// torch.relu computes it (NaN kept, else fmaxf(x, 0)) or none. A thread takes
// one 16-byte group of a channel plane, the plane's unaligned head and tail
// one float each; the bias is one register a block (grid.y = the plane).
// Prediction no longer runs it: the convolutions of csrc/conv.cu apply the
// same bias_act in their epilogue, and this kernel is the unfused route
// that the fused epilogue is held to, bit for bit.
//
// tower_normalize_kernel (entry tower_normalize): the fast tower's last
// layer, from its bias-free (N, C, H, W) convolution output: per pixel
// v_c = round_S(x_c + b_c), then v_c / sqrt(sum_c v_c * v_c + eps) at the
// rounding points of l2_normalize on a dtype tensor: the squares rounded,
// the sum (float32, rounded once), + eps rounded, sqrt rounded, each
// quotient rounded. The sum runs in the order of torch's reduction over a
// strided channel axis (Reduce.cuh): Y thread rows each take the channels
// y, y + Y, ... into four interleaved accumulators combined in order, then
// the rows combine as a tree (offsets Y/2, ..., 1); ops/tower.py
// channel_sum_plain writes the same order out and sum_rows picks Y. A
// block takes a run of TXN = 128 columns of one row of one image: a thread
// a pixel, its C values in registers (C = 64) or read twice (any other C),
// the normalized values into a shared tile of C rows; then a warp a channel
// at a time writes the run out in 16-byte stores from the first 16-byte
// boundary, a scalar head and tail (store_run). Written either as the
// features (N, C, H, W) or, for the join (pack), as its four zero-padded
// channel-major operands: image 0's row y x-reversed into a_l (Hp, C, Wa)
// and natural into b_r (Hp, C, Wb), image 1's reversed into b_l (Hp, C, Wb)
// and natural into a_r (Hp, C, Wa), +0.0 in rows past H and columns past
// W; without b_r and a_r for one side. The run of columns x0 .. x0 + 127
// writes the natural columns x0 .. x0 + 127 and the reversed ones
// W-1-x of its pixels, and the zero pad among x0 .. x0 + 127 of both.
//
// slow_volumes_epilogue_kernel (entry slow_volumes_epilogue): from the head
// scores s (D, H, W), vol_l[d, y, x] = s[d, y, xl] if xl >= d else NaN with
// xl = W-1-n for x >= W-n else x, and vol_r[d, y, x] = s[d, y, xr + d] if
// xr + d < W else NaN with xr = n for x < n else x; every cell 1e9 where
// d >= d_true. NaN is 0x7fc00000, the bits torch.nan writes; the rest are
// copies. A block takes one (d, y) row: the row of s staged in shared memory
// once (16-byte loads from the row's first 16-byte boundary, a scalar head
// and tail), both outputs' rows stored the same way.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"  // round_s, relu, bias_act

namespace {

constexpr int NT = 256;   // threads of a bias / epilogue block
constexpr int NTN = 128;  // threads of a normalize block
constexpr int TXN = NTN;  // the columns of a normalize block's run of a row
constexpr int TP = TXN + 4;  // the pitch of its tile's rows (16-byte aligned)
constexpr int YMAX = 512;  // the most thread rows of a torch reduction

template <int S, bool RELU>
__global__ void __launch_bounds__(NT)
tower_bias_act_kernel(float* __restrict__ x, const float* __restrict__ bias,
                      int C, long long P) {
  const long long plane = blockIdx.y;
  const float b = __ldg(bias + plane % C);
  float* p = x + plane * P;
  // the plane's first 16-byte boundary, the groups after it, the tail
  const long long head = (4 - (long long)((uintptr_t)p / 4 % 4)) % 4;
  const long long h = head < P ? head : P;
  const long long ngrp = (P - h) / 4;
  const long long k = (long long)blockIdx.x * NT + threadIdx.x;
  if (k < ngrp) {
    float4* q = reinterpret_cast<float4*>(p + h) + k;
    float4 v = *q;
    v.x = bias_act<S, RELU>(v.x, b);
    v.y = bias_act<S, RELU>(v.y, b);
    v.z = bias_act<S, RELU>(v.z, b);
    v.w = bias_act<S, RELU>(v.w, b);
    *q = v;
  }
  if (k < h) p[k] = bias_act<S, RELU>(p[k], b);
  const long long t = h + 4 * ngrp + k;
  if (k < 4 && t < P) p[t] = bias_act<S, RELU>(p[t], b);
}

// the squared, rounded value of channel c
template <int S, typename F>
__device__ __forceinline__ float sq(F val, int c) {
  const float v = val(c);
  return round_s<S>(__fmul_rn(v, v));
}

// row y's share of sum_c val(c)^2 in torch's strided reduction with Y
// thread rows: the channels y + Y * (i + 4k) into accumulator i, then
// ((a0 + a1) + a2) + a3 (unrolled where C and Y are constants)
template <int S, typename F>
__device__ __forceinline__ float row_sumsq(F val, int C, int Y, int y) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int idx = y;
#pragma unroll
  for (; idx + 3 * Y < C; idx += 4 * Y) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i] = __fadd_rn(acc[i], sq<S>(val, idx + i * Y));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (idx < C) acc[i] = __fadd_rn(acc[i], sq<S>(val, idx));
    idx += Y;
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
}

// sum_c val(c)^2 in the order of torch's strided reduction with Y thread
// rows (see the header): the rows' shares combined as a tree. YT fixes Y
// at compile time (registers); YT = 0 takes any Y up to YMAX from local
// memory (images of a few pixels, whose blocks are 1 wide and Y tall)
template <int CT, int YT, int S, typename F>
__device__ __forceinline__ float ordered_sumsq(F val, int C_rt, int Y_rt) {
  const int C = CT ? CT : C_rt;
  if (YT) {
    float part[YT ? YT : 1];
#pragma unroll
    for (int y = 0; y < YT; ++y) part[y] = row_sumsq<S>(val, C, YT, y);
#pragma unroll
    for (int off = YT / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int y = 0; y < off; ++y) part[y] = __fadd_rn(part[y], part[y + off]);
    }
    return part[0];
  }
  float part[YMAX];
#pragma unroll 1
  for (int y = 0; y < Y_rt; ++y) part[y] = row_sumsq<S>(val, C, Y_rt, y);
#pragma unroll 1
  for (int off = Y_rt / 2; off > 0; off >>= 1) {
#pragma unroll 1
    for (int y = 0; y < off; ++y) part[y] = __fadd_rn(part[y], part[y + off]);
  }
  return part[0];
}

struct Pack {
  float* rev;     // the x-reversed operand of this image, width wrev
  float* nat;     // the natural one, width wnat (null: one side)
  int wrev, wnat;
};

// row[x] for x in [lo, hi), the row's element 0 at ``phase`` floats past a
// 16-byte boundary: tile[x - base] (tile[base - x] with REV), or +0.0
// without a tile. One warp: 16-byte stores on the run's 16-byte groups
// (a run of up to TXN + 3 floats, a group a lane), the head and the tail
// one float a lane.
template <bool REV>
__device__ __forceinline__ void store_run(float* row, int phase, int lo,
                                          int hi, const float* tile,
                                          int base, int lane) {
  if (lo >= hi) return;
  const int a = min(hi, lo + (4 - (phase + lo) % 4) % 4);
  const int b = max(a, hi - (phase + hi) % 4);
  auto val = [&](int x) {
    return tile ? tile[REV ? base - x : x - base] : 0.0f;
  };
  for (int g = a + 4 * lane; g < b; g += 128) {
    float4 q;
    if (!REV && tile && (g - base) % 4 == 0) {
      q = *reinterpret_cast<const float4*>(tile + g - base);
    } else {
      q = make_float4(val(g), val(g + 1), val(g + 2), val(g + 3));
    }
    *reinterpret_cast<float4*>(row + g) = q;
  }
  if (lane < a - lo) row[lo + lane] = val(lo + lane);
  if (lane < hi - b) row[b + lane] = val(b + lane);
}

template <int CT, int YT, int S>
__global__ void __launch_bounds__(NTN)
tower_normalize_kernel(const float* __restrict__ x,
                       const float* __restrict__ bias, float* __restrict__ out,
                       Pack p0, Pack p1, int C_rt, int Y, int H, int W,
                       int pack) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);  // C rows of TP floats
  const int C = CT ? CT : C_rt;
  const int n = blockIdx.z, y = blockIdx.y, x0 = blockIdx.x * TXN;
  const int t = threadIdx.x, col = x0 + t;
  const bool frame = y < H;
  const long long HW = (long long)H * W;
  // each pixel of the block's run of the row, normalized, into the tile
  if (frame && col < W) {
    const float* src = x + (long long)n * C * HW + (long long)y * W + col;
    float v[CT ? CT : 1];
    if (CT) {
#pragma unroll
      for (int c = 0; c < (CT ? CT : 1); ++c)
        v[c] = round_s<S>(__fadd_rn(__ldg(src + c * HW), __ldg(bias + c)));
    }
    auto val = [&](int c) {
      return CT ? v[c] : round_s<S>(__fadd_rn(__ldg(src + c * HW),
                                              __ldg(bias + c)));
    };
    const float s = round_s<S>(ordered_sumsq<CT, YT, S>(val, C, Y));
    const float e = round_s<S>(__fadd_rn(s, 1e-5f));
    const float r = round_s<S>(__fsqrt_rn(e));
#pragma unroll
    for (int c = 0; c < C; ++c)
      tile[c * TP + t] = round_s<S>(__fdiv_rn(val(c), r));
  }
  __syncthreads();
  // the tile's rows out, a warp a channel at a time
  const int lane = t % 32, xe = min(x0 + TXN, W);
  const Pack p = n ? p1 : p0;
  for (int c = t / 32; c < C; c += NTN / 32) {
    const float* tc = tile + c * TP;
    if (!pack) {
      const long long off = ((long long)n * C + c) * HW + (long long)y * W;
      store_run<false>(out + off, (int)(off % 4), x0, xe, tc, x0, lane);
      continue;
    }
    const long long r = (long long)y * C + c;
    float* rev = p.rev + r * p.wrev;
    const int re = min(x0 + TXN, p.wrev);
    if (frame) {
      // this run's pixels at W-1-x, and the zero pad past W
      store_run<true>(rev, 0, W - xe, W - x0, tc, W - 1 - x0, lane);
      store_run<false>(rev, 0, max(x0, W), re, nullptr, 0, lane);
    } else {
      store_run<false>(rev, 0, x0, re, nullptr, 0, lane);
    }
    if (p.nat) {
      float* nat = p.nat + r * p.wnat;
      const int ne = min(x0 + TXN, p.wnat);
      if (frame) {
        store_run<false>(nat, 0, x0, min(xe, ne), tc, x0, lane);
        store_run<false>(nat, 0, max(x0, W), ne, nullptr, 0, lane);
      } else {
        store_run<false>(nat, 0, x0, ne, nullptr, 0, lane);
      }
    }
  }
}

__device__ __forceinline__ float epi_l(const float* row, int x, int d, int W,
                                       int n) {
  const int xl = x >= W - n ? W - 1 - n : x;
  return xl >= d ? row[xl] : __int_as_float(0x7fc00000);
}

__device__ __forceinline__ float epi_r(const float* row, int x, int d, int W,
                                       int n) {
  const int xr = x < n ? n : x;
  return xr + d < W ? row[xr + d] : __int_as_float(0x7fc00000);
}

__global__ void __launch_bounds__(NT)
slow_volumes_epilogue_kernel(const float* __restrict__ s,
                             float* __restrict__ vl, float* __restrict__ vr,
                             int H, int W, int n, int d_true) {
  extern __shared__ float row[];
  const int y = blockIdx.x, d = blockIdx.y;
  const long long off = ((long long)d * H + y) * W;
  // s, vl and vr rows share their offset, so one split serves all three
  const int head = min(W, (int)((4 - (off % 4)) % 4));
  const int ngrp = (W - head) / 4;
  const int tail = head + 4 * ngrp;
  const bool masked = d >= d_true;
  if (!masked) {
    const float* src = s + off;
    for (int i = threadIdx.x; i < ngrp; i += NT) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src + head) + i);
      float* r = row + head + 4 * i;
      r[0] = q.x;
      r[1] = q.y;
      r[2] = q.z;
      r[3] = q.w;
    }
    if (threadIdx.x < head) row[threadIdx.x] = __ldg(src + threadIdx.x);
    if (tail + (int)threadIdx.x < W)
      row[tail + threadIdx.x] = __ldg(src + tail + threadIdx.x);
    __syncthreads();
  }
  const float big = 1e9f;
  float* dl = vl + off;
  float* dr = vr + off;
  for (int i = threadIdx.x; i < ngrp; i += NT) {
    const int x = head + 4 * i;
    float4 a, b;
    if (masked) {
      a = make_float4(big, big, big, big);
      b = a;
    } else {
      a = make_float4(epi_l(row, x, d, W, n), epi_l(row, x + 1, d, W, n),
                      epi_l(row, x + 2, d, W, n), epi_l(row, x + 3, d, W, n));
      b = make_float4(epi_r(row, x, d, W, n), epi_r(row, x + 1, d, W, n),
                      epi_r(row, x + 2, d, W, n), epi_r(row, x + 3, d, W, n));
    }
    reinterpret_cast<float4*>(dl + head)[i] = a;
    reinterpret_cast<float4*>(dr + head)[i] = b;
  }
  // the head's and the tail's columns, fewer than 4 each
  for (int j = 0; j < 2; ++j) {
    const int x = (j ? tail : 0) + (int)threadIdx.x;
    if (x < W && (x < head || x >= tail)) {
      dl[x] = masked ? big : epi_l(row, x, d, W, n);
      dr[x] = masked ? big : epi_r(row, x, d, W, n);
    }
  }
}

template <int S>
int launch_bias_act(float* x, const float* bias, int N, int C, long long P,
                    int relu, cudaStream_t stream) {
  const long long groups = P / 4 + 1;
  const dim3 grid((unsigned)((groups + NT - 1) / NT), N * C);
  if (relu)
    tower_bias_act_kernel<S, true><<<grid, NT, 0, stream>>>(x, bias, C, P);
  else
    tower_bias_act_kernel<S, false><<<grid, NT, 0, stream>>>(x, bias, C, P);
  return (int)cudaGetLastError();
}

template <int S>
int launch_normalize(const float* x, const float* bias, float* out, Pack p0,
                     Pack p1, int N, int C, int Y, int H, int W, int rows,
                     int cols, int pack, cudaStream_t stream) {
  const dim3 grid((cols + TXN - 1) / TXN, rows, N);
  const size_t smem = (size_t)C * TP * sizeof(float);
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, NTN, smem, stream>>>(x, bias, out, p0, p1, C, Y, H, W,
                                        pack);
    return (int)cudaGetLastError();
  };
  if (C == 64 && Y == 4) return go(tower_normalize_kernel<64, 4, S>);
  if (C == 64 && Y == 1) return go(tower_normalize_kernel<64, 1, S>);
  return go(tower_normalize_kernel<0, 0, S>);
}

}  // namespace

// x: (N, C, H, W) float32, in place; bias: (C,) float32; P = H * W;
// code: the storage code S; relu: 0 or 1.
extern "C" int tower_bias_act(float* x, const float* bias, int N, int C,
                              long long P, int code, int relu,
                              cudaStream_t stream) {
  if (N < 1 || C < 1 || (long long)N * C > 65535 || code < 0 || code > 2)
    return (int)cudaErrorInvalidValue;
  if (P <= 0) return (int)cudaGetLastError();
  if (code == 1) return launch_bias_act<1>(x, bias, N, C, P, relu, stream);
  if (code == 2) return launch_bias_act<2>(x, bias, N, C, P, relu, stream);
  return launch_bias_act<0>(x, bias, N, C, P, relu, stream);
}

// x: (N, C, H, W) float32, the bias-free convolution; bias: (C,); Y: the
// thread rows of the sum order (a power of 2 up to YMAX). Without pack, out
// (N, C, H, W); with pack (N = 2), a_l, b_l (and a_r, b_r unless null) of
// (Hp, C, Wa) / (Hp, C, Wb), Hp >= H, Wa >= W.
extern "C" int tower_normalize(const float* x, const float* bias, float* out,
                               float* a_l, float* b_l, float* a_r, float* b_r,
                               int N, int C, int Y, int H, int W, int Hp,
                               int Wa, int Wb, int code, cudaStream_t stream) {
  const bool pack = a_l != nullptr;
  if (N < 1 || C < 1 || Y < 1 || Y > YMAX || (Y & (Y - 1)) || code < 0
      || (size_t)C * TP * sizeof(float) > 227 * 1024
      || code > 2 || (pack && (N != 2 || Hp < H || Wa < W || Wb < Wa
                               || (a_r == nullptr) != (b_r == nullptr)
                               || Hp > 65535))
      || (!pack && H > 65535))
    return (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return (int)cudaGetLastError();
  // image 0: a_l reversed, b_r natural; image 1: b_l reversed, a_r natural
  const Pack p0{a_l, b_r, Wa, Wb}, p1{b_l, a_r, Wb, Wa};
  const int rows = pack ? Hp : H, cols = pack ? Wb : W;
  if (code == 1)
    return launch_normalize<1>(x, bias, out, p0, p1, N, C, Y, H, W, rows, cols,
                               pack, stream);
  if (code == 2)
    return launch_normalize<2>(x, bias, out, p0, p1, N, C, Y, H, W, rows, cols,
                               pack, stream);
  return launch_normalize<0>(x, bias, out, p0, p1, N, C, Y, H, W, rows, cols,
                             pack, stream);
}

// s: (D, H, W) float32; vl, vr: (D, H, W) float32; 0 <= n < W; d_true <= D
// (the cells d >= d_true hold 1e9).
extern "C" int slow_volumes_epilogue(const float* s, float* vl, float* vr,
                                     int D, int H, int W, int n, int d_true,
                                     cudaStream_t stream) {
  if (D < 1 || D > 65535 || n < 0 || (W > 0 && n >= W)
      || (size_t)W * sizeof(float) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slow_volumes_epilogue_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  slow_volumes_epilogue_kernel<<<dim3(H, D), NT, smem, stream>>>(
      s, vl, vr, H, W, n, d_true);
  return (int)cudaGetLastError();
}
