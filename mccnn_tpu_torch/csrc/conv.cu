// The towers' SAME-padded 3x3 convolutions of prediction, bias-free, NCHW
// float32 in and out.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (mccnn_tpu/models/towers.py:84-87, conv_general_dilated NHWC/HWIO with
// preferred_element_type=float32), and the port ran them in cuDNN (f32,
// TF32 off) until this source. FastTower.infer and SlowNet.infer call
// ops/conv.py conv3x3 for every layer; the layer's bias, rounding and ReLU
// (or the fast tower's L2 normalization) then run on this output in
// csrc/tower.cu, unchanged.
//
// conv_first_kernel: the first layer, C_in = n_input_plane (1, or 3 for
// colour) -> C_out = fm, and every layer of a width that no wgmma instance
// takes (C_in up to 1365: the weights of a chunk of output channels in
// shared memory at a time; the narrow slow nets of the Middlebury search,
// fm 4-8, and the small nets of the tests). Bound on the H100: bytes, the
// fm output planes written once (KITTI fast: 232 MB, 0.069 ms at 3.35
// TB/s; 9 x 64 FMAs a pixel are 0.016 ms at 67 TFLOP/s).
// A SIMT kernel: a thread a pixel, its 3x3 window of up to 4 input planes
// in registers, the weights in shared memory (a broadcast read a tap), one
// FMA chain a channel from +0.0 in (c_in, ky, kx) order, and a warp's 32
// adjacent pixels of a channel stored in one coalesced 128-byte store. A
// tensor-core tile would pad K from 9 to 16 and buy nothing.
//
// conv_wgmma_kernel<C, MODE>: the layers after the first, C_in = C_out =
// C = fm in {64, 80, 96, 112} (the published nets' 64 and 112, and the
// fast net's hyperparameter search, fm 64, 80, 96), as implicit GEMMs on
// the tensor cores: M output pixels x N = C output channels, K = 9 taps x
// C input channels. Bound on
// the H100: operations. KITTI fast's three such layers are 1.0e11 f32
// multiply-adds (2 images x 370 x 1226 pixels x 64 x 576 x 3); in f32 (MODE
// 0) the kernel runs six bf16 products a multiply-add (below), 1.22 ms at
// 989 TFLOP/s, against 3.0 ms at the 67 TFLOP/s f32 peak that cuDNN runs
// at 0.6 of; the bytes (each layer's input read, its output written) are
// 0.14 ms a layer.
//
// Arithmetic (MODE 0, float32): each operand v is split into three bf16
// levels (round to nearest even) v1 = bf16(v), v2 = bf16(v - v1), v3 =
// bf16(v - v1 - v2), and the sum keeps the six products a_i.w_j with
// i + j <= 4 (1-based), each exact, summed in float32 on the tensor
// cores: csrc/join.cu's arithmetic. Each level is within 2^-8 of what is
// left, so a cell is within about 4 x 2^-24 sum |w||x| of the float32 sum,
// the size of the float32 rounding of the sums; ops/conv.py
// conv3x3_split_plain is its plain emulation. MODE 1 and 2 (-dtype
// bfloat16 and float16): the operands already hold values of the 16-bit
// type (models/towers.py rounds them), so one pass in that type has exact
// products, summed in float32: the rounding point of the layer.
//
// Design (one block an SM, persistent over tiles):
// - A tile is TR = 2 output rows x TM = 64 columns of one image. Two
//   compute warpgroups take a row each (wgmma M = 64, N = C), with C / 2
//   accumulators a thread. C = 96 and 112 in float32 run the tile in two
//   passes of 48 and 56 output channels (Conf::NH), so that a tap's
//   fragments of three levels (72, 84 registers) and both sets of sums
//   (below) fit without spills or serialized wgmma groups.
// - A (the activations) is staged once a tile: rows y - 1 .. y + 2,
//   columns x - 1 .. x + 64, zeros outside the frame, as float32 channel
//   rows of 68 floats (NCHW order: 4-byte asynchronous copies move it, a
//   warp's lanes adjacent pixels of one channel row; rows of W floats are
//   not 16-byte aligned in general). Each tap's A fragment (the wgmma
//   register layout: rows 16 w + g, + 8, channels 2 t4, + 1, + 8, + 9) is
//   read from that tile at the tap's (ky, kx) offset, free of bank
//   conflicts at that pitch (68 % 32 == 4), and split into its levels in
//   registers (split.cuh's split2, the join's). A from registers: a
//   shared-memory descriptor one pixel off an 8-row core matrix would not
//   address it.
//   Where two tiles of A fit beside three ring stages (C = 64, 80) the
//   next tile's copies fly while this one multiplies; at C = 96 and 112
//   they start when the last tap's fragments are read.
// - B (the weights) is split and laid out by the wrapper (ops/conv.py
//   pack_weights) in wgmma's no-swizzle K-major layout: 8 x 8 core
//   matrices of 128 bytes, K-adjacent 128 bytes apart (LBO), N-adjacent
//   256 (SBO), a k16 step NC x 32 bytes. All of it (221 KB at C = 64,
//   677 KB at C = 112 in float32) does not fit beside A, so it streams
//   from L2 through a ring of S stages in shared memory: a stage is a
//   tap's levels at C = 64 (24 KB), one level of a tap's pass at the
//   other widths (12.5 KB at C = 80, 18 KB at C = 96 and 25 KB at C = 112;
//   9 KB and 12.5 KB, a pass's share, at C = 96 and 112 in float32). A
//   producer warp keeps the ring full with one bulk copy (the TMA unit's
//   1-D copy) a stage, completion on the stage's "full" mbarrier; the consumers hand a stage back on its
//   "empty" mbarrier when the wgmma groups that read it are done.
// - MODE 0 sums the five small products and hi.hi in two sets of
//   accumulators, added once in the epilogue: the tensor cores' float32
//   accumulation truncates at each k16 step, so one set taking all six
//   passes' steps drifts about as many times further from the float32
//   sum as the one pass of bfloat16 does.
// - The epilogue stores the accumulators straight from the wgmma layout:
//   a warp's store writes 8 adjacent pixels of 4 channels, 32-byte runs
//   (16-byte stores through a shared tile would need a split row, W not
//   being a multiple of 4 in general).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split.cuh"

namespace {

constexpr int TM = 64;               // output columns a tile (wgmma M)
constexpr int TR = 2;                // output rows a tile: a warpgroup each
constexpr int HR = TR + 2;           // staged rows
constexpr int HP = TM + 2;           // staged pixels a row
constexpr int CT = 128 * TR;         // compute threads
constexpr int THREADS = CT + 32;     // and the producer warp
constexpr int MAX_SMEM = 232448;     // a block's shared memory on the H100
constexpr int BAR_BYTES = 128;       // the ring's two mbarriers a stage (S <= 8)

// MODE 0's products a multiply-add (issue_stage lists them)
constexpr int NP3 = 6;

template <int C, int MODE>
struct Conf {
  static constexpr int LV = MODE == 0 ? 3 : 1;   // levels of the split
  static constexpr int NP = MODE == 0 ? NP3 : 1; // products a multiply-add
  // output-channel passes a tile: C = 96 and 112 in float32 in two of 48
  // and 56, so that the fragments of a tap's three levels and both sets
  // of sums fit the registers without spills or serialized wgmma groups
  // (140 registers at C = 80 in one pass, as at C = 112 in two)
  static constexpr int NH = MODE == 0 && C > 80 ? 2 : 1;
  static constexpr int NC = C / NH;              // output channels a pass (wgmma N)
  static constexpr int NACC2 = MODE == 0 ? NC / 2 : 1;  // the small products' sums
  static constexpr int KS = C / 16;              // k16 steps a tap
  static constexpr int PP = HP + 2;              // staged pixel pitch of a channel row
  static constexpr int LPS = C == 64 ? LV : 1;   // weight levels a ring stage
  static constexpr int NST = LV / LPS;           // ring stages a tap
  static constexpr int LEVEL = C * NC * 2;       // bytes of a pass's tap level
  static constexpr int SB = LPS * LEVEL;         // bytes of a ring stage
  static constexpr int A_FLOATS = HR * C * PP;   // one staged tile
  static constexpr int A_BYTES = A_FLOATS * 4;
  // two A buffers (the next tile staged while this one multiplies) where
  // three ring stages still fit beside them
  static constexpr int NBUF =
      (MAX_SMEM - BAR_BYTES - 2 * A_BYTES) / SB >= 3 ? 2 : 1;
  static constexpr int S_FIT = (MAX_SMEM - BAR_BYTES - NBUF * A_BYTES) / SB;
  static constexpr int S = S_FIT < 6 ? S_FIT : 6;  // ring stages
  static constexpr int SMEM = BAR_BYTES + S * SB + NBUF * A_BYTES;
  static_assert(C % 16 == 0 && PP % 32 == 4, "fragment reads free of bank conflicts");
  static_assert(S >= 3, "a stage in use, one in flight, one to refill");
  static_assert(SMEM <= MAX_SMEM, "shared memory of one H100 block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and the bulk copy ---------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// global -> this block's shared memory, bytes a multiple of 16, completion
// counted on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 4 bytes global -> shared, asynchronous, zero-filled where `bytes` is 0
__device__ __forceinline__ void copy4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have landed
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// named barrier of the compute warpgroups (id 1; 0 is __syncthreads)
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
}

// --- wgmma -------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile without swizzle: 8 x 8
// core matrices of 128 contiguous bytes, the two of a k16 step 128 bytes
// apart (leading-dimension offset), 8-row groups 256 bytes apart (stride
// offset).
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)(128 >> 4) << 16;
  d |= (uint64_t)(256 >> 4) << 32;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x N float32) += A (64 x 16, this thread's fragment in registers) .
// B (N x 16, K-major in shared memory)^T, or D = A . B^T where `acc` is 0;
// bf16 operands, or f16 with F16.
template <int N, bool F16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int acc);

// The operands of wgmma_rs for R = N / 2 accumulators: the accumulators
// %0 .. %R-1 (WGMMA_D, WGMMA_P), then the four A registers and the B
// descriptor (WGMMA_AB) and the flag that keeps D (WGMMA_FLAG).
#define WGMMA_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_D24 WGMMA_D4(0), WGMMA_D4(4), WGMMA_D4(8), WGMMA_D4(12), WGMMA_D4(16), \
  WGMMA_D4(20)
#define WGMMA_D28 WGMMA_D24, WGMMA_D4(24)
#define WGMMA_D32 WGMMA_D28, WGMMA_D4(28)
#define WGMMA_D40 WGMMA_D32, WGMMA_D4(32), WGMMA_D4(36)
#define WGMMA_D48 WGMMA_D40, WGMMA_D4(40), WGMMA_D4(44)
#define WGMMA_D56 WGMMA_D48, WGMMA_D4(48), WGMMA_D4(52)
#define WGMMA_P24 \
  " %0, %1, %2, %3, %4, %5, %6, %7," \
  " %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23"
#define WGMMA_AB_24 "{%24, %25, %26, %27}, %28"
#define WGMMA_FLAG_24 "%29"
#define WGMMA_P28 \
  " %0, %1, %2, %3, %4, %5, %6, %7," \
  " %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23," \
  " %24, %25, %26, %27"
#define WGMMA_AB_28 "{%28, %29, %30, %31}, %32"
#define WGMMA_FLAG_28 "%33"
#define WGMMA_P32 \
  " %0, %1, %2, %3, %4, %5, %6, %7," \
  " %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23," \
  " %24, %25, %26, %27, %28, %29, %30, %31"
#define WGMMA_AB_32 "{%32, %33, %34, %35}, %36"
#define WGMMA_FLAG_32 "%37"
#define WGMMA_P40 \
  " %0, %1, %2, %3, %4, %5, %6, %7," \
  " %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23," \
  " %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39"
#define WGMMA_AB_40 "{%40, %41, %42, %43}, %44"
#define WGMMA_FLAG_40 "%45"
#define WGMMA_P48 \
  " %0, %1, %2, %3, %4, %5, %6, %7," \
  " %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23," \
  " %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39," \
  " %40, %41, %42, %43, %44, %45, %46, %47"
#define WGMMA_AB_48 "{%48, %49, %50, %51}, %52"
#define WGMMA_FLAG_48 "%53"
#define WGMMA_P56 \
  " %0, %1, %2, %3, %4, %5, %6, %7," \
  " %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23," \
  " %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39," \
  " %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55"
#define WGMMA_AB_56 "{%56, %57, %58, %59}, %60"
#define WGMMA_FLAG_56 "%61"

#define WGMMA_RS(N, F16, TY, R)                                                 \
  template <>                                                                   \
  __device__ __forceinline__ void wgmma_rs<N, F16>(                             \
      float(&d)[R], const uint32_t(&a)[4], uint64_t db, int acc) {              \
    asm volatile(                                                               \
        "{\n"                                                                   \
        ".reg .pred p;\n"                                                       \
        "setp.ne.b32 p, " WGMMA_FLAG_##R ", 0;\n"                               \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {"        \
        WGMMA_P##R "}, " WGMMA_AB_##R ", p, 1, 1, 0;\n"                         \
        "}\n"                                                                   \
        : WGMMA_D##R                                                            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));       \
  }

// the instances' N: C (bf16 and f16, one pass), C / NH (float32's split)
WGMMA_RS(48, false, "bf16", 24)
WGMMA_RS(56, false, "bf16", 28)
WGMMA_RS(64, false, "bf16", 32)
WGMMA_RS(64, true, "f16", 32)
WGMMA_RS(80, false, "bf16", 40)
WGMMA_RS(80, true, "f16", 40)
WGMMA_RS(96, false, "bf16", 48)
WGMMA_RS(96, true, "f16", 48)
WGMMA_RS(112, false, "bf16", 56)
WGMMA_RS(112, true, "f16", 56)

// This thread's A fragments of one tap, every level of each k16 step, from
// the staged tile at the tap's offset `a` (channel rows of PP floats).
template <int C, int MODE>
__device__ __forceinline__ void load_frags(
    const float* a, uint32_t (&fa)[Conf<C, MODE>::LV][C / 16][4], int warp, int g,
    int t4) {
  using K = Conf<C, MODE>;
#pragma unroll
  for (int k = 0; k < K::KS; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 16 * warp + g + 8 * (q & 1);
      const int c = 16 * k + 2 * t4 + 8 * (q >> 1);
      float v0 = a[c * K::PP + p], v1 = a[(c + 1) * K::PP + p];
      if constexpr (MODE == 0) {
        uint32_t w[K::LV];
        split2<K::LV>(v0, v1, w);
#pragma unroll
        for (int l = 0; l < K::LV; ++l) fa[l][k][q] = w[l];
      } else {
        fa[0][k][q] = pack2<MODE == 2>(v0, v1);
      }
    }
}

// The products of ring stage J of a tap whose weights sit at `slot`: the
// pack holds the weight level b at position LV - 1 - b, a stage LPS of
// them. MODE 0's products are listed by the weights' level, highest first
// (a ring stage of one level serves a run of them); the five small ones
// sum in `acc2` and hi.hi in `acc`, so that the large sums take only the
// k16 steps of one pass (the tensor cores' float32 accumulation truncates
// at each step). A tile's first product into each writes it.
template <int C, int MODE, int J>
__device__ __forceinline__ void issue_stage(float (&acc)[Conf<C, MODE>::NC / 2],
                                            float (&acc2)[Conf<C, MODE>::NACC2],
                                            const uint32_t (&fa)[Conf<C, MODE>::LV][C / 16][4],
                                            uint32_t slot, int tap) {
  using K = Conf<C, MODE>;
  constexpr int PA[NP3] = {0, 1, 0, 2, 1, 0};
  constexpr int PB[NP3] = {2, 1, 1, 0, 0, 0};
#pragma unroll
  for (int p = 0; p < K::NP; ++p) {
    const int la = K::LV == 1 ? 0 : PA[p];
    const int pos = K::LV - 1 - (K::LV == 1 ? 0 : PB[p]);
    if (pos / K::LPS == J) {
#pragma unroll
      for (int k = 0; k < K::KS; ++k) {
        const uint64_t db = make_desc(slot + (pos % K::LPS) * K::LEVEL + k * K::NC * 32);
        if constexpr (MODE == 0) {
          if (p < NP3 - 1)
            wgmma_rs<K::NC, false>(acc2, fa[la][k], db, (tap | p | k) != 0);
          else
            wgmma_rs<K::NC, false>(acc, fa[la][k], db, (tap | k) != 0);
        } else {
          wgmma_rs<K::NC, MODE == 2>(acc, fa[la][k], db, (tap | k) != 0);
        }
      }
    }
  }
}

// Stage tile (n, y0, x0)'s A into `sa`: rows y0 - 1 .. y0 + TR, columns
// x0 - 1 .. x0 + TM, zero outside the frame, a row of PP floats a channel
// (NCHW order, so that 4-byte asynchronous copies move it; rows of W
// floats are not 16-byte aligned in general). A warp copies one channel
// row at a time, its lanes adjacent pixels. Commits the copies as one
// group.
template <int C>
__device__ __forceinline__ void stage_a(const float* __restrict__ x, float* sa, int n,
                                        int y0, int x0, int H, int W, int tid) {
  constexpr int PP = HP + 2;
  const int lane = tid & 31;
#pragma unroll 1
  for (int l = tid >> 5; l < HR * C; l += CT / 32) {
    const int r = l / C, c = l - r * C;
    const int y = y0 - 1 + r;
    const bool row = y >= 0 && y < H;
    const float* src = x + (((size_t)n * C + c) * H + (row ? y : 0)) * W;
    float* dst = sa + l * PP;
#pragma unroll
    for (int p = lane; p < HP; p += 32) {
      const int xx = x0 - 1 + p;
      const bool in = row && xx >= 0 && xx < W;
      copy4(dst + p, in ? src + xx : x, in ? 4 : 0);
    }
  }
  copy_commit();
}

template <int C, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    conv_wgmma_kernel(const float* __restrict__ x, const unsigned char* __restrict__ wpack,
                      float* __restrict__ out, int N, int H, int W) {
  using K = Conf<C, MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_addr(smem), empty0 = full0 + 8 * K::S;
  const uint32_t ring = smem_addr(smem + BAR_BYTES);
  float* sa0 = reinterpret_cast<float*>(smem + BAR_BYTES + K::S * K::SB);
  constexpr int TILE_STAGES = K::NH * 9 * K::NST;

  const int tid = threadIdx.x;
  const int n_tx = (W + TM - 1) / TM, n_ty = (H + TR - 1) / TR;
  const int n_tiles = N * n_tx * n_ty;
  if (tid == 0) {
    for (int s = 0; s < K::S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CT / 32);  // a warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CT) {
    // ---- the producer warp: one thread streams the weight stages, the
    // same TILE_STAGES for every tile of this block
    if (tid == CT) {
      const int n_mine = ((int)blockIdx.x < n_tiles)
                             ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                             : 0;
      const int total = n_mine * TILE_STAGES;
      for (int s = 0; s < total; ++s) {
        const int slot = s % K::S;
        if (s >= K::S) mbar_wait(empty0 + 8 * slot, ((s / K::S) - 1) & 1);
        mbar_expect_tx(full0 + 8 * slot, K::SB);
        bulk_load(ring + slot * K::SB, wpack + (size_t)(s % TILE_STAGES) * K::SB, K::SB,
                  full0 + 8 * slot);
      }
    }
    return;
  }

  // ---- the compute warpgroups -------------------------------------------
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[K::NC / 2], acc2[K::NACC2];
#pragma unroll
  for (int i = 0; i < K::NC / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < K::NACC2; ++i) acc2[i] = 0.f;
  uint32_t fa[K::LV][K::KS][4];
  auto decode = [&](int t, int& n, int& y0, int& x0) {
    x0 = (t % n_tx) * TM;
    y0 = ((t / n_tx) % n_ty) * TR;
    n = t / (n_tx * n_ty);
  };
  int s = 0;  // ring stages consumed
  if ((int)blockIdx.x < n_tiles) {
    int n, y0, x0;
    decode(blockIdx.x, n, y0, x0);
    stage_a<C>(x, sa0, n, y0, x0, H, W, tid);
  }
  copy_wait();
  compute_sync();
  int i = 0;  // this block's tiles so far
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
    int n, y0, x0, n1, y1, x1;
    decode(t, n, y0, x0);
    const bool more = t + (int)gridDim.x < n_tiles;
    if (more) decode(t + gridDim.x, n1, y1, x1);
    float* sa = sa0 + (K::NBUF == 2 ? (i & 1) * K::A_FLOATS : 0);
    // two buffers: the next tile's A copies fly while this tile multiplies
    if (K::NBUF == 2 && more)
      stage_a<C>(x, sa0 + ((i + 1) & 1) * K::A_FLOATS, n1, y1, x1, H, W, tid);
#pragma unroll 1
    for (int hf = 0; hf < K::NH; ++hf) {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap - 3 * ky;
        load_frags<C, MODE>(sa + (wg + ky) * C * K::PP + kx, fa, warp, g, t4);
#pragma unroll
        for (int j = 0; j < K::NST; ++j) {
          const int slot = s % K::S;
          mbar_wait(full0 + 8 * slot, (s / K::S) & 1);
          wgmma_fence();
          if (j == 0) issue_stage<C, MODE, 0>(acc, acc2, fa, ring + slot * K::SB, tap);
          if (j == 1) issue_stage<C, MODE, 1>(acc, acc2, fa, ring + slot * K::SB, tap);
          if (j == 2) issue_stage<C, MODE, 2>(acc, acc2, fa, ring + slot * K::SB, tap);
          wgmma_commit();
          if (j > 0) {  // the stage before this one has been read
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(empty0 + 8 * ((s - 1) % K::S));
          }
          ++s;
        }
        if (K::NBUF == 1 && tap == 8 && hf == K::NH - 1) {
          // one buffer: every thread holds its last fragments, so the
          // tile's A is free; the next tile's copies fly while these
          // products run
          compute_sync();
          if (more) stage_a<C>(x, sa0, n1, y1, x1, H, W, tid);
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty0 + 8 * ((s - 1) % K::S));
      }
      // ---- the epilogue of the pass: its sums straight to the NCHW
      // planes: a warp's store is 8 adjacent pixels of 4 channels
      const int y = y0 + wg;
      if (y < H) {
        const size_t HW = (size_t)H * W;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int xx = x0 + 16 * warp + g + 8 * h;
          if (xx < W) {
            float* o = out + ((size_t)n * C + hf * K::NC) * HW + (size_t)y * W + xx;
#pragma unroll
            for (int n8 = 0; n8 < K::NC / 8; ++n8)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = 4 * n8 + 2 * h + e;
                float v = acc[r];
                if constexpr (MODE == 0) v = acc2[r] + acc[r];
                o[(size_t)(8 * n8 + 2 * t4 + e) * HW] = v;
              }
          }
        }
      }
    }
    copy_wait();     // this thread's copies of the next tile's A
    compute_sync();  // and every thread's
  }
}

template <int C, int MODE>
cudaError_t launch_wgmma(const float* x, const void* wpack, float* out, int N, int H,
                         int W, cudaStream_t stream) {
  using K = Conf<C, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_wgmma_kernel<C, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  int dev = 0, n_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long n_tiles =
      (long long)N * ((H + TR - 1) / TR) * ((W + TM - 1) / TM);
  const int grid = (int)(n_tiles < n_sm ? n_tiles : n_sm);  // one block an SM
  conv_wgmma_kernel<C, MODE><<<grid, THREADS, K::SMEM, stream>>>(
      x, static_cast<const unsigned char*>(wpack), out, N, H, W);
  return cudaGetLastError();
}

// ---- the first layer, and the widths no wgmma instance takes -------------

constexpr int FX = 32, FY = 8;  // a block's pixels: a warp a row of 32
constexpr int FCI = 4;          // input channels a pass (in registers)
constexpr int FW = 12288;       // weights in shared memory at a time: 48 KB

__global__ void __launch_bounds__(FX * FY)
    conv_first_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, int Ci, int Co, int H, int W) {
  __shared__ float ws[FW];
  const int tid = threadIdx.y * FX + threadIdx.x;
  const int xx = blockIdx.x * FX + threadIdx.x, y = blockIdx.y * FY + threadIdx.y;
  const int n = blockIdx.z;
  const bool in = xx < W && y < H;
  const size_t HW = (size_t)H * W;
  float* o = out + (size_t)n * Co * HW + (in ? (size_t)y * W + xx : 0);
  // the output channels in chunks whose weights (C_in x 9 a channel) fit
  // the shared memory: one chunk for the first layer
  const int per = Ci * 9, cb = FW / per;
  for (int co0 = 0; co0 < Co; co0 += cb) {
    const int nco = Co - co0 < cb ? Co - co0 : cb;
    __syncthreads();  // the chunk before has been read
    for (int i = tid; i < nco * per; i += FX * FY) ws[i] = w[(size_t)co0 * per + i];
    __syncthreads();
    if (!in) continue;
    // FCI input channels a pass; a pass after the first adds its sums to
    // the output (C_in > FCI)
    for (int c0 = 0; c0 < Ci; c0 += FCI) {
      float v[FCI][9];
#pragma unroll
      for (int i = 0; i < FCI; ++i)
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int yy = y + t / 3 - 1, xs = xx + t % 3 - 1;
          v[i][t] = c0 + i < Ci && yy >= 0 && yy < H && xs >= 0 && xs < W
                        ? __ldg(x + ((size_t)n * Ci + c0 + i) * HW + (size_t)yy * W + xs)
                        : 0.f;
        }
      for (int co = 0; co < nco; ++co) {
        const float* wc = ws + (co * Ci + c0) * 9;
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < FCI; ++i)
          if (c0 + i < Ci) {
#pragma unroll
            for (int t = 0; t < 9; ++t) a = fmaf(wc[i * 9 + t], v[i][t], a);
          }
        float* oc = o + (size_t)(co0 + co) * HW;
        *oc = c0 == 0 ? a : *oc + a;
      }
    }
  }
}

template <int C>
cudaError_t launch_width(const float* x, const void* wpack, float* out, int N, int H,
                         int W, int mode, cudaStream_t stream) {
  if (mode == 0) return launch_wgmma<C, 0>(x, wpack, out, N, H, W, stream);
  if (mode == 1) return launch_wgmma<C, 1>(x, wpack, out, N, H, W, stream);
  if (mode == 2) return launch_wgmma<C, 2>(x, wpack, out, N, H, W, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (N, Ci, H, W) float32, w: (Co, Ci, 3, 3) float32, out: (N, Co, H, W)
// float32, all contiguous; Ci, Co >= 1, Ci * 9 <= 12288, N <= 65535. One
// launch. Returns its CUDA error.
extern "C" int conv_first_launch(const float* x, const float* w, float* out, int N,
                                 int Ci, int Co, int H, int W, cudaStream_t stream) {
  if (Ci < 1 || Co < 1 || Ci * 9 > FW || N < 0 || N > 65535 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W == 0) return 0;
  const dim3 grid((W + FX - 1) / FX, (H + FY - 1) / FY, N);
  conv_first_kernel<<<grid, dim3(FX, FY), 0, stream>>>(x, w, out, Ci, Co, H, W);
  return (int)cudaGetLastError();
}

// x: (N, C, H, W) float32, out: (N, C, H, W) float32, both contiguous;
// wpack: the weights as ops/conv.py pack_weights lays them out (passes x 9
// taps x levels x C x C / passes values of the 16-bit type, 16-byte
// aligned); C 64, 80, 96 or 112; mode 0 float32 (three bf16 levels), 1
// bfloat16, 2 float16. One launch. Returns its CUDA error.
extern "C" int conv_wgmma_launch(const float* x, const void* wpack, float* out, int N,
                                 int C, int H, int W, int mode, cudaStream_t stream) {
  if (N < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W == 0) return 0;
  if (C == 64) return (int)launch_width<64>(x, wpack, out, N, H, W, mode, stream);
  if (C == 80) return (int)launch_width<80>(x, wpack, out, N, H, W, mode, stream);
  if (C == 96) return (int)launch_width<96>(x, wpack, out, N, H, W, mode, stream);
  if (C == 112) return (int)launch_width<112>(x, wpack, out, N, H, W, mode, stream);
  return (int)cudaErrorInvalidValue;
}
