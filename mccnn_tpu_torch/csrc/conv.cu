// The towers' SAME-padded 3x3 convolutions of prediction, NCHW float32 in
// and out, with the layer's bias, rounding and ReLU in their epilogue.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (mccnn_tpu/models/towers.py:84-92, conv_general_dilated NHWC/HWIO with
// preferred_element_type=float32, then the bias and ReLU, which XLA fuses
// into the convolution), and the port ran them in cuDNN (f32, TF32 off)
// until these kernels. FastTower.infer and SlowNet.infer call ops/conv.py
// conv3x3 for every layer, with its bias and ReLU for every layer but the
// fast tower's last (whose bias and L2 normalization run in
// csrc/tower.cu). The epilogue computes act(round_S(sum + b)) by
// csrc/epilogue.cuh's bias_act, the very function of csrc/tower.cu's bias
// kernel, so a fused layer gives the bits of the bias-free kernel followed
// by that kernel. The two bias-free entries stay beside the fused ones.
//
// conv_first_kernel: the first layer, C_in = n_input_plane (1, or 3 for
// colour) -> C_out = fm, and every layer of a width that no wgmma instance
// takes (C_in up to 1365: the weights of a chunk of output channels in
// shared memory at a time; the narrow slow nets of the Middlebury search,
// fm 4-8, and the small nets of the tests). Bound on the H100: bytes, the
// fm output planes written once (KITTI fast: 232 MB, 0.069 ms at 3.35
// TB/s; 9 x 64 FMAs a pixel are 0.016 ms at 67 TFLOP/s).
// A SIMT kernel: a thread two adjacent pixels, their 3 x 4 window of up to
// 4 input planes in registers, the chunk's weights and bias in dynamic
// shared memory sized to it (2.3 KB at 1 -> 64, so that the shared memory
// caps no block count), one broadcast weight read feeding both pixels'
// FMAs, the fused epilogue's rounding and ReLU instances of their own, one
// FMA chain an output from +0.0 in (c_in, ky, kx) order, and the pair
// stored in one 8-byte store where W is even. A tensor-core tile would pad
// K from 9 to 16 and buy nothing.
//
// conv_wgmma_kernel<C, MODE>: the layers after the first, C_in = C_out =
// C = fm in {64, 80, 96, 112} (the published nets' 64 and 112, and the
// fast net's hyperparameter search, fm 64, 80, 96), as implicit GEMMs on
// the tensor cores: M output pixels x N output channels, K = 9 taps x C
// input channels. Bound on the H100: operations. KITTI fast's three such
// layers are 1.0e11 f32 multiply-adds (2 images x 370 x 1226 pixels x 64 x
// 576 x 3); in f32 (MODE 0) the kernel runs six bf16 products a
// multiply-add (below), 1.22 ms at 989 TFLOP/s, against 3.0 ms at the 67
// TFLOP/s f32 peak that cuDNN runs at 0.6 of; the bytes (each layer's
// input read, its output written) are 0.14 ms a layer.
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
// products, summed in float32: the rounding point of the layer. MODE 0
// sums the five small products and hi.hi in two sets of accumulators,
// added once in the epilogue: the tensor cores' float32 accumulation
// truncates at each k16 step, so one set taking all six products' steps
// drifts several times further from the float32 sum. Each output's sum
// runs tap -> product -> k16 step, the order of the first design of this
// kernel, so the outputs keep its bits.
//
// Design (one block an SM, persistent, warp-specialized):
// - Tiles: TR output rows x TM = 64 columns. Where two warpgroups' sums
//   fit (C = 64, 80, and the 16-bit lanes) TR = 2 and a consumer
//   warpgroup takes a row (wgmma M = 64, N = C); at C = 96 and 112 in
//   float32 TR = 1 and the two consumer warpgroups take the two halves of
//   the output channels (N = 48, 56) of one row, since a tile of two rows
//   of three split levels does not fit beside the weight ring. A block
//   takes a run of consecutive tiles down column strips (Conf::TR rows at
//   a time), so that a tile shares its top two staged rows with the tile
//   before it and stages only its TR new ones, and the next tile's rows
//   stage while this one multiplies. (Runs of 4 tiles a strip, so that
//   all blocks stayed near the same rows, were 1.1-1.3x slower: every
//   fourth tile waited for all of its rows.)
// - A (the activations) is staged once, already split: a ring of row
//   slots, a row of HP = 66 pixels (x0 - 1 .. x0 + 64, zeros outside the
//   frame) in the layout [level][C / 8 channel group][pixel][8 values],
//   16 bytes a (pixel, group); three bf16 levels in float32 (split.cuh's
//   split2, each value split once), one plane of the 16-bit type in MODE
//   1 and 2 (8 global loads of adjacent pixels' channel planes an item,
//   four items in flight a thread). Row slots for the tile's TR + 2 rows
//   and the next tile's TR new ones where they fit beside three ring
//   stages (so the next rows stage while this tile multiplies), else the
//   tile's rows alone (C = 112 in float32), a row handed back as soon as
//   its last tap's fragments are read (row 0 after tap 2), so that the
//   next row stages during taps 3-8.
// - A's fragments by ldmatrix.x4: a lane names one 16-byte row, one
//   pixel's 8 channels of one level, so a tap's (ky, kx) offset is a row
//   address, and the 8 rows of each 8 x 8 matrix (8 adjacent pixels of a
//   group, 128 contiguous bytes) fall in 32 distinct banks. The x4 order
//   (rows 0-7 / 8-15 x channels 0-7 / 8-15) is the wgmma A register
//   layout: rows 16 w + g (+ 8), channels 16 k + 2 t4 (+ 8). A stays in
//   registers (RS wgmma): shared-memory A would add B's 64 bytes a clock
//   again at the tensor cores' peak.
// - B (the weights) is split and laid out by the wrapper (ops/conv.py
//   pack_weights) in wgmma's no-swizzle K-major layout: 8 x 8 core
//   matrices of 128 bytes, K-adjacent 128 bytes apart (LBO), N-adjacent
//   256 (SBO), a k16 step N x 32 bytes. It streams from L2 through a ring
//   of S stages: a tap's levels at C = 64 (24 KB), one level of a tap at
//   the other widths (both halves' at C = 96 and 112 in float32), one bulk
//   copy (the TMA unit's 1-D copy) a stage and half, completion on the
//   stage's "full" mbarrier; the consumers hand a stage back on its
//   "empty" mbarrier when the wgmma groups that read it have retired.
// - Warp specialization: a producer warpgroup lowers its registers
//   (setmaxnreg) and streams the weight ring (one thread of its first
//   warp) and stages and splits A (its other three warps); the two
//   consumer warpgroups raise theirs. A consumer
//   commits a tap's products in groups of one weight level (p0 | p1 p2 |
//   p3 p4 p5 in float32) and waits for the group before the one it just
//   committed: that frees a ring stage and the fragment registers of the
//   tap before, into which the next fragments load while the tap's
//   products run (the activations' level 0 of two taps in two register
//   sets, levels 1 and 2 of one). wgmma_wait<0> runs once a tile, before
//   the epilogue.
// - The epilogue stores the accumulators straight from the wgmma layout
//   (a warp's store writes 8 adjacent pixels of 4 channels, 32-byte runs;
//   16-byte stores through a shared tile would need a split row, W not
//   being a multiple of 4 in general), the bias, rounding and ReLU applied
//   in registers when the fused entry gives a bias (staged in shared
//   memory once, a thread's channels read at once before its stores).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "split.cuh"

namespace {

constexpr int TM = 64;               // output columns a tile (wgmma M)
constexpr int HP = TM + 2;           // staged pixels a row
constexpr int GB = HP * 16;          // bytes of a staged row's 8-channel group
constexpr int CT = 256;              // the consumer warpgroups
constexpr int THREADS = CT + 128;    // and the producer warpgroup
constexpr int STAGERS = 96;          // the producer's threads that stage A
constexpr int UNROLL = 4;            // items a staging thread has in flight
constexpr int MAX_SMEM = 232448;     // a block's shared memory on the H100
constexpr int BAR_BYTES = 256;       // the mbarriers (ring and row slots, <= 8 each)
constexpr int HEAD_BYTES = BAR_BYTES + 512;  // and the layer's bias (<= 128 floats)
// setmaxnreg: the producer's registers and the consumers' (the block's
// 65536 / 384 = 168 a thread at launch, shared out again)
constexpr int PRODUCER_REGS = 88;
constexpr int CONSUMER_REGS = 208;
static_assert(128 * PRODUCER_REGS + CT * CONSUMER_REGS <= 168 * THREADS,
              "the registers a block holds at launch");

// MODE 0's products a multiply-add (group lists them)
constexpr int NP3 = 6;

template <int C, int MODE>
struct Conf {
  static constexpr int LV = MODE == 0 ? 3 : 1;   // levels of the split
  // one row a tile, a warpgroup an output-channel half, where two rows of
  // three levels do not fit beside the ring (C = 96, 112 in float32)
  static constexpr bool HALVES = MODE == 0 && C > 80;
  static constexpr int TR = HALVES ? 1 : 2;      // output rows a tile
  static constexpr int NW = HALVES ? 2 : 1;      // N blocks of a tap level
  static constexpr int NC = C / NW;              // output channels a warpgroup (wgmma N)
  static constexpr int NACC2 = MODE == 0 ? NC / 2 : 1;  // the small products' sums
  static constexpr int KS = C / 16;              // k16 steps a tap
  static constexpr int LVB = C / 8 * GB;         // bytes of a staged row's level
  static constexpr int RB = LV * LVB;            // bytes of a row slot
  static constexpr int LPS = C == 64 ? LV : 1;   // weight levels a ring stage
  static constexpr int NST = LV / LPS;           // ring stages a tap
  static constexpr int LEVEL = C * NC * 2;       // bytes of a tap level of an N block
  static constexpr int SB = LPS * NW * LEVEL;    // bytes of a ring stage
  // row slots: this tile's TR + 2 rows and the next tile's TR where that
  // leaves three ring stages, else this tile's alone
  static constexpr int NS =
      (MAX_SMEM - HEAD_BYTES - 3 * SB) / RB >= 2 * TR + 2 ? 2 * TR + 2 : TR + 2;
  static constexpr int S_FIT = (MAX_SMEM - HEAD_BYTES - NS * RB) / SB;
  static constexpr int S = S_FIT < 6 ? S_FIT : 6;  // ring stages
  static constexpr int SMEM = HEAD_BYTES + S * SB + NS * RB;
  static constexpr int TILE_STAGES = 9 * NST;
  static_assert(C % 16 == 0, "k16 steps");
  static_assert(S >= 3, "a stage in use, one in flight, one to refill");
  static_assert(16 * S + 16 * NS <= BAR_BYTES, "the mbarriers");
  static_assert(4 * C <= HEAD_BYTES - BAR_BYTES, "the bias");
  static_assert(SMEM <= MAX_SMEM, "shared memory of one H100 block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers, the bulk copy, registers --------------------------------

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

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// 8 x 8 matrices of 16-bit values, four: lanes 8 j .. 8 j + 7 name the 16-byte
// rows of matrix j, which lands in r[j]
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The fragments `f` are read by wgmma groups in flight until the wait just
// before this: their registers stay theirs until here.
template <int KS>
__device__ __forceinline__ void keep(const uint32_t (&f)[KS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
    asm volatile("" ::"r"(f[k][0]), "r"(f[k][1]), "r"(f[k][2]), "r"(f[k][3]));
}

// The accumulators as the retired wgmma groups left them: nothing reads
// them before this point.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// the instances' N: C (bf16 and f16, and float32 at C = 64, 80), C / 2
// (float32's halves at C = 96, 112)
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

// --- staging A ------------------------------------------------------------

// One staged item, a pixel's 8 channels `v` of a group, into its 16-byte
// row of each level at `dst` (levels LVB bytes apart): split2's three bf16
// levels in MODE 0, one rounding to the 16-bit type otherwise.
template <int LV, int MODE, int LVB>
__device__ __forceinline__ void store_levels(float (&v)[8], unsigned char* dst) {
  uint32_t q[LV][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t w[LV];
    if constexpr (MODE == 0) {
      split2<LV>(v[2 * i], v[2 * i + 1], w);
    } else {
      w[0] = pack2<MODE == 2>(v[2 * i], v[2 * i + 1]);
    }
#pragma unroll
    for (int l = 0; l < LV; ++l) q[l][i] = w[l];
  }
#pragma unroll
  for (int l = 0; l < LV; ++l)
    *reinterpret_cast<uint4*>(dst + l * LVB) = make_uint4(q[l][0], q[l][1], q[l][2], q[l][3]);
}

// Stage rows ya .. ya + nr - 1 of image n (the block's staged rows q0 ..
// q0 + nr - 1), columns x0 - 1 .. x0 + TM, zeros outside the frame, into
// their row slots once the consumers have handed the slots back; then
// mark each row full. An item is a (row, channel group, pixel), the pixel
// fastest, so that a warp's 8 loads of an item read adjacent pixels of
// one channel plane each.
template <int C, int MODE>
__device__ __forceinline__ void stage_rows(const float* __restrict__ x, unsigned char* rows,
                                           uint32_t row_full, uint32_t row_empty, int n,
                                           int ya, int nr, int q0, int x0, int H, int W,
                                           int sid) {
  using K = Conf<C, MODE>;
  constexpr int ITEMS = HP * (C / 8);  // a row's
  for (int r = 0; r < nr; ++r) {
    const int q = q0 + r;
    if (q >= K::NS) mbar_wait(row_empty + 8 * (q % K::NS), ((q / K::NS) - 1) & 1);
  }
  const size_t HW = (size_t)H * W;
  const int items = nr * ITEMS;
#pragma unroll 1
  for (int i0 = sid; i0 < items; i0 += STAGERS * UNROLL) {
    float v[UNROLL][8];
    int at[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int it = i0 + u * STAGERS;
      const int r = it / ITEMS, rem = it - r * ITEMS;
      const int gi = rem / HP, p = rem - gi * HP;
      const int y = ya + r, xx = x0 - 1 + p;
      const bool in = it < items && y >= 0 && y < H && xx >= 0 && xx < W;
      const float* src = x + (((size_t)n * C + 8 * gi) * H + (in ? y : 0)) * W + (in ? xx : 0);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[u][e] = in ? __ldg(src + e * HW) : 0.f;
      at[u] = it < items ? ((q0 + r) % K::NS) * K::RB + gi * GB + p * 16 : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (at[u] >= 0) store_levels<K::LV, MODE, K::LVB>(v[u], rows + at[u]);
  }
  for (int r = 0; r < nr; ++r) mbar_arrive(row_full + 8 * ((q0 + r) % K::NS));
}

// --- the consumers -------------------------------------------------------

// What a consumer thread carries from tap to tap.
template <int C, int MODE>
struct Consumer {
  using K = Conf<C, MODE>;
  uint32_t ring, full0, empty0, rows0, row_empty;
  uint32_t lane_off;  // this lane's ldmatrix row within a tap's level
  int wrow, wh, lane;
  int qb;             // the block's staged row index of this tile's row 0
  bool carry;         // the next tile takes this tile's last two rows
  int s = 0;          // ring stages waited for
  int rel = -1;       // the stage the last committed group frees, or -1

  // the ldmatrix address of tap t's level 0 for this lane
  __device__ __forceinline__ uint32_t tap_addr(int t) const {
    const int ky = t / 3, kx = t - 3 * ky;
    return rows0 + ((qb + wrow + ky) % K::NS) * K::RB + kx * 16 + lane_off;
  }

  // wait for the next ring stage; its shared-memory address
  __device__ __forceinline__ uint32_t stage() {
    const int slot = s % K::S;
    mbar_wait(full0 + 8 * slot, (s / K::S) & 1);
    ++s;
    return ring + slot * K::SB;
  }

  // after committing a group and waiting for the one before: hand back
  // the stage that the retired group freed; `next` is the stage the group
  // just committed frees (-1: none)
  __device__ __forceinline__ void retire(int next) {
    if (rel >= 0 && lane == 0) mbar_arrive(empty0 + 8 * (rel % K::S));
    rel = next;
  }

  // hand back the rows whose last fragments tap t read, but the two the
  // next tile takes: row i's last tap is 3 i + 2 (8 for the rows past 2)
  __device__ __forceinline__ void release_rows(int t) {
    if (t != 2 && t != 5 && t != 8) return;
    __syncwarp();
    if (lane != 0) return;
#pragma unroll
    for (int i = 0; i < K::TR + 2; ++i) {
      const int last = 3 * i + 2 < 8 ? 3 * i + 2 : 8;
      if (last == t && (i < K::TR || !carry))
        mbar_arrive(row_empty + 8 * ((qb + i) % K::NS));
    }
  }
};

// this thread's fragments of level l of the tap at `a` (every k16 step)
template <int C, int MODE>
__device__ __forceinline__ void load_level(uint32_t (&f)[C / 16][4], uint32_t a, int l) {
#pragma unroll
  for (int k = 0; k < C / 16; ++k) ldsm4(f[k], a + l * Conf<C, MODE>::LVB + 2 * k * GB);
}

// The k16 steps of product p of a tap into d, B the weights' level of the
// product in the stage at `st` (this warpgroup's N block); `first`: the
// tile's first product into d writes it.
template <int C, int MODE>
__device__ __forceinline__ void product(float (&d)[Conf<C, MODE>::NC / 2],
                                        const uint32_t (&f)[C / 16][4], uint32_t st, int wb,
                                        int wh, bool first) {
  using K = Conf<C, MODE>;
  const uint32_t b = st + ((K::LV - 1 - wb) % K::LPS * K::NW + wh) * K::LEVEL;
#pragma unroll
  for (int k = 0; k < K::KS; ++k)
    wgmma_rs<K::NC, MODE == 2>(d, f[k], make_desc(b + k * K::NC * 32), !(first && k == 0));
}

// MODE 0's products GROUP[J] .. GROUP[J + 1] - 1 of a tap. Product p is
// the activations' level PA[p] by the weights' level PB[p], listed by the
// weights' level, highest first, so that a ring stage of one level serves
// a run of them (the groups, committed apart, are the runs); the five
// small ones sum in `acc2` and hi.hi in `acc`, so that the large sums take
// only the k16 steps of one product (the tensor cores' float32
// accumulation truncates at each step). A tile's first product into each
// writes it.
template <int C, int MODE, int J, int B>
__device__ __forceinline__ void group(float (&acc)[Conf<C, MODE>::NC / 2],
                                      float (&acc2)[Conf<C, MODE>::NACC2],
                                      const uint32_t (&fa0)[2][C / 16][4],
                                      const uint32_t (&fa1)[C / 16][4],
                                      const uint32_t (&fa2)[C / 16][4], uint32_t st, int wh,
                                      int tap) {
  constexpr int PA[NP3] = {0, 1, 0, 2, 1, 0};
  constexpr int PB[NP3] = {2, 1, 1, 0, 0, 0};
  constexpr int GROUP[4] = {0, 1, 3, 6};
#pragma unroll
  for (int p = GROUP[J]; p < GROUP[J + 1]; ++p) {
    if (p == NP3 - 1)
      product<C, MODE>(acc, fa0[B], st, PB[p], wh, tap == 0);
    else if (PA[p] == 0)
      product<C, MODE>(acc2, fa0[B], st, PB[p], wh, tap == 0 && p == 0);
    else if (PA[p] == 1)
      product<C, MODE>(acc2, fa1, st, PB[p], wh, false);
    else
      product<C, MODE>(acc2, fa2, st, PB[p], wh, false);
  }
}

// One tap of a tile, its level-0 fragments in fa0[B] (loaded the tap
// before); loads the next tap's.
template <int C, int MODE, int B>
__device__ __forceinline__ void tap_step(Consumer<C, MODE>& c, int tap,
                                         float (&acc)[Conf<C, MODE>::NC / 2],
                                         float (&acc2)[Conf<C, MODE>::NACC2],
                                         uint32_t (&fa0)[2][C / 16][4],
                                         uint32_t (&fa1)[C / 16][4],
                                         uint32_t (&fa2)[C / 16][4]) {
  using K = Conf<C, MODE>;
  const int s0 = c.s;
  uint32_t st = c.stage();
  wgmma_fence();
  if constexpr (MODE == 0) {
    group<C, MODE, 0, B>(acc, acc2, fa0, fa1, fa2, st, c.wh, tap);
  } else {
    product<C, MODE>(acc, fa0[B], st, 0, c.wh, tap == 0);
  }
  wgmma_commit();
  // the tap before has retired: its stage and fragment registers are free
  wgmma_wait<1>();
  c.retire(MODE != 0 || K::LPS == 1 ? s0 : -1);
  keep(fa0[B ^ 1]);
  const uint32_t a = c.tap_addr(tap);
  if constexpr (MODE == 0) {
    keep(fa1);
    keep(fa2);
    load_level<C, MODE>(fa1, a, 1);
    load_level<C, MODE>(fa2, a, 2);
  }
  if (tap < 8) load_level<C, MODE>(fa0[B ^ 1], c.tap_addr(tap + 1), 0);
  c.release_rows(tap);
  if constexpr (MODE == 0) {
    if (K::LPS == 1) st = c.stage();
    wgmma_fence();
    group<C, MODE, 1, B>(acc, acc2, fa0, fa1, fa2, st, c.wh, tap);
    wgmma_commit();
    wgmma_wait<1>();
    c.retire(K::LPS == 1 ? s0 + 1 : -1);
    if (K::LPS == 1) st = c.stage();
    wgmma_fence();
    group<C, MODE, 2, B>(acc, acc2, fa0, fa1, fa2, st, c.wh, tap);
    wgmma_commit();
    wgmma_wait<1>();
    c.retire(K::LPS == 1 ? s0 + 2 : s0);
  }
}

// A tile's sums of this thread into the NCHW planes (channels cb .., row
// y), the bias, rounding and ReLU applied with BIAS: a warp's store is 8
// adjacent pixels of 4 channels.
template <int C, int MODE, bool BIAS>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[Conf<C, MODE>::NC / 2],
                                           const float (&acc2)[Conf<C, MODE>::NACC2],
                                           const float (*bv)[2], int relu_on, int n, int cb,
                                           int y, int x0, int H, int W, int warp, int g,
                                           int t4) {
  using K = Conf<C, MODE>;
  const size_t HW = (size_t)H * W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int xx = x0 + 16 * warp + g + 8 * h;
    if (xx < W) {
      float* o = out + ((size_t)n * C + cb) * HW + (size_t)y * W + xx;
#pragma unroll
      for (int n8 = 0; n8 < K::NC / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * n8 + 2 * h + e;
          float v = acc[r];
          if constexpr (MODE == 0) v = acc2[r] + acc[r];
          if constexpr (BIAS)
            v = relu_on ? bias_act<MODE, true>(v, bv[n8][e])
                        : bias_act<MODE, false>(v, bv[n8][e]);
          o[(size_t)(8 * n8 + 2 * t4 + e) * HW] = v;
        }
    }
  }
}

template <int C, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    conv_wgmma_kernel(const float* __restrict__ x, const unsigned char* __restrict__ wpack,
                      const float* __restrict__ bias, float* __restrict__ out, int N, int H,
                      int W, int relu_on) {
  using K = Conf<C, MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_addr(smem), empty0 = full0 + 8 * K::S;
  const uint32_t row_full = empty0 + 8 * K::S, row_empty = row_full + 8 * K::NS;
  float* sbias = reinterpret_cast<float*>(smem + BAR_BYTES);
  const uint32_t ring = smem_addr(smem + HEAD_BYTES);
  unsigned char* rows = smem + HEAD_BYTES + K::S * K::SB;

  const int tid = threadIdx.x;
  const int n_tx = (W + TM - 1) / TM, n_ty = (H + K::TR - 1) / K::TR;
  const int n_tiles = N * n_tx * n_ty;
  // this block's run of tiles, in (image, column strip, row) order
  const int t0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  auto decode = [&](int t, int& n, int& yt, int& x0) {
    yt = t % n_ty;
    x0 = (t / n_ty % n_tx) * TM;
    n = t / (n_ty * n_tx);
  };
  if (tid == 0) {
    for (int s = 0; s < K::S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CT / 32);  // a warp's lane 0
    }
    for (int s = 0; s < K::NS; ++s) {
      mbar_init(row_full + 8 * s, STAGERS);
      mbar_init(row_empty + 8 * s, CT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (bias != nullptr && tid < C) sbias[tid] = bias[tid];
  __syncthreads();

  if (tid >= CT) {
    // ---- the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    const int ptid = tid - CT;
    if (ptid == 0) {
      // the weight ring: the same TILE_STAGES for every tile
      const int total = (t1 - t0) * K::TILE_STAGES;
      for (int s = 0; s < total; ++s) {
        const int slot = s % K::S, st = s % K::TILE_STAGES;
        if (s >= K::S) mbar_wait(empty0 + 8 * slot, ((s / K::S) - 1) & 1);
        mbar_expect_tx(full0 + 8 * slot, K::SB);
        if constexpr (K::HALVES) {
          // a level of a tap, both N blocks (the pack's passes)
          const int tap = st / K::NST, j = st % K::NST;
#pragma unroll
          for (int u = 0; u < 2; ++u)
            bulk_load(ring + slot * K::SB + u * K::LEVEL,
                      wpack + (size_t)((u * 9 + tap) * K::LV + j) * K::LEVEL, K::LEVEL,
                      full0 + 8 * slot);
        } else {
          bulk_load(ring + slot * K::SB, wpack + (size_t)st * K::SB, K::SB, full0 + 8 * slot);
        }
      }
    } else if (ptid >= 32) {
      // A: each tile's new rows (all TR + 2 at a strip's first tile)
      int q = 0;
      for (int t = t0; t < t1; ++t) {
        int n, yt, x0;
        decode(t, n, yt, x0);
        const bool first = t == t0 || yt == 0;
        const int nr = first ? K::TR + 2 : K::TR;
        const int ya = first ? yt * K::TR - 1 : yt * K::TR + 1;
        stage_rows<C, MODE>(x, rows, row_full, row_empty, n, ya, nr, q, x0, H, W, ptid - 32);
        q += nr;
      }
    }
    return;
  }

  // ---- the consumer warpgroups ---------------------------------------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  Consumer<C, MODE> c;
  c.ring = ring;
  c.full0 = full0;
  c.empty0 = empty0;
  c.rows0 = smem_addr(rows);
  c.row_empty = row_empty;
  c.lane_off = (lane >> 4) * GB + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * 16;
  c.wrow = K::HALVES ? 0 : wg;
  c.wh = K::HALVES ? wg : 0;
  c.lane = lane;
  float acc[K::NC / 2], acc2[K::NACC2];
  uint32_t fa0[2][K::KS][4], fa1[K::KS][4], fa2[K::KS][4];
  int q = 0;  // rows staged before this tile
  for (int t = t0; t < t1; ++t) {
    int n, yt, x0;
    decode(t, n, yt, x0);
    const bool first = t == t0 || yt == 0;
    c.qb = first ? q : q - 2;
    q += first ? K::TR + 2 : K::TR;
    c.carry = t + 1 < t1 && (t + 1) % n_ty != 0;  // the next tile is the strip's next
    for (int i = 0; i < K::TR + 2; ++i) {
      const int qq = c.qb + i;
      mbar_wait(row_full + 8 * (qq % K::NS), (qq / K::NS) & 1);
    }
    load_level<C, MODE>(fa0[0], c.tap_addr(0), 0);
#pragma unroll 1
    for (int tap = 0; tap < 8; tap += 2) {
      tap_step<C, MODE, 0>(c, tap, acc, acc2, fa0, fa1, fa2);
      tap_step<C, MODE, 1>(c, tap + 1, acc, acc2, fa0, fa1, fa2);
    }
    tap_step<C, MODE, 0>(c, 8, acc, acc2, fa0, fa1, fa2);
    wgmma_wait<0>();
    c.retire(-1);
    keep(fa0[0]);
    if constexpr (MODE == 0) {
      keep(fa1);
      keep(fa2);
    }
    fence_acc(acc);
    fence_acc(acc2);
    // ---- the epilogue: the sums (and the bias, rounding and ReLU) straight
    // to the NCHW planes: a warp's store is 8 adjacent pixels of 4 channels
    const int y = yt * K::TR + c.wrow;
    if (y < H) {
      const int cb = c.wh * K::NC;
      if (bias != nullptr) {
        float bv[K::NC / 8][2];  // this thread's channels' bias, read at once
#pragma unroll
        for (int n8 = 0; n8 < K::NC / 8; ++n8)
#pragma unroll
          for (int e = 0; e < 2; ++e) bv[n8][e] = sbias[cb + 8 * n8 + 2 * t4 + e];
        store_tile<C, MODE, true>(out, acc, acc2, bv, relu_on, n, cb, y, x0, H, W, warp,
                                  g, t4);
      } else {
        store_tile<C, MODE, false>(out, acc, acc2, nullptr, 0, n, cb, y, x0, H, W, warp,
                                   g, t4);
      }
    }
  }
}

template <int C, int MODE>
cudaError_t launch_wgmma(const float* x, const void* wpack, const float* bias, float* out,
                         int N, int H, int W, int relu_on, cudaStream_t stream) {
  using K = Conf<C, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_wgmma_kernel<C, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  int dev = 0, n_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long n_tiles =
      (long long)N * ((H + K::TR - 1) / K::TR) * ((W + TM - 1) / TM);
  const int grid = (int)(n_tiles < n_sm ? n_tiles : n_sm);  // one block an SM
  conv_wgmma_kernel<C, MODE><<<grid, THREADS, K::SMEM, stream>>>(
      x, static_cast<const unsigned char*>(wpack), bias, out, N, H, W, relu_on);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_width(const float* x, const void* wpack, const float* bias, float* out,
                         int N, int H, int W, int mode, int relu_on, cudaStream_t stream) {
  if (mode == 0) return launch_wgmma<C, 0>(x, wpack, bias, out, N, H, W, relu_on, stream);
  if (mode == 1) return launch_wgmma<C, 1>(x, wpack, bias, out, N, H, W, relu_on, stream);
  if (mode == 2) return launch_wgmma<C, 2>(x, wpack, bias, out, N, H, W, relu_on, stream);
  return cudaErrorInvalidValue;
}

int wgmma_entry(const float* x, const void* wpack, const float* bias, float* out, int N,
                int C, int H, int W, int mode, int relu_on, cudaStream_t stream) {
  if (N < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W == 0) return 0;
  if (C == 64) return (int)launch_width<64>(x, wpack, bias, out, N, H, W, mode, relu_on, stream);
  if (C == 80) return (int)launch_width<80>(x, wpack, bias, out, N, H, W, mode, relu_on, stream);
  if (C == 96) return (int)launch_width<96>(x, wpack, bias, out, N, H, W, mode, relu_on, stream);
  if (C == 112) return (int)launch_width<112>(x, wpack, bias, out, N, H, W, mode, relu_on, stream);
  return (int)cudaErrorInvalidValue;
}

// ---- the first layer, and the widths no wgmma instance takes -------------

constexpr int FX = 32, FY = 8;  // a block: a warp a row of 32 threads
constexpr int FP = 2;           // adjacent pixels a thread
constexpr int FCI = 4;          // input channels a pass (in registers)
constexpr int FW = 12288;       // weights in shared memory at a time: 48 KB

// BIAS: the layer's bias, the rounding S and ReLU (RELU) on the sums
template <bool BIAS, int S, bool RELU>
__global__ void __launch_bounds__(FX * FY)
    conv_first_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out, int Ci,
                      int Co, int H, int W, int cb) {
  extern __shared__ float ws[];  // cb output channels' C_in x 9 weights, their bias
  const int tid = threadIdx.y * FX + threadIdx.x;
  const int xx = (blockIdx.x * FX + threadIdx.x) * FP, y = blockIdx.y * FY + threadIdx.y;
  const int n = blockIdx.z;
  const bool in0 = xx < W && y < H, in1 = xx + 1 < W && y < H;
  // both pixels in one 8-byte store: W even puts every pair on 8 bytes
  const bool pair = in1 && (W & 1) == 0;
  const size_t HW = (size_t)H * W;
  float* o = out + (size_t)n * Co * HW + (in0 ? (size_t)y * W + xx : 0);
  // the output channels in chunks whose weights (C_in x 9 a channel) fit
  // the shared memory: one chunk for the first layer
  const int per = Ci * 9;
  for (int co0 = 0; co0 < Co; co0 += cb) {
    const int nco = Co - co0 < cb ? Co - co0 : cb;
    __syncthreads();  // the chunk before has been read
    for (int i = tid; i < nco * per; i += FX * FY) ws[i] = w[(size_t)co0 * per + i];
    if (BIAS)
      for (int i = tid; i < nco; i += FX * FY) ws[cb * per + i] = bias[co0 + i];
    __syncthreads();
    if (!in0) continue;
    // FCI input channels a pass; a pass after the first adds its sums to
    // the output (C_in > FCI)
    for (int c0 = 0; c0 < Ci; c0 += FCI) {
      const bool last = c0 + FCI >= Ci;
      float v[FCI][3][FP + 2];  // rows y - 1 .. y + 1, columns xx - 1 .. xx + 2
#pragma unroll
      for (int i = 0; i < FCI; ++i)
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int j = 0; j < FP + 2; ++j) {
            const int yy = y + r - 1, xs = xx + j - 1;
            v[i][r][j] = c0 + i < Ci && yy >= 0 && yy < H && xs >= 0 && xs < W
                             ? __ldg(x + ((size_t)n * Ci + c0 + i) * HW + (size_t)yy * W + xs)
                             : 0.f;
          }
      for (int co = 0; co < nco; ++co) {
        const float* wc = ws + (co * Ci + c0) * 9;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int i = 0; i < FCI; ++i)
          if (c0 + i < Ci) {
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              const float wt = wc[i * 9 + t];
              a0 = fmaf(wt, v[i][t / 3][t % 3], a0);
              a1 = fmaf(wt, v[i][t / 3][t % 3 + 1], a1);
            }
          }
        float* oc = o + (size_t)(co0 + co) * HW;
        if (c0 != 0) {
          a0 = oc[0] + a0;
          if (in1) a1 = oc[1] + a1;
        }
        if (BIAS && last) {
          const float b = ws[cb * per + co];
          a0 = bias_act<S, RELU>(a0, b);
          a1 = bias_act<S, RELU>(a1, b);
        }
        if (pair) {
          *reinterpret_cast<float2*>(oc) = make_float2(a0, a1);
        } else {
          oc[0] = a0;
          if (in1) oc[1] = a1;
        }
      }
    }
  }
}

int first_entry(const float* x, const float* w, const float* bias, float* out, int N, int Ci,
                int Co, int H, int W, int s_code, int relu_on, cudaStream_t stream) {
  if (Ci < 1 || Co < 1 || Ci * 9 + 1 > FW || N < 0 || N > 65535 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W == 0) return 0;
  const int per = Ci * 9, cb = FW / (per + 1) < Co ? FW / (per + 1) : Co;
  const dim3 grid((W + FX * FP - 1) / (FX * FP), (H + FY - 1) / FY, N), block(FX, FY);
  const size_t smem = (size_t)cb * (per + 1) * sizeof(float);
  if (bias == nullptr)
    conv_first_kernel<false, 0, false><<<grid, block, smem, stream>>>(x, w, bias, out, Ci, Co,
                                                                     H, W, cb);
  else if (s_code == 0 && relu_on)
    conv_first_kernel<true, 0, true><<<grid, block, smem, stream>>>(x, w, bias, out, Ci, Co, H,
                                                                   W, cb);
  else if (s_code == 0)
    conv_first_kernel<true, 0, false><<<grid, block, smem, stream>>>(x, w, bias, out, Ci, Co,
                                                                    H, W, cb);
  else if (s_code == 1 && relu_on)
    conv_first_kernel<true, 1, true><<<grid, block, smem, stream>>>(x, w, bias, out, Ci, Co, H,
                                                                   W, cb);
  else if (s_code == 1)
    conv_first_kernel<true, 1, false><<<grid, block, smem, stream>>>(x, w, bias, out, Ci, Co,
                                                                    H, W, cb);
  else if (relu_on)
    conv_first_kernel<true, 2, true><<<grid, block, smem, stream>>>(x, w, bias, out, Ci, Co, H,
                                                                   W, cb);
  else
    conv_first_kernel<true, 2, false><<<grid, block, smem, stream>>>(x, w, bias, out, Ci, Co,
                                                                    H, W, cb);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, Ci, H, W) float32, w: (Co, Ci, 3, 3) float32, out: (N, Co, H, W)
// float32, all contiguous; Ci, Co >= 1, Ci * 9 <= 12288, N <= 65535. One
// launch. Returns its CUDA error.
extern "C" int conv_first_launch(const float* x, const float* w, float* out, int N,
                                 int Ci, int Co, int H, int W, cudaStream_t stream) {
  return first_entry(x, w, nullptr, out, N, Ci, Co, H, W, 0, 0, stream);
}

// conv_first_launch with the layer's bias (Co float32) and activation in
// the epilogue: act(round_s(sum + bias[c])), s the storage code (0
// float32, 1 bfloat16, 2 float16), act ReLU where relu is not 0.
extern "C" int conv_first_bias_launch(const float* x, const float* w, const float* bias,
                                      float* out, int N, int Ci, int Co, int H, int W,
                                      int s, int relu, cudaStream_t stream) {
  if (bias == nullptr || s < 0 || s > 2) return (int)cudaErrorInvalidValue;
  return first_entry(x, w, bias, out, N, Ci, Co, H, W, s, relu, stream);
}

// x: (N, C, H, W) float32, out: (N, C, H, W) float32, both contiguous;
// wpack: the weights as ops/conv.py pack_weights lays them out (passes x 9
// taps x levels x C x C / passes values of the 16-bit type, 16-byte
// aligned); C 64, 80, 96 or 112; mode 0 float32 (three bf16 levels), 1
// bfloat16, 2 float16. One launch. Returns its CUDA error.
extern "C" int conv_wgmma_launch(const float* x, const void* wpack, float* out, int N,
                                 int C, int H, int W, int mode, cudaStream_t stream) {
  return wgmma_entry(x, wpack, nullptr, out, N, C, H, W, mode, 0, stream);
}

// conv_wgmma_launch with the layer's bias (C float32) and activation in
// the epilogue: act(round_mode(sum + bias[c])), the rounding the compute
// dtype's (mode), act ReLU where relu is not 0.
extern "C" int conv_wgmma_bias_launch(const float* x, const void* wpack, const float* bias,
                                      float* out, int N, int C, int H, int W, int mode,
                                      int relu, cudaStream_t stream) {
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  return wgmma_entry(x, wpack, bias, out, N, C, H, W, mode, relu, stream);
}
