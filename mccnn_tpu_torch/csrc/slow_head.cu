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
// 0.5 ms. Only wgmma reaches that rate. The mid weights (864 KB at C = 384)
// do not fit the 227 KB of shared memory and stream from L2 once per
// 128-cell tile, and h0 needs a row of A and of B per cell: L2 -> SM bytes
// per tile are the ceiling a design meets long before the tensor cores'
// (a tile of 128 columns of one d that loads all of it itself pulls
// 1,277,952 bytes, 884,736 of weights and 393,216 of A and B, and runs at
// L2's rate, about 3 TB/s on this card).
//
// Design:
// - A tile is 128 cells: XT = 16 columns by DT = 8 disparities of one image
//   row, so it reads 16 rows of A and the 23 rows of B that x - d spans
//   (59,904 bytes, each a contiguous run) where 128 columns of one d read
//   128 of each. Row r of the tile is column x0 + r % 16 at disparity
//   d0 + r / 16; the two consumer warpgroups have 64 rows (4 disparities)
//   each.
// - Each consumer keeps its rows' whole layer output (64 x C float32: 192
//   registers a thread at C = 384) in registers and multiplies with
//   wgmma.mma_async m64nNk16 (N = 192 in two passes at C = 384, N = 64 at
//   C = 64), both operands from shared memory in the 128-byte swizzled
//   K-major layout: the activation tile as C/64 blocks of 128 rows x 64
//   bf16, and a weight slab of N output rows x 64 inputs (24 KB at C = 384).
// - The host prepacks the weights once per call into slab order (layer,
//   k-block, N pass) with the swizzle already applied, so a slab is one
//   contiguous run and needs no tensor map. One producer thread feeds a
//   ring of STAGES slab-sized buffers with cp.async.bulk (the TMA unit's
//   1-D copy), completion on a "full" mbarrier per stage: per tile three
//   stages of inputs (B's rows in two, A's in one, float32) and then the
//   weight slabs. The consumers hand a stage back through its "empty"
//   mbarrier: an input stage when h0 is built, a slab once the wgmma group
//   that read it has been waited for (one group stays in flight). The next
//   tile's inputs arrive while this tile multiplies. No __syncthreads in
//   the K loop; setmaxnreg moves the producer warpgroup's registers to the
//   consumers.
// - Thread-block clusters of CL = 2 blocks take CL consecutive tiles. Each
//   block copies 1/CL of every slab and multicasts it to the shared memory
//   of all CL blocks, so a block pulls 442,368 weight bytes from L2 per
//   tile, 502,272 bytes with its inputs (clusters of 4 halve the weights
//   again, but only 30 of them fit the card's 132 SMs, 39 of 3, against 66
//   of 2, and measured slower); an "empty" barrier collects the
//   consumers of the whole cluster, for the input stages too (the ring
//   moves in step). Every block of a cluster runs the same number of tiles
//   (a tile index past the end is clamped to the last tile and
//   recomputed), or the multicast would wait for ever.
// - h0 is built by each consumer for its own rows from the input stages: a
//   thread adds one float4 column of four A rows to the seven B rows they
//   meet over its four disparities, rectifies, rounds and stores bf16 into
//   the swizzled tile. The epilogue adds the bias, applies ReLU and writes
//   bf16 back over the consumer's own rows (its wgmmas are done; stmatrix
//   stores the accumulator fragments as they lie), or, after the last mid
//   layer, reduces h . w_last across the quad (a consumer holds all C
//   columns of its rows). The ring lets one consumer's epilogue hide
//   behind the others' products, as far as its depth goes. The first
//   wgmma of a layer writes its accumulators without reading them, so the
//   192 registers are free while h0 is built.
// - Persistent clusters, as many as fit on the card, walk the tiles that
//   have a cell with x >= d (d0 <= x0 + 15); the stream of stages runs on
//   across layer and tile boundaries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int XT = 16;        // a tile: XT columns x0 .. x0 + XT - 1
constexpr int DT = 8;         //   by DT disparities d0 .. d0 + DT - 1
constexpr int BM = XT * DT;   // cells per tile: two consumer warpgroups x 64
constexpr int BROWS = XT + DT - 1;  // rows of B a tile reads: x - d over the tile
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int KB_BYTES = BM * 128;  // one k-block of the activation tile

template <int CP>
struct Tile {
  static constexpr int KB = CP / 64;               // k-blocks (and slabs) per pass
  static constexpr int NB = CP == 384 ? 192 : 64;  // output columns per wgmma
  static constexpr int NH = CP / NB;               // N passes
  static constexpr int SLAB = NB * 128;            // bytes: NB rows x 64 bf16
  static constexpr int CL = 2;                     // blocks per cluster
  static constexpr int PIECE = SLAB / CL;          // what one block copies
  static constexpr int ACT = KB * KB_BYTES;
  static constexpr int STAGES = CP == 384 ? 5 : 4;
  // 1024 to align the base: the swizzle is a function of the address
  static constexpr int SMEM = 1024 + ACT + STAGES * SLAB + 2 * STAGES * 8;
  static constexpr int C4 = CP / 4;                // float4 per row of A or B
  static constexpr int ROW = CP * 4;               // bytes of a row of A or B
  static_assert(CP % NB == 0 && CP % 64 == 0, "C must be a multiple of 64");
  static_assert((NB / CL) % 8 == 0, "a piece must be whole 8-row swizzle atoms");
  static_assert(XT * ROW <= SLAB, "a ring stage must hold XT rows of A or B");
  static_assert(BROWS <= 2 * XT, "the B window must fit two ring stages");
  static_assert(STAGES >= 4, "a tile's three input stages and a weight slab");
  static_assert(NB % 16 == 0, "the epilogue stores two 8-column chunks at a time");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------

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

// Arrive on the barrier at the same shared-memory offset in block `cta` of
// the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// One bulk copy (the TMA unit's 1-D copy) global -> this block's shared
// memory; bytes a multiple of 16, completion counted on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The same, delivered to the same offset in every block of the cluster and
// counted on each one's barrier at the same offset.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// --- wgmma -------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: rows of 64 bf16, 8-row atoms 1024 bytes apart (SBO); the
// leading-dimension offset is unused in this mode. Advancing 16 elements
// of K adds 32 bytes, 2 in the (address >> 4) field.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
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

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operand reads, bulk copies).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// D (64 x N float32, in registers) = A (64 x 16) . B (N x 16)^T, both
// K-major in shared memory: the first step of a sum, whose registers are
// written only (so the compiler knows the last tile's sums are dead while
// h0 is built), and a further step, D += A . B^T.
template <int N>
__device__ __forceinline__ void wgmma_first(float (&d)[N / 2], uint64_t da,
                                            uint64_t db);
template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t da,
                                          uint64_t db);

template <>
__device__ __forceinline__ void wgmma_first<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_first<192>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]),
        "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]),
        "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71]),
        "=f"(d[72]), "=f"(d[73]), "=f"(d[74]), "=f"(d[75]),
        "=f"(d[76]), "=f"(d[77]), "=f"(d[78]), "=f"(d[79]),
        "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]),
        "=f"(d[84]), "=f"(d[85]), "=f"(d[86]), "=f"(d[87]),
        "=f"(d[88]), "=f"(d[89]), "=f"(d[90]), "=f"(d[91]),
        "=f"(d[92]), "=f"(d[93]), "=f"(d[94]), "=f"(d[95])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_k16<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_k16<192>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// Two floats rectified and rounded to bf16 (round to nearest even), lo in
// the low half: relu then rounding and rounding then relu agree.
__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// Four 8 x 8 bf16 matrices from the mma fragment layout (thread l holds
// row l / 4, columns 2 (l % 4), + 1 of each) to shared memory; lane l gives
// the address of row l % 8 of matrix l / 8, 16 bytes a row.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
               "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// Byte offset in the activation tile of the 16-byte chunk `chunk` (8 bf16:
// columns 8 chunk .. 8 chunk + 7) of row r: k-block chunk / 8, and inside
// it the 128-byte swizzle, chunk index XOR (row mod 8).
__device__ __forceinline__ uint32_t act_offset(int r, int chunk) {
  return (chunk >> 3) * KB_BYTES + r * 128 + (((chunk & 7) ^ (r & 7)) << 4);
}

// Tile t of the walk: image rows outermost, then strips of XT columns, the
// blocks of DT disparities fastest. A strip has the blocks with a cell x >= d:
// d0 <= min(x0 + XT - 1, W - 1); past the first few strips that is all of
// them. per_row is their number in one image row (ops/slow_head.py tile_plan).
struct TileAt {
  int y, x0, d0;
};

__device__ __forceinline__ TileAt tile_at(long long t, int W, int D, int per_row) {
  const int n_blocks = (D + DT - 1) / DT;
  TileAt at;
  at.y = (int)(t / per_row);
  int r = (int)(t % per_row);
  at.x0 = 0;
  for (;;) {
    const int nd = min(n_blocks, min(at.x0 + XT - 1, W - 1) / DT + 1);
    if (nd == n_blocks) {  // so are all strips from here on
      at.x0 += r / n_blocks * XT;
      r %= n_blocks;
      break;
    }
    if (r < nd) break;
    r -= nd;
    at.x0 += XT;
  }
  at.d0 = r * DT;
  return at;
}

// The ring position of producer and consumers: the stage and the parity of
// its barriers' phase.
struct Ring {
  int stage;
  uint32_t phase;
  template <int STAGES>
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int CP>
__global__ void __launch_bounds__(THREADS, 1)
    head_chain_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      const unsigned char* __restrict__ wpk,
                      const float* __restrict__ mids_b,
                      const float* __restrict__ w_last, float b_last,
                      float* __restrict__ out, int H, int W, int D, int n_mid,
                      int per_row, long long n_tiles) {
  using T = Tile<CP>;
  constexpr int CL = T::CL;
  extern __shared__ unsigned char smem_raw[];
  // every block aligns the same way, so offsets agree across the cluster
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* act = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t ring = base + T::ACT;
  const uint32_t full = ring + T::STAGES * T::SLAB;
  const uint32_t empty = full + T::STAGES * 8;

  const int wgroup = threadIdx.x >> 7;
  const uint32_t rank = cluster_rank();
  const long long n_clusters = gridDim.x / CL;
  const long long cluster = blockIdx.x / CL;
  const long long n_groups = (n_tiles + CL - 1) / CL;
  // tiles this block runs; the same for every block of the cluster
  const int n_iters = (int)((n_groups - cluster + n_clusters - 1) / n_clusters);
  const int slabs_per_tile = n_mid * T::KB * T::NH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * CL);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // the peers' barriers exist before anything reaches them

  if (wgroup == 0) {
    // ---- producer warpgroup: one thread streams the weight slabs -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      Ring at{0, 0};
      for (int it = 0; it < n_iters; ++it) {
        long long tile = (cluster + (long long)it * n_clusters) * CL + rank;
        if (tile >= n_tiles) tile = n_tiles - 1;
        const TileAt t = tile_at(tile, W, D, per_row);
        // this block's own inputs, three stages: the rows of B the tile
        // reads, x - d clamped into the image row (two stages), and its rows
        // of A; each one contiguous run
        const int lo = max(t.x0 - t.d0 - (DT - 1), 0);
        const int hi = min(t.x0 - t.d0 + XT - 1, W - 1);
        const int na = min(XT, W - t.x0);
        const float* runs[3] = {B + ((size_t)t.y * W + lo) * CP,
                                B + ((size_t)t.y * W + lo + XT) * CP,
                                A + ((size_t)t.y * W + t.x0) * CP};
        const int rows[3] = {min(XT, hi - lo + 1), max(hi - lo + 1 - XT, 0), na};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mbar_wait(empty + 8 * at.stage, at.phase ^ 1);
          mbar_expect_tx(full + 8 * at.stage, rows[i] * T::ROW);
          if (rows[i] > 0)
            bulk_load(ring + at.stage * T::SLAB, runs[i], rows[i] * T::ROW,
                      full + 8 * at.stage);
          at.advance<T::STAGES>();
        }
        // the weight slabs, one piece of each, multicast to the cluster
        const unsigned char* src = wpk + rank * T::PIECE;
        for (int q = 0; q < slabs_per_tile; ++q) {
          mbar_wait(empty + 8 * at.stage, at.phase ^ 1);
          mbar_expect_tx(full + 8 * at.stage, T::SLAB);
          bulk_multicast(ring + at.stage * T::SLAB + rank * T::PIECE, src,
                         T::PIECE, full + 8 * at.stage, (1u << CL) - 1);
          src += T::SLAB;
          at.advance<T::STAGES>();
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no block leaves while a peer may still reach it
  } else {
    // ---- consumer warpgroups: 64 rows of the tile each ------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = wgroup - 1;
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    static_assert(XT == 16 && DT == 8, "a warp's 16 accumulator rows are one d");
    const uint32_t act_s = base + wg * 64 * 128;  // this consumer's rows, k-block 0
    // stmatrix: lane l addresses row l % 8 of matrix l / 8; matrices 0, 1 are
    // the warp's rows 0-7 and 8-15 of the first chunk, 2, 3 of the second. The
    // chunk's position in its swizzled row is (chunk % 8) ^ (row % 8), and
    // with an even first chunk (c0 | second) ^ row = c0 ^ (second ^ row).
    const uint32_t st_base = act_s + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * 128;
    const uint32_t st_x = (lane >> 4) ^ (lane & 7);

    Ring at{0, 0};
    int held = -1;  // the stage whose wgmma group is in flight
    float acc[T::NH][T::NB / 2];

    for (int it = 0; it < n_iters; ++it) {
      long long tile = (cluster + (long long)it * n_clusters) * CL + rank;
      if (tile >= n_tiles) tile = n_tiles - 1;
      const TileAt t = tile_at(tile, W, D, per_row);
      const int lo = max(t.x0 - t.d0 - (DT - 1), 0);  // first row of B in the ring

      // every warp of this consumer is done reading the activation rows
      wg_sync(wg);

      // the tile's inputs: three stages of the ring
      int in_stage[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        in_stage[i] = at.stage;
        mbar_wait(full + 8 * at.stage, at.phase);
        at.advance<T::STAGES>();
      }
      const float4* sb0 = reinterpret_cast<const float4*>(
          act + T::ACT + in_stage[0] * T::SLAB);
      const float4* sb1 = reinterpret_cast<const float4*>(
          act + T::ACT + in_stage[1] * T::SLAB);
      const float4* sa = reinterpret_cast<const float4*>(
          act + T::ACT + in_stage[2] * T::SLAB);

      // h0 = relu(A + B_shifted) -> bf16: row r of the tile is column
      // x0 + r % XT at disparity d0 + r / XT; this consumer has DT / 2 of the
      // disparities. A thread takes one float4 column of four neighbouring
      // columns x: their four A rows and the seven B rows that x - d spans
      // over the consumer's four disparities, each loaded once.
      static_assert(DT / 2 == 4, "h0 pairs four columns with four disparities");
#pragma unroll 1
      for (int p = tid; p < (XT / 4) * T::C4; p += 128) {
        const int xg = p / T::C4, c4 = p % T::C4;
        const int x = t.x0 + 4 * xg;  // the first of the four columns
        float4 a[4], b[7];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sa[(min(x + i, W - 1) - t.x0) * T::C4 + c4];
#pragma unroll
        for (int k = 0; k < 7; ++k) {  // x - d = x + k - 3 - d0 - 4 wg
          const int br = max(min(x + k - 3 - t.d0 - 4 * wg, W - 1), 0) - lo;
          b[k] = (br < XT ? sb0 : sb1)[(br & (XT - 1)) * T::C4 + c4];
        }
#pragma unroll
        for (int dl = 0; dl < 4; ++dl) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 bb = b[i - dl + 3];
            uint2 v;
            v.x = pack_relu_bf16(a[i].x + bb.x, a[i].y + bb.y);
            v.y = pack_relu_bf16(a[i].z + bb.z, a[i].w + bb.w);
            const int r = (4 * wg + dl) * XT + 4 * xg + i;
            *reinterpret_cast<uint2*>(act + act_offset(r, c4 >> 1) + (c4 & 1) * 8) = v;
          }
        }
      }

      for (int m = 0; m < n_mid; ++m) {
        // the activation rows written above (or by the last epilogue) are
        // in place for the whole consumer and visible to wgmma
        fence_async_shared();
        wg_sync(wg);
        if (m == 0 && tid < CL) {  // the consumer has read the input stages
#pragma unroll
          for (int i = 0; i < 3; ++i) mbar_arrive_cluster(empty + 8 * in_stage[i], tid);
        }

#pragma unroll
        for (int kb = 0; kb < T::KB; ++kb) {
          const uint64_t da = make_desc(act_s + kb * KB_BYTES);
#pragma unroll
          for (int nh = 0; nh < T::NH; ++nh) {
            mbar_wait(full + 8 * at.stage, at.phase);
            const uint64_t db = make_desc(ring + at.stage * T::SLAB);
            wgmma_fence();
            if (kb == 0)
              wgmma_first<T::NB>(acc[nh], da, db);
            else
              wgmma_k16<T::NB>(acc[nh], da, db);
#pragma unroll
            for (int k = 1; k < 4; ++k) wgmma_k16<T::NB>(acc[nh], da + 2 * k, db + 2 * k);
            wgmma_commit();
            if (held >= 0) {
              // the group before this one is done: its stage goes back to
              // the producers of the whole cluster
              wgmma_wait<1>();
              if (tid < CL) mbar_arrive_cluster(empty + 8 * held, tid);
            }
            held = at.stage;
            at.advance<T::STAGES>();
          }
        }
        wgmma_wait<0>();
        if (tid < CL) mbar_arrive_cluster(empty + 8 * held, tid);
        held = -1;

        // epilogue: bias + ReLU; bf16 over this warp's own 16 rows for the
        // next layer, or the final dot with w_last
        const float* bias = mids_b + (size_t)m * CP;
        if (m < n_mid - 1) {
#pragma unroll
          for (int nh = 0; nh < T::NH; ++nh) {
#pragma unroll
            for (int j = 0; j < T::NB / 8; j += 2) {
              // two 8-column chunks, this warp's 16 rows: four 8 x 8 matrices
              const int c0 = (nh * T::NB) / 8 + j;  // the first chunk, even
              uint32_t r[4];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * (c0 + h)) + t4);
                const int e = 4 * (j + h);
                r[2 * h] = pack_relu_bf16(acc[nh][e] + b.x, acc[nh][e + 1] + b.y);  // row g
                r[2 * h + 1] =
                    pack_relu_bf16(acc[nh][e + 2] + b.x, acc[nh][e + 3] + b.y);  // row g + 8
              }
              stmatrix_x4(st_base + (c0 >> 3) * KB_BYTES + (((c0 & 7) ^ st_x) << 4),
                          r[0], r[1], r[2], r[3]);
            }
          }
        } else {
          float p0 = 0.f, p1 = 0.f;
#pragma unroll
          for (int nh = 0; nh < T::NH; ++nh) {
#pragma unroll
            for (int j = 0; j < T::NB / 8; ++j) {
              const int col0 = nh * T::NB + 8 * j;
              const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col0) + t4);
              const float2 w = __ldg(reinterpret_cast<const float2*>(w_last + col0) + t4);
              p0 += fmaxf(acc[nh][4 * j] + b.x, 0.f) * w.x +
                    fmaxf(acc[nh][4 * j + 1] + b.y, 0.f) * w.y;
              p1 += fmaxf(acc[nh][4 * j + 2] + b.x, 0.f) * w.x +
                    fmaxf(acc[nh][4 * j + 3] + b.y, 0.f) * w.y;
            }
          }
          p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
          p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
          p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
          p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
          // this thread's rows 16 warp + g and + 8 of the consumer's 64: one
          // disparity, columns g and g + 8
          const int d = t.d0 + (DT / 2) * wg + warp;
          if (t4 == 0 && d < D) {
            float* orow = out + ((size_t)d * H + t.y) * W;
            const int xa = t.x0 + g, xb = xa + 8;
            if (xa < W) orow[xa] = 1.f / (1.f + expf(-(p0 + b_last)));
            if (xb < W) orow[xb] = 1.f / (1.f + expf(-(p1 + b_last)));
          }
        }
      }
    }
    cluster_sync();
  }
}

template <int CP>
int launch(const float* A, const float* B, const unsigned char* wpk,
           const float* mids_b, const float* w_last, float b_last, float* out,
           int H, int W, int D, int n_mid, int per_row, long long n_tiles,
           cudaStream_t stream) {
  using T = Tile<CP>;
  constexpr int CL = T::CL;
  if (n_tiles == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      head_chain_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;  // clusters the card holds at once
  err = cudaOccupancyMaxActiveClusters(&fit, head_chain_kernel<CP>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long n_groups = (n_tiles + CL - 1) / CL;
  cfg.gridDim = dim3((unsigned)(CL * (n_groups < fit ? n_groups : fit)));
  err = cudaLaunchKernelEx(&cfg, head_chain_kernel<CP>, A, B, wpk, mids_b, w_last,
                           b_last, out, H, W, D, n_mid, per_row, n_tiles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// A, B: (H, W, C) float32; wpk: the mid weights as bf16 in slab order with
// the 128-byte swizzle applied (ops/slow_head.py pack_weights); mids_b:
// (n_mid, C) float32; w_last: (C,) float32; out: (D, H, W) float32, cells
// with x - d < 0 may be left unwritten. per_row: the tiles of one image row
// that have a cell with x >= d, n_tiles = H * per_row
// (ops/slow_head.py tile_plan). C is 384 (the nh2 of every configuration)
// or 64 (narrow heads; the caller zero-pads other widths up to one of
// these); n_mid >= 1. Returns the first CUDA error of the launch (0: none);
// 1 (cudaErrorInvalidValue) for a width it has no instance of.
extern "C" int slow_head(const float* A, const float* B, const unsigned char* wpk,
                         const float* mids_b, const float* w_last, float b_last,
                         float* out, int H, int W, int D, int C, int n_mid,
                         int per_row, long long n_tiles, cudaStream_t stream) {
  switch (C) {
    case 64:
      return launch<64>(A, B, wpk, mids_b, w_last, b_last, out, H, W, D, n_mid,
                        per_row, n_tiles, stream);
    case 384:
      return launch<384>(A, B, wpk, mids_b, w_last, b_last, out, H, W, D, n_mid,
                         per_row, n_tiles, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
