// Fast-arch cost-volume join in the disparity-minor (Hp, Wp, Dp) layout.
//
// Replaces the TPU kernel mccnn_tpu/ops/join_pallas.py::_join_plus:
//   out[y, x, d] = -<a[y, :, x], b[y, :, x + d]>
// NaN where x + d >= W, d >= d_true (the real disparity count, at most
// D; D itself unless the caller bucketed D), d >= D or y >= H; rows
// x < n_fix of the first column tile replaced by row n_fix, NaNs included
// (fix_border, main.lua:922-927). Both reference sides run this kernel:
// the left side on x-flipped maps (the mirror identity), so its volume
// comes out x-reversed.
//
// Storage: the volume is float32, bfloat16 or float16 (out_dtype of the
// TPU kernel, join_pallas.py:239-245; a template argument here). The dots
// and the masks are float32 whatever the storage; only the store rounds,
// to nearest even (a NaN stays a NaN), so a 16-bit volume is the float32
// one rounded, bit for bit.
//
// Arithmetic: bf16 products on the tensor cores, as the TPU kernel's
// (join_pallas.py:148-165), with one split level more. Each f32 operand
// v is split into three bf16 (round to nearest even) v1 = bf16(v),
// v2 = bf16(v - v1), v3 = bf16(v - v1 - v2), and the dot keeps the six
// products a_i.b_j with i + j <= 4 (1-based), summed in float32 on the
// tensor cores. bf16 keeps 8 significant bits, so each level is within
// 2^-8 of what is left: the TPU kernel's two levels (three products)
// leave a cell up to about 3 * 2^-16 sum |a||b| from the float32 dot
// (9.8e-6 measured at 8 channels, for L2-normalized maps, whose
// sum |a||b| <= 1); three levels leave about 4 * 2^-24 sum |a||b|, the
// size of the float32 rounding of the sums. ops/join.py
// join_plus_split_plain is the plain emulation of both.
//
// Bound on the H100: bytes. At KITTI size (H=370, W=1226, C=64, D=228) one
// side reads 2 x 116 MB of features and writes a 414 MB volume of real
// cells (0.193 ms at 3.35 TB/s; the padded buffer is 503 MB); the six
// bf16 passes are 8e10 operations (0.08 ms at 989 TFLOP/s).
//
// Design: for an image row y and a tile of XM = 64 reference columns x0..,
// the band d in [d0, d0 + 256) needs the Gram columns x0 + d0 .. + 319: a
// 64 x 320 Gram tile G[i][j] = <a[x0 + i], b[x0 + d0 + j]>, whose cells
// with 0 <= j - i < 256 are the output rows' disparities (a wider band
// is cut into chunks of 256; a chunk of 128 computes and drops the last
// two column blocks). A compute warpgroup computes the tile with wgmma
// m64n64k16 in five column blocks of 64, over K = 64 channels (more
// channels: the entry launches the kernel once a slab of 64, each launch
// after the first adding into the output). The channel-major f32 tiles
// (C rows of 64 contiguous x per operand block) arrive by asynchronous
// 16-byte copies (cp.async). A thread reads its own A fragments (the
// wgmma register layout) from the f32 A block and splits them in
// registers; the split pass writes the three levels of a B block
// transposed into K-major tiles in the 128-byte swizzle (64 channels =
// one swizzle row of bf16). A block walks the x-tiles of a row
// (persistent blocks over the (row, disparity chunk) work list), so the
// 64-column B blocks form a ring of five slots: each tile copies and
// splits one new B block and its A block, and the next tile's f32 copies
// fly while this tile multiplies. The epilogue of a column block (the
// shear of its accumulator fragments into a staging tile, row i, lane
// d = j - i, with the masks) runs while the tensor cores multiply the
// next one, in a second set of accumulators. A store warpgroup writes the
// staging tile out by coalesced 16-byte stores (each row is Dp contiguous
// floats of the output) while the compute warpgroup splits and multiplies
// the next tile. Two named barriers hand the staging tile back and forth
// (full: written; free: read out).
//
// Why not the bulk-copy unit (cp.async.bulk, the TMA's 1-D copy): a tile's
// operands are 2 C runs of 256 bytes, and its output 64 runs of 1 KB;
// measured on the H100, the SM's bulk-copy unit took about 60 clocks per
// request whatever its size, so issuing a tile's 128 operand copies took
// 9.6 kclk and its 64 row stores 4.5 kclk of the tile's 20: 0.679 ms a
// side, against 0.394 with cp.async and plain stores, and 0.336 with the
// stores in a warpgroup of their own (PERF.md). A 16-bit volume is
// written by the same warpgroup from the same float32 staging tile, eight
// values a 16-byte store: half the bytes written.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "split.cuh"

namespace {

constexpr int XM = 64;            // output columns (Gram rows) per tile
constexpr int DB = 256;           // disparities per chunk of the band
constexpr int NB = (XM + DB) / 64;  // 64-column B blocks a tile reads: 5
constexpr int KC = 64;            // channels a launch: one 128-byte row of bf16
constexpr int LV = 3;             // bf16 levels of the split
constexpr int CT = 128;           // the compute warpgroup: threads 0-127
constexpr int THREADS = 2 * CT;   // and the store warpgroup
constexpr int TILE = XM * 128;    // bytes of one bf16 level of a B block (8 KB)
constexpr int SA = XM + 4;        // f32 A block row stride (conflict-free fragment reads)
constexpr int OS = DB + 4;        // staging row stride in floats (fewer bank conflicts)
constexpr int RING_OFF = 0;                          // NB slots of LV levels
constexpr int STA_OFF = RING_OFF + NB * LV * TILE;   // f32 A block
constexpr int STB_OFF = STA_OFF + KC * SA * 4;       // f32 B block
constexpr int OUT_OFF = STB_OFF + KC * XM * 4;       // output staging
constexpr int SMEM = 1024 + OUT_OFF + XM * OS * 4;   // 1024: to align the base (swizzle)
static_assert(SMEM <= 227 * 1024, "shared memory of one H100 block");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous, in this thread's copy group
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have landed
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// generic-proxy shared-memory writes ordered before async-proxy reads
// (wgmma operands)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: rows of 64 bf16, 8-row atoms 1024 bytes apart. Advancing 16
// elements of K adds 32 bytes, 2 in the (address >> 4) field.
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

// D (64 x 64 float32) = A (64 x 16) . B (64 x 16)^T with `acc` 0 (D
// written only) or D += A . B^T with `acc` 1; A from registers (the
// fragment of rows 16 w + g, + 8 and channels 2 t4, + 1, + 8, + 9 of warp
// w, lane 4 g + t4), B K-major in shared memory.
template <int ACC>
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(ACC));
}

// Two 16-bit values (round to nearest even) in one word, lo in the low
// half, for a volume stored as OUT.
template <typename OUT>
__device__ __forceinline__ uint32_t pack_out(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack_out<__nv_bfloat16>(float lo, float hi) {
  return pack2<false>(lo, hi);
}

template <>
__device__ __forceinline__ uint32_t pack_out<__half>(float lo, float hi) {
  return pack2<true>(lo, hi);
}

// named barriers: wait for n threads, or count this one without waiting
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The f32 B block src (C rows of XM columns) as LV bf16 K-major tiles
// (level l at dst + l * TILE): row r = column r of the block, 64 channels
// (zero past C) in the 128-byte swizzle (16-byte chunk ch at position
// ch ^ (r % 8)). A thread takes one column and one chunk of eight
// channels at a time, so a warp reads 32 consecutive columns of a channel
// row and writes eight distinct chunk positions per 128 bytes: no bank
// conflicts.
__device__ __forceinline__ void split_block(const float* src, unsigned char* dst,
                                            int C, int tid) {
  const int r = tid & (XM - 1);
#pragma unroll
  for (int ch = tid / XM; ch < KC / 8; ch += CT / XM) {
    uint32_t w[4][LV];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 8 * ch + 2 * k;
      float v0 = c < C ? src[c * XM + r] : 0.f;
      float v1 = c + 1 < C ? src[(c + 1) * XM + r] : 0.f;
      split2(v0, v1, w[k]);
    }
    const int off = r * 128 + ((ch ^ (r & 7)) << 4);
#pragma unroll
    for (int l = 0; l < LV; ++l)
      *reinterpret_cast<uint4*>(dst + l * TILE + off) =
          make_uint4(w[0][l], w[1][l], w[2][l], w[3][l]);
  }
}

// This thread's A fragments, the LV levels of each of the four 16-channel
// steps, from the f32 A block src (C rows of XM columns, stride SA).
__device__ __forceinline__ void split_a(const float* src, uint32_t (&fa)[LV][4][4],
                                        int C, int warp, int g, int t4) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 16 * warp + g + 8 * (q & 1);
      const int c = 16 * k + 2 * t4 + 8 * (q >> 1);
      float v0 = c < C ? src[c * SA + r] : 0.f;
      float v1 = c + 1 < C ? src[(c + 1) * SA + r] : 0.f;
      uint32_t w[LV];
      split2(v0, v1, w);
#pragma unroll
      for (int l = 0; l < LV; ++l) fa[l][k][q] = w[l];
    }
}

// One 64-column Gram block: the six level products, the smallest first,
// each over the four 16-channel steps. `slot` is the block's B tiles.
__device__ __forceinline__ void gram_block(float (&d)[32], const uint32_t (&fa)[LV][4][4],
                                           uint32_t slot) {
  constexpr int PA[6] = {2, 0, 1, 1, 0, 0};  // A level of each product
  constexpr int PB[6] = {0, 2, 1, 0, 1, 0};  // B level
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const uint64_t db = make_desc(slot + PB[p] * TILE);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (p == 0 && k == 0)
        wgmma64<0>(d, fa[PA[p]][k], db);
      else
        wgmma64<1>(d, fa[PA[p]][k], db + 2 * k);
    }
  }
}

// OUT: the volume's storage type. With `add`, the staging tile is added
// to the float32 sums of the channel slabs before this one, read from
// `prev`: `out` itself for a float32 volume (so neither pointer is
// __restrict__), a float32 buffer for a 16-bit one.
template <typename OUT>
__global__ void __launch_bounds__(THREADS, 1)
    join_kernel(const float* __restrict__ a, const float* __restrict__ b,
                OUT* out, const float* prev, int H,
                int W, int C, int Ct, int Hp, int Wp, int Wb, int Dp,
                int d_true, int n_fix, int add) {
  constexpr bool F32 = std::is_same<OUT, float>::value;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_addr(smem_raw));
  unsigned char* ring = sm + RING_OFF;
  float* stg_a = reinterpret_cast<float*>(sm + STA_OFF);
  float* stg_b = reinterpret_cast<float*>(sm + STB_OFF);
  float* ost = reinterpret_cast<float*>(sm + OUT_OFF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_xt = Wp / XM;
  const int n_chunks = (Dp + DB - 1) / DB;
  const int n_items = Hp * n_chunks;
  const int n_real = H * n_chunks;     // items of real rows come first
  const int n_units = NB - 1 + n_xt;   // a real item's copies: NB-1 B blocks, then a tile each
  const float QNAN = __int_as_float(0x7fc00000);

  // what unit u of item `it` copies: the A block of tile u - (NB-1) and B
  // block kb (its columns in b: d0 + 64 kb ..), unless past the end of b
  // (then no tile cell reads it)
  struct Unit {
    int y, d0, xt, kb;
    bool has_b;
  };
  auto unit_of = [&](int it, int u) {
    Unit un;
    un.y = it / n_chunks;
    un.d0 = (it % n_chunks) * DB;
    un.xt = u - (NB - 1);
    un.kb = un.xt < 0 ? u : un.xt + NB - 1;
    un.has_b = un.d0 + 64 * (un.kb + 1) <= Wb;
    return un;
  };
  auto fetch = [&](int it, int u) {
    const Unit un = unit_of(it, u);
    for (int k = tid; k < C * (XM / 4); k += CT) {
      const int c = k / (XM / 4), q = 4 * (k % (XM / 4));
      const size_t row = (size_t)un.y * Ct + c;
      if (un.xt >= 0) copy16(stg_a + c * SA + q, a + row * Wp + XM * un.xt + q);
      if (un.has_b) copy16(stg_b + c * XM + q, b + row * Wb + un.d0 + 64 * un.kb + q);
    }
    copy_commit();
  };
  enum { BAR_WG = 1, BAR_FULL = 2, BAR_FREE = 3 };
  if (tid >= CT) {
    // ---- the store warpgroup: each staging tile out, 16 bytes a thread
    // (added to the sums so far for a channel slab past the first): four
    // floats, or eight 16-bit values ---------------------------------------
    const int st = tid - CT;
    constexpr int VPS = F32 ? 4 : 8;  // values a 16-byte store
    int n_tiles = 0;
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) n_tiles += n_xt;
    bar_arrive(BAR_FREE, THREADS);
    int done = 0;
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      const int y = it / n_chunks, d0 = (it % n_chunks) * DB;
      const int nq = min(DB, Dp - d0) / VPS;
      for (int xt = 0; xt < n_xt; ++xt) {
        bar_sync(BAR_FULL, THREADS);
        for (int k = st; k < XM * nq; k += CT) {
          const int r = k / nq, q = k % nq;
          const float* sp = ost + r * OS + VPS * q;
          const size_t at = ((size_t)y * Wp + xt * XM + r) * Dp + d0 + VPS * q;
          float v[VPS];
#pragma unroll
          for (int i = 0; i < VPS; i += 4) {
            float4 s = *reinterpret_cast<const float4*>(sp + i);
            if (add) {
              const float4 o = __ldcs(reinterpret_cast<const float4*>(prev + at + i));
              s.x += o.x;
              s.y += o.y;
              s.z += o.z;
              s.w += o.w;
            }
            v[i] = s.x;
            v[i + 1] = s.y;
            v[i + 2] = s.z;
            v[i + 3] = s.w;
          }
          if constexpr (F32)
            __stcs(reinterpret_cast<float4*>(out + at), make_float4(v[0], v[1], v[2], v[3]));
          else
            __stcs(reinterpret_cast<uint4*>(out + at),
                   make_uint4(pack_out<OUT>(v[0], v[1]), pack_out<OUT>(v[2], v[3]),
                              pack_out<OUT>(v[4], v[5]), pack_out<OUT>(v[6], v[7])));
        }
        if (++done < n_tiles) bar_arrive(BAR_FREE, THREADS);
      }
    }
    return;
  }

  // ---- the compute warpgroup -------------------------------------------
  if ((int)blockIdx.x < n_real) fetch(blockIdx.x, 0);
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t fa[LV][4][4];
  float acc[2][32];

  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int y = it / n_chunks, d0 = (it % n_chunks) * DB;
    const int dbc = min(DB, Dp - d0);
    if (y >= H) {  // a pad row: NaN throughout
      for (int xt = 0; xt < n_xt; ++xt) {
        bar_sync(BAR_FREE, THREADS);
        for (int i = tid; i < XM * dbc; i += CT) ost[(i / dbc) * OS + i % dbc] = QNAN;
        bar_arrive(BAR_FULL, THREADS);
      }
      continue;
    }
    for (int u = 0; u < n_units; ++u) {
      const Unit un = unit_of(it, u);
      copy_wait();
      bar_sync(BAR_WG, CT);
      if (un.xt >= 0) split_a(stg_a, fa, C, warp, g, t4);
      if (un.has_b) split_block(stg_b, ring + (un.kb % NB) * LV * TILE, C, tid);
      fence_async_shared();
      bar_sync(BAR_WG, CT);
      const int nit = u + 1 < n_units ? it : it + gridDim.x;
      if (nit < n_real) fetch(nit, u + 1 < n_units ? u + 1 : 0);
      if (un.xt < 0) continue;

      const int x0 = un.xt * XM;
      auto slot = [&](int nb) {
        return base + RING_OFF + ((un.xt + nb) % NB) * LV * TILE;
      };
      wgmma_fence();
      gram_block(acc[0], fa, slot(0));
      wgmma_commit();
      bar_sync(BAR_FREE, THREADS);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb + 1 < NB) {  // the next block multiplies while this one is sheared
          wgmma_fence();
          gram_block(acc[(nb + 1) & 1], fa, slot(nb + 1));
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        const float(&c)[32] = acc[nb & 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * warp + g + 8 * h;
          // row i keeps Gram columns j in [i, i + dbc); of them j < jk are
          // in frame (x + d < W) and real (d < d_true); j counted from 2 t4
          float* rp = ost + i * OS - i + 2 * t4;
          const int jlo = i - 2 * t4, jhi = i + dbc - 2 * t4;
          const int jk = i + min(d_true - d0, W - x0 - i - d0) - 2 * t4;
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int J = 64 * nb + 8 * n8 + e;
              if (J >= jlo && J < jhi) rp[J] = J < jk ? -c[4 * n8 + 2 * h + e] : QNAN;
            }
        }
      }
      if (x0 == 0 && n_fix > 0) {  // fix_border: rows x < n_fix copy row n_fix
        bar_sync(BAR_WG, CT);
        for (int k = tid; k < n_fix * dbc; k += CT)
          ost[(k / dbc) * OS + k % dbc] = ost[n_fix * OS + k % dbc];
      }
      bar_arrive(BAR_FULL, THREADS);
    }
  }
}

// One launch of join_kernel<OUT> on the channel slab [c0, c0 + cs); its
// dynamic shared memory attribute is set once a join_launch.
template <typename OUT>
cudaError_t launch_slab(const float* a, const float* b, OUT* out, const float* prev,
                        int grid, int H, int W, int c0, int cs, int C, int Hp,
                        int Wp, int Wb, int Dp, int d_true, int n_fix,
                        cudaStream_t stream) {
  join_kernel<OUT><<<grid, THREADS, SMEM, stream>>>(
      a + (size_t)c0 * Wp, b + (size_t)c0 * Wb, out, prev, H, W, cs, C, Hp, Wp, Wb,
      Dp, d_true, n_fix, c0 > 0);
  return cudaGetLastError();
}

// Every channel slab into a volume stored as OUT, each slab past the first
// adding the float32 sum of those before it. A float32 volume holds that
// sum itself (prev = out); a 16-bit volume of more than one slab sums the
// slabs before the last in the float32 buffer tmp, and the last slab adds
// that sum and rounds once.
template <typename OUT>
int launch_all(const float* a, const float* b, OUT* out, float* tmp, int grid,
               int H, int W, int C, int Hp, int Wp, int Wb, int Dp, int d_true,
               int n_fix, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<OUT, float>::value;
  cudaError_t err = cudaFuncSetAttribute(
      join_kernel<OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess && !F32 && C > KC)
    err = cudaFuncSetAttribute(join_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  const float* prev = F32 ? reinterpret_cast<const float*>(out) : tmp;
  for (int c0 = 0; c0 < C && err == cudaSuccess; c0 += KC) {
    const int cs = C - c0 < KC ? C - c0 : KC;
    if (F32 || c0 + KC >= C)
      err = launch_slab<OUT>(a, b, out, prev, grid, H, W, c0, cs, C, Hp, Wp, Wb, Dp,
                             d_true, n_fix, stream);
    else
      err = launch_slab<float>(a, b, tmp, tmp, grid, H, W, c0, cs, C, Hp, Wp, Wb,
                               Dp, d_true, n_fix, stream);
  }
  return (int)err;
}

}  // namespace

// a: (Hp, C, Wp), b: (Hp, C, Wb) with Wb >= Wp + Dp and Wb % 4 == 0, both
// float32; out: (Hp, Wp, Dp) of the storage type out_dtype (0 float32, 1
// bfloat16, 2 float16); all contiguous. Wp % 64 == 0, Dp % 128 == 0,
// C > 0, 0 <= n_fix < 8, 0 < d_true <= D <= Dp. tmp: a float32
// (Hp, Wp, Dp) buffer for a 16-bit volume of more than 64 channels, else
// unused (may be null). Launches the kernel once for each slab of 64
// channels, ceil(C / 64) times. Returns the first CUDA error of a launch.
extern "C" int join_launch(const float* a, const float* b, void* out, float* tmp,
                           int H, int W, int C, int Hp, int Wp, int Wb, int Dp,
                           int D, int d_true, int n_fix, int out_dtype,
                           cudaStream_t stream) {
  if (out_dtype < 0 || out_dtype > 2 || d_true < 1 || d_true > D ||
      (out_dtype != 0 && C > KC && tmp == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_items = Hp * ((Dp + DB - 1) / DB);
  if (n_items == 0 || Wp == 0) return 0;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = n_items < n_sm ? n_items : n_sm;  // one block an SM
  if (out_dtype == 1)
    return launch_all(a, b, static_cast<__nv_bfloat16*>(out), tmp, grid, H, W, C, Hp,
                      Wp, Wb, Dp, d_true, n_fix, stream);
  if (out_dtype == 2)
    return launch_all(a, b, static_cast<__half*>(out), tmp, grid, H, W, C, Hp, Wp,
                      Wb, Dp, d_true, n_fix, stream);
  return launch_all(a, b, static_cast<float*>(out), tmp, grid, H, W, C, Hp, Wp, Wb,
                    Dp, d_true, n_fix, stream);
}
