// Cross-based cost aggregation (CBCA): the support arms, their packed
// offsets and one aggregation iteration.
//
// The JAX package runs the arms and the aggregation in XLA with no Pallas
// kernel (mccnn_tpu/ops/cross.py: cross_arms :20, cbca :69; reference
// adcensus.cu:280-341 and :343-400): the arms from a static unroll over arm
// length, the aggregation as 2K - 1 masked shifted adds a direction
// (K = max(2, L1)) under one lax.map over disparity, which XLA fuses. Eager
// PyTorch runs that formulation as some 7 launches a tap (ops/cross.py, the
// *_plain functions). These kernels take its place and give the plain
// versions' bits.
//
// cbca_pack: turns both images' four float arm ends into signed 8-bit
//   offsets from each pixel's own column (the -x and +x ends) or row (-y,
//   +y), clamped to [-K, K], two to an int16: the column pairs for the
//   horizontal pass, the row pairs for the vertical one (each pass reads
//   only its own). The clamp is exact: an aggregation interval is
//   lo = max(xs + 1, x - R), hi = min(xt - 1, x + R) (R = K - 1), so an end
//   beyond +-K gives the same lo, hi or empty interval as the clamped one;
//   the same for rows, a row slab's halo rows whose arms point outside the
//   slab included. The right image's arm at the match column x + d * dir,
//   shifted back by d * dir, is the right pixel's own offset, so the
//   tighter arm is the max (min) of two bytes. The column pairs sit in rows
//   padded to a multiple of 8, the right image's in eight copies shifted by
//   0-7 columns: any eight pairs from a match column are one aligned
//   16-byte load (eight strided 2-byte loads a thread cost 0.6 ms of the
//   Middlebury call). Bound: bytes, the two arm stacks read and the pairs
//   written (32 H W + 2 (9 H P + 2 H W) bytes, P the padded row).
//
// cbca: a block takes one disparity and TS rows x TX columns of outputs.
//   Horizontal pass: the block walks the TS + 2R rows that its outputs
//   read in chunks of CH rows. Each warp stages rows of the volume (NaN and
//   out of frame read as 0) with PL >= R columns on each side, 16-byte
//   aligned; a thread then takes HP adjacent columns of one staged row,
//   loads their window with 16-byte shared loads into registers and walks
//   it once in ascending order, each value serving up to HP sums. Each sum
//   runs over all 2K - 1 taps of its window, unrolled, and adds a tap when
//   the tap lies in its interval (one bit test of a mask, a word for each
//   32 taps, and a predicated add). The counts (at most 2K - 1) are the
//   interval's integer length clipped to the frame, stored as bytes. The
//   next chunk's global loads are in flight while a chunk adds its taps.
//   Vertical pass: a thread takes VP adjacent rows of one column and walks
//   the VP + 2R row sums of that column once in ascending order from
//   shared memory, each serving up to VP outputs, with the counts as
//   integers; then the IEEE quotient (__fdiv_rn, as torch's CUDA division).
//   The order is the plain version's: it adds where(mask, v, 0) for
//   k = -(K-1) .. K-1 in ascending order from +0. An accumulator that
//   starts at +0 is never -0, so adding the masked +0s changes nothing, and
//   an add skipped outside the interval gives the same bits: each sum here
//   adds the same values in the same order from +0.0f, with __fadd_rn (no
//   FMA contraction). No prefix sum, running window or other reordering:
//   that would move the roundings. Cells whose x + d * dir lies out of
//   frame pass the volume through, NaN bits included, and never read the
//   right image's offsets. Out of place: the halo reads forbid in place.
//   The window is a template argument: K itself for every K that config.py
//   sets (2, 3, 5, 14), and the next of 8, 16, 32, 64 for any other K up to
//   64. Its offsets, clamped to [-K, K], keep every interval inside
//   [-(K-1), K-1], so the taps past K - 1 add nothing and K itself is never
//   read. (nvcc's device compiler ran past 120-280 s on every version that
//   clipped the intervals by a K known only at run time, a loop over such a
//   window included; the windows known at compile time build in seconds.)
//   Bound: bytes, the volume read and written once (8 D H W bytes; with
//   the float arm stacks' 32 H W, as chip_smoke.py counts it, 0.25 ms at
//   KITTI size, 0.73 ms at Middlebury's); the adds, 2 (2K - 1) a cell at
//   most, stay below that at the f32 instruction rate. What holds it: the
//   instructions of the unrolled taps (2 a tap horizontally, 3 vertically
//   with the count) and of each sum's mask. Shared memory (cbca_smem):
//   TS + 2R rows of sums (float) and counts (byte) and CH staged rows:
//   34,944 bytes at K = 14, six blocks of 128 threads an SM.
//
// cross_arms: a thread a pixel walks each of its four arms, k = 2 .. K - 1,
//   to the first in-frame probe with |c - p| >= tau1 (the subtraction in
//   round-to-nearest, the compare against tau1 as the f32 torch compares
//   with), caps the break at the frame and stores the exclusive end as a
//   float: exact. Bound: bytes, the image read and four planes written
//   (20 H W bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;           // threads a block
constexpr int TX = 64, TS = 64;   // a cbca block's outputs: columns x rows
constexpr int HP = 8;             // horizontal sums a thread: adjacent columns
constexpr int VP = 8;             // outputs a thread: adjacent rows
constexpr int CH = NT * HP / TX;  // staged volume rows a chunk (16)
constexpr int KMAX = 64;          // the largest window built

__host__ __device__ constexpr int pad4(int r) { return (r + 3) & ~3; }

// The compile-time window that serves K: K itself for the K of config.py,
// else the next of 8, 16, 32, 64 (K past 64: K, which no instance serves).
__host__ __device__ constexpr int window_of(int K) {
  return (K == 2 || K == 3 || K == 5 || K == 14 || K > KMAX) ? K
         : K <= 8 ? 8 : K <= 16 ? 16 : K <= 32 ? 32 : 64;
}

// the cbca block's row sums ((TS + 2R) x TX floats) and counts (as many
// bytes), and a chunk of staged volume rows (CH x (TX + 2 pad4(R)) floats),
// R = window_of(K) - 1
__host__ __device__ constexpr int cbca_smem(int K) {
  return (TS + 2 * (window_of(K) - 1)) * TX * 5
         + CH * (TX + 2 * pad4(window_of(K) - 1)) * 4;
}

// the signed bytes of a packed pair, held as a sign-extended int16
__device__ __forceinline__ int lo8(int a) { return (signed char)a; }
__device__ __forceinline__ int hi8(int a) { return a >> 8; }

// pair j (compile time) of eight int16 in a 16-byte load, sign-extended
__device__ __forceinline__ int pair_of(uint4 u, int j) {
  const unsigned w =
      j / 2 == 0 ? u.x : j / 2 == 1 ? u.y : j / 2 == 2 ? u.z : u.w;
  return j % 2 ? (int)w >> 16 : (int)(w << 16) >> 16;
}

// bits a .. b of a 32-bit word (none where b < a; a and b clipped to it)
__device__ __forceinline__ unsigned bit_span(int a, int b) {
  a = max(a, 0);
  b = min(b, 31);
  return b < a ? 0u : ((2u << (b - a)) - 1u) << a;
}

// the row pitch of the horizontal planes: 8 columns of padding on each side
// and W rounded up to 8, so that 8 columns from a multiple of 8 are one
// aligned 16-byte load
__host__ __device__ constexpr int pack_pitch(int W) {
  return ((W + 7) & ~7) + 16;
}

// an arm pair as an int16: the -end's offset in the low byte, the +end's in
// the high one, each clamped to [-K, K]
__device__ __forceinline__ int16_t arm_pair(const float* __restrict__ lo,
                                            const float* __restrict__ hi,
                                            size_t p, int coord, float k) {
  const float c = (float)coord;
  const int a = __float2int_rn(fminf(fmaxf(lo[p] - c, -k), k));
  const int b = __float2int_rn(fminf(fmaxf(hi[p] - c, -k), k));
  return (int16_t)((a & 0xff) | ((b & 0xff) << 8));
}

// x0c, x1c: (4, H, W) exclusive arm ends. packed, int16, in turn: the left
// image's column pairs (H, P): column c at c + 8; the right image's, eight
// times (8, H, P): copy s holds column c at c - s + 8; the left and the
// right image's row pairs (H, W) each. 0 where no column is. A thread a
// (row, padded column).
__global__ void __launch_bounds__(256)
cbca_pack_kernel(const float* __restrict__ x0c, const float* __restrict__ x1c,
                 int16_t* __restrict__ packed, int H, int W, int K) {
  const int xp = blockIdx.x * blockDim.x + threadIdx.x, y = blockIdx.y;
  const int P = pack_pitch(W);
  if (xp >= P) return;
  const size_t plane = (size_t)H * W, row = (size_t)y * W;
  const float k = (float)K;
  int16_t* hl = packed;
  int16_t* hr = hl + (size_t)H * P;
  int16_t* vl = hr + (size_t)8 * H * P;
  int16_t* vr = vl + plane;
  const int c = xp - 8;
  hl[(size_t)y * P + xp] =
      c >= 0 && c < W ? arm_pair(x0c, x0c + plane, row + c, c, k) : 0;
#pragma unroll
  for (int s = 0; s < 8; ++s)
    hr[((size_t)s * H + y) * P + xp] =
        c + s >= 0 && c + s < W
            ? arm_pair(x1c, x1c + plane, row + c + s, c + s, k) : 0;
  if (xp < W) {
    vl[row + xp] = arm_pair(x0c + 2 * plane, x0c + 3 * plane, row + xp, y, k);
    vr[row + xp] = arm_pair(x1c + 2 * plane, x1c + 3 * plane, row + xp, y, k);
  }
}

// vol, out: (D, H, W); packed: cbca_pack_kernel's offsets, clamped to
// [-K, K]. KB is the window: K = KB, or any K < KB. The clamped offsets
// keep every interval inside [-(K-1), K-1], so no interval needs a clip
// to the window, and the taps past K - 1 add nothing.
template <int KB>
__global__ void __launch_bounds__(NT)
cbca_kernel(const float* __restrict__ vol,
            const int16_t* __restrict__ packed, float* __restrict__ out,
            int H, int W, int dir) {
  constexpr int R = KB - 1;
  constexpr int PL = pad4(R);          // staged columns left of the tile
  constexpr int VW = TX + 2 * PL;      // a staged row
  constexpr int HR = TS + 2 * R;       // rows of horizontal sums
  constexpr int NW = HP + 2 * PL;      // a thread's window of a staged row
  constexpr int MW = (2 * R + 32) / 32;  // words of an interval's bit mask
  constexpr bool WIN = NW <= 40;         // the window in registers
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                                           // HR x TX
  float* sv = hs + HR * TX;                                   // CH x VW
  unsigned char* hc = reinterpret_cast<unsigned char*>(sv + CH * VW);
  const int bx = blockIdx.x * TX, by = blockIdx.y * TS;
  const int delta = blockIdx.z * dir;
  const size_t plane = (size_t)H * W;
  const float* v = vol + blockIdx.z * plane;
  float* o = out + blockIdx.z * plane;
  // the columns whose match x + delta lies in frame: [xlo, xhi)
  const int xlo = max(0, -delta), xhi = min(W, W - delta);
  if (bx + TX <= xlo || bx >= xhi) {  // none in the tile: pass through
    for (int i = threadIdx.x; i < TS * TX; i += NT) {
      const int y = by + i / TX, x = bx + i % TX;
      if (y < H && x < W) o[(size_t)y * W + x] = v[(size_t)y * W + x];
    }
    return;
  }

  // --- horizontal pass: hs[k][c], hc[k][c] for frame row by - R + k --------
  // A chunk's global loads (the volume rows a warp stages, the offsets of a
  // thread's HP sums) are issued while the chunk before adds its taps, so
  // that their latency hides behind that work. No load sits behind a
  // branch: the volume's are predicated, the offsets' read clamped
  // addresses and are masked after.
  constexpr int ER = CH / (NT / 32);   // rows a warp stages a chunk
  constexpr int EC = (VW + 31) / 32;   // values a lane stages a row
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = threadIdx.x / (TX / HP), g = threadIdx.x % (TX / HP);
  const int P = pack_pitch(W);
  const int16_t* hl = packed;
  const int16_t* hr = hl + (size_t)H * P;
  float pv[ER][EC];
  uint4 pa, pb;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < ER; ++e) {
      const int y = by - R + k0 + warp + e * (NT / 32);
      const bool yin = k0 + warp + e * (NT / 32) < HR && y >= 0 && y < H;
      const float* vr = v + (size_t)min(max(y, 0), H - 1) * W;
#pragma unroll
      for (int c = 0; c < EC; ++c) {
        const int s = lane + 32 * c, x = bx - PL + s;
        pv[e][c] = 0.f;
        if (s < VW && yin && x >= 0 && x < W) pv[e][c] = vr[x];
      }
    }
    // the HP pairs of each image from one 16-byte load: the left image's
    // from column x0, the right's from x0 + delta, in the copy that puts
    // that column on a multiple of 8 (clamped where no column is valid)
    const size_t yr = min(max(by - R + k0 + r, 0), H - 1);
    const int x0 = min(bx + g * HP, (W + 7) & ~7);
    const int q = min(max(x0 + delta, -8), W - 1);
    pa = *reinterpret_cast<const uint4*>(hl + yr * P + x0 + 8);
    pb = *reinterpret_cast<const uint4*>(hr + ((q & 7) * H + yr) * P
                                         + (q & ~7) + 8);
  };
  fetch(0);
  for (int k0 = 0; k0 < HR; k0 += CH) {
#pragma unroll
    for (int e = 0; e < ER; ++e)
#pragma unroll
      for (int c = 0; c < EC; ++c) {
        const int s = lane + 32 * c;
        if (s < VW)
          sv[(warp + e * (NT / 32)) * VW + s] =
              isnan(pv[e][c]) ? 0.f : pv[e][c];
      }
    const int k = k0 + r, y = by - R + k, x0 = bx + g * HP;
    const bool yin = y >= 0 && y < H;
    unsigned m[HP][MW];    // tap t of output j: bit t + R
    unsigned cnt[HP / 4];  // the counts, a byte each
    bool any = false;
#pragma unroll
    for (int j = 0; j < HP; ++j) {
      const int x = x0 + j;
      int lo = 1, hi = 0;
      if (yin && x >= xlo && x < xhi) {
        const int a = pair_of(pa, j), b = pair_of(pb, j);
        lo = max(max(lo8(a), lo8(b)) + 1, -x);
        hi = min(min(hi8(a), hi8(b)) - 1, W - 1 - x);
      }
#pragma unroll
      for (int u = 0; u < MW; ++u)
        m[j][u] = bit_span(lo + R - 32 * u, hi + R - 32 * u);
      const unsigned n = max(hi - lo + 1, 0);
      cnt[j / 4] = j % 4 ? cnt[j / 4] | n << (8 * (j % 4)) : n;
      any |= hi >= lo;
    }
    __syncthreads();
    if (k0 + CH < HR) fetch(k0 + CH);
    if (k < HR) {
      float s[HP];
#pragma unroll
      for (int j = 0; j < HP; ++j) s[j] = 0.f;
      // the window: row[w] is column x0 - PL + w; output j's tap t is
      // w = PL + j + t
      const float* row = sv + r * VW + g * HP;
      if (any) {
        float win[WIN ? NW : 1];
        if constexpr (WIN) {
#pragma unroll
          for (int q = 0; q < NW; q += 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(row + q);
            win[q] = t4.x;
            win[q + 1] = t4.y;
            win[q + 2] = t4.z;
            win[q + 3] = t4.w;
          }
        }
#pragma unroll
        for (int w = PL - R; w < PL + R + HP; ++w) {
          const float val = WIN ? win[WIN ? w : 0] : row[w];
#pragma unroll
          for (int j = 0; j < HP; ++j) {
            const int b = w - PL - j + R;  // t + R
            if (b < 0 || b > 2 * R) continue;
            if (m[j][b / 32] >> (b % 32) & 1u) s[j] = __fadd_rn(s[j], val);
          }
        }
      }
      float4* hq = reinterpret_cast<float4*>(hs + k * TX + g * HP);
#pragma unroll
      for (int q = 0; q < HP / 4; ++q)
        hq[q] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      *reinterpret_cast<uint2*>(hc + k * TX + g * HP) =
          make_uint2(cnt[0], cnt[1]);
    }
    __syncthreads();
  }

  // --- vertical pass: VP rows of one column a task ---------------------------
  // A thread's NV tasks in turn, the next task's offsets loaded while this
  // one adds its taps.
  constexpr int NV = TX * (TS / VP) / NT;
  const int16_t* a0v = hr + (size_t)8 * H * P;
  const int16_t* a1v = a0v + plane;
  int qa[VP], qb[VP];
  auto vfetch = [&](int i) {
    const int task = threadIdx.x + i * NT;
    const int x = min(bx + task % TX, W - 1), y0 = by + task / TX * VP;
    const int xr = min(max(x + delta, 0), W - 1);
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      const size_t row = (size_t)min(y0 + j, H - 1) * W;
      qa[j] = a0v[row + x];
      qb[j] = a1v[row + xr];
    }
  };
  vfetch(0);
#pragma unroll 1
  for (int i = 0; i < NV; ++i) {
    const int task = threadIdx.x + i * NT;
    const int c = task % TX, q = task / TX;
    const int x = bx + c, y0 = by + q * VP;
    unsigned m[VP][MW];
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      const int y = y0 + j;
      int lo = 1, hi = 0;
      if (y < H) {
        lo = max(max(lo8(qa[j]), lo8(qb[j])) + 1, -y);
        hi = min(min(hi8(qa[j]), hi8(qb[j])) - 1, H - 1 - y);
      }
#pragma unroll
      for (int u = 0; u < MW; ++u)
        m[j][u] = bit_span(lo + R - 32 * u, hi + R - 32 * u);
    }
    if (i + 1 < NV) vfetch(i + 1);
    if (x >= W || y0 >= H) continue;
    float* orow = o + (size_t)y0 * W + x;
    if (x < xlo || x >= xhi) {
      const float* vrow = v + (size_t)y0 * W + x;
#pragma unroll
      for (int j = 0; j < VP; ++j)
        if (y0 + j < H) orow[j * W] = vrow[j * W];
      continue;
    }
    float s[VP];
    int n[VP];
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      s[j] = 0.f;
      n[j] = 0;
    }
    // the sum of frame row y0 + j + t is at w = j + t + R
    const float* hcol = hs + q * VP * TX + c;
    const unsigned char* ccol = hc + q * VP * TX + c;
#pragma unroll
    for (int w = 0; w < VP + 2 * R; ++w) {
      const float h = hcol[w * TX];
      const int cn = ccol[w * TX];
#pragma unroll
      for (int j = 0; j < VP; ++j) {
        const int b = w - j;  // t + R
        if (b < 0 || b > 2 * R) continue;
        if (m[j][b / 32] >> (b % 32) & 1u) {
          s[j] = __fadd_rn(s[j], h);
          n[j] += cn;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VP; ++j)
      if (y0 + j < H) orow[j * W] = __fdiv_rn(s[j], fmaxf((float)n[j], 1.f));
  }
}

// img: (H, W); arms: (4, H, W): [0] -x, [1] +x (column ends), [2] -y,
// [3] +y (row ends)
__global__ void __launch_bounds__(256)
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

template <int KB>
int cbca_run(const float* vol, const int16_t* packed, float* out, int D,
             int H, int W, int dir, cudaStream_t stream) {
  const int smem = cbca_smem(KB);
  cudaError_t err = cudaFuncSetAttribute(
      cbca_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cbca_kernel<KB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TX - 1) / TX, (H + TS - 1) / TS, D);
  cbca_kernel<KB><<<grid, NT, smem, stream>>>(vol, packed, out, H, W, dir);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry: contiguous tensors on the card; returns cudaGetLastError()
// after its one launch on `stream`.

extern "C" int cbca_smem_bytes(int K) { return cbca_smem(K); }

// The packed offsets of both images' arms x0c, x1c (4, H, W) float32 into
// packed (9 H pack_pitch(W) + 2 H W int16), clamped to [-K, K]
// (K <= KMAX).
extern "C" int cbca_pack_launch(const float* x0c, const float* x1c,
                                int16_t* packed, int H, int W, int K,
                                cudaStream_t stream) {
  if (K < 2 || K > KMAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((pack_pitch(W) + 255) / 256, H);
  cbca_pack_kernel<<<grid, 256, 0, stream>>>(x0c, x1c, packed, H, W, K);
  return (int)cudaGetLastError();
}

// One CBCA iteration: out = cbca(x0c, x1c, vol, dir, K) over vol (D, H, W)
// float32, from the arms packed by cbca_pack_launch with the same K.
extern "C" int cbca_launch(const float* vol, const int16_t* packed,
                           float* out, int D, int H, int W, int K, int dir,
                           cudaStream_t stream) {
  if (K < 2 || K > KMAX) return (int)cudaErrorInvalidValue;
  switch (window_of(K)) {
    case 2: return cbca_run<2>(vol, packed, out, D, H, W, dir, stream);
    case 3: return cbca_run<3>(vol, packed, out, D, H, W, dir, stream);
    case 5: return cbca_run<5>(vol, packed, out, D, H, W, dir, stream);
    case 14: return cbca_run<14>(vol, packed, out, D, H, W, dir, stream);
    case 8: return cbca_run<8>(vol, packed, out, D, H, W, dir, stream);
    case 16: return cbca_run<16>(vol, packed, out, D, H, W, dir, stream);
    case 32: return cbca_run<32>(vol, packed, out, D, H, W, dir, stream);
    default: return cbca_run<64>(vol, packed, out, D, H, W, dir, stream);
  }
}

extern "C" int cross_arms_launch(const float* img, float* arms, int H, int W,
                                 int K, float tau1, cudaStream_t stream) {
  const dim3 grid((W + 255) / 256, H);
  cross_arms_kernel<<<grid, 256, 0, stream>>>(img, arms, H, W, K, tau1);
  return (int)cudaGetLastError();
}
