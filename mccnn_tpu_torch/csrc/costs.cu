// The census and absolute-difference cost volumes of the generic lane.
//
// Replace the plain torch chains of ops/costs.py (census_volume,
// ad_volume), the counterparts of mccnn_tpu/ops/costs.py census_volume
// (:103) and ad_volume (:49), which the JAX package leaves to XLA.
// Reference kernels: census adcensus.cu:117-153, ad adcensus.cu:62-93.
// Volumes are (D, H, W) float32, NaN (0x7fc00000, torch.nan's bits)
// where the match column x + d * dir leaves the frame.
//
// census_sig_kernel<R>: the signature pass, once a pair. For every pixel of
// every channel of both images, n = (2r + 1)^2 window positions k =
// (dy + r) * (2r + 1) + (dx + r), bit k % 64 of word k / 64 holds
// x[y + dy, x + dx] < x[y, x] (strict: ties and NaN give 0), clear where
// (y + dy, x + dx) leaves the frame (the plain version's torch.roll wraps
// and masks the wrapped neighbours: the same bits). A pixel's NW =
// ceil(n / 64) words, 8 bytes each; no in-frame words: which positions
// lie in the frame follows from (y, x) and the frame. A block takes STY =
// 16 rows x STX = 32 columns of one channel plane of one image (a 3-D
// grid, no division) and stages them once in shared memory with a halo of
// R, the cells off the frame as NaN: NaN < c is false, so an off-frame
// neighbour gives bit 0 with no test a tap. A lane takes one column and
// SCY = 4 rows of it: for each of the SCY + 2R staged rows it loads the
// 2R + 1 values of its window row once into registers and compares them
// with each centre whose window holds that row. R (0-7) is a template
// argument, so every bit position is a constant and each word is built in
// registers as two 32-bit halves. A warp's lanes hold adjacent columns, so
// a pixel's words go out as one 16-byte store at NW = 2 (the path's radius
// 4: 512 contiguous bytes a warp), two at NW = 4, 8-byte stores at NW = 1
// or 3.
//
// census_volume_kernel<R, ONE, DIR>: cost[d, y, x] = sum over channels
// of n - popc(m & ~(b0 ^ b1)) (the hamming distance plus one for each
// window position out of frame on either side), signature 0 at (y, x),
// signature 1 at (y, x + d * dir), m the window positions in frame for
// both centres: the rows dy in frame at y, the columns dx in frame at x
// and at x + d * dir. The channels' distances are small integers, so
// their float32 sum in any order is exact and equals the integer sum
// converted; the mean multiplies by the float32 reciprocal of C
// (__fmul_rn), as the plain version does. A block takes one row, CW =
// 256 columns (a thread CX = 2 adjacent ones) and DCH = 32 disparities.
// It stages once, in shared memory, the span of match signatures its
// cells read (CW + DCH - 1 columns, zeros off the frame: no finite cell
// reads them) in two planes by the entry's parity, so that a warp's reads
// of one column and disparity are 32 consecutive 16-byte word pairs; the
// reference signatures stay in registers. A cell whose x and x + d * dir
// both lie in [R, W - 1 - R] takes the row's rows-only mask, built once a
// block in registers, and a block whose cells all do takes it without a
// test; only cells within R of an edge read the (R + 1)^2 column-range
// table of the block's row in shared memory. The two columns' costs of a
// disparity go out as one 8-byte pair where W is even: 4-byte stores
// (a warp's 128 bytes a store) ran the volume's writes at half the rate of
// 8-byte pairs (costs_variants --stores). R (0-7: the words, the masks'
// constants, which popcounts a word needs) and, for one channel, the
// direction (each cell's span slot a constant offset) are template
// arguments; several channels add their distances in registers first.
//
// ad_volume_kernel<R>: cost[d, y, x] = num / cnt, num the (2R + 1)^2 box
// sum of t[y', x'] = |x0[y', x'] - x1s[y', x']| * ok(x') (x1s = x1
// shifted by d * dir, 0 out of frame; ok whether x' + d * dir lies in
// frame) with zeros outside the frame, in the plain version's order: each
// row's horizontal sum from the leftmost tap to the rightmost, then the
// row sums from the top row to the bottom one, each add rounded
// (__fadd_rn). cnt, the box sum of ok, is a sum of 0/1 values and so the
// exact product of the in-frame rows and the in-frame, ok columns of the
// window. A block takes ATY = 32 rows x ATX = 128 columns and AND = 16
// disparities and stages, once, x0's tile with its halo of R (16-byte
// aligned rows) and x1's span (the tile's columns, the halo and AND - 1
// more; a column m at m + m / 32, so that the lanes' loads four columns
// apart hit distinct banks, and one zero slot). A warp (AW = 4 a block)
// takes a disparity at a time, a lane AX = 4 adjacent columns: for each
// of the ATY + 2R staged rows it loads its window of AX + 2R values of x0
// (16-byte loads) and of x1, forms the terms (a column off the frame
// reads x0's staged 0 and the zero slot, so its term is +0 whatever x1
// holds) and sums each column's row from registers; a ring of the last
// 2R + 1 row sums a column, in registers, gives each output row its
// column sum from the top. The rows run in groups of 2R + 1, each group
// unrolled (a ring slot is a constant): the 40-row unroll ran past the
// instruction cache at 15,040 instructions. The division is quotient():
// the product by the count's reciprocal and one FMA correction, equal to
// __fdiv_rn for every float (costs_variants --div-check), __fdiv_rn itself
// on a warp's rare branch. A row that starts on 16 bytes goes out as a
// 16-byte store a lane; otherwise (W even) through shared memory as two
// contiguous 256-byte stores of 8-byte pairs. The term stays a product by
// ok (NaN * 0 is NaN in the plain version); no running or prefix sum (it
// rounds otherwise).
//
// Bounds on the H100 at KITTI size (370 x 1226, D = 228): a volume is
// 413.7 MB written, 0.124 ms at 3.35 TB/s (one fill_ of it takes about
// 0.13 ms); the signatures of a pair at radius 4 are 14.5 MB written and
// 3.6 MB read (two 8-byte words a pixel), 0.0054 ms. Their blocks all fit
// on the card at once, so the pass compares (81 compares a pixel, each
// with its predicated OR) and then stores, the two one after the other
// (costs_variants' no-store and store-only split it). A census cell costs
// 3 NW + 3 integer instructions (and-not-xor, popcount and add a word; the
// subtract, the conversion, the multiply); an ad cell 20 f32 instructions
// (the term, its row sum's and its column sum's 8 adds at R = 4, the
// division): both under the bytes at the instruction rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 128;   // census volume: threads a block
constexpr int CX = 2;     // census volume: adjacent columns a thread
constexpr int CW = CT * CX;  // census volume: columns a block
constexpr int DCH = 32;   // census volume: disparities a block
constexpr int SPAN = CW + DCH - 1;  // census volume: match columns a block
constexpr int HALF = (SPAN + 1) / 2;  // census volume: entries a parity
constexpr int AX = 4;         // ad: adjacent columns a lane
constexpr int ATX = 32 * AX;  // ad: columns a block (a warp's width)
constexpr int ATY = 32;       // ad: rows a block
constexpr int AND = 16;       // ad: disparities a block
constexpr int AW = 4;         // ad: warps a block (disparity d0 + k to k % AW)
constexpr int SCY = 4;    // signature pass: rows a lane (one column)
constexpr int SWX = 1;    // signature pass: warps across a block
constexpr int SWY = 4;    // signature pass: warps down a block
constexpr int STX = 32 * SWX;  // signature pass: columns a block
constexpr int STY = SCY * SWY;  // signature pass: rows a block
constexpr int ST = 32 * SWX * SWY;  // signature pass: threads a block
constexpr unsigned NAN_BITS = 0x7fc00000u;

// The census window of radius R: N positions in NW 64-bit words; LAST_HI
// whether the last word's high half holds positions.
template <int R>
struct Win {
  static constexpr int WD = 2 * R + 1, N = WD * WD, NW = (N + 63) / 64;
  static constexpr bool LAST_HI = N - 64 * (NW - 1) > 32;
};

// NW words of a signature as 2 NW 32-bit halves (word w = h[2w] | h[2w + 1]
// << 32): 16-byte stores where NW is even, else 8-byte stores
template <int NW>
__device__ __forceinline__ void store_words(unsigned long long* o,
                                            const unsigned (&h)[2 * NW]) {
  if constexpr (NW % 2 == 0) {
#pragma unroll
    for (int w = 0; w < NW / 2; ++w)
      reinterpret_cast<uint4*>(o)[w] =
          make_uint4(h[4 * w], h[4 * w + 1], h[4 * w + 2], h[4 * w + 3]);
  } else {
#pragma unroll
    for (int w = 0; w < NW; ++w)
      reinterpret_cast<uint2*>(o)[w] = make_uint2(h[2 * w], h[2 * w + 1]);
  }
}

// x0, x1: (C, H, W); sig: (2, C, H, W, NW), plane blockIdx.z = image * C +
// channel. The tile's staged cells: rows by - R .. by + STY + R - 1, columns
// bx - R .. bx + STX + R - 1, NaN off the frame.
template <int R>
__global__ void __launch_bounds__(ST)
census_sig_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                  unsigned long long* __restrict__ sig, int C, int H, int W) {
  using V = Win<R>;
  constexpr int WD = V::WD, NW = V::NW;
  constexpr int PX = STX + 2 * R, PY = STY + 2 * R;
  __shared__ float tile[PY][PX];
  const int img = blockIdx.z;
  const int64_t plane = (int64_t)H * W;
  const float* const im =
      img < C ? x0 + img * plane : x1 + (img - C) * plane;
  const int bx = blockIdx.x * STX, by = blockIdx.y * STY;
  for (int i = threadIdx.x; i < PY * PX; i += ST) {
    const int r = i / PX, c = i - r * PX;
    const int yy = by - R + r, xx = bx - R + c;
    tile[r][c] = yy >= 0 && yy < H && xx >= 0 && xx < W
                     ? im[(int64_t)yy * W + xx]
                     : __uint_as_float(NAN_BITS);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cx = (warp % SWX) * 32 + lane;  // the lane's column in the tile
  const int cy = (warp / SWX) * SCY;        // its first row in the tile
  const int x = bx + cx;
  if (x >= W || by + cy >= H) return;
  float c[SCY];
#pragma unroll
  for (int k = 0; k < SCY; ++k) c[k] = tile[cy + k + R][cx + R];
  unsigned h[SCY][2 * NW];
#pragma unroll
  for (int k = 0; k < SCY; ++k)
#pragma unroll
    for (int w = 0; w < 2 * NW; ++w) h[k][w] = 0;
  // staged row cy + i is window row i - k of centre k
#pragma unroll
  for (int i = 0; i < SCY + 2 * R; ++i) {
    float v[WD];
#pragma unroll
    for (int dx = 0; dx < WD; ++dx) v[dx] = tile[cy + i][cx + dx];
#pragma unroll
    for (int k = 0; k < SCY; ++k) {
      const int wy = i - k;
      if (wy < 0 || wy >= WD) continue;
#pragma unroll
      for (int dx = 0; dx < WD; ++dx) {
        const int b = wy * WD + dx;  // the window position, a constant
        if (v[dx] < c[k]) h[k][b / 32] |= 1u << (b % 32);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < SCY; ++k) {
    const int y = by + cy + k;
    if (y >= H) break;
    store_words<NW>(sig + (img * plane + (int64_t)y * W + x) * NW, h[k]);
  }
}

template <int R>
int census_sig_r(const float* x0, const float* x1, unsigned long long* sig,
                 int C, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + STX - 1) / STX, (H + STY - 1) / STY, 2 * C);
  census_sig_kernel<R><<<grid, ST, 0, stream>>>(x0, x1, sig, C, H, W);
  return (int)cudaGetLastError();
}

// word j of the positions of window row dy, all 2R + 1 columns
template <int R>
__device__ __forceinline__ unsigned long long row_word(int dy, int j) {
  constexpr int WD = 2 * R + 1;
  const unsigned long long run = (1ull << WD) - 1;
  const int sh = (dy + R) * WD - 64 * j;
  return sh >= 0 && sh < 64 ? run << sh
         : sh < 0 && sh > -64 ? run >> -sh : 0ull;
}

// NW words of a signature in global memory, 16-byte loads where NW is
// even (the wrapper refuses signatures that are not 16-byte aligned then)
template <int NW>
__device__ __forceinline__ void load_words(const unsigned long long* p,
                                           unsigned long long (&v)[NW]) {
  if (NW % 2 == 0) {
#pragma unroll
    for (int w = 0; w < NW; w += 2) {
      const ulonglong2 t = reinterpret_cast<const ulonglong2*>(p)[w / 2];
      v[w] = t.x;
      v[w + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int w = 0; w < NW; ++w) v[w] = p[w];
  }
}

// Entry e of the staged span, at (e & 1) * HALF + e / 2 of each plane:
// NW / 2 planes of word pairs (NW even) or NW planes of words. A warp's
// reads of one column k and disparity, entries 2 lane + k + const, all
// of one parity, are 32 consecutive slots.
__device__ __forceinline__ int span_slot(int e) {
  return (e & 1) * HALF + (e >> 1);
}

template <int NW>
__device__ __forceinline__ void span_words(const unsigned long long* sp,
                                           int e,
                                           unsigned long long (&v)[NW]) {
  const int i = span_slot(e);
  if (NW % 2 == 0) {
#pragma unroll
    for (int w = 0; w < NW; w += 2) {
      const ulonglong2 t =
          reinterpret_cast<const ulonglong2*>(sp)[(w / 2) * 2 * HALF + i];
      v[w] = t.x;
      v[w + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int w = 0; w < NW; ++w) v[w] = sp[w * 2 * HALF + i];
  }
}

template <int NW>
__device__ __forceinline__ void span_put(unsigned long long* sp, int e,
                                         const unsigned long long (&v)[NW]) {
  const int i = span_slot(e);
  if (NW % 2 == 0) {
#pragma unroll
    for (int w = 0; w < NW; w += 2)
      reinterpret_cast<ulonglong2*>(sp)[(w / 2) * 2 * HALF + i] =
          make_ulonglong2(v[w], v[w + 1]);
  } else {
#pragma unroll
    for (int w = 0; w < NW; ++w) sp[w * 2 * HALF + i] = v[w];
  }
}

// the window positions that agree: popc(m & ~(s0 ^ s1)) over the words
// (one 32-bit count for a last word whose high half holds no position)
template <int R>
__device__ __forceinline__ int agreeing(
    const unsigned long long (&m)[Win<R>::NW],
    const unsigned long long (&s0)[Win<R>::NW],
    const unsigned long long (&s1)[Win<R>::NW]) {
  constexpr int NW = Win<R>::NW;
  int a = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const unsigned long long v = m[k] & ~(s0[k] ^ s1[k]);
    a += (k < NW - 1 || Win<R>::LAST_HI) ? __popcll(v) : __popc((unsigned)v);
  }
  return a;
}

// sig0, sig1: (C, H, W, NW) words of the reference image and of the
// image the match is taken in. win[(a, b)]: the block's row's window
// positions (dy, dx) with y + dy in frame and dx in [a - R, b], for a, b
// in [0, R], built once a block in shared memory; an edge cell reads the
// entry of its column range [max(-R, -x, -xm), min(R, W - 1 - x,
// W - 1 - xm)], an interior cell the rows-only mask rowm (the entry
// (0, R)). ONE (C = 1): the span staged once, each cell stored as soon
// as it is counted, and a block whose columns and match columns are all
// interior takes every cell's mask from rowm without a test; the
// direction is the template's DIR, so each cell's span slot is a
// constant offset. Otherwise (DIR 0, the direction dir_in) the
// distances of a thread's cells add up over the channels in registers,
// then the stores.
template <int R, bool ONE, int DIR>
__global__ void __launch_bounds__(CT)
census_volume_kernel(const unsigned long long* __restrict__ sig0,
                     const unsigned long long* __restrict__ sig1,
                     float* __restrict__ out, int C, int H, int W, int D,
                     int dir_in, float recip) {
  const int dir = DIR ? DIR : dir_in;
  using V = Win<R>;
  constexpr int NW = V::NW;
  __shared__ unsigned long long win[(R + 1) * (R + 1)][NW];
  __shared__ __align__(16) unsigned long long sp[NW * 2 * HALF];
  const int y = blockIdx.y;
  const int ylo = max(-R, -y), yhi = min(R, H - 1 - y);
  for (int i = threadIdx.x; i < (R + 1) * (R + 1) * NW; i += CT) {
    const int e = i / NW, j = i - e * NW;
    const int a = e / (R + 1) - R, b = e - (e / (R + 1)) * (R + 1);
    // a row's run of dx in [a, b], shifted to each row's first position
    const unsigned long long run = ((1ull << (b - a + 1)) - 1) << (a + R);
    unsigned long long m = 0;
    for (int dy = ylo; dy <= yhi; ++dy) {
      const int sh = (dy + R) * V::WD - 64 * j;
      if (sh >= 0 && sh < 64) m |= run << sh;
      else if (sh < 0 && sh > -64) m |= run >> -sh;
    }
    win[e][j] = m;
  }
  unsigned long long rowm[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) rowm[j] = 0;
#pragma unroll
  for (int dy = -R; dy <= R; ++dy)
    if (dy >= ylo && dy <= yhi) {
#pragma unroll
      for (int j = 0; j < NW; ++j) rowm[j] |= row_word<R>(dy, j);
    }
  const int x0 = blockIdx.x * CW + threadIdx.x * CX;  // the first column
  const int d0 = blockIdx.z * DCH;
  // the span's first column: the block's least match column
  const int xs = blockIdx.x * CW + (dir > 0 ? d0 : -(d0 + DCH - 1));
  // the span entry of column x0 + k at disparity d0 (+ j * dir at d0 + j)
  const int e0 = threadIdx.x * CX + (dir > 0 ? 0 : DCH - 1);
  const int64_t plane = (int64_t)H * W;
  bool xin[CX], xint[CX];
  int xlo0[CX], xhi0[CX];
#pragma unroll
  for (int k = 0; k < CX; ++k) {
    const int x = x0 + k;
    xin[k] = x < W;
    xint[k] = x >= R && x <= W - 1 - R;
    xlo0[k] = max(-R, -x);
    xhi0[k] = min(R, W - 1 - x);
  }
  // channel c's span, staged once
  auto stage = [&](int c) {
    const unsigned long long* row1 = sig1 + (c * plane + (int64_t)y * W) * NW;
    for (int e = threadIdx.x; e < SPAN; e += CT) {
      const int xm = xs + e;
      unsigned long long v[NW];
      if (xm >= 0 && xm < W) {
        load_words<NW>(row1 + (int64_t)xm * NW, v);
      } else {
#pragma unroll
        for (int w = 0; w < NW; ++w) v[w] = 0;
      }
      span_put<NW>(sp, e, v);
    }
  };
  auto reference = [&](int c, unsigned long long (&s0)[CX][NW]) {
    const unsigned long long* row0 = sig0 + (c * plane + (int64_t)y * W) * NW;
#pragma unroll
    for (int k = 0; k < CX; ++k)
      load_words<NW>(row0 + (int64_t)min(x0 + k, W - 1) * NW, s0[k]);
  };
  // the agreeing positions of cell (k, j), its mask tested
  auto cell = [&](int k, int j, const unsigned long long (&s0)[NW]) {
    const int xm = x0 + k + (d0 + j) * dir;
    unsigned long long s1[NW], m[NW];
    span_words<NW>(sp, e0 + k + j * dir, s1);
    if (xint[k] && xm >= R && xm <= W - 1 - R) {
#pragma unroll
      for (int w = 0; w < NW; ++w) m[w] = rowm[w];
    } else if (xin[k] && xm >= 0 && xm < W) {
      const int xlo = max(xlo0[k], -xm), xhi = min(xhi0[k], W - 1 - xm);
#pragma unroll
      for (int w = 0; w < NW; ++w) m[w] = win[(xlo + R) * (R + 1) + xhi][w];
    } else {
#pragma unroll
      for (int w = 0; w < NW; ++w) m[w] = 0;
    }
    return agreeing<R>(m, s0, s1);
  };
  float* const o = out + (int64_t)y * W + x0;
  // the costs of disparity d0 + j from C * n - agree
  auto put = [&](int j, const int (&agree)[CX]) {
    const int d = d0 + j;
    float v[CX];
#pragma unroll
    for (int k = 0; k < CX; ++k) {
      const int xm = x0 + k + d * dir;
      v[k] = xm >= 0 && xm < W
                 ? __fmul_rn((float)(C * V::N - agree[k]), recip)
                 : __uint_as_float(NAN_BITS);
    }
    // 8-byte pairs: x0 is even, and so is every row's start where W is
    if (CX == 2 && W % 2 == 0 && xin[CX - 1]) {
      *reinterpret_cast<float2*>(o + d * plane) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int k = 0; k < CX; ++k)
        if (xin[k]) o[d * plane + k] = v[k];
    }
  };
  if (ONE) {
    stage(0);
    __syncthreads();
    if (!xin[0]) return;
    unsigned long long s0[CX][NW];
    reference(0, s0);
    const int b0 = blockIdx.x * CW;
    if (b0 >= R && b0 + CW - 1 <= W - 1 - R && xs >= R &&
        xs + SPAN - 1 <= W - 1 - R) {
#pragma unroll
      for (int j = 0; j < DCH; ++j) {
        if (d0 + j >= D) break;
        int agree[CX];
#pragma unroll
        for (int k = 0; k < CX; ++k) {
          unsigned long long s1[NW];
          span_words<NW>(sp, e0 + k + j * dir, s1);
          agree[k] = agreeing<R>(rowm, s0[k], s1);
        }
        put(j, agree);
      }
    } else {
#pragma unroll
      for (int j = 0; j < DCH; ++j) {
        if (d0 + j >= D) break;
        int agree[CX];
#pragma unroll
        for (int k = 0; k < CX; ++k) agree[k] = cell(k, j, s0[k]);
        put(j, agree);
      }
    }
    return;
  }
  int agree[DCH][CX];
#pragma unroll
  for (int j = 0; j < DCH; ++j)
#pragma unroll
    for (int k = 0; k < CX; ++k) agree[j][k] = 0;
  for (int c = 0; c < C; ++c) {
    if (c) __syncthreads();
    stage(c);
    __syncthreads();
    if (!xin[0]) continue;
    unsigned long long s0[CX][NW];
    reference(c, s0);
#pragma unroll
    for (int j = 0; j < DCH; ++j) {
      if (d0 + j >= D) break;
#pragma unroll
      for (int k = 0; k < CX; ++k) agree[j][k] += cell(k, j, s0[k]);
    }
  }
  if (!xin[0]) return;
#pragma unroll
  for (int j = 0; j < DCH; ++j) {
    if (d0 + j >= D) break;
    put(j, agree[j]);
  }
}

template <int R>
int census_volume_r(const unsigned long long* s0,
                    const unsigned long long* s1, float* out, int C, int H,
                    int W, int D, int dir, float recip, cudaStream_t stream) {
  const dim3 grid((W + CW - 1) / CW, H, (D + DCH - 1) / DCH);
  if (C == 1 && dir > 0)
    census_volume_kernel<R, true, 1><<<grid, CT, 0, stream>>>(
        s0, s1, out, C, H, W, D, dir, recip);
  else if (C == 1)
    census_volume_kernel<R, true, -1><<<grid, CT, 0, stream>>>(
        s0, s1, out, C, H, W, D, dir, recip);
  else
    census_volume_kernel<R, false, 0><<<grid, CT, 0, stream>>>(
        s0, s1, out, C, H, W, D, dir, recip);
  return (int)cudaGetLastError();
}

// a / b rounded to nearest even (__fdiv_rn's bits) for b a window's count
// (an integer in [1, 225]) and y = RN(1 / b), where |a| >= b 2^-125 (not
// small()): the product a * y, then one correction by its residual,
// exact by FMA (Markstein); an infinite a keeps the product (the residual
// would be NaN). The small a (zeros, subnormals, quotients below 2^-125,
// where the residual is not exact) take __fdiv_rn itself, on a branch the
// whole warp takes only when one of its sums is that small: inline in
// every output, __fdiv_rn's call to its slow path held the registers of
// the whole kernel. quotient() is the kernel's composition of the two;
// costs_variants --div-check holds it to __fdiv_rn for every float a and
// every count.
__device__ __forceinline__ bool small(float a, float b) {
  return fabsf(a) < b * 0x1p-125f;
}

__device__ __forceinline__ float quotient_fast(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  const float c = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return isinf(a) ? q : c;
}

__device__ __forceinline__ float quotient(float a, float b, float y) {
  return small(a, b) ? __fdiv_rn(a, b) : quotient_fast(a, b, y);
}

// The ad block's shared memory: a row of ATX floats a warp (the stores'
// transpose), x0's tile, ROWS rows of P0 floats (a lane's window of NX
// columns in NV 16-byte loads), then x1's span, ROWS rows of P1 floats
// (SPAN1 columns, column m at m + m / 32, the zero slot Z last).
template <int R>
struct AdTile {
  static constexpr int ROWS = ATY + 2 * R;
  static constexpr int NX = AX + 2 * R;
  static constexpr int NV = (NX + 3) / 4;
  static constexpr int P0 = ATX - AX + 4 * NV;
  static constexpr int SPAN1 = ATX + 2 * R + AND - 1;
  static constexpr int Z = SPAN1 + SPAN1 / 32;
  static constexpr int P1 = Z + 1;
  static constexpr int SMEM = (AW * ATX + ROWS * (P0 + P1)) * 4;
};

template <int R>
__global__ void __launch_bounds__(32 * AW)
ad_volume_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                 float* __restrict__ out, int H, int W, int D, int dir) {
  using T = AdTile<R>;
  constexpr int WIN = 2 * R + 1;
  extern __shared__ __align__(16) float ad_smem[];
  // the reciprocals of the counts a window can have
  __shared__ float rcp[WIN * WIN + 1];
  for (int b = threadIdx.x + 1; b <= WIN * WIN; b += 32 * AW)
    rcp[b] = __frcp_rn((float)b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* const sw = ad_smem + warp * ATX;
  float* const t0 = ad_smem + AW * ATX;
  float* const t1 = t0 + T::ROWS * T::P0;
  const int xt = blockIdx.x * ATX, y0 = blockIdx.y * ATY;
  const int d0 = blockIdx.z * AND;
  // the chunk's least shift d * dir: x1's span starts there
  const int dmin = dir > 0 ? d0 : -(d0 + AND - 1);
  for (int i = warp; i < T::ROWS; i += AW) {
    const int yy = y0 - R + i;
    const bool yin = yy >= 0 && yy < H;
    const int64_t row = (int64_t)yy * W;
    for (int c = lane; c < T::P0; c += 32) {
      const int xx = xt - R + c;
      t0[i * T::P0 + c] = yin && xx >= 0 && xx < W ? x0[row + xx] : 0.f;
    }
    for (int m = lane; m <= T::SPAN1; m += 32) {
      const int xx = xt - R + dmin + m;
      t1[i * T::P1 + m + m / 32] =
          yin && m < T::SPAN1 && xx >= 0 && xx < W ? x1[row + xx] : 0.f;
    }
  }
  __syncthreads();
  const int xc = xt + lane * AX;  // the lane's first column
  for (int k = warp; k < AND; k += AW) {
    const int d = d0 + k;
    if (d >= D) break;
    const int delta = d * dir;
    // each window column's x1 slot (the zero slot off the frame) and ok
    int slot[T::NX];
    float ok[T::NX];
#pragma unroll
    for (int c = 0; c < T::NX; ++c) {
      const int xx = xc - R + c;
      const int m = lane * AX + c + delta - dmin;
      slot[c] = xx >= 0 && xx < W ? m + m / 32 : T::Z;
      ok[c] = xx + delta >= 0 && xx + delta < W ? 1.f : 0.f;
    }
    // each output column's in-frame, ok window columns; centre in frame;
    // the count and its reciprocal where all 2R + 1 rows are in frame
    int cols[AX];
    bool centre[AX];
    float full[AX], rfull[AX];
#pragma unroll
    for (int j = 0; j < AX; ++j) {
      const int x = xc + j;
      centre[j] = x < W && x + delta >= 0 && x + delta < W;
      const int lo = max(max(0, -delta), x - R);
      const int hi = min(min(W - 1, W - 1 - delta), x + R);
      cols[j] = centre[j] ? hi - lo + 1 : 1;
      full[j] = (float)(WIN * cols[j]);
      rfull[j] = rcp[WIN * cols[j]];
    }
    // the offset of output row y0 + i - 2R of disparity d
    int64_t off = ((int64_t)d * H + y0 - 2 * R) * W;
    // the staged rows in groups of WIN, each group unrolled: row i's sums
    // sit in ring slot i % WIN, a constant
    float ring[WIN][AX];
    for (int i0 = 0; i0 < T::ROWS; i0 += WIN) {
#pragma unroll
      for (int u = 0; u < WIN; ++u) {
        const int i = i0 + u;
        if (i >= T::ROWS) break;
        if (i) off += W;
        float a[4 * T::NV];
        const float4* a4 =
            reinterpret_cast<const float4*>(t0 + i * T::P0 + lane * AX);
#pragma unroll
        for (int v = 0; v < T::NV; ++v) {
          const float4 q = a4[v];
          a[4 * v] = q.x;
          a[4 * v + 1] = q.y;
          a[4 * v + 2] = q.z;
          a[4 * v + 3] = q.w;
        }
        const float* r1 = t1 + i * T::P1;
        float t[T::NX];
#pragma unroll
        for (int c = 0; c < T::NX; ++c)
          t[c] = __fmul_rn(fabsf(__fsub_rn(a[c], r1[slot[c]])), ok[c]);
#pragma unroll
        for (int j = 0; j < AX; ++j) {
          float s = t[j];
#pragma unroll
          for (int tap = 1; tap < WIN; ++tap) s = __fadd_rn(s, t[j + tap]);
          ring[u][j] = s;
        }
        const int yo = i - 2 * R;  // the output row in the tile
        if (yo < 0 || y0 + yo >= H) continue;
        const int y = y0 + yo;
        const int rows = min(H - 1, y + R) - max(0, y - R) + 1;
        float cnt[AX], rc[AX];
        if (rows == WIN) {
#pragma unroll
          for (int j = 0; j < AX; ++j) {
            cnt[j] = full[j];
            rc[j] = rfull[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < AX; ++j) {
            cnt[j] = (float)(rows * cols[j]);
            rc[j] = rcp[rows * cols[j]];
          }
        }
        float v[AX], num[AX];
        bool rare = false;
#pragma unroll
        for (int j = 0; j < AX; ++j) {
          // rows i - 2R .. i, from the top: slots (u + 1 + tap) % WIN
          float s = ring[(u + 1) % WIN][j];
#pragma unroll
          for (int tap = 1; tap < WIN; ++tap)
            s = __fadd_rn(s, ring[(u + 1 + tap) % WIN][j]);
          num[j] = s;
          const float q = quotient_fast(s, cnt[j], rc[j]);
          v[j] = centre[j] ? q : __uint_as_float(NAN_BITS);
          rare |= centre[j] && small(s, cnt[j]);
        }
        // the small quotients, a branch of the whole warp (never on images
        // whose sums stay above 2^-125 b)
        if (__any_sync(0xffffffffu, rare)) {
#pragma unroll
          for (int j = 0; j < AX; ++j)
            if (centre[j] && small(num[j], cnt[j]))
              v[j] = __fdiv_rn(num[j], cnt[j]);
        }
        // a row that starts on 16 bytes: a 16-byte store a lane; on 8
        // bytes (W even): the warp's row through shared memory, then two
        // 8-byte pairs a lane, each store a contiguous 256 bytes
        float* const orow = out + off;
        const int mod = (int)off & 3;
        if (mod == 0 && xc + AX <= W) {
#pragma unroll
          for (int j = 0; j < AX; j += 4)
            *reinterpret_cast<float4*>(orow + xc + j) =
                make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
        } else if (mod != 0 && W % 2 == 0) {
#pragma unroll
          for (int j = 0; j < AX; j += 4)
            *reinterpret_cast<float4*>(sw + lane * AX + j) =
                make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
          __syncwarp();
#pragma unroll
          for (int h = 0; h < AX / 2; ++h) {
            const int x = xt + h * 64 + 2 * lane;
            const float2 p =
                reinterpret_cast<const float2*>(sw)[h * 32 + lane];
            if (x + 1 < W) *reinterpret_cast<float2*>(orow + x) = p;
          }
          __syncwarp();
        } else {
#pragma unroll
          for (int j = 0; j < AX; ++j)
            if (xc + j < W) orow[xc + j] = v[j];
        }
      }
    }
  }
}

template <int R>
int ad_launch_r(const float* x0, const float* x1, float* out, int H, int W,
                int D, int dir, cudaStream_t stream) {
  using T = AdTile<R>;
  const cudaError_t err = cudaFuncSetAttribute(
      ad_volume_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + ATX - 1) / ATX, (H + ATY - 1) / ATY,
                  (D + AND - 1) / AND);
  ad_volume_kernel<R><<<grid, 32 * AW, T::SMEM, stream>>>(x0, x1, out, H, W,
                                                           D, dir);
  return (int)cudaGetLastError();
}

}  // namespace

// x0, x1: (C, H, W) float32; sig: (2, C, H, W, nw) 64-bit words, nw =
// ceil((2r + 1)^2 / 64): x0's signatures, then x1's. Returns
// cudaGetLastError() (cudaErrorInvalidValue for r outside [0, 7]).
extern "C" int census_signatures_launch(const float* x0, const float* x1,
                                        unsigned long long* sig, int C, int H,
                                        int W, int r, cudaStream_t stream) {
  switch (r) {
    case 0: return census_sig_r<0>(x0, x1, sig, C, H, W, stream);
    case 1: return census_sig_r<1>(x0, x1, sig, C, H, W, stream);
    case 2: return census_sig_r<2>(x0, x1, sig, C, H, W, stream);
    case 3: return census_sig_r<3>(x0, x1, sig, C, H, W, stream);
    case 4: return census_sig_r<4>(x0, x1, sig, C, H, W, stream);
    case 5: return census_sig_r<5>(x0, x1, sig, C, H, W, stream);
    case 6: return census_sig_r<6>(x0, x1, sig, C, H, W, stream);
    case 7: return census_sig_r<7>(x0, x1, sig, C, H, W, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// s0, s1: (C, H, W, nw) signatures of the reference image and of the
// match image, made by census_signatures_launch at the same r (r = 4 and
// r = 5 both have nw = 2: nothing here tells them apart); out: (D, H, W)
// float32; dir: -1 or +1; recip: the float32 reciprocal of C.
extern "C" int census_volume_launch(const unsigned long long* s0,
                                    const unsigned long long* s1, float* out,
                                    int C, int H, int W, int D, int dir,
                                    int r, float recip, cudaStream_t stream) {
  if (dir != -1 && dir != 1) return (int)cudaErrorInvalidValue;
  switch (r) {
    case 0: return census_volume_r<0>(s0, s1, out, C, H, W, D, dir, recip,
                                      stream);
    case 1: return census_volume_r<1>(s0, s1, out, C, H, W, D, dir, recip,
                                      stream);
    case 2: return census_volume_r<2>(s0, s1, out, C, H, W, D, dir, recip,
                                      stream);
    case 3: return census_volume_r<3>(s0, s1, out, C, H, W, D, dir, recip,
                                      stream);
    case 4: return census_volume_r<4>(s0, s1, out, C, H, W, D, dir, recip,
                                      stream);
    case 5: return census_volume_r<5>(s0, s1, out, C, H, W, D, dir, recip,
                                      stream);
    case 6: return census_volume_r<6>(s0, s1, out, C, H, W, D, dir, recip,
                                      stream);
    case 7: return census_volume_r<7>(s0, s1, out, C, H, W, D, dir, recip,
                                      stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x0, x1: (H, W) float32; out: (D, H, W) float32; dir: -1 or +1.
extern "C" int ad_volume_launch(const float* x0, const float* x1, float* out,
                                int H, int W, int D, int dir, int r,
                                cudaStream_t stream) {
  if (dir != -1 && dir != 1) return (int)cudaErrorInvalidValue;
  switch (r) {
    case 0: return ad_launch_r<0>(x0, x1, out, H, W, D, dir, stream);
    case 1: return ad_launch_r<1>(x0, x1, out, H, W, D, dir, stream);
    case 2: return ad_launch_r<2>(x0, x1, out, H, W, D, dir, stream);
    case 3: return ad_launch_r<3>(x0, x1, out, H, W, D, dir, stream);
    case 4: return ad_launch_r<4>(x0, x1, out, H, W, D, dir, stream);
    case 5: return ad_launch_r<5>(x0, x1, out, H, W, D, dir, stream);
    case 6: return ad_launch_r<6>(x0, x1, out, H, W, D, dir, stream);
    case 7: return ad_launch_r<7>(x0, x1, out, H, W, D, dir, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
