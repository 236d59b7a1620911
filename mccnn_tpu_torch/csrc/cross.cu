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
// cross_arms: each arm's walk, k = 2 .. K - 1, to the first in-frame probe
//   with |c - p| >= tau1 (the subtraction in round-to-nearest, the compare
//   against tau1 as the f32 torch compares with), the break capped at the
//   frame, the exclusive end stored as a float: exact. A NaN pixel or probe
//   never breaks (the compare is false). A probe past the frame may read
//   any value: it lies at or past the cap, and an in-frame break before it,
//   so the capped end is the same whether it breaks or not. Probes read
//   clamped addresses, and no compare tests the frame. A thread takes
//   AX = 2 adjacent columns (from an even one) of AY rows; a block 32 x 4
//   threads, 64 columns x 4 AY rows. The probes come from register
//   windows loaded before any compare (window_breaks): the rows the -y and
//   +y probes read of the thread's two columns, and for each of its rows
//   the columns its -x and +x probes read, one 8-byte load a pair where W
//   is even. A probe's compare sets its bit of the arm's mask (subtract,
//   compare, a predicated OR); the break is the lowest bit (__ffs). The
//   first windows hold k = 2 .. NP + 1, NP = min(K - 2, NPMAX): the whole
//   arm where K <= NPMAX + 2. A warp with an arm that runs on past them
//   (rare on a textured image, where most arms break at their first
//   probe) takes k up to KWIN - 1 (every K of config.py) from second
//   windows, and walk_from goes past those, AP probes loaded before their
//   compares, to the cap. NP, and whether the second windows exist, are
//   template arguments: windows sized at run time issued their unused
//   loads and compares all the same (predicated off), and arms that
//   walked past the first windows one call a lane left the loads of a
//   thread's arms in turn (on an H100 80GB HBM3 at 700 W a smooth image
//   took 1.7x the thread-a-pixel kernel's time). Each direction's ends
//   are stored as soon as they are known, 8 bytes a plane a row where W
//   is even, 4 elsewhere (held to one store pass at the end, K = 5 took
//   1.2x as long). This replaces a thread a pixel that walked each arm a
//   probe at a time, each load waiting on the compare before it. Bound:
//   bytes, the image read and four planes written (20 H W bytes). What
//   holds it: the launch and the planes' stores (K = 2 runs no probe);
//   above that three instructions a probe of the windows, for all 4 AX AY
//   arms of a thread at each of their steps.

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

constexpr int AX = 2;              // cross_arms: columns a thread
constexpr int AY = 2;              // rows a thread
constexpr int ANX = 32, ANY = 4;   // threads a block: across, down
constexpr int NPMAX = 3;           // probes an arm from the first windows
constexpr int KWIN = 14;           // the second windows' probes end at KWIN - 1
constexpr int AP = 8;              // probes a chunk of the walk past them

// columns x, x + 1 (x even) of a row, each clamped into [0, W): one 8-byte
// load where W is even (the pair then lies in the frame or past it whole)
template <bool VEC>
__device__ __forceinline__ float2 pair_at(const float* __restrict__ row,
                                          int x, int W) {
  if (VEC)
    return __ldg(reinterpret_cast<const float2*>(row + min(max(x, 0), W - 2)));
  return make_float2(__ldg(row + min(max(x, 0), W - 1)),
                     __ldg(row + min(max(x + 1, 0), W - 1)));
}

template <bool VEC>
__device__ __forceinline__ void pair_store(float* __restrict__ row, int x,
                                           int W, float a, float b) {
  if (VEC) {
    *reinterpret_cast<float2*>(row + x) = make_float2(a, b);
  } else {
    row[x] = a;
    if (x + 1 < W) row[x + 1] = b;
  }
}

// the first probe k0 <= k < kend of an arm with |c - p| >= tau1, or kend
// where none is: p = base[q * step] at q = coord + sign * k clamped into
// [0, n); AP probes loaded before their compares
__device__ __noinline__ int walk_from(const float* __restrict__ base,
                                      int step, int coord, int sign, int n,
                                      int k0, int kend, float c, float tau1) {
  for (; k0 < kend; k0 += AP) {
    float t[AP];
#pragma unroll
    for (int i = 0; i < AP; ++i)
      t[i] = __ldg(base + (size_t)min(max(coord + sign * (k0 + i), 0), n - 1)
                              * step);
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < AP; ++i)
      if (k0 + i < kend && fabsf(__fsub_rn(c, t[i])) >= tau1) m |= 1u << i;
    if (m) return k0 + __ffs(m) - 1;
  }
  return kend;
}

// The arms of direction D (-x, +x, -y, +y) of a thread's pixels: kb[r][j]
// of the pixel at row y0 + r, column x0 + j, the first probe that breaks,
// 0 while none has. The breaks among the probes k = K0 .. K0 + N - 1
// (k < K) of the arms without one yet, from a register window loaded
// before any compare: the rows of the thread's two columns that the -y
// (+y) probes read, or for each row the columns that its -x (+x) probes
// read, in pairs.
template <bool VEC, int D, int K0, int N>
__device__ __forceinline__ void window_breaks(
    const float* __restrict__ img, int H, int W, int x0, int y0, int K,
    float tau1, const float (&c)[AY][AX], int (&kb)[AY][AX]) {
  constexpr int F = K0 + N - 1;          // the farthest probe
  constexpr int S = D % 2 ? 1 : -1;      // the probes' side
  // the bits of the probes k < K
  const unsigned lim = K - K0 >= N ? ~0u : (1u << max(K - K0, 0)) - 1u;
  unsigned m[AY][AX];
  if constexpr (D >= 2) {
    // rows y0 + V0 + v, v < NV: -y probes read offsets -F .. AY - 1 - K0,
    // +y probes K0 .. AY - 1 + F
    constexpr int NV = AY + N - 1;
    constexpr int V0 = S < 0 ? -F : K0;  // the window's first row offset
    float2 vw[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v)
      vw[v] = pair_at<VEC>(
          img + (size_t)min(max(y0 + V0 + v, 0), H - 1) * W, x0, W);
#pragma unroll
    for (int r = 0; r < AY; ++r)
#pragma unroll
      for (int j = 0; j < AX; ++j) {
        m[r][j] = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float2 q = vw[r + S * (K0 + i) - V0];
          if (fabsf(__fsub_rn(c[r][j], j ? q.y : q.x)) >= tau1)
            m[r][j] |= 1u << i;
        }
      }
  } else {
    // pairs at column offsets P0 + 2 q: -x probes read -F .. 1 - K0, +x
    // probes K0 .. 1 + F
    constexpr int P0 = S < 0 ? -((F + 1) & ~1) : K0 & ~1;
    constexpr int NQ = (S < 0 ? 1 - K0 - P0 : 1 + F - P0) / 2 + 1;
#pragma unroll
    for (int r = 0; r < AY; ++r) {
      const float* row = img + (size_t)min(y0 + r, H - 1) * W;
      float2 hw[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        hw[q] = pair_at<VEC>(row, x0 + P0 + 2 * q, W);
#pragma unroll
      for (int j = 0; j < AX; ++j) {
        m[r][j] = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int o = j + S * (K0 + i) - P0;  // its column in the window
          const float t = o & 1 ? hw[o >> 1].y : hw[o >> 1].x;
          if (fabsf(__fsub_rn(c[r][j], t)) >= tau1) m[r][j] |= 1u << i;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < AY; ++r)
#pragma unroll
    for (int j = 0; j < AX; ++j) {
      const unsigned b = m[r][j] & lim;
      if (!kb[r][j] && b) kb[r][j] = K0 - 1 + __ffs(b);
    }
}

// The ends of direction D of a thread's arms, stored: the first windows'
// probes; where K runs past them (MORE) and a lane of the warp has an arm
// without a break whose cap lies past them, the second windows' up to
// KWIN - 1; walk_from past those; the break (K where none is) capped at
// the frame.
template <bool VEC, int NP, bool MORE, int D>
__device__ __forceinline__ void arms_of(
    const float* __restrict__ img, float* __restrict__ arms, int H, int W,
    int x0, int y0, int K, float tau1, const float (&c)[AY][AX]) {
  int kb[AY][AX];
  auto cap = [&](int r, int j) {
    const int x = x0 + j, y = y0 + r;
    return D == 0 ? x + 1 : D == 1 ? W - x : D == 2 ? y + 1 : H - y;
  };
  auto inside = [&](int r, int j) {
    return y0 + r < H && (VEC || x0 + j < W);
  };
#pragma unroll
  for (int r = 0; r < AY; ++r)
#pragma unroll
    for (int j = 0; j < AX; ++j) kb[r][j] = 0;
  if constexpr (NP > 0)
    window_breaks<VEC, D, 2, NP>(img, H, W, x0, y0, K, tau1, c, kb);
  if constexpr (MORE) {
    constexpr int K1 = NP + 2, K2 = KWIN > K1 ? KWIN : K1;
    if constexpr (KWIN > K1) {
      bool more = false;
#pragma unroll
      for (int r = 0; r < AY; ++r)
#pragma unroll
        for (int j = 0; j < AX; ++j)
          more |= inside(r, j) && !kb[r][j] && min(K, cap(r, j)) > K1;
      if (__any_sync(__activemask(), more))
        window_breaks<VEC, D, K1, KWIN - K1>(img, H, W, x0, y0, K, tau1, c,
                                             kb);
    }
    if (K > K2) {
#pragma unroll
      for (int r = 0; r < AY; ++r)
#pragma unroll
        for (int j = 0; j < AX; ++j) {
          const int kend = min(K, cap(r, j)), x = x0 + j, y = y0 + r;
          if (inside(r, j) && !kb[r][j] && kend > K2)
            kb[r][j] = D < 2 ? walk_from(img + (size_t)y * W, 1, x,
                                         D ? 1 : -1, W, K2, kend, c[r][j],
                                         tau1)
                             : walk_from(img + x, W, y, D == 3 ? 1 : -1, H,
                                         K2, kend, c[r][j], tau1);
        }
    }
  }
  float* plane = arms + D * (size_t)H * W;
#pragma unroll
  for (int r = 0; r < AY; ++r) {
    const int y = y0 + r;
    if (y >= H) break;
    float e[AX];
#pragma unroll
    for (int j = 0; j < AX; ++j) {
      const int k = min(kb[r][j] ? kb[r][j] : K, cap(r, j));
      e[j] = (float)(D == 0 ? x0 + j - k : D == 1 ? x0 + j + k
                     : D == 2 ? y - k : y + k);
    }
    pair_store<VEC>(plane + (size_t)y * W, x0, W, e[0], e[1]);
  }
}

// img: (H, W); arms: (4, H, W): [0] -x, [1] +x (column ends), [2] -y,
// [3] +y (row ends). VEC: W even, img and arms 8-byte aligned. NP:
// min(K - 2, NPMAX), the probes an arm from the first windows; MORE:
// K > NP + 2, the arms may run past them.
template <bool VEC, int NP, bool MORE>
__global__ void __launch_bounds__(ANX * ANY)
cross_arms_kernel(const float* __restrict__ img, float* __restrict__ arms,
                  int H, int W, int K, float tau1) {
  const int x0 = (blockIdx.x * ANX + threadIdx.x % ANX) * AX;
  const int y0 = (blockIdx.y * ANY + threadIdx.x / ANX) * AY;
  if (x0 >= W || y0 >= H) return;
  float c[AY][AX];
#pragma unroll
  for (int r = 0; r < AY; ++r) {
    const float2 p =
        pair_at<VEC>(img + (size_t)min(y0 + r, H - 1) * W, x0, W);
    c[r][0] = p.x;
    c[r][1] = p.y;
  }
  arms_of<VEC, NP, MORE, 0>(img, arms, H, W, x0, y0, K, tau1, c);
  arms_of<VEC, NP, MORE, 1>(img, arms, H, W, x0, y0, K, tau1, c);
  arms_of<VEC, NP, MORE, 2>(img, arms, H, W, x0, y0, K, tau1, c);
  arms_of<VEC, NP, MORE, 3>(img, arms, H, W, x0, y0, K, tau1, c);
}

// the kernel instance of NP = np (<= NPMAX) probes an arm from the first
// windows
template <bool VEC, int NP = 0>
void arms_run(const float* img, float* arms, int H, int W, int K, float tau1,
              int np, cudaStream_t stream) {
  if constexpr (NP < NPMAX) {
    if (np > NP)
      return arms_run<VEC, NP + 1>(img, arms, H, W, K, tau1, np, stream);
  }
  const dim3 grid((W + ANX * AX - 1) / (ANX * AX),
                  (H + ANY * AY - 1) / (ANY * AY));
  if constexpr (NP == NPMAX) {
    if (K > NP + 2) {
      cross_arms_kernel<VEC, NP, true><<<grid, ANX * ANY, 0, stream>>>(
          img, arms, H, W, K, tau1);
      return;
    }
  }
  cross_arms_kernel<VEC, NP, false><<<grid, ANX * ANY, 0, stream>>>(
      img, arms, H, W, K, tau1);
}

bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

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
  if (K < 2) return (int)cudaErrorInvalidValue;
  const int np = min(K - 2, NPMAX);
  if (W % 2 == 0 && aligned8(img) && aligned8(arms))
    arms_run<true>(img, arms, H, W, K, tau1, np, stream);
  else
    arms_run<false>(img, arms, H, W, K, tau1, np, stream);
  return (int)cudaGetLastError();
}
