// The main path's refinement chain: occlusion fill, mismatch fill, the
// subpixel parabola and the 5x5 median.
//
// The JAX package leaves these stages to XLA, which fuses each into one
// elementwise kernel on the TPU (mccnn_tpu/ops/post.py: interpolate_occlusion
// :68, interpolate_mismatch :122, subpixel_enhancement :215 and
// subpixel_enhancement_hwd :378, median2d :270). Eager PyTorch runs them as
// ~4,700 small launches a KITTI pair (ops/post.py's plain versions); these
// four kernels take their place, one launch a stage. Each selects, copies or
// compares values and accumulates nothing, so each is bit-identical to its
// plain version (ops/post.py, the *_plain functions):
//
// occlusion_fill: a block a row. The row's values and a byte of kind a column
//   in shared memory; each thread finds the last and first MATCH of its chunk
//   of columns, a block scan carries the last match from the left, and an
//   OCCLUSION pixel takes the value of the last match at or left of it, else
//   of the row's first match (there is then none left of it), else keeps its
//   own. O(W) a row whatever the labels. Pixels change only where the label
//   is OCCLUSION and are read only where it is MATCH, so the row is filled in
//   place. Bound: 12 bytes a pixel (both maps read, one written).
//
// mismatch_fill: a MISMATCH pixel walks each of the 16 rays (dx, dy) of
//   _RAY_DIRS: probe t = 1, 2, ... at (y + floor(t dy + 0.5),
//   x + floor(t dx + 0.5)). A probe out of frame lands empty, and so does one
//   of an odd t on row (column) 0 of a ray whose dy (dx) is -0.5: its true
//   coordinate is -0.5. A probe that is not MISMATCH lands with d0 there;
//   a MISMATCH probe walks on. Every ray has a component of +-1, so it leaves
//   the frame within max(H, W) steps: the plain version's pointer-doubling
//   rounds cover more, so both land on the same probes. The cnt landed values
//   give sorted[cnt / 2] through the plain version's selection network
//   (_median_network(16, 8): the invalid rays +-inf by rank), d0 if cnt is 0.
//   A probe's address does not depend on what an earlier probe loaded: only
//   where the walk stops does. So the probes of a ray go out together and
//   the first stop event among them decides. The first empty step t0 of a
//   ray is closed-form (first_out), so a probe is in frame iff t < t0.
//   A block takes a 32 x 8 tile: its pixels that are not MISMATCH copy d0,
//   its MISMATCH pixels are counted by ballots. A sparse tile (at most DENSE
//   of them) lists them in shared memory and its warps take one pixel each
//   in turn: in a round the rays still open share the 32 lanes (L = 32 / m
//   lanes for each of m rays), lane h of a ray probes t = base + h + L i for
//   i < P, all P loads issued before any compare; a ray's earliest event over
//   its lanes (a shared-memory atomicMin) closes it, the open ones go on at
//   base + L P. The landed d0 values load together and reach every lane by
//   shuffles. A dense tile walks a thread a pixel (neighbouring lanes probe
//   neighbouring addresses): each ray in chunks of Q probes in flight, the
//   16 landed values loaded together at the end. The work depends on the
//   data: a ray costs a load a probe. Bound: 12 bytes a pixel, or the probes
//   of the run's map at the instruction rate.
//
// subpixel: a thread a pixel; the three samples at d - 1, d, d + 1 read
//   through the volume's strides (the HWD lane's x-reversed (H, Wp, Dp), the
//   generic lane's (D, H, W) as its (H, W, D) view), f32, bf16 or f16 widened
//   to f32; the parabola with round-to-nearest intrinsics, so that no
//   contraction into an FMA moves a rounding (2 * (cp + cn - 2 * cz) as torch
//   computes it, an IEEE division, a clamp that keeps NaN). Bound: the map
//   read and written and three samples a pixel (20 bytes in f32). What holds
//   it on the HWD lane is the gather's fetches: each pixel's samples lie in a
//   column of their own (1 KB apart in f32), so each pixel costs a random
//   DRAM access whatever the kernel issues. One sample a pixel takes as long
//   as three, and a 16-byte vector read of the samples, with one to four
//   pixels a thread, was no faster (PERF.md).
//
// median5: blocks of 32 x 8 outputs from a shared-memory tile with a 2-pixel
//   halo; each output's 25 taps in dx-outer order, the out-of-frame ones
//   filled -inf for the first 12 - cnt / 2 of them and +inf for the rest, then
//   the plain version's pruned network (_median_network(25, 12), 113
//   comparators) on torch.minimum / torch.maximum semantics: a NaN operand
//   (the first, if both are) is both results. A window without NaN takes
//   plain fminf / fmaxf. Bound: 226 min/max a pixel at the instruction rate
//   (3.1 us at KITTI size) above its 8 bytes a pixel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr float MATCH = 0.f, OCCLUSION = 1.f, MISMATCH = 2.f;
constexpr int NT = 256;            // threads a block
constexpr int TX = 32, TY = 8;     // a block's outputs: 32 columns x 8 rows

// the scans' two ints a thread, the row's values and a byte of kind a column
__host__ __device__ constexpr int occlusion_smem_bytes(int W) {
  return 2 * NT * 4 + 5 * W;
}

// _median_network(16, 8) of ops/post.py: 53 comparators
#define MEDIAN16_NET(C) \
  C(0, 1) C(2, 3) C(4, 5) C(6, 7) C(8, 9) C(10, 11) C(12, 13) C(14, 15) \
  C(0, 2) C(1, 3) C(4, 6) C(5, 7) C(8, 10) C(9, 11) C(12, 14) C(13, 15) \
  C(1, 2) C(5, 6) C(9, 10) C(13, 14) C(0, 4) C(1, 5) C(2, 6) C(3, 7) \
  C(8, 12) C(9, 13) C(10, 14) C(11, 15) C(2, 4) C(3, 5) C(10, 12) C(11, 13) \
  C(1, 2) C(3, 4) C(5, 6) C(9, 10) C(11, 12) C(13, 14) C(0, 8) C(1, 9) \
  C(2, 10) C(3, 11) C(4, 12) C(5, 13) C(6, 14) C(7, 15) C(4, 8) C(5, 9) \
  C(6, 10) C(7, 11) C(6, 8) C(7, 9) C(7, 8)

// _median_network(25, 12) of ops/post.py: 113 comparators
#define MEDIAN25_NET(C) \
  C(0, 1) C(2, 3) C(4, 5) C(6, 7) C(8, 9) C(10, 11) C(12, 13) C(14, 15) \
  C(16, 17) C(18, 19) C(20, 21) C(22, 23) C(0, 2) C(1, 3) C(4, 6) C(5, 7) \
  C(8, 10) C(9, 11) C(12, 14) C(13, 15) C(16, 18) C(17, 19) C(20, 22) \
  C(21, 23) C(1, 2) C(5, 6) C(9, 10) C(13, 14) C(17, 18) C(21, 22) C(0, 4) \
  C(1, 5) C(2, 6) C(3, 7) C(8, 12) C(9, 13) C(10, 14) C(11, 15) C(16, 20) \
  C(17, 21) C(18, 22) C(19, 23) C(2, 4) C(3, 5) C(10, 12) C(11, 13) \
  C(18, 20) C(19, 21) C(1, 2) C(3, 4) C(5, 6) C(9, 10) C(11, 12) C(13, 14) \
  C(17, 18) C(19, 20) C(21, 22) C(0, 8) C(1, 9) C(2, 10) C(3, 11) C(4, 12) \
  C(5, 13) C(6, 14) C(7, 15) C(16, 24) C(4, 8) C(5, 9) C(6, 10) C(7, 11) \
  C(20, 24) C(2, 4) C(3, 5) C(6, 8) C(7, 9) C(10, 12) C(11, 13) C(18, 20) \
  C(19, 21) C(22, 24) C(1, 2) C(3, 4) C(5, 6) C(7, 8) C(9, 10) C(11, 12) \
  C(13, 14) C(17, 18) C(19, 20) C(21, 22) C(23, 24) C(0, 16) C(1, 17) \
  C(2, 18) C(3, 19) C(4, 20) C(5, 21) C(6, 22) C(7, 23) C(8, 24) C(8, 16) \
  C(9, 17) C(10, 18) C(11, 19) C(12, 20) C(13, 21) C(6, 10) C(7, 11) \
  C(12, 16) C(13, 17) C(10, 12) C(11, 13) C(11, 12)

// The 16 rays of ops/post.py _RAY_DIRS, (dx, dy) as twice their value.
#define RAYS(R) \
  R(0, 0, 2) R(1, -1, 2) R(2, -2, 2) R(3, -2, 1) R(4, -2, 0) R(5, -2, -1) \
  R(6, -2, -2) R(7, -1, -2) R(8, 0, -2) R(9, 1, -2) R(10, 2, -2) \
  R(11, 2, -1) R(12, 2, 0) R(13, 2, 1) R(14, 2, 2) R(15, 1, 2)

// One comparator: (a, b) <- (torch.minimum(a, b), torch.maximum(a, b)).
// With NANS false the caller knows neither operand is NaN.
template <bool NANS>
__device__ __forceinline__ void order(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  if (NANS) {
    const bool an = a != a, any = an || b != b;
    const float n = an ? a : b;
    a = any ? n : lo;
    b = any ? n : hi;
  } else {
    a = lo;
    b = hi;
  }
}

template <bool NANS>
__device__ __forceinline__ float select_mid16(float (&v)[16]) {
#define CMP(i, j) order<NANS>(v[i], v[j]);
  MEDIAN16_NET(CMP)
#undef CMP
  return v[8];
}

template <bool NANS>
__device__ __forceinline__ float select_mid25(float (&v)[25]) {
#define CMP(i, j) order<NANS>(v[i], v[j]);
  MEDIAN25_NET(CMP)
#undef CMP
  return v[12];
}

// floor(t * C2 / 2 + 0.5) for a ray component C2 / 2 in {-1, -0.5, 0, 0.5, 1}
template <int C2>
__device__ __forceinline__ int ray_step(int t) {
  return C2 == 2 ? t : C2 == -2 ? -t : C2 == 1 ? (t + 1) >> 1
         : C2 == -1 ? -(t >> 1) : 0;
}

// The first step t >= 1 at which a ray component C2 / 2 of a walk from pos
// leaves [0, N), or is the -0.5 rule's odd step on 0 (C2 = -1: t = 2 pos + 1,
// whose coordinate floor(-t / 2 + 0.5) + pos is 0); no limit for 0.
__device__ __forceinline__ int first_out(int c2, int pos, int N) {
  return c2 == 2 ? N - pos : c2 == -2 ? pos + 1
         : c2 == 1 ? 2 * (N - 1 - pos) + 1 : c2 == -1 ? 2 * pos + 1
         : INT_MAX;
}

// The rays' components packed 3 bits a ray, C2 + 2, for a run-time ray index.
#define RAY_DX2(k, dx2, dy2) | (unsigned long long)((dx2) + 2) << (3 * (k))
#define RAY_DY2(k, dx2, dy2) | (unsigned long long)((dy2) + 2) << (3 * (k))
constexpr unsigned long long RAYS_DX2 = 0ull RAYS(RAY_DX2);
constexpr unsigned long long RAYS_DY2 = 0ull RAYS(RAY_DY2);
#undef RAY_DX2
#undef RAY_DY2

__device__ __forceinline__ int ray_c2(unsigned long long packed, int r) {
  return (int)((packed >> (3 * r)) & 7) - 2;
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int NW = NT / 32;   // warps a block
constexpr int DENSE = 64;     // a tile with more MISMATCH pixels walks a
                              // thread a pixel
constexpr int P = 8;          // a sparse walk's probes a lane a round
constexpr int Q = 8;          // a dense walk's probes of a ray in flight

// sorted(landed)[cnt / 2] of the 16 rays, v[k] the value ray k landed on
// where bit k of `has` is set; v0 if none landed.
__device__ __forceinline__ float median_of_rays(float (&v)[16], unsigned has,
                                                float v0) {
  const int cnt = __popc(has);
  if (cnt == 0) return v0;
  const int a = 8 - cnt / 2;  // the rays that land empty filled -inf first
  int rank = 0;
  bool nans = false;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (!((has >> k) & 1)) v[k] = rank++ < a ? -CUDART_INF_F : CUDART_INF_F;
    nans |= v[k] != v[k];
  }
  return nans ? select_mid16<true>(v) : select_mid16<false>(v);
}

// A dense tile's walk of one ray from (y, x): the index of the probe it
// lands on, -1 if it lands empty. Chunks of Q probes start at odd t (Q is
// even), so a probe's offset from its chunk's first is a constant.
template <int DX2, int DY2>
__device__ __forceinline__ int walk_chunks(const float* __restrict__ lab,
                                           int y, int x, int H, int W) {
  static_assert(Q % 2 == 0, "chunks start at odd t");
  const int t0 = min(first_out(DX2, x, W), first_out(DY2, y, H));
  const int dj = (ray_step<DY2>(1 + Q) - ray_step<DY2>(1)) * W
                 + ray_step<DX2>(1 + Q) - ray_step<DX2>(1);
  int j = (y + ray_step<DY2>(1)) * W + x + ray_step<DX2>(1);
  for (int t = 1; t < t0; t += Q, j += dj) {
    float l[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int o = (ray_step<DY2>(1 + i) - ray_step<DY2>(1)) * W
                    + ray_step<DX2>(1 + i) - ray_step<DX2>(1);
      l[i] = t + i < t0 ? lab[j + o] : MISMATCH;
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int o = (ray_step<DY2>(1 + i) - ray_step<DY2>(1)) * W
                    + ray_step<DX2>(1 + i) - ray_step<DX2>(1);
      if (l[i] != MISMATCH) return j + o;
    }
  }
  return -1;
}

// A sparse tile's walk of the MISMATCH pixel (y, x) by one warp (every lane
// calls it); stop, next and land: the warp's 16 ints each in shared memory.
__device__ __forceinline__ void walk_warp(const float* __restrict__ d0,
                                          const float* __restrict__ lab,
                                          float* __restrict__ out, int y,
                                          int x, int H, int W, int* stop,
                                          int* next, int* land) {
  const int lane = threadIdx.x & 31;
  if (lane < 16) {
    stop[lane] = INT_MAX;
    next[lane] = 1;
    land[lane] = -1;
  }
  __syncwarp();
  unsigned open = 0xffffu;  // the rays with no event yet
  while (open) {
    const int m = __popc(open), L = 32 / m;
    int r = 0, ev = INT_MAX, jv = -1;
    if (lane < m * L) {
      r = __fns(open, 0, lane % m + 1);
      const int cx = ray_c2(RAYS_DX2, r), cy = ray_c2(RAYS_DY2, r);
      const int t0 = min(first_out(cx, x, W), first_out(cy, y, H));
      const int tb = next[r] + lane / m;
      float l[P];
      int j[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int t = tb + L * i;
        j[i] = (y + ((t * cy + 1) >> 1)) * W + x + ((t * cx + 1) >> 1);
        l[i] = t < t0 ? lab[j[i]] : MISMATCH;
      }
      // the lane's earliest event: out of frame or excluded (empty), or a
      // probe that is not MISMATCH (landed)
#pragma unroll
      for (int i = P - 1; i >= 0; --i) {
        const int t = tb + L * i;
        if (t >= t0 || l[i] != MISMATCH) {
          ev = t;
          jv = t < t0 ? j[i] : -1;
        }
      }
      if (ev != INT_MAX) atomicMin(&stop[r], ev);
    }
    __syncwarp();
    if (ev != INT_MAX && stop[r] == ev) land[r] = jv;  // the ray's owner
    __syncwarp();
    const bool still = lane < 16 && stop[lane] == INT_MAX;
    if (still) next[lane] += L * P;
    open = __ballot_sync(FULL, still);
    __syncwarp();
  }
  float v = 0.f;
  bool has = false;
  if (lane < 16) {
    const int j = land[lane];
    has = j >= 0;
    if (has) v = d0[j];
  }
  const unsigned hm = __ballot_sync(FULL, has);
  float vals[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) vals[k] = __shfl_sync(FULL, v, k);
  const size_t i = (size_t)y * W + x;
  if (lane == 0) out[i] = median_of_rays(vals, hm, d0[i]);
  __syncwarp();
}

__global__ void __launch_bounds__(NT)
mismatch_fill_kernel(const float* __restrict__ d0,
                     const float* __restrict__ lab, float* __restrict__ out,
                     int H, int W) {
  __shared__ int count[NW];
  __shared__ short list[NT];
  __shared__ int stop[NW][16], next[NW][16], land[NW][16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * TX + threadIdx.x % TX;
  const int y = blockIdx.y * TY + threadIdx.x / TX;
  const size_t i = (size_t)y * W + x;
  bool mm = false;
  float v0 = 0.f;
  if (x < W && y < H) {
    v0 = d0[i];
    mm = lab[i] == MISMATCH;
    if (!mm) out[i] = v0;
  }
  const unsigned b = __ballot_sync(FULL, mm);
  if (lane == 0) count[warp] = __popc(b);
  __syncthreads();
  int n = 0, at = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    at += w < warp ? count[w] : 0;
    n += count[w];
  }
  if (n == 0) return;
  if (n > DENSE) {
    if (!mm) return;
    int js[16];
#define RAY(k, dx2, dy2) js[k] = walk_chunks<dx2, dy2>(lab, y, x, H, W);
    RAYS(RAY)
#undef RAY
    float v[16];
    unsigned has = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v[k] = js[k] >= 0 ? d0[js[k]] : 0.f;
      has |= (unsigned)(js[k] >= 0) << k;
    }
    out[i] = median_of_rays(v, has, v0);
    return;
  }
  if (mm) list[at + __popc(b & ((1u << lane) - 1))] = (short)threadIdx.x;
  __syncthreads();
  for (int k = warp; k < n; k += NW) {
    const int t = list[k];
    walk_warp(d0, lab, out, blockIdx.y * TY + t / TX, blockIdx.x * TX + t % TX,
              H, W, stop[warp], next[warp], land[warp]);
  }
}

__global__ void __launch_bounds__(NT)
median5_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
               int W) {
  __shared__ float tile[TY + 4][TX + 4];
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  for (int k = threadIdx.x; k < (TY + 4) * (TX + 4); k += NT) {
    const int ty = k / (TX + 4), tx = k % (TX + 4);
    const int gy = y0 + ty - 2, gx = x0 + tx - 2;
    tile[ty][tx] = gy >= 0 && gy < H && gx >= 0 && gx < W
                       ? img[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();
  const int lx = threadIdx.x % TX, ly = threadIdx.x / TX;
  const int x = x0 + lx, y = y0 + ly;
  if (x >= W || y >= H) return;
  const int cnt = (min(x + 2, W - 1) - max(x - 2, 0) + 1)
                  * (min(y + 2, H - 1) - max(y - 2, 0) + 1);
  const int a = 12 - cnt / 2;  // the out-of-frame taps filled -inf first
  float v[25];
  int rank = 0;
  bool nans = false;
#pragma unroll
  for (int dx = -2; dx <= 2; ++dx) {
#pragma unroll
    for (int dy = -2; dy <= 2; ++dy) {
      const int k = (dx + 2) * 5 + dy + 2;
      const bool ok = x + dx >= 0 && x + dx < W && y + dy >= 0 && y + dy < H;
      v[k] = ok ? tile[ly + dy + 2][lx + dx + 2]
                : (rank++ < a ? -CUDART_INF_F : CUDART_INF_F);
      nans |= v[k] != v[k];
    }
  }
  out[(size_t)y * W + x] = nans ? select_mid25<true>(v) : select_mid25<false>(v);
}

template <typename S>
__device__ __forceinline__ float widen(S v);
template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float widen<__half>(__half v) {
  return __half2float(v);
}

// out[y, x] from d = (int)d0[y, x] and vol at (y, c, d - 1 .. d + 1), with
// c = W - 1 - x for x-reversed storage, else x; strides in elements.
template <typename S>
__global__ void __launch_bounds__(NT)
subpixel_kernel(const float* __restrict__ d0, const S* __restrict__ vol,
                float* __restrict__ out, int H, int W, long long sy,
                long long sx, long long sd, int Dp, bool xrev, int disp_max,
                float thresh) {
  const int x = blockIdx.x * TX + threadIdx.x % TX;
  const int y = blockIdx.y * TY + threadIdx.x / TX;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)y * W + x;
  const int d = (int)d0[i];  // truncation, saturating, as astype(int32)
  const S* base = vol + y * sy + (long long)(xrev ? W - 1 - x : x) * sx;
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = (int)((unsigned)d + (unsigned)(k - 1));  // int32 wrap
    c[k] = j >= 0 && j < Dp ? widen<S>(base[j * sd]) : 0.f;
  }
  const float cn = c[0], cz = c[1], cp = c[2];
  const float denom =
      __fmul_rn(2.f, __fsub_rn(__fadd_rn(cp, cn), __fmul_rn(2.f, cz)));
  const float df = (float)d;
  float r = df;
  if (d >= 1 && d < disp_max - 1 && denom > thresh) {
    const float q = __fdiv_rn(__fsub_rn(cp, cn), denom);
    r = __fsub_rn(df, q != q ? q : fminf(fmaxf(q, -1.f), 1.f));
  }
  out[i] = r;
}

__global__ void __launch_bounds__(NT)
occlusion_fill_kernel(const float* __restrict__ d0,
                      const float* __restrict__ lab, float* __restrict__ out,
                      int W) {
  extern __shared__ int last[];  // NT ints, NT ints, W floats, W bytes
  int* first = last + NT;
  float* row = reinterpret_cast<float*>(first + NT);
  unsigned char* kind = reinterpret_cast<unsigned char*>(row + W);
  const size_t base = (size_t)blockIdx.x * W;
  for (int x = threadIdx.x; x < W; x += NT) {
    row[x] = d0[base + x];
    const float l = lab[base + x];
    kind[x] = l == MATCH ? 1 : l == OCCLUSION ? 2 : 0;
  }
  __syncthreads();
  const int t = threadIdx.x, chunk = (W + NT - 1) / NT;
  const int lo = min(W, t * chunk), hi = min(W, lo + chunk);
  int lm = -1, fm = W;  // the chunk's last and first match
  for (int x = lo; x < hi; ++x) {
    if (kind[x] == 1) {
      fm = min(fm, x);
      lm = x;
    }
  }
  last[t] = lm;
  first[t] = fm;
  __syncthreads();
  // inclusive scans over the chunks: the last match up to each, and the
  // first match of the row (first[0] after the min-scan)
  for (int s = 1; s < NT; s <<= 1) {
    const int a = t >= s ? last[t - s] : -1;
    const int b = t + s < NT ? first[t + s] : W;
    __syncthreads();
    last[t] = max(last[t], a);
    first[t] = min(first[t], b);
    __syncthreads();
  }
  int left = t > 0 ? last[t - 1] : -1;
  const int row_first = first[0];
  for (int x = lo; x < hi; ++x) {
    if (kind[x] == 1) left = x;
    if (kind[x] == 2) {
      const int src = left >= 0 ? left : row_first < W ? row_first : x;
      row[x] = row[src];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += NT) out[base + x] = row[x];
}

dim3 tiles(int H, int W) { return dim3((W + TX - 1) / TX, (H + TY - 1) / TY); }

}  // namespace

// Every entry: (H, W) float32 maps, contiguous, on the card; returns
// cudaGetLastError() after its one launch on `stream`.

extern "C" int occlusion_fill_smem_bytes(int W) {
  return occlusion_smem_bytes(W);
}

extern "C" int occlusion_fill_launch(const float* d0, const float* lab,
                                     float* out, int H, int W,
                                     cudaStream_t stream) {
  const int smem = occlusion_smem_bytes(W);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        occlusion_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  occlusion_fill_kernel<<<H, NT, smem, stream>>>(d0, lab, out, W);
  return (int)cudaGetLastError();
}

extern "C" int mismatch_fill_launch(const float* d0, const float* lab,
                                    float* out, int H, int W,
                                    cudaStream_t stream) {
  mismatch_fill_kernel<<<tiles(H, W), NT, 0, stream>>>(d0, lab, out, H, W);
  return (int)cudaGetLastError();
}

extern "C" int median5_launch(const float* img, float* out, int H, int W,
                              cudaStream_t stream) {
  median5_kernel<<<tiles(H, W), NT, 0, stream>>>(img, out, H, W);
  return (int)cudaGetLastError();
}

// vol: the first sample's address; sy, sx, sd: the strides in elements of
// the volume's row, column and disparity axes; Dp: the disparities it holds;
// storage 0 float32, 1 bfloat16, 2 float16; xrev: the columns x-reversed.
// Returns cudaErrorInvalidValue for another storage code.
extern "C" int subpixel_launch(const float* d0, const void* vol, float* out,
                               int H, int W, long long sy, long long sx,
                               long long sd, int Dp, int storage, int xrev,
                               int disp_max, float thresh,
                               cudaStream_t stream) {
  const dim3 grid = tiles(H, W);
  switch (storage) {
    case 0:
      subpixel_kernel<float><<<grid, NT, 0, stream>>>(
          d0, static_cast<const float*>(vol), out, H, W, sy, sx, sd, Dp,
          xrev != 0, disp_max, thresh);
      break;
    case 1:
      subpixel_kernel<__nv_bfloat16><<<grid, NT, 0, stream>>>(
          d0, static_cast<const __nv_bfloat16*>(vol), out, H, W, sy, sx, sd,
          Dp, xrev != 0, disp_max, thresh);
      break;
    case 2:
      subpixel_kernel<__half><<<grid, NT, 0, stream>>>(
          d0, static_cast<const __half*>(vol), out, H, W, sy, sx, sd, Dp,
          xrev != 0, disp_max, thresh);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
