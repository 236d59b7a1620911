// The generic (D, H, W) lane's SGM data movement: the two families'
// relayouts, their D1 / D2 tables, the family sum and the winner-take-all.
//
// Replace the plain torch passes of ops/sgm.py (horiz_plan, vert_plan,
// the family sum of sgm_multi) and ops/costs.py (wta), the counterparts of
// the transposes, tables and sums of the JAX package's _sgm_slab_horiz /
// _sgm_slab_vert / _sgm_slab (mccnn_tpu/ops/sgm.py:1135-1234), of the
// pipeline's / 4 (mccnn_tpu/pipeline.py:192) and of costs.wta
// (mccnn_tpu/ops/costs.py:197), which the JAX package leaves to XLA. Each
// moves or compares float32 values without arithmetic that could round
// otherwise (a copy, |a - b|, a + b, a quarter, a compare), so each is its
// plain version's bits, NaN payloads included. All four are bound by
// their bytes on the H100 (3.35 TB/s).
//
// sgm_layout_kernel (entry sgm_layout): n = 1 or 2 volumes (D, H, w), the
// -1 direction first, into the family's d-minor volume, lanes d >= D NaN
// (0x7fc00000, the bits _pad_d writes): horizontal, out (w, n*H, Dp),
// out[x, i*H + y, d] = vol_i[d, y, x]; vertical, out (H, n*w, Dp),
// out[y, i*w + xt, d] = vol_i[d, y, x] with xt = w - 1 - x for the first
// volume when rev0 (the -1 direction's x-reversed columns). A block takes
// TD = 32 disparities x TX = 128 columns of one row y of one volume: it
// reads 32 rows of 128 floats, coalesced along x, into a shared tile of an
// odd pitch (no bank conflict either way), and writes each column's 32
// disparities, one 128-byte line of the output, as eight 16-byte stores
// (PR 21 found that the store width sets such kernels' rate). A tile of
// pad lanes only stores NaN.
//
// sgm_combine_kernel (entry sgm_combine): the family accumulators h (W, n*H,
// Dp) and v (H, n*W, Dp) into out (n, D, H, W), out[i, d, y, x] =
// (h[x, i*H + y, d] + v[y, i*W + xt, d]) * q, q = 0.25 (the quarter, exact:
// the same bits as torch.add then / 4.0) or 1 (the plain sum), __fadd_rn
// and __fmul_rn. A block takes 32 disparities x 128 columns of one row:
// each column's 32-disparity segment of both accumulators as 16-byte
// loads (one 128-byte line each), summed, through a shared tile to rows of
// out written along x in 16-byte stores from the row's first 16-byte
// boundary, a scalar head and tail.
//
// wta_dhw_kernel (entry wta_dhw): out[y, x] = argmin over d of vol[d, y, x]
// with NaN taken as +inf, as float32; ties (-0.0 ties +0.0, +inf ties
// +inf, an all-NaN column) go to the lowest d, as torch.argmin's. H * W
// threads walking all of D would leave the card idle at KITTI size, so a
// block takes 32 columns of one row and its WW = 8 warps a contiguous
// share of D each: a lane keeps (value, index) with a strict <, from
// batches of 8 loads issued before any compare, and the warps' pairs merge
// in d order, again with a strict < (the lower share wins a tie).
//
// generic_tables_kernel (entry sgm_generic_tables): the D1 / D2 tables that
// horiz_plan and vert_plan hand to the sweeps, for one or both families, in
// one launch, as parts of one buffer whose layout ops/sgm.py
// generic_table_layout sets (each part's start a multiple of 4 floats, the
// gaps 0). With dx, dy the sweep's step (+1 right / down, -1 left / up):
//   kind 0, horizontal D1 (w = W rows x, n*H columns): |x0[y, x] -
//     x0[y, clamp(x - dx)]|, y = column mod H;
//   kind 1, horizontal D2 (n*H rows, D + W + Dp columns): row i*H + y holds
//     the core |x1[y, x] - x1[y, x - dx]| (10 where x or x - dx leaves the
//     frame) with D columns of 10 on both sides, lane-reversed for the -1
//     direction, then 10;
//   kind 2, vertical D1 (H rows, n*w columns of the shard c0:c1): |x0[y, x]
//     - x0[clamp(y - dy), x]|, the -1 direction's columns reversed;
//   kind 3 / 4, vertical D2, reversed / natural (H rows, D + w + Dp
//     columns): the core |x1[y, x] - x1[(y - dy) mod H, x]| (the plain
//     torch.roll wraps: no sentinel) with D columns of 10 on both sides,
//     lane-reversed (3) or not (4), padded with 10, from column W - c1 (3)
//     or c0 (4).
// A block writes one row of one part (a 2-D grid: rows, parts), eight rows
// of the horizontal D1 (their x0 reads, down a column, hit the same
// sectors in L1), in 16-byte stores from the row's first 16-byte boundary
// with a scalar head and tail; the last row of a part also writes the gap
// before the next part.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 128;       // columns a layout / combine tile
constexpr int TD = 32;        // disparities a tile: one 128-byte line
constexpr int LDT = TX + 1;   // the tile's pitch in floats (odd)
constexpr int NT = 256;       // threads a layout / combine / wta block
constexpr int WW = NT / 32;   // warps a wta block, each a share of D
constexpr int WB = 8;         // loads a wta lane issues before comparing
constexpr unsigned QNAN = 0x7fc00000u;  // torch.nan's bits, _pad_d's pad

__global__ void __launch_bounds__(NT)
sgm_layout_kernel(const float* __restrict__ v0, const float* __restrict__ v1,
              float* __restrict__ out, int D, int H, int w, int Dp, int S,
              int vertical, int rev0) {
  __shared__ float tile[TD][LDT];
  const int x0 = blockIdx.x * TX, d0 = blockIdx.y * TD;
  const int part = blockIdx.z >= H, y = blockIdx.z - part * H;
  const int t = threadIdx.x;
  if (d0 < D) {  // the whole block alike
    const float* __restrict__ v = part ? v1 : v0;
    const int c = t & (TX - 1), x = x0 + c;
#pragma unroll
    for (int r = t / TX; r < TD; r += NT / TX)
      if (d0 + r < D && x < w)
        tile[r][c] = v[((int64_t)(d0 + r) * H + y) * w + x];
    __syncthreads();
  }
  const int j = t & 7;  // the 16-byte group of a column's 32 disparities
  const bool rev = vertical && part == 0 && rev0;
  const float nan = __uint_as_float(QNAN);
#pragma unroll
  for (int k = 0; k < TX / (NT / 8); ++k) {
    const int c = t / 8 + k * (NT / 8), x = x0 + c;
    if (x >= w) continue;
    const int r = 4 * j;
    const float4 q = make_float4(d0 + r < D ? tile[r][c] : nan,
                                 d0 + r + 1 < D ? tile[r + 1][c] : nan,
                                 d0 + r + 2 < D ? tile[r + 2][c] : nan,
                                 d0 + r + 3 < D ? tile[r + 3][c] : nan);
    const int64_t row = vertical
        ? (int64_t)y * S + part * w + (rev ? w - 1 - x : x)
        : (int64_t)x * S + part * H + y;
    *reinterpret_cast<float4*>(out + row * Dp + d0 + r) = q;
  }
}

__global__ void __launch_bounds__(NT)
sgm_combine_kernel(const float* __restrict__ h, const float* __restrict__ v,
               float* __restrict__ out, int D, int H, int W, int Dp, int n,
               int rev0, int quarter) {
  __shared__ float tile[TD][LDT];
  const int x0 = blockIdx.x * TX, d0 = blockIdx.y * TD;
  const int part = blockIdx.z >= H, y = blockIdx.z - part * H;
  const int t = threadIdx.x, j = t & 7, r = 4 * j;
  const bool rev = part == 0 && rev0;
  const float q = quarter ? 0.25f : 1.f;
  if (d0 + r < D) {
#pragma unroll
    for (int k = 0; k < TX / (NT / 8); ++k) {
      const int c = t / 8 + k * (NT / 8), x = x0 + c;
      if (x >= W) break;
      const float4 a = *reinterpret_cast<const float4*>(
          h + ((int64_t)x * n * H + part * H + y) * Dp + d0 + r);
      const float4 b = *reinterpret_cast<const float4*>(
          v + ((int64_t)y * n * W + part * W + (rev ? W - 1 - x : x)) * Dp +
          d0 + r);
      tile[r][c] = __fmul_rn(__fadd_rn(a.x, b.x), q);
      tile[r + 1][c] = __fmul_rn(__fadd_rn(a.y, b.y), q);
      tile[r + 2][c] = __fmul_rn(__fadd_rn(a.z, b.z), q);
      tile[r + 3][c] = __fmul_rn(__fadd_rn(a.w, b.w), q);
    }
  }
  __syncthreads();
  // a warp a row (d, y) of the output: its 128 columns from x0
  const int lane = t & 31, len = min(TX, W - x0);
  for (int rr = t / 32; rr < TD && d0 + rr < D; rr += NT / 32) {
    const int64_t base = (((int64_t)part * D + d0 + rr) * H + y) * W + x0;
    float* const o = out + base;
    const float* const s = tile[rr];
    const int head = min((int)((4 - (base & 3)) & 3), len);
    const int nq = (len - head) >> 2, tail = head + 4 * nq;
    if (lane < head) o[lane] = s[lane];
    if (lane < nq) {
      const int c = head + 4 * lane;
      *reinterpret_cast<float4*>(o + c) =
          make_float4(s[c], s[c + 1], s[c + 2], s[c + 3]);
    }
    if (lane < len - tail) o[tail + lane] = s[tail + lane];
  }
}

__global__ void __launch_bounds__(NT)
wta_dhw_kernel(const float* __restrict__ vol, float* __restrict__ out, int D,
           int H, int W) {
  __shared__ float bv[WW][32];
  __shared__ int bi[WW][32];
  const int lane = threadIdx.x & 31, wp = threadIdx.x / 32;
  const int x = blockIdx.x * 32 + lane, y = blockIdx.y;
  const int per = (D + WW - 1) / WW;
  const int lo = min(D, wp * per), hi = min(D, lo + per);
  // +inf at lo: a share of +inf (or NaN) only keeps its first index
  float best = __int_as_float(0x7f800000);
  int idx = lo;
  if (x < W) {
    const int64_t plane = (int64_t)H * W;
    const float* const p = vol + (int64_t)y * W + x;
    int d = lo;
    for (; d + WB <= hi; d += WB) {
      float c[WB];
#pragma unroll
      for (int e = 0; e < WB; ++e) c[e] = p[(d + e) * plane];
#pragma unroll
      for (int e = 0; e < WB; ++e)
        if (!isnan(c[e]) && c[e] < best) best = c[e], idx = d + e;
    }
    for (; d < hi; ++d) {
      const float c = p[d * plane];
      if (!isnan(c) && c < best) best = c, idx = d;
    }
  }
  bv[wp][lane] = best;
  bi[wp][lane] = idx;
  __syncthreads();
  if (wp == 0 && x < W) {
    for (int k = 1; k < WW; ++k)
      if (bv[k][lane] < best) best = bv[k][lane], idx = bi[k][lane];
    out[(int64_t)y * W + x] = (float)idx;
  }
}

// one part of the table buffer: its kind (above), the sweep's step, its
// rows and columns, rows a block, its first element and the element after
// its last row's gap (the next part's first element)
struct Part {
  int kind, step, rows, cols, rpb;
  long long off, end;
};
constexpr int MAX_PARTS = 10;
struct Parts {
  Part p[MAX_PARTS];
};
constexpr int TNT = 128;  // threads a table block

struct Frame {
  const float* x0;
  const float* x1;
  int H, W, D, n, w, c0, c1, rev0;
};

__device__ __forceinline__ float absdiff(float a, float b) {
  return fabsf(__fsub_rn(a, b));
}

// element j of row r of a part; 0 in the gap after a part's last row
template <int KIND>
__device__ __forceinline__ float value(const Frame& f, const Part& P, int r,
                                       int j) {
  if (j >= P.cols) return 0.f;
  const int core = f.W + 2 * f.D;
  if (KIND == 0) {  // row r is the column x
    const int y = j >= f.H ? j - f.H : j;
    const float* const row = f.x0 + (int64_t)y * f.W;
    return absdiff(row[r], row[min(max(r - P.step, 0), f.W - 1)]);
  }
  if (KIND == 1) {
    const int i = r >= f.H, y = r - i * f.H;
    if (j >= core) return 10.f;
    const int x = (i == 0 && f.rev0 ? core - 1 - j : j) - f.D, xb = x - P.step;
    if (x < 0 || x >= f.W || xb < 0 || xb >= f.W) return 10.f;
    const float* const row = f.x1 + (int64_t)y * f.W;
    return absdiff(row[x], row[xb]);
  }
  if (KIND == 2) {  // row r is the image row y
    const int i = j >= f.w, xt = j - i * f.w;
    const int x = i == 0 && f.rev0 ? f.c1 - 1 - xt : f.c0 + xt;
    const int yb = min(max(r - P.step, 0), f.H - 1);
    return absdiff(f.x0[(int64_t)r * f.W + x], f.x0[(int64_t)yb * f.W + x]);
  }
  // KIND 3 (reversed) and 4 (natural): column k of the padded core row
  const int k = KIND == 3 ? f.W - f.c1 + j : f.c0 + j;
  if (k >= core) return 10.f;
  const int x = (KIND == 3 ? core - 1 - k : k) - f.D;
  if (x < 0 || x >= f.W) return 10.f;
  int yb = r - P.step;
  yb = yb < 0 ? yb + f.H : yb >= f.H ? yb - f.H : yb;  // torch.roll wraps
  return absdiff(f.x1[(int64_t)r * f.W + x], f.x1[(int64_t)yb * f.W + x]);
}

template <int KIND>
__device__ void write_rows(const Frame& f, const Part& P, float* out) {
  const int r0 = blockIdx.x * P.rpb, r1 = min(P.rows, r0 + P.rpb);
  for (int r = r0; r < r1; ++r) {
    const long long base = P.off + (long long)r * P.cols;
    const int end = r < P.rows - 1 ? P.cols : (int)(P.end - base);
    const int head = min((int)((4 - (base & 3)) & 3), end);
    const int nq = (end - head) >> 2, tail = head + 4 * nq;
    float* const o = out + base;
    if ((int)threadIdx.x < head)
      o[threadIdx.x] = value<KIND>(f, P, r, threadIdx.x);
    for (int qi = threadIdx.x; qi < nq; qi += TNT) {
      const int j = head + 4 * qi;
      *reinterpret_cast<float4*>(o + j) = make_float4(
          value<KIND>(f, P, r, j), value<KIND>(f, P, r, j + 1),
          value<KIND>(f, P, r, j + 2), value<KIND>(f, P, r, j + 3));
    }
    if ((int)threadIdx.x < end - tail)
      o[tail + threadIdx.x] = value<KIND>(f, P, r, tail + threadIdx.x);
  }
}

__global__ void __launch_bounds__(TNT)
generic_tables_kernel(const __grid_constant__ Parts parts,
              const __grid_constant__ Frame f, float* __restrict__ out) {
  const Part& P = parts.p[blockIdx.y];
  if ((int)blockIdx.x * P.rpb >= P.rows) return;
  switch (P.kind) {
    case 0: write_rows<0>(f, P, out); break;
    case 1: write_rows<1>(f, P, out); break;
    case 2: write_rows<2>(f, P, out); break;
    case 3: write_rows<3>(f, P, out); break;
    default: write_rows<4>(f, P, out); break;
  }
}

}  // namespace

// vols: n (1 or 2) contiguous (D, H, w) float32 volumes (v1 unused for
// n = 1); out: (w, n*H, Dp) (vertical 0) or (H, n*w, Dp) (vertical 1),
// Dp a multiple of 32 and at least D, 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int sgm_layout_launch(const float* v0, const float* v1, float* out,
                                 int n, int D, int H, int w, int Dp,
                                 int vertical, int rev0, cudaStream_t stream) {
  if (n < 1 || n > 2 || Dp % TD || Dp < D || n * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (w <= 0 || H <= 0 || Dp == 0) return (int)cudaGetLastError();
  const dim3 grid((w + TX - 1) / TX, Dp / TD, n * H);
  sgm_layout_kernel<<<grid, NT, 0, stream>>>(
      v0, n > 1 ? v1 : v0, out, D, H, w, Dp, vertical ? n * w : n * H,
      vertical, rev0);
  return (int)cudaGetLastError();
}

// h: (W, n*H, Dp), v: (H, n*W, Dp) float32, 16-byte aligned, Dp a multiple
// of 32; out: (n, D, H, W) float32, 16-byte aligned.
extern "C" int sgm_combine_launch(const float* h, const float* v, float* out,
                                  int n, int D, int H, int W, int Dp, int rev0,
                                  int quarter, cudaStream_t stream) {
  if (n < 1 || n > 2 || Dp % TD || Dp < D || n * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (W <= 0 || H <= 0 || D <= 0) return (int)cudaGetLastError();
  const dim3 grid((W + TX - 1) / TX, (D + TD - 1) / TD, n * H);
  sgm_combine_kernel<<<grid, NT, 0, stream>>>(h, v, out, D, H, W, Dp, n,
                                              rev0, quarter);
  return (int)cudaGetLastError();
}

// vol: (D, H, W) float32, D >= 1; out: (H, W) float32.
extern "C" int wta_dhw_launch(const float* vol, float* out, int D, int H,
                              int W, cudaStream_t stream) {
  if (D < 1 || H > 65535) return (int)cudaErrorInvalidValue;
  if (W <= 0 || H <= 0) return (int)cudaGetLastError();
  wta_dhw_kernel<<<dim3((W + 31) / 32, H), NT, 0, stream>>>(vol, out, D, H,
                                                            W);
  return (int)cudaGetLastError();
}

// desc: nparts x (kind, step, rows, cols, first element) from
// ops/sgm.py generic_table_layout, in buffer order; total: the buffer's
// length in floats. x0, x1: (H, W) float32; c0, c1 the vertical parts'
// columns (w = c1 - c0), n the directions, rev0 whether the first is -1.
extern "C" int sgm_generic_tables_launch(
    const float* x0, const float* x1, float* out, const long long* desc,
    int nparts, long long total, int H, int W, int D, int n, int c0, int c1,
    int rev0, cudaStream_t stream) {
  if (nparts < 1 || nparts > MAX_PARTS || n < 1 || n > 2)
    return (int)cudaErrorInvalidValue;
  Parts parts{};
  int blocks = 0;
  for (int i = 0; i < nparts; ++i) {
    Part& P = parts.p[i];
    const long long* d = desc + 5 * i;
    P.kind = (int)d[0];
    P.step = (int)d[1];
    P.rows = (int)d[2];
    P.cols = (int)d[3];
    P.off = d[4];
    P.end = i + 1 < nparts ? desc[5 * (i + 1) + 4] : total;
    P.rpb = P.kind == 0 ? 8 : 1;
    if (P.kind < 0 || P.kind > 4 || P.rows < 1 || P.cols < 1 || P.off % 4)
      return (int)cudaErrorInvalidValue;
    blocks = max(blocks, (P.rows + P.rpb - 1) / P.rpb);
  }
  const Frame f{x0, x1, H, W, D, n, c1 - c0, c0, c1, rev0};
  generic_tables_kernel<<<dim3(blocks, nparts), TNT, 0, stream>>>(parts, f,
                                                                  out);
  return (int)cudaGetLastError();
}
