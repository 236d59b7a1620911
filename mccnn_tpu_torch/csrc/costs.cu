// The census and absolute-difference cost volumes of the generic lane.
//
// Replace the plain torch chains of ops/costs.py (census_volume,
// ad_volume), the counterparts of mccnn_tpu/ops/costs.py census_volume
// (:103) and ad_volume (:49), which the JAX package leaves to XLA.
// Reference kernels: census adcensus.cu:117-153, ad adcensus.cu:62-93.
// Volumes are (D, H, W) float32, NaN (0x7fc00000, torch.nan's bits)
// where the match column x + d * dir leaves the frame.
//
// census_sig_kernel: the signature pass, once a pair. For every pixel of
// every channel of both images, n = (2r + 1)^2 window positions k =
// (dy + r) * (2r + 1) + (dx + r), bit k % 64 of word k / 64 holds
// x[y + dy, x + dx] < x[y, x] (strict: ties and NaN give 0), clear where
// (y + dy, x + dx) leaves the frame (the plain version's torch.roll wraps
// and masks the wrapped neighbours: the same bits). A pixel's NW =
// ceil(n / 64) words, 8 bytes each; no in-frame words: which positions
// lie in the frame follows from (y, x) and the frame.
//
// census_volume_kernel<NW, ONE>: cost[d, y, x] = sum over channels of
// n - popc(m & ~(b0 ^ b1)) (the hamming distance plus one for each
// window position out of frame on either side), signature 0 at (y, x),
// signature 1 at (y, x + d * dir), m the window positions in frame for
// both centres: the rows dy in frame at y, the columns dx in frame at x
// and at x + d * dir, a rectangle of the window (one of the (r + 1)^2
// column ranges of the block's row, a table in shared memory). The
// channels' distances are small integers, so their float32 sum in any
// order is exact and equals the integer sum converted; the mean
// multiplies by the float32 reciprocal of C (__fmul_rn), as the plain
// version does. A thread a column, a block 128 columns of one row and DCH
// disparities; ONE (C = 1) keeps the reference signature in registers.
//
// ad_volume_kernel<R>: cost[d, y, x] = num / cnt (__fdiv_rn), num the
// (2R + 1)^2 box sum of t[y', x'] = |x0[y', x'] - x1s[y', x']| * ok(x')
// (x1s = x1 shifted by d * dir, 0 out of frame; ok whether x' + d * dir
// lies in frame) with zeros outside the frame, in the plain version's
// order: each row's horizontal sum from the leftmost tap to the
// rightmost, then the row sums from the top row to the bottom one, each
// add rounded (__fadd_rn). cnt, the box sum of ok, is a sum of 0/1
// values and so the exact product of the in-frame rows and the in-frame,
// ok columns of the window. A block is one disparity and a tile of TY
// rows x TX columns: the terms of its rows and columns and a halo of R
// in shared memory (computed once each), each thread the row sums of its
// column in registers, reused by the TY outputs of the column.
//
// Bounds on the H100 at KITTI size (370 x 1226, D = 228): a volume is
// 413.7 MB written, 0.124 ms at 3.35 TB/s; the signatures of a pair at
// radius 4 are 14.5 MB (two 8-byte words a pixel).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 128;   // census volume: threads (columns) a block
constexpr int DCH = 32;   // census volume: disparities a block
constexpr int TX = 128;   // ad: columns (threads) a block
constexpr int TY = 32;    // ad: rows a block
constexpr int ST = 256;   // signature pass: threads a block
constexpr int MAX_R = 7;  // the largest radius (four signature words)
constexpr unsigned NAN_BITS = 0x7fc00000u;

__global__ void __launch_bounds__(ST)
census_sig_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                  unsigned long long* __restrict__ sig, int C, int H, int W,
                  int r, int nw) {
  const int64_t plane = (int64_t)H * W;
  const int64_t total = 2 * (int64_t)C * plane;
  for (int64_t i = blockIdx.x * (int64_t)ST + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * ST) {
    const int64_t img = i / plane;  // image * C + channel
    const int64_t p = i - img * plane;
    const int y = (int)(p / W), x = (int)(p - (int64_t)y * W);
    const float* im = (img < C ? x0 + img * plane : x1 + (img - C) * plane);
    const float c = im[p];
    unsigned long long* out = sig + i * nw;
    unsigned long long b = 0;
    int bit = 0, word = 0;
    for (int dy = -r; dy <= r; ++dy) {
      const int yy = y + dy;
      const bool yok = yy >= 0 && yy < H;
      for (int dx = -r; dx <= r; ++dx) {
        const int xx = x + dx;
        if (yok && xx >= 0 && xx < W && im[(int64_t)yy * W + xx] < c)
          b |= 1ull << bit;
        if (++bit == 64) {
          out[word++] = b;
          b = 0;
          bit = 0;
        }
      }
    }
    if (bit) out[word] = b;
  }
}

// NW words of a signature, 16-byte loads where NW is even (the wrapper
// refuses signatures that are not 16-byte aligned then)
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

// sig0, sig1: (C, H, W, NW) words of the reference image and of the
// image the match is taken in. win[(a, b)]: the block's row's window
// positions (dy, dx) with y + dy in frame and dx in [a - r, b], for a, b
// in [0, r], built once a block in shared memory; a cell reads the entry
// of its column range [max(-r, -x, -xm), min(r, W - 1 - x, W - 1 - xm)].
template <int NW, bool ONE>
__global__ void __launch_bounds__(CT)
census_volume_kernel(const unsigned long long* __restrict__ sig0,
                     const unsigned long long* __restrict__ sig1,
                     float* __restrict__ out, int C, int H, int W, int D,
                     int dir, int r, float recip) {
  constexpr int NR = MAX_R + 1;
  __shared__ unsigned long long win[NR * NR][NW];
  const int y = blockIdx.y;
  const int w = 2 * r + 1, n = w * w;
  const int ylo = max(-r, -y), yhi = min(r, H - 1 - y);
  for (int i = threadIdx.x; i < (r + 1) * (r + 1) * NW; i += CT) {
    const int e = i / NW, j = i - e * NW;
    const int a = e / (r + 1) - r, b = e - (e / (r + 1)) * (r + 1);
    // a row's run of dx in [a, b], shifted to each row's first position
    const unsigned long long run = ((1ull << (b - a + 1)) - 1) << (a + r);
    unsigned long long m = 0;
    for (int dy = ylo; dy <= yhi; ++dy) {
      const int sh = (dy + r) * w - 64 * j;
      if (sh >= 0 && sh < 64) m |= run << sh;
      else if (sh < 0 && sh > -64) m |= run >> -sh;
    }
    win[e][j] = m;
  }
  __syncthreads();
  const int x = blockIdx.x * CT + threadIdx.x;
  if (x >= W) return;
  const int64_t plane = (int64_t)H * W;
  const int64_t pix = (int64_t)y * W + x;
  const int xlo0 = max(-r, -x), xhi0 = min(r, W - 1 - x);
  unsigned long long s0[NW], s1[NW];
  if (ONE) load_words<NW>(sig0 + pix * NW, s0);
  const int d_end = min(D, (int)(blockIdx.z + 1) * DCH);
  for (int d = blockIdx.z * DCH; d < d_end; ++d) {
    const int xm = x + d * dir;
    float cost = __uint_as_float(NAN_BITS);
    if (xm >= 0 && xm < W) {
      const int xlo = max(xlo0, -xm), xhi = min(xhi0, W - 1 - xm);
      const unsigned long long* m = win[(xlo + r) * (r + 1) + xhi];
      int dist = 0;
      const int64_t q = (int64_t)y * W + xm;
      for (int c = 0; c < C; ++c) {
        if (!ONE) load_words<NW>(sig0 + (c * plane + pix) * NW, s0);
        load_words<NW>(sig1 + (c * plane + q) * NW, s1);
        int agree = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k)
          agree += __popcll(m[k] & ~(s0[k] ^ s1[k]));
        dist += n - agree;
      }
      cost = __fmul_rn((float)dist, recip);
    }
    out[((int64_t)d * H + y) * W + x] = cost;
  }
}

template <int NW>
int census_volume_nw(const unsigned long long* s0,
                     const unsigned long long* s1, float* out, int C, int H,
                     int W, int D, int dir, int r, float recip,
                     cudaStream_t stream) {
  const dim3 grid((W + CT - 1) / CT, H, (D + DCH - 1) / DCH);
  if (C == 1)
    census_volume_kernel<NW, true><<<grid, CT, 0, stream>>>(
        s0, s1, out, C, H, W, D, dir, r, recip);
  else
    census_volume_kernel<NW, false><<<grid, CT, 0, stream>>>(
        s0, s1, out, C, H, W, D, dir, r, recip);
  return (int)cudaGetLastError();
}

template <int R>
__global__ void __launch_bounds__(TX)
ad_volume_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                 float* __restrict__ out, int H, int W, int dir) {
  constexpr int WIN = 2 * R + 1;
  constexpr int TR = TY + 2 * R;   // term rows
  constexpr int TC = TX + 2 * R;   // term columns
  __shared__ float term[TR][TC];
  const int d = blockIdx.z;
  const int delta = d * dir;
  const int y0 = blockIdx.y * TY, xt = blockIdx.x * TX;
  for (int i = threadIdx.x; i < TR * TC; i += TX) {
    const int ty = i / TC, tx = i - ty * TC;
    const int yy = y0 - R + ty, xx = xt - R + tx;
    float t = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const int xm = xx + delta;
      const bool ok = xm >= 0 && xm < W;
      const float a = x0[(int64_t)yy * W + xx];
      const float b = ok ? x1[(int64_t)yy * W + xm] : 0.f;
      t = __fmul_rn(fabsf(__fsub_rn(a, b)), ok ? 1.f : 0.f);
    }
    term[ty][tx] = t;
  }
  __syncthreads();
  const int x = xt + threadIdx.x;
  if (x >= W) return;
  float hs[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float s = term[i][threadIdx.x];
#pragma unroll
    for (int k = 1; k < WIN; ++k) s = __fadd_rn(s, term[i][threadIdx.x + k]);
    hs[i] = s;
  }
  // the window's in-frame columns whose match column is in frame too
  const int lo = max(max(0, -delta), x - R);
  const int hi = min(min(W - 1, W - 1 - delta), x + R);
  const int cols = max(0, hi - lo + 1);
  const bool centre = x + delta >= 0 && x + delta < W;
#pragma unroll
  for (int j = 0; j < TY; ++j) {
    const int y = y0 + j;
    if (y >= H) break;
    float cost = __uint_as_float(NAN_BITS);
    if (centre) {
      float s = hs[j];
#pragma unroll
      for (int k = 1; k < WIN; ++k) s = __fadd_rn(s, hs[j + k]);
      const int rows = min(H - 1, y + R) - max(0, y - R) + 1;
      cost = __fdiv_rn(s, (float)(rows * cols));
    }
    out[((int64_t)d * H + y) * W + x] = cost;
  }
}

template <int R>
int ad_launch_r(const float* x0, const float* x1, float* out, int H, int W,
                int D, int dir, cudaStream_t stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, D);
  ad_volume_kernel<R><<<grid, TX, 0, stream>>>(x0, x1, out, H, W, dir);
  return (int)cudaGetLastError();
}

}  // namespace

// x0, x1: (C, H, W) float32; sig: (2, C, H, W, nw) 64-bit words, nw =
// ceil((2r + 1)^2 / 64): x0's signatures, then x1's. Returns
// cudaGetLastError() (cudaErrorInvalidValue for r outside [0, 7]).
extern "C" int census_signatures_launch(const float* x0, const float* x1,
                                        unsigned long long* sig, int C, int H,
                                        int W, int r, cudaStream_t stream) {
  if (r < 0 || r > MAX_R) return (int)cudaErrorInvalidValue;
  const int nw = ((2 * r + 1) * (2 * r + 1) + 63) / 64;
  const int64_t total = 2 * (int64_t)C * H * W;
  const int64_t blocks = (total + ST - 1) / ST;
  census_sig_kernel<<<(int)(blocks < 65536 ? blocks : 65536), ST, 0,
                      stream>>>(x0, x1, sig, C, H, W, r, nw);
  return (int)cudaGetLastError();
}

// s0, s1: (C, H, W, nw) signatures of the reference image and of the
// match image, made by census_signatures_launch at the same r (r = 4 and
// r = 5 both have nw = 2: nothing here tells them apart); out: (D, H, W)
// float32; recip: the float32 reciprocal of C.
extern "C" int census_volume_launch(const unsigned long long* s0,
                                    const unsigned long long* s1, float* out,
                                    int C, int H, int W, int D, int dir,
                                    int r, float recip, cudaStream_t stream) {
  if (r < 0 || r > MAX_R) return (int)cudaErrorInvalidValue;
  switch (((2 * r + 1) * (2 * r + 1) + 63) / 64) {
    case 1: return census_volume_nw<1>(s0, s1, out, C, H, W, D, dir, r, recip,
                                       stream);
    case 2: return census_volume_nw<2>(s0, s1, out, C, H, W, D, dir, r, recip,
                                       stream);
    case 3: return census_volume_nw<3>(s0, s1, out, C, H, W, D, dir, r, recip,
                                       stream);
    default: return census_volume_nw<4>(s0, s1, out, C, H, W, D, dir, r, recip,
                                        stream);
  }
}

// x0, x1: (H, W) float32; out: (D, H, W) float32.
extern "C" int ad_volume_launch(const float* x0, const float* x1, float* out,
                                int H, int W, int D, int dir, int r,
                                cudaStream_t stream) {
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
