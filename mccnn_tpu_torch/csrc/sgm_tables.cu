// The D1 / D2 penalty tables of the HWD lane's four sweeps.
//
// Replaces the plain torch table build of ops/sgm.py sweep_plan
// (grad_with_sentinel, d2_columns, _tables), the tables of the JAX
// package's _sgm_slab_hwd (mccnn_tpu/ops/sgm.py:1237), which it leaves
// to XLA. One launch a reference direction writes all four sweeps'
// tables, in chain order (down, up, right, left), into one buffer: table
// t's (Hp, Wp) D1 at t * stride, its (Hp, gw) D2 at t * stride + n_d1
// (ops/sgm.py table_layout). Storage order as the sweeps read it: with
// xrev (the left direction's x-reversed volume) D1 is flipped in x and
// the D2 rows are lane-reversed.
//
// Natural values, for (y, x) in the (H, W) frame:
//   down / up (dy = 1 / -1): D1 = |x0[y, x] - x0[clamp(y - dy), x]| (0 at
//   the clamped edge); D2 core = |x1[y, x] - x1[(y - dy) mod H, x]| (the
//   plain torch.roll wraps row 0 or H - 1 to the opposite row: no
//   sentinel there);
//   right / left (dx = 1 / -1): D1 = |x0[y, x] - x0[y, clamp(x - dx)]|;
//   D2 core = |x1[y, x] - x1[y, x - dx]|, 10 where x - dx leaves the frame.
// The D2 row is the core with D columns of 10 on both sides (W + 2D
// columns); D1 pads to (Hp, Wp) with 0, D2 to (Hp, gw) with 10. Every
// value is |a - b| of two float32 pixels, 0 or 10, so the tables are the
// plain version's bit for bit.
//
// A block writes one stored row of one table part: blockIdx.x the row y,
// blockIdx.y the part (table t = part / 2, D1 for an even part, D2 for an
// odd one), so no index is divided; the last row's block also writes the
// alignment gap (0) before the next part. The two image rows a value reads
// (y and y - dy, clamped for D1, wrapped for D2) are fixed a block, and
// are read through L1; the xrev flip is the index W - 1 - j (D1) or
// W + 2D - 1 - j (D2). A row goes out in 16-byte stores from its first
// 16-byte boundary, with a scalar head and tail (D1 rows start on 16 bytes
// where Wp is a multiple of 4, D2 rows at n_d1 + y gw only where gw is).
// D1 and D2 rows run separate loops (a template argument), so a value
// costs its two loads, a few compares, the subtract and the absolute value.
//
// Bound on the H100 at KITTI size (Hp 384, Wp 1280, gw 1764): 18.7 MB
// written and both 1.8 MB images read a direction, 22.3 MB, 0.00667 ms at
// 3.35 TB/s; one fill_ of the buffer is the store floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads a block (a row of one table part)

// Row y of one part, its values by stored column j: ra, rb the two image
// rows, vertical whether the sweep runs down or up, step dy or dx, yin
// whether y lies in the frame, len the row's length (Wp or gw).
template <bool D2>
__device__ __forceinline__ void write_row(float* __restrict__ o, int64_t base,
                                          int end, const float* ra,
                                          const float* rb, int len, int W,
                                          int D, bool vertical, int step,
                                          bool yin, bool xrev) {
  const int core = W + 2 * D;
  auto value = [&](int j) -> float {
    if (j >= len) return 0.f;  // the alignment gap
    if (!D2) {
      if (!yin || j >= W) return 0.f;
      const int x = xrev ? W - 1 - j : j;
      const int xb = vertical ? x : min(max(x - step, 0), W - 1);
      return fabsf(__fsub_rn(ra[x], rb[xb]));
    }
    if (!yin) return 10.f;
    const int x = (xrev ? core - 1 - j : j) - D;  // the natural column
    const int xb = vertical ? x : x - step;
    if (x < 0 || x >= W || xb < 0 || xb >= W) return 10.f;
    return fabsf(__fsub_rn(ra[x], rb[xb]));
  };
  // elements before the first 16-byte boundary, whole 16-byte groups, the
  // rest
  const int head = min((int)((4 - (base & 3)) & 3), end);
  const int nq = (end - head) >> 2;
  const int tail = head + 4 * nq;
  float* const row = o + base;
  if ((int)threadIdx.x < head) row[threadIdx.x] = value(threadIdx.x);
  for (int q = threadIdx.x; q < nq; q += NT) {
    const int j = head + 4 * q;
    *reinterpret_cast<float4*>(row + j) =
        make_float4(value(j), value(j + 1), value(j + 2), value(j + 3));
  }
  if ((int)threadIdx.x < end - tail)
    row[tail + threadIdx.x] = value(tail + threadIdx.x);
}

__global__ void __launch_bounds__(NT)
sgm_tables_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                  float* __restrict__ out, int H, int W, int D, int Hp, int Wp,
                  int gw, int64_t n_d1, int64_t stride, int xrev) {
  const int y = blockIdx.x, part = blockIdx.y;
  const int t = part >> 1;
  const bool d2 = part & 1;
  const bool vertical = t < 2;
  const int step = (t & 1) ? -1 : 1;  // dy for t 0, 1; dx for t 2, 3
  const bool yin = y < H;
  const int len = d2 ? gw : Wp;
  const int64_t start = t * stride + (d2 ? n_d1 : 0);
  // the last row also writes the gap to the next part
  const int end = y < Hp - 1 ? len
                  : (int)((d2 ? stride : n_d1) - (d2 ? n_d1 : 0) -
                          (int64_t)(Hp - 1) * len);
  int yb = y;
  if (yin && vertical) {
    yb = y - step;
    if (d2) yb = yb < 0 ? yb + H : yb >= H ? yb - H : yb;  // wrap
    else yb = min(max(yb, 0), H - 1);                       // clamp
  }
  const float* const img = d2 ? x1 : x0;
  const float* const ra = img + (int64_t)(yin ? y : 0) * W;
  const float* const rb = img + (int64_t)(yin ? yb : 0) * W;
  const int64_t base = start + (int64_t)y * len;
  if (d2)
    write_row<true>(out, base, end, ra, rb, len, W, D, vertical, step, yin,
                    xrev);
  else
    write_row<false>(out, base, end, ra, rb, len, W, D, vertical, step, yin,
                     xrev);
}

}  // namespace

// x0, x1: (H, W) float32; out: 4 * stride float32 (the layout above),
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int sgm_tables_launch(const float* x0, const float* x1, float* out,
                                 int H, int W, int D, int Hp, int Wp, int gw,
                                 long long n_d1, long long stride, int xrev,
                                 cudaStream_t stream) {
  if (Hp <= 0) return (int)cudaGetLastError();
  sgm_tables_kernel<<<dim3(Hp, 8), NT, 0, stream>>>(
      x0, x1, out, H, W, D, Hp, Wp, gw, n_d1, stride, xrev);
  return (int)cudaGetLastError();
}
