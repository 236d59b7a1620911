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
// Bound on the H100 at KITTI size (Hp 384, Wp 1280, gw 1764): 18.7 MB
// written a direction, 0.0056 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
sgm_tables_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                  float* __restrict__ out, int H, int W, int D, int Hp, int Wp,
                  int gw, int64_t n_d1, int64_t stride, int xrev) {
  const int64_t total = 4 * stride;
  const int core = W + 2 * D;
  for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * NT) {
    const int t = (int)(i / stride);
    const int64_t r = i - t * stride;
    const bool vertical = t < 2;
    const int step = (t & 1) ? -1 : 1;  // dy for t 0, 1; dx for t 2, 3
    float v = 0.f;  // the alignment gaps between tables hold 0
    if (r < (int64_t)Hp * Wp) {
      const int y = (int)(r / Wp), xs = (int)(r - (int64_t)y * Wp);
      if (y < H && xs < W) {
        const int x = xrev ? W - 1 - xs : xs;
        const float a = x0[(int64_t)y * W + x];
        float b;
        if (vertical)
          b = x0[(int64_t)min(max(y - step, 0), H - 1) * W + x];
        else
          b = x0[(int64_t)y * W + min(max(x - step, 0), W - 1)];
        v = fabsf(__fsub_rn(a, b));
      }
    } else if (r >= n_d1 && r - n_d1 < (int64_t)Hp * gw) {
      const int64_t g = r - n_d1;
      const int y = (int)(g / gw), j = (int)(g - (int64_t)y * gw);
      v = 10.f;
      if (y < H && j < core) {
        const int x = (xrev ? core - 1 - j : j) - D;
        if (x >= 0 && x < W) {
          const float a = x1[(int64_t)y * W + x];
          if (vertical) {
            const int yy = ((y - step) % H + H) % H;
            v = fabsf(__fsub_rn(a, x1[(int64_t)yy * W + x]));
          } else if (x - step >= 0 && x - step < W) {
            v = fabsf(__fsub_rn(a, x1[(int64_t)y * W + x - step]));
          }
        }
      }
    }
    out[i] = v;
  }
}

}  // namespace

// x0, x1: (H, W) float32; out: 4 * stride float32 (the layout above).
// Returns cudaGetLastError().
extern "C" int sgm_tables_launch(const float* x0, const float* x1, float* out,
                                 int H, int W, int D, int Hp, int Wp, int gw,
                                 long long n_d1, long long stride, int xrev,
                                 cudaStream_t stream) {
  const int64_t total = 4 * (int64_t)stride;
  const int64_t blocks = (total + NT - 1) / NT;
  sgm_tables_kernel<<<(int)(blocks < 65536 ? blocks : 65536), NT, 0,
                      stream>>>(x0, x1, out, H, W, D, Hp, Wp, gw, n_d1,
                                stride, xrev);
  return (int)cudaGetLastError();
}
