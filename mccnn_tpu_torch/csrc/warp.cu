// Training's patch sampling: the window gather and the bicubic warp.
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA, which
// fuses it into the scanned training chunk (mccnn_tpu/train/augment.py:90
// warp_patches and :365 gather_windows_device, called by
// mccnn_tpu/train/trainer.py:67 make_train_chunk). It is the port's
// counterpart of that fusion: one launch a step in place of the ~16 taps x
// a dozen elementwise launches of the plain torch version
// (train/augment.py warp_patches_plain).
//
// Per output (b, i, j) of the (B, ws, ws) patches, bit for bit with the
// plain version (every product and sum rounded on its own, no FMA):
//   sx = (m0*j + m1*i) + m2,  sy = (m3*j + m4*i) + m5;
//   x0 = floor(sx), t = sx - x0, the Keys cubic weights (a = -0.75) of
//   1 + t, t, 1 - t, 2 - t in the plain version's order of operations;
//   acc = +0.0, then for dy = -1..2 (outer), dx = -1..2 (inner):
//   acc = acc + ((v * wy[dy]) * wx[dx]), v the window's value at
//   (y0 + dy, x0 + dx), or 0 where that tap leaves the WIN x WIN window
//   (a NaN or an infinity read propagates, a masked one does not);
//   out = acc * contrast + brightness.
// The window is given (B, WIN, WIN) (warp_windows_launch: the Middlebury
// host gather, the data-parallel step), or read in place from the padded
// image stack Xpad (2N, Hp, Wp) at (src, oy + WIN + yy, ox + WIN + xx)
// (warp_gather_launch: KITTI), which is the plain gather's copy of the
// same value.
//
// Bound on the H100: B = 256 patches of 9 x 9 outputs at kitti fast and
// slow; ~120 f32 instructions an output (2.5 M a step, 0.07 us at the
// instruction rate) and the taps' distinct values read, ~0.2 MB (0.06 us
// at 3.35 TB/s): a launch's latency holds it. Design: one thread an
// output, a block of 128 consecutive outputs (1.6 patches), the window
// read through L1; no shared memory.
//
// Each launch adds one to a device counter (`ran`, when not null): the
// launches the card ran, which a CUDA graph's replays hide from the host.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;  // threads a block

// ((1.25 * x - 2.25) * x) * x + 1, the plain version's w1 with a = -0.75
__device__ __forceinline__ float w1(float x) {
  float r = __fmul_rn(1.25f, x);
  r = __fsub_rn(r, 2.25f);
  r = __fmul_rn(r, x);
  r = __fmul_rn(r, x);
  return __fadd_rn(r, 1.0f);
}

// ((((-0.75 * x) - -3.75) * x + -6) * x) - -3, the plain version's w2
__device__ __forceinline__ float w2(float x) {
  float r = __fmul_rn(-0.75f, x);
  r = __fsub_rn(r, -3.75f);
  r = __fmul_rn(r, x);
  r = __fadd_rn(r, -6.0f);
  r = __fmul_rn(r, x);
  return __fsub_rn(r, -3.0f);
}

__device__ __forceinline__ void cubic(float t, float w[4]) {
  w[0] = w2(__fadd_rn(t, 1.0f));
  w[1] = w1(t);
  w[2] = w1(__fsub_rn(1.0f, t));
  w[3] = w2(__fsub_rn(2.0f, t));
}

// GATHER false: win points at the (B, WIN, WIN) windows. GATHER true: at
// the (2N, hp, wp) padded stack, each patch's window at (src[b], oy[b] +
// WIN, ox[b] + WIN).
template <bool GATHER>
__global__ void __launch_bounds__(NT)
warp_kernel(const float* __restrict__ win, const int* __restrict__ src,
            const int* __restrict__ oy, const int* __restrict__ ox, int hp,
            int wp, const float* __restrict__ minv,
            const float* __restrict__ bri, const float* __restrict__ con,
            float* __restrict__ out, int B, int ws, int W,
            unsigned long long* __restrict__ ran) {
  const int n = ws * ws;
  const long long o = (long long)blockIdx.x * NT + threadIdx.x;
  if (o == 0 && ran != nullptr) atomicAdd(ran, 1ull);
  if (o >= (long long)B * n) return;
  const int b = (int)(o / n);
  const int r = (int)(o - (long long)b * n);
  const float fi = (float)(r / ws);  // the output's row
  const float fj = (float)(r % ws);  // and column
  const float* m = minv + 6 * (size_t)b;
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m), fj),
                                       __fmul_rn(__ldg(m + 1), fi)),
                             __ldg(m + 2));
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 3), fj),
                                       __fmul_rn(__ldg(m + 4), fi)),
                             __ldg(m + 5));
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  float wx[4], wy[4];
  cubic(__fsub_rn(sx, x0), wx);
  cubic(__fsub_rn(sy, y0), wy);
  const long long x0i = (long long)x0;
  const long long y0i = (long long)y0;
  const float* base;
  long long pitch;
  if (GATHER) {
    pitch = wp;
    base = win + (long long)__ldg(src + b) * hp * wp
           + ((long long)__ldg(oy + b) + W) * wp + ((long long)__ldg(ox + b) + W);
  } else {
    pitch = W;
    base = win + (long long)b * W * W;
  }
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    const long long yy = y0i + (dy - 1);
    const bool oky = yy >= 0 && yy < W;
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {
      const long long xx = x0i + (dx - 1);
      const bool ok = oky && xx >= 0 && xx < W;
      const float v = ok ? __ldg(base + yy * pitch + xx) : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v, wy[dy]), wx[dx]));
    }
  }
  out[o] = __fadd_rn(__fmul_rn(acc, __ldg(con + b)), __ldg(bri + b));
}

int blocks(int B, int ws) {
  return (int)(((long long)B * ws * ws + NT - 1) / NT);
}

}  // namespace

// windows (B, win, win), minv (B, 6), brightness and contrast (B,), out
// (B, ws, ws), all float32 and contiguous; ran: the run counter or null.
// Returns cudaGetLastError().
extern "C" int warp_windows_launch(const float* windows, const float* minv,
                                   const float* bri, const float* con,
                                   float* out, int B, int ws, int win,
                                   unsigned long long* ran, void* stream) {
  if (B > 0)
    warp_kernel<false><<<blocks(B, ws), NT, 0, (cudaStream_t)stream>>>(
        windows, nullptr, nullptr, nullptr, 0, 0, minv, bri, con, out, B, ws,
        win, ran);
  return (int)cudaGetLastError();
}

// xpad (n_img, hp, wp) float32; src, oy, ox (B,) int32 with every window
// inside the stack (0 <= src < n_img, -win <= oy <= hp - 2 win, likewise
// ox: the sampler's origins, clipped to [-win, H]); the rest as above.
extern "C" int warp_gather_launch(const float* xpad, const int* src,
                                  const int* oy, const int* ox, int hp,
                                  int wp, const float* minv, const float* bri,
                                  const float* con, float* out, int B, int ws,
                                  int win, unsigned long long* ran,
                                  void* stream) {
  if (B > 0)
    warp_kernel<true><<<blocks(B, ws), NT, 0, (cudaStream_t)stream>>>(
        xpad, src, oy, ox, hp, wp, minv, bri, con, out, B, ws, win, ran);
  return (int)cudaGetLastError();
}
