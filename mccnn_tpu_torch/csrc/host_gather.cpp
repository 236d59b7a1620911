// The host window gather of training: (n, WIN, WIN) float32 windows
// src[i][oy[i] : oy[i] + WIN, ox[i] : ox[i] + WIN] of n row-major float32
// images src[i] of h[i] x w[i], zero wherever a window leaves its frame,
// on every side (past the far edge too). Host C++ with a plain C
// interface, built by g++ (mccnn_tpu_torch/ops/_build.py) and bound with
// ctypes (mccnn_tpu_torch/ops/host_gather.py); the counterpart of the JAX
// package's native gather_windows (native/mccnn_native.cpp), threaded the
// same way: the windows split into one contiguous range a thread.
//
// A tap outside the frame is the clipped in-frame value times 0.0f, as the
// numpy gather's mask multiplies it (train/augment.py _gather_windows), so
// the two agree bit for bit, the sign of a zero included.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void gather_range(int64_t lo, int64_t hi, const float *const *src,
                  const int64_t *h, const int64_t *w, const int64_t *oy,
                  const int64_t *ox, int64_t win, float *out) {
    for (int64_t i = lo; i < hi; i++) {
        const float *img = src[i];
        const int64_t H = h[i], W = w[i], x0 = ox[i];
        float *dst = out + i * win * win;
        // the window's columns inside the frame: [in_lo, in_hi)
        const int64_t in_lo = std::clamp<int64_t>(-x0, 0, win);
        const int64_t in_hi = std::clamp<int64_t>(W - x0, in_lo, win);
        for (int64_t r = 0; r < win; r++) {
            const int64_t y = oy[i] + r;
            const bool row_in = y >= 0 && y < H;
            const float *srow = img + std::clamp<int64_t>(y, 0, H - 1) * W;
            float *drow = dst + r * win;
            if (row_in && in_lo == 0 && in_hi == win) {
                std::memcpy(drow, srow + x0, win * sizeof(float));
                continue;
            }
            for (int64_t c = 0; c < win; c++) {
                const int64_t x = std::clamp<int64_t>(x0 + c, 0, W - 1);
                const bool in = row_in && c >= in_lo && c < in_hi;
                drow[c] = in ? srow[x] : srow[x] * 0.0f;
            }
        }
    }
}

}  // namespace

extern "C" int host_gather_windows(int64_t n, const float *const *src,
                                   const int64_t *h, const int64_t *w,
                                   const int64_t *oy, const int64_t *ox,
                                   int32_t win, float *out,
                                   int32_t n_threads) {
    if (n < 0 || win <= 0) return 1;
    for (int64_t i = 0; i < n; i++)
        if (src[i] == nullptr || h[i] <= 0 || w[i] <= 0) return 2;
    int64_t nt = n_threads > 0 ? n_threads
                               : std::max(1u, std::thread::hardware_concurrency());
    nt = std::max<int64_t>(1, std::min(nt, n));
    const int64_t chunk = (n + nt - 1) / nt;
    std::vector<std::thread> threads;
    for (int64_t t = 1; t < nt; t++) {
        const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(gather_range, lo, hi, src, h, w, oy, ox,
                             (int64_t)win, out);
    }
    gather_range(0, std::min(n, chunk), src, h, w, oy, ox, win, out);
    for (auto &th : threads) th.join();
    return 0;
}
