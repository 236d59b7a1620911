// SGM sweeps: one recurrence, five entries, two kernels.
//
// Replaces five TPU kernels of mccnn_tpu/ops/sgm.py:
//   _sweep_stream_vslab  (vertical sweeps, sgm_dir 2 down and 3 up:
//                         steps are rows y, scanlines are columns x)
//   _sweep_stream_hnat   (horizontal sweeps on the disparity-minor
//                         (Hp, Wp, Dp) volume, sgm_dir 0 right and 1 left:
//                         steps are columns x, scanlines are rows y, with
//                         the fused winner-take-all of the last one)
//   _sweep_stream_hslab  (horizontal sweeps of the generic lane on the
//                         step-major (W, S, Dp) volume: step x, scanline s)
//   _sweep_stream        (the scan form: one generic directional sweep over
//                         pre-built (T, S, D) slices of the volume, a (T, S)
//                         D1 table and a built (T, S, D) D2 table, the whole
//                         sweep in one launch)
//   _sweep_grid          (the same function, one sweep step per sequential
//                         grid iteration; on this card the grid's sequential
//                         axis is the kernel's step loop, so it is the same
//                         launch)
// With d fastest in every layout, one step of one scanline is one
// contiguous row. The vertical entry serves both lanes: the (Hp, Wp, Dp)
// volume of one direction, and the generic lane's (H, 2W, Dp) volume with
// both reference directions stacked on the scanline axis.
//
// Per step (sgm.py:116-124, the reference's sgm2, adcensus.cu:535-697):
//   pm   = min_d prev               (NaN taken as +inf)
//   cost = fminf(prev, pm + P2)
//   cost = fminf(cost, prev[d-1] + P1a)   (+inf below d = 0)
//   cost = fminf(cost, prev[d+1] + P1b)   (+inf above d = Dp-1)
//   val  = vol + cost - pm
// fminf ignores NaN like jnp.fmin, so NaN (out-of-frame) disparities drop
// out of the neighbour coupling. The penalty class (0: D1 and D2 below
// tau, 2: both above, else 1) picks one (P1a, P1b, P2) triple from a
// table the host computes in float32 exactly as _penalties3 does. D1 is
// one value a cell. D2 is one lane-contiguous row slice, g[row, col + d]:
//   vertical:   row = step y; col = D + x, x the scanline's column within
//               its direction (scanlines < n_rev read the table g_rev,
//               which the host lane-reverses for x-reversed storage; the
//               others g_nat, with x counted from n_rev);
//   horizontal: row = scanline; col = D + x;
//   hslab:      row = scanline; col = D + x on natural scanlines and
//               rev_base - x on the first n_rev ones (the -1 direction's,
//               whose rows the host lane-reverses: g[x - d + D] equals
//               rev(g)[rev_base - x + d] at rev_base = W + D - 1): the
//               window slides one float along its own row a step;
//   scan form:  the built table, d2[cell, d], laid out as the volume.
// The scan form's rows are D floats; its entries take a row pitch ld, a
// multiple of 4 (D itself when D % 4 == 0), whose lanes d >= D hold NaN
// in the volume, as a pad lane does in the other layouts, so neighbours
// outside [0, D) never couple.
//
// Storage (the HWD lane's two entries, sgm_sweep_vertical and
// sgm_sweep_horizontal): the volume, the accumulator and the output are
// float32, bfloat16 or float16 (the JAX package's -vol_dtype), a template
// argument of the kernel (a run-time layout field in the step loop cost
// 6-7%, see below). A 16-bit row is read as 8 bytes a lane and widened to
// float32; the recurrence state stays the unrounded float32 value; the sum
// val + acc is formed in float32, the winner map taken from it, and only
// the stored sum rounds (to nearest even), as in _sweep_stream_vslab and
// _sweep_stream_hnat (sgm.py:640-690, :878-891). The other three entries
// take float32 only.
//
// Steps: n_steps stored steps, of which the first T are real. Steps
// s >= T pass the volume through and leave the state alone; the state
// starts at step 0 (forward) or T-1 (reverse), so a reverse sweep starts
// on the last real step, and every step is read and written at its stored
// position. Output: out = val (+ acc), in place when out == acc; out may
// be null (no volume write). wta, if given, receives the argmin over d of
// the written sum (NaN as +inf, ties to the lowest d).
//
// Bound on the H100: a sweep with an accumulator reads the volume and the
// accumulator and writes the sum, over the real cells only (the pad lanes
// and rows are layout, not work): 3 x 414 MB for one direction at KITTI
// size (370 x 1226 x 228 f32; 0.37 ms at 3.35 TB/s), 3 x 827 MB for the
// generic lane's two stacked directions (0.74 ms); a scan-form sweep reads
// the volume and the D2 table in the accumulator's place. A 16-bit volume
// halves those bytes (0.19 ms for one direction at KITTI size). The arithmetic
// (about ten f32 operations per cell) is far below the f32 peak. The
// recurrence is a chain of n_steps dependent steps per scanline, each
// ending in a min over d.
//
// Both kernels run one warp per scanline (warp_step: no block barrier,
// the min over d by one redux.sync) and stream their rows through rings
// of shared-memory chunks filled by bulk asynchronous copies, so that
// tens of kilobytes per SM are in flight:
// - sgm_sweep_horizontal (hsweep_kernel): 384 scanlines at KITTI size,
//   under one wave; a ring of multi-step chunks per scanline, whose steps
//   are contiguous rows.
// - sgm_sweep_vertical, sgm_sweep_hslab and the scan form's sgm_sweep_scan
//   and sgm_sweep_step (vsweep_kernel, one template instance each but for
//   the last two, which share one): the step-major layout, where the rows
//   of adjacent scanlines at one step are one contiguous run; a block of
//   VW warps shares a ring of short chunks, one bulk copy a step and
//   input, and the host sizes the ring so that every scanline is resident
//   in one wave (vertical_plan). The uses differ only in where a warp's D2
//   lies, a template argument (D2Src): a run-time layout field in the step
//   loop cost every sweep 6-7% on the H100.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

struct Pen {
  float v[9];  // class c: (P1a, P1b, P2) at v[3c .. 3c+2]
};

namespace {

// ---- the HWD lane's horizontal sweep: a kernel of its own ------------------
//
// Its only layout assumption: the steps of one scanline are contiguous rows
// of Dp values (row y of the (Hp, Wp, Dp) volume is one run of Wp * Dp
// values), so a chunk of HK steps is one contiguous run of HK * Dp values.

constexpr int HK = 8;       // steps per chunk
constexpr int HSTAGES = 4;  // chunks in the ring, at most

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk asynchronous copy global -> shared (the TMA unit's 1-D copy):
// bytes a multiple of 16, both addresses 16-byte aligned; completion is
// counted on the mbarrier.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A map float -> unsigned that keeps the order (no NaN comes in), so that
// one redux.sync min does a warp's min exactly; key_float is its inverse.
__device__ __forceinline__ unsigned float_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The penalty class of a cell (0: D1 and D2 below tau, 2: both above,
// else 1) resolved as far as the step allows: D1 is the same for every d
// of a step, so the step picks the triple (P1a, P1b, pm + P2) that applies
// where D2 lies on D1's side of tau (`agree`), and the mixed class's
// triple applies elsewhere. relax_step then does the recurrence's
// operations in its order.
struct StepPen {
  float a1, b1, p2;   // D2 on D1's side of tau
  float am, bm, pm2;  // the mixed class
  bool lt, gt;        // D1 < tau, D1 > tau
};

__device__ __forceinline__ StepPen step_pen(float D1, float pm, float tau,
                                            const Pen& pen) {
  StepPen sp;
  sp.lt = D1 < tau;
  sp.gt = D1 > tau;
  sp.a1 = sp.lt ? pen.v[0] : pen.v[6];
  sp.b1 = sp.lt ? pen.v[1] : pen.v[7];
  sp.p2 = pm + (sp.lt ? pen.v[2] : pen.v[8]);
  sp.am = pen.v[3];
  sp.bm = pen.v[4];
  sp.pm2 = pm + pen.v[5];
  return sp;
}

__device__ __forceinline__ float relax_step(float prev, float pm, float up,
                                            float dn, float v, float D2, float tau,
                                            const StepPen& sp) {
  const bool agree = sp.lt ? D2 < tau : (sp.gt && D2 > tau);
  float cost = fminf(prev, agree ? sp.p2 : sp.pm2);
  cost = fminf(cost, up + (agree ? sp.a1 : sp.am));
  cost = fminf(cost, dn + (agree ? sp.b1 : sp.bm));
  return (v + cost) - pm;
}

// Four consecutive values of a row stored as T, widened to float32: one
// 16-byte load for float32, one 8-byte load for a 16-bit type.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);

template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

template <>
__device__ __forceinline__ float4 load4<__half>(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// v rounded to T (to nearest even; a NaN stays a NaN) at p: the
// counterpart of load4.
template <typename T>
__device__ __forceinline__ void store4(T* p, const float4& v);

template <>
__device__ __forceinline__ void store4<float>(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, const float4& v) {
  uint2 u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u.x) : "f"(v.y), "f"(v.x));
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u.y) : "f"(v.w), "f"(v.z));
  *reinterpret_cast<uint2*>(p) = u;
}

template <>
__device__ __forceinline__ void store4<__half>(__half* p, const float4& v) {
  uint2 u;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(u.x) : "f"(v.y), "f"(v.x));
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(u.y) : "f"(v.w), "f"(v.z));
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// One step of a warp-per-scanline sweep (hsweep_kernel, vsweep_kernel):
// lane l holds d = 4 (l + 32 q) + e of the state prev and of the step's
// volume row v, and D2 of its disparities in d2. A real step (s < T)
// starts the state at s == init or advances it, and v takes the state; a
// pad step leaves both. The min over d is in-register fminf, then one
// redux.sync on order-keeping keys (exact); the d +- 1 neighbours across
// float4s come by two rotating shuffles a group.
template <int NG>
__device__ __forceinline__ void warp_step(float (&prev)[NG][4], float4 (&v)[NG],
                                          const float (&d2)[NG][4], float D1,
                                          bool real, bool init, int lane, int Dp,
                                          float tau, const Pen& pen) {
  const float INF = __int_as_float(0x7f800000);
  const unsigned FULL = 0xffffffffu;
  if (!real) return;  // a pad step: the volume passes through, the state stays
  if (init) {
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      prev[q][0] = v[q].x;
      prev[q][1] = v[q].y;
      prev[q][2] = v[q].z;
      prev[q][3] = v[q].w;
    }
  } else {
    float m = INF;  // fminf drops NaN: NaN counts as +inf
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) m = fminf(m, prev[q][e]);
    const float pm = key_float(__reduce_min_sync(FULL, float_key(m)));
    const StepPen sp = step_pen(D1, pm, tau, pen);
    float ru[NG], rd[NG];  // the lane below's last d, the lane above's first
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      ru[q] = __shfl_sync(FULL, prev[q][3], (lane + 31) & 31);
      rd[q] = __shfl_sync(FULL, prev[q][0], (lane + 1) & 31);
    }
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const int d0 = 4 * (lane + 32 * q);
      float up = lane > 0 ? ru[q] : (q > 0 ? ru[q > 0 ? q - 1 : 0] : INF);
      float dn = lane < 31 ? rd[q] : (q < NG - 1 ? rd[q < NG - 1 ? q + 1 : q] : INF);
      if (d0 + 3 == Dp - 1) dn = INF;
      const float n0 = relax_step(prev[q][0], pm, up, prev[q][1], v[q].x, d2[q][0], tau, sp);
      const float n1 = relax_step(prev[q][1], pm, prev[q][0], prev[q][2], v[q].y, d2[q][1], tau, sp);
      const float n2 = relax_step(prev[q][2], pm, prev[q][1], prev[q][3], v[q].z, d2[q][2], tau, sp);
      const float n3 = relax_step(prev[q][3], pm, prev[q][2], dn, v[q].w, d2[q][3], tau, sp);
      prev[q][0] = n0;
      prev[q][1] = n1;
      prev[q][2] = n2;
      prev[q][3] = n3;
    }
  }
#pragma unroll
  for (int q = 0; q < NG; ++q)
    v[q] = make_float4(prev[q][0], prev[q][1], prev[q][2], prev[q][3]);
}

// The winner of a warp's row v: the least value (NaN counts as +inf, -0
// as +0), then the least d that has it; in the lane first, then across
// the warp by two redux.sync.
template <int NG>
__device__ __forceinline__ unsigned warp_winner(const float4 (&v)[NG], int lane) {
  const float INF = __int_as_float(0x7f800000);
  const unsigned FULL = 0xffffffffu;
  float m = INF;
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) m = fminf(m, lane_of(v[q], e));
  unsigned bi = 4 * lane;
#pragma unroll
  for (int q = NG - 1; q >= 0; --q)
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const float x = lane_of(v[q], e);
      if ((isnan(x) ? INF : x) == m) bi = 4 * (lane + 32 * q) + e;
    }
  const unsigned bk = float_key(m + 0.f);
  const unsigned best = __reduce_min_sync(FULL, bk);
  return __reduce_min_sync(FULL, bk == best ? bi : 0xffffffffu);
}

// One warp (one block) per scanline, NG = ceil(Dp / 128) groups of four
// disparities a lane: lane l holds d = 4 (l + 32 g) + e, e < 4, g < NG (one
// float4 per group, consecutive lanes on consecutive float4s: coalesced, no
// bank conflicts); each step is warp_step, the fused winner map
// warp_winner. No __syncthreads and no shared row. The
// inputs (volume and accumulator rows) arrive in chunks of HK steps through
// a ring of `stages` buffers filled by cp.async.bulk, one "full" mbarrier a
// stage; lane 0 starts a chunk's copies `stages` chunks ahead, right after
// the chunk that held the buffer was consumed, so (stages - 1) chunks a
// scanline are in flight whatever the compute does. The scanline's D2 row
// lives in shared memory for the whole sweep; D1 of a chunk sits in one
// register a lane, loaded a chunk ahead. The sum goes out by coalesced
// 16-byte stores; in place (out == acc) is safe because a chunk is written
// only after its copy has landed.
template <int NG, typename S>
__global__ void __launch_bounds__(32)
    hsweep_kernel(const S* __restrict__ vol, const S* acc, S* out,
                  float* __restrict__ wta, const float* __restrict__ d1,
                  const float* __restrict__ g, int n_steps, int Dp, int D, int T,
                  int reverse, int gw, float tau, Pen pen, int stages) {
  extern __shared__ __align__(128) unsigned char hs_raw[];
  const float QNAN = __int_as_float(0x7fc00000);
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  const int scan = blockIdx.x;
  const int init = reverse ? T - 1 : 0;
  const bool has_acc = acc != nullptr;
  const int chunk_floats = HK * Dp;  // values of one input a chunk
  const int stage_floats = chunk_floats * (has_acc ? 2 : 1);
  const int n_chunks = (n_steps + HK - 1) / HK;
  const size_t row = (size_t)scan * n_steps;  // cell of step 0

  S* ring = reinterpret_cast<S*>(hs_raw);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(ring + (size_t)stages * stage_floats);
  float* gs = reinterpret_cast<float*>(bars + HSTAGES);

  // chunk c in sweep order covers the stored steps [lo, lo + cnt)
  auto chunk_lo = [&](int c) { return (reverse ? n_chunks - 1 - c : c) * HK; };
  auto fetch = [&](int c) {  // lane 0
    const int lo = chunk_lo(c);
    const unsigned bytes = (unsigned)(min(HK, n_steps - lo) * Dp) * (unsigned)sizeof(S);
    const int st = c % stages;
    const unsigned bar = smem_addr(bars + st);
    const unsigned dst = smem_addr(ring + (size_t)st * stage_floats);
    mbar_expect_tx(bar, has_acc ? 2 * bytes : bytes);
    bulk_load(dst, vol + (row + lo) * Dp, bytes, bar);
    if (has_acc)
      bulk_load(dst + chunk_floats * (unsigned)sizeof(S), acc + (row + lo) * Dp, bytes,
                bar);
  };
  // D1 of the chunk's step lo + lane (lanes >= cnt: unused)
  auto d1_of = [&](int c) {
    if (c >= n_chunks) return 0.f;
    const int s = chunk_lo(c) + lane;
    return (lane < HK && s < n_steps) ? d1[row + s] : 0.f;
  };

  if (lane == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(smem_addr(bars + st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  if (lane == 0)
    for (int c = 0; c < stages && c < n_chunks; ++c) fetch(c);
  // the scanline's D2 window: gs[s + d] = g[scan, D + s + d]
  for (int i = lane; i < n_steps + Dp; i += 32) gs[i] = g[(size_t)scan * gw + D + i];
  float d1n = d1_of(0);
  __syncwarp();

  bool live[NG];  // a lane's float4 lies inside the row (Dp need not be NG * 128)
#pragma unroll
  for (int q = 0; q < NG; ++q) live[q] = 4 * (lane + 32 * q) < Dp;

  float prev[NG][4];
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) prev[q][e] = QNAN;

  for (int c = 0; c < n_chunks; ++c) {
    const int lo = chunk_lo(c);
    const int cnt = min(HK, n_steps - lo);
    const float d1c = d1n;
    d1n = d1_of(c + 1);
    const int st = c % stages;
    mbar_wait(smem_addr(bars + st), (unsigned)(c / stages) & 1u);
    const S* sv = ring + (size_t)st * stage_floats;
    const S* sa = sv + chunk_floats;

#pragma unroll 2
    for (int i = 0; i < cnt; ++i) {
      const int j = reverse ? cnt - 1 - i : i;
      const int s = lo + j;
      float4 v[NG], a[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const int f = lane + 32 * q;
        v[q] = make_float4(QNAN, QNAN, QNAN, QNAN);
        a[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live[q]) {
          v[q] = load4<S>(sv + j * Dp + 4 * f);
          if (has_acc) a[q] = load4<S>(sa + j * Dp + 4 * f);
        }
      }
      const float D1 = __shfl_sync(FULL, d1c, j);
      float d2[NG][4];
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d2[q][e] = gs[s + (live[q] ? 4 * (lane + 32 * q) : 0) + e];  // dead lanes: any
      warp_step<NG>(prev, v, d2, D1, s < T, s == init, lane, Dp, tau, pen);

#pragma unroll
      for (int q = 0; q < NG; ++q) {
        if (has_acc) {
          v[q].x += a[q].x;
          v[q].y += a[q].y;
          v[q].z += a[q].z;
          v[q].w += a[q].w;
        }
        if (out && live[q]) store4<S>(out + (row + s) * Dp + 4 * (lane + 32 * q), v[q]);
      }
      if (wta) {
        const unsigned at = warp_winner<NG>(v, lane);
        if (lane == 0) wta[row + s] = (float)at;
      }
    }

    // every lane has read the buffer: it takes the chunk `stages` ahead
    __syncwarp();
    if (lane == 0 && c + stages < n_chunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(c + stages);
    }
  }
}

template <int NG, typename S>
int launch_hsweep(const S* vol, const S* acc, S* out, float* wta, const float* d1,
                  const float* g, int n_scan, int n_steps, int Dp, int D, int T,
                  int reverse, int gw, float tau, Pen pen, cudaStream_t stream) {
  // the ring as deep as HSTAGES if that leaves room for three blocks on an
  // SM (72 KB each), at least two chunks deep
  const size_t stage = (size_t)HK * Dp * sizeof(S) * (acc ? 2 : 1);
  const size_t fixed = HSTAGES * 8 + (size_t)(n_steps + Dp) * 4;
  int stages = HSTAGES;
  while (stages > 2 && stages * stage + fixed > 72 * 1024) --stages;
  const size_t smem = stages * stage + fixed;
  cudaError_t err = cudaFuncSetAttribute(
      hsweep_kernel<NG, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  hsweep_kernel<NG, S><<<n_scan, 32, smem, stream>>>(vol, acc, out, wta, d1, g,
                                                     n_steps, Dp, D, T, reverse, gw,
                                                     tau, pen, stages);
  return (int)cudaGetLastError();
}

// ---- the step-major sweeps: vertical, hslab and the scan form -------------
//
// Step-major layout: step y of scanline x is the row at (y * Ws + x) * Dp,
// so the rows of VW adjacent scanlines at one step are one contiguous run
// of VW * Dp floats (4 KB at Dp = 256). Dp need only be a multiple of 4 (a
// float4 a lane, 16-byte bulk copies). A block is VW warps on VW adjacent
// scanlines of one class (reversed, x < n_rev, or natural): the host plans
// the blocks of each class apart, so no block straddles n_rev, and a ragged
// last block has dead warps that leave after the set-up. Each warp runs
// warp_step on its scanline (NG float4 groups a lane), with no block
// barrier in the step loop. The block's rows arrive in chunks of VK steps
// through a ring of `stages` buffers, each of the volume's part and, where
// the sweep has one, a second part: one cp.async.bulk per step and input,
// one "full" mbarrier a stage; an "empty" mbarrier a stage collects one
// arrival per live warp, and lane 0 of warp 0 refills the stage with the
// chunk `stages` ahead once all have read it. Where D2 comes from is the
// template argument D2Src:
// - COLUMN (the vertical entry) and ROW (the hslab entry): D1 and the
//   warp's own D2 window (any alignment, served from L1) are plain loads
//   one step ahead, g[y, D + x + d] in the vertical entry, where the
//   block's windows overlap within a step, or the scanline's own row,
//   g[x, D + y + d] or g[x, rev_base - y + d], where a window overlaps the
//   previous step's but for one float; the second part of the ring holds
//   the accumulator, if any.
// - TABLE (the scan form): the built D2 table has the volume's layout and
//   size and is read once, so it streams through the ring's second part
//   (the scan form has no accumulator); D1 is a plain load one step ahead.
// The sum goes out by coalesced 16-byte stores; in place (out == acc) is
// safe because a chunk's rows are written only after its copy has landed.
//
// Sizing: 1280 scanlines (one direction at KITTI size), 2452 (the generic
// lane's two stacked vertical directions) or 740 (its two stacked
// horizontal ones) are 5.6 to 19 warps an SM, so the host (vertical_plan)
// first counts the blocks an SM must hold for every scanline to be
// resident in one wave, then gives each block an equal share of the SM's
// shared memory for its ring, whose chunks are short (VK steps) so that
// even five blocks an SM keep a chunk each in flight.

constexpr int VW = 4;        // scanlines (warps) per block
constexpr int VK = 2;        // steps per chunk
constexpr int VSTAGES = 8;   // chunks in the ring, at most
constexpr int SM_SMEM = 233472;     // shared memory of an H100 SM
constexpr int BLOCK_RESERVED = 1024;  // of it, kept by the card per block

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

struct VPlan {
  int rev_blocks;  // blocks of the reversed class, x in [0, n_rev)
  int blocks;      // all blocks
  int per_sm;      // blocks an SM holds at once for one wave
  int stages;      // chunks in the ring
  int smem;        // bytes of dynamic shared memory a block
};

// The blocks and the ring of the step-major sweeps for Ws scanlines of
// values of `elem` bytes, the ring with a second part (the accumulator or
// the scan form's D2 table) where has_acc (mirrored by ops/sgm.py
// vertical_plan, which the tests check; a CUDA test holds the mirror
// against this plan through sgm_vertical_plan). A 16-bit volume fits
// twice the chunks of the same length in the same shared memory.
VPlan vertical_plan(int Ws, int n_rev, int Dp, bool has_acc, int elem, int n_sm) {
  VPlan p;
  p.rev_blocks = (n_rev + VW - 1) / VW;
  p.blocks = p.rev_blocks + (Ws - n_rev + VW - 1) / VW;
  p.per_sm = (p.blocks + n_sm - 1) / n_sm;
  const int budget = SM_SMEM / p.per_sm - BLOCK_RESERVED;
  const int bars = 2 * VSTAGES * 8;
  const int chunk = VK * VW * Dp * elem * (has_acc ? 2 : 1);
  p.stages = budget > bars ? (budget - bars) / chunk : 0;
  if (p.stages > VSTAGES) p.stages = VSTAGES;
  if (p.stages < 2) p.stages = 2;  // a huge Dp: fewer blocks resident
  p.smem = p.stages * chunk + bars;
  return p;
}

// Where a warp of vsweep_kernel reads D2 (see above).
enum class D2Src { COLUMN, ROW, TABLE };

template <int NG, D2Src SRC, typename S>
__global__ void __launch_bounds__(VW * 32, NG <= 2 ? 5 : 1)
    vsweep_kernel(const S* __restrict__ vol, const S* acc, S* out,
                  float* __restrict__ wta, const float* __restrict__ d1,
                  const float* __restrict__ g_rev,
                  const float* __restrict__ g_nat, int Ws, int n_steps, int Dp,
                  int D, int T, int reverse, int gw, int n_rev, int rev_base,
                  int rev_blocks, float tau, Pen pen, int stages) {
  constexpr bool TABLE = SRC == D2Src::TABLE;
  static_assert(!TABLE || std::is_same<S, float>::value, "the scan form is float32");
  extern __shared__ __align__(128) unsigned char vs_raw[];
  const float QNAN = __int_as_float(0x7fc00000);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool rev = (int)blockIdx.x < rev_blocks;
  const int x0 = rev ? blockIdx.x * VW : n_rev + (blockIdx.x - rev_blocks) * VW;
  const int nw = min(VW, (rev ? n_rev : Ws) - x0);  // live warps
  const int x = x0 + warp;
  const int init = reverse ? T - 1 : 0;
  const bool has_acc = !TABLE && acc != nullptr;
  // the ring's second part: the accumulator, or the scan form's D2 table
  const S* second = TABLE ? reinterpret_cast<const S*>(g_rev) : acc;
  const bool two = TABLE || has_acc;
  const int row_floats = VW * Dp;            // one step of the block
  const int part = VK * row_floats;          // a chunk of one input
  const int stage_floats = part * (two ? 2 : 1);
  const int n_chunks = (n_steps + VK - 1) / VK;

  S* ring = reinterpret_cast<S*>(vs_raw);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + (size_t)stages * stage_floats);
  unsigned long long* empty = full + VSTAGES;

  // chunk c in sweep order covers the stored steps [lo, lo + cnt)
  auto chunk_lo = [&](int c) { return (reverse ? n_chunks - 1 - c : c) * VK; };
  auto fetch = [&](int c) {  // lane 0 of warp 0
    const int lo = chunk_lo(c);
    const int cnt = min(VK, n_steps - lo);
    const unsigned bytes = (unsigned)(nw * Dp) * (unsigned)sizeof(S);
    const int st = c % stages;
    const unsigned bar = smem_addr(full + st);
    S* dst = ring + (size_t)st * stage_floats;
    mbar_expect_tx(bar, cnt * bytes * (two ? 2u : 1u));
    for (int j = 0; j < cnt; ++j) {
      const size_t src = ((size_t)(lo + j) * Ws + x0) * Dp;
      bulk_load(smem_addr(dst + j * row_floats), vol + src, bytes, bar);
      if (two)
        bulk_load(smem_addr(dst + part + j * row_floats), second + src, bytes, bar);
    }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(smem_addr(full + st), 1);
      mbar_init(smem_addr(empty + st), nw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < stages && c < n_chunks; ++c) fetch(c);
  }
  __syncthreads();
  if (warp >= nw) return;  // a dead warp of a ragged block

  bool live[NG];  // a lane's float4 lies inside the row (Dp need not be NG * 128)
#pragma unroll
  for (int q = 0; q < NG; ++q) live[q] = 4 * (lane + 32 * q) < Dp;

  // D1 and (COLUMN, ROW) the D2 window of a step, loaded one step ahead;
  // ROW: g_rev is g_nat, one row a scanline
  const float* g = SRC == D2Src::ROW
                       ? g_rev + (size_t)x * gw + (rev ? rev_base : D)
                       : (rev ? g_rev : g_nat) + D + (rev ? x : x - n_rev);
  float nd1, nd2[NG][4];
  auto load_pen = [&](int s) {
    nd1 = d1[(size_t)s * Ws + x];
    if constexpr (!TABLE) {
      const float* gr = SRC == D2Src::ROW ? g + (rev ? -s : s) : g + (size_t)s * gw;
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          nd2[q][e] = live[q] ? gr[4 * (lane + 32 * q) + e] : 0.f;
    }
  };
  load_pen(reverse ? n_steps - 1 : 0);

  float prev[NG][4];
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) prev[q][e] = QNAN;

  for (int c = 0; c < n_chunks; ++c) {
    const int lo = chunk_lo(c);
    const int cnt = min(VK, n_steps - lo);
    const int st = c % stages;
    mbar_wait(smem_addr(full + st), (unsigned)(c / stages) & 1u);
    const S* sv = ring + (size_t)st * stage_floats + warp * Dp;
    const S* sa = sv + part;

    for (int i = 0; i < cnt; ++i) {
      const int j = reverse ? cnt - 1 - i : i;
      const int s = lo + j;
      const float D1 = nd1;
      float D2[NG][4];  // TABLE: from the ring, below
      if constexpr (!TABLE) {
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) D2[q][e] = nd2[q][e];
      }
      const int s_next = reverse ? s - 1 : s + 1;
      if (s_next >= 0 && s_next < n_steps) load_pen(s_next);

      float4 v[NG], a[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const int f = lane + 32 * q;
        v[q] = make_float4(QNAN, QNAN, QNAN, QNAN);
        a[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live[q]) {
          v[q] = load4<S>(sv + j * row_floats + 4 * f);
          if (two) a[q] = load4<S>(sa + j * row_floats + 4 * f);
        }
        if constexpr (TABLE) {  // dead lanes: any D2
          D2[q][0] = a[q].x;
          D2[q][1] = a[q].y;
          D2[q][2] = a[q].z;
          D2[q][3] = a[q].w;
        }
      }

      warp_step<NG>(prev, v, D2, D1, s < T, s == init, lane, Dp, tau, pen);

      const size_t cell = (size_t)s * Ws + x;
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        if (has_acc) {
          v[q].x += a[q].x;
          v[q].y += a[q].y;
          v[q].z += a[q].z;
          v[q].w += a[q].w;
        }
        if (out && live[q]) store4<S>(out + cell * Dp + 4 * (lane + 32 * q), v[q]);
      }
      if (wta) {
        const unsigned at = warp_winner<NG>(v, lane);
        if (lane == 0) wta[cell] = (float)at;
      }
    }

    // this warp has read the stage; once every live warp has, warp 0 gives
    // it the chunk `stages` ahead
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(empty + st));
    if (warp == 0 && lane == 0 && c + stages < n_chunks) {
      mbar_wait(smem_addr(empty + st), (unsigned)(c / stages) & 1u);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(c + stages);
    }
    __syncwarp();
  }
}

template <int NG, D2Src SRC, typename S>
int launch_vsweep(const S* vol, const S* acc, S* out, float* wta, const float* d1,
                  const float* g_rev, const float* g_nat, int n_steps, int Ws, int Dp,
                  int D, int T, int reverse, int gw, int n_rev, int rev_base,
                  float tau, Pen pen, cudaStream_t stream) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const VPlan p = vertical_plan(Ws, n_rev, Dp, SRC == D2Src::TABLE || acc != nullptr,
                                (int)sizeof(S), n_sm);
  err = cudaFuncSetAttribute(vsweep_kernel<NG, SRC, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(vsweep_kernel<NG, SRC, S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  vsweep_kernel<NG, SRC, S><<<p.blocks, VW * 32, p.smem, stream>>>(
      vol, acc, out, wta, d1, g_rev, g_nat, Ws, n_steps, Dp, D, T, reverse, gw,
      n_rev, rev_base, p.rev_blocks, tau, pen, p.stages);
  return (int)cudaGetLastError();
}

// vsweep_kernel<NG, SRC, S> for NG = ceil(Dp / 128) groups, Dp <= 1024
template <D2Src SRC, typename S = float>
int vsweep(const S* vol, const S* acc, S* out, float* wta, const float* d1,
           const float* g_rev, const float* g_nat, int n_steps, int Ws, int Dp,
           int D, int T, int reverse, int gw, int n_rev, int rev_base, float tau,
           Pen pen, cudaStream_t stream) {
  if (n_steps == 0 || Ws == 0) return 0;
#define VSWEEP(NG)                                                             \
  case NG:                                                                     \
    return launch_vsweep<NG, SRC, S>(vol, acc, out, wta, d1, g_rev, g_nat,     \
                                     n_steps, Ws, Dp, D, T, reverse, gw,       \
                                     n_rev, rev_base, tau, pen, stream)
  switch ((Dp + 127) / 128) {
    VSWEEP(1);
    VSWEEP(2);
    VSWEEP(3);
    VSWEEP(4);
    VSWEEP(5);
    VSWEEP(6);
    VSWEEP(7);
    VSWEEP(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VSWEEP
}

// hsweep_kernel<NG, S> for NG = ceil(Dp / 128) groups, Dp <= 1024
template <typename S>
int hsweep(const S* vol, const S* acc, S* out, float* wta, const float* d1,
           const float* g, int Hp, int Wp, int Dp, int D, int T, int reverse, int gw,
           float tau, Pen pen, cudaStream_t stream) {
  if (Hp == 0 || Wp == 0) return 0;
#define HSWEEP(NG)                                                              \
  case NG:                                                                      \
    return launch_hsweep<NG, S>(vol, acc, out, wta, d1, g, Hp, Wp, Dp, D, T,    \
                                reverse, gw, tau, pen, stream)
  switch ((Dp + 127) / 128) {
    HSWEEP(1);
    HSWEEP(2);
    HSWEEP(3);
    HSWEEP(4);
    HSWEEP(5);
    HSWEEP(6);
    HSWEEP(7);
    HSWEEP(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HSWEEP
}

// The storage codes of the HWD entries: 0 float32, 1 bfloat16, 2 float16.
#define BY_STORAGE(dtype, FN, ...)                                              \
  switch (dtype) {                                                              \
    case 0:                                                                     \
      return FN<float>(__VA_ARGS__);                                            \
    case 1:                                                                     \
      return FN<__nv_bfloat16>(__VA_ARGS__);                                    \
    case 2:                                                                     \
      return FN<__half>(__VA_ARGS__);                                           \
    default:                                                                    \
      return (int)cudaErrorInvalidValue;                                        \
  }

template <typename S>
int vertical(const void* vol, const void* acc, void* out, float* wta, const float* d1,
             const float* g_rev, const float* g_nat, int Hp, int Ws, int Dp, int D,
             int T, int reverse, int gw, int n_rev, float tau, Pen pen,
             cudaStream_t stream) {
  return vsweep<D2Src::COLUMN, S>(static_cast<const S*>(vol), static_cast<const S*>(acc),
                                  static_cast<S*>(out), wta, d1, g_rev, g_nat, Hp, Ws,
                                  Dp, D, T, reverse, gw, n_rev, 0, tau, pen, stream);
}

template <typename S>
int horizontal(const void* vol, const void* acc, void* out, float* wta,
               const float* d1, const float* g, int Hp, int Wp, int Dp, int D, int T,
               int reverse, int gw, float tau, Pen pen, cudaStream_t stream) {
  return hsweep<S>(static_cast<const S*>(vol), static_cast<const S*>(acc),
                   static_cast<S*>(out), wta, d1, g, Hp, Wp, Dp, D, T, reverse, gw, tau,
                   pen, stream);
}

}  // namespace

// Dp is a multiple of 32, at most 1024, for the three slab entries; T real
// steps; acc and out may be null and may alias each other; wta may be null.
// Each entry returns cudaGetLastError(), or cudaErrorInvalidValue for a
// row width or a storage code it does not take.

// vol, acc, out: (Hp, Ws, Dp) of the storage `dtype` (0 float32, 1
// bfloat16, 2 float16), steps the Hp rows, Ws scanline columns; wta, d1:
// (Hp, Ws) float32; g_rev, g_nat: (Hp, gw) float32 with gw >= D + Ws +
// Dp. Columns [0, n_rev) read g_rev at D + x, the others g_nat at
// D + x - n_rev (one direction: n_rev = Ws or 0).
extern "C" int sgm_sweep_vertical(const void* vol, const void* acc, void* out,
                                  float* wta, const float* d1, const float* g_rev,
                                  const float* g_nat, int Hp, int Ws, int Dp, int D,
                                  int T, int reverse, int gw, int n_rev, int dtype,
                                  float tau, Pen pen, cudaStream_t stream) {
  BY_STORAGE(dtype, vertical, vol, acc, out, wta, d1, g_rev, g_nat, Hp, Ws, Dp, D, T,
             reverse, gw, n_rev, tau, pen, stream)
}

// The plan of vsweep_kernel for Ws scanlines of values of `elem` bytes on
// a card of n_sm SMs, with the ring's second part (has_acc: an
// accumulator, or the scan form's D2 table) or without, as out =
// {rev_blocks, blocks, per_sm, stages, smem}; no kernel runs.
// sgm_sweep_vertical plans Ws columns, sgm_sweep_hslab and the scan form
// Ws = S scanlines.
extern "C" void sgm_vertical_plan(int Ws, int n_rev, int Dp, int has_acc, int elem,
                                  int n_sm, int* out) {
  const VPlan p = vertical_plan(Ws, n_rev, Dp, has_acc != 0, elem, n_sm);
  const int v[5] = {p.rev_blocks, p.blocks, p.per_sm, p.stages, p.smem};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}

// vol, acc, out: (Hp, Wp, Dp) of the storage `dtype`, steps the Wp
// columns; wta, d1: (Hp, Wp) float32; g: (Hp, gw) float32 with
// gw >= D + Wp + Dp, read at D + x.
extern "C" int sgm_sweep_horizontal(const void* vol, const void* acc, void* out,
                                    float* wta, const float* d1, const float* g,
                                    int Hp, int Wp, int Dp, int D, int T,
                                    int reverse, int gw, int dtype, float tau,
                                    Pen pen, cudaStream_t stream) {
  BY_STORAGE(dtype, horizontal, vol, acc, out, wta, d1, g, Hp, Wp, Dp, D, T, reverse,
             gw, tau, pen, stream)
}

// Step-major: vol, acc, out: (W, S, Dp) float32, steps the W columns x,
// S scanlines; d1: (W, S); g: (S, gw) with gw >= D + W + Dp, read at
// D + x on scanlines >= n_rev and at rev_base - x below (rows the host
// lane-reversed), rev_base in [W - 1, gw - Dp]; the first T steps real.
extern "C" int sgm_sweep_hslab(const float* vol, const float* acc, float* out,
                               const float* d1, const float* g, int W, int S,
                               int Dp, int D, int T, int reverse, int gw,
                               int n_rev, int rev_base, float tau, Pen pen,
                               cudaStream_t stream) {
  return vsweep<D2Src::ROW, float>(vol, acc, out, nullptr, d1, g, g, W, S, Dp, D, T,
                                   reverse, gw, n_rev, rev_base, tau, pen, stream);
}

// The scan form, the whole sweep in one launch of vsweep_kernel with the
// D2 table streamed through the ring. vol, d2, out: (T, S, ld) float32,
// T steps of S scanlines, D real disparities a row of pitch ld, a multiple
// of 4 with D <= ld <= 1024, and NaN in vol's lanes [D, ld); d1: (T, S).
// A forward sweep starts at step 0, a reverse one (reverse != 0) at step
// T - 1; every step is read and written at its stored position. out
// receives the per-step values; the first step's is the volume's.
extern "C" int sgm_sweep_scan(const float* vol, const float* d1,
                              const float* d2, float* out, int T, int S, int D,
                              int ld, int reverse, float tau, Pen pen,
                              cudaStream_t stream) {
  if (ld % 4 || D < 1 || ld < D || ld > 1024) return (int)cudaErrorInvalidValue;
  return vsweep<D2Src::TABLE, float>(vol, nullptr, out, nullptr, d1, d2, d2, T, S, ld,
                                     D, T, reverse, 0, 0, 0, tau, pen, stream);
}

// The counterpart of the TPU kernel that runs one sweep step per grid
// iteration, carrying the previous step in on-chip scratch: on this card
// that sequential axis is the step loop of one launch, so this is
// sgm_sweep_scan, with the same arguments and result.
extern "C" int sgm_sweep_step(const float* vol, const float* d1,
                              const float* d2, float* out, int T, int S, int D,
                              int ld, int reverse, float tau, Pen pen,
                              cudaStream_t stream) {
  return sgm_sweep_scan(vol, d1, d2, out, T, S, D, ld, reverse, tau, pen, stream);
}
