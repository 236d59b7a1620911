"""Time variants of the cost-volume, census-signature and SGM-table
kernels, and of the generic lane's layout kernels, against a build of
their source.

    python -m mccnn_tpu_torch.costs_variants [--source PATH ...]
        [--variant NAME[+NAME] ...] [--case kitti mb]
        [--kernel census ad signatures tables layout combine wta]
        [--reps 10]

On one CUDA card, from the repository's root (it takes its images, its
bound and its CUDA-graph timer from ``chip_smoke.py`` there, its build
from ``cbca_variants``): builds each source the named kernels live in,
``costs.cu`` (``census``, ``ad``, ``signatures``), ``sgm_tables.cu``
(``tables``) and ``sgm_layout.cu`` (``layout``, ``combine``, ``wta``),
by default the shipped ones under ``csrc/`` (``--source``
names another file of the same name, such as an earlier commit's
unpacked under ``build/``), and each named variant of it (text edits of
that source, ``a+b`` for several, or ``file:PATH``, another whole source
of the same file name such as the parent's; a text variant is built for
each source one of its edits matches), then times the C entries in
turns: source, variant, variant, source. The census and ad volumes
(``census_volume_launch``, ``ad_volume_launch``) by CUDA events (the
mean of ``--reps`` calls after a warm-up), the signatures and the tables
(``census_signatures_launch``, ``sgm_tables_launch``, microseconds a
call) in a CUDA graph of ``--reps`` calls (``chip_smoke.graph_ms``),
the layout kernels (``sgm_layout_launch`` of both families,
``sgm_combine_launch`` with the quarter, ``wta_dhw_launch``) by events
on both directions' census volumes of the pair (the horizontal and the
vertical family's d-minor volumes of them as the accumulators).
The inputs are the path's own: ``chip_smoke.py``'s seeded KITTI pair
(370x1226, D = 228, phase 3) and Middlebury pair (1000x1500, D = 200,
phase 3b), both directions of each volume, radius 4, the census
signatures from the package's ``census_signatures``, the tables of both
storage orders (``xrev``) on the join's padded shape. The source's build
is held bit for bit against the plain version, and a variant that keeps
the function against the source's build. Beside each case: the bytes
bound and the card's store floor, one ``fill_`` of the same output bytes
(timed as the kernel is). Prints each build's registers, stack and
spills (ptxas) for its kernels.

Variants (``l2-sig``, ``no-fast``, ``cx-1``, ``dch-*``, ``unroll-*``,
``fdiv``, ``ty-*``, ``nd-*``, ``warps-*``, ``blocks-*``, ``ax-8``,
``sig-*``, ``tab-*`` and ``div64`` keep the function):

- ``store-only``: no work, each output's store alone (census: the
  constant of a cell with no agreeing position, or NaN; ad: NaN, no
  staging, no term; signatures: zero words, no staging, no compare, in
  this source and in the first design's; tables: 0, no image read;
  layout and combine: the tile's stores, no load; wta: index 0, no
  load): the floor of the design;
- ``no-store``: all the work, no store (the compute's floor; the
  signatures' first design and this one; layout, combine, wta: the loads
  and the tile, no store);
- census ``no-fast``: no interior blocks (every cell's mask tested);
- census ``l2-sig``: the match signatures loaded from global memory a
  cell (the parent's reads) and no span staged;
- census ``cx-1``: a column a thread, 4-byte stores (2 in the source);
  ``dch-16``, ``dch-64``: disparities a block (32); ``unroll-4``,
  ``unroll-8``: the single-channel disparity loops unrolled that far
  (whole in the source);
- ad ``no-div``: the product by the reciprocal alone, no correction;
  ``fdiv``: ``__fdiv_rn`` in place of ``quotient_fast`` (the same
  bits);
- ad ``stage-only``: the block stages its tile and span and stops;
- ad ``ty-16``, ``ty-64``: rows a block (32); ``nd-8``, ``nd-32``:
  disparities a block (16); ``warps-2``, ``warps-8``: warps a block
  (4); ``blocks-5``, ``blocks-6``: launch bounds of that many resident
  blocks an SM (their registers capped to fit); ``ax-8``: 8 columns a
  lane (blocks of 256 columns; 4 in the source);
- signatures ``sig-early``: each centre's words stored as soon as its
  last window row is compared (after all rows in the source);
  ``sig-scy-2``, ``sig-scy-8``: rows a lane (4);
  ``sig-swx-2``, ``sig-swx-4``: warps across a block (1: 32 columns);
- tables ``tab-unroll-4``: the loop of 16-byte groups unrolled 4 deep;
  ``tab-nt-64``, ``tab-nt-256``: threads a block (128);
- tables ``div64``: the first design's index arithmetic added to every
  value, two 64-bit divisions of its flat index (their quotients shifted
  out, so the values stay);
- ``parent-store-only``, ``parent-no-store``: the same two splits of
  the first designs of both volume kernels (a thread a column, the census
  mask from the shared table, ad's term tile a disparity), with
  ``--source`` naming that source (a cell's stores alone; all its work
  and no store).

``--stores`` first times kernels that only store NaN over each case's
volume in the order of a block plan (``STORES``), in turns with one
``fill_``: the card's store rate by plan. ``--div-check`` first holds
the ad kernel's ``quotient`` (the source's, included whole) to
``__fdiv_rn`` for every one of the 2^32 float bit patterns over every
count a window of radius up to 7 can have (rows x columns, each 1 to
15), and exits non-zero at the end on any difference.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import time
from pathlib import Path

import numpy as np
import torch

from mccnn_tpu_torch import cbca_variants
from mccnn_tpu_torch.ops import _build, costs, join, sgm

# name -> (H, W, D, seed, shift): chip_smoke.py's pairs
CASES = {"kitti": (370, 1226, 228, 0, 40), "mb": (1000, 1500, 200, 3, 60)}
RADIUS = 4

_CENSUS_LOOP = "    stage(0);\n    __syncthreads();\n"
_AD_STAGE = "  for (int i = warp; i < T::ROWS; i += AW) {\n"
_AD_Q = "          const float q = quotient_fast(s, cnt[j], rc[j]);"
_AD_RARE = "          rare |= centre[j] && small(s, cnt[j]);\n"
_AD_TERM = ("          t[c] = __fmul_rn(fabsf(__fsub_rn(a[c], r1[slot[c]])), "
            "ok[c]);")
_CENSUS_STORE = "    // 8-byte pairs: x0 is even"
_FAST = "    if (b0 >= R && b0 + CW - 1 <= W - 1 - R && xs >= R &&"
_J_LOOP = ("#pragma unroll\n      for (int j = 0; j < DCH; ++j) {\n"
           "        if (d0 + j >= D) break;\n")
_AD_STORE = "        float* const orow = out + off;\n"
# no store survives it (no cell holds this NaN payload)
_NO_STORE = "if (__float_as_uint(v[0]) != 0x7fbfffffu) "
# the signature pass (census_sig_kernel<R>): its staging and its window rows
_SIG_STAGE = "  for (int i = threadIdx.x; i < PY * PX; i += ST) {"
_SIG_ROWS = "  for (int i = 0; i < SCY + 2 * R; ++i) {\n    float v[WD];"
_SIG_STORE = ("    store_words<NW>(sig + (img * plane + (int64_t)y * W + x)"
              " * NW, h[k]);")
# the first signature pass (a thread a pixel, a run-time radius)
_SIG1_LOOP = ("    unsigned long long b = 0;\n    int bit = 0, word = 0;\n"
              "    for (int dy = -r; dy <= r; ++dy) {")
_SIG1_WORD = "          out[word++] = b;"
_SIG1_LAST = "    if (bit) out[word] = b;"
_SIG1_NONE = "__float_as_uint(c) == 0x7fbfffffu"
# the table kernel (sgm_tables.cu): each value, its three stores
_TAB_VALUE = ("  auto value = [&](int j) -> float {\n"
              "    if (j >= len) return 0.f;  // the alignment gap\n")
_TAB_HEAD = ("  if ((int)threadIdx.x < head) row[threadIdx.x] = "
             "value(threadIdx.x);")
_TAB_BODY = ("    *reinterpret_cast<float4*>(row + j) =\n"
             "        make_float4(value(j), value(j + 1), value(j + 2), "
             "value(j + 3));")
_TAB_TAIL = ("  if ((int)threadIdx.x < end - tail)\n"
             "    row[tail + threadIdx.x] = value(tail + threadIdx.x);")
_TAB_NONE = "__float_as_uint({}) == 0x7fbfffffu"
# the first table kernel (a thread an element of the flat buffer)
_TAB1_STORE = "    out[i] = v;"
# the layout kernels (sgm_layout.cu): each one's loads and its stores
_LAY_LOAD = "  if (d0 < D) {  // the whole block alike"
_LAY_STORE = "    *reinterpret_cast<float4*>(out + row * Dp + d0 + r) = q;"
_COMB_LOAD = "  if (d0 + r < D) {\n#pragma unroll"
_COMB_STORE = ("  for (int rr = t / 32; rr < TD && d0 + rr < D; "
               "rr += NT / 32) {")
_WTA_LOAD = "  if (x < W) {\n    const int64_t plane"
_WTA_STORE = "    out[(int64_t)y * W + x] = (float)idx;"

# name -> [(old, new, occurrences)] text edits of a costs.cu
VARIANTS = {
    "store-only": [
        (_CENSUS_LOOP, "    if (W > 0) {\n      const int none[CX] = {};\n"
         "      if (!xin[0]) return;\n"
         "      for (int j = 0; j < DCH && d0 + j < D; ++j) put(j, none);\n"
         "      return;\n    }\n" + _CENSUS_LOOP, 1),
        (_AD_STAGE, "  for (int i = warp; i < 0; i += AW) {\n", 1),
        (_AD_Q, "          const float q = __uint_as_float(NAN_BITS);", 1),
        (_AD_RARE, "", 1), (_AD_TERM, "          t[c] = 0.f;", 1),
        (_SIG_STAGE, _SIG_STAGE.replace("PY * PX", "0"), 1),
        (_SIG_ROWS, _SIG_ROWS.replace("SCY + 2 * R", "0"), 1),
        (_SIG1_LOOP, "    for (int w = 0; w < nw; ++w) out[w] = 0;\n"
         + _SIG1_LOOP.replace("dy <= r", "dy < -r"), 1),
        (_TAB_VALUE, _TAB_VALUE.replace("(j >= len)", "(j >= 0)"), 1),
        (_TAB1_STORE, "    out[i] = 0.f;", 1),
        (_LAY_LOAD, _LAY_LOAD.replace("d0 < D", "false"), 1),
        (_COMB_LOAD, _COMB_LOAD.replace("d0 + r < D", "false"), 1),
        (_WTA_LOAD, _WTA_LOAD.replace("x < W", "false"), 1)],
    "no-store": [(_CENSUS_STORE, "    " + _NO_STORE + "return;\n"
                  + _CENSUS_STORE, 1),
                 (_AD_STORE,
                  _AD_STORE + "        " + _NO_STORE + "continue;\n", 1),
                 # the last word's top bit: no window position reaches it
                 (_SIG_STORE, "    if (h[k][2 * NW - 1] >> 31)\n  "
                  + _SIG_STORE, 1),
                 (_SIG1_WORD, f"          if ({_SIG1_NONE}) out[word] = b;\n"
                  "          ++word;", 1),
                 (_SIG1_LAST, f"    if (bit && {_SIG1_NONE}) out[word] = b;",
                  1),
                 (_TAB_HEAD, "  if ((int)threadIdx.x < head && "
                  + _TAB_NONE.format("value(threadIdx.x)")
                  + ") row[threadIdx.x] = 0.f;", 1),
                 (_TAB_BODY, "    {\n      const float4 v = make_float4("
                  "value(j), value(j + 1), value(j + 2),\n"
                  "                                   value(j + 3));\n"
                  "      if (" + _TAB_NONE.format("v.x") + " && "
                  + _TAB_NONE.format("v.y") + " &&\n          "
                  + _TAB_NONE.format("v.z") + " && "
                  + _TAB_NONE.format("v.w") + ")\n"
                  "        *reinterpret_cast<float4*>(row + j) = v;\n"
                  "    }", 1),
                 (_TAB_TAIL, "  if ((int)threadIdx.x < end - tail && "
                  + _TAB_NONE.format("value(tail + threadIdx.x)")
                  + ")\n    row[tail + threadIdx.x] = 0.f;", 1),
                 (_TAB1_STORE, "    if (" + _TAB_NONE.format("v")
                  + ") out[i] = v;", 1),
                 (_LAY_STORE, "    if (__float_as_uint(q.x) == 0x7fbfffffu)\n"
                  "  " + _LAY_STORE, 1),
                 (_COMB_STORE, "  if (__float_as_uint(tile[t / 32][t & 31])"
                  " != 0x7fbfffffu) return;\n" + _COMB_STORE, 1),
                 (_WTA_STORE, "    if (idx == -7)\n  " + _WTA_STORE, 1)],
    **{f"sig-scy-{n}": [("constexpr int SCY = 4;", f"constexpr int SCY = {n};",
                         1)] for n in (2, 8)},
    **{f"sig-swx-{n}": [("constexpr int SWX = 1;", f"constexpr int SWX = {n};",
                         1)] for n in (2, 4)},
    "sig-early": [
        ("      }\n    }\n  }\n#pragma unroll\n"
         "  for (int k = 0; k < SCY; ++k) {\n"
         "    const int y = by + cy + k;\n    if (y >= H) break;\n"
         "    store_words<NW>(",
         "      }\n    }\n"
         "    if (i >= 2 * R) {  // centre i - 2R is complete\n"
         "      const int k = i - 2 * R;\n"
         "      const int y = by + cy + k;\n"
         "      if (y < H)\n        store_words<NW>(", 1),
        ("(img * plane + (int64_t)y * W + x) * NW, h[k]);\n  }\n}",
         "(img * plane + (int64_t)y * W + x) * NW,\n"
         "                        h[k]);\n    }\n  }\n}", 1)],
    "tab-unroll-4": [("  for (int q = threadIdx.x; q < nq; q += NT) {",
                      "#pragma unroll 4\n"
                      "  for (int q = threadIdx.x; q < nq; q += NT) {", 1)],
    **{f"tab-nt-{n}": [("constexpr int NT = 128;", f"constexpr int NT = {n};",
                        1)] for n in (64, 256)},
    "div64": [(_TAB_VALUE, _TAB_VALUE.replace(
        "    if (j >= len)",
        "    j += (int)(((base + j) / (int64_t)len) >> 62) +\n"
        "         (int)(((base + j) / ((int64_t)len + end)) >> 62);\n"
        "    if (j >= len)"), 1)],
    "no-fast": [(_FAST, "    if (false &&", 1)],
    "l2-sig": [
        ("span_words<NW>(sp, e0 + k + j * dir, s1);",
         "load_words<NW>(sig1 + ((int64_t)y * W + min(max(\n"
         "              x0 + k + (d0 + j) * dir, 0), W - 1)) * NW, s1);", 2),
        ("    for (int e = threadIdx.x; e < SPAN; e += CT) {",
         "    for (int e = threadIdx.x; e < 0; e += CT) {", 1)],
    **{f"dch-{n}": [("constexpr int DCH = 32;", f"constexpr int DCH = {n};",
                     1)] for n in (16, 64)},
    "cx-1": [("constexpr int CX = 2;", "constexpr int CX = 1;", 1)],
    **{f"unroll-{n}": [(_J_LOOP, _J_LOOP.replace("unroll", f"unroll {n}"), 2)]
       for n in (4, 8)},
    "no-div": [(_AD_Q, "          const float q = __fmul_rn(s, rc[j]);", 1)],
    "fdiv": [(_AD_Q, "          const float q = __fdiv_rn(s, cnt[j]);", 1)],
    "stage-only": [(
        "  __syncthreads();\n  const int xc = xt + lane * AX;",
        "  __syncthreads();\n  if (t0[threadIdx.x] == 12345.f) out[0] = 1.f;\n"
        "  return;\n  const int xc = xt + lane * AX;", 1)],
    **{f"ty-{n}": [("constexpr int ATY = 32;", f"constexpr int ATY = {n};", 1)]
       for n in (16, 64)},
    **{f"nd-{n}": [("constexpr int AND = 16;", f"constexpr int AND = {n};", 1)]
       for n in (8, 32)},
    **{f"warps-{n}": [("constexpr int AW = 4;", f"constexpr int AW = {n};", 1)]
       for n in (2, 8)},
    "ax-8": [("constexpr int AX = 4;", "constexpr int AX = 8;", 1)],
    **{f"blocks-{n}": [("__launch_bounds__(32 * AW)\nad_volume_kernel(",
                        f"__launch_bounds__(32 * AW, {n})\nad_volume_kernel(",
                        1)] for n in (5, 6)},
    # the first designs (their source given as --source): stores alone,
    # work alone
    "parent-store-only": [
        ("    if (xm >= 0 && xm < W) {\n      const int xlo",
         "    if (false) {\n      const int xlo", 1),
        ("  for (int i = threadIdx.x; i < TR * TC; i += TX) {",
         "  for (int i = threadIdx.x; i < 0; i += TX) {", 1),
        ("    if (centre) {", "    if (false) {", 1)],
    "parent-no-store": [(
        "    out[((int64_t)d * H + y) * W + x] = cost;",
        "    if (__float_as_uint(cost) == 0x7fbfffffu)\n"
        "      out[((int64_t)d * H + y) * W + x] = cost;", 2)],
}

# the variants that change what a kernel computes
NOT_SAME = ("store-only", "no-store", "no-div", "stage-only",
            "parent-store-only", "parent-no-store")

# each kernel's source (by file name) and the kernels ptxas reports of it
SOURCE_OF = {"census": "costs.cu", "ad": "costs.cu", "signatures": "costs.cu",
             "tables": "sgm_tables.cu", "layout": "sgm_layout.cu",
             "combine": "sgm_layout.cu", "wta": "sgm_layout.cu"}
PTXAS = {"costs.cu": ("census_sig_kernel", "census_volume_kernel",
                      "ad_volume_kernel"),
         "sgm_tables.cu": ("sgm_tables_kernel",),
         "sgm_layout.cu": ("sgm_layout_kernel", "sgm_combine_kernel",
                           "wta_dhw_kernel")}

# ``--stores``: kernels that only store NaN over a (D, H, W) float32
# volume, each in the order of one block plan, for the card's store rate
# by plan (beside one ``fill_``)
STORES = {
    # a block a row of 128 columns x 32 disparities, a thread a column
    # (the census plan), 4-byte stores; with 2 columns a thread and
    # 8-byte stores; with the disparity chunks first in the grid
    "row-32": 0, "row-32-pairs": 1, "row-32-chunks-first": 2,
    # a block 32 rows x 128 columns x 16 disparities, 4 warps, a warp a
    # disparity at a time, a lane 4 columns of each row (the ad plan):
    # 8-byte pairs, 4-byte stores
    "tile-16": 3, "tile-16-scalar": 4,
    # a block a row of one plane (128 columns), a thread a column: the
    # volume in its memory order; with 2 columns a thread
    "plane": 5, "plane-pairs": 6,
    # a block a row of 128 columns x all D disparities
    "row-all": 7,
}
STORES_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void store_kernel(float* __restrict__ out, int H, int W, int D,
                             int p) {
  const float v = __uint_as_float(0x7fc00000u);
  const int64_t plane = (int64_t)H * W;
  if (p <= 2 || p == 7) {
    const int cx = p == 1 ? 2 : 1;
    const int bx = p == 2 ? blockIdx.y : blockIdx.x;
    const int y = p == 2 ? blockIdx.z : blockIdx.y;
    const int z = p == 2 ? blockIdx.x : blockIdx.z;
    const int n = p == 7 ? D : 32;
    const int x = (bx * 128 + threadIdx.x) * cx;
    if (x >= W) return;
    for (int j = 0; j < n; ++j) {
      const int d = z * n + j;
      if (d >= D) break;
      float* o = out + d * plane + (int64_t)y * W + x;
      if (cx == 2 && x + 1 < W)
        *reinterpret_cast<float2*>(o) = make_float2(v, v);
      else
        *o = v;
    }
  } else if (p <= 4) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int xc = blockIdx.x * 128 + lane * 4;
    for (int k = warp; k < 16; k += 4) {
      const int d = blockIdx.z * 16 + k;
      if (d >= D) break;
      for (int i = 0; i < 32; ++i) {
        const int y = blockIdx.y * 32 + i;
        if (y >= H) break;
        float* o = out + ((int64_t)d * H + y) * W + xc;
        if (p == 3 && W % 2 == 0 && xc + 4 <= W) {
          reinterpret_cast<float2*>(o)[0] = make_float2(v, v);
          reinterpret_cast<float2*>(o)[1] = make_float2(v, v);
        } else {
          for (int j = 0; j < 4; ++j)
            if (xc + j < W) o[j] = v;
        }
      }
    }
  } else {
    const int cx = p == 6 ? 2 : 1;
    const int x = (blockIdx.x * 128 + threadIdx.x) * cx;
    if (x >= W) return;
    float* o = out + blockIdx.z * plane + (int64_t)blockIdx.y * W + x;
    if (cx == 2 && x + 1 < W)
      *reinterpret_cast<float2*>(o) = make_float2(v, v);
    else
      *o = v;
  }
}

extern "C" int store_launch(float* out, int H, int W, int D, int p,
                            cudaStream_t stream) {
  const int cx = p == 1 || p == 6 ? 2 : 1;
  const int tiles = (W + 128 * cx - 1) / (128 * cx);
  dim3 grid;
  if (p == 0 || p == 1) grid = dim3(tiles, H, (D + 31) / 32);
  else if (p == 2) grid = dim3((D + 31) / 32, tiles, H);
  else if (p <= 4) grid = dim3((W + 127) / 128, (H + 31) / 32, (D + 15) / 16);
  else if (p == 7) grid = dim3(tiles, H, 1);
  else grid = dim3(tiles, H, D);
  store_kernel<<<grid, 128, 0, stream>>>(out, H, W, D, p);
  return (int)cudaGetLastError();
}
"""


def variant_source(src: str, names: str) -> str:
    if names.startswith("file:"):
        return cbca_variants.variant_source(src, names)
    for name in names.split("+"):
        src = cbca_variants.apply_edits(src, name, VARIANTS[name])
    return src


def applies(src: str, file_name: str, names: str) -> bool:
    """Whether the variant ``names`` is built for the source ``src`` (of
    that file name): a whole file of the same name, or text edits of which
    each name has one that matches ``src``."""
    if names.startswith("file:"):
        return Path(names[5:]).name == file_name
    return all(any(src.count(old) == n for old, _, n in VARIANTS[name])
               for name in names.split("+"))


def census_launcher(lib: ctypes.CDLL, s0, s1, D: int, direction: int):
    """A call of the build's census_volume_launch on these signatures."""
    lib.census_volume_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_void_p])
    lib.census_volume_launch.restype = ctypes.c_int
    C, H, W, _ = s0.shape
    out = torch.empty((D, H, W), dtype=torch.float32, device=s0.device)

    def run():
        rc = lib.census_volume_launch(s0.data_ptr(), s1.data_ptr(),
                                      out.data_ptr(), C, H, W, D, direction,
                                      RADIUS, costs._recip(C),
                                      _build.stream(s0))
        _build.check_launch(rc, "census_volume variant")
        return out
    return run


def ad_launcher(lib: ctypes.CDLL, x0, x1, D: int, direction: int):
    """A call of the build's ad_volume_launch on these images."""
    lib.ad_volume_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ad_volume_launch.restype = ctypes.c_int
    H, W = x0.shape
    out = torch.empty((D, H, W), dtype=torch.float32, device=x0.device)

    def run():
        rc = lib.ad_volume_launch(x0.data_ptr(), x1.data_ptr(),
                                  out.data_ptr(), H, W, D, direction, RADIUS,
                                  _build.stream(x0))
        _build.check_launch(rc, "ad_volume variant")
        return out
    return run


def same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def signatures_launcher(lib: ctypes.CDLL, x0, x1):
    """A call of the build's census_signatures_launch on these images."""
    lib.census_signatures_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.census_signatures_launch.restype = ctypes.c_int
    C, H, W = x0.shape
    out = torch.empty((2, C, H, W, costs.census_words(RADIUS)),
                      dtype=torch.int64, device=x0.device)

    def run():
        rc = lib.census_signatures_launch(x0.data_ptr(), x1.data_ptr(),
                                          out.data_ptr(), C, H, W, RADIUS,
                                          _build.stream(x0))
        _build.check_launch(rc, "census_signatures variant")
        return out
    return run


def tables_launcher(lib: ctypes.CDLL, x0, x1, D: int, shape, xrev: bool):
    """A call of the build's sgm_tables_launch on these images."""
    lib.sgm_tables_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2
        + [ctypes.c_int, ctypes.c_void_p])
    lib.sgm_tables_launch.restype = ctypes.c_int
    H, W = x0.shape
    Hp, Wp, Dp = shape
    gw = D + Wp + Dp
    n_d1, stride = sgm.table_layout(Hp, Wp, gw)
    out = torch.empty(4 * stride, dtype=torch.float32, device=x0.device)

    def run():
        rc = lib.sgm_tables_launch(x0.data_ptr(), x1.data_ptr(),
                                   out.data_ptr(), H, W, D, Hp, Wp, gw, n_d1,
                                   stride, int(xrev), _build.stream(x0))
        _build.check_launch(rc, "sgm_tables variant")
        return out
    return run


# the generic lane's layout kernels (sgm_layout.cu)
LAYOUT = ("layout", "combine", "wta")


def layout_launcher(lib: ctypes.CDLL, vols, Dp: int, vertical: bool):
    """A call of the build's sgm_layout_launch on these (D, H, W) volumes
    (the -1 direction first)."""
    lib.sgm_layout_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.sgm_layout_launch.restype = ctypes.c_int
    D, H, W = vols[0].shape
    n = len(vols)
    out = torch.empty((H, n * W, Dp) if vertical else (W, n * H, Dp),
                      dtype=torch.float32, device=vols[0].device)

    def run():
        rc = lib.sgm_layout_launch(vols[0].data_ptr(), vols[-1].data_ptr(),
                                   out.data_ptr(), n, D, H, W, Dp,
                                   int(vertical), 1, _build.stream(out))
        _build.check_launch(rc, "sgm_layout variant")
        return out
    return run


def combine_launcher(lib: ctypes.CDLL, acc_h, acc_v, D: int):
    """A call of the build's sgm_combine_launch (both directions, the
    quarter) on these family accumulators."""
    lib.sgm_combine_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.sgm_combine_launch.restype = ctypes.c_int
    W, nH, Dp = acc_h.shape
    H = acc_v.shape[0]
    n = nH // H
    out = torch.empty((n, D, H, W), dtype=torch.float32, device=acc_h.device)

    def run():
        rc = lib.sgm_combine_launch(acc_h.data_ptr(), acc_v.data_ptr(),
                                    out.data_ptr(), n, D, H, W, Dp, 1, 1,
                                    _build.stream(out))
        _build.check_launch(rc, "sgm_combine variant")
        return out
    return run


def wta_launcher(lib: ctypes.CDLL, vol):
    """A call of the build's wta_dhw_launch on this (D, H, W) volume."""
    lib.wta_dhw_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.wta_dhw_launch.restype = ctypes.c_int
    D, H, W = vol.shape
    out = torch.empty((H, W), dtype=torch.float32, device=vol.device)

    def run():
        rc = lib.wta_dhw_launch(vol.data_ptr(), out.data_ptr(), D, H, W,
                                _build.stream(vol))
        _build.check_launch(rc, "wta_dhw variant")
        return out
    return run


def layout_case(x0, x1, D: int, kernel: str, libs: dict) -> list:
    """[(label, {tag: run}, plain output, bytes)] of one layout kernel on
    both directions' census volumes of the pair: each family's d-minor
    volume, the family sum with the quarter (the two families' volumes
    as the accumulators), the winner-take-all of the -1 volume."""
    vols = [costs.census_volume(x0, x1, D, -1),
            costs.census_volume(x1, x0, D, 1)]
    Dp = -(-D // 32) * 32
    n = 2 * vols[0].numel()
    if kernel == "layout":
        out = []
        for vertical in (False, True):
            plain = sgm.sgm_layout_plain(vols, Dp, vertical=vertical,
                                         rev=vertical)
            out.append((f", {'vertical' if vertical else 'horizontal'}",
                        {tag: layout_launcher(lib, vols, Dp, vertical)
                         for tag, lib in libs.items()}, plain,
                        4 * n + 4 * plain.numel()))
        return out
    if kernel == "combine":
        acc_h = sgm.sgm_layout(vols, Dp, vertical=False, rev=False)
        acc_v = sgm.sgm_layout(vols, Dp, vertical=True, rev=True)
        want = sgm.sgm_combine_plain(acc_h, acc_v, (-1, 1), D, quarter=True)
        return [(", both directions, the quarter",
                 {tag: combine_launcher(lib, acc_h, acc_v, D)
                  for tag, lib in libs.items()},
                 torch.stack([want[-1], want[1]]), 12 * n)]
    return [(", direction -1", {tag: wta_launcher(lib, vols[0])
                                for tag, lib in libs.items()},
             costs.wta_plain(vols[0]), 2 * n + 4 * vols[0][0].numel())]


def time_case(cs, case: str, kernel: str, libs: dict, variants, reps: int,
              dev) -> None:
    """``kernel`` on ``case``'s pair (each direction of a volume, each
    storage order of the tables): the source's build against the plain
    version, each variant that keeps the function against the source's
    build, the times in turns beside the bound and the ``fill_`` floor of
    the same output bytes. Volumes by events, the signatures and the
    tables in a CUDA graph."""
    H, W, D, seed, shift = CASES[case]
    x0, x1 = (torch.as_tensor(v, device=dev)
              for v in cs.kitti_pair(np.random.RandomState(seed), H, W,
                                     shift))
    if kernel in ("census", "ad", "layout", "combine", "wta"):
        def timer(fn):
            return cbca_variants.ms(fn, reps)
        how = "by events"
    else:
        def timer(fn):
            return cs.graph_ms(torch, fn, reps)
        how = "in a CUDA graph"
    sig = costs.census_signatures(x0, x1, RADIUS) if kernel == "census" \
        else None
    if kernel in LAYOUT:
        settings = [(s[0], s) for s in layout_case(x0, x1, D, kernel, libs)]
    elif kernel == "signatures":
        settings = [("", None)]
    elif kernel == "tables":
        shape = join.pad_dims(H, W, D)
        settings = [(f", xrev {xrev}", xrev) for xrev in (True, False)]
    else:
        settings = [(f", direction {d:+d}", d) for d in (-1, 1)]
    floor = None
    for label, setting in settings:
        if kernel == "census":
            direction = setting
            a, b = (x0, x1) if direction == -1 else (x1, x0)
            halves = (sig[0], sig[1]) if direction == -1 else (sig[1], sig[0])
            runs = {tag: census_launcher(lib, *halves, D, direction)
                    for tag, lib in libs.items()}
            plain = costs.census_volume_plain(a, b, D, direction, RADIUS,
                                              signatures=halves)
            nbytes = 4 * D * H * W + 2 * halves[0].numel() * 8
        elif kernel == "ad":
            direction = setting
            a, b = (x0, x1) if direction == -1 else (x1, x0)
            runs = {tag: ad_launcher(lib, a, b, D, direction)
                    for tag, lib in libs.items()}
            plain = costs.ad_volume_plain(a, b, D, direction, RADIUS)
            nbytes = 4 * D * H * W + 8 * H * W
        elif kernel in LAYOUT:
            _, runs, plain, nbytes = setting
        elif kernel == "signatures":
            runs = {tag: signatures_launcher(lib, x0[None], x1[None])
                    for tag, lib in libs.items()}
            plain = costs.census_signatures_plain(x0, x1, RADIUS)
            nbytes = 8 * H * W + 8 * plain.numel()
        else:
            runs = {tag: tables_launcher(lib, x0, x1, D, shape, setting)
                    for tag, lib in libs.items()}
            plain = sgm.sgm_tables_plain(x0, x1, D, H, W, shape,
                                         xrev=setting)
            nbytes = 8 * H * W + 4 * plain.numel()
        want = runs["source"]().clone()
        torch.cuda.synchronize()
        if not same_bits(want, plain):
            raise SystemExit(f"{kernel} {case}{label}: the source's build "
                             "differs from the plain version")
        if floor is None:  # one fill_ of the output's bytes
            buf = torch.empty_like(want)
            floor = timer(lambda: buf.fill_(0))
            del buf
        del plain
        first = timer(runs["source"])
        print(f"  {kernel} {case} ({H}x{W}, D = {D}){label}: source "
              f"{first:.5f} ms {how}, bit-identical to the plain version; "
              f"bound {cs.bound_ms(nbytes, 0)[0]:.5f} (bytes), fill_ of the "
              f"output {floor:.5f}")
        for v in variants:
            if v not in runs:
                continue
            same = ""
            if v.startswith("file:") or not any(n in v.split("+")
                                                for n in NOT_SAME):
                got = runs[v]()
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    raise SystemExit(f"variant {v} differs from the source's "
                                     f"build: {kernel} {case}{label}")
                same = ", bit-identical"
            times = [timer(runs[n]) for n in ("source", v, v, "source")]
            print(f"    source / {v} / {v} / source: "
                  f"{' / '.join(f'{t:.5f}' for t in times)}{same}")
        del runs, want
        torch.cuda.empty_cache()


def time_stores(cs, reps: int, dev) -> None:
    """Each ``STORES`` plan's NaN stores over the KITTI and Middlebury
    volumes, by events, in turns with one ``fill_``."""
    lib, _ = cbca_variants.build("stores", STORES_SRC, prefix="costs_v",
                                 kernels=("store_kernel",))
    lib.store_launch.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p])
    lib.store_launch.restype = ctypes.c_int
    for case, (H, W, D, _, _) in CASES.items():
        vol = torch.empty((D, H, W), dtype=torch.float32, device=dev)

        def fill():
            vol.fill_(float("nan"))

        want = torch.full_like(vol, float("nan"))
        for name, p in STORES.items():
            def run(p=p):
                _build.check_launch(
                    lib.store_launch(vol.data_ptr(), H, W, D, p,
                                     _build.stream(vol)), "store plan")
            vol.zero_()
            run()
            torch.cuda.synchronize()
            if not same_bits(vol, want):
                raise SystemExit(f"store plan {name} left cells unwritten")
            times = [cbca_variants.ms(f, reps) for f in (fill, run, run, fill)]
            print(f"  stores {case} ({D}x{H}x{W} float32, bound "
                  f"{cs.bound_ms(4 * D * H * W, 0)[0]:.4f}): fill_ / {name} / "
                  f"{name} / fill_: {' / '.join(f'{t:.4f}' for t in times)}")
        del vol, want
        torch.cuda.empty_cache()


# every count of a window up to radius 7: in-frame rows x ok columns
COUNTS = sorted({r * c for r in range(1, 16) for c in range(1, 16)})
DIV_CHECK = r"""
#include "%s"

__global__ void div_check(const int* counts, int n,
                          unsigned long long* bad, unsigned* first) {
  __shared__ float y[256];
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    y[k] = __frcp_rn((float)counts[k]);
  __syncthreads();
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x
                              + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const float a = __uint_as_float((unsigned)i);
    for (int k = 0; k < n; ++k) {
      const float b = (float)counts[k];
      if (__float_as_uint(quotient(a, b, y[k])) !=
          __float_as_uint(__fdiv_rn(a, b))) {
        atomicAdd(bad + k, 1ull);
        atomicMin(first + k, (unsigned)i);
      }
    }
  }
}

extern "C" int div_check_launch(const int* counts, int n,
                                unsigned long long* bad, unsigned* first) {
  div_check<<<132 * 8, 256>>>(counts, n, bad, first);
  return (int)cudaGetLastError();
}
"""


def div_check(source: Path, dev) -> bool:
    """``quotient`` of ``source`` against ``__fdiv_rn`` over every float
    bit pattern and every count of ``COUNTS``: whether all agree."""
    lib, _ = cbca_variants.build(
        "div_check", DIV_CHECK % source.resolve(), prefix="costs_v",
        kernels=("div_check",))
    lib.div_check_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.div_check_launch.restype = ctypes.c_int
    counts = torch.tensor(COUNTS, dtype=torch.int32, device=dev)
    bad = torch.zeros(len(COUNTS), dtype=torch.int64, device=dev)
    first = torch.full((len(COUNTS),), -1, dtype=torch.int32, device=dev)
    start = time.perf_counter()
    _build.check_launch(lib.div_check_launch(counts.data_ptr(), len(COUNTS),
                                             bad.data_ptr(), first.data_ptr()),
                        "div_check")
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    wrong = {c: (int(b), f"0x{int(f) & 0xffffffff:08x}")
             for c, b, f in zip(COUNTS, bad.tolist(), first.tolist()) if b}
    print(f"  div-check: quotient against __fdiv_rn, {2 ** 32} floats x "
          f"{len(COUNTS)} counts ({COUNTS[0]}-{COUNTS[-1]}) in {secs:.1f} s: "
          + (f"differs {wrong}" if wrong else "the same bits for every one"))
    return not wrong


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, nargs="+", default=[],
                    help="another costs.cu, sgm_tables.cu or sgm_layout.cu "
                    "(by file name)")
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--case", nargs="+", choices=sorted(CASES),
                    default=["kitti", "mb"])
    ap.add_argument("--kernel", nargs="+", choices=tuple(SOURCE_OF),
                    default=["census", "ad"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--stores", action="store_true",
                    help="time the store plans (STORES) first")
    ap.add_argument("--div-check", action="store_true",
                    help="hold quotient to __fdiv_rn for every float first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("costs_variants: no CUDA device")
    dev = torch.device("cuda")
    paths = {name: _build.CSRC / name for name in PTXAS}
    for path in args.source:
        if path.name not in paths:
            raise SystemExit(f"--source {path}: not one of {sorted(paths)}")
        paths[path.name] = path
    names = sorted({SOURCE_OF[k] for k in args.kernel}
                   | ({"costs.cu"} if args.div_check else set()))
    jobs = []  # (file name, tag, text)
    for name in names:
        base = paths[name].read_text()
        jobs += [(name, "source", base)] + [
            (name, v, variant_source(base, v)) for v in args.variant
            if applies(base, name, v)]
    for v in args.variant:
        if not any(tag == v for _, tag, _ in jobs):
            raise SystemExit(f"variant {v} matches none of {names}")
    # one nvcc a build, all at once
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: cbca_variants.build(
            job[1], job[2], prefix=f"costs_v_{Path(job[0]).stem}",
            kernels=PTXAS[job[0]]), jobs))
    libs = {name: {} for name in names}
    for (name, tag, _), (lib, used) in zip(jobs, built):
        libs[name][tag] = lib
        print(f"{name} {tag}:\n  {used}")
    cs = cbca_variants.chip_smoke()
    print(f"{torch.cuda.get_device_name(0)}, {cs.card_line()}; "
          + ", ".join(str(paths[n]) for n in names)
          + f"; ms a call (the mean of {args.reps} after a warm-up)")
    same = div_check(paths["costs.cu"], dev) if args.div_check else True
    if args.stores:
        time_stores(cs, args.reps, dev)
    for case in args.case:
        for kernel in args.kernel:
            time_case(cs, case, kernel, libs[SOURCE_OF[kernel]],
                      args.variant, args.reps, dev)
    if not same:
        raise SystemExit("div-check: quotient is not __fdiv_rn")


if __name__ == "__main__":
    main()
