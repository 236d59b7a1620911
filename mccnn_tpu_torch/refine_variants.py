"""Time variants of the refinement kernels against a build of their
source.

    python -m mccnn_tpu_torch.refine_variants [--source PATH]
        [--variant NAME[+NAME] ...] [--case mm-kitti sp-kitti ...]
        [--reps 20]

Run from the repository's root on one CUDA card (it takes its inputs and
its timer from ``chip_smoke.py`` there, its build from
``cbca_variants``): builds a ``refine.cu`` (by default the shipped
``csrc/refine.cu``; ``--source`` names another, such as an earlier
commit's unpacked under ``build/``) and each named variant of it (text
edits of that source, ``a+b`` for several), then times the C entries
``occlusion_fill_launch``, ``mismatch_fill_launch``, ``subpixel_launch``
and ``median5_launch`` alone in a CUDA graph (``chip_smoke.graph_ms``,
``--reps`` calls), in turns: source, variant, variant, source. The
inputs are those ``chip_smoke.py`` phases 3 and 3b hold the kernels on:
the arguments of one seeded kitti fast ``stereo_predict`` at 370x1226,
D = 228 (``capture_refine``); for the ``sp-mb*`` and ``md-mb`` cases mb
fast's at 1000x1500, D = 200. The occlusion fill runs on the path's
maps (``oc-kitti``); the mismatch fill on the maps of
``chip_smoke.mismatch_maps`` (``mm-kitti`` the path's labels,
``mm-all``, ``mm-edges``, ``mm-clustered``); subpixel on the x-reversed
HWD volume in f32, bf16 and f16 storage and relaid as the generic lane's
(D, H, W) (``-dhw``); the median on the path's map (``md-kitti``,
``md-mb``) and on ``chip_smoke.adversarial_median`` of the KITTI one
(``md-adversarial``). The source's build is held bit for bit against the
plain version, and a variant that keeps the function against the
source's build. Prints each build's registers and spills (ptxas) for the
four kernels. The ``fmnmx`` case times independent chains of ``min.f32``
and ``max.f32`` (inline PTX) over the card and prints their rate, the
instruction the median's bound counts.

Variants of the mismatch fill (the same bits):

- ``dense-0``, ``dense-16``, ``dense-128``, ``dense-256``: a tile walks a
  thread a pixel above that many MISMATCH pixels (0: every tile with one;
  256: none) instead of the source's ``DENSE``;
- ``p4``, ``p16``: a sparse walk's probes a lane a round;
- ``q4``, ``q16``: a dense walk's probes of a ray in flight.

Variants of subpixel, the split of the gather's time (they change what
the kernel computes):

- ``no-vol``: no volume reads (each sample its index: the map reads,
  the arithmetic and the stores stay);
- ``one-sample``: the centre sample read alone (the others their index).

Variants of the median, the split of its time (``md-no-net`` and
``md-no-edge`` edit an earlier source's thread-an-output kernel and the
two-path kernel's plain path, ``md-no-net`` its fast network too;
``md-plain`` and ``md-warps*`` keep the function):

- ``md-no-net``: the taps loaded, the networks replaced by the centre tap;
- ``md-no-edge``: the boundary tests dropped (every tap read from the
  tile: right on interior outputs only);
- ``md-plain``: every lane of the two-path kernel on the plain path;
- ``md-warps1``, ``md-warps2``, ``md-warps8``: warps (tiles) a block;
- ``md-scalar``: the tile staged and the fast outputs stored 4 bytes at
  a time only;
- ``md-empty``: the two-path kernel's blocks return at once (its launch).

Variants of the occlusion fill (the same bits): ``oc-v2``, ``oc-v8``,
``oc-v16``: columns a thread; ``oc-scalar``: 4-byte loads and stores
only; and, not the same bits, ``oc-copy`` (the runs loaded, their
occlusions zeroed, stored: no scan) and ``oc-empty`` (the blocks return
at once: the launch).

``file:PATH`` as a variant is another whole source (the parent's
``refine.cu``, say), timed in turns against ``--source`` and held bit for
bit against it.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import numpy as np
import torch

from mccnn_tpu_torch.cbca_variants import apply_edits, build, chip_smoke
from mccnn_tpu_torch.ops import _build, post

_SAMPLE = "c[k] = j >= 0 && j < Dp ? widen<S>(base[j * sd]) : 0.f;"
_OC_FIRST = "  const size_t base = (size_t)blockIdx.x * W;\n"
_MD_FIRST = ("  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n"
             "  const int x0 = blockIdx.x * TX, "
             "y0 = (blockIdx.y * MW + warp) * TY;\n")

# name -> [(old, new, occurrences)] text edits of a refine.cu; the edits
# that match are applied, and at least one must
VARIANTS = {
    **{f"dense-{n}": [("constexpr int DENSE = 64;",
                       f"constexpr int DENSE = {n};", 1)]
       for n in (0, 16, 128, 256)},
    **{f"p{n}": [("constexpr int P = 8;", f"constexpr int P = {n};", 1)]
       for n in (4, 16)},
    **{f"q{n}": [("constexpr int Q = 8;", f"constexpr int Q = {n};", 1)]
       for n in (4, 16)},
    "no-vol": [(_SAMPLE, "c[k] = j >= 0 && j < Dp ? (float)j : 0.f;", 1)],
    "md-no-net": [
        ("out[(size_t)y * W + x] = nans ? select_mid25<true>(v) "
         ": select_mid25<false>(v);", "out[(size_t)y * W + x] = v[12];", 1),
        ("  return nans ? select_mid25<true>(v) : select_mid25<false>(v);",
         "  return v[12];", 1),
        ("    MEDIAN5_FAST_NET(N, X, O)\n",
         "    for (int k = 0; k < MX * MY; ++k) "
         "o[k] = in[k / MX + 2][k % MX + 2];\n", 1)],
    "md-no-edge": [("const bool ok = x + dx >= 0 && x + dx < W && y + dy >= 0 "
                    "&& y + dy < H;", "const bool ok = true;", 1)],
    "md-plain": [("  bool fast = x >= 2 &&",
                  "  bool fast = false && x >= 2 &&", 1)],
    **{f"md-warps{n}": [("constexpr int MW = 4;", f"constexpr int MW = {n};",
                         1)] for n in (1, 2, 8)},
    "oc-copy": [("    // the run's last and first match\n",
                 "    for (int i = 0; i < OCC_V; ++i) {\n"
                 "      if ((oc >> i) & 1) v[i] = 0.f;\n"
                 "    }\n"
                 "    occlusion_store(out + base, c0, W, vec, v);\n"
                 "    continue;\n", 1)],
    # the blocks return at once: the first statement of each kernel
    "oc-empty": [(_OC_FIRST, "  if (W > 0) return;\n" + _OC_FIRST, 1)],
    "md-empty": [(_MD_FIRST, "  if (W > 0) return;\n" + _MD_FIRST, 1)],
    "oc-scalar": [("  const bool vec = W % 2 == 0 && aligned8(d0) && "
                   "aligned8(lab) && aligned8(out);",
                   "  const bool vec = false;", 1)],
    "md-scalar": [("  const bool vec = W % 2 == 0 && aligned8(img) && "
                   "aligned8(out);", "  const bool vec = false;", 1)],
    **{f"oc-v{n}": [("constexpr int OCC_V = 4;", f"constexpr int OCC_V = {n};",
                     1)] for n in (2, 8, 16)},
    "one-sample": [(_SAMPLE,
                    "c[k] = j >= 0 && j < Dp\n"
                    "               ? (k == 1 ? widen<S>(base[j * sd]) "
                    ": (float)j) : 0.f;", 1)],
}
# the variants that change what the kernels compute
NOT_SAME = ("no-vol", "one-sample", "md-no-net", "md-no-edge", "md-empty",
            "oc-copy", "oc-empty")

# case -> the key of chip_smoke.mismatch_maps
MM_CASES = {"mm-kitti": "path", "mm-all": "all MISMATCH",
            "mm-edges": "edges", "mm-clustered": "clustered"}
SP_CASES = tuple(f"sp-{size}{kind}" for size in ("kitti", "mb")
                 for kind in ("", "-bf16", "-f16", "-dhw"))
MD_CASES = ("md-kitti", "md-mb", "md-adversarial")
OC_CASES = ("oc-kitti",)

# independent chains of min.f32 / max.f32, volatile so that none is merged
# or dropped: 16 a step, 8 chains of two a thread
FMNMX_SRC = r"""
#include <cuda_runtime.h>
#define MN(a, b) asm volatile("min.f32 %0, %0, %1;" : "+f"(a) : "f"(b))
#define MX(a, b) asm volatile("max.f32 %0, %0, %1;" : "+f"(a) : "f"(b))
__global__ void fmnmx_kernel(float* out, int steps) {
  float a[8], b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = threadIdx.x + k;
    b[k] = blockIdx.x - k;
  }
  for (int i = 0; i < steps; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      MN(a[k], b[k]);
      MX(b[k], a[k]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += a[k] + b[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int fmnmx_launch(float* out, int blocks, int steps,
                            cudaStream_t stream) {
  fmnmx_kernel<<<blocks, 256, 0, stream>>>(out, steps);
  return (int)cudaGetLastError();
}
"""


def variant_source(src: str, names: str) -> str:
    if names.startswith("file:"):
        return Path(names[5:]).read_text()
    for name in names.split("+"):
        src = apply_edits(src, name, VARIANTS[name])
    return src


def load(tag: str, src: str) -> tuple[ctypes.CDLL, str]:
    """``src`` built with the package's flags, its four C entries typed."""
    lib, used = build(tag, src, "refine_v",
                      ("occlusion_fill_kernel", "mismatch_fill_kernel",
                       "subpixel_kernel", "median5_kernel"))
    maps = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.occlusion_fill_launch.argtypes = maps
    lib.mismatch_fill_launch.argtypes = maps
    lib.median5_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.subpixel_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_void_p])
    for fn in (lib.occlusion_fill_launch, lib.mismatch_fill_launch,
               lib.median5_launch, lib.subpixel_launch):
        fn.restype = ctypes.c_int
    return lib, used


def capture(cs, size: str, dev) -> dict:
    """The refinement stages' arguments in one fast ``stereo_predict``,
    seeded as chip_smoke.py's phase 4 (``kitti``) and phase 3b (``mb``)
    seed theirs."""
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.pipeline import stereo_predict

    if size == "kitti":
        dataset, h, w, d, shift, seed = "kitti", cs.H, cs.W, cs.D, cs.SHIFT, 0
    else:
        dataset, h, w, d, shift, seed = "mb", 1000, 1500, 200, cs.MB_SHIFT, 3
    cfg = make_config(dataset, "fast", a="predict")
    tower = towers.init_fast(cfg, cfg.seed).to(dev)
    x0, x1 = cs.kitti_pair(np.random.RandomState(seed), h, w, shift)

    def run():
        with torch.no_grad():
            stereo_predict(cfg, tower, x0, x1, d)
    return cs.capture_refine(torch, run)


def fill_call(lib, entry, d0, lab):
    """A call of the build's ``<entry>_launch`` (the occlusion or the
    mismatch fill)."""
    out = torch.empty_like(d0)
    h, w = d0.shape
    fn = getattr(lib, f"{entry}_launch")

    def run():
        rc = fn(d0.data_ptr(), lab.data_ptr(), out.data_ptr(), h, w,
                _build.stream(d0))
        _build.check_launch(rc, f"{entry} variant")
        return out
    return run


def median_call(lib, img):
    out = torch.empty_like(img)
    h, w = img.shape

    def run():
        rc = lib.median5_launch(img.data_ptr(), out.data_ptr(), h, w,
                                _build.stream(img))
        _build.check_launch(rc, "median5 variant")
        return out
    return run


def fmnmx_rate(cs, dev, reps: int) -> None:
    """Times FMNMX_SRC over 132 x 8 blocks of 256 threads and prints the
    min/max a second it issued."""
    lib, used = build("fmnmx", FMNMX_SRC, "refine_v", ("fmnmx_kernel",))
    lib.fmnmx_launch.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2
                                 + [ctypes.c_void_p])
    lib.fmnmx_launch.restype = ctypes.c_int
    blocks, steps = 132 * 8, 4096
    out = torch.empty(blocks * 256, device=dev)

    def run():
        _build.check_launch(lib.fmnmx_launch(out.data_ptr(), blocks, steps,
                                             _build.stream(out)), "fmnmx")
    ms = cs.cuda_ms(torch, run, reps)
    n = blocks * 256 * steps * 16
    print(f"  fmnmx ({used}): {n} min/max in {ms:.4f} ms: "
          f"{n / ms / 1e9:.2f} T/s (the bounds count 33.5)")


def subpixel_call(lib, d0, vol, disp_max, thresh, xrev):
    """A call of the build's subpixel_launch: ``vol`` (H, W', D') read
    through its strides, as ``ops/post.py _subpixel`` passes it."""
    out = torch.empty_like(d0)
    h, w = d0.shape
    code = post.STORAGE[vol.dtype]

    def run():
        rc = lib.subpixel_launch(d0.data_ptr(), vol.data_ptr(),
                                 out.data_ptr(), h, w, *vol.stride(),
                                 vol.shape[2], code, int(xrev),
                                 int(disp_max), thresh, _build.stream(d0))
        _build.check_launch(rc, "subpixel variant")
        return out
    return run


def subpixel_cases(seen, size: str) -> dict:
    """{case: (d0, volume, disp_max, thresh, xrev, plain)} of the subpixel
    cases at ``size``: the captured x-reversed volume in its three storage
    types and relaid as (D, H, W) (read as its (H, W, D) view)."""
    (d0, vol, dd), kw = seen["subpixel_enhancement_hwd"]
    thresh, xrev = kw.get("denom_thresh", 1e-5), kw.get("xrev", False)
    h, w = d0.shape
    cases = {}
    for kind, dt in (("", torch.float32), ("-bf16", torch.bfloat16),
                     ("-f16", torch.float16)):
        v = vol.to(dt)
        cases[f"sp-{size}{kind}"] = (
            d0, v, dd, thresh, xrev,
            lambda v=v: post.subpixel_enhancement_hwd_plain(
                d0, v, dd, thresh, xrev))
    dhw = vol[:, :w, :dd].flip(1).permute(2, 0, 1).contiguous()
    cases[f"sp-{size}-dhw"] = (d0, dhw.permute(1, 2, 0), dd, 1e-5, False,
                               lambda: post.subpixel_enhancement_plain(
                                   d0, dhw, dd))
    return cases


def bits_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def compare(cs, case: str, runs: dict, plain, variants, reps: int) -> None:
    """Hold the source's build against ``plain`` and each variant that
    keeps the function against the source's build; print the times."""
    want = runs["source"]().clone()
    torch.cuda.synchronize()
    if not bits_equal(want, plain()):
        raise SystemExit(f"{case}: the source's build differs from the "
                         f"plain version")
    print(f"  {case}: source {cs.graph_ms(torch, runs['source'], reps):.5f}, "
          f"bit-identical to the plain version")
    for v in variants:
        same = ""
        if v.startswith("file:") or not any(n in v.split("+")
                                            for n in NOT_SAME):
            got = runs[v]()
            torch.cuda.synchronize()
            if not bits_equal(got, want):
                raise SystemExit(f"variant {v} differs from the source's "
                                 f"build: {case}")
            same = ", bit-identical"
        times = [cs.graph_ms(torch, runs[n], reps)
                 for n in ("source", v, v, "source")]
        print(f"    source / {v} / {v} / source: "
              f"{' / '.join(f'{t:.5f}' for t in times)}{same}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=_build.CSRC / "refine.cu")
    ap.add_argument("--variant", nargs="*", default=[])
    cases = (*OC_CASES, *MM_CASES, *SP_CASES, *MD_CASES, "fmnmx")
    ap.add_argument("--case", nargs="+", choices=cases, default=list(cases))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    cs = chip_smoke()
    dev = torch.device("cuda")
    base = args.source.read_text()
    libs = {}
    for tag, src in [("source", base)] + [
            (v, variant_source(base, v)) for v in args.variant]:
        libs[tag], used = load(tag, src)
        print(f"{tag}:\n  {used}")
    print(f"{torch.cuda.get_device_name(0)}; {args.source}; ms a call in a "
          f"CUDA graph of {args.reps} calls")
    if "fmnmx" in args.case:
        fmnmx_rate(cs, dev, args.reps)
    _build.build()  # the package's own kernels, for the captured runs
    for size in ("kitti", "mb"):
        want = [c for c in args.case if c.startswith((f"sp-{size}",
                                                      f"md-{size}"))
                or (size == "kitti" and c in (*MM_CASES, *OC_CASES,
                                              "md-adversarial"))]
        if not want:
            continue
        seen = capture(cs, size, dev)
        if size == "kitti":
            (d0, lab), _ = seen["interpolate_occlusion"]
            if "oc-kitti" in want:
                compare(cs, "oc-kitti", {
                    t: fill_call(lib, "occlusion_fill", d0, lab)
                    for t, lib in libs.items()},
                    lambda: post.interpolate_occlusion_plain(d0, lab),
                    args.variant, args.reps)
            (d0, lab), _ = seen["interpolate_mismatch"]
            maps = cs.mismatch_maps(lab)
            for case in (c for c in MM_CASES if c in want):
                lb = maps[MM_CASES[case]]
                share = float((lb == 2).float().mean())
                print(f"  {case}: {share:.5f} of {tuple(lb.shape)} MISMATCH")
                compare(cs, case, {t: fill_call(lib, "mismatch_fill", d0, lb)
                                   for t, lib in libs.items()},
                        lambda lb=lb: post.interpolate_mismatch_plain(d0, lb),
                        args.variant, args.reps)
        (img, _), _ = seen["median2d"]
        medians = {f"md-{size}": img}
        if size == "kitti":
            medians["md-adversarial"] = cs.adversarial_median(torch, img)
        for case, m in medians.items():
            if case in want:
                print(f"  {case}: {cs.median_paths(torch, m)}")
                compare(cs, case, {t: median_call(lib, m)
                                   for t, lib in libs.items()},
                        lambda m=m: post.median2d_plain(m, 5), args.variant,
                        args.reps)
        for case, (d0, v, dd, thresh, xrev, plain) in subpixel_cases(
                seen, size).items():
            if case in want:
                compare(cs, case, {t: subpixel_call(lib, d0, v, dd, thresh,
                                                    xrev)
                                   for t, lib in libs.items()},
                        plain, args.variant, args.reps)
        del seen
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
