"""Time variants of the CBCA and arms kernels against a build of their
source.

    python -m mccnn_tpu_torch.cbca_variants [--source PATH]
        [--variant NAME[+NAME] ...] [--case mb14 kitti5 arms-k5 ...]
        [--reps 5]

On one CUDA card, from the repository's root: builds a ``cross.cu`` (by
default the shipped ``csrc/cross.cu``; ``--source`` names another, such
as an earlier commit's unpacked under ``build/``) and each named variant
of it (text edits of that source, ``a+b`` for several, or ``file:PATH``,
another whole source such as the parent's; written and compiled under
``build/`` with the package's nvcc flags). The ``arms-*`` cases time the
C entry ``cross_arms_launch`` alone in a CUDA graph of 20 calls
(``chip_smoke.graph_ms``; in turns: source, variant, variant, source) on
the path's own images, those ``chip_smoke.py`` holds the arms kernel on:
phase 3's KITTI image (370x1226) at K = 2, 3, 5, 14 with each config's
tau1 (``arms-k2`` .. ``arms-k14``) and its ``nan_image`` at K = 5
(``arms-nan5``), phase 3b's Middlebury image (1000x1500) at K = 14
(``arms-mb14``); and, where most arms are long, slow gradients with a
faint copy of the KITTI texture at K = 14 (``arms-smooth14``: the
kernel's walk past its windows); the source's build bit for bit against
``cross_arms_plain``. The other cases time ``cbca_launch`` alone (CUDA
events over ``--reps`` calls after a warm-up, in turns) on seeded inputs:
the arms of a standardized random-texture image at the config's tau1
and a random volume with NaN where the match leaves the frame, at
Middlebury's ``-a time`` shape (1000x1500, D = 200, K = 14: ``mb14``)
and KITTI's (370x1226, D = 228: ``kitti5``, ``kitti3``, ``kitti2``),
the -1 direction. A variant that keeps the function is held bit for bit
against the source's build. Prints each build's registers and stack
(ptxas) for the CBCA kernel.

Variants of the interval plan (the earlier kernel, whose ``cbca_launch``
takes the float arm stacks):

- ``fixed-trips``: both loops run the whole window of 2K - 1 taps and
  add the taps inside the interval (the same bits);
- ``arms-once``: every cell takes the arms of its block's first pixel,
  moved to its own column and row (one broadcast load a block instead
  of four floats a cell from L2; the trip counts change with the arms:
  time it on top of ``fixed-trips``);
- ``no-store``: the output stores kept only for a NaN payload that never
  occurs (the work stays, the stores go);
- ``stage-only``: the block stages its volume tile and stops.

Variants of the arms kernel (the register windows; ``arms-ay*``, ``arms-np*``
and ``arms-scalar`` keep the function):

- ``arms-no-probes``: K taken as 2 inside the kernel (the centres
  loaded and the four planes stored, no probe: the floor of the design);
- ``arms-empty``: the blocks return at once (the launch);
- ``arms-ay1``, ``arms-ay4``, ``arms-ay8``: rows a thread (2 in the
  source);
- ``arms-np1``, ``arms-np2``, ``arms-np4``, ``arms-np6``: the most
  probes an arm from the first register windows (3 in the source);
- ``arms-kwin5``: no second windows (the arms that run past the first
  walk from k = 5, a call a lane);
- ``arms-scalar``: 4-byte loads and stores only.

Variants of the window plan (``cbca_launch`` takes the offsets packed
by ``cbca_pack``):

- ``no-store``: as above;
- ``no-vertical``: the vertical pass left out (the staging and the
  horizontal pass stay);
- ``no-count``: the vertical pass adds no counts (each output divided by
  1: the integer adds' share);
- ``ts-128``: blocks of 128 rows (the horizontal pass's halo rows 2R
  over 128 rows instead of 64; the same bits);
- ``tile-32x128``: blocks of 32 columns and 128 rows (as ``ts-128`` at
  the shared memory of 64 x 64; the staged columns' halo doubles);
- ``arms-near``: the horizontal pass reads its offset pairs from row 0
  (the sums' masks change, their instruction count does not);
- ``min-blocks-4``, ``min-blocks-6``: the kernel's launch bounds ask
  for 4 (6) resident blocks an SM, which caps its registers (the same
  bits).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from mccnn_tpu_torch.ops import _build, cross
from mccnn_tpu_torch.utils.images import standardize

# name -> (D, H, W, L1, tau1)
CASES = {"mb14": (200, 1000, 1500, 14, 0.02),
         "kitti5": (228, 370, 1226, 5, 0.13),
         "kitti3": (228, 370, 1226, 3, 0.03),
         "kitti2": (228, 370, 1226, 0, 0.01)}

# name -> (image, L1, tau1) of the arms cases
ARMS_CASES = {"arms-k2": ("kitti", 0, 0.01), "arms-k3": ("kitti", 3, 0.03),
              "arms-k5": ("kitti", 5, 0.13), "arms-k14": ("kitti", 14, 0.02),
              "arms-nan5": ("kitti NaN", 5, 0.13),
              "arms-mb14": ("mb", 14, 0.02),
              "arms-smooth14": ("kitti smooth", 14, 0.02)}

_GUARD = "if (hs[threadIdx.x] == 12345.f) o[0] = 1.f;\n  return;\n"
_ARMS_FIRST = ("  const int x0 = (blockIdx.x * ANX + threadIdx.x % ANX) * AX;"
               "\n")

# (plan, [(old, new, occurrences)]) text edits of a cross.cu
VARIANTS = {
    "fixed-trips": ("interval", [
        ("for (int xx = lo; xx <= hi; ++xx) s = __fadd_rn(s, sv[row + xx]);",
         "for (int xx = x - R; xx <= x + R; ++xx)\n"
         "        if (xx >= lo && xx <= hi) s = __fadd_rn(s, sv[row + xx]);", 1),
        ("for (int yy = lo; yy <= hi; ++yy) {",
         "for (int yy = y - R; yy <= y + R; ++yy) if (yy >= lo && yy <= hi) {",
         1)]),
    "arms-once": ("interval", [
        ("""      const size_t p = (size_t)y * W + x;
      const int xs = max((int)x0c[p], (int)x1c[p + delta] - delta);
      const int xt = min((int)x0c[plane + p],
                         (int)x1c[plane + p + delta] - delta);""",
         """      const size_t p = (size_t)by * W + bx;
      const int xs = x - bx + (int)x0c[p];
      const int xt = x - bx + (int)x0c[plane + p];""", 1),
        ("""      const int ys = max((int)x0c[2 * plane + p],
                         (int)x1c[2 * plane + p + delta]);
      const int yt = min((int)x0c[3 * plane + p],
                         (int)x1c[3 * plane + p + delta]);""",
         """      const size_t pb = (size_t)by * W + bx;
      const int ys = y - by + (int)x0c[2 * plane + pb];
      const int yt = y - by + (int)x0c[3 * plane + pb];""", 1)]),
    "no-store": (None, [
        ("    out[d * plane + p] = o;",
         "    if (__float_as_uint(o) == 0x7fbfffffu) out[d * plane + p] = o;", 1),
        ("      if (y0 + j < H) orow[j * W] = __fdiv_rn(",
         "      if (y0 + j < H && __float_as_uint(s[j]) == 0x7fbfffffu)"
         " orow[j * W] = __fdiv_rn(", 1)]),
    "stage-only": ("interval", [
        ("""    sv[i] = t;
  }
  __syncthreads();
""", """    sv[i] = t;
  }
  __syncthreads();
  if (sv[threadIdx.x] == 12345.f) out[0] = 1.f;
  return;
""", 1)]),
    "ts-128": ("window", [("constexpr int TX = 64, TS = 64;",
                            "constexpr int TX = 64, TS = 128;", 1)]),
    "tile-32x128": ("window", [("constexpr int TX = 64, TS = 64;",
                                 "constexpr int TX = 32, TS = 128;", 1)]),
    "arms-near": ("window", [(
        "    const size_t yr = min(max(by - R + k0 + r, 0), H - 1);",
        "    const size_t yr = 0;", 1)]),
    "min-blocks-4": ("window", [("__launch_bounds__(NT)\ncbca_kernel(",
                                  "__launch_bounds__(NT, 4)\ncbca_kernel(", 1)]),
    "min-blocks-6": ("window", [("__launch_bounds__(NT)\ncbca_kernel(",
                                  "__launch_bounds__(NT, 6)\ncbca_kernel(", 1)]),
    "no-count": ("window", [("          n[j] += cn;\n", "", 1)]),
    "arms-no-probes": (None, [("  const int np = min(K - 2, NPMAX);",
                               "  K = 2;\n  const int np = min(K - 2, NPMAX);",
                               1)]),
    "arms-empty": (None, [(_ARMS_FIRST, "  if (W > 0) return;\n" + _ARMS_FIRST,
                           1)]),
    **{f"arms-ay{n}": (None, [("constexpr int AY = 2;",
                               f"constexpr int AY = {n};", 1)])
       for n in (1, 4, 8)},
    **{f"arms-np{n}": (None, [("constexpr int NPMAX = 3;",
                               f"constexpr int NPMAX = {n};", 1)])
       for n in (1, 2, 4, 6)},
    "arms-kwin5": (None, [("constexpr int KWIN = 14;",
                           "constexpr int KWIN = 5;", 1)]),
    "arms-scalar": (None, [(
        "if (W % 2 == 0 && aligned8(img) && aligned8(arms))", "if (false)",
        1)]),
    "no-vertical": ("window", [
        ("  // --- vertical pass: VP rows of one column a task",
         "  " + _GUARD + "  // --- vertical pass: VP rows of one column a task", 1)]),
}


# the variants that change what a kernel computes
NOT_SAME = ("arms-once", "no-store", "stage-only", "no-vertical", "no-count",
            "arms-near", "arms-no-probes", "arms-empty")


def chip_smoke():
    """The repository's ``chip_smoke.py`` as a module."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    return cs


def plan_of(src: str) -> str:
    return "window" if "cbca_pack_launch" in src else "interval"


def apply_edits(src: str, name: str, edits) -> str:
    """``src`` with the edits ``[(old, new, occurrences)]`` of the variant
    ``name`` that match it (an edit matches where ``old`` occurs that many
    times); at least one must."""
    hits = [e for e in edits if src.count(e[0]) == e[2]]
    if not hits:
        raise SystemExit(f"variant {name}: no edit of it matches the source")
    for old, new, _ in hits:
        src = src.replace(old, new)
    return src


def variant_source(src: str, names: str) -> str:
    if names.startswith("file:"):
        return Path(names[5:]).read_text()
    plan = plan_of(src)
    for name in names.split("+"):
        want, edits = VARIANTS[name]
        if want not in (None, plan):
            raise SystemExit(f"variant {name} edits the {want} plan; the "
                             f"source has the {plan} plan")
        src = apply_edits(src, name, edits)
    return src


def build(tag: str, src: str, prefix: str = "cbca_v",
          kernels=("cbca_kernel",)) -> tuple[ctypes.CDLL, str]:
    """Compile ``src`` as ``build/lib<prefix>_<tag>.so`` with the package's
    flags; the library and ptxas's stack, spills and registers of each
    entry whose name holds one of ``kernels``."""
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    stem = f"{prefix}_" + re.sub(r"[^a-z0-9]+", "_", tag)
    cu, lib = _build.BUILD / f"{stem}.cu", _build.BUILD / f"lib{stem}.so"
    cu.write_text(src)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(cu)], capture_output=True, text=True)
    log = out.stdout + out.stderr
    if out.returncode:
        raise SystemExit(f"{tag}: nvcc exit {out.returncode}:\n{log}")
    used, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the kernel's name and its template arguments, if any
            entry = re.search(rf"({'|'.join(kernels)})(I\w+?E)?", m.group(1))
        elif entry and ("Used" in line or "spill" in line):
            used.append(f"{entry.group(0)}: {line.split(':', 1)[-1].strip()}")
    return ctypes.CDLL(str(lib)), "\n  ".join(used)


def inputs(case: str, dev):
    D, H, W, L1, tau1 = CASES[case]
    g = torch.Generator(device="cpu").manual_seed(D + H + W + L1)
    img = torch.randn((2, H, W), generator=g)
    arms = [cross.cross_arms(torch.as_tensor(standardize(i.numpy()),
                                             device=dev), L1, tau1)
            for i in img]
    vol = torch.rand((D, H, W), generator=g).to(dev)
    xs = torch.arange(W, device=dev)[None, None, :]
    ds = torch.arange(D, device=dev)[:, None, None]
    vol[(xs - ds < 0).expand(D, H, W)] = float("nan")
    return arms, vol, L1


def launcher(lib: ctypes.CDLL, plan: str, arms, vol, L1):
    """A call of the build's cbca_launch on these inputs (the window plan
    reads the offsets packed once here)."""
    D, H, W = vol.shape
    K = max(2, int(L1))
    ops = arms if plan == "interval" else [cross.cbca_pack(*arms, L1)]
    lib.cbca_launch.argtypes = ([ctypes.c_void_p] * (len(ops) + 2)
                                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.cbca_launch.restype = ctypes.c_int
    out = torch.empty_like(vol)

    def run():
        rc = lib.cbca_launch(vol.data_ptr(), *(t.data_ptr() for t in ops),
                             out.data_ptr(), D, H, W, K, -1,
                             _build.stream(vol))
        _build.check_launch(rc, "cbca variant")
        return out
    return run


def arms_image(cs, which: str, dev):
    """The path's image of an arms case (``ARMS_CASES``): chip_smoke.py's
    KITTI pair (phase 3), its NaN image, or its Middlebury pair (phase
    3b)."""
    if which == "mb":
        img = cs.kitti_pair(np.random.RandomState(3), 1000, 1500,
                            cs.MB_SHIFT)[0]
    else:
        img = cs.kitti_pair(np.random.RandomState(0), cs.H, cs.W, cs.SHIFT)[0]
    img = torch.as_tensor(img, device=dev)
    if which.endswith("smooth"):
        # slow gradients and faint texture: neighbours 0.002-0.004 apart,
        # so at tau1 0.02 most arms run past the register windows
        ys = torch.arange(img.shape[0], device=dev)[:, None]
        xs = torch.arange(img.shape[1], device=dev)[None, :]
        return torch.sin(xs / 400.0) + torch.cos(ys / 300.0) + 1e-3 * img
    return cs.nan_image(torch, img) if which.endswith("NaN") else img


def arms_launcher(lib: ctypes.CDLL, img, L1, tau1):
    """A call of the build's cross_arms_launch on ``img``."""
    lib.cross_arms_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float]
        + [ctypes.c_void_p])
    lib.cross_arms_launch.restype = ctypes.c_int
    H, W = img.shape
    out = torch.empty((4, H, W), dtype=torch.float32, device=img.device)

    def run():
        rc = lib.cross_arms_launch(img.data_ptr(), out.data_ptr(), H, W,
                                   max(2, int(L1)), float(tau1),
                                   _build.stream(img))
        _build.check_launch(rc, "cross_arms variant")
        return out
    return run


def time_arms(cs, case: str, libs: dict, variants, dev) -> None:
    """The arms case ``case``: the source's build against the plain
    version bit for bit, each variant that keeps the function against
    the source's build, and the times in a CUDA graph in turns."""
    which, L1, tau1 = ARMS_CASES[case]
    img = arms_image(cs, which, dev)
    runs = {tag: arms_launcher(lib, img, L1, tau1) for tag, lib in libs.items()}
    want = runs["source"]().clone()
    torch.cuda.synchronize()
    plain = cross.cross_arms_plain(img, L1, tau1)
    if not torch.equal(want.view(torch.int32), plain.view(torch.int32)):
        raise SystemExit(f"{case}: the source's build differs from the plain "
                         "version")
    h, w = img.shape
    print(f"  {case} ({which} {h}x{w}, K = {max(2, L1)}, tau1 {tau1}): "
          f"source {cs.graph_ms(torch, runs['source'], 20):.5f}, "
          f"bit-identical to the plain version; bound "
          f"{cs.bound_ms(20 * h * w, 0)[0]:.5f} (bytes)")
    for v in variants:
        same = ""
        if v.startswith("file:") or not any(n in v.split("+")
                                            for n in NOT_SAME):
            got = runs[v]()
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise SystemExit(f"variant {v} differs from the source's "
                                 f"build: {case}")
            same = ", bit-identical"
        times = [cs.graph_ms(torch, runs[n], 20)
                 for n in ("source", v, v, "source")]
        print(f"    source / {v} / {v} / source: "
              f"{' / '.join(f'{t:.5f}' for t in times)}{same}")


def ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=_build.CSRC / "cross.cu")
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--case", nargs="+",
                    choices=sorted(CASES) + list(ARMS_CASES),
                    default=["mb14", "kitti5", "kitti2"])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    base = args.source.read_text()
    plan = plan_of(base)
    libs = {}
    for tag, src in [("source", base)] + [
            (v, variant_source(base, v)) for v in args.variant]:
        libs[tag], used = build(tag, src,
                                kernels=("cbca_kernel", "cross_arms_kernel"))
        print(f"{tag}:\n  {used}")
    print(f"{torch.cuda.get_device_name(0)}; {args.source} ({plan} plan); "
          f"cbca_launch ms a call (mean of {args.reps} after a warm-up), "
          f"cross_arms_launch ms a call in a CUDA graph of 20")
    cs = chip_smoke() if any(c in ARMS_CASES for c in args.case) else None
    for case in args.case:
        if case in ARMS_CASES:
            time_arms(cs, case, libs, args.variant, dev)
            continue
        arms, vol, L1 = inputs(case, dev)
        runs = {tag: launcher(lib, plan, arms, vol, L1)
                for tag, lib in libs.items()}
        want = runs["source"]().clone()
        print(f"  {case} (D, H, W = {tuple(vol.shape)}, K = {max(2, L1)}): "
              f"source {ms(runs['source'], args.reps):.4f}")
        for v in args.variant:
            same = ""
            if v.startswith("file:") or not any(n in v.split("+")
                                                for n in NOT_SAME):
                got = runs[v]()
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    raise SystemExit(f"variant {v} differs from the source's "
                                     f"build: {case}")
                same = ", bit-identical"
            times = [ms(runs[n], args.reps) for n in ("source", v, v, "source")]
            print(f"    source / {v} / {v} / source: "
                  f"{' / '.join(f'{t:.4f}' for t in times)}{same}")
        del arms, vol, runs, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
