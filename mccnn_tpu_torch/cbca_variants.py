"""Time variants of the CBCA kernel against a build of its source.

    python -m mccnn_tpu_torch.cbca_variants [--source PATH]
        [--variant NAME[+NAME] ...] [--case mb14 kitti5 ...] [--reps 5]

On one CUDA card: builds a CBCA source (by default the shipped
``csrc/cross.cu``; ``--source`` names another, such as an earlier
commit's unpacked under ``build/``) and each named variant of it (text
edits of that source, ``a+b`` for several, written and compiled under
``build/`` with the package's nvcc flags), then times the C entry
``cbca_launch`` alone (CUDA events over ``--reps`` calls after a
warm-up, in turns: source, variant, variant, source) on seeded inputs:
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
from pathlib import Path

import torch

from mccnn_tpu_torch.ops import _build, cross
from mccnn_tpu_torch.utils.images import standardize

# name -> (D, H, W, L1, tau1)
CASES = {"mb14": (200, 1000, 1500, 14, 0.02),
         "kitti5": (228, 370, 1226, 5, 0.13),
         "kitti3": (228, 370, 1226, 3, 0.03),
         "kitti2": (228, 370, 1226, 0, 0.01)}

_GUARD = "if (hs[threadIdx.x] == 12345.f) o[0] = 1.f;\n  return;\n"

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
    "no-vertical": ("window", [
        ("  // --- vertical pass: VP rows of one column a task",
         "  " + _GUARD + "  // --- vertical pass: VP rows of one column a task", 1)]),
}


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
    ap.add_argument("--case", nargs="+", choices=sorted(CASES),
                    default=["mb14", "kitti5", "kitti2"])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    base = args.source.read_text()
    plan = plan_of(base)
    libs = {}
    for tag, src in [("source", base)] + [
            (v, variant_source(base, v)) for v in args.variant]:
        libs[tag], used = build(tag, src)
        print(f"{tag}:\n  {used}")
    print(f"{torch.cuda.get_device_name(0)}; {args.source} ({plan} plan); "
          f"cbca_launch ms a call (mean of {args.reps} after a warm-up)")
    for case in args.case:
        arms, vol, L1 = inputs(case, dev)
        runs = {tag: launcher(lib, plan, arms, vol, L1)
                for tag, lib in libs.items()}
        want = runs["source"]().clone()
        print(f"  {case} (D, H, W = {tuple(vol.shape)}, K = {max(2, L1)}): "
              f"source {ms(runs['source'], args.reps):.4f}")
        for v in args.variant:
            same = ""
            if not any(n in v for n in ("arms-once", "no-store", "stage-only",
                                        "no-vertical", "no-count", "arms-near")):
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
