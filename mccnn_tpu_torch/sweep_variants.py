"""Time variants of the scan form's sweep kernel against the shipped one.

    python -m mccnn_tpu_torch.sweep_variants [--variant d2-loads no-store]
        [--reps 5]

On one CUDA card: builds ``csrc/sgm_sweep.cu`` and each named variant of
it (a text edit of the shipped source, written and compiled under
``build/`` with the package's nvcc flags), then times the scan form's
entry ``sgm_sweep_scan`` (the kernel ``sgm_sweep_step`` runs too) at the
KITTI census shapes, D = 228: the horizontal family (T = 1226 steps,
S = 740 scanlines) and the vertical one (T = 370, S = 2452), forward and
reverse, on seeded random slices and tables. Each case runs the builds
in turns (shipped, variant, variant, shipped), CUDA events over
``--reps`` calls after a warm-up, and holds each variant's result bit for
bit against the shipped build's where the variant keeps the function.
Variants:

- ``d2-loads``: the D2 table read by plain float4 loads one step ahead,
  as the vertical entry reads its window, instead of streamed through
  the ring (the ring then carries the volume alone);
- ``no-store``: the output stores left out, so what is left is the
  reads and the recurrence (no check: there is no result).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from mccnn_tpu_torch.ops import _build, sgm

SHAPES = {"horizontal": (1226, 740), "vertical": (370, 2452)}
D = 228

_LOADS_OLD = """  auto load_pen = [&](int s) {
    nd1 = d1[(size_t)s * Ws + x];
    if constexpr (!TABLE) {"""
_LOADS_NEW = """  auto load_pen = [&](int s) {
    nd1 = d1[(size_t)s * Ws + x];
    if constexpr (TABLE) {
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const float4 t = live[q] ? *reinterpret_cast<const float4*>(
            g_rev + ((size_t)s * Ws + x) * Dp + 4 * (lane + 32 * q))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        nd2[q][0] = t.x;
        nd2[q][1] = t.y;
        nd2[q][2] = t.z;
        nd2[q][3] = t.w;
      }
    } else {"""

# (old, new, occurrences) text edits of csrc/sgm_sweep.cu
VARIANTS = {
    "d2-loads": [
        ("const bool two = TABLE || has_acc;", "const bool two = has_acc;", 1),
        ("SRC == D2Src::TABLE || acc != nullptr", "acc != nullptr", 1),
        (_LOADS_OLD, _LOADS_NEW, 1),
        ("      if constexpr (!TABLE) {\n#pragma unroll\n        for (int q = 0; q < NG; ++q)\n#pragma unroll\n          for (int e = 0; e < 4; ++e) D2[q][e] = nd2[q][e];",
         "      if constexpr (true) {\n#pragma unroll\n        for (int q = 0; q < NG; ++q)\n#pragma unroll\n          for (int e = 0; e < 4; ++e) D2[q][e] = nd2[q][e];", 1),
        ("if constexpr (TABLE) {  // dead lanes: any D2",
         "if constexpr (false) {", 1),
    ],
    "no-store": [
        ("if (out && live[q]) store4<S>(out + cell",
         "if (false && out && live[q]) store4<S>(out + cell", 1),
    ],
}


def variant_source(name: str) -> str:
    src = (_build.CSRC / "sgm_sweep.cu").read_text()
    for old, new, n in VARIANTS[name]:
        if src.count(old) != n:
            raise RuntimeError(f"variant {name}: {old[:50]!r} found "
                               f"{src.count(old)} times, expected {n}")
        src = src.replace(old, new)
    return src


def build_variant(name: str) -> ctypes.CDLL:
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD / f"sgm_sweep_{name}.cu"
    src.write_text(variant_source(name))
    lib = _build.BUILD / f"libsgm_sweep_{name}.so"
    log = _build.BUILD / f"sgm_sweep_{name}.log"
    with open(log, "w") as f:
        rc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                             str(src)], stdout=f, stderr=subprocess.STDOUT).returncode
    if rc:
        raise RuntimeError(f"variant {name}: nvcc exit {rc}:\n{log.read_text()}")
    return ctypes.CDLL(str(lib))


def inputs(T: int, S: int, seed: int, dev):
    """Slices as the census volumes give them: NaN where the match leaves
    the frame (a run of top disparities on half the scanlines), D1 and D2
    around tau so that all three penalty classes occur."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vol = torch.rand((T, S, D), generator=g, device=dev)
    vol[:, : S // 2, D - D // 3:] = float("nan")
    d1 = torch.rand((T, S), generator=g, device=dev) * 0.16
    d2 = torch.rand((T, S, D), generator=g, device=dev) * 0.16
    return vol, d1, d2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", nargs="+", choices=sorted(VARIANTS),
                    default=sorted(VARIANTS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    libs = {"shipped": _build.library("sgm_sweep")}
    libs.update((name, build_variant(name)) for name in args.variant)
    for name in libs:
        log = _build.log_path("sgm_sweep") if name == "shipped" \
            else _build.BUILD / f"sgm_sweep_{name}.log"
        lines = log.read_text().splitlines()
        for i, line in enumerate(lines):  # the instance of D = 228
            if "properties" in line and "vsweep_kernelILi2ELNS_5D2SrcE2" in line:
                used = next(u for u in lines[i:] if "Used" in u)
                print(f"{name}: {used.strip()}")
    pen = sgm.pen_table(1.32, 24.25, 3.0, 2.0, 1.0, 1.0)

    def run(name, vol, d1, d2, reverse):
        _build._LIBS["sgm_sweep"] = libs[name]
        return sgm.sweep_stream(vol, d1, d2, tau=0.08, pen=pen, reverse=reverse)

    def ms(name, *a):
        run(name, *a)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            run(name, *a)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    print(f"{torch.cuda.get_device_name(0)}; sgm_sweep_scan at D={D}, ms a "
          f"launch (mean of {args.reps} after a warm-up)")
    for family, (T, S) in SHAPES.items():
        vol, d1, d2 = inputs(T, S, T + S, dev)
        for reverse in (False, True):
            a = (vol, d1, d2, reverse)
            want = run("shipped", *a)
            for name in args.variant:
                if name != "no-store":
                    got = run(name, *a)
                    if not (torch.equal(got.isnan(), want.isnan()) and torch.equal(
                            got.nan_to_num(), want.nan_to_num())):
                        raise SystemExit(f"variant {name} differs from the "
                                         f"shipped build: {family}, reverse={reverse}")
                    del got
                times = [ms(n, *a) for n in ("shipped", name, name, "shipped")]
                print(f"  {family} reverse={reverse}: shipped / {name} / {name} / "
                      f"shipped {' / '.join(f'{t:.4f}' for t in times)}")
            del want
        del vol, d1, d2
    _build._LIBS["sgm_sweep"] = libs["shipped"]


if __name__ == "__main__":
    main()
