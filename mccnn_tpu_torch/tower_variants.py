"""Time the tower kernels of other ``csrc/tower.cu`` or ``csrc/conv.cu``
sources against this one.

    python -m mccnn_tpu_torch.tower_variants [--kernel tower|conv]
        [--source OTHER.cu ...] [--case kitti mb] [--reps 10]
        [--widths 64 112] [--split]

Builds this checkout's ``csrc/tower.cu`` (or, with ``--kernel conv``,
``csrc/conv.cu``) and each ``--source`` (the same ``nvcc`` flags, into
``build/``) and times, at the KITTI fast and slow shapes (370x1226,
D=228; 64 and 112 channels, and with ``--kernel conv`` each width of
``ops/conv.py`` ``WIDTHS``) or the Middlebury ones (1000x1500, D=200), on
seeded random inputs, in turns (this source, the others, the others, this
source), each call in a CUDA graph. Every other source must keep the C
entries' signatures.

- ``--kernel tower``: each source's ``tower_normalize`` (the join's
  operands of both sides and of the left side, and the features),
  ``tower_bias_act`` and ``slow_volumes_epilogue`` through the wrappers of
  ``ops/tower.py``, each held bit for bit to this source's; each form's
  bound by bytes (inputs read once, outputs written once, at 3.35 TB/s).
- ``--kernel conv``: each source's convolutions through ``ops/conv.py``
  ``conv3x3`` (the first layer, one plane into C, and a C into C layer, in
  float32 and with ``-dtype bfloat16``; ``--widths`` picks the C), with
  ``F.conv2d`` (cuDNN, TF32 off) timed in the same turns as the library's
  yardstick; each source's output bit for bit this source's and within
  2e-6 of sum |w||x| from ``F.conv2d``'s; then the layer with its bias
  and ReLU: this source's fused epilogue (``conv3x3(..., bias, relu)``)
  against each source's bias-free convolution followed by
  ``tower.bias_act``, bit for bit; each form's bound: the bytes, and the
  operations at the bf16 tensor-core peak (six passes in float32, one in
  bfloat16) or, for the first layer, at the f32 peak.
- ``--kernel conv --split``: each ``--source`` and its text variants
  (``SPLIT``: the three-level split replaced by one rounding, the
  ``wgmma`` instruction left out, the staging waits left out, the
  epilogue's stores left out), the C into C layer only, timed in turns
  with no check of their outputs: what each part of a source's kernel
  costs.

Prints the card and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from mccnn_tpu_torch.ops import _build, join, tower

MEM_BPS = 3.35e12
F32_OPS, BF16_TC_OPS = 67e12, 989e12
CASES = {"kitti": (370, 1226, 228), "mb": (1000, 1500, 200)}
# the checks that failed (the run goes on to time the rest)
FAILED: list[str] = []
# --split: a conv.cu's text variants, each a list of (text, replacement)
# pairs applied where the text occurs (a variant none of whose texts
# occurs is left out): the float32 split as one rounding a level, the
# wgmma instruction a PTX comment (its operands still bound, so nothing
# upstream is dropped), the staging copies' waits gone (the first design's
# cp.async waits; a design whose row slots are handed back on mbarriers
# has no safe counterpart: its consumers would run ahead of the ring's
# phases), the epilogue's stores behind a test that never holds
SPLIT = {
    "no-split": [("split2<K::LV>(v0, v1, w);",
                  "for (int l = 0; l < K::LV; ++l) w[l] = pack2(v0, v1);"),
                 ("split2<LV>(v[2 * i], v[2 * i + 1], w);",
                  "for (int l = 0; l < LV; ++l) w[l] = pack2(v[2 * i], "
                  "v[2 * i + 1]);")],
    "no-wgmma": [('"wgmma.mma_async.sync.aligned.m64n"',
                  '"// wgmma.mma_async.sync.aligned.m64n"')],
    "no-wait": [("copy_wait();", "")],
    "no-store": [("o[(size_t)(8 * n8 + 2 * t4 + e) * HW] = v;",
                  "if (v == 1.2345e-38f) o[(size_t)(8 * n8 + 2 * t4 + e) "
                  "* HW] = v;")],
}


def _load(srcs, kernel: str = "tower") -> list[ctypes.CDLL]:
    """The sources' libraries, built beside the checkout's own builds, one
    compiler a source, all at once."""
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in srcs:
        out = (_build.BUILD
               / f"lib{kernel}-variant-{src.parent.name}-{src.stem}.so")
        jobs.append((src, out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for src, out, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{src}: nvcc failed:\n{log}")
        (out.with_suffix(".log")).write_text(log)
        libs.append(ctypes.CDLL(str(out)))
    return libs


def _split_variants(src: Path) -> list[Path]:
    """``src``'s text variants (``SPLIT``), written under ``build/`` beside
    copies of the headers of ``src``'s directory."""
    text = src.read_text()
    out = _build.BUILD / "variants" / src.parent.name
    out.mkdir(parents=True, exist_ok=True)
    for h in src.parent.glob("*.cuh"):
        shutil.copy(h, out / h.name)
    made = []
    for name, subs in SPLIT.items():
        v = text
        for old, new in subs:
            v = v.replace(old, new)
        if v == text:
            print(f"{src}: no text of variant {name}, left out")
            continue
        made.append(out / f"{src.stem}-{name}.cu")
        made[-1].write_text(v)
    return made


def _graph_ms(fn, reps: int, replays: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def _bits(out):
    parts = out[:4] if isinstance(out, tuple) else (out,)
    return [None if t is None else t.view(torch.int32).clone() for t in parts]


def _conv_cases(args, libs, order, checked) -> None:
    """``--kernel conv``: every source's convolutions and ``F.conv2d`` in
    turns, at each case's shapes; the sources in ``checked`` held bit for
    bit to this one's output; then the layer with its bias and ReLU."""
    from mccnn_tpu_torch.ops import conv

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    def use(key):
        _build._LIBS["conv"] = libs[key]
        conv._lib()  # the entries' argument types

    with torch.no_grad():
        for case in args.case:
            H, W, _ = CASES[case]
            for C in args.widths:
                for Ci in ((C,) if args.split else (1, C)):
                    x32 = torch.as_tensor(
                        rng.randn(2, Ci, H, W).astype(np.float32), device=dev)
                    w = torch.as_tensor(
                        (rng.randn(C, Ci, 3, 3) / np.sqrt(9 * Ci))
                        .astype(np.float32), device=dev)
                    b = torch.as_tensor(rng.randn(C).astype(np.float32)
                                        * 0.1, device=dev)
                    for dt in (torch.float32, torch.bfloat16):
                        if Ci == 1 and dt != torch.float32:
                            continue
                        x = x32.to(dt).float()
                        ref = conv.conv3x3_plain(x, w, dt)
                        scale = conv.conv3x3_plain(x.abs(), w.abs(), dt) \
                            .clamp_min(1e-30)
                        ops = 2.0 * x.numel() * 9 * C
                        nbytes = 4.0 * (x.numel() + ref.numel() + w.numel())
                        if Ci == C:
                            ops_ms = (6 if dt == torch.float32 else 1) * ops \
                                / BF16_TC_OPS * 1e3
                        else:
                            ops_ms = ops / F32_OPS * 1e3
                        bound = max(nbytes / MEM_BPS * 1e3, ops_ms)
                        times = {k: [] for k in libs}
                        times["F.conv2d"] = []
                        want = None
                        for key in order:
                            use(key)
                            got = conv.conv3x3(x, w, dt)
                            if key in checked:
                                err = float(((got - ref).abs() / scale).max())
                                if err > 2e-6:
                                    raise SystemExit(
                                        f"{case} C={C} Ci={Ci} {dt}: {key} "
                                        f"is {err} of sum |w||x| from "
                                        "F.conv2d")
                                bits = _bits(got)[0]
                                if want is None:
                                    want = bits
                                elif not torch.equal(bits, want):
                                    differ = int((bits != want).sum())
                                    FAILED.append(
                                        f"{case} C={C} Ci={Ci} {dt}: {key} "
                                        "is not bit for bit this source's "
                                        f"({differ} of {bits.numel()} "
                                        "outputs differ)")
                                    print(FAILED[-1])
                            del got
                            times[key].append(_graph_ms(
                                lambda: conv.conv3x3(x, w, dt), args.reps))
                            times["F.conv2d"].append(_graph_ms(
                                lambda: conv.conv3x3_plain(x, w, dt),
                                args.reps))
                        line = ", ".join(f"{k} " + " / ".join(
                            f"{t:.4f}" for t in v) for k, v in times.items())
                        print(f"{case} {H}x{W} conv {Ci} -> {C} "
                              f"{str(dt).replace('torch.', '')}: {line} ms in "
                              f"a CUDA graph; bound {bound:.4f} ms")
                        if not args.split:
                            _fused(libs, order, use, x, w, b, dt,
                                   f"{case} {H}x{W} conv {Ci} -> {C} "
                                   f"{str(dt).replace('torch.', '')}",
                                   args.reps, nbytes)
                        use("this")
                        del x, ref, scale
                    del x32, w, b
                    torch.cuda.empty_cache()


def _fused(libs, order, use, x, w, b, dt, what, reps, nbytes) -> None:
    """The layer with its bias and ReLU: this source's fused epilogue
    against each source's bias-free convolution followed by
    ``tower.bias_act``, bit for bit, timed in turns."""
    from mccnn_tpu_torch.ops import conv

    use("this")
    fused = _bits(conv.conv3x3(x, w, dt, b, True))[0]
    times = {"this fused": []}
    times.update({f"{k} + tower_bias_act": [] for k in libs})

    def unfused():
        return tower.bias_act(conv.conv3x3(x, w, dt), b, True, dt)

    for key in order:
        use(key)
        if not torch.equal(_bits(unfused())[0], fused):
            FAILED.append(f"{what}: the fused epilogue is not bit for bit "
                          f"{key}'s convolution and tower.bias_act")
            print(FAILED[-1])
        times[f"{key} + tower_bias_act"].append(_graph_ms(unfused, reps))
        use("this")
        times["this fused"].append(_graph_ms(
            lambda: conv.conv3x3(x, w, dt, b, True), reps))
    line = ", ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                     for k, v in times.items())
    print(f"{what} with its bias and ReLU: {line} ms in a CUDA graph; bound "
          f"{nbytes / MEM_BPS * 1e3:.4f} ms (bytes)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("tower", "conv"), default="tower")
    ap.add_argument("--source", nargs="*", default=[], type=Path,
                    help="other sources of the kernel to time against this "
                    "one")
    ap.add_argument("--case", nargs="*", default=list(CASES),
                    choices=list(CASES))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--widths", nargs="*", type=int, default=None,
                    help="--kernel conv: the C of the layers (default "
                    "ops/conv.py WIDTHS)")
    ap.add_argument("--split", action="store_true",
                    help="--kernel conv: time each --source's text variants "
                    "beside it (SPLIT)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tower_variants: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    _build.build((args.kernel,))
    libs = {"this": ctypes.CDLL(str(_build.lib_path(args.kernel)))}
    srcs = {str(src): src for src in args.source}
    checked = set(srcs) | {"this"}
    if args.kernel == "conv" and args.split:
        for src in args.source:
            srcs.update({v.stem: v for v in _split_variants(src)})
    libs.update(zip(srcs, _load(list(srcs.values()), args.kernel)))
    others = [k for k in libs if k != "this"]
    order = ["this"] + others + others + ["this"]
    if args.kernel == "conv":
        from mccnn_tpu_torch.ops import conv

        args.widths = args.widths or list(conv.WIDTHS)
        _conv_cases(args, libs, order, checked)
        if FAILED:
            raise SystemExit("tower_variants: " + "; ".join(FAILED))
        return
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for case in args.case:
            H, W, D = CASES[case]
            for C in (64, 112):
                acc = torch.as_tensor(rng.randn(2, C, H, W).astype(np.float32),
                                      device=dev)
                bias = torch.as_tensor(rng.randn(C).astype(np.float32),
                                       device=dev)
                nbytes = 4 * acc.numel()
                Hp, Wp, Dp = join.pad_dims(H, W, D)
                forms = {"bias_act": (lambda: tower.bias_act(
                    acc, bias, True), 2 * nbytes)}
                if C == 64:
                    wa, wb = Hp * C * Wp * 4, Hp * C * (Wp + Dp) * 4
                    forms.update({
                        "normalize (both sides)": (lambda: tower.normalize(
                            acc, bias, torch.float32, (D, "both")),
                            nbytes + 2 * (wa + wb)),
                        "normalize (left side)": (lambda: tower.normalize(
                            acc, bias, torch.float32, (D, "left")),
                            nbytes + wa + wb),
                        "normalize (features)": (lambda: tower.normalize(
                            acc, bias), 2 * nbytes)})
                else:
                    s = torch.as_tensor(rng.rand(D, H, W).astype(np.float32),
                                        device=dev)
                    forms["slow_volumes_epilogue"] = (
                        lambda: tower.slow_epilogue(s, 4), 3 * 4 * s.numel())
                for name, (fn, nb) in forms.items():
                    times, want = {k: [] for k in libs}, None
                    for key in order:
                        _build._LIBS["tower"] = libs[key]
                        tower._lib()  # the entries' argument types
                        if name != "bias_act":  # in place: values drift
                            got = _bits(fn())
                            if want is None:
                                want = got
                            elif not all(
                                    (a is None and b is None)
                                    or torch.equal(a, b)
                                    for a, b in zip(got, want)):
                                raise SystemExit(f"{case} {name}: {key} is "
                                                 "not bit for bit this "
                                                 "source's")
                        times[key].append(_graph_ms(fn, args.reps))
                    _build._LIBS["tower"] = libs["this"]
                    line = ", ".join(f"{k} " + " / ".join(
                        f"{t:.4f}" for t in v) for k, v in times.items())
                    print(f"{case} {H}x{W} C={C} {name}: {line} ms in a CUDA "
                          f"graph; bound {nb / MEM_BPS * 1e3:.4f} ms (bytes)")
                del acc, forms
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
