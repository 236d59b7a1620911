"""Time the tower kernels of other ``csrc/tower.cu`` or ``csrc/conv.cu``
sources against this one.

    python -m mccnn_tpu_torch.tower_variants [--kernel tower|conv]
        [--source OTHER.cu ...] [--case kitti mb] [--reps 10]

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
  float32 and with ``-dtype bfloat16``), with ``F.conv2d`` (cuDNN, TF32
  off) timed in the same turns as the library's yardstick; each source's
  output within 2e-6 of sum |w||x| from ``F.conv2d``'s; each form's
  bound: the bytes, and the operations at the bf16 tensor-core peak (six
  passes in float32, one in bfloat16) or, for the first layer, at the f32
  peak.

Prints the card and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from mccnn_tpu_torch.ops import _build, join, tower

MEM_BPS = 3.35e12
F32_OPS, BF16_TC_OPS = 67e12, 989e12
CASES = {"kitti": (370, 1226, 228), "mb": (1000, 1500, 200)}


def _load(src: Path, kernel: str = "tower") -> ctypes.CDLL:
    """A source's library, built beside the checkout's own builds."""
    out = _build.BUILD / f"lib{kernel}-variant-{src.parent.name}-{src.stem}.so"
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"{src}: nvcc failed:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out))


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


def _conv_cases(args, libs, order) -> None:
    """``--kernel conv``: every source's convolutions and ``F.conv2d`` in
    turns, at each case's shapes."""
    from mccnn_tpu_torch.ops import conv

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for case in args.case:
            H, W, _ = CASES[case]
            for C in conv.WIDTHS:
                for Ci in (1, C):
                    x32 = torch.as_tensor(
                        rng.randn(2, Ci, H, W).astype(np.float32), device=dev)
                    w = torch.as_tensor(
                        (rng.randn(C, Ci, 3, 3) / np.sqrt(9 * Ci))
                        .astype(np.float32), device=dev)
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
                        for key in order:
                            _build._LIBS["conv"] = libs[key]
                            conv._lib()  # the entries' argument types
                            err = float(((conv.conv3x3(x, w, dt) - ref).abs()
                                         / scale).max())
                            if err > 2e-6:
                                raise SystemExit(f"{case} C={C} Ci={Ci} {dt}: "
                                                 f"{key} is {err} of sum "
                                                 "|w||x| from F.conv2d")
                            times[key].append(_graph_ms(
                                lambda: conv.conv3x3(x, w, dt), args.reps))
                            times["F.conv2d"].append(_graph_ms(
                                lambda: conv.conv3x3_plain(x, w, dt),
                                args.reps))
                        _build._LIBS["conv"] = libs["this"]
                        line = ", ".join(f"{k} " + " / ".join(
                            f"{t:.4f}" for t in v) for k, v in times.items())
                        print(f"{case} {H}x{W} conv {Ci} -> {C} "
                              f"{str(dt).replace('torch.', '')}: {line} ms in "
                              f"a CUDA graph; bound {bound:.4f} ms")
                        del x, ref, scale
                    del x32, w
                    torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("tower", "conv"), default="tower")
    ap.add_argument("--source", nargs="*", default=[], type=Path,
                    help="other sources of the kernel to time against this "
                    "one")
    ap.add_argument("--case", nargs="*", default=list(CASES),
                    choices=list(CASES))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tower_variants: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    _build.build((args.kernel,))
    libs = {"this": ctypes.CDLL(str(_build.lib_path(args.kernel)))}
    for src in args.source:
        libs[str(src)] = _load(src, args.kernel)
    others = [k for k in libs if k != "this"]
    order = ["this"] + others + others + ["this"]
    if args.kernel == "conv":
        _conv_cases(args, libs, order)
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
