"""Time the tower kernels of other ``csrc/tower.cu`` sources against this one.

    python -m mccnn_tpu_torch.tower_variants [--source OTHER.cu ...]
        [--case kitti mb] [--reps 10]

Builds this checkout's ``csrc/tower.cu`` and each ``--source`` (the same
``nvcc`` flags, into ``build/``) and times, at the KITTI fast and slow
shapes (370x1226, D=228; 64 and 112 channels) or the Middlebury ones
(1000x1500, D=200), on seeded random inputs, each source's
``tower_normalize`` (the join's operands of both sides and of the left
side, and the features), ``tower_bias_act`` and ``slow_volumes_epilogue``
through the wrappers of ``ops/tower.py``, in turns (this source, the
others, the others, this source), each call in a CUDA graph. Every other
source must keep the C entries' signatures. Each source's results are
held bit for bit to this one's. Prints the card and its power limit, and
each form's bound by bytes (inputs read once, outputs written once, at
3.35 TB/s).
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
CASES = {"kitti": (370, 1226, 228), "mb": (1000, 1500, 200)}


def _load(src: Path) -> ctypes.CDLL:
    """A source's library, built beside the checkout's own builds."""
    out = _build.BUILD / f"libtower-variant-{src.stem}.so"
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", nargs="*", default=[], type=Path,
                    help="other tower.cu sources to time against this one")
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
    _build.build(("tower",))
    libs = {"this": ctypes.CDLL(str(_build.lib_path("tower")))}
    for src in args.source:
        libs[str(src)] = _load(src)
    others = [k for k in libs if k != "this"]
    order = ["this"] + others + others + ["this"]
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
