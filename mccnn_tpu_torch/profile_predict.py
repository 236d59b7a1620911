"""Where the device time of one prediction goes.

    python -m mccnn_tpu_torch.profile_predict [--arch fast|slow|census|ad]
        [--dataset kitti|mb] [--form slab|stream|grid]
        [--vol_dtype float32|bfloat16|float16] [--dtype float32|bfloat16]
        [--set KEY=VALUE ...] [--top 15] [--trace out.json]

Runs ``stereo_predict`` (the config of ``--dataset`` and ``--arch``,
seeded random weights where the arch has a network; ``--form`` is the
SGM form of the generic lane, by default what ``MCCNN_SGM_HSLAB``
selects; ``--vol_dtype`` and ``--dtype`` as the CLI's; ``--set`` overrides
config fields, as ``--set cbca_i1=2 --set L1=5 --set tau1=0.13`` runs
kitti fast with CBCA on the generic lane) on a seeded pair
on the CUDA card: KITTI 370x1226 at D=228, or Middlebury at the ``-a
time`` shape, 1000x1500 at D=200, the left direction alone. Twice to
warm up, then once under ``torch.profiler``. Prints the device time of
every CUDA kernel grouped as the port's hand-written kernels, cuDNN's
convolutions (none since the towers' convolutions are hand kernels),
cuBLAS's matmuls and the plain torch operations, the calls of each hand
kernel's wrapper (``_build.launches``), the top kernels by device time,
the device's busy share of the wall time of the run, and the peak device
memory of that run, and where the arch has a tower the hand convolutions'
time (their fused bias and ReLU included) beside their f32 bound, their
tensor-core floor and cuDNN's time on the same layers' inputs with the
bias and ReLU as torch operations after it (by events, in this
process); the plain
torch launches of a
second run and their device time, in which each function of the port's
pipeline, tower and ops modules runs in a profiler range, by the
innermost such function that issued them; the SHA-256 of the map's float32
bytes, so that two versions' maps can be compared across processes;
then pairs/s of 10 runs without the profiler, the median and the spread
of their wall times (host clock around a synchronized call).
"""

from __future__ import annotations

import argparse
import ast
import collections
import contextlib
import functools
import hashlib
import importlib
import inspect
import statistics
import time

import numpy as np
import torch

from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.models import towers
from mccnn_tpu_torch.ops import _build, conv, tower
from mccnn_tpu_torch.pipeline import resolve_device, stereo_predict
from mccnn_tpu_torch.utils.images import standardize

HAND = ("join_kernel", "hsweep_kernel", "vsweep_kernel", "outlier_kernel",
        "blur_kernel", "head_chain_kernel", "occlusion_fill_kernel",
        "mismatch_fill_kernel", "subpixel_kernel", "median5_kernel",
        "cbca_kernel", "cross_arms_kernel", "cbca_pack_kernel",
        "census_sig_kernel", "census_volume_kernel", "ad_volume_kernel",
        "sgm_tables_kernel", "sgm_layout_kernel", "generic_tables_kernel",
        "sgm_combine_kernel", "wta_dhw_kernel", "tower_bias_act_kernel",
        "tower_normalize_kernel", "slow_volumes_epilogue_kernel",
        "conv_first_kernel", "conv_wgmma_kernel")
# the hand kernels of the towers' convolutions (csrc/conv.cu)
CONV = ("conv_first_kernel", "conv_wgmma_kernel")


PLAIN = "plain torch operations"
CUDNN = "tower convolutions (cuDNN)"
# the H100 SXM's published peaks (a fused multiply-add two operations):
# f32 outside the tensor cores, and bf16 on them (the tower's f32 layers as
# six bf16 passes, a 16-bit lane's as one)
F32_PEAK = 67e12
BF16_TC_PEAK = 989e12
# the port's modules whose functions the second run labels, and the prefix
# of those labels among the profiler's ranges
LABELLED = ("pipeline", "models.towers", "ops.costs", "ops.cross", "ops.join",
            "ops.sgm", "ops.outlier", "ops.blur", "ops.post", "ops.slow_head")
LABEL = "port: "


def _ranged(label: str, fn):
    @functools.wraps(fn)
    def call(*a, **kw):
        with torch.profiler.record_function(LABEL + label):
            return fn(*a, **kw)
    return call


@contextlib.contextmanager
def _labelled():
    """Every function of the ``LABELLED`` modules wrapped in a profiler
    range named after it, for the span of the block (calls through the
    module, as the port makes them, go through the wrapper)."""
    saved = []
    for short in LABELLED:
        mod = importlib.import_module(f"mccnn_tpu_torch.{short}")
        for name, fn in list(vars(mod).items()):
            if inspect.isfunction(fn) and fn.__module__ == mod.__name__:
                saved.append((mod, name, fn))
                setattr(mod, name, _ranged(f"{short}.{name}", fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _source(event) -> str:
    """The innermost labelled function around a profiled operation."""
    while event is not None:
        if event.name.startswith(LABEL):
            return event.name[len(LABEL):]
        event = event.cpu_parent
    return "outside the labelled modules"


def _group(name: str) -> str:
    if any(k in name for k in HAND):
        return "hand-written CUDA kernels"
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "fprop", "implicit",
                              "winograd")):
        return CUDNN
    if "gemm" in low or "xmma" in low:
        return "matmuls (cuBLAS: the slow head's first layer)"
    return PLAIN


@contextlib.contextmanager
def _conv_inputs(seen: list):
    """Record the (x, weight, dtype, bias, relu) of every ``conv.conv3x3``
    call in the block (nothing writes a layer's input after its
    convolution)."""
    orig = conv.conv3x3

    def call(x, weight, dtype=torch.float32, bias=None, relu=False):
        seen.append((x, weight, dtype, bias, relu))
        return orig(x, weight, dtype, bias, relu)

    conv.conv3x3 = call
    try:
        yield
    finally:
        conv.conv3x3 = orig


def _cudnn_layer(x, weight, dtype, bias, relu):
    """A layer as cuDNN (TF32 off) and torch compute it: ``F.conv2d``, then
    the bias and ReLU as ``tower.bias_act_plain`` where the hand kernel
    fuses them."""
    out = conv.conv3x3_plain(x, weight, dtype)
    return out if bias is None else tower.bias_act_plain(out, bias, relu,
                                                         dtype)


def _events_ms(fn, reps: int) -> float:
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
    ap.add_argument("--arch", choices=("fast", "slow", "census", "ad"),
                    default="fast")
    ap.add_argument("--dataset", choices=("kitti", "mb"), default="kitti")
    ap.add_argument("--form", choices=("slab", "stream", "grid"), default=None,
                    help="SGM form of the generic lane")
    ap.add_argument("--vol_dtype", choices=("float32", "bfloat16", "float16"),
                    default="float32")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config field (a Python literal or a "
                    "string)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    mb = args.dataset == "mb"
    H, W, D, shift = (1000, 1500, 200, 40) if mb else (370, 1226, 228, 40)
    base = np.random.RandomState(0).randn(H, W + shift).astype(np.float32)
    x0 = torch.as_tensor(standardize(base[:, :W]), device=dev)
    x1 = torch.as_tensor(standardize(base[:, shift:shift + W]), device=dev)
    over = dict(kv.split("=", 1) for kv in args.set)
    for k, v in over.items():
        try:
            over[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
    cfg = make_config(args.dataset, args.arch, a="time" if mb else "predict",
                      vol_dtype=args.vol_dtype, dtype=args.dtype, **over)
    init = {"fast": towers.init_fast, "slow": towers.init_slow}.get(args.arch)
    tower = init and init(cfg, cfg.seed)
    for _ in range(2):
        stereo_predict(cfg, tower, x0, x1, D, sgm_form=args.form)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        disp = stereo_predict(cfg, tower, x0, x1, D, sgm_form=args.form)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    groups = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        g = groups[_group(e.key)]
        g[0] += dev_us(e) / 1e3
        g[1] += e.count
    form = "" if args.form is None else f" (SGM form {args.form})"
    if args.vol_dtype != "float32" or args.dtype != "float32":
        form += f" (-vol_dtype {args.vol_dtype}, -dtype {args.dtype})"
    if over:
        form += f" (config {over})"
    print(f"{torch.cuda.get_device_name(0)}: one {args.dataset} {args.arch} "
          f"stereo_predict{form} {H}x{W} "
          f"D={D}: wall {wall_ms:.3f} ms (under the profiler), device "
          f"{total_ms:.3f} ms in {sum(e.count for e in kernels)} kernel "
          f"launches, busy {total_ms / wall_ms:.3f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {ms:.3f} ms in {n} launches")
    if tower is not None:
        # the convolutions' operations (a multiply-add two), both images:
        # every layer at the f32 peak, and the layers of the wgmma kernel
        # as its passes at the bf16 tensor-core peak beside the first
        # layer's at the f32 one
        f32 = floor = 0.0
        for c in tower.convs:
            ops = 2.0 * 2 * H * W * c.weight[0].numel() * c.out_channels
            f32 += ops / F32_PEAK
            if c.in_channels == c.out_channels \
                    and c.in_channels in conv.WIDTHS:
                floor += (6 if args.dtype == "float32" else 1) * ops \
                    / BF16_TC_PEAK
            else:
                floor += ops / F32_PEAK
        hand_ms = sum(dev_us(e) for e in kernels
                      if any(k in e.key for k in CONV)) / 1e3
        calls = []
        with _conv_inputs(calls), torch.no_grad():
            stereo_predict(cfg, tower, x0, x1, D, sgm_form=args.form)
            cudnn_ms = _events_ms(lambda: [_cudnn_layer(*c)
                                           for c in calls], 5)
        del calls
        print(f"  the tower's convolutions ({len(tower.convs)} layers): hand "
              f"kernels {hand_ms:.3f} ms (this profile); the f32 bound "
              f"{f32 * 1e3:.3f} ms at {F32_PEAK / 1e12:.0f} TFLOP/s; the "
              f"tensor-core floor {floor * 1e3:.3f} ms (six bf16 passes a "
              f"float32 layer, one a 16-bit one, at "
              f"{BF16_TC_PEAK / 1e12:.0f} TFLOP/s); cuDNN (TF32 off) on the "
              f"same layers' inputs {cudnn_ms:.3f} ms by events "
              f"({cudnn_ms / max(hand_ms, 1e-9):.2f}x)")
    print("  the hand kernels' wrapper calls: "
          + ", ".join(f"{k} {n}" for k, n in _build.launches().items() if n))
    print(f"top {args.top} kernels by device time:")
    for e in sorted(kernels, key=dev_us, reverse=True)[:args.top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}")
    with _labelled(), torch.profiler.profile(activities=acts) as prof:
        stereo_predict(cfg, tower, x0, x1, D, sgm_form=args.form)
        torch.cuda.synchronize()
    by_source = collections.Counter()
    us_of = collections.Counter()
    for e in prof.events():
        plain = [k for k in e.kernels if _group(k.name) == PLAIN]
        if plain:
            by_source[_source(e)] += len(plain)
            us_of[_source(e)] += sum(k.duration for k in plain)
    print(f"plain torch launches and their device ms by the port's function "
          f"that issued them (a second run, each function in a profiler "
          f"range; {sum(by_source.values())} launches, "
          f"{sum(us_of.values()) / 1e3:.3f} ms in all):")
    for src, n in by_source.most_common():
        print(f"  {n:6d}  {us_of[src] / 1e3:9.3f} ms  {src}")
    digest = hashlib.sha256(disp.cpu().numpy().astype(np.float32).tobytes())
    print(f"map sha256 {digest.hexdigest()}")
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        stereo_predict(cfg, tower, x0, x1, D, sgm_form=args.form)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"{1e3 / statistics.median(times):.3f} pairs/s (median of 10 runs "
          f"without the profiler; {min(times):.2f}-{max(times):.2f} ms a "
          f"pair)")


if __name__ == "__main__":
    main()
