#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, the
CUDA toolkit (nvcc) and PyTorch; JAX is not needed. Phases, each fatal:

1. the card, and its name and power limit as nvidia-smi reports them;
2. building every kernel of ``mccnn_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the KITTI fast-arch path (370x1226, D=228, 64 features),
   with kernel, plain and bound times; the tower (cuDNN with TF32 off)
   against the same tower on the CPU;
4. ``stereo_predict`` on a seeded 370x1226 pair of known disparity: the
   launch count of every kernel in one run, the accuracy, and the
   share of pixels where it differs from the all-plain path (the CPU);
   then pairs/s (median of 10 runs after warm-up) on that pair and on
   bench.py's synthetic 350x1242 pair.

Prints the kernels' JSON line, the card line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
there is no CUDA card or the package is missing, and when any phase
fails.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32
# outside the tensor cores. A bound is the larger of bytes / MEM_BPS
# and operations / F32_OPS.
MEM_BPS = 3.35e12
F32_OPS = 67e12

H, W, D, SHIFT = 370, 1226, 228, 40


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / MEM_BPS * 1e3, ops / F32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    by CUDA events."""
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


def kitti_pair(rng, h, w, shift):
    """A standardized random-texture pair whose true disparity is
    ``shift`` everywhere: x1[y, x - shift] == x0[y, x]."""
    from mccnn_tpu_torch.utils.images import standardize

    base = rng.randn(h, w + shift).astype(np.float32)
    return standardize(base[:, :w]), standardize(base[:, shift:shift + w])


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.ops import _build, blur, costs, join, outlier, sgm
    from mccnn_tpu_torch.pipeline import stereo_predict

    dev = torch.device("cuda")
    card = card_line()
    print(f"phase 1: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card)

    secs = _build.build()
    print(f"phase 2: built {len(_build.SOURCES)} sources in {secs:.1f} s")
    for name in _build.SOURCES:
        log = _build.log_path(name)
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = make_config("kitti", "fast", a="predict")
    tower = towers.init_fast(cfg, torch.Generator().manual_seed(cfg.seed))
    rng = np.random.RandomState(0)
    x0, x1 = kitti_pair(rng, H, W, SHIFT)
    rows = {}

    # --- phase 3: kernels against their plain versions -----------------
    images = torch.as_tensor(np.stack([x0, x1])[:, None])
    with torch.no_grad():
        feats_cpu = tower(images)
        tower.to(dev)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            feats = tower(images.to(dev))
    err = float((feats.cpu() - feats_cpu).abs().max())
    print(f"phase 3: tower cuDNN (TF32 off) vs CPU: max |d| {err:.2e}")
    check(err <= 1e-4, f"tower differs from the CPU tower by {err}")
    fl = feats[0].permute(1, 2, 0)
    fr = feats[1].permute(1, 2, 0)
    C = fl.shape[-1]
    Hp, Wp, Dp = join.pad_dims(H, W, D)
    a = join._prep(fr, False, Hp, Wp)
    b = join._prep(fl, False, Hp, Wp + Dp)

    vol_k = join._join_plus(a, b, D, W, H, 4)
    vol_p = join.join_plus_plain(a, b, D, W, H, 4)
    torch.cuda.synchronize()
    check(torch.equal(vol_k.isnan(), vol_p.isnan()), "join NaN masks differ")
    err = float((vol_k - vol_p).nan_to_num().abs().max())
    check(err <= 1e-5, f"join max |d| {err} > 1e-5")
    rows["join"] = dict(
        err=err, ms=cuda_ms(torch, lambda: join._join_plus(a, b, D, W, H, 4), 10),
        plain_ms=cuda_ms(torch, lambda: join.join_plus_plain(a, b, D, W, H, 4), 1),
        bound=bound_ms((a.numel() + b.numel() + vol_k.numel()) * 4,
                       2.0 * H * W * D * C))
    del vol_p

    # the right direction's four sweeps on the join volume; the second of
    # each family is timed: it reads the accumulator and adds in place
    vol_l, vol_r = join.stereo_join_hwd(fl, fr, D, n_fix=4)
    plan = sgm.sweep_plan(torch.as_tensor(x0, device=dev),
                          torch.as_tensor(x1, device=dev), D, H, W,
                          vol_r.shape, xrev=False, pi1=cfg.pi1, pi2=cfg.pi2,
                          tau_so=cfg.tau_so, alpha1=cfg.alpha1, q1=cfg.sgm_q1,
                          q2=cfg.sgm_q2)
    acc_k = torch.empty_like(vol_r)
    acc_p = torch.empty_like(vol_r)
    cells = H * W * D  # real cells of one sweep, ~10 f32 operations each
    for i, p in enumerate(plan):
        p = dict(p)
        d1, g = p.pop("d1"), p.pop("g")
        last = i == len(plan) - 1
        ak, ap = (None, None) if i == 0 else (acc_k, acc_p)
        wk = torch.empty((Hp, Wp), device=dev) if last else None
        wp = torch.empty((Hp, Wp), device=dev) if last else None
        if i in (1, 3):  # the last one with its fused WTA, as on the path
            scratch = acc_k.clone()
            wbuf = torch.empty((Hp, Wp), device=dev) if last else None
            entry = "sgm_vertical" if p["vertical"] else "sgm_horizontal"
            ms = cuda_ms(torch, lambda: sgm._sweep(vol_r, scratch, scratch,
                                                   wbuf, d1, g, **p), 5)
            t0 = time.perf_counter()
            sgm.sweep_plain(vol_r, scratch, scratch, wbuf, d1, g, **p)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            del scratch, wbuf
        sgm._sweep(vol_r, ak, acc_k, wk, d1, g, **p)
        sgm.sweep_plain(vol_r, ap, acc_p, wp, d1, g, **p)
        torch.cuda.synchronize()
        check(torch.equal(acc_k.isnan(), acc_p.isnan()),
              f"sweep {i} NaN masks differ")
        real = (slice(0, H), slice(0, W), slice(0, D))
        diff = (acc_k[real] - acc_p[real]).abs().nan_to_num()  # masks equal
        tol = 1e-5 * acc_p[real].abs().nan_to_num()
        check(bool((diff <= tol).all()), f"sweep {i}: max |d| "
              f"{float(diff.max())} beyond rtol 1e-5")
        if last:
            same = float((wk[:H, :W] == wp[:H, :W]).float().mean())
            check(same >= 0.9999, f"fused WTA maps agree on {same}")
            wta_same = same
        if i in (1, 3):
            rows[entry] = dict(
                err=float(diff.max()), ms=ms, plain_ms=plain_ms,
                bound=bound_ms(3 * vol_r.numel() * 4
                               + (d1.numel() + g.numel()) * 4
                               + (Hp * Wp * 4 if last else 0), 10.0 * cells))
    print(f"  fused WTA maps equal on {wta_same:.6f} of pixels")
    del acc_k, acc_p

    d_r = costs.wta_hwd(vol_r)[:H, :W].contiguous()
    d_l = costs.wta_hwd(vol_l)[:H, :W].flip(1).contiguous()
    lab_k = outlier.outlier_detection(d_l, d_r, D)
    lab_p = outlier.outlier_detection_plain(d_l, d_r, D)
    check(torch.equal(lab_k, lab_p), "outlier labels differ")
    taps = float(H * sum(min(D, x + 1) for x in range(W)))
    rows["outlier"] = dict(
        err=0.0, ms=cuda_ms(torch, lambda: outlier.outlier_detection(d_l, d_r, D), 20),
        plain_ms=cuda_ms(torch, lambda: outlier.outlier_detection_plain(d_l, d_r, D), 2),
        bound=bound_ms(3 * H * W * 4, 4.0 * taps))

    kern = torch.as_tensor(blur.gaussian_kernel(cfg.blur_sigma), device=dev)
    k = kern.shape[0]
    r = k // 2
    img = d_l.clone()
    b_k = blur.mean2d(img, kern, cfg.blur_t)
    b_p = blur.mean2d_plain(img, kern, cfg.blur_t)
    err = float((b_k - b_p).abs().max())
    check(err <= 1e-4, f"blur max |d| {err} > 1e-4")
    ny = sum(min(H - 1, y + r) - max(0, y - r) + 1 for y in range(H))
    nx = sum(min(W - 1, x + r) - max(0, x - r) + 1 for x in range(W))
    rows["blur"] = dict(
        err=err, ms=cuda_ms(torch, lambda: blur.mean2d(img, kern, cfg.blur_t), 10),
        plain_ms=cuda_ms(torch, lambda: blur.mean2d_plain(img, kern, cfg.blur_t), 1),
        bound=bound_ms((2 * H * W + k * k) * 4, 6.0 * ny * nx))
    del vol_l, vol_r
    for name, row in rows.items():
        print(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound'][0]:.4f} ms ({row['bound'][1]}), "
              f"max |d| {row['err']:.3g}")

    # --- phase 4: the main path ----------------------------------------
    _build.reset_launches()
    disp = stereo_predict(cfg, tower, x0, x1, D)
    torch.cuda.synchronize()
    counts = _build.launches()
    print(f"phase 4: launches in one stereo_predict: {counts}")
    want = {"join": 2, "sgm_vertical": 4, "sgm_horizontal": 4, "outlier": 1,
            "blur": 1}
    check(counts == want, f"launch counts {counts}, expected {want}")
    d = disp.cpu().numpy()
    check(d.shape == (H, W) and bool(np.isfinite(d).all()),
          "disparity map not finite or misshaped")
    good = float((np.abs(d[:, SHIFT + 8:] - SHIFT) <= 1.0).mean())
    print(f"  pixels within 1 px of the true disparity {SHIFT}: {good:.4f}")
    check(good >= 0.9, f"only {good:.4f} of pixels within 1 px")

    def pairs_per_s(p0, p1):
        t0_, t1_ = (torch.as_tensor(v, device=dev) for v in (p0, p1))
        for _ in range(2):
            stereo_predict(cfg, tower, t0_, t1_, D)
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t = time.perf_counter()
            stereo_predict(cfg, tower, t0_, t1_, D)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return 1.0 / statistics.median(times), times

    torch.cuda.reset_peak_memory_stats()
    pps_a, times_a = pairs_per_s(x0, x1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    base = np.random.RandomState(42).randn(350, 1242 + D).astype(np.float32)
    pps_b, times_b = pairs_per_s(base[:, D:], base[:, :-D])
    print(f"  370x1226: {pps_a:.3f} pairs/s (median of 10; runs "
          f"{[round(t * 1e3, 2) for t in times_a]} ms), peak {peak:.2f} GiB")
    print(f"  350x1242 (bench pair): {pps_b:.3f} pairs/s (median of 10; runs "
          f"{[round(t * 1e3, 2) for t in times_b]} ms)")

    t = time.perf_counter()
    d_plain = stereo_predict(cfg, tower, x0, x1, D, device="cpu").numpy()
    frac = float((np.abs(d - d_plain) > 0.51).mean())
    print(f"  kernel path vs all-plain path (CPU, {time.perf_counter() - t:.0f} s):"
          f" {frac:.5f} of pixels differ by > 0.51")
    check(frac < 0.01, f"{frac} of pixels differ from the plain path")

    sources = {"join": ("join.cu", "mccnn_tpu/ops/join_pallas.py:65"),
               "sgm_vertical": ("sgm_sweep.cu", "mccnn_tpu/ops/sgm.py:741"),
               "sgm_horizontal": ("sgm_sweep.cu", "mccnn_tpu/ops/sgm.py:462"),
               "outlier": ("outlier.cu", "mccnn_tpu/ops/outlier_pallas.py:32"),
               "blur": ("blur.cu", "mccnn_tpu/ops/blur_pallas.py:56")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"mccnn_tpu_torch/csrc/{sources[name][0]}",
         "replaces": sources[name][1], "launches": counts[name],
         "max_abs_err": rows[name]["err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound"][0],
         "bound_by": rows[name]["bound"][1], "library_ms": None}
        for name in _build.KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
