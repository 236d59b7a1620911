"""The command-line driver of the port: ``predict`` and ``time``.

    python -m mccnn_tpu_torch kitti fast -a predict -left L.png -right R.png \\
        -disp_max 228 [-net_fname net.npz] [-backend cpu]
    python -m mccnn_tpu_torch kitti slow -a time    # fastest of 3 (fast: 30)
    python -m mccnn_tpu_torch kitti census -a time

Same flags and outputs as the reference's ``./main.lua`` (main.lua:10-32):
predict writes ``left.bin``/``right.bin`` ((1, D, H, W) float32 cost
volumes) and ``disp.bin`` ((1, 1, H, W)) to the working directory; time
prints the fastest of N runs on a synthetic pair, in seconds. The other
actions are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import sys
import time as _time

import numpy as np
import torch

from mccnn_tpu_torch.config import Config, parse_args, print_args
from mccnn_tpu_torch.data.bin_io import write_raw_float32
from mccnn_tpu_torch.models import towers
from mccnn_tpu_torch.pipeline import resolve_device, stereo_predict
from mccnn_tpu_torch.utils import images as im


def device_of(cfg: Config) -> torch.device:
    """``-backend cpu`` runs on the host; otherwise CUDA device
    ``-gpu`` (1-based), which must exist."""
    if cfg.backend == "cpu":
        return torch.device("cpu")
    if cfg.backend not in ("", "cuda", "gpu"):
        raise SystemExit(f"-backend must be cpu or cuda, got {cfg.backend!r}")
    dev = resolve_device("cuda")
    if not 1 <= cfg.gpu <= torch.cuda.device_count():
        raise SystemExit(f"-gpu {cfg.gpu}: only {torch.cuda.device_count()} "
                         "CUDA device(s) visible")
    return torch.device(dev.type, cfg.gpu - 1)


def load_params(cfg: Config) -> towers.FastTower | towers.SlowNet | None:
    """The network of ``-net_fname`` (an .npz of the JAX package's
    checkpoints), or seeded random weights with a warning: a fast tower
    for the fast arch, a slow net (tower and FC head) for the slow one.
    None for ad and census, which need no network."""
    if cfg.arch in ("ad", "census"):
        return None
    if cfg.net_fname:
        net = towers.load_npz(cfg.net_fname)
        if isinstance(net, towers.SlowNet) != (cfg.arch == "slow"):
            raise SystemExit(f"{cfg.net_fname}: not a {cfg.arch}-arch "
                             "checkpoint")
        return net
    print("WARNING: no -net_fname given; using randomly initialized weights")
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.arch == "slow":
        return towers.init_slow(cfg, gen)
    return towers.init_fast(cfg, gen)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def action_predict(cfg: Config) -> None:
    """main.lua:1084-1105: arbitrary pair -> left.bin/right.bin (final
    cost volumes) + disp.bin, raw float32, reference layouts."""
    dev = device_of(cfg)
    x0 = im.standardize(im.load_gray(cfg.left))
    x1 = im.standardize(im.load_gray(cfg.right))
    if x0.shape != x1.shape:
        raise SystemExit(f"left {x0.shape} and right {x1.shape} differ")
    if cfg.disp_max is None:
        raise SystemExit("-a predict needs -disp_max")
    disp_max = int(cfg.disp_max)
    disp, vol_l, vol_r = stereo_predict(cfg, load_params(cfg), x0, x1,
                                        disp_max, return_vols=True, device=dev)
    H, W = x0.shape
    for name, vol in (("left", vol_l), ("right", vol_r)):
        if vol is None:
            continue
        print(f"Writing {name}.bin, 1 x {disp_max} x {H} x {W}")
        write_raw_float32(f"{name}.bin", vol.cpu().numpy())
    print(f"Writing disp.bin, 1 x 1 x {H} x {W}")
    write_raw_float32("disp.bin", disp.cpu().numpy())


def action_time(cfg: Config) -> None:
    """main.lua:1140-1170: fastest of N wall-clock runs at the
    reference's synthetic sizes, inputs resident on the device, after
    one warm-up run: N = 30 for the fast arch, 3 for the others (the
    reference's rule, mccnn_tpu/cli.py:113), on any device."""
    dev = device_of(cfg)
    if cfg.tiny:
        H, W, disp_max = 240, 320, 32
    elif cfg.dataset in ("kitti", "kitti2015"):
        H, W, disp_max = 350, 1242, 228
    else:
        H, W, disp_max = 1000, 1500, 200
    rng = np.random.RandomState(cfg.seed)
    x0 = torch.as_tensor(rng.randn(H, W).astype(np.float32), device=dev)
    x1 = torch.as_tensor(rng.randn(H, W).astype(np.float32), device=dev)
    params = load_params(cfg)
    stereo_predict(cfg, params, x0, x1, disp_max, device=dev)  # warm-up
    _sync(dev)
    best = float("inf")
    for _ in range(30 if cfg.arch == "fast" else 3):
        t0 = _time.perf_counter()
        stereo_predict(cfg, params, x0, x1, disp_max, device=dev)
        _sync(dev)
        best = min(best, _time.perf_counter() - t0)
    print(best)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    print(" ".join(argv))  # echo argv like main.lua:6-9
    cfg, _ = parse_args(argv)
    if cfg.print_args:
        print_args(cfg)
        return
    if cfg.a == "predict":
        action_predict(cfg)
    elif cfg.a == "time":
        action_time(cfg)
    else:
        raise SystemExit(f"-a {cfg.a} is not ported yet (ROADMAP.md queue 1, "
                         "items 13 and 15); the port runs predict and time")


if __name__ == "__main__":
    main()
