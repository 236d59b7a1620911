"""The command line of the port: every action of the reference.

    python -m mccnn_tpu_torch kitti fast -a predict -left L.png -right R.png \\
        -disp_max 228 [-net_fname net.npz] [-backend cpu]
    python -m mccnn_tpu_torch kitti slow -a time    # fastest of 3 (fast: 30)
    python -m mccnn_tpu_torch kitti fast -a train_tr [-data_dir D] [-resume ck.npz]
    python -m mccnn_tpu_torch kitti fast -a test_te -net_fname net/net_kitti_fast_-a_train_tr.npz

Same flags and outputs as the reference's ``./main.lua`` (main.lua:10-32):
predict writes ``left.bin``/``right.bin`` ((1, D, H, W) float32 cost
volumes) and ``disp.bin`` ((1, 1, H, W)) to the working directory; time
prints the fastest of N runs on a synthetic pair, in seconds;
train_tr / train_all train on the preprocessed set under ``-data_dir``,
write ``net/net_<cmd_str>.npz`` and chain into test_te / submit;
test_te / test_all print ``runtime err`` per image and the mean error
as the last token; submit writes ``out/`` and ``out/submission.zip``.
``-net_fname`` takes an ``.npz`` checkpoint of either package or a
``.t7`` net in the reference's format; ``-make_cache`` / ``-use_cache``
write and read the slow net's volumes under ``cache/``
(``pipeline.compute_volumes``). The command line drives one card
(``-gpu``); the mesh over several cards (batch and row-sharded
inference, data-parallel training) is the library's
``mccnn_tpu_torch.parallel``.
"""

from __future__ import annotations

import sys
import time as _time

import numpy as np
import torch

from mccnn_tpu_torch.config import Config, parse_args, print_args
from mccnn_tpu_torch.data.bin_io import write_raw_float32
from mccnn_tpu_torch.models import checkpoint, towers
from mccnn_tpu_torch.models.import_t7 import params_from_t7
from mccnn_tpu_torch.pipeline import device_of, stereo_predict
from mccnn_tpu_torch.utils import images as im

EVAL_ACTIONS = ("test_te", "test_all", "submit")


def load_params(cfg: Config) -> towers.FastTower | towers.SlowNet | None:
    """The network of ``-net_fname`` (an .npz checkpoint of either
    package, or a ``.t7`` net in the reference's format), or for ``-a
    predict`` and ``-a time`` seeded random weights with a warning: a
    fast tower for the fast arch, a slow net (tower and FC head) for the
    slow one, the JAX package's weights for the same ``-seed``. The
    evaluation actions of a learned arch
    need ``-net_fname`` (main.lua:892-902): a random net would score
    garbage behind one warning. None for ad and census, which need no
    network."""
    if cfg.arch in ("ad", "census"):
        return None
    if cfg.net_fname:
        if cfg.net_fname.endswith(".t7"):
            net = params_from_t7(cfg.net_fname)[0]
        else:
            net = checkpoint.load(cfg.net_fname)[0]
        if isinstance(net, towers.SlowNet) != (cfg.arch == "slow"):
            raise SystemExit(f"{cfg.net_fname}: not a {cfg.arch}-arch "
                             "checkpoint")
        return net
    if cfg.a in EVAL_ACTIONS:
        raise SystemExit(f"-a {cfg.a} with arch {cfg.arch} requires "
                         "-net_fname (main.lua:892-902)")
    print("WARNING: no -net_fname given; using randomly initialized weights")
    return towers.init_net(cfg)


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
    cfg, tail = parse_args(argv)
    if cfg.print_args:
        print_args(cfg)
        return
    if cfg.a == "predict":
        action_predict(cfg)
    elif cfg.a == "time":
        action_time(cfg)
    elif cfg.a in ("train_tr", "train_all"):
        from mccnn_tpu_torch.train.trainer import action_train
        action_train(cfg, tail)
    else:
        from mccnn_tpu_torch.train.evaluate import action_eval
        action_eval(cfg, tail)


if __name__ == "__main__":
    main()
