"""Evaluation / submission actions (mccnn_tpu/train/evaluate.py).

Behavior contract (main.lua:1107-1293):

- ``test_te``: loop the validation examples (KITTI: ``te`` ids; MB:
  ``te`` images at light 1/cam 2 plus the extra lighting pairs (5,3)
  and (5,4)), run ``stereo_predict``, compute the bad-``err_at`` error
  over ground-truth pixels (mask = GT != 0), print ``runtime err`` per
  image, and the mean error as the final stdout token (the hs.py
  score contract, hs.py:209-211).
- ``test_all``: train+val ids (KITTI only).
- ``submit``: KITTI 16-bit PNGs into ``out/`` (2015: ``out/disp_0``)
  padded back to full image height, MB PFM + runtime files, zipped to
  ``out/submission.zip``.

Runs on the card unless given ``device="cpu"`` or ``-backend cpu``; the
runtime of a pair is taken around the prediction and its copy to the
host, which waits for the card.
"""

from __future__ import annotations

import os
import time as _time
import zipfile

import numpy as np
import torch

from mccnn_tpu_torch.config import Config
from mccnn_tpu_torch.data.datasets import StereoDataset, load_dataset
from mccnn_tpu_torch.data.pfm import write_pfm
from mccnn_tpu_torch.data.png16 import write_png16
from mccnn_tpu_torch.pipeline import device_of, resolve_device, stereo_predict


def _examples(cfg: Config, ds: StereoDataset):
    if cfg.a == "submit":
        if cfg.dataset in ("kitti", "kitti2015"):
            n = ds.X0.shape[0]
            return list(range(n - ds.n_te + 1, n + 1))
        # the last 30 images are the MiddEval3 submission set
        # (main.lua:1115-1119)
        return [(i, 2) for i in range(max(1, len(ds.X) - 29), len(ds.X) + 1)]
    if cfg.a == "test_te":
        if cfg.dataset in ("kitti", "kitti2015"):
            return [int(i) for i in ds.te]
        ex = [(int(i), 2) for i in ds.te]
        # extra lighting/exposure pairs of image 5 (main.lua:1129-1131);
        # guarded for reduced synthetic datasets
        if len(ds.X) >= 5 and ds.X[4] and ds.X[4][0].shape[0] >= 4:
            ex += [(5, 3), (5, 4)]
        return ex
    if cfg.a == "test_all":
        if cfg.dataset not in ("kitti", "kitti2015"):
            raise SystemExit("test_all not supported on Middlebury.")
        return [int(i) for i in np.concatenate([ds.tr, ds.te])]
    raise ValueError(cfg.a)


def _eval_error(pred: np.ndarray, actual: np.ndarray, err_at: float) -> float:
    mask = actual != 0
    bad = (np.abs(actual - pred) > err_at) & mask
    return float(bad.sum()) / float(mask.sum())


def _bucket_sizes(cfg: Config):
    """(bucket_hw, bucket_d) with -1 resolved to the dataset default:
    64/64 on Middlebury, whose shapes vary by image, off elsewhere."""
    auto = 64 if cfg.dataset == "mb" else 0
    bh = cfg.bucket_hw if cfg.bucket_hw >= 0 else auto
    bd = cfg.bucket_d if cfg.bucket_d >= 0 else auto
    return max(bh, 1), max(bd, 1)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def bucketed_predict(cfg: Config, net, x0, x1, disp_max: int,
                     device=None, pair_id=None) -> torch.Tensor:
    """stereo_predict with shape bucketing: edge-pad the pair up to
    (bucket_hw, bucket_hw) multiples and disp_max up to a bucket_d
    multiple, mask the padded disparities (``disp_true``), run, crop to
    (H, W). Results can deviate from exact-shape runs only where the SGM
    sweeps/CBCA/blur touch the padded border band. ``pair_id`` names
    the pair in the volume cache (``-use_cache`` / ``-make_cache``)."""
    bh, bd = _bucket_sizes(cfg)
    H, W = x0.shape
    Hp, Wp, Dp = _round_up(H, bh), _round_up(W, bh), _round_up(disp_max, bd)
    if (Hp, Wp, Dp) == (H, W, disp_max):
        return stereo_predict(cfg, net, x0, x1, disp_max, device=device,
                              pair_id=pair_id)
    x0p = np.pad(x0, ((0, Hp - H), (0, Wp - W)), mode="edge")
    x1p = np.pad(x1, ((0, Hp - H), (0, Wp - W)), mode="edge")
    pred = stereo_predict(cfg, net, x0p, x1p, Dp, device=device,
                          disp_true=disp_max if Dp > disp_max else None,
                          pair_id=pair_id)
    return pred[:H, :W]


def action_eval(cfg: Config, tail: list[str], net=None,
                ds: StereoDataset | None = None, device=None) -> None:
    """``-a test_te`` / ``test_all`` / ``submit`` with ``net`` (default
    the network of ``-net_fname``, which the learned arches need)."""
    from mccnn_tpu_torch.cli import load_params

    dev = device_of(cfg) if device is None else resolve_device(device)
    if ds is None:
        ds = load_dataset(cfg)
    if net is None:
        net = load_params(cfg)

    examples = _examples(cfg, ds)
    is_kitti = cfg.dataset in ("kitti", "kitti2015")
    if cfg.a == "submit":
        os.makedirs("out", exist_ok=True)
        for f in os.listdir("out"):
            p = os.path.join("out", f)
            if os.path.isfile(p):
                os.remove(p)
        if cfg.dataset == "kitti2015":
            os.makedirs("out/disp_0", exist_ok=True)

    err_sum = 0.0
    written = []
    for ex in examples:
        if is_kitti:
            i = ex
            img_height, img_width, img_id = (int(v) for v in ds.metadata[i - 1])
            x0 = np.array(ds.X0[i - 1, 0, :, :img_width])
            x1 = np.array(ds.X1[i - 1, 0, :, :img_width])
            disp_max = ds.disp_max
        else:
            i, right = ex
            img_id = f"{i}_{right}"
            disp_max = int(ds.metadata[i - 1, 2])
            # light-1 tensor is (n_views, C, H, W) = [im0, im1, im1E, im1L]
            # (preprocess_mb.py:139-140); right=2 is im1, 3/4 the extra
            # lighting/exposure pairs (main.lua:1186-1188).
            x0 = np.array(ds.X[i - 1][0][0, 0])
            x1 = np.array(ds.X[i - 1][0][right - 1, 0])

        t0 = _time.perf_counter()
        pred = bucketed_predict(cfg, net, x0, x1, disp_max, device=dev,
                                pair_id=img_id)
        pred = pred.cpu().numpy()
        runtime = _time.perf_counter() - t0

        if cfg.a == "submit":
            if is_kitti:
                pred_img = np.zeros((img_height, img_width), np.float32)
                pred_img[img_height - ds.height:] = pred[:ds.height]
                path = "out" if cfg.dataset == "kitti" else "out/disp_0"
                fname = os.path.join(path, f"{img_id:06d}_10.png")
                write_png16(pred_img, fname)
                written.append(fname)
            else:
                name = ds.fname_submit[i - (len(ds.X) - len(ds.fname_submit)) - 1]
                base = os.path.join("out", name)
                os.makedirs(base, exist_ok=True)
                method = "MC-CNN-" + ("fst" if cfg.arch == "fast" else "acrt")
                f_pfm = os.path.join(base, f"disp0{method}.pfm")
                write_pfm(pred[::-1], f_pfm)  # vflip (main.lua:1218)
                with open(os.path.join(base, f"time{method}.txt"), "w") as f:
                    f.write(str(runtime))
                written.extend([f_pfm, os.path.join(base, f"time{method}.txt")])
        else:
            if np.isnan(pred.sum()):
                raise RuntimeError(f"NaN in the prediction of image {img_id}")
            if is_kitti:
                actual = np.asarray(ds.dispnoc[i - 1, 0, :, :img_width])
            else:
                actual = np.asarray(ds.mb_dispnoc[i - 1]).reshape(pred.shape)
            err = _eval_error(pred, actual, cfg.err_at)
            err_sum += err
            print(runtime, err)
            if cfg.debug:
                _debug_dump(cfg, img_id, pred, actual, x0, disp_max)

    if cfg.a == "submit":
        zname = "out/submission.zip"
        with zipfile.ZipFile(zname, "w", zipfile.ZIP_DEFLATED) as z:
            for f in written:
                z.write(f, os.path.relpath(f, "out"))
        print(f"wrote {zname} ({len(written)} files)")
    else:
        print(err_sum / len(examples))


def _debug_dump(cfg: Config, img_id, pred, actual, x0, disp_max) -> None:
    """The -debug triple into tmp/ (main.lua:1240-1266):

    - ``<dataset>_<id>_gt.png``: jet((gt+1)/disp_max), blue channel
      gated by the GT-valid mask (main.lua:1259-1261)
    - ``<dataset>_<arch>_<id>_pred.png``: jet((pred+1)/disp_max)
    - ``<dataset>_<arch>_<id>_err.png``: desaturated x0 with bad
      (>err_at) pixels pushed red and good pixels pushed green at
      weight 0.5 (main.lua:1246-1252)
    """
    from PIL import Image

    from mccnn_tpu_torch.utils.images import grey2jet

    def save(path, rgb):
        Image.fromarray(
            (np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(path)

    pred = np.asarray(pred)
    actual = np.asarray(actual)
    mask = actual != 0
    diff = np.abs(actual - pred)
    bad = ((diff > cfg.err_at) & mask).astype(np.float32)
    good = ((diff <= cfg.err_at) & mask).astype(np.float32)

    img_err = np.repeat(((np.asarray(x0) * 50 + 150) / 255)[..., None],
                        3, axis=-1)
    img_err[..., 0] += 0.5 * bad - 0.5 * good
    img_err[..., 1] += 0.5 * good - 0.5 * bad
    img_err[..., 2] -= 0.5 * (bad + good)

    img_gt = grey2jet((actual + 1) / disp_max)
    img_gt[..., 2] *= mask

    os.makedirs("tmp", exist_ok=True)
    save(f"tmp/{cfg.dataset}_{img_id}_gt.png", img_gt)
    save(f"tmp/{cfg.dataset}_{cfg.arch}_{img_id}_pred.png",
         grey2jet((pred + 1) / disp_max))
    save(f"tmp/{cfg.dataset}_{cfg.arch}_{img_id}_err.png", img_err)
