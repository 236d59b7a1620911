"""KITTI 2012/2015 preprocessing into the binary dataset format.

Behavior contract: preprocess_kitti.lua —

- images bottom-cropped to the last 350 rows, per-image standardized
  (mean 0, std 1) after the crop, zero-padded into fixed
  ``(N, 1, 350, 1242)`` tensors (preprocess_kitti.lua:31-77),
- KITTI 2015 color images converted with rgb2y,
- metadata rows ``(img_height, img_width, id)``,
- train/val split: ``randperm(n_tr)`` with the first 40 as validation
  (seed 42, preprocess_kitti.lua:86-88),
- ground truth filtered by remove_nonvisible → remove_occluded →
  remove_white (adcensus.cu:1723-1796; note the reference passes the
  *standardized* image to remove_white, so the ==255 test never fires —
  replicated faithfully),
- nnz tables (img 1-based, y/x 0-based, disp) for every pixel with
  disp > 0.5 (make_dataset2, adcensus.cu:1900-1929).

Usage: python -m mccnn_tpu_torch.data.preprocess_kitti [data_root]
Expects ``data.kitti/unzip/{training,testing}/...`` (and
``data.kitti2015/unzip/...``) under data_root.

A copy of the JAX package's ``mccnn_tpu/data/preprocess_kitti.py``: the
same ``.bin`` / ``.dim`` / ``.type`` files, byte for byte. PIL is
imported inside the image readers, so the module imports without it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from mccnn_tpu_torch.data.bin_io import tofile
from mccnn_tpu_torch.data.png16 import read_png16
from mccnn_tpu_torch.utils.images import load_gray

HEIGHT, WIDTH = 350, 1242


def remove_nonvisible(disp: np.ndarray) -> np.ndarray:
    """Zero GT where disp >= x (match outside the left frame edge,
    adcensus.cu:1723-1731)."""
    H, W = disp.shape
    xs = np.arange(W)[None, :]
    return np.where(disp >= xs, 0.0, disp)


def remove_occluded(disp: np.ndarray) -> np.ndarray:
    """Zero GT where a pixel to the right maps left of this pixel's
    match: exists i>=1 with (x+i) - d[x+i] < x - d[x]
    (adcensus.cu:1747-1758). Vectorized as a right-to-left running
    minimum of the match column x - d[x]."""
    H, W = disp.shape
    xs = np.arange(W)[None, :].astype(np.float32)
    match = xs - disp  # match column of each pixel
    # min over strictly-right pixels of match[x+i]
    right_min = np.full_like(match, np.inf)
    right_min[:, :-1] = np.minimum.accumulate(match[:, ::-1], axis=1)[:, ::-1][:, 1:]
    return np.where(right_min < match, 0.0, disp)


def remove_white(x: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """Zero GT where the source intensity equals 255
    (adcensus.cu:1774-1784). The reference calls this on the already
    standardized image, making it a no-op; kept for parity."""
    return np.where(x == 255.0, 0.0, disp)


def make_dataset2(disp: np.ndarray, img_1based: int) -> np.ndarray:
    """(img, y, x, disp) rows for every pixel with disp > 0.5, row-major
    scan order (adcensus.cu:1915-1924)."""
    ys, xs = np.nonzero(disp > 0.5)
    return np.column_stack([
        np.full_like(ys, img_1based, dtype=np.float32),
        ys.astype(np.float32), xs.astype(np.float32),
        disp[ys, xs].astype(np.float32)])


def preprocess_one(root: str, year: int) -> None:
    if year == 2012:
        n_tr, n_te, path = 194, 195, "data.kitti"
        image_0, image_1, disp_noc = "image_0", "image_1", "disp_noc"
    else:
        n_tr, n_te, path = 200, 200, "data.kitti2015"
        image_0, image_1, disp_noc = "image_2", "image_3", "disp_noc_0"
    out_dir = os.path.join(root, path)

    x0 = np.zeros((n_tr + n_te, 1, HEIGHT, WIDTH), np.float32)
    x1 = np.zeros((n_tr + n_te, 1, HEIGHT, WIDTH), np.float32)
    dispnoc = np.zeros((n_tr, 1, HEIGHT, WIDTH), np.float32)
    metadata = np.zeros((n_tr + n_te, 3), np.int32)

    examples = [("training", i) for i in range(1, n_tr + 1)] + \
               [("testing", i) for i in range(1, n_te + 1)]
    for i, (split, cnt) in enumerate(examples, start=1):
        fn0 = os.path.join(out_dir, "unzip", split, image_0, f"{cnt - 1:06d}_10.png")
        fn1 = os.path.join(out_dir, "unzip", split, image_1, f"{cnt - 1:06d}_10.png")
        img_0 = load_gray(fn0)  # rgb2y applied for color inputs
        img_1 = load_gray(fn1)
        img_height, img_width = img_0.shape
        img_0 = img_0[img_height - HEIGHT:]
        img_1 = img_1[img_height - HEIGHT:]
        img_0 = (img_0 - img_0.mean()) / img_0.std(ddof=1)
        img_1 = (img_1 - img_1.mean()) / img_1.std(ddof=1)
        x0[i - 1, 0, :, :img_width] = img_0
        x1[i - 1, 0, :, :img_width] = img_1
        if split == "training":
            gt = read_png16(os.path.join(out_dir, "unzip", "training",
                                         disp_noc, f"{cnt - 1:06d}_10.png"))
            dispnoc[i - 1, 0, :, :img_width] = gt[img_height - HEIGHT:]
        metadata[i - 1] = (img_height, img_width, cnt - 1)
        if i % 50 == 0:
            print(i, flush=True)

    # torch.randperm(n_tr) with manualSeed(42) — we use numpy's; the
    # exact permutation differs from torch but the 40/154 split
    # semantics match (preprocess_kitti.lua:86-88).
    rng = np.random.RandomState(42)
    perm = rng.permutation(n_tr) + 1  # 1-based ids
    te, tr = perm[:40], perm[40:]

    nnz_tr_list, nnz_te_list = [], []
    te_set = set(int(v) for v in te)
    for i in range(1, n_tr + 1):
        d = dispnoc[i - 1, 0].copy()
        d = remove_nonvisible(d)
        d = remove_occluded(d)
        d = remove_white(x0[i - 1, 0], d)
        rows = make_dataset2(d, i)
        (nnz_te_list if i in te_set else nnz_tr_list).append(rows)
    nnz_tr = np.concatenate(nnz_tr_list) if nnz_tr_list else np.zeros((0, 4), np.float32)
    nnz_te = np.concatenate(nnz_te_list) if nnz_te_list else np.zeros((0, 4), np.float32)
    print(f"{path}: nnz_tr={len(nnz_tr)} nnz_te={len(nnz_te)}")

    tofile(os.path.join(out_dir, "x0.bin"), x0)
    tofile(os.path.join(out_dir, "x1.bin"), x1)
    tofile(os.path.join(out_dir, "dispnoc.bin"), dispnoc)
    tofile(os.path.join(out_dir, "metadata.bin"), metadata)
    tofile(os.path.join(out_dir, "tr.bin"), tr.astype(np.int64))
    tofile(os.path.join(out_dir, "te.bin"), te.astype(np.int64))
    tofile(os.path.join(out_dir, "nnz_tr.bin"), nnz_tr)
    tofile(os.path.join(out_dir, "nnz_te.bin"), nnz_te)


def main(root: str = ".") -> None:
    for year in (2012, 2015):
        print(f"dataset {year}")
        preprocess_one(root, year)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
