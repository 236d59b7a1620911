"""Dataset assembly: loading preprocessed KITTI / Middlebury tensors.

Mirrors the reference's dataset-loading section (main.lua:394-491):

- **KITTI / KITTI2015**: fixed ``height=350, width=1242, disp_max=228``;
  ``X0/X1`` are ``(N, 1, 350, 1242)`` standardized float32 images,
  ``dispnoc`` the ground-truth disparity (0 = invalid), ``metadata``
  rows ``(img_height, img_width, id)``, ``tr``/``te`` train/val image
  index lists (1-based, like the reference), ``nnz_tr``/``nnz_te`` flat
  ``(n, 4)`` float32 tables of ``(img, y, x, disp)`` ground-truth
  points. ``-at 1`` concatenates KITTI 2012 + 2015 (main.lua:403-426).
- **Middlebury**: per-image tensors ``x_<n>_<light>.bin`` of shape
  ``(n_exposures, 2, C, H, W)``, per-image ``disp_max`` from
  ``metadata[i][2]``, nested access ``X[img][light][exp][cam]``
  (main.lua:447-491).

All reads go through :func:`mccnn_tpu_torch.data.bin_io.fromfile` and are
memory-mapped.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from mccnn_tpu_torch.config import Config
from mccnn_tpu_torch.data.bin_io import fromfile, tofile


@dataclass
class StereoDataset:
    dataset: str
    height: int
    width: int
    disp_max: int
    err_at: int
    n_te: int
    n_input_plane: int = 1
    # KITTI-style dense tensors
    X0: Optional[np.ndarray] = None  # (N, 1, H, W)
    X1: Optional[np.ndarray] = None
    dispnoc: Optional[np.ndarray] = None  # (N, 1, H, W)
    metadata: Optional[np.ndarray] = None  # (N, 3) int32
    tr: Optional[np.ndarray] = None  # 1-based image ids
    te: Optional[np.ndarray] = None
    nnz_tr: Optional[np.ndarray] = None  # (n, 4): img, y, x, disp (1-based img/y/x)
    nnz_te: Optional[np.ndarray] = None
    # Middlebury nested: X[img][light] = (n_exp, 2, C, H, W); both 0-based lists
    X: Optional[list] = None
    mb_dispnoc: Optional[list] = None
    fname_submit: Optional[list] = None

    def nnz_for_action(self, action: str) -> np.ndarray:
        if action == "train_all":
            return np.concatenate([self.nnz_tr, self.nnz_te], axis=0)
        return self.nnz_tr


def _data_dir(cfg: Config, name: str) -> str:
    base = cfg.data_dir if cfg.data_dir else "."
    return os.path.join(base, name)


def load_kitti(cfg: Config) -> StereoDataset:
    """main.lua:394-445. With -at 1, merges 2012 and 2015 by offsetting
    the second set's image indices (main.lua:403-426)."""
    height, width, disp_max, n_te = 350, 1242, 228, (195 if cfg.dataset == "kitti" else 200)

    def load_one(dirname):
        d = _data_dir(cfg, dirname)
        out = {}
        for k in ("x0", "x1", "dispnoc", "metadata", "tr", "te", "nnz_tr", "nnz_te"):
            out[k] = fromfile(os.path.join(d, f"{k}.bin"))
        return out

    main_dir = "data.kitti" if cfg.dataset == "kitti" else "data.kitti2015"
    if cfg.at == 1:
        # main.lua:403-426: image rows are ALWAYS ordered [2012 GT
        # images | 2015 GT images | primary set's test slab]; both tr
        # lists are concatenated (2015 ids offset by the 2012 GT image
        # count, 194 for real KITTI); te and the appended test images
        # come from the primary set only; both nnz_te tables stay out
        # of nnz_tr. The GT image count is the dispnoc row count
        # (preprocess writes GT for the training images only).
        d12 = load_one("data.kitti")
        d15 = load_one("data.kitti2015")
        n12 = d12["dispnoc"].shape[0]
        n15 = d15["dispnoc"].shape[0]
        prim, n_prim = (d12, n12) if cfg.dataset == "kitti" else (d15, n15)

        def merge(key):
            return np.concatenate([np.asarray(d12[key][:n12]),
                                   np.asarray(d15[key][:n15]),
                                   np.asarray(prim[key][n_prim:])])

        def off15(nnz):
            nnz = np.array(nnz, copy=True)
            nnz[:, 0] += n12
            return nnz

        te = (np.asarray(d12["te"]) if cfg.dataset == "kitti"
              else np.asarray(d15["te"]) + n12)
        a = dict(
            x0=merge("x0"), x1=merge("x1"), metadata=merge("metadata"),
            dispnoc=np.concatenate([np.asarray(d12["dispnoc"]),
                                    np.asarray(d15["dispnoc"])]),
            tr=np.concatenate([np.asarray(d12["tr"]),
                               np.asarray(d15["tr"]) + n12]),
            te=te,
            nnz_tr=np.concatenate([np.asarray(d12["nnz_tr"]),
                                   off15(d15["nnz_tr"])]),
            nnz_te=np.concatenate([np.asarray(d12["nnz_te"]),
                                   off15(d15["nnz_te"])]),
        )
    else:
        a = load_one(main_dir)
    return StereoDataset(
        dataset=cfg.dataset, height=height, width=width, disp_max=disp_max,
        err_at=3, n_te=n_te, X0=a["x0"], X1=a["x1"], dispnoc=a["dispnoc"],
        metadata=np.asarray(a["metadata"], dtype=np.int64),
        tr=np.asarray(a["tr"], dtype=np.int64),
        te=np.asarray(a["te"], dtype=np.int64),
        nnz_tr=np.asarray(a["nnz_tr"]), nnz_te=np.asarray(a["nnz_te"]))


def load_mb(cfg: Config) -> StereoDataset:
    """main.lua:447-491: data.mb.<rect>_<color> layout from
    preprocess_mb.py:330-344."""
    d = _data_dir(cfg, f"data.mb.{cfg.rect}_{cfg.color}")
    te = np.asarray(fromfile(os.path.join(d, "te.bin")), dtype=np.int64)
    metadata = np.asarray(fromfile(os.path.join(d, "meta.bin")), dtype=np.int64)
    nnz_tr = np.asarray(fromfile(os.path.join(d, "nnz_tr.bin")))
    nnz_te = np.asarray(fromfile(os.path.join(d, "nnz_te.bin")))
    fname_submit = []
    with open(os.path.join(d, "fname_submit.txt")) as f:
        fname_submit = [line.strip() for line in f if line.strip()]
    X: list = []
    dispnoc: list = []
    n = metadata.shape[0]
    for i in range(1, n + 1):
        lights = []
        for light in range(1, 100):
            fname = os.path.join(d, f"x_{i}_{light}.bin")
            if not os.path.exists(fname):
                break
            lights.append(fromfile(fname))
        X.append(lights)
        dn = os.path.join(d, f"dispnoc{i}.bin")
        dispnoc.append(fromfile(dn) if os.path.exists(dn) else None)
    n_input = 3 if cfg.color == "rgb" else 1
    return StereoDataset(
        dataset="mb", height=1500, width=1000, disp_max=0, err_at=1,
        n_te=len(fname_submit), n_input_plane=n_input, metadata=metadata,
        te=te, nnz_tr=nnz_tr, nnz_te=nnz_te, X=X, mb_dispnoc=dispnoc,
        fname_submit=fname_submit)


def load_dataset(cfg: Config) -> StereoDataset:
    if cfg.dataset in ("kitti", "kitti2015"):
        return load_kitti(cfg)
    return load_mb(cfg)


def subset_nnz(nnz: np.ndarray, image_ids: np.ndarray) -> np.ndarray:
    """Filter nnz rows to images in `image_ids` (adcensus.cu:1863-1898,
    used for -subset, main.lua:622-647)."""
    keep = np.isin(nnz[:, 0].astype(np.int64), np.asarray(image_ids, np.int64))
    return nnz[keep]


def make_synthetic_kitti(out_dir: str, n_images: int = 4, height: int = 64,
                         width: int = 128, disp_max: int = 16,
                         seed: int = 42, n_test_images: int = 0,
                         occlusions: bool = False) -> None:
    """Write a tiny synthetic dataset in the exact data.kitti layout.

    Left image = random smooth texture; right image = left shifted by a
    ground-truth disparity plane — or, with ``occlusions=True``,
    z-buffer-rendered :func:`make_occlusion_pair` scenes whose
    foreground/background discontinuities exercise the KITTI-only
    refinement chain (dispnoc then excludes the occluded band like the
    real KITTI disp_noc maps). Used by tests and smoke training — the
    reference has no equivalent (it assumes the real datasets), but
    the binary contract matches preprocess_kitti.lua:118-144.

    ``n_test_images`` appends GT-less submission-test images to
    x0/x1/metadata (like the real preprocessed sets, where the test
    slab follows the GT images and dispnoc covers the GT images only).
    """
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    X0 = np.zeros((n_images, 1, height, width), np.float32)
    X1 = np.zeros((n_images, 1, height, width), np.float32)
    dispnoc = np.zeros((n_images, 1, height, width), np.float32)
    metadata = np.zeros((n_images, 3), np.int32)
    nnz_rows = []
    for i in range(n_images):
        if occlusions:
            left, right, dmap, occ, valid = make_occlusion_pair(
                height, width, disp_max, seed=seed + 7 * i)
            left = (left - left.mean()) / (left.std() + 1e-6)
            right = (right - right.mean()) / (right.std() + 1e-6)
            X0[i, 0] = left
            X1[i, 0] = right
            noc = valid & ~occ
            dispnoc[i, 0] = np.where(noc, dmap, 0.0)
            metadata[i] = (height, width, i)
            ys, xs = np.nonzero(noc)
            keep = (rng.rand(len(ys)) < 0.25) & (ys >= 8) \
                & (ys < height - 8) & (xs >= 8) & (xs < width - 8)
            for y, x in zip(ys[keep], xs[keep]):
                nnz_rows.append((i + 1, y, x, dmap[y, x]))
            continue
        base = rng.randn(height, width + disp_max).astype(np.float32)
        # smooth the texture so matching is learnable
        k = np.ones(5, np.float32) / 5
        for axis in (0, 1):
            base = np.apply_along_axis(
                lambda r: np.convolve(r, k, mode="same"), axis, base)
        base = (base - base.mean()) / (base.std() + 1e-6)
        d = float(rng.randint(3, disp_max - 2))
        # left pixel x matches right pixel x - d (right[x-d] == left[x])
        left = base[:, :width]
        right = base[:, int(d):int(d) + width]
        X0[i, 0] = left
        X1[i, 0] = right
        dispnoc[i, 0, :, :] = d
        dispnoc[i, 0, :, : int(d)] = 0  # match out of right frame
        metadata[i] = (height, width, i)
        ys, xs = np.mgrid[8:height - 8, int(d) + 8:width - 8]
        sel = rng.rand(*ys.shape) < 0.2
        for y, x in zip(ys[sel].ravel(), xs[sel].ravel()):
            # img 1-based, y/x 0-based (make_dataset2, adcensus.cu:1915-1922)
            nnz_rows.append((i + 1, y, x, d))
    nnz = np.asarray(nnz_rows, np.float32)
    rng.shuffle(nnz)
    if n_test_images:
        Xt0 = rng.randn(n_test_images, 1, height, width).astype(np.float32)
        Xt1 = rng.randn(n_test_images, 1, height, width).astype(np.float32)
        X0 = np.concatenate([X0, Xt0])
        X1 = np.concatenate([X1, Xt1])
        mt = np.stack([np.full(n_test_images, height, np.int32),
                       np.full(n_test_images, width, np.int32),
                       np.arange(n_images, n_images + n_test_images,
                                 dtype=np.int32)], axis=1)
        metadata = np.concatenate([metadata, mt])
    tofile(os.path.join(out_dir, "x0.bin"), X0)
    tofile(os.path.join(out_dir, "x1.bin"), X1)
    tofile(os.path.join(out_dir, "dispnoc.bin"), dispnoc)
    tofile(os.path.join(out_dir, "metadata.bin"), metadata)
    tr = np.arange(1, n_images, dtype=np.int64)  # last image is validation
    te = np.asarray([n_images], dtype=np.int64)
    tofile(os.path.join(out_dir, "tr.bin"), tr)
    tofile(os.path.join(out_dir, "te.bin"), te)
    keep_tr = np.isin(nnz[:, 0].astype(np.int64), tr)
    tofile(os.path.join(out_dir, "nnz_tr.bin"), nnz[keep_tr])
    tofile(os.path.join(out_dir, "nnz_te.bin"), nnz[~keep_tr])


def make_synthetic_mb(out_dir: str, n_images: int = 3, height: int = 48,
                      width: int = 96, disp_max: int = 10, n_lights: int = 3,
                      n_exp: int = 2, seed: int = 42) -> None:
    """Write a tiny synthetic dataset in the exact data.mb.<rect>_<color>
    layout (preprocess_mb.py:330-344): per-image ``x_<n>_<light>.bin``
    with light 1 = the official 4-view eval tensor (im0, im1, im1E,
    im1L) and lights 2.. = ``(n_exp, 2, C, H, W)`` training stacks,
    ``dispnoc<n>.bin``, ``meta.bin``, nnz tables, ``te.bin``,
    ``fname_submit.txt``. Image 1 is the validation image (te).
    """
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    meta, nnz_tr, nnz_te = [], [], []
    fname_submit = []
    for i in range(1, n_images + 1):
        base = rng.randn(height, width + disp_max).astype(np.float32)
        k = np.ones(5, np.float32) / 5
        for axis in (0, 1):
            base = np.apply_along_axis(
                lambda r: np.convolve(r, k, mode="same"), axis, base)
        base = (base - base.mean()) / (base.std() + 1e-6)
        d = float(rng.randint(3, disp_max - 2))
        # left pixel x matches right pixel x - d (right[x-d] == left[x])
        left = base[:, :width]
        right = base[:, int(d):int(d) + width]
        # light 1: 4 views (im0, im1, im1E, im1L) — brightness variants
        views = np.stack([left, right, right * 1.1, right * 0.9])[:, None]
        tofile(os.path.join(out_dir, f"x_{i}_1.bin"),
               views.astype(np.float32))
        for light in range(2, n_lights + 1):
            pairs = np.stack(
                [np.stack([left + rng.randn() * 0.01,
                           right + rng.randn() * 0.01])[:, None]
                 for _ in range(n_exp)])
            tofile(os.path.join(out_dir, f"x_{i}_{light}.bin"),
                   pairs.astype(np.float32))
        disp = np.full((height, width), d, np.float32)
        disp[:, : int(d)] = 0
        tofile(os.path.join(out_dir, f"dispnoc{i}.bin"), disp)
        meta.append((height, width, disp_max))
        ys, xs = np.mgrid[8:height - 8, int(d) + 8:width - 8]
        sel = rng.rand(*ys.shape) < 0.2
        rows = np.column_stack([
            np.full(sel.sum(), i, np.float32),
            ys[sel].astype(np.float32), xs[sel].astype(np.float32),
            np.full(sel.sum(), d, np.float32)])
        (nnz_te if i == 1 else nnz_tr).append(rows)
        fname_submit.append(f"trainingH/synth{i}")
    tofile(os.path.join(out_dir, "meta.bin"),
           np.asarray(meta, np.int32))
    tofile(os.path.join(out_dir, "nnz_tr.bin"),
           np.concatenate(nnz_tr).astype(np.float32))
    tofile(os.path.join(out_dir, "nnz_te.bin"),
           np.concatenate(nnz_te).astype(np.float32))
    tofile(os.path.join(out_dir, "te.bin"), np.asarray([1], np.int64))
    with open(os.path.join(out_dir, "fname_submit.txt"), "w") as f:
        f.write("\n".join(fname_submit))


def make_occlusion_pair(height: int, width: int, disp_max: int,
                        seed: int = 0, noise: float = 0.03,
                        n_objects: int = 3):
    """Synthetic stereo pair with TRUE occlusions and noise.

    A background plane at disparity ``disp_max // 4`` with
    ``n_objects`` foreground rectangles at higher disparities; the
    right view is forward-splatted from the left with a z-buffer
    (nearer surface wins), so the background band immediately left of
    each foreground object is genuinely occluded — visible in the
    left image, covered in the right — and disoccluded right-view
    holes get fresh texture that matches nothing in the left image.
    This is the geometry the reference's KITTI-only refinement chain
    (LR outlier detection -> occlusion fill -> mismatch fill,
    main.lua:1054-1066) exists to repair; the constant-disparity
    synthetic sets never exercise it.

    Returns ``(left, right, gt_disp, occluded, valid)``: float32
    images (unstandardized), the full left-reference ground-truth
    disparity (including occluded pixels, like KITTI's disp_occ),
    the boolean occlusion mask (z-buffer losers), and the valid-GT
    mask (match inside the right frame).
    """
    rng = np.random.RandomState(seed)
    tex = rng.randn(height, width).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    for axis in (0, 1):
        tex = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), axis, tex)
    tex = (tex - tex.mean()) / (tex.std() + 1e-6)

    d_bg = max(1, disp_max // 4)
    d = np.full((height, width), d_bg, np.float32)
    bh, bw = max(8, height // 3), max(8, width // 6)
    for i in range(n_objects):
        y0 = rng.randint(0, max(1, height - bh))
        x0 = rng.randint(disp_max, max(disp_max + 1, width - bw))
        d_fg = rng.randint(disp_max // 2, disp_max - 1)
        d[y0:y0 + bh, x0:x0 + bw] = d_fg
        tex[y0:y0 + bh, x0:x0 + bw] += 0.5  # faint object edge

    left = tex
    right = np.zeros_like(left)
    zbuf = np.full((height, width), -1.0, np.float32)
    for x in range(width):
        dx = d[:, x].astype(np.int64)
        xr = x - dx
        ys = np.nonzero(xr >= 0)[0]
        xrv = xr[ys]
        win = d[ys, x] > zbuf[ys, xrv]
        ys, xrv = ys[win], xrv[win]
        right[ys, xrv] = left[ys, x]
        zbuf[ys, xrv] = d[ys, x]
    # disoccluded holes: texture visible only in the right view
    holes = zbuf < 0
    fill = rng.randn(height, width).astype(np.float32)
    for axis in (0, 1):
        fill = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), axis, fill)
    right[holes] = fill[holes] / (fill.std() + 1e-6)

    xs = np.arange(width)[None, :]
    valid = xs - d >= 0
    occluded = np.zeros((height, width), bool)
    inb = valid
    occluded[inb] = zbuf[np.nonzero(inb)[0],
                         (xs - d.astype(np.int64))[inb]] > d[inb]

    left = left + rng.randn(height, width).astype(np.float32) * noise
    right = right + rng.randn(height, width).astype(np.float32) * noise
    return (left.astype(np.float32), right.astype(np.float32), d,
            occluded, valid)
