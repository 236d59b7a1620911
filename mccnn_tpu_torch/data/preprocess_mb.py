"""Middlebury preprocessing into the binary dataset format.

Behavior contract: preprocess_mb.py (reference, python2) — ingests six
dataset generations into ``data.mb.<rect>_<color>/``:

- **2014**: half-resolution (50% resize, cached as ``*.H.png``), GT PFM
  downsampled by taking the 2nd-smallest of each 2x2 block and halving
  (load_pfm, preprocess_mb.py:13-26), ndisp/2, lights stacked as
  ``x_<n>_<light>.bin``; light 1 = the official pair [im0, im1, im1E,
  im1L] reserved for eval (preprocess_mb.py:135-140).
- **2006/2005**: HalfSize, 3 lights x 3 exposures, GT PNG /2.
- **2003**: conesH/teddyH, GT /2.
- **2001**: GT /8 (tsukuba /16 with its own nonocc mask).
- **MiddEval3 trainingH/testH**: submission inputs + ndisp from
  calib.txt.

Occlusion masks: the reference shells out to the MiddEval3 SDK's
``computemask`` (preprocess_mb.py:174,221). That binary is replaced
here by an in-process LR-consistency + visibility check with the same
role (mask pixels whose match is inconsistent or out of frame); pixel
sets differ slightly from the SDK's.

Usage: python -m mccnn_tpu_torch.data.preprocess_mb <perfect|imperfect> <gray|rgb> [root]

A copy of the JAX package's ``mccnn_tpu/data/preprocess_mb.py``: the
same files, byte for byte. PIL is imported inside the functions that
read images, so the module imports without it.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from mccnn_tpu_torch.data.pfm import read_pfm

_RGB2GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def _write_none(fname: str) -> None:
    with open(fname + ".dim", "w") as f:
        f.write("0\n")
    open(fname, "w").close()


def tofile(fname: str, x) -> None:
    """Reference tofile (preprocess_mb.py:99-106): None -> `.dim` of 0."""
    if x is None or (hasattr(x, "size") and x.size == 0):
        _write_none(fname)
        return
    x = np.ascontiguousarray(x)
    x.tofile(fname)
    with open(fname + ".type", "w") as f:
        f.write(str(x.dtype))
    with open(fname + ".dim", "w") as f:
        f.write("\n".join(str(s) for s in x.shape))


def read_im(fname: str, downsample: bool, color: str) -> np.ndarray:
    """(1, C, H, W) standardized float32 (preprocess_mb.py:85-97)."""
    from PIL import Image

    if downsample:
        half = fname + ".H.png"
        if not os.path.isfile(half):
            img = Image.open(fname)
            img = img.resize((img.width // 2, img.height // 2), Image.LANCZOS)
            img.save(half)
        fname = half
    x = np.asarray(Image.open(fname).convert("RGB"), np.float32)
    if color == "rgb":
        x = x.transpose(2, 0, 1)
    else:
        x = (x @ _RGB2GRAY)[None]
    x = (x - x.mean()) / x.std()
    return x[None].astype(np.float32)


def load_pfm_half(fname: str) -> np.ndarray:
    """GT downsampling rule (preprocess_mb.py:13-26): halve values, take
    the 2nd smallest of each 2x2 block. Returns top-down rows."""
    cache = fname + ".H.npy"
    if os.path.isfile(cache):
        return np.load(cache)
    x = np.flipud(read_pfm(fname)) / 2.0
    H, W = (x.shape[0] // 2) * 2, (x.shape[1] // 2) * 2
    blocks = x[:H, :W].reshape(H // 2, 2, W // 2, 2).transpose(0, 2, 1, 3)
    out = np.sort(blocks.reshape(H // 2, W // 2, 4), axis=-1)[..., 1]
    out = out.astype(np.float32)
    np.save(cache, out)
    return out


def consistency_mask(disp0: np.ndarray, disp1: np.ndarray,
                     disp0y: np.ndarray | None = None,
                     thresh: float = 1.0) -> np.ndarray:
    """In-process stand-in for the MiddEval3 `computemask` binary: a
    pixel is valid when disp0 is finite, the match x-d is in frame, the
    right image's disparity there agrees within `thresh`, and (when
    given) the vertical disparity is sub-threshold."""
    H, W = disp0.shape
    xs = np.arange(W)[None, :]
    d0 = np.where(np.isfinite(disp0), disp0, np.inf)
    xm = np.round(xs - d0).astype(np.int64)
    ok = np.isfinite(disp0) & (disp0 > 0) & (xm >= 0) & (xm < W)
    xm_c = np.clip(xm, 0, W - 1)
    d1 = np.where(np.isfinite(disp1), disp1, np.inf)
    d1_at = np.take_along_axis(d1, xm_c, axis=1)
    ok &= np.abs(d0 - d1_at) <= thresh
    if disp0y is not None:
        ok &= np.abs(np.where(np.isfinite(disp0y), disp0y, np.inf)) <= thresh
    return ok


class Builder:
    def __init__(self, rect: str, color: str, root: str):
        self.rect, self.color, self.root = rect, color, root
        self.X: list = []
        self.dispnoc: list = []
        self.meta: list = []
        self.nnz_tr: list = []
        self.nnz_te: list = []
        self.te = np.arange(1, 11, dtype=np.int64)
        self.fname_submit: list[str] = []

    def _mb(self, *parts):
        return os.path.join(self.root, "data.mb", "unzip", *parts)

    def add_image(self, XX, disp0, mask, ndisp):
        disp0 = disp0.copy()
        disp0[~mask] = 0
        y, x = np.nonzero(mask)
        self.X.append(XX)
        n = len(self.X)
        rows = np.column_stack([np.full_like(y, n, dtype=np.float32),
                                y.astype(np.float32), x.astype(np.float32),
                                disp0[y, x]]).astype(np.float32)
        (self.nnz_te if n in self.te else self.nnz_tr).append(rows)
        self.dispnoc.append(disp0.astype(np.float32))
        h, w = disp0.shape
        self.meta.append((h, w, ndisp))

    # ---- dataset generations ------------------------------------------
    def scenes2014(self):
        base1 = self._mb("vision.middlebury.edu/stereo/data/scenes2014/datasets")
        if not os.path.isdir(base1):
            return
        for d in sorted(os.listdir(base1)):
            if not d.endswith("imperfect"):
                continue
            print(d.split("-")[0], flush=True)
            b_imp = os.path.join(base1, d)
            b_per = b_imp.replace("imperfect", "perfect")
            calib = open(os.path.join(b_imp, "calib.txt")).read()
            ndisp = int(re.search(r"ndisp=(.*)", calib).group(1)) // 2
            r = lambda f: read_im(os.path.join(b_imp, f), True, self.color)
            XX = [np.concatenate([r("im0.png"), r("im1.png"),
                                  r("im1E.png"), r("im1L.png")])]
            b_amb = os.path.join(
                b_per if self.rect == "perfect" else b_imp, "ambient")
            lights = sorted(os.listdir(b_amb))
            # exposure-pair selection by available exposure count
            exp_names = os.listdir(os.path.join(b_amb, "L1"))
            num_exp = {}
            for f in exp_names:
                m = re.match(r"im(\d)e(\d+)", f)
                if m:
                    num_exp.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
            n_exp = min(len(v) for v in num_exp.values())
            rng_tab = {8: [1, 3, 5], 7: [1, 3, 5], 6: [0, 2, 4],
                       5: [0, 2, 4], 3: [0, 1, 2], 2: [0, 1]}
            for light in range(len(lights)):
                imgs = []
                b4 = os.path.join(b_amb, f"L{light + 1}")
                for exp in rng_tab[n_exp]:
                    for cam in range(2):
                        imgs.append(read_im(
                            os.path.join(b4, f"im{cam}e{exp}.png"), True,
                            self.color))
                c = imgs[0].shape[1]
                h, w = imgs[0].shape[2], imgs[0].shape[3]
                XX.append(np.concatenate(imgs).reshape(
                    len(imgs) // 2, 2, c, h, w))
            disp0 = load_pfm_half(os.path.join(b_imp, "disp0.pfm"))
            disp1 = load_pfm_half(os.path.join(b_imp, "disp1.pfm"))
            disp0y = load_pfm_half(os.path.join(b_imp, "disp0y.pfm"))
            mask = consistency_mask(disp0, disp1, disp0y)
            self.add_image(XX, disp0, mask, ndisp)

    def scenes2006_2005(self):
        from PIL import Image as I
        for year in (2006, 2005):
            base1 = self._mb(f"vision.middlebury.edu/stereo/data/scenes{year}/HalfSize")
            if not os.path.isdir(base1):
                continue
            for d in sorted(os.listdir(base1)):
                b2 = os.path.join(base1, d)
                if not os.path.isfile(b2 + "/disp1.png"):
                    continue
                print(d, flush=True)
                XX = [None]
                for light in range(3):
                    imgs = []
                    for exp in (0, 1, 2):
                        b3 = os.path.join(b2, f"Illum{light + 1}/Exp{exp}")
                        imgs.append(read_im(os.path.join(b3, "view1.png"), False, self.color))
                        imgs.append(read_im(os.path.join(b3, "view5.png"), False, self.color))
                    c, h, w = imgs[0].shape[1:]
                    XX.append(np.concatenate(imgs).reshape(len(imgs) // 2, 2, c, h, w))
                disp0 = np.asarray(I.open(b2 + "/disp1.png").convert("L"), np.float32) / 2
                disp1 = np.asarray(I.open(b2 + "/disp5.png").convert("L"), np.float32) / 2
                ndisp = int(np.ceil(disp0.max()))
                mask = consistency_mask(np.where(disp0 == 0, np.inf, disp0),
                                        np.where(disp1 == 0, np.inf, disp1))
                self.add_image(XX, disp0, mask, ndisp)

    def scenes2003(self):
        from PIL import Image as I
        for d in ("conesH", "teddyH"):
            b1 = self._mb(f"vision.middlebury.edu/stereo/data/scenes2003/{d}")
            if not os.path.isdir(b1):
                continue
            print(d, flush=True)
            x0 = read_im(b1 + "/im2.ppm", False, self.color)
            x1 = read_im(b1 + "/im6.ppm", False, self.color)
            c, h, w = x0.shape[1:]
            XX = [None, np.concatenate((x0, x1)).reshape(1, 2, c, h, w)]
            disp0 = np.asarray(I.open(b1 + "/disp2.pgm"), np.float32) / 2
            disp1 = np.asarray(I.open(b1 + "/disp6.pgm"), np.float32) / 2
            ndisp = int(np.ceil(disp0.max()))
            mask = consistency_mask(np.where(disp0 == 0, np.inf, disp0),
                                    np.where(disp1 == 0, np.inf, disp1))
            self.add_image(XX, disp0, mask, ndisp)

    def scenes2001(self):
        from PIL import Image as I
        b1 = self._mb("vision.middlebury.edu/stereo/data/scenes2001/data")
        if not os.path.isdir(b1):
            return
        for d in sorted(os.listdir(b1)):
            if d == "tsukuba":
                f_d0, f_d1, f_x0, f_x1 = ("truedisp.row3.col3.pgm", "",
                                          "scene1.row3.col3.ppm",
                                          "scene1.row3.col4.ppm")
            elif d == "map":
                f_d0, f_d1, f_x0, f_x1 = "disp0.pgm", "disp1.pgm", "im0.pgm", "im1.pgm"
            else:
                f_d0, f_d1, f_x0, f_x1 = "disp2.pgm", "disp6.pgm", "im2.ppm", "im6.ppm"
            b2 = os.path.join(b1, d)
            if not os.path.isfile(os.path.join(b2, f_d0)):
                continue
            print(d, flush=True)
            x0 = read_im(os.path.join(b2, f_x0), False, self.color)
            x1 = read_im(os.path.join(b2, f_x1), False, self.color)
            c, h, w = x0.shape[1:]
            XX = [None, np.concatenate((x0, x1)).reshape(1, 2, c, h, w)]
            if d == "tsukuba":
                disp0 = np.asarray(I.open(os.path.join(b2, f_d0)), np.float32) / 16
                mask = np.asarray(I.open(os.path.join(b2, "nonocc.png")).convert("L")) == 255
            else:
                disp0 = np.asarray(I.open(os.path.join(b2, f_d0)), np.float32) / 8
                disp1 = np.asarray(I.open(os.path.join(b2, f_d1)), np.float32) / 8
                mask = consistency_mask(np.where(disp0 == 0, np.inf, disp0),
                                        np.where(disp1 == 0, np.inf, disp1))
            self.add_image(XX, disp0, mask, -1)

    def middeval3(self):
        b1 = self._mb("MiddEval3")
        if not os.path.isdir(b1):
            return
        for d1 in ("trainingH", "testH"):
            b2 = os.path.join(b1, d1)
            if not os.path.isdir(b2):
                continue
            for d2 in sorted(os.listdir(b2)):
                b3 = os.path.join(b2, d2)
                print(os.path.join(d1, d2), flush=True)
                calib = open(os.path.join(b3, "calib.txt")).read()
                ndisp = int(re.search(r"ndisp=(.*)", calib).group(1))
                x0 = read_im(os.path.join(b3, "im0.png"), False, self.color)
                x1 = read_im(os.path.join(b3, "im1.png"), False, self.color)
                self.X.append([np.concatenate((x0, x1)).astype(np.float32)])
                h, w = x0.shape[2], x0.shape[3]
                self.meta.append((h, w, ndisp))
                self.fname_submit.append(os.path.join(d1, d2))

    def write(self):
        out_dir = os.path.join(self.root, f"data.mb.{self.rect}_{self.color}")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(len(self.X)):
            for j in range(len(self.X[i])):
                tofile(os.path.join(out_dir, f"x_{i + 1}_{j + 1}.bin"), self.X[i][j])
            if i < len(self.dispnoc):
                tofile(os.path.join(out_dir, f"dispnoc{i + 1}.bin"), self.dispnoc[i])
        tofile(os.path.join(out_dir, "meta.bin"),
               np.asarray(self.meta, np.int32))
        tofile(os.path.join(out_dir, "nnz_tr.bin"), np.vstack(self.nnz_tr))
        tofile(os.path.join(out_dir, "nnz_te.bin"),
               np.vstack(self.nnz_te) if self.nnz_te else None)
        tofile(os.path.join(out_dir, "te.bin"), self.te)
        with open(os.path.join(out_dir, "fname_submit.txt"), "w") as f:
            f.write("\n".join(self.fname_submit))


def main(rect: str, color: str, root: str = ".") -> None:
    assert rect in ("perfect", "imperfect") and color in ("gray", "rgb")
    b = Builder(rect, color, root)
    b.scenes2014()
    b.scenes2006_2005()
    b.scenes2003()
    b.scenes2001()
    b.middeval3()
    b.write()


if __name__ == "__main__":
    main(*sys.argv[1:])
