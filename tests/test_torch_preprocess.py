"""The port's preprocess scripts against the JAX package's: one synthetic
raw tree, both packages' scripts, every output file equal byte for
byte. KITTI at the fixed image counts (194/195 and 200/200, with ground
truth, both years) with ``HEIGHT, WIDTH`` cut to a few rows and
columns; Middlebury with a tiny scene or more in each generation that
``Builder`` reads (11 with ground truth, so that image 11 trains), PFMs
written by the port's ``data/pfm.py``. The port's modules import with
PIL blocked."""

import importlib
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from mccnn_tpu.data import preprocess_kitti as jkitti, preprocess_mb as jmb
from mccnn_tpu_torch.data import preprocess_kitti, preprocess_mb
from mccnn_tpu_torch.data.pfm import write_pfm

# the cut frame of both modules, and the raw images' size: taller than
# the frame (a bottom crop) and narrower (a zero pad)
HEIGHT, WIDTH = 4, 11
IMG_H, IMG_W = 6, 9


def _files(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def kitti_raw(tmp_path_factory):
    """The raw KITTI trees of both years: gray (2012) and color (2015)
    pairs, 16-bit ground truth with invalid zeros for every training
    image."""
    root = tmp_path_factory.mktemp("kitti_raw")
    rng = np.random.RandomState(0)
    years = (("data.kitti", 194, 195, "image_0", "image_1", "disp_noc", 1),
             ("data.kitti2015", 200, 200, "image_2", "image_3", "disp_noc_0",
              3))
    for path, n_tr, n_te, im0, im1, gt, c in years:
        for split, n in (("training", n_tr), ("testing", n_te)):
            base = root / path / "unzip" / split
            for i in range(n):
                name = f"{i:06d}_10.png"
                for im in (im0, im1):
                    shape = (IMG_H, IMG_W) + ((c,) if c > 1 else ())
                    _png(str(base / im / name),
                         rng.randint(0, 256, shape).astype(np.uint8))
                if split == "training":
                    d = rng.uniform(0, 6, (IMG_H, IMG_W))
                    d[rng.rand(IMG_H, IMG_W) < 0.2] = 0
                    _png(str(base / gt / name),
                         (d * 256).astype(np.uint16))
    return root


def _run_kitti(module, raw, out, monkeypatch):
    for year_dir in ("data.kitti", "data.kitti2015"):
        os.makedirs(out / year_dir)
        os.symlink(raw / year_dir / "unzip", out / year_dir / "unzip")
    monkeypatch.setattr(module, "HEIGHT", HEIGHT)
    monkeypatch.setattr(module, "WIDTH", WIDTH)
    module.main(str(out))
    for year_dir in ("data.kitti", "data.kitti2015"):
        os.unlink(out / year_dir / "unzip")


def test_preprocess_kitti_writes_the_jax_files(kitti_raw, tmp_path,
                                               monkeypatch, capsys):
    _run_kitti(jkitti, kitti_raw, tmp_path / "jax", monkeypatch)
    _run_kitti(preprocess_kitti, kitti_raw, tmp_path / "port", monkeypatch)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    names = {f"{d}/{n}{ext}" for d in ("data.kitti", "data.kitti2015")
             for n in ("x0.bin", "x1.bin", "dispnoc.bin", "metadata.bin",
                       "tr.bin", "te.bin", "nnz_tr.bin", "nnz_te.bin")
             for ext in ("", ".dim", ".type")}
    assert set(want) == names
    assert set(got) == set(want)
    for name in sorted(want):
        assert got[name] == want[name], name
    dim = want["data.kitti/x0.bin.dim"].decode().split()
    assert dim == ["389", "1", str(HEIGHT), str(WIDTH)]
    nnz = np.frombuffer(want["data.kitti/nnz_tr.bin"], np.float32)
    assert nnz.size > 0 and nnz.size % 4 == 0
    assert "nnz_tr=" in capsys.readouterr().out


# --- Middlebury ----------------------------------------------------------

MB = "data.mb/unzip/vision.middlebury.edu/stereo/data"


def _gray_img(rng, h, w, path, mode="L"):
    shape = (h, w) if mode == "L" else (h, w, 3)
    _png(path, rng.randint(0, 256, shape).astype(np.uint8))


def _disp(rng, h, w, scale, path):
    d = np.round(rng.uniform(1, 4, (h, w)) * scale)
    d[rng.rand(h, w) < 0.1] = 0
    _png(path, d.astype(np.uint8))


def _mb_raw(root):
    """11 scenes with ground truth (2014 x2, 2006 x2, 2005 x2, 2003 x2,
    2001 x3: tsukuba, map and another) and one MiddEval3 scene each in
    trainingH and testH."""
    rng = np.random.RandomState(1)
    h, w = 12, 16
    for name in ("Adirondack", "Jadeplant"):
        b = root / MB / "scenes2014" / "datasets" / f"{name}-imperfect"
        os.makedirs(b)
        (b / "calib.txt").write_text("cam0=[1 0 0]\nndisp=10\n")
        for f in ("im0.png", "im1.png", "im1E.png", "im1L.png"):
            _gray_img(rng, h, w, str(b / f), "RGB")
        for light in ("L1", "L2"):
            for exp in (0, 1):
                for cam in (0, 1):
                    _gray_img(rng, h, w,
                              str(b / "ambient" / light / f"im{cam}e{exp}.png"),
                              "RGB")
        for f in ("disp0.pfm", "disp1.pfm", "disp0y.pfm"):
            d = rng.uniform(0.5, 4, (h, w)).astype(np.float32)
            if f == "disp0y.pfm":
                d = rng.uniform(-1, 1, (h, w)).astype(np.float32)
            d[rng.rand(h, w) < 0.05] = np.inf
            write_pfm(d, str(b / f))
    for year, names in ((2006, ("Aloe", "Baby1")), (2005, ("Art", "Books"))):
        for name in names:
            b = root / MB / f"scenes{year}" / "HalfSize" / name
            for light in range(3):
                for exp in range(3):
                    for v in ("view1.png", "view5.png"):
                        _gray_img(rng, h, w,
                                  str(b / f"Illum{light + 1}" / f"Exp{exp}" / v),
                                  "RGB")
            _disp(rng, h, w, 2, str(b / "disp1.png"))
            _disp(rng, h, w, 2, str(b / "disp5.png"))
    for name in ("conesH", "teddyH"):
        b = root / MB / "scenes2003" / name
        _gray_img(rng, h, w, str(b / "im2.ppm"), "RGB")
        _gray_img(rng, h, w, str(b / "im6.ppm"), "RGB")
        _disp(rng, h, w, 2, str(b / "disp2.pgm"))
        _disp(rng, h, w, 2, str(b / "disp6.pgm"))
    b01 = root / MB / "scenes2001" / "data"
    _gray_img(rng, h, w, str(b01 / "tsukuba" / "scene1.row3.col3.ppm"), "RGB")
    _gray_img(rng, h, w, str(b01 / "tsukuba" / "scene1.row3.col4.ppm"), "RGB")
    _disp(rng, h, w, 16, str(b01 / "tsukuba" / "truedisp.row3.col3.pgm"))
    _png(str(b01 / "tsukuba" / "nonocc.png"),
         np.where(rng.rand(h, w) < 0.8, 255, 0).astype(np.uint8))
    _gray_img(rng, h, w, str(b01 / "map" / "im0.pgm"))
    _gray_img(rng, h, w, str(b01 / "map" / "im1.pgm"))
    _disp(rng, h, w, 8, str(b01 / "map" / "disp0.pgm"))
    _disp(rng, h, w, 8, str(b01 / "map" / "disp1.pgm"))
    _gray_img(rng, h, w, str(b01 / "sawtooth" / "im2.ppm"), "RGB")
    _gray_img(rng, h, w, str(b01 / "sawtooth" / "im6.ppm"), "RGB")
    _disp(rng, h, w, 8, str(b01 / "sawtooth" / "disp2.pgm"))
    _disp(rng, h, w, 8, str(b01 / "sawtooth" / "disp6.pgm"))
    for split in ("trainingH", "testH"):
        b = root / "data.mb" / "unzip" / "MiddEval3" / split / "Motorcycle"
        os.makedirs(b)
        (b / "calib.txt").write_text("ndisp=24\n")
        _gray_img(rng, h, w, str(b / "im0.png"), "RGB")
        _gray_img(rng, h, w, str(b / "im1.png"), "RGB")


@pytest.mark.parametrize("color", ["gray", "rgb"])
def test_preprocess_mb_writes_the_jax_files(tmp_path, color, capsys):
    """Each package on its own copy of the raw tree (the half-size
    images and ground truth are cached beside the raw files)."""
    _mb_raw(tmp_path / "raw")
    for who in ("jax", "port"):
        shutil.copytree(tmp_path / "raw", tmp_path / who)
    jmb.main("imperfect", color, str(tmp_path / "jax"))
    preprocess_mb.main("imperfect", color, str(tmp_path / "port"))
    out = f"data.mb.imperfect_{color}"
    want, got = _files(tmp_path / "jax" / out), _files(tmp_path / "port" / out)
    assert set(got) == set(want)
    for name in sorted(want):
        assert got[name] == want[name], name
    assert want["meta.bin.dim"].decode().split() == ["13", "3"]
    assert len(want["nnz_tr.bin"]) > 0 and len(want["nnz_te.bin"]) > 0
    assert {"x_1_1.bin", "x_1_3.bin", "x_3_4.bin", "x_13_1.bin",
            "dispnoc11.bin"} <= set(want)
    assert "trainingH/Motorcycle" in want["fname_submit.txt"].decode()
    capsys.readouterr()


def test_port_modules_import_without_pil(monkeypatch):
    for name in ("PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    for name in ("mccnn_tpu_torch.data.preprocess_mb",
                 "mccnn_tpu_torch.data.preprocess_kitti",
                 "mccnn_tpu_torch.utils.images",
                 "mccnn_tpu_torch.data.png16"):
        monkeypatch.delitem(sys.modules, name)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401  (the block holds)
    mods = [importlib.import_module(f"mccnn_tpu_torch.data.{n}")
            for n in ("preprocess_mb", "preprocess_kitti")]
    assert all(callable(m.main) for m in mods)
    with pytest.raises(ImportError):
        mods[0].read_im("x.png", False, "gray")
