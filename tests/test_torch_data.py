"""The port's data modules and the host half of its sampler against the
JAX package's: the same files byte for byte, the same loaded arrays,
the same augmentation draws bit for bit. All numpy on both sides, so
every comparison here is exact."""

import os

import numpy as np
import pytest

from mccnn_tpu import config as jconfig
from mccnn_tpu.data import bin_io as jbin_io
from mccnn_tpu.data import datasets as jdatasets
from mccnn_tpu.data import pfm as jpfm
from mccnn_tpu.data import png16 as jpng16
from mccnn_tpu.train import augment as jaugment
from mccnn_tpu_torch import config
from mccnn_tpu_torch.data import bin_io, datasets, pfm, png16
from mccnn_tpu_torch.train import augment


def _same_tree(a, b):
    """Every file under directories ``a`` and ``b`` equal, byte for byte."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64,
                                   np.float64])
def test_tofile_fromfile_match_jax(tmp_path, dtype):
    """Data, ``.dim`` and ``.type`` files equal byte for byte (float64
    is written as float32 by both); ``fromfile`` with and without mmap
    gives the same arrays."""
    x = (np.random.RandomState(0).randn(3, 4, 5) * 100).astype(dtype)
    jbin_io.tofile(str(tmp_path / "j" / "x.bin"), x)
    bin_io.tofile(str(tmp_path / "t" / "x.bin"), x)
    _same_tree(tmp_path / "j", tmp_path / "t")
    for mmap in (True, False):
        got = bin_io.fromfile(str(tmp_path / "t" / "x.bin"), mmap=mmap)
        want = jbin_io.fromfile(str(tmp_path / "j" / "x.bin"), mmap=mmap)
        assert got.dtype == want.dtype and got.shape == (3, 4, 5)
        np.testing.assert_array_equal(got, want)


def test_fromfile_empty_and_bad_type(tmp_path):
    (tmp_path / "e.bin.dim").write_text("0\n")
    assert bin_io.fromfile(str(tmp_path / "e.bin")).shape == (0,)
    with pytest.raises(ValueError):
        bin_io.tofile(str(tmp_path / "u.bin"), np.zeros(3, np.uint8))


@pytest.mark.parametrize("scale", [-0.003922, 1.0])
def test_pfm_matches_jax(tmp_path, scale):
    """Little- (negative scale) and big-endian PFMs equal byte for byte,
    and read back equal by both readers."""
    img = np.random.RandomState(1).rand(7, 11).astype(np.float32) * 60
    jpfm.write_pfm(img, str(tmp_path / "j.pfm"), scale=scale)
    pfm.write_pfm(img, str(tmp_path / "t.pfm"), scale=scale)
    assert _bytes(tmp_path / "j.pfm") == _bytes(tmp_path / "t.pfm")
    got = pfm.read_pfm(str(tmp_path / "t.pfm"))
    np.testing.assert_array_equal(got, jpfm.read_pfm(str(tmp_path / "t.pfm")))
    np.testing.assert_array_equal(got, img)


def test_png16_matches_jax(tmp_path):
    """KITTI 16-bit PNGs equal byte for byte; values below 1e-5 read
    back as 0 (invalid), the others as round-down(d * 256) / 256."""
    disp = np.random.RandomState(2).rand(9, 13).astype(np.float32) * 200
    disp[0, :4] = 0.0
    jpng16.write_png16(disp, str(tmp_path / "j.png"))
    png16.write_png16(disp, str(tmp_path / "t.png"))
    assert _bytes(tmp_path / "j.png") == _bytes(tmp_path / "t.png")
    got = png16.read_png16(str(tmp_path / "t.png"))
    np.testing.assert_array_equal(got, jpng16.read_png16(str(tmp_path
                                                             / "t.png")))
    np.testing.assert_array_equal(got[0, :4], 0.0)
    assert float(np.abs(got - disp).max()) < 1 / 256


@pytest.mark.parametrize("kw", [dict(n_images=3, height=32, width=64,
                                     disp_max=8),
                                dict(n_images=4, height=32, width=64,
                                     disp_max=8, seed=5, n_test_images=2),
                                dict(n_images=2, height=40, width=96,
                                     disp_max=16, occlusions=True)],
                         ids=["plain", "test_slab", "occlusions"])
def test_make_synthetic_kitti_matches_jax(tmp_path, kw):
    jdatasets.make_synthetic_kitti(str(tmp_path / "j"), **kw)
    datasets.make_synthetic_kitti(str(tmp_path / "t"), **kw)
    _same_tree(tmp_path / "j", tmp_path / "t")


def test_make_synthetic_mb_matches_jax(tmp_path):
    kw = dict(n_images=3, height=40, width=80, disp_max=10, seed=3)
    jdatasets.make_synthetic_mb(str(tmp_path / "j"), **kw)
    datasets.make_synthetic_mb(str(tmp_path / "t"), **kw)
    _same_tree(tmp_path / "j", tmp_path / "t")


def test_make_occlusion_pair_matches_jax():
    got = datasets.make_occlusion_pair(40, 120, 24, seed=9)
    want = jdatasets.make_occlusion_pair(40, 120, 24, seed=9)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3].any()  # a real occluded band


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Two KITTI sets (2012 and 2015, each with a GT-less test slab) and
    a Middlebury set, written by the JAX package."""
    root = tmp_path_factory.mktemp("data")
    jdatasets.make_synthetic_kitti(str(root / "data.kitti"), n_images=4,
                                   height=32, width=64, disp_max=8, seed=1,
                                   n_test_images=2)
    jdatasets.make_synthetic_kitti(str(root / "data.kitti2015"), n_images=5,
                                   height=32, width=64, disp_max=8, seed=2,
                                   n_test_images=3)
    jdatasets.make_synthetic_mb(str(root / "data.mb.imperfect_gray"),
                                n_images=3, height=40, width=80, disp_max=10)
    return str(root)


def _same_dataset(got, want):
    for field in ("dataset", "height", "width", "disp_max", "err_at", "n_te",
                  "n_input_plane", "fname_submit"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("X0", "X1", "dispnoc", "metadata", "tr", "te", "nnz_tr",
                  "nnz_te"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.X is None) == (want.X is None)
    if got.X is not None:  # X[img][light]
        assert [len(x) for x in got.X] == [len(x) for x in want.X]
        for lights_a, lights_b in zip(got.X, want.X):
            for x, y in zip(lights_a, lights_b):
                np.testing.assert_array_equal(x, y)
        assert len(got.mb_dispnoc) == len(want.mb_dispnoc)
        for x, y in zip(got.mb_dispnoc, want.mb_dispnoc):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dataset,at", [("kitti", 0), ("kitti2015", 0),
                                        ("kitti", 1), ("kitti2015", 1)])
def test_load_kitti_matches_jax(data_root, dataset, at):
    """Plain loads and the ``-at 1`` 2012 + 2015 merge
    (main.lua:403-426): every array equal, dtypes included; the train
    and train_all nnz tables too."""
    got = datasets.load_dataset(config.make_config(dataset, "fast", at=at,
                                                   data_dir=data_root))
    want = jdatasets.load_dataset(jconfig.make_config(dataset, "fast", at=at,
                                                      data_dir=data_root))
    _same_dataset(got, want)
    for action in ("train_tr", "train_all"):
        np.testing.assert_array_equal(got.nnz_for_action(action),
                                      want.nnz_for_action(action))


def test_load_mb_matches_jax(data_root):
    """The nested lights/exposures, per-image GT, meta, nnz tables and
    submission names equal."""
    got = datasets.load_dataset(config.make_config("mb", "fast",
                                                   data_dir=data_root))
    want = jdatasets.load_dataset(jconfig.make_config("mb", "fast",
                                                      data_dir=data_root))
    assert [len(x) for x in got.X] == [len(x) for x in want.X] == [3, 3, 3]
    _same_dataset(got, want)


def test_subset_nnz_matches_jax(data_root):
    ds = datasets.load_kitti(config.make_config("kitti", "fast", at=1,
                                                data_dir=data_root))
    for ids in ([1], [2, 3], [1, 5, 6], []):
        got = datasets.subset_nnz(ds.nnz_tr, np.asarray(ids))
        np.testing.assert_array_equal(got, jdatasets.subset_nnz(
            ds.nnz_tr, np.asarray(ids)))
        assert set(np.unique(got[:, 0]).astype(int)) <= set(ids)


@pytest.mark.parametrize("device_gather", [False, True])
@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_sampler_kitti_matches_jax(data_root, arch, device_gather):
    """One ``RandomState`` seed, the same rows: windows (or their
    origins), inverse affines, photometrics and labels equal bit for
    bit, twice in a row (the stream stays in step)."""
    cfg = config.make_config("kitti", arch, data_dir=data_root)
    jcfg = jconfig.make_config("kitti", arch, data_dir=data_root)
    ds = datasets.load_kitti(cfg)
    X0, X1 = np.asarray(ds.X0), np.asarray(ds.X1)
    got = augment.AugmentSampler(cfg, np.random.RandomState(11))
    want = jaugment.AugmentSampler(jcfg, np.random.RandomState(11))
    for rows in (ds.nnz_tr[:24], ds.nnz_tr[24:40]):
        a = got.build_batches(X0, X1, rows, device_gather=device_gather)
        b = want.build_batches(X0, X1, rows, device_gather=device_gather)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["minv"].shape == (64, 6)
    np.testing.assert_array_equal(a["labels"], np.tile([0.0, 1.0], 16))


def test_sampler_mb_matches_jax(data_root):
    """The Middlebury sampler's light/exposure draws and host gathers
    equal bit for bit, also with every light perturbed (d_exp = d_light
    = 1)."""
    for over in ({}, dict(d_exp=1.0, d_light=1.0)):
        cfg = config.make_config("mb", "fast", data_dir=data_root, **over)
        jcfg = jconfig.make_config("mb", "fast", data_dir=data_root, **over)
        ds = datasets.load_mb(cfg)
        a = augment.AugmentSampler(cfg, np.random.RandomState(4)) \
            .build_batches_mb(ds.X, ds.nnz_tr[:20])
        b = jaugment.AugmentSampler(jcfg, np.random.RandomState(4)) \
            .build_batches_mb(ds.X, ds.nnz_tr[:20])
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["windows"].shape == (80, augment.WIN, augment.WIN)


def test_host_gather_matches_jax():
    """The port's numpy window gather against the JAX package's (its
    native kernel where built, else the same numpy), zero fill outside
    the frame included, at origins from -WIN to the frame's far edge,
    the range the sampler draws (a window's centre lies in the frame or
    at most a disparity range left of it)."""
    rng = np.random.RandomState(3)
    X = rng.randn(3, 1, 40, 50).astype(np.float32)
    img = rng.randint(0, 3, 17)
    oy = rng.randint(-augment.WIN, 40, 17)
    ox = rng.randint(-augment.WIN, 50, 17)
    got = augment._gather_windows(X, img, oy, ox)
    np.testing.assert_array_equal(got, jaugment._gather_windows(
        X, img.astype(np.int64), oy.astype(np.int64), ox.astype(np.int64)))
    assert got.shape == (17, augment.WIN, augment.WIN)


@pytest.mark.parametrize("tail", [[], ["-a", "train_tr"],
                                  ["-lr", "0.01", "-bs", "64", "-debug"]])
def test_cmd_str_matches_jax(tail):
    got = config.cmd_str(*config.parse_args(["kitti", "fast"] + tail))
    want = jconfig.cmd_str(*jconfig.parse_args(["kitti", "fast"] + tail))
    assert got == want == "_".join(["kitti", "fast"] + tail)
