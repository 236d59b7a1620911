"""The port's volume cache (``-make_cache`` / ``-use_cache``,
``pipeline.compute_volumes``) against the JAX package's
(mccnn_tpu/pipeline.py:417-444): files written by either package are
read by the other, a cached run equals an uncached one bit for bit, the
cache sends the fast arch to the generic lane, and the evaluation keys
the files by the image id. Narrow nets, on the CPU, each test in its own
working directory."""

import os

import jax
import numpy as np
import pytest
import torch

from mccnn_tpu import cli as jcli, pipeline as jpipe
from mccnn_tpu.config import make_config as jmake_config
from mccnn_tpu.data import datasets as jdatasets
from mccnn_tpu.train import evaluate as jevaluate
from mccnn_tpu_torch import pipeline
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.data import datasets
from mccnn_tpu_torch.models import towers
from mccnn_tpu_torch.train import evaluate

SLOW = dict(l1=2, fm=8, l2=2, nh2=16)
FAST = dict(l1=2, fm=8)
H, W, D = 20, 64, 12


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    """Torch on one thread, and the working directory a fresh one: the
    cache lives under ``cache/`` there."""
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=3):
    base = np.random.RandomState(seed).randn(H, W + D).astype(np.float32)
    return base[:, D:], base[:, :-D]


def _nets(arch, seed=1):
    over = SLOW if arch == "slow" else FAST
    tree = jcli.init_params(jmake_config("kitti", arch, **over), seed=seed)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return tree, towers.params_from_numpy(tree)


def _cfgs(arch, **flags):
    over = SLOW if arch == "slow" else FAST
    return (make_config("kitti", arch, a="test_te", **over, **flags),
            jmake_config("kitti", arch, a="test_te", **over, **flags))


def _forbid(monkeypatch, module, name):
    def boom(*a, **kw):
        raise AssertionError(f"{name} ran under -use_cache")
    monkeypatch.setattr(module, name, boom)


def _bits(a: np.ndarray) -> np.ndarray:
    """The float32 cells as integers: NaN cells compare too."""
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _read(pair_id):
    with np.load(os.path.join("cache", f"{pair_id}.npz")) as z:
        return {-1: z["vol_m1"], 1: z["vol_p1"]}


def test_jax_cache_is_read_by_the_port(monkeypatch):
    tree, net = _nets("slow")
    x0, x1 = _pair()
    _, jmake = _cfgs("slow", make_cache=True)
    jpipe.compute_volumes(jmake, tree, x0, x1, D, pair_id=7)
    want = _read(7)
    assert want[-1].dtype == np.float32 and want[-1].shape == (D, H, W)
    use, _ = _cfgs("slow", use_cache=True)
    _forbid(monkeypatch, pipeline, "_volumes")
    got = pipeline.compute_volumes(use, net, x0, x1, D, pair_id=7,
                                   device="cpu")
    for k in (-1, 1):
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(want[k]))


def test_port_cache_is_read_by_jax(monkeypatch):
    tree, net = _nets("slow")
    x0, x1 = _pair()
    make, _ = _cfgs("slow", make_cache=True)
    vols = pipeline.compute_volumes(make, net, x0, x1, D, pair_id="5_2",
                                    device="cpu")
    _, juse = _cfgs("slow", use_cache=True)
    _forbid(monkeypatch, jpipe, "_volumes_jit")
    got = jpipe.compute_volumes(juse, tree, x0, x1, D, pair_id="5_2")
    for k in (-1, 1):
        a = np.asarray(got[k])
        assert a.dtype == np.float32
        np.testing.assert_array_equal(_bits(a), _bits(vols[k].numpy()))


@pytest.mark.parametrize("arch", ["slow", "fast"])
def test_cached_run_equals_uncached_bit_for_bit(monkeypatch, arch):
    """The uncached map (a cache flag without a pair id: nothing read or
    written), the cache-making run and the cached run: equal in every
    bit, and the cached run runs no network."""
    _, net = _nets(arch)
    x0, x1 = _pair()
    plain, _ = _cfgs(arch, make_cache=True)
    make, _ = _cfgs(arch, make_cache=True)
    use, _ = _cfgs(arch, use_cache=True)
    d0 = pipeline.stereo_predict(plain, net, x0, x1, D, device="cpu")
    assert not os.path.exists("cache")
    d1 = pipeline.stereo_predict(make, net, x0, x1, D, device="cpu",
                                 pair_id=11)
    assert os.path.exists(os.path.join("cache", "11.npz"))
    _forbid(monkeypatch, pipeline, "_volumes")
    d2 = pipeline.stereo_predict(use, net, x0, x1, D, device="cpu",
                                 pair_id=11)
    assert torch.equal(d0, d1) and torch.equal(d1, d2)


def test_fast_with_the_cache_takes_the_generic_lane(monkeypatch):
    """kitti fast under -use_cache: the HWD lane is off (as in the JAX
    package's ``_hwd_eligible``), and the map is the JAX package's
    (its CPU lane is the generic one) within the budget of
    tests/test_torch_pipeline.py."""
    tree, net = _nets("fast")
    x0, x1 = _pair()
    use, juse = _cfgs("fast", use_cache=True)
    _forbid(monkeypatch, pipeline, "_fast_hwd")
    got = pipeline.stereo_predict(use, net, x0, x1, D, device="cpu",
                                  pair_id=3).numpy()
    assert not os.path.exists(os.path.join("cache", "3.npz"))
    want = np.asarray(jpipe.stereo_predict(juse, tree, x0, x1, D,
                                           pair_id=3))
    assert got.shape == (H, W) and np.isfinite(got).all()
    assert float((np.abs(got - want) > 0.51).mean()) < 0.01


@pytest.mark.parametrize("flag", ["use_cache", "make_cache"])
def test_16_bit_volumes_with_the_cache_raise(flag):
    _, net = _nets("fast")
    x0, x1 = _pair()
    cfg = make_config("kitti", "fast", a="test_te", vol_dtype="bfloat16",
                      **FAST, **{flag: True})
    with pytest.raises(ValueError, match="vol_dtype"):
        pipeline.stereo_predict(cfg, net, x0, x1, D, device="cpu",
                                pair_id=1)


def test_bucketed_predict_keys_the_file_by_the_image_id(tmp_path, capsys):
    """``test_te -make_cache`` on a synthetic KITTI set writes one file
    an evaluated image, named by its id, in both packages alike; then
    ``-use_cache`` scores the same without the network, and an mb pair
    padded to its buckets keeps its padded volumes under its
    ``<i>_<right>`` id."""
    data = tmp_path / "data"
    jdatasets.make_synthetic_kitti(str(data / "data.kitti"), n_images=3,
                                   height=24, width=64, disp_max=D)
    tree, net = _nets("slow")
    make, jmake = _cfgs("slow", make_cache=True, data_dir=str(data))
    ds, jds = datasets.load_kitti(make), jdatasets.load_kitti(jmake)
    ds.disp_max = jds.disp_max = D
    ids = sorted(f"{int(ds.metadata[int(i) - 1][2])}.npz" for i in ds.te)
    os.chdir(tmp_path / "data")
    jevaluate.action_eval(jmake, [], params=tree, ds=jds)
    jax_files = sorted(os.listdir("cache"))
    os.chdir(tmp_path)
    evaluate.action_eval(make, [], net=net, ds=ds, device="cpu")
    made = capsys.readouterr().out.split()[-1]
    assert sorted(os.listdir("cache")) == jax_files == ids
    use, _ = _cfgs("slow", use_cache=True, data_dir=str(data))
    evaluate.action_eval(use, [], net=net, ds=ds, device="cpu")
    assert capsys.readouterr().out.split()[-1] == made

    mb = make_config("mb", "fast", a="test_te", make_cache=True, **FAST)
    _, fnet = _nets("fast")
    x0, x1 = _pair(5)
    evaluate.bucketed_predict(mb, fnet, x0, x1, D, device="cpu",
                              pair_id="2_3")
    assert _read("2_3")[-1].shape == (64, 64, 64)
