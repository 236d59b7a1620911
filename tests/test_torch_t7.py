"""The port's ``.t7`` interop (``data/t7.py``, ``models/import_t7.py``)
against the JAX package's: the JAX package's own t7 cases repeated on
the port, files dumped by either package loaded by the other with equal
weights, byte-equal dumps of one net, and ``-net_fname x.t7`` through
``cli.load_params`` to the map the JAX CLI flow gives."""

import os

import jax
import numpy as np
import pytest
import torch

from mccnn_tpu import cli as jcli, pipeline as jpipe
from mccnn_tpu.config import make_config as jmake_config
from mccnn_tpu.models import import_t7 as jimport_t7, towers as jtowers
from mccnn_tpu_torch import cli, pipeline
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.data.t7 import (T7Object, Tensor, dump_t7_ascii,
                                     load_t7_ascii)
from mccnn_tpu_torch.models import towers
from mccnn_tpu_torch.models.import_t7 import params_from_t7, params_to_t7

NARROW_SLOW = dict(l1=2, fm=6, ks=3, l2=2, nh2=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread: with a test worker on every core, intra-op
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _roundtrip(obj, tmp_path):
    p = str(tmp_path / "x.t7")
    dump_t7_ascii(obj, p)
    return load_t7_ascii(p)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fast_tree(seed=0):
    return _np(jtowers.init_fast(jax.random.PRNGKey(seed), l1=3, fm=8, ks=3))


def _slow_tree(seed=1):
    return _np(jtowers.init_slow(jax.random.PRNGKey(seed), **NARROW_SLOW))


def _assert_same_weights(net, tree):
    want = towers.params_from_numpy(tree)
    assert type(net) is type(want)
    for (name, a), b in zip(net.state_dict().items(),
                            want.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=0,
                                   err_msg=name)


# --- the JAX package's tests/test_t7.py cases, on the port ---------------

def test_primitives_roundtrip(tmp_path):
    obj = {1: 3.5, 2: "a string with spaces", 3: True, 4: None,
           5: {"nested": {1: 1.0, 2: 2.0}}, "k": -1e-7}
    got = _roundtrip(obj, tmp_path)
    assert got[1] == 3.5
    assert got[2] == "a string with spaces"
    assert got[3] is True
    assert got[4] is None
    assert got[5]["nested"] == {1: 1.0, 2: 2.0}
    assert got["k"] == -1e-7


def test_shared_table_reference(tmp_path):
    shared = {"v": 7.0}
    got = _roundtrip({1: shared, 2: shared}, tmp_path)
    assert got[1] is got[2]
    assert got[1]["v"] == 7.0


@pytest.mark.parametrize("cls,dtype", [("torch.FloatTensor", np.float32),
                                       ("torch.CudaTensor", np.float32),
                                       ("torch.DoubleTensor", np.float64)])
def test_tensor_roundtrip_dtypes(tmp_path, cls, dtype):
    a = np.random.RandomState(0).randn(3, 4, 2).astype(dtype)
    got = _roundtrip(Tensor(a, cls), tmp_path)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, a)


def test_classed_object_roundtrip(tmp_path):
    m = T7Object("cudnn.SpatialConvolution",
                 {"weight": Tensor(np.ones((2, 1, 3, 3), np.float32)),
                  "nInputPlane": 1.0})
    got = _roundtrip(m, tmp_path)
    assert got.torch_typename == "cudnn.SpatialConvolution"
    assert got["nInputPlane"] == 1.0
    np.testing.assert_array_equal(got["weight"], np.ones((2, 1, 3, 3)))


def test_noncontiguous_tensor_read(tmp_path):
    """A 2x3 storage view at offset 2 (1-based 3), strides (6, 2)."""
    base = np.arange(24, dtype=np.float32)
    raw = ["4\n1\n", "3\nV 1\n", "17\ntorch.FloatTensor\n",
           "2\n2 3\n6 2\n3\n", "4\n2\n", "3\nV 1\n18\ntorch.FloatStorage\n",
           "24\n" + " ".join(str(float(v)) for v in base) + "\n"]
    p = tmp_path / "x.t7"
    p.write_bytes("".join(raw).encode())
    got = load_t7_ascii(str(p))
    want = np.lib.stride_tricks.as_strided(base[2:], (2, 3), (24, 8))
    np.testing.assert_array_equal(got, want)


def test_fast_checkpoint_roundtrip(tmp_path):
    tree = _fast_tree()
    p = str(tmp_path / "net.t7")
    params_to_t7(towers.params_from_numpy(tree), p, arch="fast",
                 opt={"arch": "fast", "l1": 3.0})
    net, opt = params_from_t7(p)
    assert opt["arch"] == "fast"
    assert isinstance(net, towers.FastTower) and len(net.convs) == 3
    _assert_same_weights(net, tree)
    mods = load_t7_ascii(p)[1]["modules"]
    assert [mods[k].torch_typename for k in sorted(mods)] == [
        "cudnn.SpatialConvolution", "cudnn.ReLU",
        "cudnn.SpatialConvolution", "cudnn.ReLU",
        "cudnn.SpatialConvolution", "nn.Normalize2", "nn.StereoJoin"]


def test_slow_checkpoint_roundtrip_and_forward(tmp_path):
    tree = _slow_tree()
    net = towers.params_from_numpy(tree)
    p = str(tmp_path / "net.t7")
    params_to_t7(net, p, arch="slow")
    got, _ = params_from_t7(p)
    assert isinstance(got, towers.SlowNet)
    assert len(got.convs) == 2 and len(got.head) == 3
    x = torch.as_tensor(np.random.RandomState(2).randn(1, 1, 9, 9)
                        .astype(np.float32))
    d2 = torch.as_tensor(np.random.RandomState(3).randn(5, 12)
                         .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(net(x), got(x))
        assert torch.equal(net.score(d2), got.score(d2))


def test_arch_must_be_the_nets(tmp_path):
    with pytest.raises(TypeError, match="SlowNet"):
        params_to_t7(towers.params_from_numpy(_fast_tree()),
                     str(tmp_path / "x.t7"), arch="slow")


# --- across the packages -------------------------------------------------

@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_files_cross_between_the_packages(tmp_path, arch):
    """A file dumped by either package loads in the other with every
    weight equal (rtol=0)."""
    tree = _fast_tree() if arch == "fast" else _slow_tree()
    p_jax, p_port = str(tmp_path / "jax.t7"), str(tmp_path / "port.t7")
    jimport_t7.params_to_t7(tree, p_jax, arch=arch)
    params_to_t7(towers.params_from_numpy(tree), p_port, arch=arch)
    _assert_same_weights(params_from_t7(p_jax)[0], tree)
    back, _ = jimport_t7.params_from_t7(p_port)
    assert len(back["tower"]) == len(tree["tower"])
    assert len(back["head"]) == len(tree["head"])
    for got, want in zip(back["tower"] + back["head"],
                         tree["tower"] + tree["head"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_dumps_of_one_net_are_byte_equal(tmp_path, arch):
    tree = _fast_tree(3) if arch == "fast" else _slow_tree(4)
    opt = {"arch": arch, "l1": float(len(tree["tower"])), "dataset": "kitti"}
    p_jax, p_port = str(tmp_path / "jax.t7"), str(tmp_path / "port.t7")
    jimport_t7.params_to_t7(tree, p_jax, arch=arch, opt=opt, disp_max=228)
    params_to_t7(towers.params_from_numpy(tree), p_port, arch=arch, opt=opt,
                 disp_max=228)
    with open(p_jax, "rb") as a, open(p_port, "rb") as b:
        assert a.read() == b.read()


def test_cli_load_params_t7_gives_the_jax_cli_map(tmp_path):
    """``-net_fname x.t7`` (a kitti fast net, 24x96, D=16): the port's
    ``cli.load_params`` and ``stereo_predict`` on the CPU (the HWD lane)
    against the JAX package's ``cli.load_params`` and ``stereo_predict``
    (its CPU lane, the generic one): < 1% of pixels off by > 0.51, the
    budget of tests/test_torch_pipeline.py."""
    H, W, D = 24, 96, 16
    p = str(tmp_path / "net.t7")
    net = towers.init_net(make_config("kitti", "fast", seed=5))
    params_to_t7(net, p, arch="fast", disp_max=D)
    cfg = make_config("kitti", "fast", a="predict", net_fname=p)
    jcfg = jmake_config("kitti", "fast", a="predict", net_fname=p)
    rng = np.random.RandomState(17)
    base = rng.randn(H, W + D).astype(np.float32)
    x0, x1 = base[:, D:], base[:, :-D]
    d_t = pipeline.stereo_predict(cfg, cli.load_params(cfg), x0, x1, D,
                                  device="cpu").numpy()
    d_j = np.asarray(jpipe.stereo_predict(jcfg, jcli.load_params(jcfg), x0,
                                          x1, D))
    assert d_t.shape == d_j.shape == (H, W) and np.isfinite(d_t).all()
    assert float((np.abs(d_t - d_j) > 0.51).mean()) < 0.01


def test_cli_load_params_t7_checks_the_arch(tmp_path):
    p = str(tmp_path / "net.t7")
    params_to_t7(towers.params_from_numpy(_slow_tree()), p, arch="slow")
    with pytest.raises(SystemExit, match="not a fast-arch"):
        cli.load_params(make_config("kitti", "fast", a="predict",
                                    net_fname=p))
    net = cli.load_params(make_config("kitti", "slow", a="predict",
                                      net_fname=p, **NARROW_SLOW))
    assert isinstance(net, towers.SlowNet)
    assert os.path.getsize(p) > 0
