"""The port's data-parallel train step (``mccnn_tpu_torch.parallel.
data_parallel``, plain torch on the CPU) against the JAX package's
``make_dp_train_step`` on the conftest's virtual CPU devices: the same
sampler batch and the same seeded init (``models/prng.py``) on meshes of
1, 2 and 4 entries, fast and slow at narrow widths; and against the
port's own ``train_chunk``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu import config as jconfig
from mccnn_tpu.cli import init_params
from mccnn_tpu.data import datasets as jdatasets
from mccnn_tpu.parallel import data_parallel as jdp
from mccnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from mccnn_tpu.parallel.mesh import replicated as jreplicated
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.data import datasets
from mccnn_tpu_torch.models import towers
from mccnn_tpu_torch.parallel import data_parallel as dp
from mccnn_tpu_torch.parallel.mesh import make_mesh, replicated
from mccnn_tpu_torch.train import augment, trainer

NARROW = dict(bs=16, l1=2, fm=16)
SLOW_NARROW = dict(bs=16, l1=2, fm=16, l2=2, nh2=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread: many small ops, and with a test worker on
    every core the intra-op threads of each worker contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    jdatasets.make_synthetic_kitti(str(root / "data.kitti"), n_images=3,
                                   height=48, width=96, disp_max=12)
    return str(root)


def _cfgs(root, arch):
    kw = dict(SLOW_NARROW if arch == "slow" else NARROW, a="train_tr",
              data_dir=root)
    return make_config("kitti", arch, **kw), jconfig.make_config("kitti",
                                                                 arch, **kw)


def _batch(cfg, seed=0):
    """One minibatch of ``bs / 2`` examples from the sampler, as numpy."""
    ds = datasets.load_kitti(cfg)
    X0 = np.asarray(ds.X0[:, 0])[:, None]
    X1 = np.asarray(ds.X1[:, 0])[:, None]
    sampler = augment.AugmentSampler(cfg, np.random.RandomState(seed))
    return sampler.build_batches(X0, X1, ds.nnz_tr[:cfg.bs // 2])


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch", ["fast", "slow"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_dp_step_matches_jax(kitti_root, arch, n):
    """One step on n entries against the JAX step on n virtual devices:
    the loss within 1e-6 relative, every parameter and momentum leaf
    within 1e-5 relative (the gradient is a mean of the shards' means
    here, one sum over the batch there); the replicas equal."""
    cfg, jcfg = _cfgs(kitti_root, arch)
    b = _batch(cfg)
    jmesh = jmake_mesh(n, backend="cpu")
    tree = init_params(jcfg)
    jparams = jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree),
                             jreplicated(jmesh))
    jmom = jax.device_put(jax.tree_util.tree_map(jnp.zeros_like, tree),
                          jreplicated(jmesh))
    jp, jm, jerr = jdp.make_dp_train_step(jcfg, jmesh)(
        jparams, jmom, jnp.float32(cfg.lr), jdp.shard_batch(b, jmesh))

    mesh = make_mesh(n, backend="cpu")
    nets = replicated(towers.init_net(cfg), mesh)
    mom = [torch.zeros_like(p) for p in nets[0].parameters()]
    err = dp.make_dp_train_step(cfg, mesh)(nets, mom, cfg.lr,
                                           dp.shard_batch(b, mesh))
    assert err.dim() == 0
    assert abs(float(err) - float(jerr)) <= 1e-6 * abs(float(jerr))
    leaves = jax.tree_util.tree_leaves
    got = towers.params_to_numpy(nets[0])
    for a, w in zip(leaves(got), leaves(jax.tree_util.tree_map(np.asarray,
                                                               jp))):
        assert _rel(a, w) <= 1e-5
    got_m = towers.params_to_numpy(nets[0], mom)
    for a, w in zip(leaves(got_m), leaves(jax.tree_util.tree_map(np.asarray,
                                                                 jm))):
        assert np.abs(w).max() > 0 and _rel(a, w) <= 1e-5
    for net in nets[1:]:
        assert all(torch.equal(p, q) for p, q in zip(net.parameters(),
                                                     nets[0].parameters()))


@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_one_entry_step_is_train_chunk(kitti_root, arch):
    """On one entry the step is ``train_chunk``'s step bit for bit (the
    mean of one shard's gradient is that gradient); on [cpu, cpu] the
    replicas, updated once, stay equal."""
    cfg, _ = _cfgs(kitti_root, arch)
    b = _batch(cfg, seed=3)
    net = towers.init_net(cfg)
    mom = [torch.zeros_like(p) for p in net.parameters()]
    chunk = {k: torch.as_tensor(v)[None] for k, v in b.items()}
    want = trainer.train_chunk(cfg, net, mom, cfg.lr, chunk)[0]

    mesh = make_mesh(1, backend="cpu")
    nets = replicated(towers.init_net(cfg), mesh)
    mom1 = [torch.zeros_like(p) for p in nets[0].parameters()]
    err = dp.make_dp_train_step(cfg, mesh)(nets, mom1, cfg.lr,
                                           dp.shard_batch(b, mesh))
    assert torch.equal(err, want)
    assert all(torch.equal(p, q) for p, q in zip(nets[0].parameters(),
                                                 net.parameters()))
    assert all(torch.equal(v, w) for v, w in zip(mom1, mom))


def test_shard_batch_keeps_examples_whole(kitti_root):
    """Each shard holds whole examples, its four patches (L, R+, L, R-)
    and two labels together; a split that would cut one raises."""
    cfg, _ = _cfgs(kitti_root, "fast")
    b = _batch(cfg)  # 8 examples: 32 patches, 16 labels
    shards = dp.shard_batch(b, make_mesh(4, backend="cpu"))
    assert [len(s["windows"]) for s in shards] == [8] * 4
    assert [len(s["labels"]) for s in shards] == [4] * 4
    np.testing.assert_array_equal(shards[1]["minv"].numpy(), b["minv"][8:16])
    for n in (3, 16):  # 8 examples in 3; 32 patches in 16 (2 a shard)
        with pytest.raises(ValueError, match="whole examples"):
            dp.shard_batch(b, make_mesh(n, backend="cpu"))
