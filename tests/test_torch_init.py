"""The port's seeded init against the JAX package's, bit for bit: the
numpy Threefry-2x32 of ``models/prng.py`` against ``jax.random``, and
``init_net`` against ``mccnn_tpu.cli.init_params`` at the full widths of
every learned (dataset, arch) of ``config.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu import cli as jcli
from mccnn_tpu.config import make_config as jmake_config
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.models import prng, towers

SEEDS = (0, 42, 2**31 - 1)
LEARNED = [(ds, arch) for ds in ("kitti", "kitti2015", "mb")
           for arch in ("fast", "slow")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread: with a test worker on every core, intra-op
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS + (-1, 2**32 + 3))
def test_key_and_split_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.key(seed), np.asarray(k))
    for num in (1, 2, 5, 8):
        np.testing.assert_array_equal(prng.split(prng.key(seed), num),
                                      np.asarray(jax.random.split(k, num)))


@pytest.mark.parametrize("shape", [(1,), (7,), (4, 5), (3, 3, 1, 64)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_match_jax(seed, shape):
    k = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    kk = prng.split(prng.key(seed), 3)[2]
    np.testing.assert_array_equal(
        prng.random_bits(kk, shape),
        np.asarray(jax.random.bits(k, shape, jnp.uint32)))
    s = jnp.float32(1.0) / jnp.sqrt(9 * 64)
    want = jax.random.uniform(k, shape, jnp.float32, -s, s)
    got = prng.uniform(kk, shape, -np.float32(s), np.float32(s))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dataset,arch", LEARNED)
def test_init_net_is_the_jax_init_bit_for_bit(dataset, arch, seed):
    """Full widths: every weight and bias of ``init_net(cfg)`` equals the
    converted ``init_params(cfg)`` in every bit."""
    net = towers.init_net(make_config(dataset, arch, seed=seed))
    tree = jcli.init_params(jmake_config(dataset, arch, seed=seed))
    want = towers.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))
    assert type(net) is type(want)
    got_sd, want_sd = net.state_dict(), want.state_dict()
    assert list(got_sd) == list(want_sd)
    for name in got_sd:
        assert got_sd[name].shape == want_sd[name].shape, name
        np.testing.assert_array_equal(_bits(got_sd[name].numpy()),
                                      _bits(want_sd[name].numpy()),
                                      err_msg=name)


def test_kitti_fast_seed_42_first_weights():
    """The numbers chip_smoke.py prints in phase 9: the first conv's
    weight[:3, 0, 0, 0] (OIHW) of the default kitti fast net."""
    w = towers.init_net(make_config("kitti", "fast")).convs[0].weight
    np.testing.assert_array_equal(
        w[:3, 0, 0, 0].detach().numpy(),
        np.array([-0.1761167, 0.293127, -0.20261869], np.float32))
