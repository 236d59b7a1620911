"""The port's matching costs (plain torch, on the CPU) against
``mccnn_tpu.ops.costs``: absolute difference, census, and the disparity-major join on the join kernel's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import costs as jcosts
from mccnn_tpu.ops.join_pallas import stereo_join_mxu
from mccnn_tpu_torch.ops import costs, join

H, W, D = 14, 45, 21


def _images(seed, shape=(H, W)):
    """Two images with repeated values, so that the census comparison
    ``<`` meets ties."""
    rng = np.random.RandomState(seed)
    x0 = np.round(rng.randn(*shape) * 4).astype(np.float32) / 4
    x1 = np.round(rng.randn(*shape) * 4).astype(np.float32) / 4
    return x0, x1


@pytest.mark.parametrize("direction", [-1, 1])
def test_ad_volume_matches_jax(direction):
    """Box sums of 81 terms taken in another order than XLA's
    reduce_window: max |d| <= 1e-6 on costs of order 1; NaN masks
    equal. D exceeds the chunk of disparities."""
    x0, x1 = _images(3)
    got = costs.ad_volume(torch.as_tensor(x0), torch.as_tensor(x1), D,
                          direction).numpy()
    want = np.asarray(jcosts.ad_volume(jnp.asarray(x0), jnp.asarray(x1), D,
                                       direction))
    assert got.shape == want.shape == (D, H, W)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() and np.nanmax(np.abs(got - want)) <= 1e-6


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("shape", [(H, W), (3, H, W)], ids=["gray", "rgb"])
def test_census_volume_equals_jax(shape, direction):
    """Hamming distances are small integers (thirds of integers for
    three channels): the volumes are equal, NaN masks included."""
    x0, x1 = _images(5, shape)
    got = costs.census_volume(torch.as_tensor(x0), torch.as_tensor(x1), D,
                              direction).numpy()
    want = np.asarray(jcosts.census_volume(jnp.asarray(x0), jnp.asarray(x1), D,
                                           direction))
    assert got.shape == want.shape == (D, H, W)
    assert np.isnan(got).any()
    np.testing.assert_array_equal(got, want)


def test_census_radius_and_small_frames():
    """A 5x5 window (25 bits, one word) and a frame smaller than the
    window, where ``roll`` wraps onto the pixel itself."""
    x0, x1 = _images(7, (3, 6))
    for radius in (2, 4):
        got = costs.census_volume(torch.as_tensor(x0), torch.as_tensor(x1), 4,
                                  -1, radius).numpy()
        want = np.asarray(jcosts.census_volume(jnp.asarray(x0), jnp.asarray(x1),
                                               4, -1, radius))
        np.testing.assert_array_equal(got, want)


def test_popcount_counts_bits():
    rng = np.random.RandomState(11)
    vals = [0, 1, (1 << 41) - 1, (1 << 62) | 5] + [
        int(v) for v in rng.randint(0, 2 ** 62, size=200, dtype=np.int64)]
    got = costs._popcount(torch.tensor(vals, dtype=torch.int64)).tolist()
    assert got == [bin(v).count("1") for v in vals]


def _feats(seed, h, w, c):
    rng = np.random.RandomState(seed)
    f = rng.randn(2, h, w, c).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def test_stereo_join_dhw_matches_jax_join():
    """Against the einsum join, ``costs.stereo_join``: dots of 16 terms
    summed in another order, max |d| <= 1e-5; NaN masks equal."""
    fl, fr = _feats(17, 9, 50, 16)
    got = join.stereo_join_dhw(torch.as_tensor(fl), torch.as_tensor(fr), 20)
    want = jcosts.stereo_join(jnp.asarray(fl), jnp.asarray(fr), 20)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (20, 9, 50)
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.nanmax(np.abs(g - w)) <= 1e-5


def test_stereo_join_dhw_matches_jax_mxu_join():
    """Against ``stereo_join_mxu``, its Pallas kernel in interpret mode:
    max |d| <= 1e-5; NaN masks equal; and the port's own disparity-major
    oracle gives the same."""
    fl, fr = _feats(19, 7, 140, 8)
    tl, tr = torch.as_tensor(fl), torch.as_tensor(fr)
    got = join.stereo_join_dhw(tl, tr, 33)
    want = stereo_join_mxu(jnp.asarray(fl), jnp.asarray(fr), 33, interpret=True)
    for g, w, o in zip(got, want, costs.stereo_join(tl, tr, 33)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (33, 7, 140) and g.flags["C_CONTIGUOUS"]
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.nanmax(np.abs(g - w)) <= 1e-5
        assert np.nanmax(np.abs(g - o.numpy())) <= 1e-5
