"""The port's CBCA (plain torch, on the CPU) against the JAX package's
``ops/cross.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import cross as jcross
from mccnn_tpu_torch.ops import cross


def _img(seed, H=23, W=57):
    # standardized-looking texture with flat patches, so arms of every
    # length occur
    rng = np.random.RandomState(seed)
    x = rng.randn(H, W).astype(np.float32) * 0.1
    x[5:12, 10:30] = 0.3
    return x


@pytest.mark.parametrize("L1,tau1", [(5, 0.13), (14, 0.02), (1, 0.2)])
def test_cross_arms_exact(L1, tau1):
    x = _img(L1)
    got = cross.cross_arms(torch.as_tensor(x), L1, tau1).numpy()
    want = np.asarray(jcross.cross_arms(jnp.asarray(x), L1, tau1))
    assert got.dtype == np.float32 and got.shape == (4, 23, 57)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("direction", [-1, 1])
def test_cbca_matches_jax_with_nan_cells(direction):
    """kitti slow's L1=5, tau1=0.13 on a volume with NaN out-of-frame
    cells (the slow volumes' masks) and scattered NaN inside. The same
    masked adds in the same order: rtol 1e-6 for the division's
    rounding; identical NaN masks (out-of-frame cells pass through).
    Chunked over d (4 per chunk) and in one piece, both equal."""
    rng = np.random.RandomState(3 + direction)
    D, H, W = 9, 23, 57
    x0, x1 = _img(1), _img(2)
    vol = rng.rand(D, H, W).astype(np.float32)
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    oof = (xs + ds * direction < 0) | (xs + ds * direction >= W)
    vol[np.broadcast_to(oof, vol.shape)] = np.nan
    vol[rng.rand(D, H, W) < 0.05] = np.nan
    j0, j1 = (jcross.cross_arms(jnp.asarray(a), 5, 0.13) for a in (x0, x1))
    want = np.asarray(jcross.cbca(j0, j1, jnp.asarray(vol), direction, 5))
    t0, t1 = (cross.cross_arms(torch.as_tensor(a), 5, 0.13) for a in (x0, x1))
    got = cross.cbca(t0, t1, torch.as_tensor(vol), direction, 5).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[np.broadcast_to(oof, got.shape)]).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    chunked = cross.cbca(t0, t1, torch.as_tensor(vol), direction, 5,
                         chunk_cells=4 * H * W).numpy()
    assert np.array_equal(chunked, got, equal_nan=True)
