"""The port's cost-volume join (plain version, on the CPU) against the
JAX package's Pallas join run in interpret mode, and the disparity-major
oracle forms against ``ops/costs.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import costs as jcosts
from mccnn_tpu.ops.join_pallas import stereo_join_mxu_hwd
from mccnn_tpu_torch.ops import costs, join


def _feats(seed, H=20, W=140, C=8):
    rng = np.random.RandomState(seed)
    fl = rng.randn(H, W, C).astype(np.float32)
    fr = rng.randn(H, W, C).astype(np.float32)
    fl /= np.linalg.norm(fl, axis=-1, keepdims=True)
    fr /= np.linalg.norm(fr, axis=-1, keepdims=True)
    return fl, fr


@pytest.mark.parametrize("sides", ["both", "left"])
def test_join_hwd_matches_pallas(sides):
    """Full padded buffers, 20x140, C=8, D=20, n_fix=4. The JAX kernel's
    dot is a bf16x3 split (about 1e-7 relative), the port's an f32 sum:
    NaN masks identical, values within 5e-5."""
    fl, fr = _feats(1)
    D = 20
    want = stereo_join_mxu_hwd(jnp.asarray(fl), jnp.asarray(fr), D, n_fix=4,
                               interpret=True, sides=sides)
    got = join.stereo_join_hwd(torch.as_tensor(fl), torch.as_tensor(fr), D,
                               n_fix=4, sides=sides)
    if sides == "left":
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (64, 256, 128)
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.nanmax(np.abs(g - w)) <= 5e-5


def test_join_hwd_unpacks_to_disparity_major():
    """The HWD buffers, unpacked (left x-reversed), are the
    disparity-major volumes of ``stereo_join`` + ``fix_border``."""
    fl, fr = _feats(2, H=9, W=50, C=4)
    H, W, D, n = 9, 50, 13, 4
    vl_x, vr = join.stereo_join_hwd(torch.as_tensor(fl), torch.as_tensor(fr),
                                    D, n_fix=n)
    want_l, want_r = jcosts.stereo_join(jnp.asarray(fl), jnp.asarray(fr), D)
    want_l = np.asarray(jcosts.fix_border(want_l, -1, n))
    want_r = np.asarray(jcosts.fix_border(want_r, 1, n))
    got_l = vl_x[:H, :W, :D].flip(1).permute(2, 0, 1).numpy()
    got_r = vr[:H, :W, :D].permute(2, 0, 1).numpy()
    for g, w in ((got_l, want_l), (got_r, want_r)):
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.nanmax(np.abs(g - w)) <= 1e-6


def test_stereo_join_and_fix_border_match_jax():
    fl, fr = _feats(3, H=7, W=30, C=5)
    D = 9
    got = costs.stereo_join(torch.as_tensor(fl), torch.as_tensor(fr), D)
    want = jcosts.stereo_join(jnp.asarray(fl), jnp.asarray(fr), D)
    for g, w, direction in zip(got, want, (-1, 1)):
        g = costs.fix_border(g, direction, 3).numpy()
        w = np.asarray(jcosts.fix_border(w, direction, 3))
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.nanmax(np.abs(g - w)) <= 1e-6


def test_wta_forms_match_jax():
    """NaN never wins, ties go to the lowest disparity, all-NaN gives 0."""
    rng = np.random.RandomState(4)
    vol = rng.randint(0, 4, size=(6, 5, 7)).astype(np.float32)
    vol[rng.rand(*vol.shape) < 0.3] = np.nan
    vol[:, 0, 0] = np.nan
    got = costs.wta(torch.as_tensor(vol)).numpy()
    assert np.array_equal(got, np.asarray(jcosts.wta(jnp.asarray(vol))))
    hwd = np.ascontiguousarray(np.moveaxis(vol, 0, -1))
    got = costs.wta_hwd(torch.as_tensor(hwd)).numpy()
    assert np.array_equal(got, np.asarray(jcosts.wta_hwd(jnp.asarray(hwd))))
