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


def _operands(seed, H, W, C, D):
    """The kernel's operands of the right side: (Hp, C, Wp) and
    (Hp, C, Wp + Dp) from L2-normalized random maps."""
    fl, fr = _feats(seed, H=H, W=W, C=C)
    Hp, Wp, Dp = join.pad_dims(H, W, D)
    return (join._prep(torch.as_tensor(fr), False, Hp, Wp),
            join._prep(torch.as_tensor(fl), False, Hp, Wp + Dp))


@pytest.mark.parametrize("levels", [3, 2])
@pytest.mark.parametrize("H,W,C,D", [(9, 200, 64, 64), (13, 150, 16, 48),
                                     (5, 300, 32, 40), (20, 140, 8, 20),
                                     (7, 300, 112, 100)])
def test_split_emulation_matches_f32_plain(H, W, C, D, levels):
    """The bf16 split arithmetic against the float32 sum. bf16 keeps 8
    significant bits, so each split term is within 2^-8 of what the
    terms before it leave. The CUDA kernel's three levels (six products)
    leave about 4 * 2^-24 sum |a||b|, the size of the float32 rounding:
    within 2e-6 at every C. The TPU kernel's two levels (three
    products) leave up to about 3 * 2^-16 sum |a||b| per cell (with
    L2-normalized maps sum |a||b| <= 1): inside that bound, and within
    1e-5 here. NaN masks equal, winner maps equal on >= 0.999 of the
    pixels. W is not a multiple of 128; C from 8 to 112."""
    a, b = _operands(H + C, H, W, C, D)
    want = join.join_plus_plain(a, b, D, W, H, 4)
    got = join.join_plus_split_plain(a, b, D, W, H, 4, levels=levels)
    assert torch.equal(got.isnan(), want.isnan())
    diff = (got - want).nan_to_num().abs()
    if levels == 3:
        assert float(diff.max()) <= 2e-6
    else:
        size = -join.join_plus_plain(a.abs(), b.abs(), D, W, H,
                                     4).nan_to_num()
        assert bool((diff <= 3 * 2.0 ** -16 * size + 1e-7).all())
        assert float(diff.max()) <= 1e-5
    same = (costs.wta_hwd(got)[:H, :W] == costs.wta_hwd(want)[:H, :W])
    assert float(same.float().mean()) >= 0.999


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("sides", ["both", "left"])
def test_split_emulation_matches_pallas(sides, levels):
    """The emulation against the JAX kernel, run in interpret mode, at
    C = 8. With the TPU kernel's two levels: the same split and the same
    bf16 products, summed in other orders: within 2e-6. With the CUDA
    kernel's three: as close to the float32 sum as the rounding, so off
    the JAX kernel by its own split error, up to 3 * 2^-16 sum |a||b|
    (plus 1e-6). NaN masks equal."""
    fl, fr = _feats(1)
    H, W, D = 20, 140, 20
    Hp, Wp, Dp = join.pad_dims(H, W, D)
    want = stereo_join_mxu_hwd(jnp.asarray(fl), jnp.asarray(fr), D, n_fix=4,
                               interpret=True, sides=sides)
    want = (want,) if sides == "left" else want
    pairs = ((fl, fr, True), (fr, fl, False))[:len(want)]
    for (f0, f1, flip), w in zip(pairs, want):
        a = join._prep(torch.as_tensor(f0), flip, Hp, Wp)
        b = join._prep(torch.as_tensor(f1), flip, Hp, Wp + Dp)
        got = join.join_plus_split_plain(a, b, D, W, H, 4, levels=levels)
        w = torch.as_tensor(np.array(w))
        assert torch.equal(got.isnan(), w.isnan())
        diff = (got - w).nan_to_num().abs()
        if levels == 2:
            assert float(diff.max()) <= 2e-6
        else:
            size = -join.join_plus_plain(a.abs(), b.abs(), D, W, H,
                                         4).nan_to_num()
            assert bool((diff <= 3 * 2.0 ** -16 * size + 1e-6).all())


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
