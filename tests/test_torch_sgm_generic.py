"""The port's generic-lane SGM and subpixel step (plain versions, on the
CPU) against the JAX package's ``sgm_pair(use_pallas=False)`` (the
``lax.scan`` sweeps) and ``post.subpixel_enhancement``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import post as jpost
from mccnn_tpu.ops import sgm as jsgm
from mccnn_tpu_torch.ops import post, sgm

KW = dict(pi1=1.32, pi2=24.25, tau_so=0.08, alpha1=2.0, sgm_q1=3.0,
          sgm_q2=2.0)


def _case(seed, D=13, H=17, W=45):
    """Two (D, H, W) volumes with the slow volumes' NaN masks, plus
    scattered NaN cells, and small-gradient images so that all three
    penalty classes occur."""
    rng = np.random.RandomState(seed)
    x0 = (rng.rand(H, W) * 0.2).astype(np.float32)
    x1 = (rng.rand(H, W) * 0.2).astype(np.float32)
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    vols = {}
    for direction in (-1, 1):
        v = rng.rand(D, H, W).astype(np.float32)
        oof = (xs + ds * direction < 0) | (xs + ds * direction >= W)
        v[np.broadcast_to(oof, v.shape)] = np.nan
        v[rng.rand(D, H, W) < 0.02] = np.nan
        vols[direction] = v
    return x0, x1, vols


def test_sgm_pair_matches_jax_scan():
    """Both directions stacked in one sweep set, against the JAX scan
    sweeps on each family. The same f32 operations in the same order,
    sums a + b in either order: rtol 1e-5."""
    x0, x1, vols = _case(5)
    want_m, want_p = jsgm.sgm_pair(jnp.asarray(x0), jnp.asarray(x1),
                                   jnp.asarray(vols[-1]), jnp.asarray(vols[1]),
                                   use_pallas=False, **KW)
    got_m, got_p = sgm.sgm_pair(torch.as_tensor(x0), torch.as_tensor(x1),
                                torch.as_tensor(vols[-1]),
                                torch.as_tensor(vols[1]), **KW)
    for got, want in ((got_m, want_m), (got_p, want_p)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == vols[1].shape
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("direction", [-1, 1])
def test_sgm_one_direction_matches_stacked(direction):
    """One direction alone (the Middlebury left-only run and the +1
    side) gives the same sums as its half of the stacked pair: the
    scanlines are independent."""
    x0, x1, vols = _case(7)
    t0, t1 = torch.as_tensor(x0), torch.as_tensor(x1)
    both = sgm.sgm_pair(t0, t1, torch.as_tensor(vols[-1]),
                        torch.as_tensor(vols[1]), **KW)
    alone = sgm.sgm(t0, t1, torch.as_tensor(vols[direction]),
                    direction=direction, **KW)
    assert torch.equal(alone.isnan(), both[direction == 1].isnan())
    torch.testing.assert_close(alone, both[direction == 1], rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("reverse", [False, True])
def test_hslab_plain_pad_steps_pass_through(reverse):
    """With T < W real steps, the step-major sweep over the first T steps
    equals the sweep of a volume cut to them, and the pad steps pass the
    volume (plus the accumulator) through, as in ``sweep_plain``."""
    rng = np.random.RandomState(12 + reverse)
    W, S, Dp, D, T, n_rev = 13, 6, 32, 20, 9, 2
    vol = torch.as_tensor(rng.rand(W, S, Dp).astype(np.float32))
    vol[..., D:] = torch.nan
    acc = torch.as_tensor(rng.rand(W, S, Dp).astype(np.float32))
    d1 = torch.as_tensor((rng.rand(W, S) * 0.16).astype(np.float32))
    g = torch.as_tensor((rng.rand(S, D + W + Dp) * 0.16).astype(np.float32))
    kw = dict(reverse=reverse, D=D, n_rev=n_rev, rev_base=W + D - 1,
              tau=0.08, pen=sgm.pen_table(1.32, 24.25, 3.0, 2.0, 1.0, 1.0))
    out = torch.empty_like(vol)
    sgm.hslab_plain(vol, acc, out, d1, g, T=T, **kw)
    cut = torch.empty_like(vol[:T])
    sgm.hslab_plain(vol[:T], acc[:T], cut, d1[:T], g, **kw)
    for got, want in ((out[:T], cut), (out[T:], vol[T:] + acc[T:])):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_hslab_plain_matches_scan_sweep():
    """One step-major horizontal sweep (the -1 direction's lane-reversed
    D2 rows included) against the JAX package's ``lax.scan`` sweep on
    the D1/D2 values the scan lane builds."""
    x0, x1, vols = _case(11, D=9, H=6, W=21)
    D, H, W = vols[1].shape
    Dp = 32
    for dx, reverse in ((1, False), (-1, True)):
        vol_x = torch.cat([sgm._pad_d(torch.as_tensor(vols[d]).permute(2, 1, 0),
                                      Dp) for d in (-1, 1)], dim=1)
        d1 = sgm.grad_with_sentinel(torch.as_tensor(x0), 1, dx).T
        d1 = torch.cat([d1, d1], dim=1).contiguous()
        g0 = sgm.d2_columns(torch.as_tensor(x1), dx, 0, D)
        gw = D + W + Dp
        g = torch.nn.functional.pad(torch.cat([g0.flip(1), g0]),
                                    (0, gw - g0.shape[1]), value=10.0)
        out = torch.empty_like(vol_x)
        sgm.hslab_plain(vol_x, None, out, d1, g, reverse=reverse, D=D,
                        n_rev=H, rev_base=W + D - 1, tau=KW["tau_so"],
                        pen=sgm.pen_table(1.32, 24.25, 3.0, 2.0, 1.0, 1.0))
        # the scan lane's inputs (mccnn_tpu/ops/sgm.py:1365-1394)
        vx = jnp.concatenate([jnp.transpose(jnp.asarray(vols[d]), (2, 1, 0))
                              for d in (-1, 1)], axis=1)
        jd1 = jnp.concatenate([jsgm._grad_with_sentinel(
            jnp.asarray(x0), axis=1, step=dx).T] * 2, axis=1)
        parts = []
        for direction in (-1, 1):
            col = jsgm._d2_columns(jnp.asarray(x1), dx, 0, direction, D)
            idx = np.arange(W)[:, None] + np.arange(D)[None, :] * direction + D
            parts.append(jnp.transpose(col[:, idx], (1, 0, 2)))
        jd2 = jnp.concatenate(parts, axis=1)
        order = slice(None) if dx == 1 else slice(None, None, -1)
        want = np.asarray(jsgm._sweep(vx[order], jd1[order], jd2[order], 1.32,
                                      24.25, 0.08, 2.0, 3.0, 2.0,
                                      0 if dx == 1 else 1)[order])
        got = out.numpy()[..., :D]
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_subpixel_enhancement_matches_jax(seed):
    """The disparity-major parabola with its 1e-5 threshold, NaN
    neighbours included: identical maps."""
    rng = np.random.RandomState(seed)
    D, H, W = 11, 9, 30
    vol = rng.rand(D, H, W).astype(np.float32)
    vol[rng.rand(D, H, W) < 0.1] = np.nan
    d0 = rng.randint(0, D, size=(H, W)).astype(np.float32)
    got = post.subpixel_enhancement(torch.as_tensor(d0), torch.as_tensor(vol),
                                    D).numpy()
    want = np.asarray(jpost.subpixel_enhancement(jnp.asarray(d0),
                                                 jnp.asarray(vol), D))
    np.testing.assert_array_equal(got, want)
