"""The port's SGM on the disparity-minor volume (plain sweeps, on the
CPU) against the JAX package's ``_sgm_slab_hwd``, whose Pallas sweeps
run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mccnn_tpu.ops import sgm as jsgm
from mccnn_tpu.ops.join_pallas import stereo_join_mxu_hwd
from mccnn_tpu_torch.ops import costs, sgm

KW = dict(pi1=4.0, pi2=55.72, tau_so=0.02, alpha1=1.5, q1=3.0, q2=2.5)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _case(xrev, H=20, W=140, C=8, D=20):
    """A join volume with its NaN layout (pad rows, pad lanes, out-of-frame
    cells) and small-gradient images, so all three penalty classes occur."""
    rng = np.random.RandomState(41 + xrev)
    x0 = (rng.rand(H, W) * 0.06).astype(np.float32)
    x1 = (rng.rand(H, W) * 0.06).astype(np.float32)
    fl = rng.randn(H, W, C).astype(np.float32)
    fr = rng.randn(H, W, C).astype(np.float32)
    fl /= np.linalg.norm(fl, axis=-1, keepdims=True)
    fr /= np.linalg.norm(fr, axis=-1, keepdims=True)
    vl, vr = stereo_join_mxu_hwd(jnp.asarray(fl), jnp.asarray(fr), D, n_fix=4,
                                 interpret=True)
    vol = np.array(vl if xrev else vr)
    return x0, x1, vol, H, W, D


@pytest.mark.parametrize("xrev", [True, False])
def test_sgm_slab_hwd_matches_jax(interpret, xrev):
    """H=20 (not a multiple of 64), D=20 (not a multiple of 128). Both
    sides do the same f32 operations in the same order; rtol 1e-5 /
    atol 1e-4 leaves room for the compiler's choices. The fused WTA map
    equals ``wta_hwd`` of the materialized sum, with and without the
    volume write."""
    x0, x1, vol, H, W, D = _case(xrev)
    want_vol, want_map = jsgm._sgm_slab_hwd(
        jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(vol), D, H, W,
        xrev=xrev, wta=True, **KW)
    want_vol = np.asarray(want_vol)[:H, :W, :D]
    t0, t1, tv = (torch.as_tensor(a) for a in (x0, x1, vol))
    got_vol, got_map = sgm.sgm_slab_hwd(t0, t1, tv, D, H, W, xrev=xrev,
                                        wta=True, **KW)
    g = got_vol.numpy()[:H, :W, :D]
    assert np.array_equal(np.isnan(g), np.isnan(want_vol))
    np.testing.assert_allclose(g, want_vol, rtol=1e-5, atol=1e-4)
    wta = costs.wta_hwd(got_vol).numpy()[:H, :W]
    assert np.array_equal(got_map.numpy()[:H, :W], wta)
    assert np.array_equal(np.asarray(want_map)[:H, :W], wta)
    map_only = sgm.sgm_slab_hwd(t0, t1, tv, D, H, W, xrev=xrev, wta=True,
                                materialize=False, **KW)
    assert np.array_equal(map_only.numpy()[:H, :W], wta)
    # the port's pad rows and columns are NaN, its pad map cells 0
    assert np.isnan(got_vol.numpy()[H:]).all()
    assert np.isnan(got_vol.numpy()[:, W:]).all()


@pytest.mark.parametrize("alpha_on", ["none", "p1a", "p1b"])
def test_pen_table_matches_penalties3(alpha_on):
    """The host-side table holds the exact float32 constants that
    ``_penalties3`` selects."""
    a = 1.5
    divs = {"none": (1.0, 1.0), "p1a": (a, 1.0), "p1b": (1.0, a)}[alpha_on]
    lo = jnp.asarray([True, False, False])
    hi = jnp.asarray([False, False, True])
    want = jsgm._penalties3(lo, hi, 4.0, 55.72, 3.0, 2.5, *divs)
    table = np.asarray(sgm.pen_table(4.0, 55.72, 3.0, 2.5, *divs),
                       np.float32).reshape(3, 3)
    for j, w in enumerate(want):
        assert np.array_equal(table[:, j], np.asarray(w, np.float32))


def test_gradient_tables_match_jax():
    rng = np.random.RandomState(5)
    x = rng.rand(7, 11).astype(np.float32)
    t = torch.as_tensor(x)
    for axis, step, sentinel in ((0, 1, None), (0, -1, None), (1, 1, 10.0),
                                 (1, -1, None)):
        got = sgm.grad_with_sentinel(t, axis, step, sentinel).numpy()
        want = np.asarray(jsgm._grad_with_sentinel(jnp.asarray(x), axis, step,
                                                   sentinel))
        assert np.array_equal(got, want)
    for dx, dy in ((1, 0), (-1, 0), (0, 1)):
        got = sgm.d2_columns(t, dx, dy, 5).numpy()
        want = np.asarray(jsgm._d2_columns(jnp.asarray(x), dx, dy, 1, 5))
        assert np.array_equal(got, want)


def test_sweep_plain_matches_scan_sweep():
    """One plain vertical sweep against the JAX package's ``lax.scan``
    sweep on the same D1/D2 values."""
    rng = np.random.RandomState(9)
    Hp, Wp, Dp, D, T = 8, 4, 32, 20, 6
    vol = rng.rand(Hp, Wp, Dp).astype(np.float32)
    vol[..., D:] = np.nan
    vol[rng.rand(*vol.shape) < 0.1] = np.nan
    d1 = (rng.rand(Hp, Wp) * 0.04).astype(np.float32)
    gw = D + Wp + Dp
    g = (rng.rand(Hp, gw) * 0.04).astype(np.float32)
    out = torch.empty(vol.shape)
    sgm.sweep_plain(torch.as_tensor(vol), None, out, None, torch.as_tensor(d1),
                    torch.as_tensor(g), vertical=True, reverse=False, T=T, D=D,
                    tau=0.02, pen=sgm.pen_table(4.0, 55.72, 3.0, 2.5, 1.5, 1.0))
    d2 = np.stack([[g[y, D + x:D + x + Dp] for x in range(Wp)]
                   for y in range(T)])
    want = np.asarray(jsgm._sweep(jnp.asarray(vol[:T]), jnp.asarray(d1[:T]),
                                  jnp.asarray(d2), 4.0, 55.72, 0.02, 1.5, 3.0,
                                  2.5, 2))
    got = out.numpy()[:T]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(out.numpy()[T:], vol[T:], equal_nan=True)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n_steps", [1, sgm.HCHUNK - 1, sgm.HCHUNK,
                                     3 * sgm.HCHUNK, 3 * sgm.HCHUNK + 5, 1280])
def test_horizontal_chunks_cover_the_steps_once_in_sweep_order(n_steps,
                                                               reverse):
    """The horizontal sweep kernel's chunk walk: the chunks cover the
    stored steps 0 .. n_steps-1 once, in sweep order (descending for a
    reverse sweep); each is one contiguous run of at most HCHUNK steps
    that starts on a multiple of HCHUNK, the ragged one at the far
    end."""
    chunks = sgm.horizontal_chunks(n_steps, reverse)
    order = [s for c in chunks for s in c]
    want = list(range(n_steps))
    assert order == (want[::-1] if reverse else want)
    for c in chunks:
        lo, hi = min(c), max(c)
        assert 1 <= len(c) <= sgm.HCHUNK and hi - lo + 1 == len(c)
        assert lo % sgm.HCHUNK == 0
        assert len(c) == sgm.HCHUNK or hi == n_steps - 1


@pytest.mark.parametrize("Ws,n_rev,Dp,has_acc,kitti", [
    (1280, 0, 256, True, True),       # one direction at KITTI size
    (1280, 1280, 256, False, True),   # its x-reversed side, first sweep
    (2452, 1226, 256, True, True),    # the generic lane's two directions
    (2452, 1226, 256, False, True),
    (740, 370, 256, True, True),      # its stacked horizontal family (hslab)
    (740, 370, 256, False, True),
    (740, 0, 228, True, True),        # the scan form's horizontal family:
    (2452, 0, 228, True, True),       # rows of D = 228, the D2 table in the ring
    (743, 371, 256, True, False),     # classes off a multiple of VWARPS
    (23, 7, 96, True, False),         # ragged classes, Dp off 128
    (150, 150, 128, True, False),
    (5, 2, 1024, True, False)])       # the widest rows
def test_vertical_plan_covers_each_scanline_once_in_one_wave(Ws, n_rev, Dp,
                                                             has_acc, kitti):
    """The vertical sweep kernel's blocks and ring: every scanline in
    exactly one block of at most VWARPS adjacent ones; no block reads both
    D2 tables (none straddles n_rev); the ring fits a block's shared
    memory. At the KITTI shapes every block is resident in one wave (its
    share of the SM's shared memory, at most 64 warps an SM) and each SM
    keeps at least 32 KB of chunks in flight."""
    p = sgm.vertical_plan(Ws, n_rev, Dp, has_acc)
    covered = [x for x0, n in p["blocks"] for x in range(x0, x0 + n)]
    assert covered == list(range(Ws))
    for x0, n in p["blocks"]:
        assert 1 <= n <= sgm.VWARPS
        assert x0 >= n_rev or x0 + n <= n_rev
    chunk = sgm.VCHUNK * sgm.VWARPS * Dp * 4 * (2 if has_acc else 1)
    assert 2 <= p["stages"] <= sgm.VSTAGES
    assert p["smem"] == p["stages"] * chunk + 2 * sgm.VSTAGES * 8
    assert p["smem"] <= sgm.SM_SMEM - sgm.BLOCK_RESERVED
    if kitti:
        assert len(p["blocks"]) <= p["per_sm"] * sgm.H100_SMS
        assert p["per_sm"] * (p["smem"] + sgm.BLOCK_RESERVED) <= sgm.SM_SMEM
        assert p["per_sm"] * sgm.VWARPS <= 64
        assert p["per_sm"] * (p["stages"] - 1) * chunk >= 32 * 1024


@pytest.mark.parametrize("Ws,n_rev,Dp,has_acc,want", [
    (740, 370, 256, True, (93, 186, 2, 7, 114816)),   # hslab at KITTI size
    (740, 370, 256, False, (93, 186, 2, 8, 65664)),
    (750, 375, 256, True, (94, 188, 2, 7, 114816)),   # ragged classes
    (37, 13, 96, True, (4, 10, 1, 8, 49280)),
    (740, 0, 228, True, (0, 185, 2, 7, 102272)),   # scan form, horizontal
    (2452, 0, 228, True, (0, 613, 5, 3, 43904))])  # scan form, vertical
def test_vertical_plan_at_the_hslab_shapes(Ws, n_rev, Dp, has_acc, want):
    """The step-major plan for the S stacked scanlines of the hslab
    entry and of the scan form, as (reversed-class blocks, blocks,
    per_sm, stages, smem): the values the C entry ``sgm_vertical_plan``
    gives on 132 SMs (reckoned from ``vertical_plan`` in
    csrc/sgm_sweep.cu; the CUDA mirror test checks the same shapes
    against the entry). At S = 740 the 186 blocks of 4 need two an SM; a
    block's ring then holds 7 chunks of 16 KB with the accumulator, so
    the SM keeps ~192 KB in flight. The scan form streams its D2 table
    where the accumulator goes (has_acc) over unpadded rows of 228
    floats, no scanline reversed: 7 chunks of 14.25 KB at S = 740, and 3
    at S = 2452, five blocks an SM."""
    p = sgm.vertical_plan(Ws, n_rev, Dp, has_acc)
    got = (sum(x0 < n_rev for x0, _ in p["blocks"]), len(p["blocks"]),
           p["per_sm"], p["stages"], p["smem"])
    assert got == want
