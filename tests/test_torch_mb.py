"""The port's Middlebury prediction (plain versions, on the CPU) against
the JAX package, its Pallas kernels in interpret mode: mb fast on the
HWD lane with the left direction alone (``-a time``) and with both
(``-a predict``), and mb slow on the generic lane; mb has no outlier
stage (``kitti`` false)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mccnn_tpu import pipeline as jpipe
from mccnn_tpu.models import towers as jtowers
from mccnn_tpu.ops import post as jpost
from mccnn_tpu_torch import pipeline
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.models import towers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for this file's tests: the plain versions run
    thousands of small ops, and with a test worker on every core the
    intra-op threads of each worker contend for the cores and multiply
    the time several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _pair(seed, H, W, D):
    rng = np.random.RandomState(seed)
    base = rng.randn(H, W + D).astype(np.float32)
    return base[:, D:], base[:, :-D]


def _common(cfg, D):
    return dict(pi1=float(cfg.pi1), pi2=float(cfg.pi2),
                tau_so=float(cfg.tau_so), alpha1=float(cfg.alpha1),
                sgm_q1=float(cfg.sgm_q1), sgm_q2=float(cfg.sgm_q2),
                sgm_i=int(cfg.sgm_i), blur_t=float(cfg.blur_t),
                sm_terminate=cfg.sm_terminate, sm_skip=cfg.sm_skip,
                disp_max=D)


@pytest.mark.parametrize("action,directions", [("time", (-1,)),
                                               ("predict", (1, -1))])
def test_mb_fast_matches_jax_hwd_lane(interpret, action, directions):
    """mb fast at its own widths (l1=5, fm=64) and method parameters,
    48x200, D=40, the JAX weights converted. ``-a time`` runs the left
    direction alone (the right volume is None on both sides), ``-a
    predict`` both; neither has the outlier stage. The left volume:
    identical NaN masks, max |d| < 1e-3 (tower and join sum in other
    orders); the map: < 1% of pixels off by > 0.51 (WTA near-ties), the
    budget of tests/test_torch_pipeline.py."""
    H, W, D = 48, 200, 40
    cfg = make_config("mb", "fast", a=action)
    tree = jtowers.init_fast(jax.random.PRNGKey(cfg.seed), l1=cfg.l1,
                             fm=cfg.fm, ks=cfg.ks)
    tower = towers.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))
    x0, x1 = _pair(7, H, W, D)
    d_j, vl_j, vr_j = jpipe._fast_hwd_body(
        tree, jnp.asarray(x0), jnp.asarray(x1),
        jnp.asarray(jpost.gaussian_kernel(cfg.blur_sigma)), kitti=False,
        ws=cfg.ws, dtype_name="float32", return_vols=True,
        directions=directions, **_common(cfg, D))
    d_t, vl_t, vr_t = pipeline.stereo_predict(cfg, tower, x0, x1, D,
                                              return_vols=True, device="cpu")
    assert (vr_t is None) == (vr_j is None) == (directions == (-1,))
    a, b = vl_t.numpy(), np.asarray(vl_j)
    assert a.shape == b.shape == (D, H, W)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(np.abs(a - b)) < 1e-3
    d_t, d_j = d_t.numpy(), np.asarray(d_j)
    assert d_t.shape == (H, W) and np.isfinite(d_t).all()
    assert float((np.abs(d_t - d_j) > 0.51).mean()) < 0.01


def test_mb_slow_matches_jax_generic_lane(interpret):
    """mb slow (``-a time``: the left direction alone) at narrow widths
    (l1=2, fm=8, l2=3, nh2=16) with mb's own method parameters (CBCA x2
    before the SGM and x16 after, L1=14), 40x160, D=24: the port's
    ``stereo_predict`` against ``_volumes_jit`` (the head kernel in
    interpret mode) and ``_method_jit`` with ``directions=(-1,)`` and no
    outlier stage. Final left volume: identical NaN masks, max |d|
    <= 1e-4 (the head rounds the same operands to bf16 and sums in other
    orders; CBCA and SGM repeat the same f32 operations). The map: < 1%
    of pixels off by > 0.51."""
    H, W, D = 40, 160, 24
    cfg = make_config("mb", "slow", a="time", l1=2, fm=8, l2=3, nh2=16)
    tree = jtowers.init_slow(jax.random.PRNGKey(cfg.seed), l1=cfg.l1,
                             fm=cfg.fm, ks=cfg.ks, l2=cfg.l2, nh2=cfg.nh2)
    net = towers.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))
    x0, x1 = _pair(19, H, W, D)
    jvols = jpipe._volumes_jit(tree, jnp.asarray(x0), jnp.asarray(x1),
                               arch="slow", disp_max=D, ws=cfg.ws,
                               dtype_name="float32", use_pallas=True)
    kw = _common(cfg, D)
    kw.update(return_vols=True)
    d_j, vl_j, _ = jpipe._method_jit(
        jvols, jnp.asarray(x0), jnp.asarray(x1), directions=(-1,),
        kitti=False, L1=int(cfg.L1), tau1=float(cfg.tau1),
        cbca_i1=int(cfg.cbca_i1), cbca_i2=int(cfg.cbca_i2),
        blur_kernel=jnp.asarray(jpost.gaussian_kernel(cfg.blur_sigma)), **kw)
    d_t, vl_t, vr_t = pipeline.stereo_predict(cfg, net, x0, x1, D,
                                              return_vols=True, device="cpu")
    assert vr_t is None
    a, b = vl_t.numpy(), np.asarray(vl_j)
    assert a.shape == b.shape == (D, H, W)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(np.abs(a - b)) <= 1e-4
    d_t, d_j = d_t.numpy(), np.asarray(d_j)
    assert d_t.shape == (H, W) and np.isfinite(d_t).all()
    assert float((np.abs(d_t - d_j) > 0.51).mean()) < 0.01


def test_mb_directions_follow_the_action():
    """``-a predict`` on mb runs both reference directions (both volume
    dumps), ``-a time`` the left one alone (main.lua:954-955), on both
    lanes."""
    H, W, D = 16, 48, 8
    x0, x1 = _pair(3, H, W, D)
    for arch in ("fast", "census"):
        for action, both in (("predict", True), ("time", False)):
            cfg = make_config("mb", arch, a=action)
            net = (towers.init_fast(cfg, 0)
                   if arch == "fast" else None)
            _, vl, vr = pipeline.stereo_predict(cfg, net, x0, x1, D,
                                                return_vols=True, device="cpu")
            assert vl is not None and (vr is not None) == both, (arch, action)
