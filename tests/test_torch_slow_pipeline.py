"""The port's slow-arch prediction path (plain versions, on the CPU)
against the JAX package's generic lane: ``_volumes_jit`` with the slow
head's Pallas kernel in interpret mode, then ``_method_jit`` (scan
sweeps, XLA CBCA); plus the stage gates, the CLI and the device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mccnn_tpu import pipeline as jpipe
from mccnn_tpu.models import towers as jtowers
from mccnn_tpu.ops import post as jpost
from mccnn_tpu_torch import cli, pipeline
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.models import towers

NARROW = dict(l1=2, fm=8, l2=3, nh2=16)


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


def _nets(cfg):
    tree = jtowers.init_slow(jax.random.PRNGKey(cfg.seed), l1=cfg.l1,
                             fm=cfg.fm, ks=cfg.ks, l2=cfg.l2, nh2=cfg.nh2)
    return tree, towers.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                 tree))


def _jax_method(vols, x0, x1, cfg, D, **over):
    kw = dict(disp_max=D, directions=(1, -1), kitti=True, L1=int(cfg.L1),
              tau1=float(cfg.tau1), cbca_i1=int(cfg.cbca_i1),
              cbca_i2=int(cfg.cbca_i2), pi1=float(cfg.pi1),
              pi2=float(cfg.pi2), tau_so=float(cfg.tau_so),
              alpha1=float(cfg.alpha1), sgm_q1=float(cfg.sgm_q1),
              sgm_q2=float(cfg.sgm_q2), sgm_i=int(cfg.sgm_i),
              blur_kernel=jnp.asarray(jpost.gaussian_kernel(cfg.blur_sigma)),
              blur_t=float(cfg.blur_t), sm_terminate=cfg.sm_terminate,
              sm_skip=cfg.sm_skip, return_vols=False)
    kw.update(over)
    return jpipe._method_jit({k: jnp.asarray(v) for k, v in vols.items()},
                             jnp.asarray(x0), jnp.asarray(x1), **kw)


def test_stereo_predict_slow_matches_jax_generic_lane(interpret):
    """kitti slow at narrow widths (l1=2, fm=8, l2=3, nh2=16), 40x160,
    D=24, the JAX weights converted. Cost volumes and final volumes:
    identical NaN masks, max |d| <= 1e-4 (the head rounds the same
    operands to bf16 and sums in other orders; CBCA and SGM repeat the
    same f32 operations). Disparity: < 1% of pixels off by > 0.51
    (WTA near-ties), the budget of tests/test_pipeline.py."""
    H, W, D = 40, 160, 24
    cfg = make_config("kitti", "slow", a="predict", **NARROW)
    tree, net = _nets(cfg)
    x0, x1 = _pair(17, H, W, D)
    jvols = jpipe._volumes_jit(tree, jnp.asarray(x0), jnp.asarray(x1),
                               arch="slow", disp_max=D, ws=cfg.ws,
                               dtype_name="float32", use_pallas=True)
    tvols = pipeline._volumes(net, torch.as_tensor(x0), torch.as_tensor(x1),
                              arch="slow", disp_max=D, ws=cfg.ws)
    for k in (-1, 1):
        a, b = tvols[k].numpy(), np.asarray(jvols[k])
        assert a.shape == b.shape == (D, H, W)
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        assert np.nanmax(np.abs(a - b)) <= 1e-4, k
    d_j, vl_j, vr_j = _jax_method(jvols, x0, x1, cfg, D, return_vols=True)
    d_t, vl_t, vr_t = pipeline.stereo_predict(cfg, net, x0, x1, D,
                                              return_vols=True, device="cpu")
    for name, a, b in (("volL", vl_t, vl_j), ("volR", vr_t, vr_j)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (D, H, W), name
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        assert np.nanmax(np.abs(a - b)) <= 1e-4, name
    d_t, d_j = d_t.numpy(), np.asarray(d_j)
    assert d_t.shape == (H, W) and np.isfinite(d_t).all()
    assert float((np.abs(d_t - d_j) > 0.51).mean()) < 0.01
    d_only = pipeline.stereo_predict(cfg, net, x0, x1, D, device="cpu")
    assert torch.equal(d_only, torch.as_tensor(d_t))


@pytest.mark.parametrize("gate", [
    dict(sm_terminate="cnn"), dict(sm_terminate="cbca1"),
    dict(sm_terminate="sgm"), dict(sm_terminate="cbca2"),
    dict(sm_terminate="occlusion"), dict(sm_terminate="median"),
    dict(sm_skip="cbca"), dict(sm_skip="sgm"),
    dict(sm_skip="subpixel_enchancement"), dict(sm_skip="bilateral"),
    dict(cbca_i2=1)])
def test_method_gates_match_jax(gate):
    """Every gate of the generic lane on the same volumes as JAX's
    ``_method_jit`` (cbca_i2=1 runs the second CBCA), 20x48, D=10:
    < 1% of pixels off by > 0.51 (WTA near-ties; the gates that stop at
    a WTA map give integer maps)."""
    H, W, D = 20, 48, 10
    cfg = make_config("kitti", "slow", a="predict", **gate)
    rng = np.random.RandomState(29)
    x0, x1 = _pair(31, H, W, D)
    vols = {k: rng.rand(D, H, W).astype(np.float32) for k in (-1, 1)}
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    for k, v in vols.items():
        v[np.broadcast_to((xs + ds * k < 0) | (xs + ds * k >= W), v.shape)] = np.nan
    want = np.asarray(_jax_method(vols, x0, x1, cfg, D))
    got = pipeline._method(
        {k: torch.as_tensor(v) for k, v in vols.items()}, torch.as_tensor(x0),
        torch.as_tensor(x1),
        torch.as_tensor(jpost.gaussian_kernel(cfg.blur_sigma)), disp_max=D,
        directions=(1, -1), kitti=True, L1=cfg.L1, tau1=cfg.tau1,
        cbca_i1=cfg.cbca_i1, cbca_i2=cfg.cbca_i2, pi1=cfg.pi1, pi2=cfg.pi2,
        tau_so=cfg.tau_so, alpha1=cfg.alpha1, sgm_q1=cfg.sgm_q1,
        sgm_q2=cfg.sgm_q2, sgm_i=cfg.sgm_i, blur_t=cfg.blur_t,
        sm_terminate=cfg.sm_terminate, sm_skip=cfg.sm_skip,
        return_vols=False).numpy()
    assert got.shape == want.shape == (H, W)
    assert float((np.abs(got - want) > 0.51).mean()) < 0.01


def test_mb_left_only_matches_jax():
    """Middlebury evaluation runs the -1 direction alone (no outlier
    stage): the generic lane on one volume against JAX's _method_jit,
    mb slow's stereo method (L1=14, cbca_i2=16 cut to 1 here for time),
    24x64, D=12: < 1% of pixels off by > 0.51."""
    H, W, D = 24, 64, 12
    cfg = make_config("mb", "slow", a="test_te", cbca_i2=1)
    x0, x1 = _pair(37, H, W, D)
    vol = np.random.RandomState(41).rand(D, H, W).astype(np.float32)
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    vol[np.broadcast_to(xs - ds < 0, vol.shape)] = np.nan
    want = np.asarray(_jax_method({-1: vol}, x0, x1, cfg, D,
                                  directions=(-1,), kitti=False))
    got = pipeline._method(
        {-1: torch.as_tensor(vol)}, torch.as_tensor(x0), torch.as_tensor(x1),
        torch.as_tensor(jpost.gaussian_kernel(cfg.blur_sigma)), disp_max=D,
        directions=(-1,), kitti=False, L1=cfg.L1, tau1=cfg.tau1,
        cbca_i1=cfg.cbca_i1, cbca_i2=cfg.cbca_i2, pi1=cfg.pi1, pi2=cfg.pi2,
        tau_so=cfg.tau_so, alpha1=cfg.alpha1, sgm_q1=cfg.sgm_q1,
        sgm_q2=cfg.sgm_q2, sgm_i=cfg.sgm_i, blur_t=cfg.blur_t,
        sm_terminate="", sm_skip="", return_vols=False).numpy()
    assert got.shape == want.shape == (H, W)
    assert float((np.abs(got - want) > 0.51).mean()) < 0.01


def test_cli_predict_slow_writes_bins(tmp_path, monkeypatch):
    """``kitti slow -a predict -backend cpu`` at the kitti slow widths on
    a 20x60 pair with seeded random weights."""
    from PIL import Image

    rng = np.random.RandomState(5)
    h, w, d = 20, 60, 12
    base = (rng.rand(h, w + d) * 255).astype(np.uint8)
    Image.fromarray(base[:, :w]).save(tmp_path / "L.png")
    Image.fromarray(base[:, d:]).save(tmp_path / "R.png")
    monkeypatch.chdir(tmp_path)
    cli.main(["kitti", "slow", "-a", "predict", "-left", "L.png", "-right",
              "R.png", "-disp_max", str(d), "-backend", "cpu"])
    for name, shape in (("left", (d, h, w)), ("right", (d, h, w)),
                        ("disp", (h, w))):
        arr = np.fromfile(tmp_path / f"{name}.bin", dtype=np.float32)
        assert arr.size == int(np.prod(shape)), name
    disp = np.fromfile(tmp_path / "disp.bin", dtype=np.float32)
    assert np.isfinite(disp).all() and disp.min() >= 0 and disp.max() <= d
    left = np.fromfile(tmp_path / "left.bin", dtype=np.float32).reshape(d, h, w)
    assert np.isnan(left[d - 1, :, :d - 1]).all()  # x - d < 0, before fix_border


def test_slow_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_config("kitti", "slow", a="predict", **NARROW)
    net = towers.init_slow(cfg, 0)
    x = np.zeros((8, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.stereo_predict(cfg, net, x, x, 4)


@pytest.mark.parametrize("overrides", [dict(vol_dtype="bfloat16"),
                                       dict(dtype="bfloat16"),
                                       dict(use_cache=True)])
def test_slow_configs_outside_the_lane_name_the_roadmap(overrides):
    """The slow arch runs on the generic lane, so a 16-bit -vol_dtype
    raises ValueError naming vol_dtype (the JAX package's
    check_vol_dtype). The volume cache and -dtype bfloat16 are ported:
    they run and return a finite map (the cache reads and writes nothing
    without a pair id)."""
    cfg = make_config("kitti", "slow", a="predict", **NARROW, **overrides)
    net = towers.init_slow(cfg, 0)
    H, W, D = 16, 48, 8
    x0, x1 = _pair(4, H, W, D)
    if cfg.vol_dtype != "float32":
        with pytest.raises(ValueError, match="vol_dtype"):
            pipeline.stereo_predict(cfg, net, x0, x1, D, device="cpu")
    else:
        d = pipeline.stereo_predict(cfg, net, x0, x1, D, device="cpu")
        assert d.shape == (H, W) and bool(torch.isfinite(d).all())


def test_arch_and_network_must_agree():
    cfg = make_config("kitti", "slow", a="predict", **NARROW)
    tower = towers.init_fast(make_config("kitti", "fast"), 0)
    x = np.zeros((8, 16), np.float32)
    with pytest.raises(TypeError, match="SlowNet"):
        pipeline.stereo_predict(cfg, tower, x, x, 4, device="cpu")
