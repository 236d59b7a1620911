"""The port's whole prediction path (plain versions, on the CPU) against
the JAX package's fast HWD lane, whose Pallas kernels run in interpret
mode, plus the stage gates, the CLI and the device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mccnn_tpu import pipeline as jpipe
from mccnn_tpu.config import make_config as jmake_config
from mccnn_tpu.models import towers as jtowers
from mccnn_tpu.ops import post as jpost
from mccnn_tpu_torch import cli, pipeline
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.models import towers

H, W, D = 48, 200, 40


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _pair(seed):
    rng = np.random.RandomState(seed)
    base = rng.randn(H, W + D).astype(np.float32)
    return base[:, D:], base[:, :-D]


def _params(cfg):
    tree = jtowers.init_fast(jax.random.PRNGKey(cfg.seed), l1=cfg.l1,
                             fm=cfg.fm, ks=cfg.ks)
    return tree, towers.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                 tree))


def _jax_lane(tree, x0, x1, cfg, return_vols):
    return jpipe._fast_hwd_body(
        tree, jnp.asarray(x0), jnp.asarray(x1),
        jnp.asarray(jpost.gaussian_kernel(cfg.blur_sigma)), disp_max=D,
        kitti=True, ws=cfg.ws, dtype_name="float32", pi1=float(cfg.pi1),
        pi2=float(cfg.pi2), tau_so=float(cfg.tau_so), alpha1=float(cfg.alpha1),
        sgm_q1=float(cfg.sgm_q1), sgm_q2=float(cfg.sgm_q2),
        sgm_i=int(cfg.sgm_i), blur_t=float(cfg.blur_t),
        sm_terminate=cfg.sm_terminate, sm_skip=cfg.sm_skip,
        return_vols=return_vols)


def test_stereo_predict_matches_jax_hwd_lane(interpret):
    """kitti fast at 48x200, D=40, the JAX weights converted. Volumes:
    identical NaN masks, max |Δ| < 1e-3 (tower and join sum in other
    orders). Disparity: < 1% of pixels off by > 0.51 (WTA near-ties),
    the budget of tests/test_pipeline.py."""
    cfg = make_config("kitti", "fast", a="predict")
    tree, tower = _params(cfg)
    x0, x1 = _pair(17)
    d_j, vl_j, vr_j = _jax_lane(tree, x0, x1, cfg, return_vols=True)
    d_t, vl_t, vr_t = pipeline.stereo_predict(cfg, tower, x0, x1, D,
                                              return_vols=True, device="cpu")
    for name, a, b in (("volL", vl_t, vl_j), ("volR", vr_t, vr_j)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (D, H, W), name
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        assert np.nanmax(np.abs(a - b)) < 1e-3, name
    d_t, d_j = d_t.numpy(), np.asarray(d_j)
    assert d_t.shape == (H, W) and np.isfinite(d_t).all()
    assert float((np.abs(d_t - d_j) > 0.51).mean()) < 0.01
    d_only = pipeline.stereo_predict(cfg, tower, x0, x1, D, device="cpu")
    assert torch.equal(d_only, torch.as_tensor(d_t))


def test_sm_terminate_cbca2_is_the_sgm_wta(interpret):
    """-sm_terminate cbca2 stops right after the fused WTA: the output
    is the integer left winner map of the JAX lane, pixel for pixel up
    to near-ties."""
    cfg = make_config("kitti", "fast", a="predict", sm_terminate="cbca2")
    jcfg = jmake_config("kitti", "fast", a="predict", sm_terminate="cbca2")
    tree, tower = _params(cfg)
    x0, x1 = _pair(23)
    got = pipeline.stereo_predict(cfg, tower, x0, x1, D, device="cpu").numpy()
    want = np.asarray(_jax_lane(tree, x0, x1, jcfg, return_vols=False))
    assert np.array_equal(got, np.round(got))
    assert float((got != want).mean()) < 0.01


def test_cli_predict_writes_bins(tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.RandomState(5)
    h, w, d = 20, 60, 12
    base = (rng.rand(h, w + d) * 255).astype(np.uint8)
    Image.fromarray(base[:, :w]).save(tmp_path / "L.png")
    Image.fromarray(base[:, d:]).save(tmp_path / "R.png")
    monkeypatch.chdir(tmp_path)
    cli.main(["kitti", "fast", "-a", "predict", "-left", "L.png", "-right",
              "R.png", "-disp_max", str(d), "-backend", "cpu"])
    for name, shape in (("left", (d, h, w)), ("right", (d, h, w)),
                        ("disp", (h, w))):
        arr = np.fromfile(tmp_path / f"{name}.bin", dtype=np.float32)
        assert arr.size == int(np.prod(shape)), name
    disp = np.fromfile(tmp_path / "disp.bin", dtype=np.float32)
    assert np.isfinite(disp).all() and disp.min() >= 0 and disp.max() <= d


def test_entry_points_raise_without_cuda(monkeypatch):
    """device=None means CUDA, and no CUDA means an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_config("kitti", "fast", a="predict")
    tower = towers.init_fast(cfg, 0)
    x = np.zeros((8, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.stereo_predict(cfg, tower, x, x, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.device_of(cfg)


@pytest.mark.parametrize("overrides", [dict(vol_dtype="bfloat16", cbca_i1=2),
                                       dict(use_cache=True),
                                       dict(dtype="bfloat16")])
def test_configs_outside_the_lane_name_the_roadmap(overrides):
    """A 16-bit -vol_dtype on a generic-lane config (here fast with
    CBCA) raises ValueError naming vol_dtype, as the JAX package's
    check_vol_dtype does. The volume cache and -dtype bfloat16 are
    ported: they run and return a finite map (the cache, on the generic
    lane, reads and writes nothing without a pair id)."""
    cfg = make_config("kitti", "fast", a="predict", **overrides)
    tower = towers.init_fast(make_config("kitti", "fast"), 0)
    x0, x1 = _pair(3)
    if cfg.vol_dtype != "float32":
        with pytest.raises(ValueError, match="vol_dtype"):
            pipeline.stereo_predict(cfg, tower, x0, x1, 4, device="cpu")
    else:
        d = pipeline.stereo_predict(cfg, tower, x0, x1, D, device="cpu")
        assert d.shape == (H, W) and bool(torch.isfinite(d).all())
