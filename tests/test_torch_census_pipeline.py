"""The port's census, ad and fast-with-CBCA prediction (plain versions,
on the CPU) against the JAX package's generic lane, ``_volumes_jit`` +
``_method_jit``, in the slab and the stream form of the SGM; plus the
network rule for ad and census, the lane choice and the CLI."""

import functools

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

H, W, D = 24, 72, 14
NARROW = dict(l1=2, fm=8)

# name -> (dataset, arch, action, config overrides, volume tolerance)
CASES = {
    "kitti-census": ("kitti", "census", "predict", {}, 0.0),
    "kitti-ad": ("kitti", "ad", "predict", {}, 1e-5),
    "mb-census-left": ("mb", "census", "test_te", {}, 0.0),
    "kitti-fast-cbca": ("kitti", "fast", "predict",
                        dict(cbca_i1=2, L1=5, tau1=0.13, **NARROW), 1e-4),
}


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


def _config(name):
    dataset, arch, action, over, tol = CASES[name]
    return make_config(dataset, arch, a=action, **over), tol


def _nets(cfg):
    if cfg.arch != "fast":
        return None, None
    tree = jtowers.init_fast(jax.random.PRNGKey(cfg.seed), l1=cfg.l1,
                             fm=cfg.fm, ks=cfg.ks)
    return tree, towers.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                 tree))


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """The JAX package's volumes, disparity map and final volumes for a
    case: one compile per case, shared by the forms (call it under the
    ``interpret`` fixture: the fast case runs the join's Pallas kernel)."""
    cfg, _ = _config(name)
    tree, _ = _nets(cfg)
    x0, x1 = _pair(17)
    vols = jpipe._volumes_jit(tree, jnp.asarray(x0), jnp.asarray(x1),
                              arch=cfg.arch, disp_max=D, ws=cfg.ws,
                              dtype_name="float32", use_pallas=True)
    directions = (-1,) if cfg.a == "test_te" else (1, -1)
    out = jpipe._method_jit(
        vols, jnp.asarray(x0), jnp.asarray(x1), disp_max=D,
        directions=directions, kitti=cfg.dataset == "kitti", L1=int(cfg.L1),
        tau1=float(cfg.tau1), cbca_i1=int(cfg.cbca_i1),
        cbca_i2=int(cfg.cbca_i2), pi1=float(cfg.pi1), pi2=float(cfg.pi2),
        tau_so=float(cfg.tau_so), alpha1=float(cfg.alpha1),
        sgm_q1=float(cfg.sgm_q1), sgm_q2=float(cfg.sgm_q2),
        sgm_i=int(cfg.sgm_i),
        blur_kernel=jnp.asarray(jpost.gaussian_kernel(cfg.blur_sigma)),
        blur_t=float(cfg.blur_t), sm_terminate=cfg.sm_terminate,
        sm_skip=cfg.sm_skip, return_vols=True)
    return ({k: np.asarray(v) for k, v in vols.items()},
            [None if o is None else np.asarray(o) for o in out])


def _close(a, b, tol, what):
    assert a.shape == b.shape == (D, H, W), what
    assert np.array_equal(np.isnan(a), np.isnan(b)), what
    assert np.isnan(a).any() and np.nanmax(np.abs(a - b)) <= tol, what


@pytest.mark.parametrize("form", ["slab", "stream"])
@pytest.mark.parametrize("name", list(CASES))
def test_stereo_predict_matches_jax_generic_lane(interpret, name, form):
    """24x72, D=14, each config's own stereo method. Cost volumes: equal
    NaN masks; census equal (integer distances), ad max |d| <= 1e-5 (box
    sums in another order), fast <= 1e-4 (tower and join sum in other
    orders). Final volumes: the same masks, within 1e-4 plus the volume
    tolerance (CBCA and SGM repeat the JAX package's f32 operations).
    Disparity: < 1% of pixels off by > 0.51 (WTA near-ties), the budget
    of tests/test_pipeline.py."""
    cfg, tol = _config(name)
    _, net = _nets(cfg)
    x0, x1 = _pair(17)
    jvols, (d_j, vl_j, vr_j) = _jax_side(name)
    tvols = pipeline._volumes(net, torch.as_tensor(x0), torch.as_tensor(x1),
                              arch=cfg.arch, disp_max=D, ws=cfg.ws)
    for k in (-1, 1):
        _close(tvols[k].numpy(), jvols[k], tol, f"volume {k}")
    d_t, vl_t, vr_t = pipeline.stereo_predict(cfg, net, x0, x1, D,
                                              return_vols=True, device="cpu",
                                              sgm_form=form)
    _close(vl_t.numpy(), vl_j, 1e-4 + tol, "final left volume")
    if cfg.a == "test_te":
        assert vr_t is None and vr_j is None
    else:
        _close(vr_t.numpy(), vr_j, 1e-4 + tol, "final right volume")
    d_t = d_t.numpy()
    assert d_t.shape == (H, W) and np.isfinite(d_t).all()
    assert float((np.abs(d_t - d_j) > 0.51).mean()) < 0.01


@pytest.mark.parametrize("name", ["kitti-census", "kitti-fast-cbca"])
def test_forms_give_equal_outputs(name):
    """The slab, stream and grid forms add the same sweep results: the
    maps and the final volumes are equal."""
    cfg, _ = _config(name)
    _, net = _nets(cfg)
    x0, x1 = _pair(23)
    outs = [pipeline.stereo_predict(cfg, net, x0, x1, D, return_vols=True,
                                    device="cpu", sgm_form=form)
            for form in ("slab", "stream", "grid")]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("overrides", [dict(arch="census"), dict(cbca_i1=2)])
def test_configs_once_outside_the_lane_now_run(overrides):
    """The two configurations the port used to refuse (census, and the
    fast arch with CBCA) give finite maps of the frame's shape."""
    arch = overrides.pop("arch", "fast")
    cfg = make_config("kitti", arch, a="predict", **overrides)
    net = None if arch == "census" else towers.init_fast(cfg, 0)
    x0, x1 = _pair(29)
    d = pipeline.stereo_predict(cfg, net, x0, x1, D, device="cpu").numpy()
    assert d.shape == (H, W) and np.isfinite(d).all()
    assert d.min() >= 0 and d.max() <= D


@pytest.mark.parametrize("arch", ["census", "ad"])
def test_ad_and_census_take_no_network(arch):
    cfg = make_config("kitti", arch, a="predict")
    tower = towers.init_fast(make_config("kitti", "fast", **NARROW), 0)
    x = np.zeros((8, 16), np.float32)
    with pytest.raises(TypeError, match="no network"):
        pipeline.stereo_predict(cfg, tower, x, x, 4, device="cpu")
    assert cli.load_params(cfg) is None


def test_fast_arch_needs_its_tower():
    cfg = make_config("kitti", "fast", a="predict", cbca_i1=2)
    x = np.zeros((8, 16), np.float32)
    with pytest.raises(TypeError, match="FastTower"):
        pipeline.stereo_predict(cfg, None, x, x, 4, device="cpu")


@pytest.mark.parametrize("env,form,hwd", [("1", None, True), ("0", None, False),
                                          ("1", "stream", False),
                                          ("0", "slab", True)])
def test_plain_fast_arch_leaves_the_hwd_lane_with_the_scan_form(monkeypatch,
                                                                env, form, hwd):
    """The fast arch without CBCA runs the HWD lane only while the SGM
    is in its slab form, as the JAX package's ``_hwd_eligible``; an
    explicit form overrides the environment."""
    monkeypatch.setenv("MCCNN_SGM_HSLAB", env)
    cfg = make_config("kitti", "fast", a="predict", **NARROW)
    tower = towers.init_fast(cfg, 0)
    lanes = []
    monkeypatch.setattr(pipeline, "_fast_hwd",
                        lambda *a, **kw: lanes.append("hwd"))
    monkeypatch.setattr(pipeline, "_method",
                        lambda *a, **kw: lanes.append(kw["sgm_form"]))
    x0, x1 = _pair(31)
    pipeline.stereo_predict(cfg, tower, x0, x1, D, device="cpu", sgm_form=form)
    assert lanes == (["hwd"] if hwd else ["stream"])


def test_census_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_config("kitti", "census", a="predict")
    x = np.zeros((8, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.stereo_predict(cfg, None, x, x, 4)


def test_cli_predict_census_writes_bins(tmp_path, monkeypatch, capsys):
    """``kitti census -a predict -backend cpu`` on a 20x60 pair: the
    three .bin files with the right sizes, and no random-weights
    warning."""
    from PIL import Image

    rng = np.random.RandomState(5)
    h, w, d = 20, 60, 12
    base = (rng.rand(h, w + d) * 255).astype(np.uint8)
    Image.fromarray(base[:, :w]).save(tmp_path / "L.png")
    Image.fromarray(base[:, d:]).save(tmp_path / "R.png")
    monkeypatch.chdir(tmp_path)
    cli.main(["kitti", "census", "-a", "predict", "-left", "L.png", "-right",
              "R.png", "-disp_max", str(d), "-backend", "cpu"])
    assert "WARNING" not in capsys.readouterr().out
    for name, shape in (("left", (d, h, w)), ("right", (d, h, w)),
                        ("disp", (h, w))):
        arr = np.fromfile(tmp_path / f"{name}.bin", dtype=np.float32)
        assert arr.size == int(np.prod(shape)), name
    disp = np.fromfile(tmp_path / "disp.bin", dtype=np.float32)
    assert np.isfinite(disp).all() and disp.min() >= 0 and disp.max() <= d
