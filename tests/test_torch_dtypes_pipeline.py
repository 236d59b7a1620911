"""The port's fast HWD lane with 16-bit volume storage (``-vol_dtype``
bfloat16 and float16) and bf16 compute (``-dtype bfloat16``), plain
versions on the CPU, against the JAX package's ``_fast_hwd_body`` in the
same dtypes, its Pallas kernels in interpret mode."""

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


# the shape and input of tests/test_pipeline.py's 16-bit test
H, W, D = 48, 200, 40


@pytest.fixture(scope="module")
def case():
    """The JAX weights (converted for the port), a seeded noise pair and
    the float32 maps of both packages and the port's float32 volume
    dumps, computed once."""
    cfg = make_config("kitti", "fast", a="predict")
    tree = jtowers.init_fast(jax.random.PRNGKey(cfg.seed), l1=cfg.l1,
                             fm=cfg.fm, ks=cfg.ks)
    tower = towers.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))
    rng = np.random.RandomState(31)
    base = rng.randn(H, W + D).astype(np.float32)
    x0, x1 = base[:, D:], base[:, :-D]
    with pytest.MonkeyPatch.context() as mp:
        _interpret(mp)
        j32 = _jax_map(tree, x0, x1, cfg)
    t32, vl32, vr32 = pipeline.stereo_predict(cfg, tower, x0, x1, D,
                                              return_vols=True, device="cpu")
    return dict(cfg=cfg, tree=tree, tower=tower, x0=x0, x1=x1, j32=j32,
                t32=t32.numpy(), vols32=(vl32, vr32))


def _interpret(mp):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    mp.setattr(pl, "pallas_call", interp)


def _jax_map(tree, x0, x1, cfg, dtype_name="float32", vol_dtype="float32"):
    return np.asarray(jpipe._fast_hwd_body(
        tree, jnp.asarray(x0), jnp.asarray(x1),
        jnp.asarray(jpost.gaussian_kernel(cfg.blur_sigma)), disp_max=D,
        kitti=True, ws=cfg.ws, dtype_name=dtype_name, pi1=float(cfg.pi1),
        pi2=float(cfg.pi2), tau_so=float(cfg.tau_so), alpha1=float(cfg.alpha1),
        sgm_q1=float(cfg.sgm_q1), sgm_q2=float(cfg.sgm_q2),
        sgm_i=int(cfg.sgm_i), blur_t=float(cfg.blur_t),
        sm_terminate=cfg.sm_terminate, sm_skip=cfg.sm_skip,
        return_vols=False, vol_dtype=vol_dtype))


def _moved(a, b) -> float:
    """The share of pixels moved by more than 1 px."""
    return float((np.abs(a - b) > 1.0).mean())


@pytest.mark.parametrize("over", [dict(vol_dtype="bfloat16"),
                                  dict(vol_dtype="float16"),
                                  dict(dtype="bfloat16")])
def test_hwd_lane_16bit_matches_jax(case, monkeypatch, over):
    """kitti fast at 48x200, D=40, on the noise pair of
    tests/test_pipeline.py:182-237 (the worst case for 16-bit WTA
    margins). The share of pixels the port moves by more than 1 px
    against JAX in the same dtype is no larger than JAX's own
    16-bit-against-float32 share on this input (the port's join sums in
    float32 where JAX's splits into two bf16 levels, which can move a
    rounding by one unit: a difference of the size 16-bit storage makes
    everywhere). The port's 16-bit-against-float32 figures stay within
    that test's bounds: moved share < 0.15, mean |d| < 1.0. The mean
    |d| to JAX in the same dtype is no larger than JAX's own mean |d|
    between its 16-bit and float32 runs either. The volume
    dumps come back float32 (README:63-66), NaN where the float32 run's
    are."""
    cfg = make_config("kitti", "fast", a="predict", **over)
    _interpret(monkeypatch)
    j16 = _jax_map(case["tree"], case["x0"], case["x1"], cfg,
                   dtype_name=cfg.dtype, vol_dtype=cfg.vol_dtype)
    t16, vl, vr = pipeline.stereo_predict(cfg, case["tower"], case["x0"],
                                          case["x1"], D, return_vols=True,
                                          device="cpu")
    t16 = t16.numpy()
    assert t16.shape == (H, W) and np.isfinite(t16).all()
    port_jax, jax_own = _moved(t16, j16), _moved(j16, case["j32"])
    port_own = _moved(t16, case["t32"])
    mad = float(np.abs(t16 - case["t32"]).mean())
    mad_pj = float(np.abs(t16 - j16).mean())
    mad_j = float(np.abs(j16 - case["j32"]).mean())
    print(f"{over}: moved > 1 px: port vs JAX {port_jax:.5f}, JAX 16 vs 32 "
          f"{jax_own:.5f}, port 16 vs 32 {port_own:.5f}; mean |d|: port vs "
          f"JAX {mad_pj:.5f}, JAX 16 vs 32 {mad_j:.5f}, port 16 vs 32 "
          f"{mad:.5f}")
    assert port_jax <= jax_own
    # the moved shares are 0 on this input; the mean |d| says the same
    assert mad_pj <= mad_j
    assert port_own < 0.15 and mad < 1.0
    for v, v32 in zip((vl, vr), case["vols32"]):
        assert v.dtype == torch.float32 and v.shape == (D, H, W)
        assert torch.equal(v.isnan(), v32.isnan())
