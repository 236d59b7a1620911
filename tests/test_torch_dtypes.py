"""The port's storage and compute dtypes and ``disp_true`` (plain
versions, on the CPU) against the JAX package, whose Pallas kernels run
in interpret mode: the 16-bit join and its ``d_true`` lanes, the 16-bit
SGM on the disparity-minor volume, the bf16 towers and slow head, the
``disp_true`` masks of both lanes, and the ``-vol_dtype`` contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mccnn_tpu import pipeline as jpipe
from mccnn_tpu.models import towers as jtowers
from mccnn_tpu.ops import sgm as jsgm
from mccnn_tpu.ops.join_pallas import stereo_join_mxu_hwd
from mccnn_tpu.ops.slow_head_pallas import slow_volumes_mxu
from mccnn_tpu_torch import cli, pipeline
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.models import towers
from mccnn_tpu_torch.ops import costs, join, sgm


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


KW = dict(pi1=4.0, pi2=55.72, tau_so=0.02, alpha1=1.5, q1=3.0, q2=2.5)
# significand bits after the leading one, and the least normal exponent
BITS = {"bfloat16": (7, -126), "float16": (10, -14)}


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def ulp(v: np.ndarray, dtype: str) -> np.ndarray:
    """One unit in the last place of ``dtype`` at each value of v (the
    subnormal spacing below the least normal number)."""
    bits, emin = BITS[dtype]
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** emin)))
    return 2.0 ** (e - bits)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values and equal NaN masks."""
    return bool(torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _feats(seed, H=20, W=140, C=8):
    rng = np.random.RandomState(seed)
    f = rng.randn(2, H, W, C).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("d_true", [None, 13])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_join_16bit_is_the_f32_join_rounded(dtype, d_true):
    """20x140, C=8, D=20, n_fix=4. The port's 16-bit join is its float32
    join rounded to the storage type, bit for bit (one float32 result,
    one rounding, as the kernel's store does); with d_true the lanes
    d >= d_true are NaN and the others unchanged. Against the JAX
    kernel with out_dtype and d_true: equal NaN masks, and within one
    unit in the last place of the storage type plus the 1e-5 of the
    float32 join (its two-level bf16 split sits up to 9.8e-6 from the
    float32 dot, which can move the rounding by one unit)."""
    fl, fr = _feats(1)
    D = 20
    tl, tr = torch.as_tensor(fl), torch.as_tensor(fr)
    f32 = join.stereo_join_hwd(tl, tr, D, n_fix=4)
    got = join.stereo_join_hwd(tl, tr, D, n_fix=4, d_true=d_true,
                               out_dtype=getattr(torch, dtype))
    want = jax.block_until_ready(stereo_join_mxu_hwd(
        jnp.asarray(fl), jnp.asarray(fr), D, n_fix=4, interpret=True,
        d_true=d_true, out_dtype=dtype))
    for g, f, w in zip(got, f32, want):
        assert g.dtype == getattr(torch, dtype)
        if d_true is not None:
            f = f.clone()
            f[..., d_true:] = torch.nan
        assert same(g, f.to(g.dtype))
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert np.array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        assert np.all(np.abs(g - w)[ok] <= ulp(w[ok], dtype) + 1e-5)
        if d_true is not None:
            assert np.isnan(g[..., d_true:]).all()


def _sgm_case(xrev, dtype, H=20, W=140, C=8, D=20):
    """The join volume of tests/test_torch_sgm.py stored in ``dtype``,
    and small-gradient images, so all three penalty classes occur."""
    rng = np.random.RandomState(41 + xrev)
    x0 = (rng.rand(H, W) * 0.06).astype(np.float32)
    x1 = (rng.rand(H, W) * 0.06).astype(np.float32)
    fl, fr = _feats(41 + xrev, H, W, C)
    vols = stereo_join_mxu_hwd(jnp.asarray(fl), jnp.asarray(fr), D, n_fix=4,
                               interpret=True, out_dtype=dtype)
    return x0, x1, vols[0] if xrev else vols[1], H, W, D


@pytest.mark.parametrize("xrev", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_sgm_slab_hwd_16bit_matches_jax(interpret, dtype, xrev):
    """The four chained sweeps on a 16-bit volume, against
    ``_sgm_slab_hwd`` on the same volume. Both widen the stored rows,
    run the recurrence in float32 and round only the stored sums, so
    they differ only where the compiler's float32 choices move a sum
    across a rounding boundary: equal NaN masks, values within two
    units in the last place of the storage type plus the float32
    test's 1e-4, the float32 winner maps equal on >= 0.999 of the
    pixels (a unit apart can flip an exact tie; the share is printed).
    The port's accumulator and sum stay in the storage dtype, its
    winner map float32."""
    x0, x1, vol, H, W, D = _sgm_case(xrev, dtype)
    want_vol, want_map = jsgm._sgm_slab_hwd(
        jnp.asarray(x0), jnp.asarray(x1), vol, D, H, W, xrev=xrev, wta=True,
        **KW)
    tv = torch.as_tensor(np.array(vol.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got_vol, got_map = sgm.sgm_slab_hwd(torch.as_tensor(x0),
                                        torch.as_tensor(x1), tv, D, H, W,
                                        xrev=xrev, wta=True, **KW)
    assert got_vol.dtype == tv.dtype and got_map.dtype == torch.float32
    g = got_vol.float().numpy()[:H, :W, :D]
    w = np.asarray(want_vol.astype(jnp.float32))[:H, :W, :D]
    assert np.array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    assert np.all(np.abs(g - w)[ok] <= 2 * ulp(w[ok], dtype) + 1e-4)
    share = float((got_map.numpy()[:H, :W]
                   == np.asarray(want_map)[:H, :W]).mean())
    print(f"{dtype} xrev={xrev}: winner maps equal on {share:.6f}")
    assert share >= 0.999


def test_sweep_plain_rounds_only_the_stored_sum():
    """The plain step loop on a bf16 volume and accumulator is the
    float32 loop on their widened values, with only the written sum
    rounded and the winner map taken from the float32 sum: against a
    float32 run on the widened inputs, the bf16 output is that run's
    output rounded, bit for bit, and the winner maps are equal."""
    rng = np.random.RandomState(3)
    Hp, Ws, Dp, D = 6, 37, 128, 100
    vol = rng.rand(Hp, Ws, Dp).astype(np.float32)
    vol[..., D:] = np.nan
    vol[rng.rand(Hp, Ws, Dp) < 0.03] = np.nan
    acc = rng.rand(Hp, Ws, Dp).astype(np.float32) * 40
    acc[np.isnan(vol)] = np.nan
    d1 = torch.as_tensor((rng.rand(Hp, Ws) * 0.16).astype(np.float32))
    g = torch.as_tensor((rng.rand(Hp, D + Ws + Dp) * 0.16).astype(np.float32))
    kw = dict(reverse=True, T=Ws - 3, D=D, tau=0.08,
              pen=sgm.pen_table(1.32, 24.25, 3.0, 2.0, 1.0, 1.0))
    v16, a16 = (torch.as_tensor(a).to(torch.bfloat16) for a in (vol, acc))
    out16, w16 = torch.empty_like(v16), torch.empty((Hp, Ws))
    sgm.sweep_plain(v16, a16, out16, w16, d1, g, vertical=False, **kw)
    out32, w32 = torch.empty((Hp, Ws, Dp)), torch.empty((Hp, Ws))
    sgm.sweep_plain(v16.float(), a16.float(), out32, w32, d1, g,
                    vertical=False, **kw)
    assert same(out16, out32.to(torch.bfloat16))
    assert torch.equal(w16, w32)


def _fast_params(cfg):
    tree = jtowers.init_fast(jax.random.PRNGKey(cfg.seed), l1=cfg.l1,
                             fm=cfg.fm, ks=cfg.ks)
    return tree, towers.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                 tree))


def _slow_params(cfg):
    tree = jtowers.init_slow(jax.random.PRNGKey(cfg.seed), l1=cfg.l1,
                             fm=cfg.fm, ks=cfg.ks, l2=cfg.l2, nh2=cfg.nh2)
    return tree, towers.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                 tree))


def _pair(seed, H, W, D):
    rng = np.random.RandomState(seed)
    base = rng.randn(H, W + D).astype(np.float32)
    return base[:, D:], base[:, :-D]


@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_towers_bfloat16_match_apply_tower(arch):
    """-dtype bfloat16: the port's towers (bf16 operands, float32 sums,
    the bias added in float32 and one rounding, ReLU and the L2
    normalization on the rounded values, the output widened) against
    ``apply_tower(dtype=bfloat16)`` on the same weights. The float32 sums
    run in other orders, so a value near a rounding boundary may round
    one bf16 unit apart and carry that into the next layer: at least
    0.999 of the features equal, every one within four bf16 units
    (2^-6 relative) plus 1e-6."""
    cfg = make_config("kitti", arch, l1=3, fm=16, l2=2, nh2=32)
    tree, net = (_fast_params if arch == "fast" else _slow_params)(cfg)
    imgs = np.random.RandomState(5).randn(2, 30, 50).astype(np.float32)
    want = np.asarray(jtowers.apply_tower(
        tree, jnp.asarray(imgs)[..., None], arch=arch, padding="SAME",
        dtype=jnp.bfloat16))
    with torch.no_grad():
        got = net(torch.as_tensor(imgs)[:, None], torch.bfloat16)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.dtype == np.float32
    assert float((got == want).mean()) >= 0.999
    assert np.all(np.abs(got - want) <= 4 * ulp(want, "bfloat16") + 1e-6)


def test_slow_volumes_bfloat16_match_jax(interpret):
    """-dtype bfloat16 on the slow arch at narrow widths (l1=2, fm=8,
    l2=3, nh2=16), 24x80, D=12: the port's volumes (bf16 tower, A and B
    from bf16 features and first-layer weights summed in float32)
    against ``slow_volumes_mxu(..., dtype=bfloat16, interpret=True)`` on
    the JAX tower's bf16 features. Equal NaN masks; the head rounds the
    same operands to bf16 and sums in other orders (the float32 test's
    1e-4), and a tower feature one bf16 unit apart moves a score by up to
    about 2e-3: max |d| <= 2e-3, mean |d| <= 1e-4."""
    H, W, D = 24, 80, 12
    cfg = make_config("kitti", "slow", l1=2, fm=8, l2=3, nh2=16)
    tree, net = _slow_params(cfg)
    x0, x1 = _pair(9, H, W, D)
    feats = jtowers.apply_tower(tree, jnp.stack([jnp.asarray(x0),
                                                 jnp.asarray(x1)])[..., None],
                                arch="slow", padding="SAME",
                                dtype=jnp.bfloat16)
    want = slow_volumes_mxu(tree, feats[0], feats[1], D, dtype=jnp.bfloat16,
                            interpret=True)
    got = pipeline.slow_cost_volumes(net, torch.as_tensor(x0),
                                     torch.as_tensor(x1), D,
                                     dtype=torch.bfloat16)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.array_equal(np.isnan(g), np.isnan(w))
        diff = np.abs(g - w)[~np.isnan(w)]
        assert diff.max() <= 2e-3 and diff.mean() <= 1e-4


def test_disp_true_on_the_hwd_lane_is_the_exact_run():
    """mb fast (no outlier stage) at 40x150: a run padded to D = 64 with
    disp_true = 24 gives the exact D = 24 run's map, pixel for pixel, in
    float32 and in bf16 storage: the NaN lanes d >= 24 never win the WTA,
    never couple in the sweeps, and keep d at the subpixel boundary,
    exactly as the pad lanes of the exact run do (the same Dp = 128)."""
    H, W, D = 40, 150, 24
    x0, x1 = _pair(13, H, W, D)
    for vol_dtype in ("float32", "bfloat16"):
        cfg = make_config("mb", "fast", a="predict", vol_dtype=vol_dtype)
        tower = towers.init_fast(cfg, 2)
        exact = pipeline.stereo_predict(cfg, tower, x0, x1, D, device="cpu")
        padded = pipeline.stereo_predict(cfg, tower, x0, x1, 64,
                                         device="cpu", disp_true=D)
        assert torch.equal(exact, padded), vol_dtype
    # disp_true == disp_max is no bucketing at all
    again = pipeline.stereo_predict(cfg, tower, x0, x1, D, device="cpu",
                                    disp_true=D)
    assert torch.equal(again, exact)


@pytest.mark.parametrize("arch", ["census", "fast"])
def test_disp_true_on_the_generic_lane_matches_volumes_jit(arch):
    """The generic lane's volumes with disp_true = 9 of D = 16 against
    ``_volumes_jit(disp_true=9)``: the planes d >= 9 are the 1e9
    sentinel on both sides, the others equal (census bit for bit, the
    fast join within the 1e-6 of tests/test_torch_join.py); NaN masks
    equal."""
    H, W, D, dt = 20, 60, 16, 9
    cfg = make_config("kitti", arch)
    x0, x1 = _pair(21, H, W, D)
    tree, net = _fast_params(cfg) if arch == "fast" else (None, None)
    want = jpipe._volumes_jit(tree, jnp.asarray(x0), jnp.asarray(x1),
                              arch=arch, disp_max=D, ws=cfg.ws,
                              dtype_name="float32", use_pallas=False,
                              disp_true=dt)
    got = pipeline._volumes(net, torch.as_tensor(x0), torch.as_tensor(x1),
                            arch=arch, disp_max=D, ws=cfg.ws, disp_true=dt)
    for k in (-1, 1):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert (g[dt:] == 1e9).all() and (w[dt:] == 1e9).all()
        tol = 0.0 if arch == "census" else 1e-6
        assert np.nanmax(np.abs(g - w)) <= tol
    d = pipeline.stereo_predict(make_config("kitti", arch, a="predict"), net,
                                x0, x1, D, device="cpu", disp_true=dt)
    assert d.shape == (H, W) and bool(torch.isfinite(d).all())
    assert float(d.max()) < dt


@pytest.mark.parametrize("arch,over", [("slow", {}), ("census", {}),
                                       ("ad", {}), ("fast", dict(cbca_i1=2)),
                                       ("fast", dict(cbca_i2=1))])
@pytest.mark.parametrize("vol_dtype", ["bfloat16", "float16"])
def test_16bit_vol_dtype_off_the_hwd_lane_raises(arch, over, vol_dtype):
    """A 16-bit -vol_dtype on a generic-lane config raises ValueError
    naming vol_dtype, before any work, as ``check_vol_dtype`` does
    (mccnn_tpu/pipeline.py:457-460)."""
    cfg = make_config("kitti", arch, a="predict", vol_dtype=vol_dtype, **over)
    x = np.zeros((8, 16), np.float32)
    with pytest.raises(ValueError, match="vol_dtype"):
        pipeline.stereo_predict(cfg, None, x, x, 4, device="cpu")


def test_16bit_vol_dtype_in_a_scan_form_raises():
    """The scan forms send the fast arch to the generic lane, so a
    16-bit volume there raises too."""
    cfg = make_config("kitti", "fast", a="predict", vol_dtype="bfloat16")
    tower = towers.init_fast(cfg, 0)
    x = np.zeros((8, 16), np.float32)
    for form in ("stream", "grid"):
        with pytest.raises(ValueError, match="vol_dtype"):
            pipeline.stereo_predict(cfg, tower, x, x, 4, device="cpu",
                                    sgm_form=form)


@pytest.mark.parametrize("flags", [["-vol_dtype", "bfloat16"],
                                   ["-vol_dtype", "float16"],
                                   ["-dtype", "bfloat16"]])
def test_cli_predict_16bit_writes_float32_bins(tmp_path, monkeypatch, flags):
    """``kitti fast -a predict`` with a 16-bit volume or compute dtype
    writes the .bin dumps as raw float32, finite where in frame."""
    from PIL import Image

    rng = np.random.RandomState(5)
    h, w, d = 20, 60, 12
    base = (rng.rand(h, w + d) * 255).astype(np.uint8)
    Image.fromarray(base[:, :w]).save(tmp_path / "L.png")
    Image.fromarray(base[:, d:]).save(tmp_path / "R.png")
    monkeypatch.chdir(tmp_path)
    cli.main(["kitti", "fast", "-a", "predict", "-left", "L.png", "-right",
              "R.png", "-disp_max", str(d), "-backend", "cpu", *flags])
    for name, n in (("left", d * h * w), ("right", d * h * w),
                    ("disp", h * w)):
        arr = np.fromfile(tmp_path / f"{name}.bin", dtype=np.float32)
        assert arr.size == n, name
    disp = np.fromfile(tmp_path / "disp.bin", dtype=np.float32)
    assert np.isfinite(disp).all() and 0 <= disp.min() and disp.max() <= d


def test_wta_of_a_16bit_volume_is_the_wta_of_its_values():
    """The HWD lane without the SGM takes the winner of the stored
    volume: on a 16-bit volume, the winner of its widened values."""
    rng = np.random.RandomState(8)
    v = torch.as_tensor(rng.rand(5, 7, 128).astype(np.float32))
    v[..., 100:] = torch.nan
    b = v.to(torch.bfloat16)
    assert torch.equal(costs.wta_hwd(b), costs.wta_hwd(b.float()))
