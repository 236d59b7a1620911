"""The port's mesh inference (``mccnn_tpu_torch.parallel``, plain versions
on the CPU) against the JAX package's ``mccnn_tpu.parallel`` on the
conftest's eight virtual CPU devices, at the shapes of
tests/test_sharded_inference.py (32x48, D=8; 36x48 for rows that do not
split evenly); the slow arch at the narrow widths of
tests/test_torch_slow_pipeline.py. A port mesh of n CPU entries runs
every shard on the host, one after another."""

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
from mccnn_tpu.parallel import inference as jinf
from mccnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from mccnn_tpu_torch import pipeline
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.models import towers
from mccnn_tpu_torch.ops import costs, cross, join, sgm, slow_head
from mccnn_tpu_torch.parallel import inference, mesh as pmesh
from mccnn_tpu_torch.parallel.mesh import make_mesh

H, W, D = 32, 48, 8
NARROW = dict(l1=2, fm=8, l2=3, nh2=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread: many small ops, and with a test worker on
    every core the intra-op threads of each worker contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices("cpu")) == 8
    return jmake_mesh(8, backend="cpu")


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _batch(seed, B, h=H):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, h, W).astype(np.float32),
            rng.randn(B, h, W).astype(np.float32))


def _nets(cfg):
    """The JAX tree and the port's net converted from it."""
    key = jax.random.PRNGKey(cfg.seed)
    if cfg.arch == "fast":
        tree = jtowers.init_fast(key, l1=cfg.l1, fm=cfg.fm, ks=cfg.ks)
    else:
        tree = jtowers.init_slow(key, l1=cfg.l1, fm=cfg.fm, ks=cfg.ks,
                                 l2=cfg.l2, nh2=cfg.nh2)
    return tree, towers.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                 tree))


def _off(a, b) -> float:
    """Share of pixels more than 0.51 apart."""
    return float((np.abs(np.asarray(a) - np.asarray(b)) > 0.51).mean())


# --- the mesh ----------------------------------------------------------------

def test_make_mesh_axes_and_shape(monkeypatch):
    """The JAX package's semantics: one axis takes every device; a
    multi-axis mesh needs ``shape``; a split over an axis runs on index
    0 of the others. ``backend=None`` means CUDA and raises without a
    card; a Mesh takes any device array, one device repeated included."""
    m = make_mesh(8, backend="cpu")
    jm = jmake_mesh(8, backend="cpu")
    assert m.devices.shape == jm.devices.shape == (8,)
    assert m.axis_names == jm.axis_names == ("data",)
    assert make_mesh(backend="cpu").devices.shape == (1,)
    m2 = make_mesh(8, axes=("data", "model"), shape=(2, 4), backend="cpu")
    jm2 = jmake_mesh(8, axes=("data", "model"), shape=(2, 4), backend="cpu")
    assert m2.devices.shape == jm2.devices.shape == (2, 4)
    assert m2.entries("data") == [0, 4] and m2.entries("model") == [0, 1, 2, 3]
    assert m2.size == 8
    with pytest.raises(ValueError, match="shape required"):
        make_mesh(8, axes=("data", "model"), backend="cpu")
    with pytest.raises(ValueError, match="axis"):
        m2.along("rows")
    rep = pmesh.Mesh(np.array(["cpu", "cpu"]), ("data",))
    assert list(rep.devices) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2, backend="cuda")


def test_replicated_and_batch_sharded():
    """A module is copied for every entry, a tensor moved; a split along
    a dimension takes equal shards and refuses an uneven one."""
    m = make_mesh(4, backend="cpu")
    net = towers.init_fast(make_config("kitti", "fast", a="predict",
                                       l1=2, fm=8), 0)
    reps = pmesh.replicated(net, m)
    assert len(reps) == 4 and len({id(r) for r in reps}) == 4
    assert all(torch.equal(p, q) for r in reps
               for p, q in zip(r.parameters(), net.parameters()))
    x = torch.arange(24.0).reshape(8, 3)
    parts = pmesh.batch_sharded(x, m)
    assert [p.shape for p in parts] == [(2, 3)] * 4
    assert torch.equal(torch.cat(parts), x)
    with pytest.raises(ValueError, match="split evenly"):
        pmesh.batch_sharded(x, m, dim=1)


def test_splits_are_the_issued_shares():
    """370 rows in four (93, 93, 92, 92) and 1226 columns (307, 307,
    306, 306); more parts than rows leaves the empty ones out."""
    assert [b - a for a, b in inference.splits(370, 4)] == [93, 93, 92, 92]
    assert [b - a for a, b in inference.splits(1226, 4)] == [307, 307, 306,
                                                              306]
    assert inference.splits(3, 8) == [(0, 1), (1, 2), (2, 3)]


# --- the batch lanes ---------------------------------------------------------

@pytest.fixture(scope="module")
def census_batch(jmesh):
    """kitti census, B=8: the JAX batch lane's maps on its 8-device mesh."""
    x0b, x1b = _batch(7, 8)
    cfg = jmake_config("kitti", "census", a="predict")
    want = np.asarray(jinf.make_batch_predict_sharded(cfg, jmesh, D)(
        None, x0b, x1b))
    return x0b, x1b, want


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_batch_sharded_census_matches_jax(census_batch, n):
    """rtol 1e-5 against the JAX lane, the JAX test's tolerance."""
    x0b, x1b, want = census_batch
    cfg = make_config("kitti", "census", a="predict")
    got = inference.make_batch_predict_sharded(
        cfg, make_mesh(n, backend="cpu"), D)(None, x0b, x1b)
    assert got.shape == (8, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_batch_lane_outputs_equal_across_mesh_sizes(census_batch):
    """Each pair's work does not depend on the shard it lands in: equal
    maps at n = 1, 2, 4, 8 (test_batch_lane_scaling_curve_shard_
    independent), and each equal to its own single-pair prediction."""
    x0b, x1b, _ = census_batch
    cfg = make_config("kitti", "census", a="predict")
    outs = {n: inference.make_batch_predict_sharded(
        cfg, make_mesh(n, backend="cpu"), D)(None, x0b, x1b).numpy()
        for n in (1, 2, 4, 8)}
    for n in (2, 4, 8):
        np.testing.assert_array_equal(outs[n], outs[1])
    for b in (0, 5):
        np.testing.assert_array_equal(outs[1][b], pipeline.stereo_predict(
            cfg, None, x0b[b], x1b[b], D, device="cpu").numpy())


def test_batch_sharded_fast_matches_jax_hwd_body(interpret):
    """kitti fast takes the HWD lane, as the JAX factory takes
    ``_fast_hwd_body`` on the TPU: B=2 on a mesh of 2, each map equal to
    the port's own ``stereo_predict`` (which takes that lane), and the
    first against ``_fast_hwd_body`` with its Pallas kernels in
    interpret mode (one pair: its compile dominates): < 1% of pixels off
    by > 0.51 (WTA near-ties), the budget of
    tests/test_torch_pipeline.py."""
    cfg = make_config("kitti", "fast", a="predict")
    tree, net = _nets(cfg)
    x0b, x1b = _batch(3, 2)
    got = inference.make_batch_predict_sharded(
        cfg, make_mesh(2, backend="cpu"), D)(net, x0b, x1b).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], pipeline.stereo_predict(
            cfg, net, x0b[b], x1b[b], D, device="cpu").numpy())
    want = jpipe._fast_hwd_body(
        tree, jnp.asarray(x0b[0]), jnp.asarray(x1b[0]),
        jnp.asarray(jpost.gaussian_kernel(cfg.blur_sigma)), disp_max=D,
        kitti=True, ws=cfg.ws, dtype_name="float32", pi1=float(cfg.pi1),
        pi2=float(cfg.pi2), tau_so=float(cfg.tau_so), alpha1=float(cfg.alpha1),
        sgm_q1=float(cfg.sgm_q1), sgm_q2=float(cfg.sgm_q2),
        sgm_i=int(cfg.sgm_i), blur_t=float(cfg.blur_t),
        sm_terminate=cfg.sm_terminate, sm_skip=cfg.sm_skip, return_vols=False)
    assert np.isfinite(got).all()
    assert _off(got[0], want) < 0.01


@pytest.mark.parametrize("arch", ["census", "slow"])
def test_batch_predict_matches_jax(jmesh, arch):
    """The generic lane for every arch, B=8 on meshes of 8 (JAX) and 4
    (the port). census: rtol 1e-5. slow (narrow widths): the JAX lane
    runs its head in XLA float32 (``use_pallas=False``), the port's
    rounds the mid layers' operands to bf16 as its kernel does, so
    < 1% of pixels off by > 0.51."""
    over = NARROW if arch == "slow" else {}
    cfg = make_config("kitti", arch, a="predict", **over)
    jcfg = jmake_config("kitti", arch, a="predict", **over)
    tree, net = _nets(cfg) if arch == "slow" else (None, None)
    x0b, x1b = _batch(11, 8)
    want = np.asarray(jinf.make_batch_predict(jcfg, jmesh, D)(tree, x0b, x1b))
    got = inference.make_batch_predict(cfg, make_mesh(4, backend="cpu"), D)(
        net, x0b, x1b).numpy()
    assert got.shape == (8, H, W)
    if arch == "census":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.isfinite(got).all() and _off(got, want) < 0.01


def test_batch_lanes_refuse_an_uneven_split():
    cfg = make_config("kitti", "census", a="predict")
    x0b, x1b = _batch(1, 3)
    for make in (inference.make_batch_predict_sharded,
                 inference.make_batch_predict):
        with pytest.raises(ValueError, match="split evenly"):
            make(cfg, make_mesh(2, backend="cpu"), D)(None, x0b, x1b)


# --- the row-sharded pair ----------------------------------------------------

def test_row_sharded_census_matches_jax(jmesh):
    """32x48 on 8 devices: rtol 1e-5 against the JAX row-sharded lane,
    the JAX test's tolerance."""
    x0b, x1b = _batch(5, 1)
    jcfg = jmake_config("kitti", "census", a="predict")
    want = np.asarray(jinf.make_sharded_predict(jcfg, jmesh, D)(
        None, x0b[0], x1b[0]))
    cfg = make_config("kitti", "census", a="predict")
    got = inference.make_sharded_predict(cfg, make_mesh(8, backend="cpu"), D)(
        None, x0b[0], x1b[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_row_sharded_fast_matches_jax(jmesh):
    """kitti fast at 36x48 (36 rows do not split evenly in 8: 5, 5, 5,
    5, 4, 4, 4, 4) on 8 devices against the JAX row-sharded lane (its
    tower under GSPMD, its einsum join): < 1% of pixels off by > 0.51
    (the join sums in another order; WTA near-ties)."""
    x0b, x1b = _batch(11, 1, h=36)
    jcfg = jmake_config("kitti", "fast", a="predict")
    cfg = make_config("kitti", "fast", a="predict")
    tree, net = _nets(cfg)
    want = np.asarray(jinf.make_sharded_predict(jcfg, jmesh, D)(
        tree, x0b[0], x1b[0]))
    got = inference.make_sharded_predict(cfg, make_mesh(8, backend="cpu"), D)(
        net, x0b[0], x1b[0]).numpy()
    assert got.shape == (36, W) and np.isfinite(got).all()
    assert _off(got, want) < 0.01


@pytest.mark.parametrize("arch,over", [
    ("slow", NARROW),
    ("census", dict(L1=9, cbca_i1=2, cbca_i2=2, tau1=0.13)),
])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_row_sharded_equals_the_single_device_lane(arch, over, n):
    """The port's row-sharded pair against its own single-device
    generic lane (``stereo_predict``), max |d| <= 1e-5, at 36x48 on
    2, 4 and 8 entries: the slow tower's and the head's rows with their
    halo; CBCA over four iterations with L1 = 9, whose halo of 8 rows
    reaches past the 4- and 5-row shards of 8 entries into the shards
    beyond, the arms' row coordinates offset to each slab."""
    cfg = make_config("kitti", arch, a="predict", **over)
    net = towers.init_net(cfg)
    x0b, x1b = _batch(13, 1, h=36)
    want = pipeline.stereo_predict(cfg, net, x0b[0], x1b[0], D, device="cpu")
    got = inference.make_sharded_predict(cfg, make_mesh(n, backend="cpu"), D)(
        net, x0b[0], x1b[0])
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("form", ["stream", "grid"])
def test_row_sharded_scan_forms(monkeypatch, form):
    """The scan forms per shard (the vertical family's built D2 table
    sliced to the column shard) equal the single-device slab lane, max
    |d| <= 1e-5."""
    cfg = make_config("kitti", "census", a="predict")
    x0b, x1b = _batch(17, 1, h=36)
    want = pipeline.stereo_predict(cfg, None, x0b[0], x1b[0], D,
                                   device="cpu")
    monkeypatch.setattr(sgm, "resolve_form",
                        lambda f=None, _r=sgm.resolve_form: _r(f or form))
    got = inference.make_sharded_predict(cfg, make_mesh(4, backend="cpu"), D)(
        None, x0b[0], x1b[0])
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("arch", ["fast", "slow", "census"])
def test_row_sharded_shards_hold_their_share(monkeypatch, arch):
    """On four entries at 36x48, record the volumes that the join, the
    slow head, census, CBCA and the sweep kernels' wrappers receive: no
    shard of a (D, H, W) volume holds more than ceil(H/4) rows and its
    halo (the tower's l1 * (ks // 2) rows before the join and the head,
    which get none; census's 4; CBCA's K - 1), or ceil(W/4) columns in
    the vertical family, the two directions stacked (the counterpart of
    the JAX test's look at the compiled program)."""
    over = NARROW if arch == "slow" else {}
    cfg = make_config("kitti", arch, a="predict", **over)
    net = towers.init_net(cfg)
    h, n = 36, 4
    rows, cols = -(-h // n), -(-W // n)
    seen = []

    def record(mod, name, what, shape_of):
        orig = getattr(mod, name)

        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            seen.append((what, shape_of(a, out)))
            return out

        monkeypatch.setattr(mod, name, wrapped)

    record(join, "stereo_join_dhw", "join", lambda a, o: a[0].shape[0])
    record(slow_head, "slow_volumes", "head", lambda a, o: a[1].shape[0])
    record(costs, "census_volume", "census", lambda a, o: o.shape[1])
    record(cross, "cbca", "cbca", lambda a, o: a[2].shape[1])
    record(sgm, "_sweep_hslab", "hslab", lambda a, o: a[0].shape[1])
    record(sgm, "_sweep", "vertical", lambda a, o: a[0].shape[1])
    limit = {"join": rows, "head": rows, "census": rows + 2 * 4,
             "cbca": rows + 2 * (max(2, cfg.L1) - 1), "hslab": 2 * rows,
             "vertical": 2 * cols}
    x0b, x1b = _batch(19, 1, h=h)
    got = inference.make_sharded_predict(cfg, make_mesh(n, backend="cpu"), D)(
        net, x0b[0], x1b[0])
    assert got.shape == (h, W)
    kinds = {what for what, _ in seen}
    want_kinds = {"fast": {"join"}, "slow": {"head", "cbca"},
                  "census": {"census", "cbca"}}[arch] | {"hslab", "vertical"}
    assert kinds == want_kinds, kinds
    for what, size in seen:
        assert size <= limit[what], (what, size, limit[what])


# --- the vol_dtype contract --------------------------------------------------

def test_factories_guard_vol_dtype():
    """A 16-bit ``-vol_dtype`` raises wherever the lane is not the HWD
    one (the row-sharded and the generic batch lanes, and the sharded
    batch lane for a configuration the HWD lane does not take); the
    sharded batch lane takes it on kitti fast, as ``stereo_predict``
    does (float16 too: the card stores it)."""
    m = make_mesh(2, backend="cpu")
    fast16 = make_config("kitti", "fast", a="predict", vol_dtype="bfloat16")
    cbca16 = make_config("kitti", "fast", a="predict", vol_dtype="float16",
                         cbca_i1=2)
    for make in (inference.make_sharded_predict, inference.make_batch_predict):
        with pytest.raises(ValueError, match="vol_dtype"):
            make(fast16, m, D)
    with pytest.raises(ValueError, match="vol_dtype"):
        inference.make_batch_predict_sharded(cbca16, m, D)
    inference.make_batch_predict_sharded(fast16, m, D)
    inference.make_batch_predict_sharded(
        make_config("kitti", "fast", a="predict", vol_dtype="float16"), m, D)
