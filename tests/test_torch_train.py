"""The port's training path (plain torch on the CPU) against the JAX
package's: the bicubic warp, the device window gather, the losses,
``loss_fn``'s value and gradients in float32 and bf16, a chunk of SGD
steps, whole epochs across the lr drop, checkpoints and resume in both
directions, the evaluation actions and the command line. Narrow widths
(l1 = 2, fm = 16, bs = 16) wherever the full width is not the point;
the JAX runs are shared per module."""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu import config as jconfig
from mccnn_tpu.cli import init_params
from mccnn_tpu.cli import load_params as jload_params
from mccnn_tpu.data import datasets as jdatasets
from mccnn_tpu.models import checkpoint as jcheckpoint
from mccnn_tpu.models import towers as jtowers
from mccnn_tpu.train import augment as jaugment
from mccnn_tpu.train import evaluate as jevaluate
from mccnn_tpu.train import losses as jlosses
from mccnn_tpu.train import trainer as jtrainer
from mccnn_tpu_torch import cli
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.data import datasets
from mccnn_tpu_torch.models import checkpoint, towers
from mccnn_tpu_torch.train import augment, evaluate, losses, trainer

NARROW = dict(bs=16, l1=2, fm=16)
SLOW_NARROW = dict(bs=16, l1=2, fm=16, l2=2, nh2=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for this file's tests: many small ops, and
    with a test worker on every core the intra-op threads of each worker
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    """A JAX copy of a numpy tree: the JAX trainer donates (deletes) the
    trees it is given."""
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree):
    """The numpy leaves of a parameter tree in the JAX package's order."""
    return jax.tree_util.tree_leaves(_np(tree))


def _quiet(fn, *args, **kw):
    """(result, stdout) of ``fn``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue()


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    jdatasets.make_synthetic_kitti(str(root / "data.kitti"), n_images=3,
                                   height=48, width=96, disp_max=12)
    return str(root)


def _cfgs(root, arch="fast", **over):
    kw = dict(SLOW_NARROW if arch == "slow" else NARROW, a="train_tr",
              data_dir=root)
    kw.update(over)
    return (make_config("kitti", arch, **kw),
            jconfig.make_config("kitti", arch, **kw))


# --- the warp and the window gather ----------------------------------------

def _warp_f64(win, minv, bri, con, ws, a=-0.75):
    """The warp's formula in float64 (cv.cpp:19-45): the oracle both
    float32 versions are held to."""
    win, minv = win.astype(np.float64), minv.astype(np.float64)
    B, H, W = win.shape
    ys, xs = np.mgrid[0:ws, 0:ws].astype(np.float64)
    m = minv[:, :, None, None]
    sx = m[:, 0] * xs + m[:, 1] * ys + m[:, 2]
    sy = m[:, 3] * xs + m[:, 4] * ys + m[:, 5]

    def kern(t):
        t = np.abs(t)
        return np.where(t <= 1, ((a + 2) * t - (a + 3)) * t * t + 1,
                        np.where(t < 2, ((a * t - 5 * a) * t + 8 * a) * t
                                 - 4 * a, 0.0))

    acc = np.zeros((B, ws, ws))
    b = np.arange(B)[:, None, None]
    for dy in range(-1, 3):
        yy = np.floor(sy).astype(np.int64) + dy
        for dx in range(-1, 3):
            xx = np.floor(sx).astype(np.int64) + dx
            ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            v = win[b, yy.clip(0, H - 1), xx.clip(0, W - 1)] * ok
            acc += v * kern(sy - yy) * kern(sx - xx)
    return acc * con[:, None, None] + bri[:, None, None]


@pytest.mark.parametrize("ws", [9, 11])
def test_warp_patches_matches_jax(ws):
    """Random windows and affines whose samples reach past every edge of
    the window (zero fill) and land inside. Each float32 version lies
    within 2e-5 of the float64 evaluation of the formula, and the two
    within 2e-5 of each other (measured: 1.02e-5 and 1.19e-5 at most;
    near a tap boundary the outer cubic weights cancel terms up to 6, so
    a few ulps of 6 reach 1e-5); the port's taps add in the JAX loop's
    order. The port's version is ``warp_patches_plain``, the plain
    version of the warp kernel, which ``warp_patches`` runs on CPU
    tensors."""
    rng = np.random.RandomState(ws)
    B = 96
    win = rng.randn(B, augment.WIN, augment.WIN).astype(np.float32)
    ang = rng.uniform(-0.6, 0.6, B)
    sc = rng.uniform(0.6, 1.6, B)
    minv = np.stack([sc * np.cos(ang), -sc * np.sin(ang),
                     rng.uniform(-8, augment.WIN - 2, B),
                     sc * np.sin(ang), sc * np.cos(ang),
                     rng.uniform(-8, augment.WIN - 2, B)], 1).astype(np.float32)
    bri = rng.uniform(-0.7, 0.7, B).astype(np.float32)
    con = rng.uniform(0.7, 1.3, B).astype(np.float32)
    want = np.asarray(jaugment.warp_patches(win, minv, bri, con, ws=ws))
    got = augment.warp_patches_plain(*(torch.as_tensor(v) for v in
                                       (win, minv, bri, con)), ws=ws).numpy()
    exact = _warp_f64(win, minv, bri, con, ws)
    assert got.shape == want.shape == (B, ws, ws)
    np.testing.assert_allclose(got, exact, rtol=0, atol=2e-5)
    np.testing.assert_allclose(want, exact, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # some patches read the zero fill, some none
    edge = (minv[:, 2] < 2) | (minv[:, 5] < 2)
    assert edge.any() and (~edge).any()


def test_device_gather_equals_host_gather(kitti_root):
    """The port's window gather from the padded stack equals its host
    gather bit for bit, on one sampler stream drawn twice."""
    cfg, _ = _cfgs(kitti_root)
    ds = datasets.load_kitti(cfg)
    X0, X1 = np.asarray(ds.X0), np.asarray(ds.X1)
    rows = ds.nnz_tr[:40]
    host = augment.AugmentSampler(cfg, np.random.RandomState(2)) \
        .build_batches(X0, X1, rows)
    dev = augment.AugmentSampler(cfg, np.random.RandomState(2)) \
        .build_batches(X0, X1, rows, device_gather=True)
    Xpad = augment.pad_image_stack(X0, X1, torch.device("cpu"))
    got = augment.gather_windows_device(
        Xpad, *(torch.as_tensor(dev[k]) for k in ("src", "oy", "ox")))
    assert torch.equal(got, torch.as_tensor(host["windows"]))
    for k in ("minv", "brightness", "contrast", "labels"):
        np.testing.assert_array_equal(dev[k], host[k])


# --- losses -------------------------------------------------------------

@pytest.mark.parametrize("which", ["hinge1", "hinge2", "bce"])
def test_losses_match_jax(which):
    """Value within 1e-7 and gradient within 1e-8 (float32, the same
    elementwise operations and a mean)."""
    rng = np.random.RandomState(5)
    if which == "bce":
        x = rng.uniform(0.01, 0.99, 64).astype(np.float32)
        y = np.tile([0.0, 1.0], 32).astype(np.float32)

        def jf(v):
            return jlosses.bce(v, jnp.asarray(y))

        def tf(v):
            return losses.bce(v, torch.as_tensor(y))
    else:
        x = rng.uniform(-1, 1, 64).astype(np.float32)
        p = int(which[-1])

        def jf(v):
            return jlosses.hinge(v, margin=0.2, pow=p)

        def tf(v):
            return losses.hinge(v, margin=0.2, pow=p)
    want, gwant = jax.value_and_grad(jf)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tf(xt)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-7
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant), rtol=0,
                               atol=1e-8)


def _jax_loss_rounded(params, patches, labels, *, arch, m, pow):
    """The JAX package's ``loss_fn`` in bf16 with each convolution
    written as the float32 convolution of its bf16-rounded operands:
    the same rounding points (``apply_tower``: operands rounded, f32 sum
    plus bias, one round a layer), but differentiable. The package's own
    ``loss_fn`` is not in bf16: ``conv_general_dilated``'s transpose
    meets a bf16 kernel and an f32 cotangent and raises."""
    bf, f32 = jnp.bfloat16, jnp.float32
    h = patches[..., None].astype(bf)
    layers = params["tower"]
    for i, layer in enumerate(layers):
        h = jax.lax.conv_general_dilated(
            h.astype(f32), layer["w"].astype(bf).astype(f32), (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        h = (h + layer["b"]).astype(bf)
        if arch == "slow" or i < len(layers) - 1:
            h = jnp.maximum(h, 0)
    if arch == "fast":
        h = jtowers.l2_normalize(h)
    desc = h.astype(f32).reshape(h.shape[0], -1)
    if arch == "fast":
        return jlosses.hinge(jnp.sum(desc[0::2] * desc[1::2], axis=-1),
                             margin=m, pow=pow)
    pair = jnp.concatenate([desc[0::2], desc[1::2]], axis=-1)
    return jlosses.bce(jtowers.apply_head(params, pair, dtype=bf), labels)


# f32: both sum in float32 in other orders (conv, matmul, mean). bf16:
# the operands of every layer round to bf16 on both sides, so one
# summation-order difference at a bf16 rounding boundary moves a value
# by an ulp (2^-8 relative); the bounds are in units of the largest
# gradient of a tensor.
_LOSS_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (2e-3, 2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_loss_fn_value_and_grad_match_jax(kitti_root, arch, dtype):
    """``loss_fn``'s value and its gradient with respect to every weight
    (compared in the JAX layouts through ``params_to_numpy``) on warped
    patches of the synthetic set: in float32 against
    ``jax.value_and_grad`` of the JAX ``loss_fn``; in bf16 the value
    against the JAX ``loss_fn`` and the gradients against
    ``jax.value_and_grad`` of :func:`_jax_loss_rounded` (whose value
    equals the package's within 1e-6). |loss - loss_jax| <= tol_v, and
    each gradient within tol_g times the largest |gradient| of its
    tensor (``_LOSS_TOL`` per dtype)."""
    cfg, jcfg = _cfgs(kitti_root, arch, dtype=dtype)
    ds = datasets.load_kitti(cfg)
    b = augment.AugmentSampler(cfg, np.random.RandomState(8)).build_batches(
        np.asarray(ds.X0), np.asarray(ds.X1), ds.nnz_tr[:cfg.bs // 2])
    patches = augment.warp_patches(*(torch.as_tensor(b[k]) for k in (
        "windows", "minv", "brightness", "contrast")), ws=cfg.ws)
    tree = init_params(jcfg, seed=3)
    net = towers.params_from_numpy(_np(tree))
    kw = dict(arch=arch, m=cfg.m, pow=cfg.pow)
    jx, jy = jnp.asarray(patches.numpy()), jnp.asarray(b["labels"])
    want = jtrainer.loss_fn(tree, jx, jy, dtype=jnp.dtype(dtype), **kw)
    if dtype == "float32":
        _, gwant = jax.value_and_grad(jtrainer.loss_fn)(
            tree, jx, jy, dtype=jnp.float32, **kw)
    else:
        rounded, gwant = jax.value_and_grad(_jax_loss_rounded)(tree, jx, jy,
                                                               **kw)
        assert abs(float(rounded) - float(want)) <= 1e-6
    got = trainer.loss_fn(net, patches, torch.as_tensor(b["labels"]),
                          dtype=getattr(torch, dtype), **kw)
    grads = torch.autograd.grad(got, list(net.parameters()))
    tol_v, tol_g = _LOSS_TOL[dtype]
    assert abs(float(got) - float(want)) <= tol_v, (float(got), float(want))
    assert float(want) > 0
    for a, w in zip(_leaves(towers.params_to_numpy(net, grads)),
                    _leaves(gwant)):
        assert a.shape == w.shape
        scale = float(np.abs(w).max())
        assert scale > 0
        assert float(np.abs(a - w).max()) <= tol_g * scale, (
            float(np.abs(a - w).max()), scale)


# --- the SGD steps and the schedule --------------------------------------

@pytest.mark.parametrize("arch,device_gather", [("fast", True),
                                                ("slow", False)])
def test_train_chunk_matches_jax(kitti_root, arch, device_gather):
    """Six steps from the same batches against the JAX
    ``make_train_chunk`` (its ``lax.scan``): the per-step losses within
    1e-5 relative (1e-7 absolute: a mean of hinges may be near 0), and the weights and momentum after the chunk within
    1e-6 (float32; the sums run in other orders)."""
    cfg, jcfg = _cfgs(kitti_root, arch)
    ds = datasets.load_kitti(cfg)
    X0 = np.asarray(ds.X0[:, 0])[:, None]
    X1 = np.asarray(ds.X1[:, 0])[:, None]
    k, bs_half = 6, cfg.bs // 2
    rows = ds.nnz_tr[:k * bs_half]
    chunk = trainer.stack_chunk(
        augment.AugmentSampler(cfg, np.random.RandomState(6)), ds, rows, k,
        bs_half, X0, X1, device_gather=device_gather)
    tree = _np(init_params(jcfg, seed=4))
    net = towers.params_from_numpy(tree)
    jmom = jax.tree_util.tree_map(jnp.zeros_like, _jnp(tree))
    Xpad = jaugment.pad_image_stack(X0, X1) if device_gather else None
    jp, jm, jerrs = jtrainer.make_train_chunk(jcfg, device_gather)(
        _jnp(tree), jmom, jnp.float32(cfg.lr), chunk, Xpad)
    mom = [torch.zeros_like(p) for p in net.parameters()]
    errs = trainer.train_chunk(
        cfg, net, mom, cfg.lr, {n: torch.as_tensor(v) for n, v in
                                chunk.items()},
        augment.pad_image_stack(X0, X1, torch.device("cpu"))
        if device_gather else None)
    np.testing.assert_allclose(errs.numpy(), np.asarray(jerrs), rtol=1e-5,
                               atol=1e-7)
    for a, b in zip(_leaves(towers.params_to_numpy(net)), _leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(_leaves(towers.params_to_numpy(net, mom)), _leaves(jm)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert np.abs(b).max() > 0


def _epoch_lines(log):
    """(epoch, mean_err, lr) of each epoch line."""
    rows = [s.split("\t") for s in log if "\t" in s]
    return [(int(r[0]), float(r[1]), float(r[2])) for r in rows]


@pytest.fixture(scope="module")
def two_epochs(kitti_root):
    """Two epochs of kitti fast on the synthetic set (121 steps an
    epoch) from the same weights through both packages' ``train()``."""
    cfg, jcfg = _cfgs(kitti_root)
    tree = _np(init_params(jcfg))
    jds = jdatasets.load_kitti(jcfg)
    jlog = []
    jp, jm = jtrainer.train(jcfg, jds, _jnp(tree), epochs=2, log=jlog.append)
    ds = datasets.load_kitti(cfg)
    log = []
    net, mom = trainer.train(cfg, ds, towers.params_from_numpy(_np(tree)),
                             epochs=2, log=log.append, device="cpu")
    return dict(cfg=cfg, ds=ds, tree=tree, jlog=jlog, jp=jp, jm=jm,
                log=log, net=net, mom=mom)


def test_train_two_epochs_matches_jax(two_epochs):
    """The epoch lines (mean loss within 1e-6 relative, lr equal) and the
    weights and momentum after two epochs within 1e-6 (float32)."""
    r = two_epochs
    got, want = _epoch_lines(r["log"]), _epoch_lines(r["jlog"])
    assert [g[0] for g in got] == [1, 2] and [w[2] for w in want] == [
        g[2] for g in got]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-6)
    assert got[1][1] < got[0][1]  # it learns
    for a, b in zip(_leaves(towers.params_to_numpy(r["net"])),
                    _leaves(r["jp"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(_leaves(towers.params_to_numpy(r["net"], r["mom"])),
                    _leaves(r["jm"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_lr_drop_run_matches_jax(kitti_root, arch):
    """13 epochs on a table of 20 rows (2 steps an epoch): the lr falls
    to lr/10 at epoch 12, where the reference's momentum
    (v = mom*v - lr*g) and ``torch.optim.SGD``'s (v = mom*v + g, steps of
    lr*v) part. Epoch lines (the mean loss within 1e-5 relative, lr
    equal) and the final weights within 1e-5 against the JAX trainer;
    then SGD's rule from the same start is shown to leave the JAX weights
    by more than that."""
    cfg, jcfg = _cfgs(kitti_root, arch)
    ds = datasets.load_kitti(cfg)
    jds = jdatasets.load_kitti(jcfg)
    ds.nnz_tr = jds.nnz_tr = np.asarray(ds.nnz_tr[:20])
    tree = _np(init_params(jcfg, seed=7))
    jlog, log = [], []
    jp, _ = jtrainer.train(jcfg, jds, _jnp(tree), epochs=13, log=jlog.append)
    net, _ = trainer.train(cfg, ds, towers.params_from_numpy(_np(tree)),
                           epochs=13, log=log.append, device="cpu")
    got, want = _epoch_lines(log), _epoch_lines(jlog)
    assert [g[2] for g in got] == [w[2] for w in want]
    assert got[10][2] == cfg.lr and got[11][2] == cfg.lr / 10
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-5)
    jleaves = _leaves(jp)
    for a, b in zip(_leaves(towers.params_to_numpy(net)), jleaves):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)

    # the same run under torch.optim.SGD's momentum
    sgd_net = towers.params_from_numpy(_np(tree))
    opt = torch.optim.SGD(sgd_net.parameters(), lr=cfg.lr, momentum=cfg.mom)

    def sgd_chunk(cfg_, net_, mom_, lr, chunk, Xpad=None):
        for g in opt.param_groups:
            g["lr"] = lr
        errs = []
        for s in range(chunk["minv"].shape[0]):
            patches = augment.warp_patches(
                augment.gather_windows_device(Xpad, chunk["src"][s],
                                              chunk["oy"][s], chunk["ox"][s]),
                chunk["minv"][s], chunk["brightness"][s],
                chunk["contrast"][s], ws=cfg_.ws)
            opt.zero_grad()
            err = trainer.loss_fn(net_, patches, chunk["labels"][s],
                                  arch=arch, m=cfg_.m, pow=cfg_.pow)
            err.backward()
            opt.step()
            errs.append(err.detach())
        return torch.stack(errs)

    orig = trainer.train_chunk
    trainer.train_chunk = sgd_chunk
    try:
        trainer.train(cfg, ds, sgd_net, epochs=13, log=lambda s: None,
                      device="cpu")
    finally:
        trainer.train_chunk = orig
    gap = max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(towers.params_to_numpy(sgd_net)), jleaves))
    assert gap > 1e-5, gap


def test_subset_matches_jax(kitti_root):
    """``-subset 0.5`` on KITTI (one of the two training images, drawn
    from RandomState(seed)): one epoch's line equal to the JAX
    trainer's within 1e-6 relative. On Middlebury the draw is per
    generation (main.lua:630-640): int(n * subset) ids of each of the
    five id ranges, the same ids for the same seed."""
    cfg, jcfg = _cfgs(kitti_root, subset=0.5)
    tree = _np(init_params(jcfg))
    jlog, log = [], []
    jtrainer.train(jcfg, jdatasets.load_kitti(jcfg), _jnp(tree), epochs=1,
                   log=jlog.append)
    trainer.train(cfg, datasets.load_kitti(cfg),
                  towers.params_from_numpy(tree), epochs=1, log=log.append,
                  device="cpu")
    got, want = _epoch_lines(log), _epoch_lines(jlog)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-6)

    mcfg = make_config("mb", "fast", subset=0.5)
    fake = datasets.StereoDataset("mb", 0, 0, 0, 1, 0)
    nnz = np.repeat(np.arange(1, 61, dtype=np.float32), 2)[:, None] \
        * np.ones((1, 4), np.float32)
    kept = np.unique(trainer._subset(mcfg, fake, nnz)[:, 0]).astype(int)
    for lo, hi in ((11, 23), (24, 44), (45, 50), (51, 52), (53, 60)):
        n = int((hi - lo + 1) * 0.5)
        assert ((kept >= lo) & (kept <= hi)).sum() == n
    assert len(kept) == 6 + 10 + 3 + 1 + 4
    np.testing.assert_array_equal(
        kept, np.unique(trainer._subset(mcfg, fake, nnz)[:, 0]).astype(int))


def test_resume_equals_uninterrupted(two_epochs, tmp_path):
    """One epoch, a checkpoint (momentum and epoch), a load, one more
    epoch: equal to the two epochs in one go, bit for bit (the same
    operations on the CPU, and the per-epoch seeding replays the
    stream)."""
    r = two_epochs
    cfg, ds = r["cfg"], r["ds"]
    cfg.checkpoint_every = 1
    saved = {}

    def save_cb(epoch, net, mom):
        saved["f"] = checkpoint.save(str(tmp_path / f"ck_{epoch}.npz"), net,
                                     {"epoch": epoch}, extra={"momentum": mom})

    try:
        trainer.train(cfg, ds, towers.params_from_numpy(r["tree"]), epochs=1,
                      save_cb=save_cb, log=lambda s: None, device="cpu")
    finally:
        cfg.checkpoint_every = 0
    net, opt, extras = checkpoint.load(saved["f"])
    assert opt["epoch"] == 1
    net, mom = trainer.train(cfg, ds, net, momentum=extras["momentum"],
                             epochs=2, start_epoch=opt["epoch"] + 1,
                             log=lambda s: None, device="cpu")
    for a, b in zip(net.parameters(), r["net"].parameters()):
        assert torch.equal(a, b)
    for a, b in zip(mom, r["mom"]):
        assert torch.equal(a, b)


def test_checkpoints_cross_packages(two_epochs, tmp_path):
    """A checkpoint of the port (weights, momentum, epoch) loads in the
    JAX package and one of the JAX package in the port, bit for bit in
    the other's layouts; slow nets too."""
    r = two_epochs
    net, mom = r["net"], r["mom"]
    fname = checkpoint.save(str(tmp_path / "port.npz"), net, {"epoch": 2},
                            extra={"momentum": mom})
    tmpl = r["tree"]
    jp, opt, extras = jcheckpoint.load(
        fname, tmpl, {"momentum": jax.tree_util.tree_map(np.zeros_like,
                                                         tmpl)})
    assert opt["epoch"] == 2
    for a, b in zip(_leaves(jp), _leaves(towers.params_to_numpy(net))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(extras["momentum"]),
                    _leaves(towers.params_to_numpy(net, mom))):
        np.testing.assert_array_equal(a, b)

    jfname = jcheckpoint.save(str(tmp_path / "jax.npz"), r["jp"],
                              {"epoch": 5}, extra={"momentum": r["jm"]})
    net2, opt2, extras2 = checkpoint.load(jfname)
    assert isinstance(net2, towers.FastTower) and opt2["epoch"] == 5
    for a, b in zip(_leaves(towers.params_to_numpy(net2)), _leaves(r["jp"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(towers.params_to_numpy(net2, extras2["momentum"])),
                    _leaves(r["jm"])):
        np.testing.assert_array_equal(a, b)

    scfg = jconfig.make_config("kitti", "slow", **SLOW_NARROW)
    stree = _np(init_params(scfg))
    snet = towers.params_from_numpy(stree)
    sname = checkpoint.save(str(tmp_path / "slow.npz"), snet, {})
    sp, _, _ = jcheckpoint.load(sname, stree)
    for a, b in zip(_leaves(sp), _leaves(stree)):
        np.testing.assert_array_equal(a, b)
    assert isinstance(checkpoint.load(sname)[0], towers.SlowNet)


# --- evaluation ------------------------------------------------------------

def test_action_eval_score_matches_jax(tmp_path, capsys):
    """``test_te`` on a synthetic KITTI set with occlusions
    (``ds.disp_max`` overridden as tests/test_contracts.py does), the
    same converted net: the score, the last stdout token, equals the JAX
    package's within one pixel's share (the JAX package runs its generic
    lane on the CPU, the port its HWD lane: the maps may part at a WTA
    near-tie)."""
    jdatasets.make_synthetic_kitti(str(tmp_path / "data.kitti"), n_images=2,
                                   height=40, width=96, disp_max=16,
                                   occlusions=True)
    cfg = make_config("kitti", "fast", a="test_te", data_dir=str(tmp_path),
                      **NARROW)
    jcfg = jconfig.make_config("kitti", "fast", a="test_te",
                               data_dir=str(tmp_path), **NARROW)
    ds, jds = datasets.load_kitti(cfg), jdatasets.load_kitti(jcfg)
    ds.disp_max = jds.disp_max = 16
    tree = init_params(jcfg, seed=1)
    jevaluate.action_eval(jcfg, [], params=tree, ds=jds)
    want = float(capsys.readouterr().out.split()[-1])
    evaluate.action_eval(cfg, [], net=towers.params_from_numpy(_np(tree)),
                         ds=ds, device="cpu")
    out = capsys.readouterr().out.split()
    got = float(out[-1])
    n_gt = int((np.asarray(ds.dispnoc[int(ds.te[0]) - 1]) != 0).sum())
    assert 0.0 < want < 1.0 and len(out) == 3
    assert abs(got - want) <= 1.0 / n_gt


def test_bucketed_predict_mb_matches_jax(tmp_path):
    """mb fast at Middlebury's buckets: 40x80 edge-padded to 64x128 and
    D = 10 padded to 64 (masked past 10), cropped back; against the JAX
    ``bucketed_predict`` on the same converted net: the same shape, every
    value finite and < 1% of pixels off by > 0.51 (a WTA near-tie), and
    the crop equal to the exact-shape run wherever the padding does not
    reach (here: equal on > 90% of the pixels)."""
    jdatasets.make_synthetic_mb(str(tmp_path / "data.mb.imperfect_gray"),
                                n_images=2, height=40, width=80, disp_max=10)
    cfg = make_config("mb", "fast", a="test_te", data_dir=str(tmp_path),
                      **NARROW)
    jcfg = jconfig.make_config("mb", "fast", a="test_te",
                               data_dir=str(tmp_path), **NARROW)
    ds = datasets.load_mb(cfg)
    x0, x1 = (np.array(ds.X[0][0][k, 0]) for k in (0, 1))
    tree = init_params(jcfg, seed=2)
    net = towers.params_from_numpy(_np(tree))
    want = np.asarray(jevaluate.bucketed_predict(jcfg, tree, x0, x1, 10))
    got = evaluate.bucketed_predict(cfg, net, x0, x1, 10, device="cpu").numpy()
    assert got.shape == want.shape == (40, 80) and np.isfinite(got).all()
    assert float((np.abs(got - want) > 0.51).mean()) < 0.01
    exact = make_config("mb", "fast", a="test_te", bucket_hw=0, bucket_d=0,
                        **NARROW)
    same = evaluate.bucketed_predict(exact, net, x0, x1, 10,
                                     device="cpu").numpy()
    assert float((np.abs(got - same) <= 0.51).mean()) > 0.9


def test_debug_dump_matches_jax(tmp_path, monkeypatch):
    """``-debug``'s three PNGs (GT, prediction, error overlay in jet,
    main.lua:1240-1266) equal the JAX package's byte for byte on the
    same maps."""
    rng = np.random.RandomState(4)
    pred = rng.uniform(0, 20, (24, 40)).astype(np.float32)
    actual = np.where(rng.rand(24, 40) < 0.5, 0.0,
                      pred + rng.uniform(-5, 5, (24, 40))).astype(np.float32)
    x0 = rng.randn(24, 40).astype(np.float32)
    for pkg, mod in (("j", jevaluate), ("t", evaluate)):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        mod._debug_dump(make_config("kitti", "fast", debug=True), 7, pred,
                        actual, x0, 24)
    _names = sorted(os.listdir(tmp_path / "t" / "tmp"))
    assert _names == sorted(os.listdir(tmp_path / "j" / "tmp")) \
        and len(_names) == 3
    for name in _names:
        assert (tmp_path / "t" / "tmp" / name).read_bytes() == \
            (tmp_path / "j" / "tmp" / name).read_bytes(), name


@pytest.mark.parametrize("arch", ["fast", "slow"])
@pytest.mark.parametrize("action", ["test_te", "test_all", "submit"])
def test_load_params_exits_without_net_fname(arch, action):
    """The evaluation actions of a learned arch need -net_fname
    (main.lua:892-902), as in the JAX package."""
    with pytest.raises(SystemExit, match="net_fname"):
        cli.load_params(make_config("kitti", arch, a=action))
    with pytest.raises(SystemExit):
        jload_params(jconfig.make_config("kitti", arch, a=action))


@pytest.mark.parametrize("action", ["time", "predict"])
def test_load_params_seeds_for_time_and_predict(action, capsys):
    net = cli.load_params(make_config("kitti", "fast", a=action, **NARROW))
    assert isinstance(net, towers.FastTower)
    assert "WARNING" in capsys.readouterr().out
    assert cli.load_params(make_config("kitti", "census", a=action)) is None


def test_cli_train_tr_saves_and_chains_test_te(tmp_path, monkeypatch,
                                               capsys):
    """``-a train_tr -backend cpu`` on a tiny synthetic set: 14 epochs
    (the lr drop printed at 12), ``net/net_<cmd_str>.npz`` written and
    loadable, then the chained test_te's score as the last token (at
    KITTI's D = 228, which the command line keeps); then ``-a test_te
    -net_fname`` of that file gives the same score, and ``-a test_all``
    scores the training and the te image."""
    jdatasets.make_synthetic_kitti(str(tmp_path / "data.kitti"), n_images=2,
                                   height=24, width=48, disp_max=8)
    monkeypatch.chdir(tmp_path)
    tail = ["-backend", "cpu", "-data_dir", str(tmp_path), "-bs", "16",
            "-l1", "2", "-fm", "16"]
    cli.main(["kitti", "fast", "-a", "train_tr"] + tail)
    lines = capsys.readouterr().out.strip().splitlines()
    epochs = _epoch_lines(lines)
    assert [e[0] for e in epochs] == list(range(1, 15))
    assert epochs[10][2] == 0.002 and epochs[11][2] == 0.0002
    name = "net/net_kitti_fast_-a_train_tr_" + "_".join(tail) + ".npz"
    net, opt, _ = checkpoint.load(name)
    assert isinstance(net, towers.FastTower) and opt["cfg"]["a"] == "train_tr"
    score = float(lines[-1].split()[-1])
    assert 0.0 <= score <= 1.0
    cli.main(["kitti", "fast", "-a", "test_te", "-net_fname", name] + tail)
    assert float(capsys.readouterr().out.split()[-1]) == score
    cli.main(["kitti", "fast", "-a", "test_all", "-net_fname", name] + tail)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4  # argv, the train image, the te image, the mean
    assert 0.0 <= float(lines[-1]) <= 1.0


def test_submit_writes_png16_and_pfm(tmp_path, monkeypatch, capsys):
    """``-a submit``: KITTI's GT-less slab as 16-bit PNGs whose decode is
    the prediction (256x scale, 0 = invalid) and the zip of exactly those
    files; Middlebury's PFM (rows flipped) and runtime files; the JAX
    package's names and layouts (tests/test_contracts.py,
    tests/test_mb.py)."""
    from mccnn_tpu_torch.data.pfm import read_pfm
    from mccnn_tpu_torch.data.png16 import read_png16

    jdatasets.make_synthetic_kitti(str(tmp_path / "data.kitti"), n_images=2,
                                   height=40, width=80, disp_max=8,
                                   n_test_images=2)
    jdatasets.make_synthetic_mb(str(tmp_path / "data.mb.imperfect_gray"),
                                n_images=2, height=40, width=80, disp_max=10)
    monkeypatch.chdir(tmp_path)
    cfg = make_config("kitti", "ad", a="submit", data_dir=str(tmp_path))
    ds = datasets.load_kitti(cfg)
    ds.disp_max, ds.height, ds.n_te = 8, 40, 2
    evaluate.action_eval(cfg, [], ds=ds, device="cpu")
    assert "wrote out/submission.zip (2 files)" in capsys.readouterr().out
    for row in (2, 3):
        name = f"{int(ds.metadata[row, 2]):06d}_10.png"
        want = evaluate.bucketed_predict(cfg, None, np.array(ds.X0[row, 0]),
                                         np.array(ds.X1[row, 0]), 8,
                                         device="cpu").numpy()
        want = np.where(want < 1e-5, 0.0, np.floor(want * 256) / 256)
        np.testing.assert_array_equal(read_png16(os.path.join("out", name)),
                                      want)
    import zipfile
    with zipfile.ZipFile("out/submission.zip") as z:
        assert sorted(z.namelist()) == ["000002_10.png", "000003_10.png"]

    mcfg = make_config("mb", "fast", a="submit", data_dir=str(tmp_path),
                       **NARROW)
    mds = datasets.load_mb(mcfg)
    net = towers.init_net(mcfg)
    evaluate.action_eval(mcfg, [], net=net, ds=mds, device="cpu")
    assert "(4 files)" in capsys.readouterr().out
    got = read_pfm("out/trainingH/synth1/disp0MC-CNN-fst.pfm")[::-1]
    want = evaluate.bucketed_predict(mcfg, net, np.array(mds.X[0][0][0, 0]),
                                     np.array(mds.X[0][0][1, 0]), 10,
                                     device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert os.path.exists("out/trainingH/synth2/timeMC-CNN-fst.txt")


def test_training_and_evaluation_raise_without_cuda(kitti_root, monkeypatch):
    """``device=None`` means the card (``-backend`` unset): with no CUDA
    the trainer and the evaluation raise, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _cfgs(kitti_root)
    ds = datasets.load_kitti(cfg)
    net = towers.init_net(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.train(cfg, ds, net, epochs=1, log=lambda s: None)
    cfg.a = "test_te"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.action_eval(cfg, [], net=net, ds=ds)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.action_train(make_config("kitti", "fast", a="train_tr",
                                         data_dir=kitti_root), [])
