"""The training chunk's CUDA graph and the ``warp_patches`` kernel
(``csrc/warp.cu``) by what runs of them on the CPU.

- the fused gather and warp's plain version against the plain gather
  and warp, bit for bit, and against the JAX package's, on origins
  clipped to the padding and affines whose taps leave the window;
- a numpy transliteration of the kernel's arithmetic against the plain
  warp, bit for bit, with NaN, -0.0 and +-inf planted;
- the update's 0-d ``lr`` tensor against the float, bit for bit;
- the graph's body (``trainer._steps`` on ``chunk_buffers``) run eagerly
  against ``train_chunk`` bit for bit and against the JAX package's
  ``make_train_chunk``; ``make_train_chunk`` refusing the CPU.

Torch runs on one thread here (many small ops; see test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu import config as jconfig
from mccnn_tpu.cli import init_params
from mccnn_tpu.data import datasets as jdatasets
from mccnn_tpu.train import augment as jaugment
from mccnn_tpu.train import trainer as jtrainer
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.data import datasets
from mccnn_tpu_torch.models import towers
from mccnn_tpu_torch.ops import _build
from mccnn_tpu_torch.train import augment, trainer

WIN = augment.WIN
NARROW = dict(bs=16, l1=2, fm=16)
SLOW_NARROW = dict(bs=16, l1=2, fm=16, l2=2, nh2=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _plant(rng, a):
    """A copy of float32 ``a`` with NaN of two payloads, -0.0 and +-inf
    planted."""
    a = np.array(a, np.float32)
    flat = a.reshape(-1)
    flat[::97] = np.nan
    flat[3::89] = -0.0
    flat[5::83] = np.inf
    flat[7::79] = -np.inf
    flat[9::73] = np.array([0x7fc00123], np.int32).view(np.float32)[0]
    return a


def _affines(rng, B):
    """(B, 6) window-coordinate affines: rotations and scales about the
    window, translations that reach past every edge, and a few whose every
    tap leaves the window."""
    ang = rng.uniform(-0.6, 0.6, B)
    sc = rng.uniform(0.6, 1.6, B)
    tx = rng.uniform(-8, WIN - 2, B)
    ty = rng.uniform(-8, WIN - 2, B)
    tx[::7] = rng.choice([-45.0, WIN + 30.0], len(tx[::7]))
    ty[3::11] = rng.choice([-60.0, WIN + 40.0], len(ty[3::11]))
    return np.stack([sc * np.cos(ang), -sc * np.sin(ang), tx,
                     sc * np.sin(ang), sc * np.cos(ang), ty],
                    1).astype(np.float32)


def _photo(rng, B):
    return (rng.uniform(-0.7, 0.7, B).astype(np.float32),
            rng.uniform(0.7, 1.3, B).astype(np.float32))


def _stack(rng, N=3, H=40, W=56):
    """Images (N, 1, H, W) for both sides, and the port's padded stack."""
    X0 = rng.randn(N, 1, H, W).astype(np.float32)
    X1 = rng.randn(N, 1, H, W).astype(np.float32)
    return X0, X1


def _origins(rng, B, N, H, W):
    """(src, oy, ox) int32 over [0, 2N) x [-WIN, H] x [-WIN, W], the
    clipped extremes (all padding) included."""
    src = rng.randint(0, 2 * N, B).astype(np.int32)
    oy = rng.randint(-WIN, H + 1, B).astype(np.int32)
    ox = rng.randint(-WIN, W + 1, B).astype(np.int32)
    oy[:4] = [-WIN, H, -WIN, H]
    ox[:4] = [-WIN, W, W, -WIN]
    return src, oy, ox


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# --- the fused gather and warp ----------------------------------------------

@pytest.mark.parametrize("ws", [9, 11])
def test_gather_warp_plain_is_the_gather_then_the_warp(ws):
    """``gather_warp_plain`` equals ``warp_patches_plain`` of
    ``gather_windows_device``'s windows bit for bit, with NaN, -0.0 and
    +-inf planted in the stack; the CPU dispatch of both runs them."""
    rng = np.random.RandomState(ws)
    X0, X1 = _stack(rng)
    N, H, W = X0.shape[0], X0.shape[2], X0.shape[3]
    Xpad = augment.pad_image_stack(_plant(rng, X0), X1, torch.device("cpu"))
    B = 37
    src, oy, ox = _t(*_origins(rng, B, N, H, W))
    minv, bri, con = _t(_affines(rng, B), *_photo(rng, B))
    want = augment.warp_patches_plain(
        augment.gather_windows_device(Xpad, src, oy, ox), minv, bri, con,
        ws=ws)
    got = augment.gather_warp_plain(Xpad, src, oy, ox, minv, bri, con, ws=ws)
    assert got.shape == (B, ws, ws)
    assert np.array_equal(_bits(got), _bits(want))
    assert bool(got.isnan().any()) and bool(torch.isfinite(got).any())
    disp = augment.gather_warp(Xpad, src, oy, ox, minv, bri, con, ws=ws)
    assert np.array_equal(_bits(disp), _bits(want))
    win = augment.gather_windows_device(Xpad, src, oy, ox)
    disp = augment.warp_patches(win, minv, bri, con, ws=ws)
    assert np.array_equal(_bits(disp), _bits(want))


@pytest.mark.parametrize("ws", [9, 11])
def test_gather_warp_plain_matches_jax(ws):
    """The fused plain version against JAX's ``warp_patches`` of
    ``gather_windows_device``'s windows within 2e-5 (the tolerance of
    ``test_warp_patches_matches_jax``), on clipped origins and affines
    whose taps leave the window."""
    rng = np.random.RandomState(100 + ws)
    X0, X1 = _stack(rng)
    N, H, W = X0.shape[0], X0.shape[2], X0.shape[3]
    B = 40
    src, oy, ox = _origins(rng, B, N, H, W)
    minv = _affines(rng, B)
    bri, con = _photo(rng, B)
    jwin = jaugment.gather_windows_device(jaugment.pad_image_stack(X0, X1),
                                          src, oy, ox)
    want = np.asarray(jaugment.warp_patches(jwin, minv, bri, con, ws=ws))
    got = augment.gather_warp_plain(
        augment.pad_image_stack(X0, X1, torch.device("cpu")),
        *_t(src, oy, ox, minv, bri, con), ws=ws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # some patches lie wholly in the padding, some read the frame
    assert (np.abs(got - bri[:, None, None]) == 0).all(axis=(1, 2)).any()
    assert (np.abs(got).max(axis=(1, 2)) > 1.5).any()


def _kernel_warp(read, minv, bri, con, ws):
    """csrc/warp.cu's arithmetic in float32 numpy, op for op: every
    product and sum rounded on its own, the weights' constants, the taps
    dy outer and dx inner from +0.0, a tap read (``read(b, yy, xx)``)
    only inside the WIN x WIN window."""
    f = np.float32
    B = minv.shape[0]
    fi, fj = (a.astype(f) for a in np.meshgrid(np.arange(ws), np.arange(ws),
                                               indexing="ij"))
    m = minv[:, :, None, None]
    sx = (m[:, 0] * fj + m[:, 1] * fi) + m[:, 2]
    sy = (m[:, 3] * fj + m[:, 4] * fi) + m[:, 5]

    def w1(x):
        return ((f(1.25) * x - f(2.25)) * x) * x + f(1.0)

    def w2(x):
        return (((f(-0.75) * x - f(-3.75)) * x + f(-6.0)) * x) - f(-3.0)

    def cubic(t):
        return [w2(t + f(1)), w1(t), w1(f(1) - t), w2(f(2) - t)]

    x0, y0 = np.floor(sx), np.floor(sy)
    wx, wy = cubic(sx - x0), cubic(sy - y0)
    x0i, y0i = x0.astype(np.int64), y0.astype(np.int64)
    b = np.broadcast_to(np.arange(B)[:, None, None], x0i.shape)
    acc = np.zeros((B, ws, ws), f)
    with np.errstate(invalid="ignore", over="ignore"):
        for dy in range(4):
            yy = y0i + dy - 1
            for dx in range(4):
                xx = x0i + dx - 1
                ok = (yy >= 0) & (yy < WIN) & (xx >= 0) & (xx < WIN)
                v = np.where(ok, read(b, yy.clip(0, WIN - 1),
                                      xx.clip(0, WIN - 1)), f(0))
                acc = acc + (v * wy[dy]) * wx[dx]
        return acc * con[:, None, None] + bri[:, None, None]


@pytest.mark.parametrize("ws", [9, 11])
def test_kernel_arithmetic_is_the_plain_warp(ws):
    """The kernel's arithmetic, transliterated, equals both plain versions
    bit for bit (``.view(int32)``): from windows with NaN of two payloads,
    -0.0 and +-inf planted, and read in place from the padded stack at
    the window origins (the kernel's gather mode)."""
    rng = np.random.RandomState(7 * ws)
    B = 45
    minv = _affines(rng, B)
    bri, con = _photo(rng, B)
    win = _plant(rng, rng.randn(B, WIN, WIN))
    got = _kernel_warp(lambda b, y, x: win[b, y, x], minv, bri, con, ws)
    want = augment.warp_patches_plain(*_t(win, minv, bri, con), ws=ws)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.isnan(got).any() and np.isinf(got).any()

    X0, X1 = _stack(rng)
    N, H, W = X0.shape[0], X0.shape[2], X0.shape[3]
    Xpad = augment.pad_image_stack(_plant(rng, X0), _plant(rng, X1),
                                   torch.device("cpu"))
    src, oy, ox = _origins(rng, B, N, H, W)
    xp = Xpad.numpy()
    got = _kernel_warp(lambda b, y, x: xp[src[b], oy[b] + WIN + y,
                                          ox[b] + WIN + x],
                       minv, bri, con, ws)
    want = augment.gather_warp_plain(Xpad, *_t(src, oy, ox, minv, bri, con),
                                     ws=ws)
    assert np.array_equal(_bits(got), _bits(want))


# --- the update's lr tensor and the launch counts --------------------------

@pytest.mark.parametrize("lr", [0.003, 0.003 / 10, 0.002, 1e-4, 0.1 / 3])
def test_foreach_mul_by_a_0d_tensor_is_the_float_form(lr):
    """``torch._foreach_mul(grads, lr)`` with ``lr`` a 0-d float32 tensor
    (the graph's, which ``fill_`` sets) gives the float form's bits: both
    round ``lr`` to float32 once and multiply in float32."""
    rng = np.random.RandomState(1)
    grads = [torch.as_tensor(rng.randn(*s).astype(np.float32) * 10.0 ** e)
             for s, e in (((64, 1, 3, 3), -3), ((64,), 0), ((3, 5), 2),
                          ((7,), -30))]
    lr_t = torch.zeros((), dtype=torch.float32)
    lr_t.fill_(lr)
    for a, b in zip(torch._foreach_mul(grads, lr_t),
                    torch._foreach_mul(grads, lr)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_capture_counts_nothing_and_replays_count_what_they_run():
    """``_build.uncounted`` leaves the counts as they were and hands back
    what its block counted; ``add_counts`` records one replay of it."""
    _build.reset_launches()
    _build.count("join")
    with _build.uncounted() as counted:
        for _ in range(5):
            _build.count("warp_patches")
    assert _build.launches()["warp_patches"] == 0
    assert _build.launches()["join"] == 1
    for _ in range(3):
        _build.add_counts(*counted[0])
    assert _build.launches()["warp_patches"] == 15
    assert _build.kernel_launches()["warp_patches"] == 15
    assert "warp" in _build.SOURCES and "warp_patches" in _build.KERNELS
    _build.reset_launches()


# --- the graph's body, eagerly ---------------------------------------------

@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    jdatasets.make_synthetic_kitti(str(root / "data.kitti"), n_images=3,
                                   height=48, width=96, disp_max=12)
    return str(root)


def _setup(root, arch, device_gather, k, seed):
    kw = dict(SLOW_NARROW if arch == "slow" else NARROW, a="train_tr",
              data_dir=root)
    cfg = make_config("kitti", arch, **kw)
    jcfg = jconfig.make_config("kitti", arch, **kw)
    ds = datasets.load_kitti(cfg)
    X0 = np.asarray(ds.X0[:, 0])[:, None]
    X1 = np.asarray(ds.X1[:, 0])[:, None]
    bs_half = cfg.bs // 2

    def chunk(n, rs):
        rows = ds.nnz_tr[rs * n * bs_half % len(ds.nnz_tr):][:n * bs_half]
        return trainer.stack_chunk(
            augment.AugmentSampler(cfg, np.random.RandomState(rs)), ds, rows,
            n, bs_half, X0, X1, device_gather=device_gather)

    Xpad = (augment.pad_image_stack(X0, X1, torch.device("cpu"))
            if device_gather else None)
    return cfg, jcfg, chunk, Xpad, (X0, X1)


def _graph_body(cfg, net, mom, Xpad, n, chunk, lr):
    """What one replay runs, eagerly: the chunk copied into the static
    buffers, the 0-d lr tensor filled, the steps on the buffers."""
    bufs = trainer.chunk_buffers(chunk, torch.device("cpu"))
    trainer.fill_buffers(bufs, chunk)
    lr_t = torch.zeros((), dtype=torch.float32)
    lr_t.fill_(lr)
    return trainer._steps(cfg, net, mom, lr_t, bufs, Xpad)


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("arch,device_gather,k", [("fast", True, 5),
                                                  ("slow", False, 3)])
def test_graph_body_matches_train_chunk_and_jax(kitti_root, arch,
                                                device_gather, k):
    """The graph's body run eagerly on the CPU from static buffers (a tail
    of k < 32 steps) equals ``train_chunk`` bit for bit (losses, weights,
    momentum), and the JAX package's ``make_train_chunk`` at
    ``test_train_chunk_matches_jax``'s tolerances: losses within 1e-5
    relative, weights and momentum within 1e-6."""
    cfg, jcfg, chunk, Xpad, (X0, X1) = _setup(kitti_root, arch,
                                              device_gather, k, 6)
    c = chunk(k, 6)
    tree = jax.tree_util.tree_map(np.asarray, init_params(jcfg, seed=4))
    runs = []
    for body in (True, False):
        net = towers.params_from_numpy(tree)
        mom = [torch.zeros_like(p) for p in net.parameters()]
        if body:
            errs = _graph_body(cfg, net, mom, Xpad, k, c, cfg.lr)
        else:
            errs = trainer.train_chunk(
                cfg, net, mom, cfg.lr,
                {n: torch.as_tensor(v) for n, v in c.items()}, Xpad)
        runs.append((errs, net, mom))
    (e_g, net, mom), (e_e, net_e, mom_e) = runs
    assert _same(e_g, e_e)
    for a, b in zip(list(net.parameters()) + mom,
                    list(net_e.parameters()) + mom_e):
        assert _same(a.detach(), b.detach())

    jnp_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    jmom = jax.tree_util.tree_map(jnp.zeros_like, jnp_tree)
    jXpad = jaugment.pad_image_stack(X0, X1) if device_gather else None
    jp, jm, jerrs = jtrainer.make_train_chunk(jcfg, device_gather)(
        jnp_tree, jmom, jnp.float32(cfg.lr), c, jXpad)
    np.testing.assert_allclose(e_g.numpy(), np.asarray(jerrs), rtol=1e-5,
                               atol=1e-7)

    def leaves(t):
        return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                                t))
    for a, b in zip(leaves(towers.params_to_numpy(net)), leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(leaves(towers.params_to_numpy(net, mom)), leaves(jm)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert np.abs(b).max() > 0


def test_graph_body_over_a_full_chunk_a_tail_and_an_lr_change(kitti_root):
    """Two replays' bodies (a chunk of 32, then a tail of 3 at the lr
    dropped by 10, as at epoch 12) on one net equal two ``train_chunk``
    calls bit for bit."""
    cfg, _, chunk, Xpad, _ = _setup(kitti_root, "fast", True, 32, 8)
    chunks = [(chunk(32, 8), cfg.lr), (chunk(3, 9), cfg.lr / 10)]
    runs = []
    for body in (True, False):
        net = towers.init_net(cfg)
        mom = [torch.zeros_like(p) for p in net.parameters()]
        errs = []
        for c, lr in chunks:
            n = c["minv"].shape[0]
            if body:
                errs.append(_graph_body(cfg, net, mom, Xpad, n, c, lr))
            else:
                errs.append(trainer.train_chunk(
                    cfg, net, mom, lr,
                    {k: torch.as_tensor(v) for k, v in c.items()}, Xpad))
        runs.append((torch.cat(errs), list(net.parameters()) + mom))
    assert runs[0][0].shape == (35,)
    assert _same(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert _same(a.detach(), b.detach())


def test_chunk_buffers_take_stack_chunk_and_refuse_others(kitti_root):
    """The static buffers made from a chunk have ``stack_chunk``'s keys,
    shapes and dtypes (origins int32 with the device gather, windows
    without) and take its values; a chunk of other keys or shapes is
    refused."""
    for device_gather in (True, False):
        cfg, _, chunk, _, _ = _setup(kitti_root, "fast", device_gather, 4, 3)
        c = chunk(4, 3)
        bufs = trainer.chunk_buffers(c, torch.device("cpu"))
        assert set(bufs) == set(c) == (
            {"minv", "brightness", "contrast", "labels"}
            | ({"src", "oy", "ox"} if device_gather else {"windows"}))
        for k, v in c.items():
            assert bufs[k].shape == v.shape, k
            assert bufs[k].dtype == (torch.int32 if k in ("src", "oy", "ox")
                                     else torch.float32), k
        trainer.fill_buffers(bufs, c)
        for k, v in c.items():
            assert torch.equal(bufs[k], torch.as_tensor(v))
        with pytest.raises(ValueError, match="shape"):
            trainer.fill_buffers(bufs, chunk(3, 3))
        with pytest.raises(ValueError, match="keys"):
            trainer.fill_buffers(bufs, {k: v for k, v in c.items()
                                        if k != "labels"})


def test_make_train_chunk_refuses_the_cpu(kitti_root, monkeypatch):
    """The graph is CUDA's: on a CPU device ``make_train_chunk`` raises,
    and ``train()`` there runs the eager ``train_chunk`` (one epoch of
    3 steps, no graph asked for)."""
    cfg, _, _, Xpad, _ = _setup(kitti_root, "fast", True, 4, 3)
    net = towers.init_net(cfg)
    mom = [torch.zeros_like(p) for p in net.parameters()]
    with pytest.raises(ValueError, match="CUDA"):
        trainer.make_train_chunk(cfg, net, mom, Xpad, 4, "cpu")

    def no_graph(*a, **kw):
        raise AssertionError("train() on the CPU asked for a graph")

    eager = []
    orig = trainer.train_chunk
    monkeypatch.setattr(trainer, "make_train_chunk", no_graph)
    monkeypatch.setattr(trainer, "train_chunk",
                        lambda *a, **kw: eager.append(1) or orig(*a, **kw))
    ds = datasets.load_kitti(cfg)
    ds.nnz_tr = ds.nnz_tr[:3 * (cfg.bs // 2) + 1]
    lines = []
    trainer.train(cfg, ds, net, epochs=1, log=lines.append, device="cpu")
    assert eager == [1] and len(lines) == 1
