"""The towers' convolutions of prediction (``ops/conv.py``, ``csrc/conv.cu``)
on the CPU: the plain version against the JAX package's
``conv_general_dilated`` (SAME, NHWC/HWIO) in float32 and in the bf16
lane, on seeded numpy inputs and weights carried across by
``params_from_numpy``; the split emulation's error budget (three levels
within 1e-6 of sum |w||x|, two measurably worse); the weight prepack's
layout against the offsets the kernel's descriptors address; its cache;
the tile plan's cover of the frame; and the towers' ``infer`` against
``apply_tower``. The kernels themselves are held to these plain versions
on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import gc
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.models import towers as jtowers
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.models import towers
from mccnn_tpu_torch.ops import _build, conv
from mccnn_tpu_torch.ops.join import _split

SRC = (Path(__file__).resolve().parents[1] / "mccnn_tpu_torch" / "csrc"
       / "conv.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(seed, N, Ci, Co, H, W):
    """Seeded NCHW input and an HWIO layer of the JAX tree, and the port's
    OIHW weight carried across by ``params_from_numpy``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, Ci, H, W).astype(np.float32)
    w = (rng.randn(3, 3, Ci, Co) / np.sqrt(9 * Ci)).astype(np.float32)
    b = np.zeros(Co, np.float32)
    net = towers.params_from_numpy({"tower": [{"w": w, "b": b}], "head": []})
    return x, w, net.convs[0].weight.detach()


def _jax_conv(x, w, dtype):
    h = jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)).astype(dtype),
        jnp.asarray(w).astype(dtype), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    return np.asarray(h).transpose(0, 3, 1, 2)


SHAPES = [(2, 1, 8, 9, 70), (1, 3, 16, 5, 33), (2, 8, 8, 11, 40),
          (1, 16, 16, 6, 17), (2, 16, 16, 1, 3)]


@pytest.mark.parametrize("N,Ci,Co,H,W", SHAPES)
def test_plain_conv_matches_jax_f32(N, Ci, Co, H, W):
    """``conv3x3_plain`` (and ``conv3x3`` on CPU tensors, which runs it)
    against ``conv_general_dilated`` in float32: atol 1e-5, as the
    tower's test (summation order)."""
    x, w, wt = _layer(N + Ci + Co + H, N, Ci, Co, H, W)
    want = _jax_conv(x, w, jnp.float32)
    got = conv.conv3x3_plain(torch.as_tensor(x), wt)
    assert got.dtype == torch.float32 and got.shape == (N, Co, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(conv.conv3x3(torch.as_tensor(x), wt), got)


@pytest.mark.parametrize("N,Ci,Co,H,W", SHAPES)
def test_plain_conv_matches_jax_bf16_lane(N, Ci, Co, H, W):
    """The bf16 lane: both round the input and the weights to bf16 and sum
    in float32 (``preferred_element_type``); the port takes the input as a
    bf16 tensor or as its float32 values alike."""
    x, w, wt = _layer(7 * N + Ci + H, N, Ci, Co, H, W)
    want = _jax_conv(x, w, jnp.bfloat16)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    got = conv.conv3x3_plain(xb, wt, torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(conv.conv3x3_plain(xb.float(), wt, torch.bfloat16),
                       got)
    assert torch.equal(conv.conv3x3(xb, wt, torch.bfloat16), got)


def _relative(got, x, wt):
    """max |got - the float64 convolution| / its sum |w||x|."""
    f = torch.nn.functional.conv2d
    ref = f(x.double(), wt.double(), None, padding=1)
    scale = f(x.double().abs(), wt.double().abs(), None, padding=1)
    return float(((got.double() - ref).abs() / scale.clamp_min(1e-300)).max())


@pytest.mark.parametrize("C,H,W", [(16, 9, 70), (64, 5, 33), (112, 4, 21)])
def test_split_emulation_error_budget(C, H, W):
    """``conv3x3_split_plain``: three bf16 levels (the float32 kernel's six
    products) within 1e-6 of sum |w||x| of the float64 convolution, as
    close as float32 itself; two levels (three products, the TPU join's
    split) measurably worse, past 1e-6 and ten times the three levels'
    gap: what the third level buys."""
    x, _, wt = _layer(C + H, 2, C, C, H, W)
    x = torch.as_tensor(x)
    e3 = _relative(conv.conv3x3_split_plain(x, wt, 3), x, wt)
    e2 = _relative(conv.conv3x3_split_plain(x, wt, 2), x, wt)
    e32 = _relative(conv.conv3x3_plain(x, wt), x, wt)
    assert e3 <= 1e-6 and e32 <= 1e-6, (e3, e32)
    assert e2 > 1e-6 and e2 > 10 * e3, (e2, e3)


def test_split_emulation_sums_the_kernels_products():
    """The products the kernel lists (``PA``, ``PB`` of
    ``issue_stage``) are the six pairs the emulation sums, i + j < 3
    (0-based), each once, hi.hi last (the sums it keeps apart)."""
    pa = [int(v) for v in re.search(r"constexpr int PA\[NP3\] = \{([^}]*)\}",
                                     SRC).group(1).split(",")]
    pb = [int(v) for v in re.search(r"constexpr int PB\[NP3\] = \{([^}]*)\}",
                                     SRC).group(1).split(",")]
    pairs = list(zip(pa, pb))
    assert len(pairs) == _const("NP3") == 6
    assert sorted(pairs) == sorted((i, j) for i in range(3) for j in range(3)
                                   if i + j < 3)
    assert pairs[-1] == (0, 0)
    # a ring stage of one weight level serves a run of products: the
    # weights' levels never rise along the list
    assert pb == sorted(pb, reverse=True)


def _unpack(packed):
    """The levels of ``pack_weights``, the largest first, each a (C_out,
    C_in, 3, 3) float32 tensor: the inverse of its layout."""
    nh, _, n_lv, ks, cg = packed.shape[:5]
    Co, Ci = 8 * cg * nh, 16 * ks
    return [packed[:, :, i].float().permute(1, 0, 3, 5, 2, 4, 6)
            .reshape(3, 3, Co, Ci).permute(2, 3, 0, 1)
            for i in reversed(range(n_lv))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("C", [64, 80, 96, 112])
def test_prepack_round_trips_and_addresses(C, dtype):
    """``pack_weights``: its levels are ``join._split``'s three (float32) or
    the weight rounded to the 16-bit dtype, and the inverse of its layout
    gives them back bit for bit; each value sits at the byte the kernel's
    descriptor for (pass, tap, level position, k16 step, 8-channel group,
    half of the step, row, element) addresses: ((pass * 9 + tap) * LV +
    position) * level bytes + k * NC * 32 + group * 256 + half * 128 + row
    * 16 + element * 2, level position LV - 1 - level."""
    w = torch.as_tensor(np.random.RandomState(C).randn(C, C, 3, 3)
                        .astype(np.float32))
    packed = conv.pack_weights(w, dtype)
    nh = conv.passes(C, dtype)
    lv = 3 if dtype == torch.float32 else 1
    assert packed.dtype == (torch.bfloat16 if dtype == torch.float32
                            else dtype)
    assert packed.shape == (nh, 9, lv, C // 16, C // 8 // nh, 2, 8, 8)
    levels = _unpack(packed)
    want = _split(w, 3) if lv == 3 else [w.to(dtype).float()]
    assert all(torch.equal(a, b) for a, b in zip(levels, want))
    nc = C // nh
    level_bytes = C * nc * 2
    flat = packed.view(-1)
    rng = np.random.RandomState(1)
    for _ in range(200):
        u, tap, b = rng.randint(nh), rng.randint(9), rng.randint(lv)
        k, j, h = rng.randint(C // 16), rng.randint(nc // 8), rng.randint(2)
        r, e = rng.randint(8), rng.randint(8)
        pos = lv - 1 - b
        at = (((u * 9 + tap) * lv + pos) * level_bytes + k * nc * 32 + j * 256
              + h * 128 + r * 16 + e * 2)
        co, ci = u * nc + 8 * j + r, 16 * k + 8 * h + e
        assert float(flat[at // 2]) == float(want[b][co, ci, tap // 3,
                                                      tap % 3])


def test_prepack_passes_match_the_kernel():
    """``passes`` mirrors ``Conf::NH``: two at C = 96 and 112 in float32
    (MODE 0), one otherwise; ``WIDTHS`` are the widths the launch
    dispatches to a wgmma instance, and ``FIRST_CIN`` the SIMT kernel's
    limit (an output channel's weights in its shared memory)."""
    assert re.search(r"NH = MODE == 0 && C > 80 \? 2 : 1;", SRC)
    assert conv.passes(112) == conv.passes(96) == 2
    assert conv.passes(112, torch.bfloat16) == conv.passes(80) == 1
    assert conv.passes(64) == conv.passes(64, torch.float16) == 1
    assert tuple(int(c) for c in re.findall(
        r"if \(C == (\d+)\) return \(int\)launch_width", SRC)) \
        == conv.WIDTHS == (64, 80, 96, 112)
    assert conv.FIRST_CIN == _const("FW") // 9


def test_prepack_cache_follows_the_weight():
    """The pack is made once for a weight and dtype, made anew after an
    in-place update (``_version``) or a new storage (``data_ptr``), and
    dropped with its weight."""
    w = torch.nn.Parameter(torch.randn(64, 64, 3, 3))
    first = conv.prepacked(w)
    assert conv.prepacked(w) is first
    assert conv.prepacked(w, torch.bfloat16) is not first
    with torch.no_grad():
        w.mul_(0.5)
    again = conv.prepacked(w)
    assert again is not first
    assert torch.equal(_unpack(again)[0],
                       _split(w.detach(), 3)[0])
    w.data = w.data.clone()
    assert conv.prepacked(w) is not again
    small = torch.randn(8, 1, 3, 3)
    assert torch.equal(conv.prepacked(small, torch.bfloat16),
                       small.to(torch.bfloat16).float())
    n = len(conv._PACKS)
    del w, first, again
    gc.collect()
    assert len(conv._PACKS) == n - 1


def test_tile_plan_covers_every_pixel_once():
    """The wgmma kernel's tiles (``TM`` columns x ``TR`` rows, decoded from
    the tile index as ``decode`` does, a warpgroup a row, its warps' rows
    16 w + g + 8 h) cover every output pixel of frames off the tile
    exactly once, the stores masked at the frame's edges."""
    TM, TR = _const("TM"), _const("TR")
    assert (TM, TR) == (64, 2)
    for N, H, W in ((2, 5, 70), (1, 1, 3), (1, 37, 131), (2, 4, 128)):
        seen = np.zeros((N, H, W), np.int64)
        n_tx, n_ty = -(-W // TM), -(-H // TR)
        for t in range(N * n_tx * n_ty):
            x0, y0, n = (t % n_tx) * TM, ((t // n_tx) % n_ty) * TR, \
                t // (n_tx * n_ty)
            for wg in range(TR):
                for m in range(TM):
                    y, x = y0 + wg, x0 + m
                    if y < H and x < W:
                        seen[n, y, x] += 1
        assert (seen == 1).all()


def test_conv3x3_refuses_what_it_does_not_take():
    """An unknown compute dtype raises on every device."""
    with pytest.raises(ValueError, match="compute dtype"):
        conv.conv3x3(torch.zeros(1, 1, 4, 4), torch.zeros(8, 1, 3, 3),
                     torch.float64)
    with pytest.raises(ValueError, match="C_out % 16"):
        conv.pack_weights(torch.zeros(8, 8, 3, 3))


@pytest.mark.parametrize("ks", [1, 5])
def test_plain_conv_is_same_padded_at_any_odd_kernel_size(ks):
    """On CPU tensors ``conv3x3`` (``conv3x3_plain``) pads by ks // 2, as
    ``_conv_acc`` and ``conv_general_dilated`` SAME do, so a tower of
    another kernel size still predicts on the CPU: atol 1e-5 from JAX."""
    rng = np.random.RandomState(ks)
    x = rng.randn(2, 8, 9, 21).astype(np.float32)
    w = (rng.randn(ks, ks, 8, 16) / np.sqrt(ks * ks * 8)).astype(np.float32)
    wt = towers.params_from_numpy(
        {"tower": [{"w": w, "b": np.zeros(16, np.float32)}], "head": []}
    ).convs[0].weight.detach()
    got = conv.conv3x3(torch.as_tensor(x), wt)
    assert got.shape == (2, 16, 9, 21)
    np.testing.assert_allclose(got.numpy(), _jax_conv(x, w, jnp.float32),
                               rtol=0, atol=1e-5)


def test_kernel_size_is_refused_on_cuda_before_a_run():
    """The CUDA kernels take 3 x 3 weights: ``check_kernel_size`` refuses
    another ``ks`` on CUDA (not on the CPU), and ``stereo_predict`` and
    ``action_train`` call it before any work (here with CUDA faked as the
    resolved device: the refusal comes before the tower or the data are
    touched)."""
    conv.check_kernel_size(3, "cuda")
    conv.check_kernel_size(5, "cpu")
    with pytest.raises(ValueError, match="ks = 3"):
        conv.check_kernel_size(5, torch.device("cuda"))
    from mccnn_tpu_torch import pipeline
    from mccnn_tpu_torch.train import trainer

    cfg = make_config("kitti", "fast", a="train_tr", ks=5)
    mp = pytest.MonkeyPatch()
    try:
        for mod in (pipeline, trainer):
            mp.setattr(mod, "resolve_device",
                       lambda device=None: torch.device("cuda"))

        def no_data(cfg):
            raise AssertionError("the data were loaded before the refusal")

        mp.setattr(trainer, "load_dataset", no_data)
        with pytest.raises(ValueError, match="ks = 3"):
            pipeline.stereo_predict(cfg, object(), None, None, 16,
                                    device="cuda")
        with pytest.raises(ValueError, match="ks = 3"):
            trainer.action_train(cfg, [], device="cuda")
    finally:
        mp.undo()


def _jax_nets(arch, dtype, ks=3):
    cfg = make_config("kitti", arch, l1=3, fm=16, l2=2, nh2=16, ks=ks)
    key = jax.random.PRNGKey(3)
    if arch == "fast":
        tree = jtowers.init_fast(key, l1=cfg.l1, fm=cfg.fm, ks=cfg.ks)
    else:
        tree = jtowers.init_slow(key, l1=cfg.l1, fm=cfg.fm, ks=cfg.ks,
                                 l2=cfg.l2, nh2=cfg.nh2)
    return tree, towers.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_infer_on_the_cpu_matches_jax(arch, dtype):
    """The whole tower through ``infer`` (the convolutions of
    ``conv.conv3x3`` on CPU tensors, then the tower kernels' plain
    versions) against ``apply_tower`` with SAME padding, on a frame off
    the kernel's tile: atol 1e-5 in float32; in bf16 within one bf16 ulp
    of the features (2^-8 relative), where a sum within float32 order of
    a rounding boundary rounds the other way; no kernel counted."""
    tree, net = _jax_nets(arch, dtype)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    x = np.random.RandomState(4).randn(2, 13, 70).astype(np.float32)
    want = np.asarray(jtowers.apply_tower(tree, x[..., None], arch=arch,
                                          padding="SAME", dtype=jdt))
    _build.reset_launches()
    got = net.infer(torch.as_tensor(x)[:, None], tdt).permute(0, 2, 3, 1)
    assert _build.launches()["tower_conv"] == 0
    tol = 1e-5 if dtype == "float32" else 2 ** -8 * max(
        1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_infer_on_the_cpu_matches_jax_at_kernel_size_5():
    """A fast tower of 5 x 5 kernels through ``infer`` on the CPU against
    ``apply_tower`` SAME: atol 1e-5 (the CPU path takes any odd ks)."""
    tree, net = _jax_nets("fast", "float32", ks=5)
    x = np.random.RandomState(6).randn(2, 13, 30).astype(np.float32)
    want = np.asarray(jtowers.apply_tower(tree, x[..., None], arch="fast",
                                          padding="SAME", dtype=jnp.float32))
    got = net.infer(torch.as_tensor(x)[:, None]).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
