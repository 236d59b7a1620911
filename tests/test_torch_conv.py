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

import collections
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
    """The products the kernel lists (``PA``, ``PB`` of ``group``) are
    the six pairs the emulation sums, i + j < 3 (0-based), each once,
    hi.hi last (the sums it keeps apart), in the order of
    ``conv3x3_tile_plain``; its groups, committed apart, are the runs of
    one weight level."""
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
    assert (tuple(pa), tuple(pb)) == (conv.PA, conv.PB)
    group = [int(v) for v in re.search(
        r"constexpr int GROUP\[4\] = \{([^}]*)\}", SRC).group(1).split(",")]
    assert [pb[group[j]:group[j + 1]] for j in range(3)] == [[2], [1, 1],
                                                             [0, 0, 0]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 112])
@pytest.mark.parametrize("N,H,W", [(2, 5, 70), (1, 3, 131)])
def test_tile_emulation_matches_the_split(N, C, H, W, dtype):
    """``conv3x3_tile_plain``, the wgmma kernel's staged A tile (its level
    planes [level][group][pixel][8], zero halo) read at the ``ldmatrix``
    rows' addresses with its order of products, within 1e-6 of sum
    |w||x| of ``conv3x3_split_plain`` (three levels) on frames that do not
    divide into whole tiles, at C = 64 (two rows a tile) and 112 (one row
    in float32, the two channel halves), in float32 and in the bf16 lane
    (the operands rounded to bf16: one product)."""
    rng = np.random.RandomState(C + H + W)
    x = torch.as_tensor(rng.randn(N, C, H, W).astype(np.float32))
    w = torch.as_tensor((rng.randn(C, C, 3, 3) / np.sqrt(9 * C))
                        .astype(np.float32))
    xr, wr = (x, w) if dtype == torch.float32 else (
        x.to(dtype).float(), w.to(dtype).float())
    got = conv.conv3x3_tile_plain(xr, w, dtype)
    want = conv.conv3x3_split_plain(xr, wr, 3)
    scale = torch.nn.functional.conv2d(xr.abs(), wr.abs(), padding=1)
    assert got.shape == (N, C, H, W)
    err = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
    assert err <= 1e-6, err


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_fused_plain_route_is_the_bias_pass(dtype, relu):
    """On CPU tensors ``conv3x3(..., bias, relu)`` is
    ``tower.bias_act_plain`` on ``conv3x3_plain`` bit for bit, and so is
    ``conv3x3_unfused`` (the bias-free convolution, then ``tower.bias_act``,
    whose plain version runs on the CPU), with NaN, -0.0 and +-inf in the
    bias; no kernel counted."""
    from mccnn_tpu_torch.ops import tower

    rng = np.random.RandomState(11)
    x = torch.as_tensor(rng.randn(2, 16, 7, 33).astype(np.float32))
    x = x.to(dtype).float()
    w = torch.as_tensor((rng.randn(16, 16, 3, 3) / 12).astype(np.float32))
    b = torch.as_tensor(rng.randn(16).astype(np.float32))
    b[0], b[1], b[2], b[3] = -0.0, float("nan"), float("inf"), -float("inf")
    _build.reset_launches()
    want = tower.bias_act_plain(conv.conv3x3_plain(x, w, dtype), b, relu,
                                dtype)
    got = conv.conv3x3(x, w, dtype, b, relu)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(conv.conv3x3_unfused(x, w, dtype, b, relu)
                       .view(torch.int32), want.view(torch.int32))
    assert not any(_build.launches().values())


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
    """``passes`` and ``tile_plan`` mirror ``Conf::NW`` and ``Conf::TR``:
    at C = 96 and 112 in float32 (MODE 0) two output-channel blocks of
    one row, else one block of two rows; ``WIDTHS`` are the widths the
    launch dispatches to a wgmma instance, and ``FIRST_CIN`` the SIMT
    kernel's limit (an output channel's weights in its shared memory)."""
    assert re.search(r"HALVES = MODE == 0 && C > 80;", SRC)
    assert re.search(r"TR = HALVES \? 1 : 2;", SRC)
    assert re.search(r"NW = HALVES \? 2 : 1;", SRC)
    assert conv.passes(112) == conv.passes(96) == 2
    assert conv.passes(112, torch.bfloat16) == conv.passes(80) == 1
    assert conv.passes(64) == conv.passes(64, torch.float16) == 1
    for C in conv.WIDTHS:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            halves = dt == torch.float32 and C > 80
            assert conv.tile_plan(C, dt) == ((1, 2) if halves else (2, 1))
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


def _head():
    """The bytes ahead of the ring: the mbarriers and the layer's bias."""
    extra = re.search(r"constexpr int HEAD_BYTES = BAR_BYTES \+ (\d+);", SRC)
    return _const("BAR_BYTES") + int(extra.group(1))


def _conf(C, dtype):
    """``Conf`` of ``csrc/conv.cu`` computed by its formulas from its
    constants: (TR, row slots NS, ring stages S, stage bytes, row slot
    bytes)."""
    assert "(MAX_SMEM - HEAD_BYTES - 3 * SB) / RB >= 2 * TR + 2 ? " \
        "2 * TR + 2 : TR + 2;" in SRC
    smem, hp = _const("MAX_SMEM"), _const("TM") + 2
    bar = _head()
    tr, nw = conv.tile_plan(C, dtype)
    lv = 3 if dtype == torch.float32 else 1
    rb = lv * C // 8 * hp * 16
    lps = lv if C == 64 else 1
    sb = lps * nw * C * (C // nw) * 2
    ns = 2 * tr + 2 if (smem - bar - 3 * sb) // rb >= 2 * tr + 2 \
        else tr + 2
    return tr, ns, min((smem - bar - ns * rb) // sb, 6), sb, rb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 80, 96, 112])
def test_tile_plan_covers_every_pixel_once(C, dtype):
    """The wgmma kernel's tiles at each width (``TM`` columns x ``Conf::TR``
    rows, decoded from the tile index as ``decode`` does, the row
    fastest; each block a run of consecutive tiles down column strips; a
    consumer warpgroup a row of
    all the channels, or at C = 96 and 112 in float32 a half of the
    channels of the one row, its warps' rows 16 w + g + 8 h) cover every
    output (pixel, channel) of frames off the tile exactly once, the
    stores masked at the frame's edges. The row-slot ring, as the producer
    stages and the consumers read and hand back: every tile finds its
    rows y0 - 1 .. y0 + TR of its image and columns in the slots it
    reads; a row is handed back after its last read (a0 of tap t loaded
    in step t - 1, levels 1 and 2 in step t) and never read again; a slot
    is refilled only after its row was handed back in an earlier tile, so
    nothing waits on a later tile; the shared memory fits."""
    TM = _const("TM")
    assert TM == conv.TM == 64
    tr, ns, n_stage, sb, rb = _conf(C, dtype)
    assert n_stage >= 3
    assert _head() + n_stage * sb + ns * rb <= _const("MAX_SMEM")
    _, nw = conv.tile_plan(C, dtype)
    lv = 3 if dtype == torch.float32 else 1
    for N, H, W, G in ((2, 5, 70, 3), (1, 1, 3, 1), (1, 37, 131, 4),
                       (2, 4, 128, 5), (1, 9, 200, 2), (2, 41, 200, 7)):
        seen = np.zeros((N, C, H, W), np.int64)
        n_tx, n_ty = -(-W // TM), -(-H // tr)
        n_tiles = N * n_tx * n_ty

        def decode(t):
            """(image, tile row, x0) of tile t, in (image, strip, row)
            order."""
            return t // (n_ty * n_tx), t % n_ty, (t // n_ty % n_tx) * TM

        for b in range(G):
            t0, t1 = b * n_tiles // G, (b + 1) * n_tiles // G
            # the producer's rows: q -> (image, row, x0)
            staged, q = {}, 0
            for t in range(t0, t1):
                n, yt, x0 = decode(t)
                first = t == t0 or yt == 0
                nr = tr + 2 if first else tr
                ya = yt * tr - 1 if first else yt * tr + 1
                for r in range(nr):
                    staged[q + r] = (n, ya + r, x0, t)
                q += nr
            # the consumers
            q, released = 0, {}
            for t in range(t0, t1):
                n, yt, x0 = decode(t)
                first = t == t0 or yt == 0
                qb = q if first else q - 2
                q += tr + 2 if first else tr
                carry = t + 1 < t1 and (t + 1) % n_ty != 0
                for i in range(tr + 2):
                    assert staged[qb + i][:3] == (n, yt * tr - 1 + i, x0)
                    if qb + i >= ns:  # its slot handed back a tile before
                        assert released[qb + i - ns][0] < staged[qb + i][3]
                reads = collections.defaultdict(list)
                for tap in range(9):
                    ky = tap // 3
                    for wg in range(2):
                        row = ky if nw == 2 else wg + ky
                        reads[row].append(max(tap - 1, 0))  # a0
                        if lv == 3:
                            reads[row].append(tap)  # levels 1, 2
                for i in range(tr + 2):
                    last = min(3 * i + 2, 8)
                    if i < tr or not carry:
                        assert max(reads[i]) <= last
                        released[qb + i] = (t, last)
                for wg in range(2):
                    y = yt * tr + (0 if nw == 2 else wg)
                    chans = (range(wg * C // 2, (wg + 1) * C // 2) if nw == 2
                             else range(C))
                    for w in range(4):
                        for g in range(8):
                            for h in range(2):
                                x = x0 + 16 * w + g + 8 * h
                                if y < H and x < W:
                                    seen[n, list(chans), y, x] += 1
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
