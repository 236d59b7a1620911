"""The towers' kernels of ``csrc/tower.cu`` by their plain versions on the
CPU: the prediction route of both towers (``infer``: bias-free
convolutions, ``tower.bias_act``, ``tower.normalize``) against the JAX
package's ``apply_tower``, the join's packed operands against
``join._prep``, the slow volumes' epilogue against the composition it
replaces and against the JAX package's ``_volumes_jit``, and numpy models
of the kernels' sum order and thread splits (constants read out of the
source). The kernels themselves are held to these plain versions on the
card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mccnn_tpu import pipeline as jpipe
from mccnn_tpu.models import towers as jtowers
from mccnn_tpu_torch import pipeline
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.models import towers
from mccnn_tpu_torch.ops import _build, costs, join, slow_head, tower

SRC = (Path(__file__).resolve().parents[1] / "mccnn_tpu_torch" / "csrc"
       / "tower.cu").read_text()
H, W = 24, 40
# the kitti widths: l1 = 4, fm = 64 (fast) and 112 (slow)
WIDTHS = {"fast": dict(l1=4, fm=64), "slow": dict(l1=4, fm=112, l2=2, nh2=32)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _nets(arch, **over):
    cfg = make_config("kitti", arch, **{**WIDTHS[arch], **over})
    key = jax.random.PRNGKey(cfg.seed)
    if arch == "fast":
        tree = jtowers.init_fast(key, l1=cfg.l1, fm=cfg.fm, ks=cfg.ks)
    else:
        tree = jtowers.init_slow(key, l1=cfg.l1, fm=cfg.fm, ks=cfg.ks,
                                 l2=cfg.l2, nh2=cfg.nh2)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return cfg, tree, towers.params_from_numpy(tree)


def _images(seed, h=H, w=W):
    return np.random.RandomState(seed).randn(2, h, w).astype(np.float32)


def _bf16_ulp(v):
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("case", ["float32", "bfloat16", "bfloat16-narrow"])
@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_inference_tower_matches_apply_tower(arch, case):
    """``infer`` (the plain versions of the bias kernel and, on the fast
    tower, of the normalization) against ``apply_tower(padding="SAME")``
    on the same weights, 24x40. float32 at the kitti widths: atol 1e-5
    (the convolutions sum in other orders). bfloat16 at
    tests/test_torch_dtypes.py's widths (l1 = 3, fm = 16), with its
    tolerance: at least 0.999 of the features equal, each within four bf16
    units plus 1e-6. bfloat16 at the kitti widths, where a sum near a
    rounding boundary that rounds one bf16 unit apart in the first layers
    carries through three more (0.3% of the features here, by up to one
    bf16 unit of the largest feature, much more than one unit of a feature
    near zero): at least 0.99 equal, each within four bf16 units of the
    largest |feature| of the map."""
    dtype = case.split("-")[0]
    _, tree, net = _nets(arch, **(dict(l1=3, fm=16) if "narrow" in case
                                  else {}))
    imgs = _images(3)
    want = np.asarray(jtowers.apply_tower(
        tree, jnp.asarray(imgs)[..., None], arch=arch, padding="SAME",
        dtype=jnp.dtype(dtype)))
    got = net.infer(torch.as_tensor(imgs)[:, None],
                    pipeline.DTYPES[dtype]).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    elif "narrow" in case:
        assert float((got == want).mean()) >= 0.999
        assert np.all(np.abs(got - want) <= 4 * _bf16_ulp(want) + 1e-6)
    else:
        assert float((got == want).mean()) >= 0.99
        assert np.all(np.abs(got - want)
                      <= 4 * _bf16_ulp(np.abs(want).max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_inference_tower_is_forward_in_16_bit(arch, dtype):
    """In a 16-bit compute dtype ``forward`` already adds the bias to a
    bias-free float32 convolution, so ``infer`` gives its bits; in float32
    it differs only by the CPU convolution's own bias add (1e-6)."""
    _, _, net = _nets(arch, l1=3)
    x = torch.as_tensor(_images(4))[:, None]
    with torch.no_grad():
        assert torch.equal(net.infer(x, dtype), net(x, dtype))
        assert float((net.infer(x) - net(x)).abs().max()) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sides", ["both", "left"])
def test_packed_operands_are_prep_of_the_features(sides, dtype):
    """The packed route's operands equal ``join._prep`` of the features
    that the plain-layout route gives, ``torch.equal``: a_l, b_l from the
    x-reversed maps, a_r, b_r (both sides) natural, zero-padded to
    ``join.pad_dims``; and the join's volumes from them equal the volumes
    from the features."""
    _, _, net = _nets("fast", l1=2, fm=16)
    x = torch.as_tensor(_images(5, 20, 37))[:, None]
    D = 9
    feats = net.infer(x, dtype)
    fl, fr = feats[0].permute(1, 2, 0), feats[1].permute(1, 2, 0)
    got = net.infer(x, dtype, pack=(D, sides))
    Hp, Wp, Dp = join.pad_dims(20, 37, D)
    want = [join._prep(fl, True, Hp, Wp), join._prep(fr, True, Hp, Wp + Dp)]
    if sides == "both":
        want += [join._prep(fr, False, Hp, Wp),
                 join._prep(fl, False, Hp, Wp + Dp)]
    else:
        assert got.a_r is None and got.b_r is None
    assert (got.H, got.W) == (20, 37)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    vols = join.stereo_join_hwd(None, None, D, n_fix=2, sides=sides,
                                packed=got)
    ref = join.stereo_join_hwd(fl, fr, D, n_fix=2, sides=sides)
    for g, w in zip(*((vols, ref) if sides == "both" else ([vols], [ref]))):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(), w.nan_to_num())


def test_join_refuses_operands_of_another_shape():
    _, _, net = _nets("fast", l1=1, fm=8)
    x = torch.as_tensor(_images(6, 10, 20))[:, None]
    left = net.infer(x, pack=(8, "left"))
    with pytest.raises(ValueError, match="operands"):
        join.stereo_join_hwd(None, None, 8, packed=left)  # both sides
    with pytest.raises(ValueError, match="operands"):
        join.stereo_join_hwd(None, None, 200, sides="left", packed=left)
    with pytest.raises(ValueError, match="sides"):
        tower.normalize(torch.zeros(2, 8, 3, 4), torch.zeros(8),
                        pack=(8, "right"))


def _planted_scores(seed, D, h, w):
    s = np.random.RandomState(seed).rand(D, h, w).astype(np.float32)
    flat = s.reshape(-1)
    flat[::97] = np.nan
    flat[5::89] = -0.0
    flat[7::83] = np.inf
    flat[11::79] = -np.inf
    flat[13::73] = np.float32(np.frombuffer(np.uint32(0x7fc00123).tobytes(),
                                            np.float32)[0])
    return torch.as_tensor(s)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("disp_true", [None, 7])
@pytest.mark.parametrize("n", [0, 1, 4])
def test_slow_epilogue_is_the_old_composition(n, disp_true):
    """``slow_epilogue`` on CPU tensors against ``masked_volumes`` ->
    ``fix_border`` of both volumes -> ``torch.where`` of the planes
    d >= disp_true, bit for bit, on scores with NaN of two payloads,
    -0.0 and +-inf planted."""
    D, h, w = 12, 5, 21
    s = _planted_scores(n, D, h, w)
    vol_l, vol_r = slow_head.masked_volumes(s)
    vols = [costs.fix_border(vol_l, -1, n), costs.fix_border(vol_r, 1, n)]
    if disp_true is not None:
        real = torch.arange(D)[:, None, None] < disp_true
        vols = [torch.where(real, v, 1e9) for v in vols]
    before = dict(_build.LAUNCHES)
    got = tower.slow_epilogue(s, n, disp_true)
    assert dict(_build.LAUNCHES) == before  # no kernel on the CPU
    for g, want in zip(got, vols):
        assert torch.equal(_bits(g), _bits(want))


def _split(off: int, length: int):
    """The kernels' split of a run of ``length`` floats at element offset
    ``off`` from a 16-byte boundary: the head up to the first boundary,
    whole 16-byte groups, the tail (csrc/tower.cu)."""
    head = min(length, (4 - off % 4) % 4)
    groups = (length - head) // 4
    return head, groups, head + 4 * groups


def _epilogue_model(s: np.ndarray, n: int, d_true: int):
    """numpy model of slow_volumes_epilogue_kernel: each (d, y) row split
    as the kernel splits it, every column written by the head, a group
    or the tail with the kernel's index formulas."""
    D, h, w = s.shape
    nan = np.frombuffer(np.uint32(0x7fc00000).tobytes(), np.float32)[0]
    vl = np.full(s.shape, -7.0, np.float32)
    vr = np.full(s.shape, -7.0, np.float32)
    writes = np.zeros(s.shape, np.int32)

    def put(d, y, x):
        row = s[d, y]
        xl = w - 1 - n if x >= w - n else x
        xr = n if x < n else x
        if d >= d_true:
            vl[d, y, x] = vr[d, y, x] = np.float32(1e9)
        else:
            vl[d, y, x] = row[xl] if xl >= d else nan
            vr[d, y, x] = row[xr + d] if xr + d < w else nan
        writes[d, y, x] += 1

    for d in range(D):
        for y in range(h):
            head, groups, tail = _split((d * h + y) * w, w)
            for x in list(range(head)) + list(range(tail, w)):
                put(d, y, x)
            for g in range(groups):
                for k in range(4):
                    put(d, y, head + 4 * g + k)
    assert (writes == 1).all()
    return vl, vr


@pytest.mark.parametrize("shape,n,disp_true", [((9, 3, 13), 1, None),
                                               ((6, 2, 7), 0, 4),
                                               ((11, 4, 30), 4, 9)])
def test_epilogue_kernel_model_is_the_plain_version(shape, n, disp_true):
    """The kernel's arithmetic (index formulas, the NaN of 0x7fc00000, the
    row's head / 16-byte groups / tail, every cell written once) in
    numpy against ``slow_epilogue_plain``, bit for bit, widths off a
    multiple of 4 so that rows start at every offset."""
    s = _planted_scores(sum(shape), *shape)
    d_true = shape[0] if disp_true is None else disp_true
    want = tower.slow_epilogue_plain(s, n, disp_true)
    for g, w in zip(_epilogue_model(s.numpy(), n, d_true), want):
        assert np.array_equal(g.view(np.int32), w.numpy().view(np.int32))


@pytest.mark.parametrize("disp_true", [None, 12])
def test_slow_volumes_match_jax_volumes_jit(interpret, disp_true):
    """The slow arch's ``_volumes`` (the tower's plain route, the head,
    the epilogue's plain version) against JAX's ``_volumes_jit`` with the
    head's Pallas kernel in interpret mode, at D = 16 and narrow widths:
    equal NaN masks, max |d| <= 1e-4 (tests/test_torch_slow_pipeline.py's
    tolerance), the planes d >= disp_true 1e9 in both."""
    D, h, w = 16, 12, 40
    cfg, tree, net = _nets("slow", l1=2, fm=8, l2=3, nh2=16)
    x0, x1 = _images(7, h, w)
    want = jpipe._volumes_jit(tree, jnp.asarray(x0), jnp.asarray(x1),
                              arch="slow", disp_max=D, ws=cfg.ws,
                              dtype_name="float32", use_pallas=True,
                              disp_true=disp_true)
    got = pipeline._volumes(net, torch.as_tensor(x0), torch.as_tensor(x1),
                            arch="slow", disp_max=D, ws=cfg.ws,
                            disp_true=disp_true)
    for k in (-1, 1):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape == (D, h, w)
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        assert np.nanmax(np.abs(a - b)) <= 1e-4, k
        if disp_true is not None:
            assert (a[disp_true:] == 1e9).all() and (b[disp_true:] == 1e9).all()


def _kernel_sum(sq: np.ndarray, rows: int) -> np.ndarray:
    """numpy transliteration of ordered_sumsq in csrc/tower.cu, float32
    adds one at a time, on the channel axis 0 of ``sq``."""
    f = np.float32
    C = sq.shape[0]
    part = []
    for y in range(rows):
        acc = [np.zeros(sq.shape[1:], f) for _ in range(4)]
        idx = y
        while idx + 3 * rows < C:
            for i in range(4):
                acc[i] = (acc[i] + sq[idx + i * rows]).astype(f)
            idx += 4 * rows
        for i in range(4):
            if idx < C:
                acc[i] = (acc[i] + sq[idx]).astype(f)
            idx += rows
        part.append((((acc[0] + acc[1]).astype(f) + acc[2]).astype(f)
                     + acc[3]).astype(f))
    off = rows // 2
    while off:
        for y in range(off):
            part[y] = (part[y] + part[y + off]).astype(f)
        off //= 2
    return part[0]


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("C", [64, 112, 33, 8, 3])
def test_kernel_sum_order_is_channel_sum_plain(C, rows):
    """The kernel's channel sum order, transliterated, against
    ``channel_sum_plain`` (the order written out beside the plain
    version) bit for bit, on values spread over eight binades."""
    rng = np.random.RandomState(C * 16 + rows)
    sq = (rng.rand(2, C, 3, 5) * 2.0 ** rng.randint(-4, 4, (2, C, 3, 5))
          ).astype(np.float32)
    want = tower.channel_sum_plain(torch.as_tensor(sq), rows)[:, 0].numpy()
    got = np.stack([_kernel_sum(sq[i], rows) for i in range(2)])
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_sum_rows_mirrors_the_reduction_config():
    """torch's strided channel sum: four outputs a thread where H * W
    allows (KITTI, Middlebury, the test images), so blocks of 32 x 4 and
    64 channels split over 4 rows; two or one output a thread (H * W off
    a multiple of 4) keep 64 channels in one row; no split past the
    kernel's YMAX rows."""
    assert tower.sum_rows(64, 2, 370 * 1226) == 4
    assert tower.sum_rows(64, 2, 1000 * 1500) == 4
    assert tower.sum_rows(64, 2, 24 * 40) == 4
    assert tower.sum_rows(64, 2, 23 * 42) == 1
    assert tower.sum_rows(64, 2, 23 * 41) == 1
    assert tower.sum_rows(112, 2, 24 * 40) == 4
    assert tower.sum_rows(8, 2, 24 * 40) == 1
    assert tower.sum_rows(1024, 2, 23 * 41) == 16
    ymax = int(re.search(r"constexpr int YMAX = (\d+);", SRC).group(1))
    assert max(tower.sum_rows(c, n, hw) for c in range(1, 1100, 7)
               for n in (1, 2) for hw in (1, 2, 3, 4, 6, 35, 960)) <= ymax


@pytest.mark.parametrize("P", [1, 2, 3, 5, 8, 13, 960, 1023])
def test_bias_act_split_covers_each_plane_once(P):
    """tower_bias_act_kernel's threads over a plane of P floats at each
    offset from a 16-byte boundary: thread k takes group k, the head's
    float k and the tail's float k, and every float is taken once (the
    grid's P / 4 + 1 groups' worth of threads)."""
    threads = ((P // 4 + 1 + 255) // 256) * 256
    for off in range(4):
        head, groups, tail = _split(off, P)
        hits = np.zeros(P, np.int32)
        for k in range(threads):
            if k < groups:
                hits[head + 4 * k:head + 4 * k + 4] += 1
            if k < head:
                hits[k] += 1
            if k < 4 and tail + k < P:
                hits[tail + k] += 1
        assert (hits == 1).all(), (off, P)


def _store_run(phase, lo, hi, base, rev):
    """store_run in csrc/tower.cu: [(x, tile index or None)] for x in
    [lo, hi), as the head, the 16-byte groups (each 16-byte aligned, a row
    whose element 0 is ``phase`` floats past a boundary) and the tail."""
    if lo >= hi:
        return []
    a = min(hi, lo + (4 - (phase + lo) % 4) % 4)
    b = max(a, hi - (phase + hi) % 4)
    assert (b - a) % 4 == 0 and (a == b or (phase + a) % 4 == 0)
    assert a - lo < 4 and hi - b < 4 and (b - a) // 4 <= 32
    xs = list(range(lo, a)) + list(range(a, b)) + list(range(b, hi))
    return [(x, None if base is None else (base - x if rev else x - base))
            for x in xs]


def _normalize_plan(N, H, W, D, sides):
    """The writes of tower_normalize_kernel, block by block (a run of TXN
    columns of a row of an image): {(operand, image, row, x): tile index
    of the block's run or None for +0.0}, each write asserted new."""
    assert "constexpr int TXN = NTN;" in SRC
    txn = int(re.search(r"constexpr int NTN = (\d+);", SRC).group(1))
    writes = {}

    def put(name, n, y, runs, x0):
        for x, idx in runs:
            key = (name, n, y, x)
            assert key not in writes, key
            assert idx is None or 0 <= idx < min(txn, W - x0)
            writes[key] = None if idx is None else x0 + idx

    if sides is None:  # the features' layout, rows of W at any offset
        for n in range(N):
            for y in range(H):
                for x0 in range(0, W, txn):
                    xe = min(x0 + txn, W)
                    put("out", n, y, _store_run((n * H + y) * W % 4, x0, xe,
                                                x0, False), x0)
        return writes
    Hp, Wp, Dp = join.pad_dims(H, W, D)
    wa, wb = Wp, Wp + Dp
    plan = {0: (("a_l", wa), ("b_r", wb)), 1: (("b_l", wb), ("a_r", wa))}
    for n in (0, 1):
        (rev, wrev), (nat, wnat) = plan[n]
        for y in range(Hp):
            for x0 in range(0, wb, txn):
                xe = min(x0 + txn, W)
                if y < H:
                    put(rev, n, y, _store_run(0, W - xe, W - x0, W - 1 - x0,
                                              True), x0)
                    put(rev, n, y, _store_run(0, max(x0, W),
                                              min(x0 + txn, wrev), None,
                                              False), x0)
                else:
                    put(rev, n, y, _store_run(0, x0, min(x0 + txn, wrev),
                                              None, False), x0)
                if sides == "left":
                    continue
                ne = min(x0 + txn, wnat)
                if y < H:
                    put(nat, n, y, _store_run(0, x0, min(xe, ne), x0, False),
                        x0)
                    put(nat, n, y, _store_run(0, max(x0, W), ne, None,
                                              False), x0)
                else:
                    put(nat, n, y, _store_run(0, x0, ne, None, False), x0)
    return writes


@pytest.mark.parametrize("sides", ["both", "left", None])
@pytest.mark.parametrize("H,W,D", [(5, 7, 3), (3, 128, 128), (4, 131, 1),
                                   (2, 257, 40)])
def test_normalize_plan_writes_each_element_once(H, W, D, sides):
    """tower_normalize_kernel's store plan in numpy (a block a run of
    TXN columns of a row, read out of the source; ``store_run``'s head,
    16-byte groups and tail): every element of a_l, b_l (and a_r, b_r),
    or of the features, written once, each pixel from its own column of
    the run, and the values where ``join._prep`` puts them."""
    writes = _normalize_plan(2, H, W, D, sides)
    fl = torch.arange(H * W, dtype=torch.float32).reshape(H, W, 1) + 1
    fr = -fl
    if sides is None:
        for n, f in ((0, fl), (1, fr)):
            got = np.zeros((H, W), np.float32)
            for (_, m, y, x), col in writes.items():
                if m == n:
                    got[y, x] = f[y, col, 0]
            assert len([k for k in writes if k[1] == n]) == H * W
            assert np.array_equal(got, f[..., 0].numpy())
        return
    want = join.operands(fl, fr, D, sides)
    names = ("a_l", "b_l") + (("a_r", "b_r") if sides == "both" else ())
    for name in names:
        ref = getattr(want, name)[:, 0].numpy()
        got = np.full(ref.shape, np.nan, np.float32)
        for (nm, n, y, x), col in writes.items():
            if nm == name:
                got[y, x] = 0.0 if col is None else (fl if n == 0
                                                     else fr)[y, col, 0]
        assert not np.isnan(got).any(), name
        assert np.array_equal(got, ref), name


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("direction", [-1, 1])
def test_fix_border_in_place(direction, inplace):
    """``fix_border(..., inplace=True)`` overwrites the caller's volume
    with the values of the returning form; the returning form leaves the
    volume as it was."""
    vol = _planted_scores(direction + 5, 6, 3, 11)
    keep = vol.clone()
    want = costs.fix_border(keep, direction, 3)
    got = costs.fix_border(vol, direction, 3, inplace=inplace)
    assert torch.equal(_bits(got), _bits(want))
    assert (got is vol) == inplace
    if not inplace:
        assert torch.equal(_bits(vol), _bits(keep))


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    """On CPU tensors each wrapper is its plain version (no kernel counted),
    ``bias_act`` in place; a dtype the kernels do not take raises."""
    rng = np.random.RandomState(8)
    acc = torch.as_tensor(rng.randn(2, 5, 4, 6).astype(np.float32))
    bias = torch.as_tensor(rng.randn(5).astype(np.float32))
    _build.reset_launches()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for relu in (True, False):
            a = acc.clone()
            assert tower.bias_act(a, bias, relu, dt) is a
            assert torch.equal(a, tower.bias_act_plain(acc.clone(), bias,
                                                       relu, dt))
        assert torch.equal(tower.normalize(acc, bias, dt),
                           tower.normalize_plain(acc, bias, dt))
    assert not any(_build.launches().values())
    with pytest.raises(ValueError, match="dtype"):
        tower.bias_act(acc, bias, True, torch.float64)


def test_training_forward_keeps_the_plain_ops():
    """``forward`` under autograd builds its graph from the plain ops
    (gradients reach every layer) and launches no tower kernel;
    ``infer`` records no graph."""
    _, _, net = _nets("fast", l1=2, fm=8)
    x = torch.as_tensor(_images(9, 11, 11))[:, None]
    _build.reset_launches()
    net(x, padding="valid").sum().backward()
    assert all(c.weight.grad is not None for c in net.convs)
    assert not net.infer(x).requires_grad
    assert not any(_build.launches().values())


def test_fast_hwd_lane_joins_the_packed_operands(monkeypatch):
    """The HWD lane hands the join the tower's packed operands (no
    features), both sides or the left one (mb -a time)."""
    seen = []
    orig = join.stereo_join_hwd

    def spy(fl, fr, D, **kw):
        seen.append((fl, fr, kw["sides"], type(kw["packed"])))
        return orig(fl, fr, D, **kw)

    monkeypatch.setattr(join, "stereo_join_hwd", spy)
    _, _, net = _nets("fast", l1=2, fm=8)
    x0, x1 = _images(10, 16, 40)
    for ds, a in (("kitti", "predict"), ("mb", "time")):
        cfg = make_config(ds, "fast", a=a, l1=2, fm=8)
        d = pipeline.stereo_predict(cfg, net, x0, x1, 8, device="cpu")
        assert d.shape == (16, 40) and torch.isfinite(d).all()
    assert seen == [(None, None, "both", join.Operands),
                    (None, None, "left", join.Operands)]
