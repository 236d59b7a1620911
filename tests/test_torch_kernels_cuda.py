"""The CUDA kernels against their plain versions on the card, at small
awkward shapes (chip_smoke.py checks the full KITTI shapes).

Needs an NVIDIA GPU with nvcc; skips elsewhere. On a machine without
JAX, run it without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from mccnn_tpu_torch.ops import (_build, blur, conv, costs, cross, join,
                                 outlier, post, sgm, slow_head, tower)

pytestmark = pytest.mark.cuda

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fm", [80, 96])
def test_prediction_at_the_search_widths(dev, fm, dtype):
    """kitti fast at the other widths of the fast net's hyperparameter
    search (tools/hs.py, fm 80 and 96) at 40x160, D=24: ``stereo_predict``
    runs a ``tower_conv`` a layer; each layer's kernel output within
    1.2e-6 (float32) or 2e-6 (bf16) of sum |w||x| from ``conv3x3_plain``
    on the same inputs; the map finite, and more than 0.51 px from the
    map with ``conv3x3_plain`` in place of the kernels on at most 0.001
    of the pixels."""
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.pipeline import stereo_predict

    H, W, D = 40, 160, 24
    base = np.random.RandomState(29).randn(H, W + D).astype(np.float32)
    x0, x1 = base[:, D:], base[:, :-D]
    cfg = make_config("kitti", "fast", a="predict", dtype=dtype, fm=fm)
    net = towers.init_net(cfg).to(dev)
    seen, orig = [], conv.conv3x3

    def record(x, weight, dt=torch.float32, bias=None, relu=False):
        seen.append((x, weight, dt))
        return orig(x, weight, dt, bias, relu)

    def plain(x, weight, dt=torch.float32, bias=None, relu=False):
        out = conv.conv3x3_plain(x, weight, dt)
        return out if bias is None else tower.bias_act_plain(out, bias, relu,
                                                             dt)

    _build.reset_launches()
    conv.conv3x3 = record
    try:
        got = stereo_predict(cfg, net, x0, x1, D)
        torch.cuda.synchronize()
    finally:
        conv.conv3x3 = orig
    assert _build.launches()["tower_conv"] == cfg.l1 == len(seen)
    assert [w.shape[:2] for _, w, _ in seen[1:]] == [(fm, fm)] * (cfg.l1 - 1)
    limit = 1.2e-6 if dtype == "float32" else 2e-6
    with torch.no_grad():
        for x, w, dt in seen:
            scale = conv.conv3x3_plain(x.abs(), w.abs(), dt).clamp_min(1e-30)
            err = float(((conv.conv3x3(x, w, dt)
                          - conv.conv3x3_plain(x, w, dt)).abs() / scale).max())
            assert err <= limit, (tuple(w.shape), err)
    conv.conv3x3 = plain
    try:
        ref = stereo_predict(cfg, net, x0, x1, D)
    finally:
        conv.conv3x3 = orig
    assert got.shape == (H, W) and bool(torch.isfinite(got).all())
    assert float(((got - ref).abs() > 0.51).float().mean()) <= 0.001


KW = dict(pi1=4.0, pi2=55.72, tau_so=0.02, alpha1=1.5, q1=3.0, q2=2.5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _feats(rng, H, W, C, dev):
    f = torch.as_tensor(rng.randn(2, H, W, C).astype(np.float32), device=dev)
    return f / f.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize("H,W,C,D,n_fix", [(20, 140, 8, 20, 4),
                                           (70, 300, 64, 228, 4),
                                           (3, 128, 16, 130, 0),
                                           (9, 1000, 64, 300, 4),
                                           (4, 200, 64, 100, 0),
                                           (66, 97, 33, 228, 3),
                                           (7, 300, 112, 100, 4),
                                           (5, 200, 130, 64, 0)])
def test_join_kernel_matches_plain(dev, H, W, C, D, n_fix):
    """The kernel against the float32 sum within 1e-5, and against the
    emulation of its own arithmetic (three bf16 levels, the same products
    summed in float32 in other orders) within 1e-6; NaN masks equal. W
    off a multiple of 64; Dp 128, 256 and 384 (two disparity chunks);
    rows past a multiple of 64; C below 64 (zero channels in the kernel)
    and above it (slabs of 64 channels, one kernel launch each, the last
    one ragged)."""
    f = _feats(np.random.RandomState(H), H, W, C, dev)
    Hp, Wp, Dp = join.pad_dims(H, W, D)
    a = join._prep(f[0], True, Hp, Wp)
    b = join._prep(f[1], True, Hp, Wp + Dp)
    before = _build.LAUNCHES["join"], _build.KERNEL_LAUNCHES["join"]
    got = join._join_plus(a, b, D, W, H, n_fix)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["join"] == before[0] + 1
    assert _build.KERNEL_LAUNCHES["join"] == before[1] + -(-C // 64)
    want = join.join_plus_plain(a, b, D, W, H, n_fix)
    assert torch.equal(got.isnan(), want.isnan())
    assert float((got - want).nan_to_num().abs().max()) <= 1e-5
    want = join.join_plus_split_plain(a, b, D, W, H, n_fix)
    assert torch.equal(got.isnan(), want.isnan())
    assert float((got - want).nan_to_num().abs().max()) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("H,W,C,D,n_fix,d_true", [(20, 140, 8, 20, 4, None),
                                                  (70, 300, 64, 228, 4, 200),
                                                  (66, 97, 33, 228, 3, None),
                                                  (7, 300, 112, 100, 4, 61),
                                                  (5, 200, 130, 64, 0, 1)])
def test_join_kernel_16bit_is_the_f32_kernel_rounded(dev, H, W, C, D, n_fix,
                                                     d_true, dtype):
    """The join's 16-bit stores against its float32 kernel on the same
    operands: one float32 staging tile, one rounding to nearest even, so
    equal to the float32 volume rounded, bit for bit, NaN masks included;
    with d_true the lanes d >= d_true NaN and the others unchanged. More
    than 64 channels sum their slabs in float32 before the last one
    rounds, as the float32 kernel sums them in place."""
    f = _feats(np.random.RandomState(H + C), H, W, C, dev)
    Hp, Wp, Dp = join.pad_dims(H, W, D)
    a = join._prep(f[0], True, Hp, Wp)
    b = join._prep(f[1], True, Hp, Wp + Dp)
    want = join._join_plus(a, b, D, W, H, n_fix)
    if d_true is not None:
        want[..., d_true:] = torch.nan
    got = join._join_plus(a, b, D, W, H, n_fix, d_true=d_true, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    want = want.to(dtype)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("xrev", [True, False])
def test_sgm_kernels_match_plain(dev, xrev):
    rng = np.random.RandomState(7)
    H, W, C, D = 45, 310, 16, 150
    f = _feats(rng, H, W, C, dev)
    vl, vr = join.stereo_join_hwd(f[0], f[1], D, n_fix=4)
    vol = vl if xrev else vr
    x0 = torch.as_tensor((rng.rand(H, W) * 0.06).astype(np.float32), device=dev)
    x1 = torch.as_tensor((rng.rand(H, W) * 0.06).astype(np.float32), device=dev)
    got, gmap = sgm.sgm_slab_hwd(x0, x1, vol, D, H, W, xrev=xrev, wta=True, **KW)
    torch.cuda.synchronize()
    want, wmap = sgm.sgm_slab_hwd(x0.cpu(), x1.cpu(), vol.cpu(), D, H, W,
                                  xrev=xrev, wta=True, **KW)
    got = got.cpu()
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4, equal_nan=True)
    assert float((gmap.cpu() == wmap).float().mean()) >= 0.9999
    map_only = sgm.sgm_slab_hwd(x0, x1, vol, D, H, W, xrev=xrev, wta=True,
                                materialize=False, **KW)
    assert torch.equal(map_only, gmap)


@pytest.mark.parametrize("H,W,D,C,n_mid", [(11, 140, 19, 64, 2),
                                           (5, 300, 130, 384, 3),
                                           (3, 129, 1, 192, 1),
                                           (2, 300, 200, 64, 3),
                                           (1, 100, 1, 384, 2),
                                           (4, 130, 140, 384, 1),
                                           (7, 257, 60, 64, 1),
                                           (3, 128, 128, 48, 2),
                                           (2, 513, 228, 384, 2)])
def test_slow_head_kernel_matches_plain(dev, H, W, D, C, n_mid):
    """Awkward shapes (W % 128, D and C not multiples of 128; C=192
    zero-padded to the 384 instance, C=48 to the 64 one; D beyond the
    first strip, so whole tiles have no cell with x >= d and are
    skipped; D beyond W; one tile in all, less than a cluster; an odd
    number of tiles; one, two and three mid layers at both widths).
    Both sides round the same operands
    to bf16 and sum in float32 in other orders; a hidden unit within a
    summation-order difference of a bf16 rounding boundary may round one
    bf16 ulp apart: max |d| <= 1e-3 over the cells with x >= d, mean
    |d| <= 1e-5."""
    rng = np.random.RandomState(C + D)

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.randn(*shape) * scale).astype(np.float32),
                               device=dev)

    A, B = t(H, W, C, scale=0.5), t(H, W, C, scale=0.5)
    mw = t(n_mid, C, C, scale=C ** -0.5)
    mb, wl = t(n_mid, C, scale=0.1), t(C, scale=C ** -0.5)
    A, B, mw, mb, wl = slow_head.pad_head(A, B, mw, mb, wl)
    mw = mw.to(torch.bfloat16)
    before = _build.LAUNCHES["slow_head"]
    got = slow_head.slow_head_volume(A, B, mw, mb, wl, 0.1, D)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["slow_head"] == before + 1
    want = slow_head.slow_head_plain(A, B, mw, mb, wl, 0.1, D)
    valid = (torch.arange(W, device=dev)[None, None, :]
             >= torch.arange(D, device=dev)[:, None, None]).expand(D, H, W)
    diff = (got - want).abs()[valid]
    assert float(diff.max()) <= 1e-3 and float(diff.mean()) <= 1e-5


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("Hp,Wp,Dp,D,T", [
    (5, 37, 128, 100, 37),    # T not a multiple of the chunk
    (3, 5, 128, 70, 5),       # less than one chunk
    (4, 48, 256, 228, 29),    # pad steps, and T inside a chunk
    (3, 2 * sgm.HCHUNK, 256, 130, 2 * sgm.HCHUNK),  # whole chunks
    (3, 20, 96, 80, 17),      # Dp off a multiple of 128
    (2, 19, 384, 300, 19)])   # three float4 groups a lane
def test_horizontal_sweep_kernel_is_bit_identical(dev, Hp, Wp, Dp, D, T,
                                                  reverse):
    """``sgm_sweep_horizontal`` against ``sweep_plain`` on the same
    tensors in its four uses: a first sweep (no accumulator), a sweep
    adding into its accumulator in place, the last sweep with the fused
    winner map, and that one without the volume write. The same f32
    operations in the same order and an exact min: equal bit for bit,
    NaN masks and winner maps included. The volume has NaN tails in d,
    scattered NaN cells, whole NaN steps and one scanline all NaN."""
    _horizontal_case(dev, Hp, Wp, Dp, D, T, reverse, torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("Hp,Wp,Dp,D,T", [
    (5, 37, 128, 100, 37), (4, 48, 256, 228, 29), (3, 20, 96, 80, 17),
    (2, 19, 384, 300, 19)])
def test_horizontal_sweep_kernel_16bit_is_bit_identical(dev, Hp, Wp, Dp, D, T,
                                                        reverse, dtype):
    """The 16-bit instances of ``sgm_sweep_horizontal`` against
    ``sweep_plain`` on the same 16-bit volume and accumulator, in the
    four uses of the float32 test: both widen the stored rows, run the
    same f32 recurrence, take the winner from the f32 sum and round only
    the stored sum to nearest even, so they are equal bit for bit."""
    _horizontal_case(dev, Hp, Wp, Dp, D, T, reverse, dtype)


def _horizontal_case(dev, Hp, Wp, Dp, D, T, reverse, dtype):
    rng = np.random.RandomState(Wp + Dp + reverse)
    vol = rng.rand(Hp, Wp, Dp).astype(np.float32)
    vol[..., D:] = np.nan
    vol[rng.rand(Hp, Wp, Dp) < 0.03] = np.nan
    vol[:, Wp // 3, :] = np.nan
    vol[:, :, D - D // 4:][:, ::2] = np.nan
    vol[Hp - 1] = np.nan
    accv = rng.rand(Hp, Wp, Dp).astype(np.float32)
    accv[np.isnan(vol)] = np.nan
    vol, accv = (torch.as_tensor(a, device=dev).to(dtype) for a in (vol, accv))
    d1 = torch.as_tensor((rng.rand(Hp, Wp) * 0.16).astype(np.float32),
                         device=dev)
    g = (rng.rand(Hp, D + Wp + Dp + 3) * 0.16).astype(np.float32)
    g[rng.rand(*g.shape) < 0.05] = 10.0
    g = torch.as_tensor(g, device=dev)
    kw = dict(vertical=False, reverse=reverse, T=T, D=D, tau=0.08,
              pen=sgm.pen_table(1.32, 24.25, 3.0, 2.0, 1.0, 1.0))

    def same(a, b):
        return torch.equal(a.isnan(), b.isnan()) \
            and torch.equal(a.nan_to_num(), b.nan_to_num())

    _build.reset_launches()
    for acc, with_out, with_wta in ((False, True, False), (True, True, False),
                                    (True, True, True), (True, False, True),
                                    (False, True, True)):
        bufs = []
        for sweep in (sgm._sweep, sgm.sweep_plain):
            a = accv.clone() if acc else None
            o = (a if acc else torch.full_like(vol, -1.0)) if with_out else None
            w = torch.full((Hp, Wp), -1.0, device=dev) if with_wta else None
            sweep(vol, a, o, w, d1, g, **kw)
            torch.cuda.synchronize()
            bufs.append((a, o, w))
        for got, want in zip(*bufs):
            assert (got is None) == (want is None)
            assert got is None or same(got, want)
    assert _build.LAUNCHES["sgm_horizontal"] == 5


@pytest.mark.parametrize("Ws,n_rev,Dp,has_acc", [
    (1280, 0, 256, True), (1280, 1280, 256, False),   # the fast shape
    (2452, 1226, 256, True), (2452, 1226, 256, False),  # the stacked one
    (740, 370, 256, True), (740, 370, 256, False),  # hslab's stacked rows
    (740, 0, 228, True), (2452, 0, 228, True),  # the scan form's families
    (750, 375, 256, True), (37, 13, 96, True),  # classes off a multiple of 4
    (23, 7, 96, True), (5, 2, 1024, True),
    (1536, 1536, 256, True), (1536, 0, 256, True)])  # the Middlebury shape
def test_vertical_plan_mirror_is_the_launched_plan(dev, Ws, n_rev, Dp,
                                                   has_acc):
    """``sgm.vertical_plan`` (the mirror the CPU tests check) against the
    plan ``sgm_sweep_vertical`` launches with, from the C entry
    ``sgm_vertical_plan``, on this card's SM count and on the H100's,
    for float32 and 16-bit values."""
    fn = _build.library("sgm_sweep").sgm_vertical_plan
    n_sms = {torch.cuda.get_device_properties(dev).multi_processor_count,
             sgm.H100_SMS}
    for n_sm in sorted(n_sms):
        for elem in (4, 2):
            got = (ctypes.c_int * 5)()
            fn(Ws, n_rev, Dp, int(has_acc), elem, n_sm, got)
            p = sgm.vertical_plan(Ws, n_rev, Dp, has_acc, n_sm, elem)
            want = [sum(x0 < n_rev for x0, _ in p["blocks"]),
                    len(p["blocks"]), p["per_sm"], p["stages"], p["smem"]]
            assert list(got) == want


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("Hp,Ws,Dp,D,T,n_rev", [
    (37, 9, 128, 100, 37, 0),     # T off a multiple of the chunk, Ws ragged
    (5, 6, 128, 70, 3, 6),        # pad steps, every scanline reversed
    (48, 13, 256, 228, 29, 5),    # pad steps, an odd split of the classes
    (20, 8, 96, 80, 17, 3),       # Dp off a multiple of 128
    (19, 7, 384, 300, 19, 7),     # three float4 groups a lane
    (2, 4, 256, 130, 2, 0)])      # one chunk
def test_vertical_sweep_kernel_is_bit_identical(dev, Hp, Ws, Dp, D, T, n_rev,
                                                reverse):
    """``sgm_sweep_vertical`` against ``sweep_plain`` on the same
    tensors, with the accumulator null, separate and in place, with the
    winner map fused, with and without the volume write. The same f32
    operations in the same order and an exact min: equal bit for bit,
    NaN masks and winner maps included. Scanlines x < n_rev read g_rev,
    the others g_nat; the volume has NaN tails in d, scattered NaN cells,
    whole NaN steps and one scanline all NaN."""
    _vertical_case(dev, Hp, Ws, Dp, D, T, n_rev, reverse, torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("Hp,Ws,Dp,D,T,n_rev", [
    (37, 9, 128, 100, 37, 0), (48, 13, 256, 228, 29, 5),
    (20, 8, 96, 80, 17, 3), (19, 7, 384, 300, 19, 7)])
def test_vertical_sweep_kernel_16bit_is_bit_identical(dev, Hp, Ws, Dp, D, T,
                                                      n_rev, reverse, dtype):
    """The 16-bit instances of ``sgm_sweep_vertical`` (their ring holds
    twice the chunks of the float32 one) against ``sweep_plain`` on the
    same 16-bit tensors, in the six uses of the float32 test: equal bit
    for bit, NaN masks and winner maps included."""
    _vertical_case(dev, Hp, Ws, Dp, D, T, n_rev, reverse, dtype)


def _vertical_case(dev, Hp, Ws, Dp, D, T, n_rev, reverse, dtype):
    rng = np.random.RandomState(Ws + Dp + reverse)
    vol = rng.rand(Hp, Ws, Dp).astype(np.float32)
    vol[..., D:] = np.nan
    vol[rng.rand(Hp, Ws, Dp) < 0.03] = np.nan
    vol[:, Ws // 3, :] = np.nan
    vol[:, :, D - D // 4:][::2] = np.nan
    vol[Hp // 2] = np.nan
    accv = rng.rand(Hp, Ws, Dp).astype(np.float32)
    accv[np.isnan(vol)] = np.nan
    vol, accv = (torch.as_tensor(v, device=dev).to(dtype) for v in (vol, accv))
    d1 = torch.as_tensor((rng.rand(Hp, Ws) * 0.16).astype(np.float32),
                         device=dev)
    tables = []
    for _ in range(2):
        g = (rng.rand(Hp, D + Ws + Dp + 3) * 0.16).astype(np.float32)
        g[rng.rand(*g.shape) < 0.05] = 10.0
        tables.append(torch.as_tensor(g, device=dev))
    kw = dict(vertical=True, reverse=reverse, T=T, D=D, tau=0.08,
              g_nat=tables[1], n_rev=n_rev,
              pen=sgm.pen_table(1.32, 24.25, 3.0, 2.0, 2.0, 1.0))

    def same(a, b):
        return torch.equal(a.isnan(), b.isnan()) \
            and torch.equal(a.nan_to_num(), b.nan_to_num())

    _build.reset_launches()
    uses = ((False, "new", False), (True, "new", False), (True, "acc", False),
            (True, "acc", True), (True, None, True), (False, "new", True))
    for acc, out_to, with_wta in uses:
        bufs = []
        for sweep in (sgm._sweep, sgm.sweep_plain):
            a = accv.clone() if acc else None
            o = {"new": torch.full_like(vol, -1.0), "acc": a, None: None}[out_to]
            w = torch.full((Hp, Ws), -1.0, device=dev) if with_wta else None
            sweep(vol, a, o, w, d1, tables[0], **kw)
            torch.cuda.synchronize()
            bufs.append((a, o, w))
        for got, want in zip(*bufs):
            assert (got is None) == (want is None)
            assert got is None or same(got, want)
    assert _build.LAUNCHES["sgm_vertical"] == len(uses)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("W,S,Dp,D,T,n_rev", [
    (37, 9, 32, 20, 37, 5),        # one float4 group, ragged classes
    (29, 13, 256, 228, 29, 6),     # two groups: the KITTI rows
    (21, 7, 1024, 1000, 21, 3),    # eight groups, the widest rows
    (40, 11, 256, 200, 27, 11),    # pad steps, every scanline reversed
    (33, 10, 384, 300, 17, 0),     # pad steps, none reversed
    (3, 6, 128, 70, 3, 2)])        # one chunk and a half
def test_hslab_sweep_kernel_is_bit_identical(dev, W, S, Dp, D, T, n_rev,
                                             reverse):
    """``sgm_sweep_hslab`` against ``hslab_plain`` on the same tensors,
    with no accumulator, a separate one and one summed in place. The same
    f32 operations in the same order and an exact min: equal bit for
    bit, NaN masks included. Scanlines s < n_rev read their row of g at
    rev_base - x, the others at D + x; the volume has NaN tails in d,
    scattered NaN cells, whole NaN steps and one scanline all NaN."""
    rng = np.random.RandomState(W + Dp + reverse)
    vol = rng.rand(W, S, Dp).astype(np.float32)
    vol[..., D:] = np.nan
    vol[rng.rand(W, S, Dp) < 0.03] = np.nan
    vol[:, S // 3, :] = np.nan
    vol[W // 2] = np.nan
    accv = rng.rand(W, S, Dp).astype(np.float32)
    accv[np.isnan(vol)] = np.nan
    vol, accv = (torch.as_tensor(v, device=dev) for v in (vol, accv))
    d1 = torch.as_tensor((rng.rand(W, S) * 0.16).astype(np.float32),
                         device=dev)
    g = (rng.rand(S, D + W + Dp + 5) * 0.16).astype(np.float32)
    g[rng.rand(*g.shape) < 0.05] = 10.0
    g = torch.as_tensor(g, device=dev)
    kw = dict(reverse=reverse, D=D, n_rev=n_rev, rev_base=W + D + 1, T=T,
              tau=0.08, pen=sgm.pen_table(1.32, 24.25, 3.0, 2.0, 1.0, 1.0))

    def same(a, b):
        return torch.equal(a.isnan(), b.isnan()) \
            and torch.equal(a.nan_to_num(), b.nan_to_num())

    _build.reset_launches()
    uses = ((False, "new"), (True, "new"), (True, "acc"))
    for acc, out_to in uses:
        bufs = []
        for sweep in (sgm._sweep_hslab, sgm.hslab_plain):
            a = accv.clone() if acc else None
            o = a if out_to == "acc" else torch.full_like(vol, -1.0)
            sweep(vol, a, o, d1, g, **kw)
            torch.cuda.synchronize()
            bufs.append((a, o))
        for got, want in zip(*bufs):
            assert (got is None) == (want is None)
            assert got is None or same(got, want)
    assert _build.launches()["sgm_hslab"] == len(uses)


@pytest.mark.parametrize("dirs", [(-1, 1), (-1,), (1,)])
def test_generic_sgm_kernels_match_plain(dev, dirs):
    """The generic lane's stacked sweeps (hslab and the vertical entry
    with its n_rev split) against the plain step loops on the CPU: the
    same f32 operations in the same order and an exact min, so the
    horizontal family and the sum of both are equal bit for bit, NaN
    masks included."""
    rng = np.random.RandomState(len(dirs))
    D, H, W = 70, 23, 150
    x0 = (rng.rand(H, W) * 0.2).astype(np.float32)
    x1 = (rng.rand(H, W) * 0.2).astype(np.float32)
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    vols = {}
    for k in dirs:
        v = rng.rand(D, H, W).astype(np.float32)
        v[np.broadcast_to((xs + ds * k < 0) | (xs + ds * k >= W), v.shape)] = np.nan
        vols[k] = v
    kw = dict(pi1=1.32, pi2=24.25, tau_so=0.08, alpha1=2.0, sgm_q1=3.0,
              sgm_q2=2.0)
    hkw = dict(pi1=1.32, pi2=24.25, tau_so=0.08, q1=3.0, q2=2.0)

    def same(a, b):
        return torch.equal(a.isnan(), b.isnan()) \
            and torch.equal(a.nan_to_num(), b.nan_to_num())

    before = dict(_build.LAUNCHES)
    on_dev = [torch.as_tensor(a, device=dev) for a in (x0, x1)]
    got = sgm.sgm_multi(*on_dev, {k: torch.as_tensor(v, device=dev)
                                  for k, v in vols.items()}, **kw)
    got_h = sgm.sgm_slab_horiz(*on_dev, {k: torch.as_tensor(v, device=dev)
                                         for k, v in vols.items()},
                               dirs, D, H, W, **hkw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sgm_hslab"] == before.get("sgm_hslab", 0) + 4
    assert _build.LAUNCHES["sgm_vertical"] == before.get("sgm_vertical", 0) + 2
    on_cpu = [torch.as_tensor(a) for a in (x0, x1)]
    want = sgm.sgm_multi(*on_cpu, {k: torch.as_tensor(v)
                                   for k, v in vols.items()}, **kw)
    want_h = sgm.sgm_slab_horiz(*on_cpu, {k: torch.as_tensor(v)
                                          for k, v in vols.items()},
                                dirs, D, H, W, **hkw)
    for k in dirs:
        assert same(got_h[k].cpu(), want_h[k])
        assert same(got[k].cpu(), want[k])


def _scan_case(rng, T, S, D, dev):
    """Pre-built scan-form slices: volume rows with out-of-frame NaN
    runs, scattered NaN cells and one all-NaN scanline step; D1 and D2
    around tau so that all three penalty classes occur."""
    vol = rng.rand(T, S, D).astype(np.float32)
    vol[rng.rand(T, S, D) < 0.03] = np.nan
    vol[:, : S // 2, D - D // 3:] = np.nan
    vol[T // 2, 1, :] = np.nan
    d1 = (rng.rand(T, S) * 0.16).astype(np.float32)
    d2 = (rng.rand(T, S, D) * 0.16).astype(np.float32)
    d2[rng.rand(T, S, D) < 0.05] = 10.0
    return tuple(torch.as_tensor(a, device=dev) for a in (vol, d1, d2))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("entry", ["sgm_scan", "sgm_step"])
@pytest.mark.parametrize("T,S,D", [(37, 50, 70), (9, 131, 228), (64, 3, 32),
                                   (5, 7, 1)])
def test_scan_sweep_kernels_match_plain(dev, entry, T, S, D, reverse):
    """The two scan-form entries against ``sweep_scan_plain`` on the
    same tensors (a reverse sweep: on the tensors reversed in steps, its
    result reversed back): the same f32 operations in the same order, so
    equal bit for bit, NaN masks included; one kernel launch a call; D
    below, at and off a multiple of 32, and off a multiple of 4 (70 and
    1: the rows padded to a pitch of whole float4s)."""
    vol, d1, d2 = _scan_case(np.random.RandomState(T + D), T, S, D, dev)
    pen = sgm.pen_table(1.32, 24.25, 3.0, 2.0, 2.0, 1.0)
    sweep = sgm.sweep_stream if entry == "sgm_scan" else sgm.sweep_grid
    _build.reset_launches()
    got = sweep(vol, d1, d2, tau=0.08, pen=pen, reverse=reverse)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[entry] == 1
    assert _build.KERNEL_LAUNCHES[entry] == 1
    if reverse:
        want = sgm.sweep_scan_plain(vol.flip(0), d1.flip(0), d2.flip(0),
                                    tau=0.08, pen=pen).flip(0)
    else:
        want = sgm.sweep_scan_plain(vol, d1, d2, tau=0.08, pen=pen)
    assert got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("form", ["stream", "grid"])
def test_scan_forms_equal_the_slab_form(dev, form):
    """``sgm_multi`` in the scan forms on the card against the slab
    form on the card: the same two sweep results per family, added in
    either order, so equal."""
    rng = np.random.RandomState(3)
    D, H, W = 70, 23, 150
    x0 = torch.as_tensor((rng.rand(H, W) * 0.2).astype(np.float32), device=dev)
    x1 = torch.as_tensor((rng.rand(H, W) * 0.2).astype(np.float32), device=dev)
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    vols = {}
    for k in (-1, 1):
        v = rng.rand(D, H, W).astype(np.float32)
        v[np.broadcast_to((xs + ds * k < 0) | (xs + ds * k >= W), v.shape)] = np.nan
        vols[k] = torch.as_tensor(v, device=dev)
    kw = dict(pi1=1.32, pi2=24.25, tau_so=0.08, alpha1=2.0, sgm_q1=3.0,
              sgm_q2=2.0)
    want = sgm.sgm_multi(x0, x1, vols, form="slab", **kw)
    _build.reset_launches()
    got = sgm.sgm_multi(x0, x1, vols, form=form, **kw)
    torch.cuda.synchronize()
    entry = "sgm_scan" if form == "stream" else "sgm_step"
    assert _build.launches()[entry] == 4
    assert _build.LAUNCHES["sgm_hslab"] == _build.LAUNCHES["sgm_vertical"] == 0
    for k in (-1, 1):
        assert torch.equal(got[k].isnan(), want[k].isnan())
        assert torch.equal(got[k].nan_to_num(), want[k].nan_to_num())


@pytest.mark.parametrize("maps,H,W,D", [
    ("random", 37, 300, 64),
    ("probe", 9, 300, 40),     # W off a multiple of the 256 threads a block
    ("probe", 6, 513, 228),
    ("probe", 5, 30, 64),      # W < D
    ("probe", 7, 50, 1),       # D = 1
    ("probe", 4, 2100, 200)])  # more columns than a thread's first loads
def test_outlier_kernel_matches_plain(dev, maps, H, W, D):
    """The kernel against ``outlier_detection_plain`` on the card, equal,
    one launch a call: on random maps, and on ``probe_maps`` (values at
    k +- 1.1f and an ulp either side, negative, past D, NaN, +-inf, 1e30);
    its footprint as ``outlier.smem_bytes`` reckons it."""
    if maps == "random":
        rng = np.random.RandomState(3)
        d1 = rng.randint(0, D, size=(H, W)).astype(np.float32)
        d0 = d1.copy()
        m = rng.rand(H, W) < 0.4
        d0[m] = rng.randint(0, D, size=int(m.sum())) + 0.3
    else:
        d0, d1 = outlier.probe_maps(W, H, W, D)
    t0, t1 = torch.as_tensor(d0, device=dev), torch.as_tensor(d1, device=dev)
    before = _build.launches()["outlier"]
    got = outlier.outlier_detection(t0, t1, D)
    torch.cuda.synchronize()
    assert _build.launches()["outlier"] == before + 1
    want = outlier.outlier_detection_plain(t0, t1, D)
    assert torch.equal(got, want)
    assert outlier._lib().outlier_smem_bytes(W) == outlier.smem_bytes(W)


def test_outlier_kernel_takes_the_widest_rows(dev):
    """The widest rows whose footprint a block holds run (above 48 KB of
    shared memory, so the launch raises the kernel's limit) and equal the
    plain version; one column more is refused."""
    W = _build.MAX_SMEM // outlier.smem_bytes(1)
    assert outlier.smem_bytes(W) <= _build.MAX_SMEM < outlier.smem_bytes(W + 1)
    d0, d1 = outlier.probe_maps(5, 2, W, 228)
    t0, t1 = torch.as_tensor(d0, device=dev), torch.as_tensor(d1, device=dev)
    got = outlier.outlier_detection(t0, t1, 228)
    assert torch.equal(got, outlier.outlier_detection_plain(t0, t1, 228))
    z = torch.zeros((2, W + 1), device=dev)
    with pytest.raises(ValueError, match="bad shapes"):
        outlier.outlier_detection(z, z, 228)


@pytest.mark.parametrize("H,W,sigma", [
    (67, 141, 1.67), (67, 141, 7.74),
    (19, 263, 7.74),   # a width off a multiple of the 8 columns a thread
    (11, 30, 7.74),    # an image smaller than the 49 x 49 window
    (9, 77, 0.3)])     # k = 3
def test_blur_kernel_matches_plain(dev, H, W, sigma):
    """The kernel against ``mean2d_plain``, which sums in another order,
    to 1e-4 (values below 20); its footprint as ``blur.smem_bytes``
    reckons it; and a kernel too large for a block's shared memory is
    refused."""
    rng = np.random.RandomState(4)
    img = torch.as_tensor((rng.rand(H, W) * 20).astype(np.float32),
                          device=dev)
    kern = torch.as_tensor(blur.gaussian_kernel(sigma), device=dev)
    before = _build.launches()["blur"]
    got = blur.mean2d(img, kern, 5.0)
    want = blur.mean2d_plain(img, kern, 5.0)
    assert _build.launches()["blur"] == before + 1
    assert float((got - want).abs().max()) <= 1e-4
    k = kern.shape[0]
    assert blur._lib().blur_smem_bytes(k) == blur.smem_bytes(k)
    big = 2 * next(j for j in range(1, 200)
                   if blur.smem_bytes(2 * j + 1) > _build.MAX_SMEM) + 1
    with pytest.raises(ValueError, match="bad shapes"):
        blur.mean2d(img, torch.ones((big, big), device=dev), 5.0)


def _bits(a):
    return a.contiguous().view(torch.int32)


def _labels(rng, H, W, p=(.5, .2, .3)):
    return rng.choice([0.0, 1.0, 2.0], (H, W), p=p).astype(np.float32)


@pytest.mark.parametrize("H,W", [(37, 300), (9, 600), (5, 3), (2, 1226),
                                 (3, 46080), (4, 8193), (3, 46081), (7, 1501)])
def test_occlusion_fill_kernel_is_bit_identical(dev, H, W):
    """``occlusion_fill`` against ``interpolate_occlusion_plain``, bit for
    bit, one launch a call: rows with no match, rows whose matches lie
    right of the occlusions only, a row whose only match is its last
    column, random rows, values with NaN of two payloads and -0.0; rows of
    one segment (up to 4096 columns), of three and of twelve (46080, the
    widest row a block took when the row was staged in shared memory,
    and one more), and an odd width (scalar loads)."""
    rng = np.random.RandomState(H + W)
    d0 = (rng.rand(H, W) * 100).astype(np.float32)
    d0[rng.rand(H, W) < 0.05] = np.nan
    d0.view(np.int32)[rng.rand(H, W) < 0.05] = 0x7fc00123
    d0[rng.rand(H, W) < 0.05] = -0.0
    lab = _labels(rng, H, W, (.3, .5, .2))
    lab[0] = np.where(lab[0] == 0.0, 1.0, lab[0])
    if H > 2:
        lab[1, :W // 2] = 1.0
        lab[1, -1] = 0.0
    if H > 3:
        lab[2] = 1.0
        lab[2, -1] = 0.0
    d0, lab = (torch.as_tensor(a, device=dev) for a in (d0, lab))
    before = _build.launches()["occlusion_fill"]
    got = post.interpolate_occlusion(d0, lab)
    torch.cuda.synchronize()
    assert _build.launches()["occlusion_fill"] == before + 1
    assert torch.equal(_bits(got), _bits(post.interpolate_occlusion_plain(
        d0, lab)))


@pytest.mark.parametrize("case", ["random", "all mismatch", "edges", "cnt 0",
                                  "nan", "clustered", "crowded"])
@pytest.mark.parametrize("H,W", [(37, 150), (70, 33)])
def test_mismatch_fill_kernel_is_bit_identical(dev, case, H, W):
    """``mismatch_fill`` (a walk of each ray) against the plain version's
    pointer doubling, bit for bit, one launch a call: random labels, an
    all-mismatch map, mismatch against row 0 and column 0 (the half
    directions' -0.5 rule), a map where most pixels land nothing, NaN
    among the values that land, a MISMATCH block larger than one 32 x 8
    tile among sparse MISMATCH pixels (dense tiles walk a thread a pixel,
    sparse ones a warp a pixel), and tiles with more MISMATCH pixels than
    the block has warps: 9, 40, 64 (the most a sparse tile holds) and 65
    (the fewest a dense one does)."""
    rng = np.random.RandomState(H * W)
    d0 = (rng.rand(H, W) * 100).astype(np.float32)
    lab = _labels(rng, H, W)
    if case == "clustered":
        lab = np.where(rng.rand(H, W) < 0.01, 2.0, lab % 2).astype(np.float32)
        lab[4:H - 3, 3:W - 5] = 2.0
        lab[H // 2, W // 2] = 0.0
    elif case == "crowded":
        lab = lab % 2
        for ty, n in enumerate((9, 40, 64, 65)):
            rows = slice(8 * ty, min(8 * ty + 8, H))
            tile = lab[rows, :32]
            k = rng.permutation(tile.size)[:min(n, tile.size)]
            tile.flat[k] = 2.0
            lab[rows, :32] = tile
    elif case == "all mismatch":
        lab[:] = 2.0
    elif case == "edges":
        lab[:8], lab[:, :8] = 2.0, 2.0
        lab[0, ::3], lab[::3, 0] = 0.0, 1.0
    elif case == "cnt 0":
        lab[:] = 2.0
        lab[H // 3, W // 4] = 0.0
    elif case == "nan":
        d0[rng.rand(H, W) < 0.05] = np.nan
    d0, lab = (torch.as_tensor(a, device=dev) for a in (d0, lab))
    before = _build.launches()["mismatch_fill"]
    got = post.interpolate_mismatch(d0, lab)
    torch.cuda.synchronize()
    assert _build.launches()["mismatch_fill"] == before + 1
    assert torch.equal(_bits(got), _bits(post.interpolate_mismatch_plain(
        d0, lab)))


def _median_input(rng, H, W, case):
    img = (rng.randint(0, 20, (H, W)) + rng.choice([0, .5], (H, W))
           ).astype(np.float32)
    bits = img.view(np.int32)
    if case == "nan":
        img[rng.rand(H, W) < 0.03] = np.nan
        bits[rng.rand(H, W) < 0.02] = 0x7fc00123  # a NaN of another payload
        img[rng.rand(H, W) < 0.02] = np.inf
        img[rng.rand(H, W) < 0.02] = -np.inf
    elif case == "interior nan":
        # NaN of two payloads, -0.0 and inf in interior tiles only
        for y, x in ((12, 40), (20, 75), (27, 100)):
            img[y, x] = np.nan
        bits[13, 45] = 0x7fc00123
        img[21, 70], img[28, 110] = -0.0, np.inf
    elif case == "signed zeros":
        img[:] = rng.choice([0.0, -0.0, 1.0, -1.0], (H, W), p=[.3, .3, .2, .2])
    elif case in ("kitti", "mb"):
        img = (rng.rand(H, W) * 228).astype(np.float32)
    return img


@pytest.mark.parametrize("H,W,case", [
    (37, 150, "ties"), (5, 5, "ties"), (3, 2, "ties"), (1, 40, "ties"),
    (67, 141, "nan"), (37, 150, "signed zeros"), (40, 150, "interior nan"),
    (40, 151, "ties"), (37, 150, "misaligned"), (370, 1226, "kitti"),
    (1000, 1500, "mb")])
def test_median5_kernel_is_bit_identical(dev, H, W, case):
    """``median5`` against ``median2d_plain(·, 5)``, bit for bit, one
    launch a call: maps smaller than the window or a lane's 6 x 8 union, a
    width off a multiple of the block's 32 columns and an odd one (scalar
    staging), repeated values, NaN of two payloads and infinities among
    them (torch.minimum / torch.maximum semantics), -0.0 next to +0.0
    (windows whose median is zero), NaN, -0.0 and inf in interior tiles
    only (those tiles plain, the rest fast), a map 4 bytes off 8-byte
    alignment, and random KITTI- and mb-sized maps (every interior lane
    fast). Another kernel size raises on the card."""
    rng = np.random.RandomState(H * W)
    img = torch.as_tensor(_median_input(rng, H, W, case), device=dev)
    t = img
    if case == "misaligned":
        flat = torch.empty(H * W + 1, device=dev)
        t = flat[1:].view(H, W)
        t.copy_(img)
    before = _build.launches()["median5"]
    got = post.median2d(t, 5)
    torch.cuda.synchronize()
    assert _build.launches()["median5"] == before + 1
    assert torch.equal(_bits(got), _bits(post.median2d_plain(t, 5)))
    with pytest.raises(ValueError, match="kernel_size 5"):
        post.median2d(t, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("layout", ["hwd", "hwd xrev", "dhw", "dhw sliced",
                                    "hwd xrev pitch"])
@pytest.mark.parametrize("H,W", [(23, 77), (9, 130)])
def test_subpixel_kernel_is_bit_identical(dev, dtype, layout, H, W):
    """``subpixel`` against the plain parabola, bit for bit, one launch a
    call, reading each layout in place through its strides: the HWD
    lane's (H, Wp, Dp) in storage order, its x-reversed volume with
    pad columns read from the natural map, the generic lane's (D, H, W),
    and a (D, H, W) slice of a larger volume (strides that are not its
    shape's); the x-reversed volume as a view whose disparity rows are off
    16 bytes (pitch Dp + 2, first lane 1); widths that are not a multiple
    of the block's 32 columns; f32, bf16 and f16 storage; NaN samples,
    flat triples at the threshold, d outside [1, D - 1) and past the
    volume, a NaN d0 and huge ones."""
    rng = np.random.RandomState(5)
    D, Wp, Dp = 40, 96 if W < 96 else 160, 64
    d0 = (rng.randint(-1, D + 2, (H, W))
          + rng.choice([0, .5, .99], (H, W))).astype(np.float32)
    d0[0, :5] = [np.nan, 3e9, -3e9, Dp, Dp - 1]
    d0 = torch.as_tensor(d0, device=dev)
    vol = rng.rand(D + 3, H + 2, W + 4).astype(np.float32)
    vol[rng.rand(*vol.shape) < 0.05] = np.nan
    vol[:, :, ::5] = 0.5
    vol = torch.as_tensor(vol, device=dev).to(dtype)
    dhw = vol[:D, :H, :W].contiguous()
    thresh = 4e-5 if layout.startswith("hwd") else 1e-5
    before = _build.launches()["subpixel"]
    if layout == "dhw":
        got = post.subpixel_enhancement(d0, dhw, D)
        want = post.subpixel_enhancement_plain(d0, dhw, D)
    elif layout == "dhw sliced":
        got = post.subpixel_enhancement(d0, vol[1:D + 1, 2:, 3:W + 3], D)
        want = post.subpixel_enhancement_plain(d0, vol[1:D + 1, 2:, 3:W + 3],
                                               D)
    else:
        pitch = layout == "hwd xrev pitch"
        hwd = torch.full((H, Wp, Dp + 2 * pitch), float("nan"), device=dev,
                         dtype=dtype)
        if pitch:
            hwd = hwd[:, :, 1:Dp + 1]
        xrev = layout.startswith("hwd xrev")
        hwd[:, :W, :D] = dhw.permute(1, 2, 0).flip(1) if xrev \
            else dhw.permute(1, 2, 0)
        if xrev:
            got = post.subpixel_enhancement_hwd(d0, hwd, D, thresh, xrev=True)
        else:
            hwd = hwd[:, :W]
            got = post.subpixel_enhancement_hwd(d0, hwd, D, thresh)
        want = post.subpixel_enhancement_hwd_plain(d0, hwd, D, thresh,
                                                   xrev=xrev)
    torch.cuda.synchronize()
    assert _build.launches()["subpixel"] == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))


def test_refine_wrappers_refuse_what_the_kernels_do_not_take(dev):
    z = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError, match="float32"):
        post.interpolate_mismatch(z.double(), z)
    with pytest.raises(ValueError, match="bad shapes"):
        post.interpolate_occlusion(z, z[:3])
    with pytest.raises(ValueError, match="CUDA tensor"):
        post.interpolate_mismatch(z, z.cpu())
    with pytest.raises(ValueError, match="bad shapes"):
        post.median2d(torch.zeros(8, device=dev), 5)
    vol = torch.zeros((4, 8, 16), device=dev)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        post.subpixel_enhancement_hwd(z, vol.double(), 10)
    with pytest.raises(ValueError, match="bad shapes"):
        post.subpixel_enhancement_hwd(z, vol[:, :7], 10, xrev=True)
    with pytest.raises(ValueError, match="bad shapes"):
        post.subpixel_enhancement_hwd(z, torch.zeros((4, 9, 16), device=dev),
                                      10)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    a = torch.zeros((64, 8, 128), device=dev)
    with pytest.raises(ValueError, match="n_fix"):
        join._join_plus(a, torch.zeros((64, 8, 256), device=dev), 20, 100, 60, 9)
    with pytest.raises(ValueError, match="channels"):
        join._join_plus(torch.zeros((64, 0, 128), device=dev),
                        torch.zeros((64, 0, 256), device=dev), 20, 100, 60, 0)
    with pytest.raises(ValueError, match="float32"):
        outlier.outlier_detection(torch.zeros((4, 8), device=dev,
                                              dtype=torch.float64),
                                  torch.zeros((4, 8), device=dev), 3)
    z = torch.zeros((4, 8, 96), device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        slow_head.slow_head_volume(z, z, torch.zeros((1, 96, 96), device=dev),
                                   z[0, 0], z[0, 0], 0.0, 3)
    with pytest.raises(ValueError, match="bad shapes"):
        slow_head.slow_head_volume(
            z, z, torch.zeros((1, 96, 96), device=dev, dtype=torch.bfloat16),
            torch.zeros((1, 96), device=dev), z[0, 0], 0.0, 3)
    pen = sgm.pen_table(1.0, 2.0, 3.0, 2.0, 1.0, 1.0)
    # the generic lane's three sweep entries take float32 only, and the
    # HWD entries one storage dtype for the volume, accumulator and sum
    for dt in (torch.bfloat16, torch.float16):
        v16 = torch.zeros((4, 8, 96), device=dev, dtype=dt)
        with pytest.raises(ValueError, match="float32"):
            sgm._sweep_hslab(v16, None, v16.clone(), z[:, :, 0].contiguous(),
                             torch.zeros((8, 4 + 4 + 96), device=dev),
                             reverse=False, D=4, n_rev=0, rev_base=4, tau=0.1,
                             pen=pen)
        for sweep in (sgm.sweep_stream, sgm.sweep_grid):
            with pytest.raises(ValueError, match="float32"):
                sweep(v16, z[:, :, 0].contiguous(), z, tau=0.1, pen=pen)
        with pytest.raises(ValueError, match=str(dt)):
            sgm._sweep(v16, z, v16.clone(), None, z[:, :, 0].contiguous(),
                       torch.zeros((4, 4 + 8 + 96), device=dev),
                       vertical=True, reverse=False, T=4, D=4, tau=0.1,
                       pen=pen)
    with pytest.raises(ValueError, match="out_dtype"):
        join._join_plus(a, torch.zeros((64, 8, 256), device=dev), 20, 100, 60,
                        0, d_true=21)
    for sweep in (sgm.sweep_stream, sgm.sweep_grid):
        d1 = z[:, :, 0].contiguous()
        with pytest.raises(ValueError, match="bad shapes"):
            sweep(z, d1, z[:, :, :95].contiguous(), tau=0.1, pen=pen)
        with pytest.raises(ValueError, match="contiguous"):
            sweep(z, z[:, :, 0], z, tau=0.1, pen=pen)
        with pytest.raises(ValueError, match="CUDA tensor"):
            sweep(z, d1.cpu(), z, tau=0.1, pen=pen)


@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_train_chunk_on_the_card_matches_the_cpu(dev, tmp_path, arch):
    """chip_smoke.py phase 8's card-against-CPU check at a small width
    (l1 = 2, fm = 16, bs = 32 on a 64x128 synthetic KITTI set): four
    steps of one sampled chunk from the same weights, the window gather
    on the card and on the CPU; TF32 off, so the per-step losses agree
    within 1e-5 relative and the weights within 1e-6, and the training
    launches one hand kernel, ``warp_patches``, once a step."""
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.data import datasets
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.train import augment, trainer

    datasets.make_synthetic_kitti(str(tmp_path / "data.kitti"), n_images=2,
                                  height=64, width=128, disp_max=16)
    over = dict(l1=2, fm=16, bs=32, data_dir=str(tmp_path))
    if arch == "slow":
        over.update(l2=2, nh2=32)
    cfg = make_config("kitti", arch, **over)
    ds = datasets.load_kitti(cfg)
    X0, X1 = np.asarray(ds.X0), np.asarray(ds.X1)
    chunk = trainer.stack_chunk(
        augment.AugmentSampler(cfg, np.random.RandomState(0)), ds,
        ds.nnz_tr[:64], 4, 16, X0, X1, device_gather=True)
    runs = {}
    for where in ("cpu", "cuda"):
        d = torch.device(where)
        net = towers.init_net(cfg).to(d)
        mom = [torch.zeros_like(p) for p in net.parameters()]
        _build.reset_launches()
        errs = trainer.train_chunk(
            cfg, net, mom, cfg.lr,
            {k: torch.as_tensor(v, device=d) for k, v in chunk.items()},
            augment.pad_image_stack(X0, X1, d))
        if where == "cuda":
            torch.cuda.synchronize()
            assert _build.launches() == dict(
                dict.fromkeys(_build.KERNELS, 0), warp_patches=4)
        runs[where] = errs.cpu(), [p.detach().cpu() for p in net.parameters()]
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], rtol=1e-5,
                               atol=1e-7)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_t7_fast_net_runs_kernels_1_to_5_like_the_net_in_memory(dev,
                                                                 tmp_path):
    """A kitti fast net (l1 = 2, fm = 16) dumped with ``params_to_t7``
    and loaded through ``cli.load_params`` (``-net_fname x.t7``): on the
    card its map is the in-memory net's bit for bit, through the join (2
    launches), the vertical and horizontal sweeps (4 each), the outlier
    labels, the blur and the four refinement kernels (1 each)."""
    from mccnn_tpu_torch import cli
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.models.import_t7 import params_to_t7
    from mccnn_tpu_torch.pipeline import stereo_predict

    H, W, D = 48, 200, 40
    base = np.random.RandomState(9).randn(H, W + D).astype(np.float32)
    x0, x1 = base[:, D:], base[:, :-D]
    cfg = make_config("kitti", "fast", a="predict", l1=2, fm=16)
    net = towers.init_net(cfg)
    path = str(tmp_path / "net.t7")
    params_to_t7(net, path, arch="fast", disp_max=D)
    cfg.net_fname = path
    loaded = cli.load_params(cfg)
    want = stereo_predict(cfg, net, x0, x1, D)
    _build.reset_launches()
    got = stereo_predict(cfg, loaded, x0, x1, D)
    torch.cuda.synchronize()
    counts = _build.launches()
    assert counts == dict(dict.fromkeys(_build.KERNELS, 0), join=2,
                          sgm_tables=2, sgm_vertical=4, sgm_horizontal=4,
                          outlier=1, blur=1, occlusion_fill=1,
                          mismatch_fill=1, subpixel=1, median5=1,
                          tower_bias_act=0, tower_normalize_pack=1,
                          tower_conv=2)
    assert torch.equal(got, want)


def test_cached_slow_run_launches_no_head(dev, tmp_path, monkeypatch):
    """kitti slow at narrow widths: ``-make_cache`` runs the head kernel
    once and writes ``cache/<id>.npz``; ``-use_cache`` reads it, launches
    the head no time, and gives the uncached map bit for bit."""
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.pipeline import stereo_predict

    monkeypatch.chdir(tmp_path)
    H, W, D = 40, 160, 24
    base = np.random.RandomState(10).randn(H, W + D).astype(np.float32)
    x0, x1 = base[:, D:], base[:, :-D]
    over = dict(a="test_te", l1=2, fm=8, l2=3, nh2=16)
    net = towers.init_net(make_config("kitti", "slow", **over))
    plain = stereo_predict(make_config("kitti", "slow", **over), net, x0, x1,
                           D)
    maps = {}
    for flag in ("make_cache", "use_cache"):
        _build.reset_launches()
        maps[flag] = stereo_predict(
            make_config("kitti", "slow", **over, **{flag: True}), net, x0,
            x1, D, pair_id="p")
        torch.cuda.synchronize()
        assert _build.launches()["slow_head"] == (flag == "make_cache"), flag
        assert _build.launches()["sgm_hslab"] == 2, flag
    assert (tmp_path / "cache" / "p.npz").exists()
    assert torch.equal(maps["make_cache"], plain)
    assert torch.equal(maps["use_cache"], plain)


def _card_mesh(n):
    from mccnn_tpu_torch.parallel.mesh import Mesh

    return Mesh([torch.device("cuda")] * n, ("data",))


@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_batch_lanes_on_a_repeated_card(dev, arch):
    """kitti fast on the serving lane (the HWD lane, kernels 1-5) and
    kitti slow on the generic batch lane (narrow widths), B=2 on
    [cuda:0, cuda:0] at 37x160, D=24: each map the card's own
    ``stereo_predict`` bit for bit, each kernel launched twice its
    single-pair count."""
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.parallel import inference
    from mccnn_tpu_torch.pipeline import stereo_predict

    H, W, D = 37, 160, 24
    rng = np.random.RandomState(21)
    x0b, x1b = (rng.randn(2, H, W).astype(np.float32) for _ in range(2))
    over = dict(l1=2, fm=8, l2=3, nh2=16) if arch == "slow" else {}
    cfg = make_config("kitti", arch, a="predict", **over)
    net = towers.init_net(cfg).to(dev)
    make = (inference.make_batch_predict_sharded if arch == "fast"
            else inference.make_batch_predict)
    want = [stereo_predict(cfg, net, x0b[b], x1b[b], D) for b in range(2)]
    _build.reset_launches()
    stereo_predict(cfg, net, x0b[0], x1b[0], D)
    torch.cuda.synchronize()
    one = _build.launches()
    _build.reset_launches()
    got = make(cfg, _card_mesh(2), D)(net, x0b, x1b)
    torch.cuda.synchronize()
    assert _build.launches() == {k: 2 * v for k, v in one.items()}
    for b in range(2):
        assert torch.equal(got[b], want[b])


@pytest.mark.parametrize("arch", ["census", "fast", "slow"])
def test_row_sharded_on_a_repeated_card(dev, arch):
    """One pair row-sharded over [cuda:0] * 4 at 37x160, D=24 (rows 10,
    9, 9, 9; columns 40 each): census (with its CBCA) equal to the card's
    single-device map bit for bit; fast and slow (narrow widths; the
    tower's convolutions on other heights) within 1% of pixels off by
    > 0.51; the join, head, hslab and vertical kernels launched once a
    shard and direction, the outlier and the subpixel kernel once a
    shard, the fills, the median and the blur once, CBCA once a shard,
    direction and iteration, its pack once a shard, the arms once an
    image; census's signatures once a shard and its volumes once a shard
    and direction; the generic lane's layout kernel and its tables once a
    row shard (horizontal) and once a column shard (vertical), the
    winner-take-all once a shard and direction, the family sum plain."""
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.parallel import inference
    from mccnn_tpu_torch.pipeline import stereo_predict

    H, W, D, n = 37, 160, 24, 4
    base = np.random.RandomState(22).randn(H, W + D).astype(np.float32)
    x0, x1 = base[:, D:], base[:, :-D]
    over = dict(l1=2, fm=8, l2=3, nh2=16) if arch == "slow" else {}
    cfg = make_config("kitti", arch, a="predict", **over)
    net = towers.init_net(cfg)
    net = None if net is None else net.to(dev)
    want = stereo_predict(cfg, net, x0, x1, D, sgm_form="slab")
    _build.reset_launches()
    got = inference.make_sharded_predict(cfg, _card_mesh(n), D)(net, x0, x1)
    torch.cuda.synchronize()
    # CBCA a shard, direction and iteration (kitti census 4 + 8, slow 2,
    # fast none); the arms packed once a shard where an iteration runs,
    # and made once an image
    its = cfg.cbca_i1 + cfg.cbca_i2
    counts = dict(dict.fromkeys(_build.KERNELS, 0), sgm_hslab=2 * n,
                  sgm_vertical=2 * n, outlier=n, blur=1, occlusion_fill=1,
                  mismatch_fill=1, subpixel=n, median5=1, cross_arms=2,
                  cbca=2 * n * its, cbca_pack=n if its else 0,
                  sgm_layout=2 * n, sgm_generic_tables=2 * n, wta_dhw=2 * n)
    # the tower a shard: a convolution a layer (the bias and ReLU in its
    # epilogue, no bias kernel), the fast tower's last layer's bias and
    # normalization; the slow volumes' epilogue a shard
    counts.update({"fast": {"join": 2 * n, "tower_normalize_pack": n,
                            "tower_conv": 4 * n},
                   "slow": {"slow_head": n, "slow_volumes_epilogue": n,
                            "tower_conv": 2 * n},
                   "census": {"census_signatures": n,
                              "census_volume": 2 * n}}[arch])
    assert _build.launches() == counts
    if arch == "census":
        assert torch.equal(got, want)
    else:
        assert float(((got - want).abs() > 0.51).float().mean()) < 0.01


def _cross_case(dev, rng, D, H, W, L1, direction, d_true=None):
    """Arms of a textured pair (flat patches, so arms of every length) and
    a volume with NaN out of frame and scattered, -0.0 cells, and 1e9
    planes d >= ``d_true``, on the card."""
    tau1 = {0: 0.01, 3: 0.03, 5: 0.13, 14: 0.02, 7: 0.05}[L1]
    imgs = rng.randn(2, H, W).astype(np.float32) * 0.1
    imgs[:, H // 5:H // 2, W // 6:W // 2] = 0.3
    arms = [cross.cross_arms_plain(torch.as_tensor(x, device=dev), L1, tau1)
            for x in imgs]
    vol = rng.rand(D, H, W).astype(np.float32)
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    vol[np.broadcast_to((xs + ds * direction < 0)
                        | (xs + ds * direction >= W), vol.shape)] = np.nan
    vol[rng.rand(D, H, W) < 0.05] = np.nan
    vol[(rng.rand(D, H, W) < 0.05) & ~np.isnan(vol)] = -0.0
    if d_true is not None:
        vol[d_true:] = 1e9
    return arms, torch.as_tensor(vol, device=dev)


# L1 -> tau1: the configs' K (2, 3, 5, 14); K = 6, 9, 10, 11, 13, whose
# arms run past the kernel's first windows (k = 2 .. 4) into its second
# (k = 5 .. 13); K = 15, 22, 23, whose arms walk past those (from k = 14,
# 8 probes a chunk: the walk ends at, and one past, a chunk's edge); K
# past 64
ARMS_TAU1 = {0: 0.01, 3: 0.03, 5: 0.13, 14: 0.02, 6: 0.05, 9: 0.05,
             10: 0.05, 11: 0.05, 13: 0.05, 15: 0.05, 22: 0.05, 23: 0.05,
             70: 0.08}


@pytest.mark.parametrize("L1", list(ARMS_TAU1))
@pytest.mark.parametrize("H,W,kind", [
    (37, 150, ""), (5, 3, ""), (67, 301, ""), (37, 150, "nan"),
    (1, 97, ""), (80, 1, ""), (33, 2, "nan"), (40, 96, "misaligned")])
def test_cross_arms_kernel_is_bit_identical(dev, L1, H, W, kind):
    """``cross_arms`` against ``cross_arms_plain`` on the card, bit for
    bit, one launch a call: the K of census, ad, slow and mb slow, K
    around the edge of the register windows and of the walk's chunks
    (``ARMS_TAU1``) and K = 70 (> 64), on a texture with a flat patch
    (arms of every length); odd shapes, one smaller than the window, a
    single row and a single column (K past H or W); NaN pixels (``nan``:
    10% and a block, never a break); and an image 4 bytes off an 8-byte
    boundary (``misaligned``: the 4-byte path at an even W)."""
    rng = np.random.RandomState(H + W + L1)
    x = rng.randn(H, W).astype(np.float32) * 0.1
    x[H // 5:H // 2, W // 6:W // 2] = 0.3
    if kind == "nan":
        x[rng.rand(H, W) < 0.1] = np.nan
        x[H // 3:H // 2 + 1, :W // 3 + 1] = np.nan
    x = torch.as_tensor(x, device=dev)
    if kind == "misaligned":
        flat = torch.empty(H * W + 1, device=dev)
        flat[1:] = x.flatten()
        x = flat[1:].view(H, W)
        assert x.data_ptr() % 8 == 4 and x.is_contiguous()
    tau1 = ARMS_TAU1[L1]
    before = _build.launches()["cross_arms"]
    got = cross.cross_arms(x, L1, tau1)
    torch.cuda.synchronize()
    assert _build.launches()["cross_arms"] == before + 1
    assert torch.equal(_bits(got), _bits(cross.cross_arms_plain(x, L1, tau1)))


@pytest.mark.parametrize("L1", [0, 3, 5, 14, 7])
@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("D,H,W", [(20, 37, 150), (7, 5, 3), (30, 67, 301)])
def test_cbca_kernel_is_bit_identical(dev, L1, direction, D, H, W):
    """``cbca`` against ``cbca_plain`` on the card, bit for bit
    (``.view(torch.int32)``: NaN payloads and signed zeros included), one
    launch a call and one of ``cbca_pack``: K = 2, 3, 5, 14 and the
    run-time instance (L1 = 7), both directions, NaN and -0.0 cells, 1e9
    planes (``disp_true``), odd H and W off the block's 64 x 64 tile, a
    frame smaller than the window, disparities past the width."""
    arms, vol = _cross_case(dev, np.random.RandomState(D + H + L1), D, H, W,
                            L1, direction, d_true=D - 3)
    before = _build.launches()
    got = cross.cbca(*arms, vol, direction, L1)
    torch.cuda.synchronize()
    after = _build.launches()
    assert (after["cbca"], after["cbca_pack"]) == (before["cbca"] + 1,
                                                   before["cbca_pack"] + 1)
    assert torch.equal(_bits(got), _bits(cross.cbca_plain(*arms, vol,
                                                          direction, L1)))


@pytest.mark.parametrize("L1", [0, 5, 14])
def test_cbca_kernel_reads_a_given_pack(dev, L1):
    """``cbca`` handed its arms' pack (``packed``, as the generic lane
    hands every iteration of a pair one pack) launches the CBCA kernel
    alone and gives the bits of a call that packs them itself, in both
    directions from the one pack."""
    arms, vol = _cross_case(dev, np.random.RandomState(L1 + 9), 12, 37, 150,
                            L1, 1)
    packed = cross.cbca_pack(*arms, L1)
    for direction in (-1, 1):
        want = cross.cbca(*arms, vol, direction, L1)
        before = _build.launches()
        got = cross.cbca(*arms, vol, direction, L1, packed=packed)
        torch.cuda.synchronize()
        after = _build.launches()
        assert (after["cbca"], after["cbca_pack"]) == (before["cbca"] + 1,
                                                       before["cbca_pack"])
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("L1", [0, 5, 14])
def test_cbca_kernel_on_a_row_slab(dev, L1):
    """Row slabs with the arms' rows relative to the slab, as
    ``RowShards.cbca`` builds them (the halo rows' arms point outside the
    slab): the kernel equals the plain version on each slab bit for bit,
    and the slab's own rows the whole frame's."""
    D, H, W = 24, 70, 200
    arms, vol = _cross_case(dev, np.random.RandomState(L1), D, H, W, L1, -1,
                            20)
    whole = cross.cbca(*arms, vol, -1, L1)
    halo = max(2, L1) - 1
    for lo, hi in ((0, 18), (18, 36), (36, 53), (53, 70)):
        a, b = max(0, lo - halo), min(H, hi + halo)
        slab_arms = [torch.cat([c[:2, a:b], c[2:, a:b] - a]) for c in arms]
        slab = vol[:, a:b].contiguous()
        got = cross.cbca(*slab_arms, slab, -1, L1)
        assert torch.equal(_bits(got), _bits(cross.cbca_plain(
            *slab_arms, slab, -1, L1)))
        assert torch.equal(_bits(got[:, lo - a:hi - a]),
                           _bits(whole[:, lo:hi]))


@pytest.mark.parametrize("L1", [0, 3, 5, 14, 7])
@pytest.mark.parametrize("H,W", [(37, 150), (5, 3), (70, 200)])
def test_cbca_pack_kernel_is_bit_identical(dev, L1, H, W):
    """``cbca_pack`` against ``cbca_pack_plain`` on the card, bit for
    bit, one launch a call: every K of the configs and a run-time one,
    on arms longer than K (L1 = 14's, clamped) and a row slab's
    relative arms."""
    rng = np.random.RandomState(H + L1)
    arms, _ = _cross_case(dev, rng, 2, H, W, 14, 1)
    for a in (arms, [torch.cat([c[:2, 1:H - 1], c[2:, 1:H - 1] - 1])
                     for c in arms]):
        before = _build.launches()["cbca_pack"]
        got = cross.cbca_pack(*a, L1)
        torch.cuda.synchronize()
        assert _build.launches()["cbca_pack"] == before + 1
        assert torch.equal(got, cross.cbca_pack_plain(*a, L1))


def test_cross_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """The launchers take float32, contiguous operands on the card and
    cast or copy nothing: a 16-bit volume, a strided volume or arm stack,
    an operand on the CPU, an L1 past the widest window built (64) and
    one whose block exceeds the shared memory, and a pack of another
    dtype, size or device raise ValueError; ``cbca`` on a CUDA volume
    launches (no fallback)."""
    arms, vol = _cross_case(dev, np.random.RandomState(1), 6, 9, 40, 5, 1)
    with pytest.raises(ValueError, match="float32"):
        cross.cbca(*arms, vol.to(torch.bfloat16), 1, 5)
    with pytest.raises(ValueError, match="contiguous"):
        cross.cbca(*arms, vol.transpose(1, 2).contiguous().transpose(1, 2), 1,
                   5)
    with pytest.raises(ValueError, match="contiguous"):
        cross.cbca(arms[0].transpose(1, 2).contiguous().transpose(1, 2),
                   arms[1], vol, 1, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cross.cbca(arms[0].cpu(), arms[1], vol, 1, 5)
    with pytest.raises(ValueError, match="bad shapes"):
        cross.cbca(arms[0][:, :8].contiguous(), arms[1], vol, 1, 5)
    with pytest.raises(ValueError, match="widest window"):
        cross.cbca(*arms, vol, 1, cross.KMAX + 1)
    with pytest.raises(ValueError, match="exceeds"):
        cross.cbca_pack(*arms, cross.KMAX + 1)
    packed = cross.cbca_pack(*arms, 5)
    for bad in (packed.int(), packed[:-1], packed.cpu()):
        with pytest.raises(ValueError, match="packed"):
            cross.cbca(*arms, vol, 1, 5, packed=bad)
    big = next(L1 for L1 in range(2, 1000)
               if cross.cbca_smem_bytes(L1) > _build.MAX_SMEM)
    with pytest.raises(ValueError, match="widest window|shared memory"):
        cross.cbca(*arms, vol, 1, big)
    with pytest.raises(ValueError, match="float32"):
        cross._arms_launch(vol[0].double(), 5, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        cross._arms_launch(vol[0].t(), 5, 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cross._arms_launch(vol[0].cpu(), 5, 0.1)
    assert cross._lib().cbca_smem_bytes(14) == cross.cbca_smem_bytes(14)


# --- the cost volumes and the HWD lane's SGM tables (csrc/costs.cu,
# csrc/sgm_tables.cu): bit for bit with their plain versions -------------

def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _cost_images(dev, seed, shape):
    """Quarter-step images (census ties) on the card."""
    rng = np.random.RandomState(seed)
    return tuple(torch.as_tensor((np.round(rng.randn(*shape) * 4) / 4)
                                 .astype(np.float32), device=dev)
                 for _ in range(2))


def _adversarial_cost_images(dev, seed, shape):
    """``_cost_images`` with NaN of two payloads, +inf, -inf and -0.0
    beside +0.0 at random cells, the first and last of the frame among
    them."""
    x0, x1 = (x.cpu().numpy() for x in _cost_images(dev, seed, shape))
    rng = np.random.RandomState(seed + 1)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32)
    for x in (x0, x1):
        flat = x.reshape(-1)
        idx = rng.choice(flat.size, size=max(2, flat.size // 9),
                         replace=False)
        idx[:2] = 0, flat.size - 1
        flat[idx] = specials[rng.randint(0, len(specials), size=idx.size)]
        flat.view(np.uint32)[idx[1::7]] = 0x7fc00123
    return tuple(torch.as_tensor(x, device=dev) for x in (x0, x1))


CENSUS_CUDA = [(9, 130, 1, 4, 70), (5, 40, 3, 2, 45), (37, 300, 1, 2, 33),
               (3, 6, 1, 4, 4), (20, 77, 3, 7, 40), (64, 257, 1, 4, 100),
               (9, 131, 1, 0, 33), (5, 126, 3, 7, 65), (3, 50, 1, 4, 228),
               (33, 1226, 1, 4, 70), (4, 61, 2, 2, 36), (5, 9, 1, 1, 6),
               (1, 80, 1, 3, 20), (40, 1, 1, 5, 3), (21, 70, 2, 6, 30),
               (17, 65, 1, 5, 40), (370, 1226, 1, 4, 12)]


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("H,W,C,r,D", CENSUS_CUDA)
def test_census_kernels_are_bit_identical(dev, H, W, C, r, D, direction):
    """The signature pass word for word and the volume pass bit for bit
    (NaN masks included) against the plain versions on the card, on
    images with ties, NaN of two payloads, +-inf and -0.0 beside +0.0:
    gray and rgb (C = 2, 3), every radius 0 to 7 (one to four words), W
    off a multiple of the 128-column block and of the signature tile's
    32 columns (odd, 2 mod 4, below one block, KITTI's 1226), H off the
    signature tile's 16 rows, one row, one column, D off the
    32-disparity chunk, spans that leave the frame on both sides (D past
    W), a frame smaller than the window, the KITTI frame; every frame
    holds the columns r - 1, r, W - r - 1 and W - r at the interior
    mask's edge; one launch a call, and two for a volume not handed its
    signatures."""
    shape = (H, W) if C == 1 else (C, H, W)
    x0, x1 = _adversarial_cost_images(dev, H + W + r, shape)
    _build.reset_launches()
    sig = costs.census_signatures(x0, x1, r)
    torch.cuda.synchronize()
    assert _build.launches()["census_signatures"] == 1
    assert torch.equal(sig, costs.census_signatures_plain(x0, x1, r))
    a, b = (x0, x1) if direction == -1 else (x1, x0)
    halves = (sig[0], sig[1]) if direction == -1 else (sig[1], sig[0])
    got = costs.census_volume(a, b, D, direction, r, signatures=halves)
    torch.cuda.synchronize()
    assert _build.launches()["census_volume"] == 1
    want = costs.census_volume_plain(a, b, D, direction, r)
    assert want.isnan().any() and _same_bits(got, want)
    again = costs.census_volume(a, b, D, direction, r)
    torch.cuda.synchronize()
    assert _build.launches()["census_signatures"] == 2
    assert _build.launches()["census_volume"] == 2
    assert _same_bits(again, want)


AD_CUDA = [(9, 130, 4, 70), (40, 7, 4, 9), (37, 300, 2, 33), (3, 6, 4, 4),
           (70, 257, 7, 100), (33, 64, 0, 5), (33, 131, 0, 17),
           (65, 126, 7, 33), (31, 50, 4, 60), (40, 1226, 2, 40),
           (35, 10, 2, 18)]


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("H,W,r,D", AD_CUDA)
def test_ad_kernel_is_bit_identical(dev, H, W, r, D, direction):
    """The ad kernel against its plain version on the card, bit for bit:
    H off the 32-row tile, W off the 128-column tile (odd, 2 mod 4,
    below one tile, KITTI's 1226), D off the 16-disparity chunk, spans
    that leave the frame on both sides (D past W), radius 0, 2, 4, 7,
    frames smaller than the window; one launch a call."""
    rng = np.random.RandomState(H * W + r)
    x0, x1 = (torch.as_tensor(rng.randn(H, W).astype(np.float32), device=dev)
              for _ in range(2))
    _build.reset_launches()
    got = costs.ad_volume(x0, x1, D, direction, r)
    torch.cuda.synchronize()
    assert _build.launches()["ad_volume"] == 1
    want = costs.ad_volume_plain(x0, x1, D, direction, r)
    assert want.isnan().any() and _same_bits(got, want)


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("H,W,r,D", [(33, 131, 4, 17), (35, 126, 7, 40),
                                     (20, 50, 2, 60)])
def test_ad_kernel_is_bit_identical_with_nan_and_inf(dev, H, W, r, D,
                                                     direction):
    """NaN and inf in both images near both edges: the terms of window
    columns off the frame are +0 whatever x1 holds at their match, the
    terms of in-frame columns keep NaN * 0 = NaN; bit for bit."""
    rng = np.random.RandomState(H + W + r)
    a = rng.randn(2, H, W).astype(np.float32)
    a[1, :, :2] = np.nan
    a[1, H // 2, -1] = np.inf
    a[0, 3, W - 3] = np.nan
    x0, x1 = (torch.as_tensor(v, device=dev) for v in a)
    got = costs.ad_volume(x0, x1, D, direction, r)
    want = costs.ad_volume_plain(x0, x1, D, direction, r)
    assert _same_bits(got, want)


@pytest.mark.parametrize("xrev", [True, False])
@pytest.mark.parametrize("H,W,D,shape", [
    (45, 310, 150, join.pad_dims(45, 310, 150)),
    (5, 9, 4, (8, 12, 4)), (1, 6, 3, (3, 7, 5)), (6, 20, 7, (8, 21, 9)),
    (370, 1226, 228, join.pad_dims(370, 1226, 228)),
    (4, 3, 5, (5, 7, 6)), (7, 40, 9, (8, 44, 12)), (1, 33, 6, (1, 35, 8)),
    (3, 17, 2, (4, 20, 4)), (12, 30, 10, (13, 31, 11)),
    (1000, 1500, 200, join.pad_dims(1000, 1500, 200))])
def test_sgm_tables_kernel_is_bit_identical(dev, H, W, D, shape, xrev):
    """The four sweeps' tables of one direction in one launch, the whole
    buffer (alignment gaps and pad rows included) bit for bit with the
    plain build, on images with NaN of two payloads, +-inf and -0.0:
    ragged shapes, gw = D + Wp + Dp 0, 1, 2 and 3 mod 4 (D2 rows off 16
    bytes), Wp odd (D1 rows off 16 bytes), H = Hp = 1, one row, the KITTI
    and Middlebury join shapes."""
    rng = np.random.RandomState(H + W + D)
    a = rng.rand(2, H, W).astype(np.float32)
    a[0, -1, W // 2] = np.inf
    a[0, H // 2, 0] = -np.inf
    a[1, 0, W // 3] = np.nan
    a[1].view(np.uint32)[H - 1, 0] = 0x7fc00123
    a[1, -1, -1] = -0.0
    x0, x1 = (torch.as_tensor(v, device=dev) for v in a)
    _build.reset_launches()
    got = sgm.sgm_tables(x0, x1, D, H, W, shape, xrev=xrev)
    torch.cuda.synchronize()
    assert _build.launches()["sgm_tables"] == 1
    want = sgm.sgm_tables_plain(x0, x1, D, H, W, shape, xrev=xrev)
    assert _same_bits(got, want)


def test_row_sharded_census_volume_is_the_unsharded_slice(dev):
    """``row_volumes`` of kitti census on row shards (the halo the
    window reads) equals the rows of the whole pair's volumes, bit for
    bit; signatures once a shard."""
    from mccnn_tpu_torch import pipeline
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.parallel import inference

    H, W, D = 37, 160, 24
    x0, x1 = _cost_images(dev, 3, (H, W))
    cfg = make_config("kitti", "census", a="predict")
    whole = pipeline._volumes(None, x0, x1, arch="census", disp_max=D, ws=0)
    for lo, hi in ((0, 10), (10, 19), (19, 28), (28, 37)):
        _build.reset_launches()
        part = inference.row_volumes(cfg, None, x0, x1, lo, hi, D, dev)
        torch.cuda.synchronize()
        assert _build.launches()["census_signatures"] == 1
        for k in (-1, 1):
            assert _same_bits(part[k], whole[k][:, lo:hi].contiguous())


def test_cost_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """A radius past MAX_RADIUS, a direction other than -1 or +1,
    non-float32 images, an image on the CPU beside one on the card,
    signatures of another dtype, shape or device or not 16-byte aligned,
    and a table image on the CPU raise ValueError; nothing falls back."""
    x0, x1 = _cost_images(dev, 1, (9, 40))
    for fn in (lambda *a, **k: costs.census_volume(*a, 5, -1, **k),
               lambda *a, **k: costs.ad_volume(*a, 5, -1, **k),
               costs.census_signatures):
        with pytest.raises(ValueError, match="radius"):
            fn(x0, x1, radius=costs.MAX_RADIUS + 1)
        with pytest.raises(ValueError, match="float32"):
            fn(x0.double(), x1.double())
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x0, x1.cpu())
    for fn in (costs.census_volume, costs.ad_volume):
        for direction in (0, 2, -2):
            with pytest.raises(ValueError, match="direction"):
                fn(x0, x1, 5, direction)
    sig = costs.census_signatures(x0, x1)
    # a view 8 bytes past a 16-byte boundary: the kernel reads word pairs
    odd = torch.empty(sig[1].numel() + 1, dtype=torch.int64,
                      device=dev)[1:].view(sig[1].shape)
    for bad in ((sig[0].int(), sig[1]), (sig[0], sig[1][:, :5]),
                (sig[0], sig[1].cpu()), (sig[0], odd)):
        with pytest.raises(ValueError, match="signatures"):
            costs.census_volume(x0, x1, 5, -1, signatures=bad)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sgm.sgm_tables(x0, x1.cpu(), 5, 9, 40, (16, 48, 8), xrev=True)
    with pytest.raises(ValueError, match="do not fit"):
        sgm.sgm_tables(x0, x1, 5, 9, 40, (8, 48, 8), xrev=True)


def _generic_vols(dev, seed, D, H, W, dirs):
    """(D, H, W) volumes with the out-of-frame NaN masks, NaN of two
    payloads, -0.0 beside +0.0, +-inf and 1e9 cells, a column of ties and
    an all-NaN column, on the card."""
    rng = np.random.RandomState(seed)
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    vols = {}
    for k in dirs:
        v = rng.rand(D, H, W).astype(np.float32)
        v[np.broadcast_to((xs + ds * k < 0) | (xs + ds * k >= W), v.shape)] \
            = np.nan
        v[rng.rand(D, H, W) < 0.02] = np.nan
        v.view(np.uint32)[rng.rand(D, H, W) < 0.01] = 0x7fc00123
        v[rng.rand(D, H, W) < 0.02] = -0.0
        v[rng.rand(D, H, W) < 0.02] = 0.0
        v[rng.rand(D, H, W) < 0.01] = np.inf
        v[rng.rand(D, H, W) < 0.01] = -np.inf
        v[rng.rand(D, H, W) < 0.02] = 1e9
        v[:, H // 2, W // 3] = 0.25
        v[:, H - 1, W - 1] = np.nan
        vols[k] = torch.as_tensor(v, device=dev)
    return vols


GENERIC_SHAPES = [(13, 17, 45), (40, 23, 150), (70, 9, 257), (1, 3, 5),
                  (228, 37, 300), (200, 6, 1500)]


@pytest.mark.parametrize("dirs", [(-1, 1), (-1,), (1,)])
@pytest.mark.parametrize("D,H,W", GENERIC_SHAPES)
def test_sgm_layout_kernel_is_bit_identical(dev, D, H, W, dirs):
    """Both families' d-minor volumes, one launch each, bit for bit with
    the plain permute, pad and cat (NaN payloads kept, lanes [D, Dp)
    0x7fc00000): ragged column and disparity tiles, one direction and
    both, the -1 direction's columns reversed in the vertical one."""
    vols = _generic_vols(dev, D + H, D, H, W, dirs)
    tv = [vols[d] for d in dirs]
    Dp = -(-D // 32) * 32
    for vertical in (False, True):
        kw = dict(vertical=vertical, rev=vertical and -1 in dirs)
        _build.reset_launches()
        got = sgm.sgm_layout(tv, Dp, **kw)
        torch.cuda.synchronize()
        assert _build.launches()["sgm_layout"] == 1
        assert _same_bits(got, sgm.sgm_layout_plain(tv, Dp, **kw))


@pytest.mark.parametrize("cols", [None, "left", "right"])
@pytest.mark.parametrize("dirs", [(-1, 1), (-1,), (1,)])
@pytest.mark.parametrize("D,H,W", GENERIC_SHAPES)
def test_sgm_generic_tables_kernel_is_bit_identical(dev, D, H, W, dirs, cols):
    """Both families' tables in one launch, and each family alone, the
    whole buffer (gaps included) bit for bit with the plain build, on
    images with NaN of two payloads, +-inf and -0.0; the vertical family
    also on a column shard (the left or right half)."""
    x0, x1 = _adversarial_cost_images(dev, D + W, (H, W))
    c = {None: None, "left": (0, W // 2 + 1), "right": (W // 3, W)}[cols]
    for kw in (dict(cols=c), dict(vertical=False),
               dict(horizontal=False, cols=c)):
        _build.reset_launches()
        got = sgm.sgm_generic_tables(x0, x1, D, dirs, **kw)
        torch.cuda.synchronize()
        assert _build.launches()["sgm_generic_tables"] == 1
        want = sgm.sgm_generic_tables_plain(x0, x1, D, dirs, **kw)
        parts, total = sgm.generic_table_layout(H, W, D, len(dirs), **kw)
        flat = [torch.as_strided(next(iter(t.values())), (total,), (1,), 0)
                for t in (got, want)]
        assert _same_bits(*flat)


@pytest.mark.parametrize("quarter", [True, False])
@pytest.mark.parametrize("dirs", [(-1, 1), (-1,), (1,)])
@pytest.mark.parametrize("D,H,W", GENERIC_SHAPES)
def test_sgm_combine_kernel_is_bit_identical(dev, D, H, W, dirs, quarter):
    """The family sum (with the quarter or without) of two accumulators
    holding NaN of two payloads, -0.0, +-inf and 1e9, one launch, bit for
    bit with torch.add of the families' views then / 4.0 (rows of the
    output off 16 bytes: W odd)."""
    a = _generic_vols(dev, D + 1, D, H, W, dirs)
    b = _generic_vols(dev, D + 2, D, H, W, dirs)
    Dp = -(-D // 32) * 32
    acc_h = sgm.sgm_layout([a[d] for d in dirs], Dp, vertical=False,
                           rev=False)
    acc_v = sgm.sgm_layout([b[d] for d in dirs], Dp, vertical=True,
                           rev=-1 in dirs)
    _build.reset_launches()
    got = sgm.sgm_combine(acc_h, acc_v, dirs, D, quarter=quarter)
    torch.cuda.synchronize()
    assert _build.launches()["sgm_combine"] == 1
    want = sgm.sgm_combine_plain(acc_h, acc_v, dirs, D, quarter=quarter)
    for d in dirs:
        assert got[d].is_contiguous() and _same_bits(got[d], want[d])


@pytest.mark.parametrize("D,H,W", GENERIC_SHAPES + [(7, 5, 31), (8, 4, 33),
                                                    (9, 2, 64)])
def test_wta_kernel_is_bit_identical(dev, D, H, W):
    """The winner-take-all of a volume with NaN, -0.0 beside +0.0, +-inf,
    1e9, a column of ties and an all-NaN column, one launch, equal to
    torch.argmin of the NaN-free copy: D below, at and past the warps of
    a block."""
    vol = _generic_vols(dev, D + W, D, H, W, (1,))[1]
    _build.reset_launches()
    got = costs.wta(vol)
    torch.cuda.synchronize()
    assert _build.launches()["wta_dhw"] == 1
    assert _same_bits(got, costs.wta_plain(vol))


@pytest.mark.parametrize("dirs", [(-1, 1), (-1,)])
def test_generic_slab_sgm_launches_the_layout_kernels(dev, dirs):
    """``Stages.sgm`` in the slab form on the card: the layout kernel a
    family, both families' tables in one launch, one combine launch, and
    the map of ``costs.wta`` bit for bit with the plain route (every
    wrapper's plain version on the card)."""
    from mccnn_tpu_torch import pipeline

    D, H, W = 70, 23, 150
    vols = _generic_vols(dev, 7, D, H, W, dirs)
    for v in vols.values():
        v[v.isinf()] = 1e9
    x0, x1 = _cost_images(dev, 2, (H, W))
    kw = dict(pi1=1.32, pi2=24.25, tau_so=0.08, alpha1=2.0, sgm_q1=3.0,
              sgm_q2=2.0)
    _build.reset_launches()
    got = pipeline.ONE_DEVICE.sgm(x0, x1, vols, "slab", **kw)
    maps = {d: costs.wta(got[d]) for d in dirs}
    torch.cuda.synchronize()
    n = _build.launches()
    assert (n["sgm_layout"], n["sgm_generic_tables"], n["sgm_combine"],
            n["wta_dhw"]) == (2, 1, 1, len(dirs))
    routes = ((sgm, "sgm_layout"), (sgm, "sgm_generic_tables"),
              (sgm, "sgm_combine"), (costs, "wta"))
    saved = [getattr(m, name) for m, name in routes]
    try:
        for m, name in routes:
            setattr(m, name, getattr(m, name + "_plain"))
        want = pipeline.ONE_DEVICE.sgm(x0, x1, vols, "slab", **kw)
        want_maps = {d: costs.wta(want[d]) for d in dirs}
    finally:
        for (m, name), fn in zip(routes, saved):
            setattr(m, name, fn)
    for d in dirs:
        assert _same_bits(got[d], want[d])
        assert _same_bits(maps[d], want_maps[d])


def test_layout_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Non-float32, non-contiguous, mismatched or CPU operands raise
    ValueError; nothing falls back."""
    vols = _generic_vols(dev, 1, 13, 9, 40, (-1, 1))
    a, b = vols[-1], vols[1]
    with pytest.raises(ValueError, match="float32"):
        sgm.sgm_layout([a.double(), b.double()], 32, vertical=False,
                       rev=False)
    with pytest.raises(ValueError, match="contiguous"):
        sgm.sgm_layout([a.transpose(1, 2), b], 32, vertical=False, rev=False)
    with pytest.raises(ValueError, match="shape"):
        sgm.sgm_layout([a, b[:, :5].contiguous()], 32, vertical=True,
                       rev=True)
    with pytest.raises(ValueError, match="Dp"):
        sgm.sgm_layout([a, b], 8, vertical=True, rev=True)
    with pytest.raises(ValueError, match="float32"):
        costs.wta(a.double())
    with pytest.raises(ValueError, match="contiguous"):
        costs.wta(a.transpose(1, 2))
    x0, x1 = _cost_images(dev, 1, (9, 40))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sgm.sgm_generic_tables(x0, x1.cpu(), 13, (-1, 1))
    with pytest.raises(ValueError, match="columns"):
        sgm.sgm_generic_tables(x0, x1, 13, (-1, 1), cols=(5, 50))
    acc_h = sgm.sgm_layout([a, b], 32, vertical=False, rev=False)
    acc_v = sgm.sgm_layout([a, b], 32, vertical=True, rev=True)
    with pytest.raises(ValueError, match="accumulators"):
        sgm.sgm_combine(acc_h, acc_v[:, :40].contiguous(), (-1, 1), 13)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sgm.sgm_combine(acc_h, acc_v.cpu(), (-1, 1), 13)


# --- the towers' kernels (csrc/tower.cu) ------------------------------------

TOWER_SHAPES = [(2, 64, 37, 123), (2, 64, 23, 41), (2, 112, 9, 50),
                (1, 8, 5, 7), (2, 64, 1, 3)]
TOWER_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _planted(rng, shape, dev):
    """Random values with NaN of two payloads, -0.0 and +-inf planted."""
    t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
    flat = t.view(-1)
    flat[::97] = float("nan")
    flat[3::89] = -0.0
    flat[5::83] = float("inf")
    flat[7::79] = -float("inf")
    flat[9::73] = torch.tensor([0x7fc00123], dtype=torch.int32).view(
        torch.float32).item()
    return t


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", TOWER_DTYPES)
@pytest.mark.parametrize("shape", TOWER_SHAPES)
def test_tower_bias_act_is_bit_identical(dev, shape, dtype, relu):
    """``bias_act`` in place against its plain version, ``.view(int32)``:
    planes off a multiple of 4 floats (heads and tails at every offset),
    NaN, -0.0 and +-inf in the input and a -0.0 bias (ReLU's NaN and
    signed zero)."""
    rng = np.random.RandomState(sum(shape))
    acc = _planted(rng, shape, dev)
    bias = torch.as_tensor(rng.randn(shape[1]).astype(np.float32), device=dev)
    bias[0] = -0.0
    want = tower.bias_act_plain(acc.clone(), bias, relu, dtype)
    got = acc.clone()
    before = _build.launches()["tower_bias_act"]
    with torch.no_grad():
        assert tower.bias_act(got, bias, relu, dtype) is got
    torch.cuda.synchronize()
    assert _build.launches()["tower_bias_act"] == before + 1
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", TOWER_DTYPES)
@pytest.mark.parametrize("shape", TOWER_SHAPES)
def test_tower_normalize_is_bit_identical(dev, shape, dtype):
    """``normalize`` (the features' layout) against its plain version, the
    torch operations of ``l2_normalize`` on the card, bit for bit: the
    kernel sums the channels in torch's order (``sum_rows`` thread rows,
    4 on H * W a multiple of 4, else 1 here), which ``channel_sum_plain``
    writes out and which must be torch's own sum's bits."""
    rng = np.random.RandomState(sum(shape) + 1)
    acc = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
    bias = torch.as_tensor(rng.randn(shape[1]).astype(np.float32), device=dev)
    with torch.no_grad():
        got = tower.normalize(acc, bias, dtype)
    want = tower.normalize_plain(acc, bias, dtype)
    assert torch.equal(_bits(got), _bits(want))
    v = (acc + bias[:, None, None]).to(dtype)
    sq = v * v
    rows = tower.sum_rows(shape[1], shape[0], shape[2] * shape[3])
    order = tower.channel_sum_plain(sq.float(), rows).to(dtype)
    ref = sq.sum(dim=1, keepdim=True)
    assert torch.equal(order.float().view(torch.int32),
                       ref.float().view(torch.int32))


@pytest.mark.parametrize("sides", ["both", "left"])
@pytest.mark.parametrize("dtype", TOWER_DTYPES)
@pytest.mark.parametrize("H,W,D", [(37, 123, 40), (70, 300, 228), (3, 5, 1)])
def test_tower_normalize_pack_is_bit_identical(dev, H, W, D, dtype, sides):
    """The packed form against ``join.operands`` of the plain features,
    each operand bit for bit (the +0.0 pad rows and columns included);
    the join's volumes from them equal."""
    rng = np.random.RandomState(H + W)
    acc = torch.as_tensor(rng.randn(2, 64, H, W).astype(np.float32),
                          device=dev)
    bias = torch.as_tensor(rng.randn(64).astype(np.float32), device=dev)
    with torch.no_grad():
        got = tower.normalize(acc, bias, dtype, pack=(D, sides))
    want = tower.normalize_plain(acc, bias, dtype, pack=(D, sides))
    assert (got.H, got.W) == (H, W)
    for g, w in zip(got[:4], want[:4]):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("disp_true", [None, 9])
@pytest.mark.parametrize("n", [0, 1, 4])
@pytest.mark.parametrize("D,H,W", [(17, 5, 33), (40, 7, 45), (12, 3, 1501),
                                   (1, 1, 5)])
def test_slow_volumes_epilogue_is_bit_identical(dev, D, H, W, n, disp_true):
    """``slow_epilogue`` against ``masked_volumes`` -> ``fix_border`` ->
    the disp_true planes, ``.view(int32)``, on scores with NaN of two
    payloads, -0.0 and +-inf; rows at every 16-byte offset; a row wider
    than 48 KB of shared memory."""
    if n >= W:
        pytest.skip("the border needs n < W")
    rng = np.random.RandomState(D + H + W + n)
    s = _planted(rng, (D, H, W), dev)
    before = _build.launches()["slow_volumes_epilogue"]
    got = tower.slow_epilogue(s, n, disp_true)
    torch.cuda.synchronize()
    assert _build.launches()["slow_volumes_epilogue"] == before + 1
    want = tower.slow_epilogue_plain(s, n, disp_true)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def test_tower_wrappers_refuse_what_the_kernels_do_not_take(dev):
    acc = torch.zeros(2, 8, 4, 4, device=dev)
    bias = torch.zeros(8, device=dev)
    with pytest.raises(RuntimeError, match="no_grad"):
        tower.bias_act(acc, bias.requires_grad_(), True)
    bias = bias.detach()
    with pytest.raises(ValueError, match="contiguous"):
        tower.bias_act(acc.transpose(2, 3), bias, True)
    with pytest.raises(ValueError, match="float32"):
        tower.normalize(acc.double(), bias)
    with pytest.raises(ValueError, match="shapes"):
        tower.normalize(acc, bias[:4])
    with pytest.raises(ValueError, match="two images"):
        tower.normalize(acc[:1], bias, pack=(16, "both"))
    s = torch.zeros(4, 3, 5, device=dev)
    with pytest.raises(ValueError, match="n=5"):
        tower.slow_epilogue(s, 5)
    with pytest.raises(ValueError, match="aligned"):
        tower.slow_epilogue(torch.zeros(61, device=dev)[1:].view(1, 4, 15))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prediction_runs_the_tower_kernels(dev, dtype):
    """kitti fast and kitti slow (narrow) at 40x160, D=24: the fast tower
    runs ``tower_normalize_pack`` once, the slow one
    ``slow_volumes_epilogue`` once, a ``tower_conv`` a layer with the
    bias and ReLU in its epilogue, and ``tower_bias_act`` no time; each
    map bit for bit the map with the three wrappers swapped for their
    plain versions and the layers' bias and ReLU as ``bias_act_plain``
    after the bias-free convolution (``conv3x3_unfused``)."""
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.pipeline import stereo_predict

    H, W, D = 40, 160, 24
    base = np.random.RandomState(23).randn(H, W + D).astype(np.float32)
    x0, x1 = base[:, D:], base[:, :-D]
    for arch, over, want in (
            ("fast", {}, dict(tower_bias_act=0, tower_normalize_pack=1,
                              tower_conv=4)),
            ("slow", dict(l1=2, fm=8, l2=3, nh2=16),
             dict(tower_bias_act=0, slow_volumes_epilogue=1, tower_conv=2))):
        cfg = make_config("kitti", arch, a="predict", dtype=dtype, **over)
        net = towers.init_net(cfg).to(dev)
        _build.reset_launches()
        got = stereo_predict(cfg, net, x0, x1, D)
        torch.cuda.synchronize()
        counts = _build.launches()
        assert {k: counts[k] for k in want} == want
        saved = (tower.bias_act, tower.normalize, tower.slow_epilogue,
                 conv.conv3x3)
        try:
            tower.bias_act = tower.bias_act_plain
            tower.normalize = tower.normalize_plain
            tower.slow_epilogue = tower.slow_epilogue_plain
            conv.conv3x3 = conv.conv3x3_unfused
            ref = stereo_predict(cfg, net, x0, x1, D)
        finally:
            (tower.bias_act, tower.normalize, tower.slow_epilogue,
             conv.conv3x3) = saved
        assert torch.equal(_bits(got), _bits(ref))


# --- training: the warp kernel (csrc/warp.cu) and the chunk's CUDA graph ----

def _warp_inputs(rng, B, dev, N=3, H=40, W=56):
    """Affines reaching past every edge of the window (some wholly
    outside), photometrics, windows and a padded stack with NaN of two
    payloads, -0.0 and +-inf planted, origins clipped to [-WIN, H/W]."""
    from mccnn_tpu_torch.train import augment

    win = augment.WIN
    ang, sc = rng.uniform(-0.6, 0.6, B), rng.uniform(0.6, 1.6, B)
    tx, ty = rng.uniform(-8, win - 2, B), rng.uniform(-8, win - 2, B)
    tx[::7] = -45.0
    ty[3::11] = win + 40.0
    minv = np.stack([sc * np.cos(ang), -sc * np.sin(ang), tx,
                     sc * np.sin(ang), sc * np.cos(ang), ty], 1)
    f32 = [torch.as_tensor(a.astype(np.float32), device=dev) for a in (
        minv, rng.uniform(-0.7, 0.7, B), rng.uniform(0.7, 1.3, B))]
    windows = _planted(rng, (B, win, win), dev)
    xpad = torch.nn.functional.pad(_planted(rng, (2 * N, H, W), dev),
                                   (win, win, win, win))
    org = [rng.randint(0, 2 * N, B), rng.randint(-win, H + 1, B),
           rng.randint(-win, W + 1, B)]
    org[1][:2], org[2][:2] = [-win, H][:B], [W, -win][:B]
    org = [torch.as_tensor(a.astype(np.int32), device=dev) for a in org]
    return windows, xpad, org, f32


@pytest.mark.parametrize("ws", [9, 11])
@pytest.mark.parametrize("B", [1, 37, 256, 301])
def test_warp_kernel_is_bit_identical(dev, B, ws):
    """``warp_patches`` from windows and from the padded stack (the fused
    gather) against their plain versions, ``.view(int32)``: NaN, -0.0 and
    +-inf planted in both sources, awkward B, one launch counted a call,
    by the wrapper and by the kernel's counter on the card."""
    from mccnn_tpu_torch.ops import warp
    from mccnn_tpu_torch.train import augment

    windows, xpad, org, (minv, bri, con) = _warp_inputs(
        np.random.RandomState(B + ws), B, dev)
    ran = warp.runs(dev)
    before = _build.launches()["warp_patches"]
    got = warp.warp_windows(windows, minv, bri, con, ws)
    torch.cuda.synchronize()
    assert _build.launches()["warp_patches"] == before + 1
    want = augment.warp_patches_plain(windows, minv, bri, con, ws=ws)
    assert torch.equal(_bits(got), _bits(want))
    got = augment.gather_warp(xpad, *org, minv, bri, con, ws=ws)
    torch.cuda.synchronize()
    assert _build.launches()["warp_patches"] == before + 2
    want = augment.gather_warp_plain(xpad, *org, minv, bri, con, ws=ws)
    assert torch.equal(_bits(got), _bits(want))
    assert bool(torch.isfinite(want).any())
    assert warp.runs(dev) == ran + 2


def test_warp_wrappers_refuse_what_the_kernel_does_not_take(dev):
    from mccnn_tpu_torch.ops import warp

    windows, xpad, org, (minv, bri, con) = _warp_inputs(
        np.random.RandomState(0), 8, dev)
    with pytest.raises(ValueError, match="float32"):
        warp.warp_windows(windows.double(), minv, bri, con, 9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp.warp_windows(windows, minv.cpu(), bri, con, 9)
    with pytest.raises(ValueError, match="bad shapes"):
        warp.warp_windows(windows, minv[:, :5].contiguous(), bri, con, 9)
    with pytest.raises(ValueError, match="bad windows"):
        warp.warp_windows(windows[:, :31].contiguous(), minv, bri, con, 9)
    with pytest.raises(ValueError, match="int32"):
        warp.warp_gather(xpad, org[0].long(), org[1], org[2], minv, bri, con,
                         9, 32)
    with pytest.raises(ValueError, match="bad shapes"):
        warp.warp_gather(xpad, org[0], org[1][:4].contiguous(), org[2], minv,
                         bri, con, 9, 32)


def _train_setup(tmp_path, arch, dtype, device_gather, dev):
    """A narrow config (l1 = 2, fm = 16, bs = 32) on a 64x128 synthetic
    KITTI set, its chunks by seed, and the padded stack on the card."""
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.data import datasets
    from mccnn_tpu_torch.train import augment, trainer

    datasets.make_synthetic_kitti(str(tmp_path / "data.kitti"), n_images=2,
                                  height=64, width=128, disp_max=16)
    over = dict(l1=2, fm=16, bs=32, data_dir=str(tmp_path), dtype=dtype)
    if arch == "slow":
        over.update(l2=2, nh2=32)
    cfg = make_config("kitti", arch, **over)
    ds = datasets.load_kitti(cfg)
    X0, X1 = np.asarray(ds.X0), np.asarray(ds.X1)

    def chunk(n, seed):
        rows = ds.nnz_tr[seed * 16:][:n * 16]
        return trainer.stack_chunk(
            augment.AugmentSampler(cfg, np.random.RandomState(seed)), ds,
            rows, n, 16, X0, X1, device_gather=device_gather)

    assert len(ds.nnz_tr) > 35 * 16
    Xpad = augment.pad_image_stack(X0, X1, dev) if device_gather else None
    return cfg, chunk, Xpad


@pytest.mark.parametrize("device_gather", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["fast", "slow"])
def test_graph_chunk_is_the_eager_chunk(dev, tmp_path, arch, dtype,
                                        device_gather):
    """``make_train_chunk``'s replays against eager ``train_chunk`` calls
    from the same weights, bit for bit under ``cudnn.deterministic``: a
    chunk of 32 steps, a second at the lr dropped by 10 (a ``fill_``, no
    new capture), then a tail of 5 on its own graph; the losses, weights
    and momentum after each. The replays count ``warp_patches`` once a
    step, the warm-ups once a graph, the capture nothing, as the kernel's
    own counter on the card does."""
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.ops import warp
    from mccnn_tpu_torch.train import trainer

    cfg, chunk, Xpad = _train_setup(tmp_path, arch, dtype, device_gather,
                                     dev)
    plan = [(chunk(32, 1), cfg.lr), (chunk(32, 2), cfg.lr / 10),
            (chunk(5, 3), cfg.lr / 10)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = []
        for graph in (True, False):
            net = towers.init_net(cfg).to(dev)
            mom = [torch.zeros_like(p) for p in net.parameters()]
            graphs, seen = {}, []
            _build.reset_launches()
            ran = warp.runs(dev)
            for c, lr in plan:
                n = c["minv"].shape[0]
                if graph:
                    if n not in graphs:
                        graphs[n] = trainer.make_train_chunk(
                            cfg, net, mom, Xpad, n, dev)
                    errs = graphs[n](c, lr)
                else:
                    errs = trainer.train_chunk(
                        cfg, net, mom, lr,
                        {k: torch.as_tensor(v, device=dev)
                         for k, v in c.items()}, Xpad)
                seen.append([errs.clone()] + [t.detach().clone() for t in
                                              list(net.parameters()) + mom])
            torch.cuda.synchronize()
            launches = _build.launches()
            assert launches == dict(dict.fromkeys(_build.KERNELS, 0),
                                    warp_patches=69 + (2 if graph else 0))
            assert warp.runs(dev) - ran == launches["warp_patches"]
            states.append(seen)
    finally:
        torch.backends.cudnn.deterministic = det
    for g, e in zip(*states):
        assert bool(torch.isfinite(g[0]).all())
        for a, b in zip(g, e):
            assert torch.equal(_bits(a), _bits(b))


def test_graph_chunk_refuses_a_moved_net(dev, tmp_path):
    """A replay after the net's storage was replaced raises (the graph
    holds the old addresses); so does a chunk of another shape."""
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.train import trainer

    cfg, chunk, Xpad = _train_setup(tmp_path, "fast", "float32", True, dev)
    net = towers.init_net(cfg).to(dev)
    mom = [torch.zeros_like(p) for p in net.parameters()]
    run = trainer.make_train_chunk(cfg, net, mom, Xpad, 4, dev)
    c = chunk(4, 1)
    assert bool(torch.isfinite(run(c, cfg.lr)).all())
    with pytest.raises(ValueError, match="shape"):
        run(chunk(3, 1), cfg.lr)
    first = next(net.parameters())
    first.data = first.data.clone()
    with pytest.raises(RuntimeError, match="moved since the capture"):
        run(c, cfg.lr)


def test_train_on_the_card_replays_one_graph_a_chunk_size(dev, tmp_path):
    """``train()`` on the card: one graph for the epoch's chunks of 32 and
    one for its tail, captured once for two epochs; ``warp_patches``
    counted once a step and once a graph's warm-up, nothing else."""
    from mccnn_tpu_torch.data import datasets
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.train import trainer

    cfg, _, _ = _train_setup(tmp_path, "fast", "float32", True, dev)
    ds = datasets.load_kitti(cfg)
    ds.nnz_tr = ds.nnz_tr[:35 * 16 + 1]
    made = []
    orig = trainer.make_train_chunk

    def spy(*a, **kw):
        made.append(a[4])
        return orig(*a, **kw)

    trainer.make_train_chunk = spy
    try:
        _build.reset_launches()
        lines = []
        trainer.train(cfg, ds, towers.init_net(cfg), epochs=2,
                      log=lines.append, device=dev)
        torch.cuda.synchronize()
    finally:
        trainer.make_train_chunk = orig
    assert made == [32, 3]
    assert _build.launches() == dict(dict.fromkeys(_build.KERNELS, 0),
                                     warp_patches=2 * 35 + 2)
    assert len(lines) == 2 and all(np.isfinite(float(ln.split("\t")[1]))
                                   for ln in lines)


# --- the towers' convolutions (csrc/conv.cu) --------------------------------

CONV_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _conv_case(dev, seed, N, Ci, Co, H, W, dtype):
    """Seeded input and weights on the card, the input rounded to
    ``dtype`` (held as float32, as the previous layer leaves it), and the
    float64 convolution of the operands the kernels read (the weights
    rounded to ``dtype``) with its scale sum |w||x|."""
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(N, Ci, H, W).astype(np.float32), device=dev)
    x = x.to(dtype).float()
    w = torch.as_tensor((rng.randn(Co, Ci, 3, 3) / np.sqrt(9 * Ci))
                        .astype(np.float32), device=dev)
    wr = w.to(dtype).double()
    ref = torch.nn.functional.conv2d(x.double(), wr, None, padding=1)
    scale = torch.nn.functional.conv2d(x.double().abs(), wr.abs(), None,
                                       padding=1)
    return x, w, ref, scale


@pytest.mark.parametrize("dtype", CONV_DTYPES)
@pytest.mark.parametrize("N,C,H,W", [(2, 64, 9, 70), (1, 112, 5, 130),
                                     (2, 64, 37, 131), (1, 64, 1, 3),
                                     (2, 112, 3, 64), (1, 112, 6, 200),
                                     (2, 80, 9, 70), (1, 96, 5, 130),
                                     (1, 80, 1, 3), (2, 96, 7, 131)])
def test_tower_conv_wgmma_is_within_f32_rounding(dev, N, C, H, W, dtype):
    """The wgmma kernel at C = 64, 80, 96 and 112 on frames off the 2 x 64 tile
    (edges, one row, three columns): within 2e-6 of sum |w||x| of the
    float64 convolution of the same operands (float32 through the
    three-level split: about 4 * 2^-24), and as close as cuDNN's float32
    sum (TF32 off) is, within 2e-6 of it too; one ``tower_conv`` count a
    call."""
    x, w, ref, scale = _conv_case(dev, 40 + C + H, N, C, C, H, W, dtype)
    before = _build.launches()["tower_conv"]
    with torch.no_grad():
        got = conv.conv3x3(x, w, dtype)
    torch.cuda.synchronize()
    assert _build.launches()["tower_conv"] == before + 1
    assert got.shape == (N, C, H, W) and got.dtype == torch.float32
    err = float(((got.double() - ref).abs() / scale.clamp_min(1e-30)).max())
    assert err <= 2e-6, err
    lib = conv.conv3x3_plain(x, w, dtype)
    assert float(((got - lib).abs().double()
                  / scale.clamp_min(1e-30)).max()) <= 2e-6


@pytest.mark.parametrize("dtype", CONV_DTYPES)
@pytest.mark.parametrize("N,Ci,Co,H,W", [(2, 1, 64, 9, 70), (2, 1, 112, 7, 45),
                                         (1, 3, 64, 5, 33), (2, 8, 8, 11, 40),
                                         (1, 16, 16, 6, 17), (1, 48, 48, 6, 70),
                                         (1, 200, 72, 4, 40)])
def test_tower_conv_first_is_within_f32_rounding(dev, N, Ci, Co, H, W, dtype):
    """The SIMT kernel: the first layer (one or three input planes) and the
    layers of the widths no wgmma instance takes (48 -> 48: its weights in
    two chunks of output channels; 200 -> 72 in twelve), within 1e-6 of
    sum |w||x| of the float64 convolution."""
    x, w, ref, scale = _conv_case(dev, 60 + Ci + Co, N, Ci, Co, H, W, dtype)
    with torch.no_grad():
        got = conv.conv3x3(x, w, dtype)
    torch.cuda.synchronize()
    err = float(((got.double() - ref).abs() / scale.clamp_min(1e-30)).max())
    assert err <= 1e-6, err


def test_tower_conv_split_emulation_and_cache(dev):
    """The float32 kernel against its torch emulation
    (``conv3x3_split_plain``) within float32 summation error (2e-6 of
    sum |w||x|: both sum 6 x 576 products, in other orders); the weights'
    pack cached until the weight changes in place, then made anew (the
    output follows the new weights); 16-bit input widened by the
    wrapper; a 5 x 5 kernel, a missing no_grad and a float64 input
    refused."""
    x, w, _, scale = _conv_case(dev, 7, 2, 64, 64, 12, 90, torch.float32)
    w = torch.nn.Parameter(w)
    with torch.no_grad():
        got = conv.conv3x3(x, w)
        emu = conv.conv3x3_split_plain(x, w, 3)
        assert float(((got - emu).abs().double() / scale).max()) <= 2e-6
        packed = conv.prepacked(w)
        assert conv.prepacked(w) is packed
        w.mul_(-0.5)
        assert conv.prepacked(w) is not packed
        again = conv.conv3x3(x, w)
        torch.testing.assert_close(again, -0.5 * got, rtol=0, atol=1e-5)
        xb = x.to(torch.bfloat16)
        torch.testing.assert_close(conv.conv3x3(xb, w, torch.bfloat16),
                                   conv.conv3x3(xb.float(), w,
                                                torch.bfloat16),
                                   rtol=0, atol=0)
        with pytest.raises(ValueError, match="ks = 3"):
            conv.conv3x3(torch.zeros(1, 48, 4, 4, device=dev),
                         torch.zeros(48, 48, 5, 5, device=dev))
        with pytest.raises(ValueError, match="float32"):
            conv.conv3x3(x.double(), w)
    with pytest.raises(RuntimeError, match="no_grad"):
        conv.conv3x3(x, w)


def _fused_case(dev, seed, N, Ci, Co, H, W, dtype):
    """A layer's input with NaN, -0.0 and +-inf planted (held as float32
    values of ``dtype``, as the previous layer leaves them), its weights,
    and a bias with NaN, -0.0, +-inf and values that cancel sums."""
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(N, Ci, H, W).astype(np.float32), device=dev)
    flat = x.view(-1)
    flat[11::997] = float("nan")
    flat[13::991] = -0.0
    flat[17::983] = float("inf")
    flat[19::977] = -float("inf")
    x = x.to(dtype).float()
    w = torch.as_tensor((rng.randn(Co, Ci, 3, 3) / np.sqrt(9 * Ci))
                        .astype(np.float32), device=dev)
    b = torch.as_tensor(rng.randn(Co).astype(np.float32), device=dev)
    b[0], b[1 % Co], b[2 % Co] = -0.0, float("nan"), float("inf")
    b[3 % Co] = -float("inf")
    return x, w, b


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", CONV_DTYPES)
@pytest.mark.parametrize("N,Ci,Co,H,W", [(2, 64, 64, 9, 70),
                                         (1, 80, 80, 5, 131),
                                         (2, 96, 96, 3, 70),
                                         (1, 112, 112, 6, 130),
                                         (2, 1, 64, 9, 71), (1, 3, 112, 5, 40),
                                         (1, 48, 48, 6, 70)])
def test_tower_conv_fused_epilogue_is_the_bias_kernel(dev, N, Ci, Co, H, W,
                                                      dtype, relu):
    """The fused epilogue (``conv3x3(..., bias, relu)``) bit for bit the
    bias-free kernel followed by ``tower.bias_act`` (``conv3x3_unfused``)
    at every wgmma width and dtype and on the SIMT kernel (the first
    layer, one and three planes, W odd and even; a width without a wgmma
    instance), with NaN, -0.0 and +-inf in the input and the bias; one
    ``tower_conv`` count a call and no ``tower_bias_act``."""
    x, w, b = _fused_case(dev, Ci + Co + H, N, Ci, Co, H, W, dtype)
    with torch.no_grad():
        want = conv.conv3x3_unfused(x, w, dtype, b, relu)
        before = _build.launches()
        got = conv.conv3x3(x, w, dtype, b, relu)
    torch.cuda.synchronize()
    after = _build.launches()
    assert after["tower_conv"] == before["tower_conv"] + 1
    assert after["tower_bias_act"] == before["tower_bias_act"]
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", CONV_DTYPES)
@pytest.mark.parametrize("C", [64, 112])
def test_tower_conv_wgmma_matches_the_tile_emulation(dev, C, dtype):
    """The wgmma kernel against ``conv3x3_tile_plain`` (its staged tile and
    order of products in torch) on a frame off the tile: within 2e-6 of
    sum |w||x| (the tensor cores' float32 sums truncate where torch's
    round)."""
    x, w, _, scale = _conv_case(dev, 3 + C, 2, C, C, 7, 131, dtype)
    with torch.no_grad():
        got = conv.conv3x3(x, w, dtype)
    emu = conv.conv3x3_tile_plain(x, w, dtype)
    err = float(((got.double() - emu.double()).abs()
                 / scale.clamp_min(1e-30)).max())
    assert err <= 2e-6, err

