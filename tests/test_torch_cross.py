"""The port's CBCA (plain torch, on the CPU) against the JAX package's
``ops/cross.py``; numpy models of the CBCA kernel's plans (csrc/cross.cu:
the clipped intervals, and the packed offsets with fixed-window sums)
against the plain version bit for bit; the packed offsets against numpy;
the wrappers' CPU dispatch; the kernel's shared-memory footprint at
every config's K; and the operands the generic lane hands to CBCA."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import cross as jcross
from mccnn_tpu_torch import config
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.ops import _build, cross

SRC = (Path(cross.__file__).resolve().parent.parent / "csrc" / "cross.cu"
       ).read_text()

# L1 -> tau1: kitti census (K = 2), kitti ad, kitti slow, mb slow, and a K
# that no config sets (the kernel's run-time instance)
TAU1 = {0: 0.01, 3: 0.03, 5: 0.13, 14: 0.02, 7: 0.05}


def _img(seed, H=23, W=57):
    # standardized-looking texture with flat patches, so arms of every
    # length occur
    rng = np.random.RandomState(seed)
    x = rng.randn(H, W).astype(np.float32) * 0.1
    x[5:12, 10:30] = 0.3
    return x


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.int32),
        np.ascontiguousarray(b).view(np.int32))


# (L1, tau1): the K of census (L1 = 0 and 1: K = 2), ad, slow and mb slow
# with their configs' tau1; K = 9, 10, 11 around a chunk edge of 8 probes;
# and a tau1 of 0 (kitti fast's) and below it, where every in-frame
# compare of a number breaks
ARMS = [(0, 0.01), (1, 0.2), (3, 0.03), (5, 0.13), (14, 0.02), (9, 0.05),
        (10, 0.05), (11, 0.05), (5, 0.0), (11, -1.0)]
ARM_KINDS = ["texture", "nan", "row", "column", "small"]


def _arms_img(kind, seed):
    """The image of an arms case: ``texture`` 23x57 with a flat patch
    (arms of every length); ``nan`` that with NaN at 10% of its pixels
    and in a block (a NaN compare never breaks); ``row`` a single row and
    ``column`` a single column through the patch (K past H or W);
    ``small`` 3x5 (K >= W and K >= H for every K above 4)."""
    x = _img(seed)
    if kind == "nan":
        x[np.random.RandomState(seed).rand(*x.shape) < 0.1] = np.nan
        x[14:19, 3:25] = np.nan
    return {"texture": x, "nan": x, "row": x[8:9], "column": x[:, 15:16],
            "small": x[6:9, 12:17]}[kind].copy()


@pytest.mark.parametrize("kind", ARM_KINDS)
@pytest.mark.parametrize("L1,tau1", ARMS)
def test_cross_arms_exact(L1, tau1, kind):
    """The arms equal to the JAX package's, on the cases of ``ARMS`` and
    the images of ``_arms_img``."""
    x = _arms_img(kind, L1)
    got = cross.cross_arms(torch.as_tensor(x), L1, tau1).numpy()
    want = np.asarray(jcross.cross_arms(jnp.asarray(x), L1, tau1))
    assert got.dtype == np.float32 and got.shape == (4, *x.shape)
    assert np.array_equal(got, want)


def _kernel_arms(img, L1, tau1, rng):
    """A numpy model of the arms kernel's walk (csrc/cross.cu): each arm
    breaks at its first probe k = 2 .. K - 1 with |c - p| >= tau1 in
    float32, where a probe past the frame reads any value (drawn here
    from ``rng`` a probe and a pixel: the clamped pixel's, as the kernel
    reads, the centre's, a random one, NaN or inf), and the break is
    capped at the frame. The kernel's steps (the windows' NP probes, then
    chunks of AP up to the cap) change which probes load together, not
    which breaks first."""
    H, W = img.shape
    K = max(2, int(L1))
    t = np.float32(tau1)
    rows, cols = np.arange(H)[:, None], np.arange(W)[None, :]
    out = []
    for axis, sign in ((1, -1), (1, 1), (0, -1), (0, 1)):
        n = img.shape[axis]
        coord = np.broadcast_to(rows if axis == 0 else cols, (H, W))
        kb = np.full((H, W), K)
        for k in range(2, K):
            q = np.clip(coord + sign * k, 0, n - 1)
            p = img[q, cols] if axis == 0 else img[rows, q]
            junk = np.stack([p, img, rng.randn(H, W).astype(np.float32),
                             np.full((H, W), np.nan, np.float32),
                             np.full((H, W), np.inf, np.float32)])
            pick = rng.randint(0, len(junk), (H, W))
            inside = (coord + sign * k >= 0) & (coord + sign * k < n)
            p = np.where(inside, p, np.take_along_axis(junk, pick[None], 0)[0])
            with np.errstate(invalid="ignore"):
                hit = (kb == K) & (np.abs(img - p) >= t)
            kb = np.where(hit, k, kb)
        cap = coord + 1 if sign < 0 else n - coord
        out.append((coord + sign * np.minimum(kb, cap)).astype(np.float32))
    return np.stack(out)


@pytest.mark.parametrize("kind", ARM_KINDS)
@pytest.mark.parametrize("L1,tau1", ARMS)
def test_kernel_walk_is_the_plain_version_bit_for_bit(L1, tau1, kind):
    """The kernel's walk (``_kernel_arms``), whatever its probes past the
    frame read, gives ``cross_arms_plain``'s bits: the cap at the frame
    makes a break there the same as none, so the kernel reads clamped
    addresses and tests no frame in its compares."""
    x = _arms_img(kind, L1)
    want = cross.cross_arms_plain(torch.as_tensor(x), L1, tau1).numpy()
    for seed in range(3):
        got = _kernel_arms(x, L1, tau1, np.random.RandomState(seed))
        assert _bits_equal(got, want)


def test_arms_windows_hold_every_probe_they_serve():
    """The register windows of the arms kernel (csrc/cross.cu
    ``window_breaks<VEC, D, K0, N>``: AX = 2 columns a thread, AY rows;
    the probes k = K0 .. F = K0 + N - 1 of direction D on side S; the -y
    or +y window's NV rows from offset V0, a row's NQ pairs from column
    offset P0), at the first windows (K0 = 2, N = NP <= NPMAX), at the
    second (K0 = NPMAX + 2 up to KWIN - 1) and past them (the ``arms-np*``
    variants of ``cbca_variants``): the window entry each probe reads is
    inside the window and holds the probe's row or column."""
    num = {k: int(re.search(rf"constexpr int {k} = (\d+);", SRC)[1])
           for k in ("AX", "AY", "NPMAX", "KWIN")}
    AX, AY = num["AX"], num["AY"]
    assert AX == 2 and num["NPMAX"] >= 1 and num["KWIN"] >= 14
    for line in ("constexpr int F = K0 + N - 1;",
                 "constexpr int S = D % 2 ? 1 : -1;",
                 "constexpr int NV = AY + N - 1;",
                 "constexpr int V0 = S < 0 ? -F : K0;",
                 "const float2 q = vw[r + S * (K0 + i) - V0];",
                 "constexpr int P0 = S < 0 ? -((F + 1) & ~1) : K0 & ~1;",
                 "constexpr int NQ = (S < 0 ? 1 - K0 - P0 : 1 + F - P0) / 2 + 1;",
                 "hw[q] = pair_at<VEC>(row, x0 + P0 + 2 * q, W);",
                 "const int o = j + S * (K0 + i) - P0;",
                 "window_breaks<VEC, D, 2, NP>(",
                 "window_breaks<VEC, D, K1, KWIN - K1>(",
                 "const int np = min(K - 2, NPMAX);"):
        assert line in SRC, line
    stages = [(2, n) for n in range(1, 9)] + [
        (npm + 2, num["KWIN"] - npm - 2) for npm in range(1, 7)]
    for K0, N in stages:
        F = K0 + N - 1
        for S in (-1, 1):
            NV, V0 = AY + N - 1, -F if S < 0 else K0
            P0 = -((F + 1) & ~1) if S < 0 else K0 & ~1
            NQ = ((1 - K0 - P0) if S < 0 else (1 + F - P0)) // 2 + 1
            assert P0 % 2 == 0
            for i in range(N):
                k = K0 + i
                for r in range(AY):
                    v = r + S * k - V0
                    assert 0 <= v < NV and V0 + v == r + S * k
                for j in range(AX):
                    o = j + S * k - P0
                    assert 0 <= o >> 1 < NQ and P0 + o == j + S * k


def _volume(rng, D, H, W, direction):
    """A volume with NaN out-of-frame cells (the slow volumes' masks) and
    scattered NaN inside; and the out-of-frame mask."""
    vol = rng.rand(D, H, W).astype(np.float32)
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    oof = np.broadcast_to((xs + ds * direction < 0)
                          | (xs + ds * direction >= W), vol.shape)
    vol[oof] = np.nan
    vol[rng.rand(D, H, W) < 0.05] = np.nan
    return vol, oof


@pytest.mark.parametrize("L1", [0, 3, 5, 14])
@pytest.mark.parametrize("direction", [-1, 1])
def test_cbca_matches_jax_with_nan_cells(direction, L1):
    """The K of census, ad, slow and mb slow, on a volume with NaN
    out-of-frame cells and scattered NaN inside. The same masked adds in
    the same order: rtol 1e-6 for the division's rounding; identical NaN
    masks (out-of-frame cells pass through). Chunked over d (4 per
    chunk) and in one piece, both equal."""
    tau1 = TAU1[L1]
    rng = np.random.RandomState(3 + direction)
    D, H, W = 9, 23, 57
    x0, x1 = _img(1), _img(2)
    vol, oof = _volume(rng, D, H, W, direction)
    j0, j1 = (jcross.cross_arms(jnp.asarray(a), L1, tau1) for a in (x0, x1))
    want = np.asarray(jcross.cbca(j0, j1, jnp.asarray(vol), direction, L1))
    t0, t1 = (cross.cross_arms(torch.as_tensor(a), L1, tau1)
              for a in (x0, x1))
    got = cross.cbca(t0, t1, torch.as_tensor(vol), direction, L1).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[oof]).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    chunked = cross.cbca_plain(t0, t1, torch.as_tensor(vol), direction, L1,
                               chunk_cells=4 * H * W).numpy()
    assert np.array_equal(chunked, got, equal_nan=True)


def _kernel_plan(x0c, x1c, vol, direction, L1):
    """A numpy model of the CBCA kernel's index plan (csrc/cross.cu): for
    each valid cell the columns of each row in the closed interval
    [max(xx_s + 1, x - K + 1, 0), min(xx_t - 1, x + K - 1, W - 1)] added
    in ascending order from +0, the rows likewise, the counts as
    integers, and the float32 quotient; out-of-frame cells pass the
    volume through. Only the active cells of a step add: no masked
    zeros."""
    D, H, W = vol.shape
    R = max(2, int(L1)) - 1
    a0, a1_all = x0c.astype(np.int64), x1c.astype(np.int64)
    vol_z = np.where(np.isnan(vol), np.float32(0), vol)
    ys = np.arange(H)[:, None].repeat(W, 1)
    xs = np.arange(W)[None, :].repeat(H, 0)
    out = vol.copy()
    for d in range(D):
        delta = d * direction
        valid = (xs + delta >= 0) & (xs + delta < W)
        a1 = a1_all[:, ys, np.clip(xs + delta, 0, W - 1)]
        lo = np.maximum(np.maximum(np.maximum(a0[0], a1[0] - delta) + 1,
                                   xs - R), 0)
        hi = np.minimum(np.minimum(np.minimum(a0[1], a1[1] - delta) - 1,
                                   xs + R), W - 1)
        hsum = np.zeros((H, W), np.float32)
        for t in range(2 * R + 1):
            c = lo + t
            on = c <= hi
            hsum[on] = hsum[on] + vol_z[d, ys[on], c[on]]
        hcnt = np.maximum(hi - lo + 1, 0)
        lo = np.maximum(np.maximum(np.maximum(a0[2], a1[2]) + 1, ys - R), 0)
        hi = np.minimum(np.minimum(np.minimum(a0[3], a1[3]) - 1, ys + R),
                        H - 1)
        vsum = np.zeros((H, W), np.float32)
        vcnt = np.zeros((H, W), np.int64)
        for t in range(2 * R + 1):
            r = lo + t
            on = r <= hi
            vsum[on] = vsum[on] + hsum[r[on], xs[on]]
            vcnt[on] += hcnt[r[on], xs[on]]
        agg = vsum / np.maximum(vcnt, 1).astype(np.float32)
        out[d] = np.where(valid, agg, vol[d])
    return out


def _case(L1, direction, seed=0, D=11, H=29, W=61, d_true=8, arms_L1=None):
    """Arms of a textured pair (of ``arms_L1``, by default L1) and a
    volume with NaN cells (out of frame and scattered), -0.0 cells and
    1e9 planes d >= d_true (``disp_true``)."""
    a = L1 if arms_L1 is None else arms_L1
    x0c, x1c = (cross.cross_arms_plain(torch.as_tensor(_img(seed + s, H, W)),
                                       a, TAU1[a]) for s in (1, 2))
    rng = np.random.RandomState(seed + 7)
    vol, _ = _volume(rng, D, H, W, direction)
    vol[(rng.rand(D, H, W) < 0.05) & ~np.isnan(vol)] = -0.0
    vol[d_true:] = 1e9
    return x0c, x1c, vol


def _pack_np(arms, K):
    """The packed offsets as int8 (4, H, W): each arm end less the
    pixel's own column (ends 0, 1) or row (2, 3), clamped to [-K, K]."""
    _, H, W = arms.shape
    xs, ys = np.arange(W)[None, :], np.arange(H)[:, None]
    return np.stack([np.clip(arms[i] - c, -K, K) for i, c in
                     enumerate((xs, xs, ys, ys))]).astype(np.int8)


def _window_plan(x0c, x1c, vol, direction, L1):
    """A numpy model of the CBCA kernel's plan (csrc/cross.cu): the arms
    as offsets clamped to [-K, K] (``_pack_np``), the tighter of each
    pair the max or min of two bytes; each horizontal sum runs over the
    fixed 2K - 1 taps t = -(K-1) .. K-1 in ascending order from +0 over
    the staged row (NaN and out of frame read as 0) and adds a tap only
    where t lies in its interval (the kernel's predicated add), its count
    the interval's length clipped to the frame; each output's vertical
    sum likewise over the row sums of its column (rows out of frame 0),
    the counts added as integers; the float32 quotient. The taps run
    over the kernel instance's window (``cross.window_of``: wider than
    2K - 1 for a K that no config sets), and the intervals are clipped
    to the frame alone: the offsets clamped to [-K, K] keep them inside
    [-(K-1), K-1]. The kernel takes the taps of HP (VP) adjacent outputs
    from one shared window, which changes no output's order. Out-of-frame
    cells pass the volume through."""
    D, H, W = vol.shape
    K = max(2, int(L1))
    Rw = cross.window_of(K) - 1
    o0, o1 = (_pack_np(a, K).astype(np.int64) for a in (x0c, x1c))
    vol_z = np.where(np.isnan(vol), np.float32(0), vol)
    ys = np.arange(H)[:, None].repeat(W, 1)
    xs = np.arange(W)[None, :].repeat(H, 0)
    out = vol.copy()
    for d in range(D):
        delta = d * direction
        valid = (xs + delta >= 0) & (xs + delta < W)
        b = o1[:, ys, np.clip(xs + delta, 0, W - 1)]
        lo = np.maximum(np.maximum(o0[0], b[0]) + 1, -xs)
        hi = np.minimum(np.minimum(o0[1], b[1]) - 1, W - 1 - xs)
        lo, hi = np.where(valid, lo, 1), np.where(valid, hi, 0)
        row = np.zeros((H, W + 2 * Rw), np.float32)
        row[:, Rw:Rw + W] = vol_z[d]
        hsum = np.zeros((H, W), np.float32)
        for t in range(-Rw, Rw + 1):
            on = (t >= lo) & (t <= hi)
            hsum = np.where(on, hsum + row[:, Rw + t:Rw + t + W], hsum)
        hcnt = np.maximum(hi - lo + 1, 0)
        lo = np.maximum(np.maximum(o0[2], b[2]) + 1, -ys)
        hi = np.minimum(np.minimum(o0[3], b[3]) - 1, H - 1 - ys)
        col = np.zeros((H + 2 * Rw, W), np.float32)
        col[Rw:Rw + H] = hsum
        cnt = np.zeros((H + 2 * Rw, W), np.int64)
        cnt[Rw:Rw + H] = hcnt
        vsum = np.zeros((H, W), np.float32)
        vcnt = np.zeros((H, W), np.int64)
        for t in range(-Rw, Rw + 1):
            on = (t >= lo) & (t <= hi)
            vsum = np.where(on, vsum + col[Rw + t:Rw + t + H], vsum)
            vcnt += np.where(on, cnt[Rw + t:Rw + t + H], 0)
        agg = vsum / np.maximum(vcnt, 1).astype(np.float32)
        out[d] = np.where(valid, agg, vol[d])
    return out


@pytest.mark.parametrize("shape", [(11, 29, 61), (11, 5, 3)])
@pytest.mark.parametrize("L1", [0, 3, 5, 14])
@pytest.mark.parametrize("direction", [-1, 1])
def test_kernel_plan_is_the_plain_version_bit_for_bit(direction, L1, shape):
    """The kernel's interval plan equals ``cbca_plain`` bit for bit on a
    whole frame: NaN cells, 1e9 planes, both directions; and on a frame
    narrower and lower than the window."""
    x0c, x1c, vol = _case(L1, direction, **dict(zip("DHW", shape)))
    want = cross.cbca_plain(x0c, x1c, torch.as_tensor(vol), direction,
                            L1).numpy()
    got = _kernel_plan(x0c.numpy(), x1c.numpy(), vol, direction, L1)
    assert _bits_equal(got, want)
    # the 1e9 planes are sums of up to (2K - 1)^2 values of 1e9, rounded
    np.testing.assert_allclose(want[8:], 1e9, rtol=1e-4)


@pytest.mark.parametrize("L1", [0, 3, 5, 14])
def test_kernel_plan_on_a_row_slab(L1):
    """A row slab with its arms' row coordinates made relative to its
    first row, as ``RowShards.cbca`` builds it (the halo rows' arms may
    point outside the slab): the plan equals ``cbca_plain`` on the slab
    bit for bit, halo rows included, and the slab's own rows equal the
    whole frame's."""
    direction = -1
    x0c, x1c, vol = _case(L1, direction, seed=3, H=41)
    H, halo = vol.shape[1], max(2, L1) - 1
    whole = cross.cbca_plain(x0c, x1c, torch.as_tensor(vol), direction,
                             L1).numpy()
    for lo, hi in ((0, 11), (11, 21), (21, 31), (31, 41)):
        a, b = max(0, lo - halo), min(H, hi + halo)
        arms = [torch.cat([c[:2, a:b], c[2:, a:b] - a]) for c in (x0c, x1c)]
        slab = np.ascontiguousarray(vol[:, a:b])
        want = cross.cbca_plain(*arms, torch.as_tensor(slab), direction,
                                L1).numpy()
        got = _kernel_plan(*(c.numpy() for c in arms), slab, direction, L1)
        assert _bits_equal(got, want), (lo, hi)
        assert _bits_equal(want[:, lo - a:hi - a], whole[:, lo:hi]), (lo, hi)


@pytest.mark.parametrize("shape", [(11, 29, 61), (11, 5, 3)])
@pytest.mark.parametrize("L1", [0, 3, 5, 14, 7])
@pytest.mark.parametrize("direction", [-1, 1])
def test_window_plan_is_the_plain_version_bit_for_bit(direction, L1, shape):
    """The kernel's window plan (packed, clamped offsets; fixed-window
    predicated adds from +0; the vertical sums in the same order) equals
    ``cbca_plain`` bit for bit at the K of census, ad, slow, mb slow and
    the run-time instance (L1 = 7): NaN, -0.0 and 1e9 cells, both
    directions, a whole frame and one smaller than the window."""
    x0c, x1c, vol = _case(L1, direction, **dict(zip("DHW", shape)))
    want = cross.cbca_plain(x0c, x1c, torch.as_tensor(vol), direction,
                            L1).numpy()
    got = _window_plan(x0c.numpy(), x1c.numpy(), vol, direction, L1)
    assert _bits_equal(got, want)


@pytest.mark.parametrize("L1", [0, 3, 5, 14, 7])
def test_window_plan_on_a_row_slab(L1):
    """Row slabs with relative arms, as ``RowShards.cbca`` builds them
    (the halo rows' arms point outside the slab): the window plan equals
    ``cbca_plain`` on each slab bit for bit."""
    direction = 1
    x0c, x1c, vol = _case(L1, direction, seed=5, H=41)
    H, halo = vol.shape[1], max(2, L1) - 1
    for lo, hi in ((0, 11), (11, 21), (21, 31), (31, 41)):
        a, b = max(0, lo - halo), min(H, hi + halo)
        arms = [torch.cat([c[:2, a:b], c[2:, a:b] - a]) for c in (x0c, x1c)]
        slab = np.ascontiguousarray(vol[:, a:b])
        want = cross.cbca_plain(*arms, torch.as_tensor(slab), direction,
                                L1).numpy()
        got = _window_plan(*(c.numpy() for c in arms), slab, direction, L1)
        assert _bits_equal(got, want), (lo, hi)


@pytest.mark.parametrize("L1", [0, 3, 5])
def test_window_plan_clamp_is_exact(L1):
    """Arms longer than K (those of L1 = 14 under a smaller K) are
    clamped to [-K, K] in the packed offsets, and the plan still equals
    ``cbca_plain`` bit for bit: an end beyond K gives the same interval
    as the clamped one."""
    x0c, x1c, vol = _case(L1, -1, seed=9, arms_L1=14)
    assert (x0c[1] - torch.arange(61) > max(2, L1)).any()
    want = cross.cbca_plain(x0c, x1c, torch.as_tensor(vol), -1, L1).numpy()
    got = _window_plan(x0c.numpy(), x1c.numpy(), vol, -1, L1)
    assert _bits_equal(got, want)


@pytest.mark.parametrize("L1", [0, 5, 14, 7])
def test_packed_offsets(L1):
    """``cbca_pack_plain`` lays out the numpy offsets as the kernel reads
    them: the left image's column pairs (H, P) with column c at c + 8,
    the right image's in eight copies, copy s with column c at c - s + 8,
    then the row pairs of both images, 0 where no column is; the first
    end of each pair in the low byte. On arms longer than K (L1 = 14's,
    clamped) and on a row slab's relative arms, at an odd width too."""
    K = max(2, L1)
    for W in (61, 58):
        x0c, x1c, _ = _case(L1, 1, W=W, arms_L1=14)
        for arms in ((x0c, x1c), [torch.cat([c[:2, 3:20], c[2:, 3:20] - 3])
                                  for c in (x0c, x1c)]):
            got = cross.cbca_pack_plain(*arms, L1).numpy()
            H = arms[0].shape[1]
            P = cross.pack_pitch(W)
            assert P % 8 == 0 and P >= W + 16
            assert got.dtype == np.int16 and got.shape == (9 * H * P
                                                           + 2 * H * W,)
            off = [_pack_np(a.numpy(), K) for a in arms]  # int8 (4, H, W)
            pair = [(o[0::2].astype(np.int16) & 0xff)
                    | (o[1::2].astype(np.int16) << 8) for o in off]
            want_h = np.zeros((9, H, P), np.int16)
            want_h[0, :, 8:8 + W] = pair[0][0]
            for s in range(8):
                want_h[1 + s, :, 8 - s:8 - s + W] = pair[1][0]
            assert np.array_equal(got[:9 * H * P].reshape(9, H, P), want_h)
            assert np.array_equal(got[9 * H * P:].reshape(2, H, W),
                                  np.stack([pair[0][1], pair[1][1]]))


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    """``cross_arms``, ``cbca_pack`` and ``cbca`` on CPU tensors return
    their plain versions' bits and launch no kernel; ``cbca`` the same
    bits with its arms' pack handed to it or with any tensor there."""
    x0c, x1c, vol = _case(5, 1)
    img = torch.as_tensor(_img(4))
    before = _build.launches()
    assert torch.equal(cross.cross_arms(img, 5, 0.13),
                       cross.cross_arms_plain(img, 5, 0.13))
    assert torch.equal(cross.cbca_pack(x0c, x1c, 5),
                       cross.cbca_pack_plain(x0c, x1c, 5))
    got = cross.cbca(x0c, x1c, torch.as_tensor(vol), 1, 5).numpy()
    want = cross.cbca_plain(x0c, x1c, torch.as_tensor(vol), 1, 5).numpy()
    assert _bits_equal(got, want)
    # a pack is read by the kernel only; the plain version ignores it
    for packed in (cross.cbca_pack(x0c, x1c, 5), torch.zeros(1)):
        got = cross.cbca(x0c, x1c, torch.as_tensor(vol), 1, 5,
                         packed=packed).numpy()
        assert _bits_equal(got, want)
    assert _build.launches() == before


def test_the_kernels_are_registered_and_exported():
    """The three entries are counted kernels of the ``cross`` source, and
    the C entries the wrappers bind are the ones cross.cu exports."""
    assert "cross" in _build.SOURCES
    assert {"cbca", "cross_arms", "cbca_pack"} <= set(_build.KERNELS)
    assert set(re.findall(r'extern "C" int (\w+)\(', SRC)) == {
        "cbca_smem_bytes", "cbca_launch", "cbca_pack_launch",
        "cross_arms_launch"}


def test_cbca_footprint_keeps_every_config_under_the_limit():
    """The mirror of the kernel's shared-memory plan uses cross.cu's tile
    (TX columns, TS rows, CH staged rows = NT * HP / TX), its largest K
    and its windows, and every config's K fits a block of the H100 (the
    tile is fixed, so the footprint is the same at W = 1226 and 1500);
    K = 14, mb slow's, takes 34,944 bytes (six blocks an SM), K = 5
    27,648 and K = 2 25,728 (eight); K = 7 runs in the window of 8."""
    tile = re.search(r"constexpr int TX = (\d+), TS = (\d+);", SRC)
    nt = int(re.search(r"constexpr int NT = (\d+);", SRC)[1])
    hp = int(re.search(r"constexpr int HP = (\d+);", SRC)[1])
    assert (int(tile[1]), int(tile[2])) == (cross.TX, cross.TS)
    assert nt * hp // int(tile[1]) == cross.CH
    assert int(re.search(r"constexpr int KMAX = (\d+);", SRC)[1]) == cross.KMAX
    assert [cross.cbca_smem_bytes(k) for k in (14, 5, 2)] == [34944, 27648,
                                                              25728]
    for key, sm in config._SM.items():
        assert cross.cbca_smem_bytes(max(2, sm["L1"])) <= _build.MAX_SMEM, key
    assert cross.cbca_smem_bytes(cross.KMAX) <= _build.MAX_SMEM
    assert [cross.window_of(k) for k in (2, 3, 4, 5, 7, 14, 15, 17, 64)] == [
        2, 3, 8, 5, 8, 14, 16, 32, 64]
    assert cross.cbca_smem_bytes(7) == cross.cbca_smem_bytes(8)


NARROW = dict(l1=2, fm=8, l2=3, nh2=16)


@pytest.mark.parametrize("case", ["slow", "slow bf16", "slow disp_true",
                                  "census disp_true", "ad", "fast cbca",
                                  "slow row-sharded"])
def test_the_generic_lane_hands_cbca_what_the_kernel_takes(monkeypatch,
                                                           case):
    """Every operand the generic lane hands to ``cbca`` (the volume and
    both arm stacks) is float32 and contiguous, as the kernel requires
    (it casts nothing): kitti slow, with ``-dtype bfloat16`` and with
    ``disp_true``, census with ``disp_true``, ad, fast with CBCA, and
    the row-sharded slow pair's slabs."""
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.parallel import inference, make_mesh
    from mccnn_tpu_torch.pipeline import stereo_predict

    seen = []
    orig = cross.cbca

    def record(x0c, x1c, vol, direction, L1, packed=None):
        seen.append((x0c, x1c, vol))
        return orig(x0c, x1c, vol, direction, L1, packed=packed)

    monkeypatch.setattr(cross, "cbca", record)
    arch = case.split()[0]
    over = dict(NARROW) if arch == "slow" else {}
    if case == "slow bf16":
        over["dtype"] = "bfloat16"
    if arch == "fast":
        over.update(cbca_i1=2, L1=5, tau1=0.13)
    cfg = make_config("kitti", arch, a="predict", **over)
    net = towers.init_net(cfg)
    H, W, D = 20, 48, 12
    base = np.random.RandomState(5).randn(H, W + D).astype(np.float32)
    x0, x1 = base[:, D:], base[:, :-D]
    if case == "slow row-sharded":
        inference.make_sharded_predict(cfg, make_mesh(2, backend="cpu"), D)(
            net, x0, x1)
    else:
        stereo_predict(cfg, net, x0, x1, D, device="cpu",
                       disp_true=9 if "disp_true" in case else None)
    assert seen
    for t in (t for ops in seen for t in ops):
        assert t.dtype == torch.float32 and t.is_contiguous()


@pytest.mark.parametrize("case", ["slow", "census", "ad", "fast cbca",
                                  "kitti2015 slow", "ad sm_terminate sgm",
                                  "fast stream", "slow row-sharded"])
def test_the_generic_lane_packs_the_arms_once_a_pair(monkeypatch, case):
    """``_method`` packs the arms once a pair (``Stages.pack``) and hands
    that pack to every ``cbca`` call of the pair: kitti slow, census
    (4 + 8 iterations a direction), ad (its 4 after the SGM only),
    fast with CBCA and kitti2015 slow; no pack where no iteration runs
    (ad stopped after the SGM, fast on the generic lane); the row-sharded
    slow pair packs once a shard, each shard's calls reading its own
    pack. The maps equal those of a run where every call packs for
    itself (the CPU's plain CBCA ignores the pack)."""
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.parallel import inference, make_mesh
    from mccnn_tpu_torch.pipeline import stereo_predict

    packs, calls = [], []
    orig_pack, orig_cbca = cross.cbca_pack, cross.cbca

    def pack(x0c, x1c, L1):
        packs.append(orig_pack(x0c, x1c, L1))
        return packs[-1]

    def cbca(x0c, x1c, vol, direction, L1, packed=None):
        calls.append((vol.shape[1], packed))
        return orig_cbca(x0c, x1c, vol, direction, L1, packed=packed)

    words = case.split()
    dataset = "kitti2015" if words[0] == "kitti2015" else "kitti"
    arch = words[1] if dataset == "kitti2015" else words[0]
    over = dict(NARROW) if arch == "slow" else {}
    if case == "fast cbca":
        over.update(cbca_i1=2, L1=5, tau1=0.13)
    if "sm_terminate" in words:
        over["sm_terminate"] = "sgm"
    cfg = make_config(dataset, arch, a="predict", **over)
    net = towers.init_net(cfg)
    H, W, D = 20, 48, 12
    base = np.random.RandomState(6).randn(H, W + D).astype(np.float32)
    x0, x1 = base[:, D:], base[:, :-D]
    n = 2 if "row-sharded" in words else 1

    def run():
        if n > 1:
            return inference.make_sharded_predict(
                cfg, make_mesh(n, backend="cpu"), D)(net, x0, x1)
        return stereo_predict(cfg, net, x0, x1, D, device="cpu",
                              sgm_form="stream" if "stream" in words
                              else None)

    want = run()
    monkeypatch.setattr(cross, "cbca_pack", pack)
    monkeypatch.setattr(cross, "cbca", cbca)
    got = run()
    assert torch.equal(got, want)
    its = cfg.cbca_i1 + (cfg.cbca_i2 if cfg.sm_terminate != "sgm" else 0)
    assert len(calls) == 2 * n * its
    assert len(packs) == (n if its else 0)
    for i, pk in enumerate(packs):
        mine = [c for c in calls if c[1] is pk]
        assert len(mine) == 2 * its
        # a shard's pack is of its slab's rows
        assert pk.numel() == 9 * mine[0][0] * cross.pack_pitch(W) \
            + 2 * mine[0][0] * W
