"""The arithmetic of the cost-volume and SGM-table kernels
(``csrc/costs.cu``, ``csrc/sgm_tables.cu``) on the CPU.

Each kernel's per-output arithmetic is mirrored in numpy float32 and
uint64 (the census signature pass's 64-bit words and the volume pass's
popcount, the ad kernel's row sums then column sums and its count of
valid positions, the table kernel's index decode of one buffer) and held
bit for bit to the plain version the wrapper runs on CPU tensors; the
plain versions are held to the JAX package here (the signatures) and in
tests/test_torch_costs.py, tests/test_torch_sgm.py and the pipeline
tests (the volumes, the tables through ``sgm_slab_hwd``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import costs as jcosts
from mccnn_tpu_torch import pipeline
from mccnn_tpu_torch.ops import _build, costs, join, sgm

F32 = np.float32


def _images(seed, shape):
    """Two images of quarter steps, so that the census ``<`` meets ties."""
    rng = np.random.RandomState(seed)
    return tuple((np.round(rng.randn(*shape) * 4) / 4).astype(F32)
                 for _ in range(2))


def _bits(a):
    return np.ascontiguousarray(a, dtype=F32).view(np.int32)


# --- census ---------------------------------------------------------------

def _mirror_signatures(x0, x1, r):
    """The signature pass: for each pixel of each channel of both images
    the window positions in row-major order, bit k % 64 of word k // 64
    set where the neighbour lies in the frame and is less than the
    centre: (2, C, H, W, nw) uint64."""
    ims = np.concatenate([x0, x1])  # (2C, H, W)
    n2, H, W = ims.shape
    nw = -(-(2 * r + 1) ** 2 // 64)
    out = np.zeros((n2, H, W, nw), np.uint64)
    ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            ok = (ys + dy >= 0) & (ys + dy < H) & (xs + dx >= 0) & (xs + dx < W)
            yy = np.clip(ys + dy, 0, H - 1)
            xx = np.clip(xs + dx, 0, W - 1)
            less = (ims[:, yy, xx] < ims) & ok
            bit = np.uint64(1) << np.uint64(k % 64)
            out[:, :, :, k // 64] |= np.where(less, bit, np.uint64(0))
            k += 1
    return out.reshape(2, n2 // 2, H, W, nw)


@functools.lru_cache(maxsize=None)
def _mirror_window_mask(r, nw, ylo, yhi, xlo, xhi):
    """The volume pass's table entry: bit k set where window position k
    = (dy + r) * (2r + 1) + (dx + r) has dy in [ylo, yhi] and dx in
    [xlo, xhi]."""
    w = 2 * r + 1
    m = [0] * nw
    for k in range(w * w):
        dy, dx = k // w - r, k % w - r
        if ylo <= dy <= yhi and xlo <= dx <= xhi:
            m[k // 64] |= 1 << (k % 64)
    return np.array(m, np.uint64)


def _kernel_window_word(r, ylo, yhi, xlo, xhi, j):
    """Word j of the volume kernel's table entry as the kernel builds it:
    the run of bits dx in [xlo, xhi] shifted to each row dy in [ylo,
    yhi], cut at the word's ends."""
    w = 2 * r + 1
    run = ((1 << (xhi - xlo + 1)) - 1) << (xlo + r)
    m = 0
    for dy in range(ylo, yhi + 1):
        sh = (dy + r) * w - 64 * j
        if 0 <= sh < 64:
            m |= (run << sh) & (2 ** 64 - 1)
        elif -64 < sh < 0:
            m |= run >> -sh
    return m


@pytest.mark.parametrize("r", range(8))
def test_census_window_table_is_the_rectangle(r):
    """Every entry of the volume kernel's shared table (each row range
    a block's y can give, each column range a cell can give), word for
    word, is the window rectangle of ``_mirror_window_mask``, which the
    mirror volume (held to the plain version) reads: radius 0 to 7, one
    to four words."""
    nw = costs.census_words(r)
    for ylo in range(-r, 1):
        for yhi in range(r + 1):
            for xlo in range(-r, 1):
                for xhi in range(r + 1):
                    want = _mirror_window_mask(r, nw, ylo, yhi, xlo, xhi)
                    got = [_kernel_window_word(r, ylo, yhi, xlo, xhi, j)
                           for j in range(nw)]
                    assert got == [int(v) for v in want]


def _mirror_census(sig0, sig1, D, direction, r):
    """The volume pass: each channel's n - popc(m & ~(b0 ^ b1)) over the
    words, m the window rectangle in frame at y, x and x + d * direction
    (``_mirror_window_mask``, the entry of the kernel's shared table for
    the cell's column range), the channels' integer sum converted to
    float32 and multiplied by the float32 reciprocal of C; NaN off the
    frame."""
    C, H, W, nw = sig0.shape
    n = (2 * r + 1) ** 2
    recip = F32(1) / F32(C)
    out = np.full((D, H, W), np.nan, F32)
    for d in range(D):
        for y in range(H):
            for x in range(W):
                xm = x + d * direction
                if not 0 <= xm < W:
                    continue
                m = _mirror_window_mask(
                    r, nw, max(-r, -y), min(r, H - 1 - y),
                    max(-r, -x, -xm), min(r, W - 1 - x, W - 1 - xm))
                agree = m & ~(sig0[:, y, x] ^ sig1[:, y, xm])
                dist = int((n - np.bitwise_count(agree).astype(np.int64)
                            .sum(-1)).sum())
                out[d, y, x] = F32(dist) * recip
    return out


CENSUS_CASES = [((14, 45), 2, 21), ((14, 45), 4, 21), ((3, 14, 45), 2, 21),
                ((3, 14, 45), 4, 21), ((3, 6), 4, 4), ((3, 6), 2, 7),
                ((2, 5, 9), 4, 6), ((9, 30), 7, 10)]


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("shape,r,D", CENSUS_CASES,
                         ids=[f"{'x'.join(map(str, s))}-r{r}-D{D}"
                              for s, r, D in CENSUS_CASES])
def test_census_kernel_mirror_is_the_plain_volume(shape, r, D, direction):
    """Gray and rgb images with ties, radius 2 and 4 (one and two words)
    and 7 (four), frames smaller than the window (3 x 6 at radius 4: the
    plain version's roll wraps onto the pixel itself), D past the frame
    width: the signatures word for word and the volume bit for bit."""
    x0, x1 = _images(3 + r, shape)
    c0, c1 = (x[None] if x.ndim == 2 else x for x in (x0, x1))
    t0, t1 = torch.as_tensor(x0), torch.as_tensor(x1)
    sig = _mirror_signatures(c0, c1, r)
    got = costs.census_signatures(t0, t1, r)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), sig)
    a, b = (sig[0], sig[1]) if direction == -1 else (sig[1], sig[0])
    want = _mirror_census(a, b, D, direction, r)
    ta, tb = (t0, t1) if direction == -1 else (t1, t0)
    plain = costs.census_volume(ta, tb, D, direction, r)
    assert plain.shape == (D, *shape[-2:]) and np.isnan(want).any()
    np.testing.assert_array_equal(_bits(plain.numpy()), _bits(want))
    # the same volume from the pair's signatures, as the pipeline hands them
    halves = (got[0], got[1]) if direction == -1 else (got[1], got[0])
    again = costs.census_volume(ta, tb, D, direction, r, signatures=halves)
    assert torch.equal(again.view(torch.int32), plain.view(torch.int32))


def _unpack(words, n, per):
    """(words, H, W) integer words -> (n, H, W) bits, bit k % per of word
    k // per."""
    w = np.asarray(words).astype(np.uint64)
    return np.stack([(w[k // per] >> np.uint64(k % per)) & np.uint64(1)
                     for k in range(n)])


@pytest.mark.parametrize("shape,r", [((14, 45), 2), ((14, 45), 4),
                                     ((3, 6), 4), ((9, 30), 7)])
def test_census_signatures_hold_the_jax_bits(shape, r):
    """Each window position's bits of the once-a-pair signatures (64 a
    word) equal the JAX package's ``_census_bits`` (32 a word) for both
    images, and the frame's in-frame words (``_census_valid``, which the
    signatures do not carry) equal its ``valid``."""
    x0, x1 = _images(11 + r, shape)
    sig = costs.census_signatures(torch.as_tensor(x0), torch.as_tensor(x1),
                                  r).numpy().view(np.uint64)
    valid = costs._census_valid(*shape, r, "cpu").numpy().view(np.uint64)
    n = (2 * r + 1) ** 2
    for i, x in enumerate((x0, x1)):
        jb, jv = jcosts._census_bits(jnp.asarray(x), r)
        got = _unpack(np.moveaxis(sig[i, 0], -1, 0), n, 64)
        np.testing.assert_array_equal(got, _unpack(jb, n, 32))
        np.testing.assert_array_equal(_unpack(valid, n, 64),
                                      _unpack(jv, n, 32))


def test_popcount64_counts_all_64_bits():
    rng = np.random.RandomState(12)
    vals = [0, -1, -(1 << 63), (1 << 63) - 1, 1 << 62] + [
        int(v) for v in rng.randint(-2 ** 63, 2 ** 63 - 1, size=200,
                                    dtype=np.int64)]
    got = costs._popcount64(torch.tensor(vals, dtype=torch.int64)).tolist()
    assert got == [bin(v & (2 ** 64 - 1)).count("1") for v in vals]


# --- ad ---------------------------------------------------------------------

def _mirror_ad(x0, x1, D, direction, r):
    """The ad kernel's arithmetic: the terms |x0 - x1s| * ok with zeros
    outside the frame; each row sum from the leftmost tap, each add a
    float32 rounding; the row sums added from the top row; divided by
    the product of the window's in-frame rows and its in-frame columns
    whose match column is in frame; NaN where the centre's match leaves
    the frame."""
    H, W = x0.shape
    w = 2 * r + 1
    out = np.empty((D, H, W), F32)
    xs = np.arange(W)
    for d in range(D):
        delta = d * direction
        ok = (xs + delta >= 0) & (xs + delta < W)
        x1s = np.where(ok, x1[:, np.clip(xs + delta, 0, W - 1)], F32(0))
        t = np.pad(np.abs(x0 - x1s) * ok.astype(F32), r)  # (H + 2r, W + 2r)
        hs = t[:, 0:W].copy()
        for k in range(1, w):
            hs = (hs + t[:, k:k + W]).astype(F32)
        num = hs[0:H].copy()
        for k in range(1, w):
            num = (num + hs[k:k + H]).astype(F32)
        lo = np.maximum(np.maximum(0, -delta), xs - r)
        hi = np.minimum(np.minimum(W - 1, W - 1 - delta), xs + r)
        cols = np.maximum(0, hi - lo + 1)
        ys = np.arange(H)
        rows = np.minimum(H - 1, ys + r) - np.maximum(0, ys - r) + 1
        cnt = (rows[:, None] * cols[None, :]).astype(F32)
        with np.errstate(invalid="ignore", divide="ignore"):  # 0 / 0 off ok
            out[d] = np.where(ok, num / cnt, np.nan)
    return out


AD_CASES = [((14, 45), 4, 21), ((14, 45), 2, 30), ((3, 6), 4, 4),
            ((40, 7), 4, 9), ((37, 150), 7, 33), ((5, 5), 0, 3)]


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("shape,r,D", AD_CASES,
                         ids=[f"{'x'.join(map(str, s))}-r{r}-D{D}"
                              for s, r, D in AD_CASES])
def test_ad_kernel_mirror_is_the_plain_volume(shape, r, D, direction):
    """Row sums then column sums in the plain version's order, the count
    as a product of integers, one correctly rounded division: bit for
    bit, NaN masks included; frames smaller than the window, radius 0, 2,
    4, 7, D past the frame and past the plain version's chunk."""
    rng = np.random.RandomState(sum(shape) + r)
    x0, x1 = (rng.randn(*shape).astype(F32) for _ in range(2))
    got = costs.ad_volume(torch.as_tensor(x0), torch.as_tensor(x1), D,
                          direction, r)
    want = _mirror_ad(x0, x1, D, direction, r)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# --- the HWD lane's SGM tables ------------------------------------------

def _mirror_tables(x0, x1, D, H, W, shape, xrev):
    """The table kernel's decode of each buffer element: the table t
    (down, up, right, left), D1 or D2, its stored (row, column), the
    natural column behind it, the value."""
    Hp, Wp, Dp = shape
    gw = D + Wp + Dp
    n_d1, stride = sgm.table_layout(Hp, Wp, gw)
    out = np.zeros(4 * stride, F32)
    core = W + 2 * D
    for t in range(4):
        step = -1 if t & 1 else 1
        base = t * stride
        for y in range(Hp):
            for xs in range(Wp):
                v = F32(0)
                if y < H and xs < W:
                    x = W - 1 - xs if xrev else xs
                    if t < 2:
                        b = x0[min(max(y - step, 0), H - 1), x]
                    else:
                        b = x0[y, min(max(x - step, 0), W - 1)]
                    v = abs(x0[y, x] - b)
                out[base + y * Wp + xs] = v
            for j in range(gw):
                v = F32(10)
                xj = (core - 1 - j if xrev else j) - D
                if y < H and j < core and 0 <= xj < W:
                    if t < 2:
                        v = abs(x1[y, xj] - x1[(y - step) % H, xj])
                    elif 0 <= xj - step < W:
                        v = abs(x1[y, xj] - x1[y, xj - step])
                out[base + n_d1 + y * gw + j] = v
    return out


TABLE_CASES = [(5, 9, 4, (8, 12, 4)), (6, 20, 7, (8, 21, 9)),
               (1, 6, 3, (3, 7, 5)), (4, 3, 5, (5, 7, 6)),
               (9, 13, 130, join.pad_dims(9, 13, 130))]


@pytest.mark.parametrize("xrev", [True, False])
@pytest.mark.parametrize("H,W,D,shape", TABLE_CASES)
def test_sgm_tables_mirror_is_the_plain_buffer(H, W, D, shape, xrev):
    """The whole buffer, alignment gaps (sizes off a multiple of 4)
    included, bit for bit; one row (the vertical roll wraps onto
    itself), a frame narrower than D, the padded join shape."""
    rng = np.random.RandomState(H * W + D)
    x0, x1 = (rng.rand(H, W).astype(F32) for _ in range(2))
    x0[0, 0] = x0[0, -1]  # a zero gradient
    got = sgm.sgm_tables(torch.as_tensor(x0), torch.as_tensor(x1), D, H, W,
                         shape, xrev=xrev)
    want = _mirror_tables(x0, x1, D, H, W, shape, xrev)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("xrev", [True, False])
def test_sweep_plan_reads_views_of_one_buffer(xrev):
    """The plan's eight tables are views of one buffer at the offsets of
    ``table_layout``, each equal to the per-table build of ``_tables``
    bit for bit."""
    H, W, D = 11, 50, 20
    shape = join.pad_dims(H, W, D)
    Hp, Wp, Dp = shape
    gw = D + Wp + Dp
    rng = np.random.RandomState(5)
    x0, x1 = (torch.as_tensor(rng.rand(H, W).astype(F32)) for _ in range(2))
    plan = sgm.sweep_plan(x0, x1, D, H, W, shape, xrev=xrev, pi1=1.0,
                          pi2=2.0, tau_so=0.1, alpha1=2.0, q1=3.0, q2=2.0)
    n_d1, stride = sgm.table_layout(Hp, Wp, gw)
    base = plan[0]["d1"].data_ptr()
    cores = [torch.nn.functional.pad((x1 - torch.roll(x1, dy, 0)).abs(),
                                     (D, D), value=10.0) for dy in (1, -1)]
    cores += [sgm.d2_columns(x1, dx, 0, D) for dx in (1, -1)]
    d1s = [sgm.grad_with_sentinel(x0, axis=0, step=s) for s in (1, -1)]
    d1s += [sgm.grad_with_sentinel(x0, axis=1, step=s) for s in (1, -1)]
    for t, p in enumerate(plan):
        assert p["d1"].shape == (Hp, Wp) and p["g"].shape == (Hp, gw)
        assert p["d1"].data_ptr() == base + 4 * t * stride
        assert p["g"].data_ptr() == base + 4 * (t * stride + n_d1)
        d1, g = sgm._tables(d1s[t], cores[t], xrev, Hp, Wp, gw)
        assert torch.equal(p["d1"].view(torch.int32), d1.view(torch.int32))
        assert torch.equal(p["g"].view(torch.int32), g.view(torch.int32))


# --- the pipeline's use and the CPU dispatch ------------------------------

def test_volumes_compute_the_census_signatures_once_a_pair(monkeypatch):
    """``pipeline._volumes`` for census: one signature call a pair, its
    halves handed to both volumes, each equal to the JAX package's
    ``census_volume``; a row shard slices the halo'd volumes."""
    H, W, D = 12, 40, 9
    x0, x1 = _images(21, (H, W))
    calls = []
    orig = costs.census_signatures

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(costs, "census_signatures", counted)
    t0, t1 = torch.as_tensor(x0), torch.as_tensor(x1)
    vols = pipeline._volumes(None, t0, t1, arch="census", disp_max=D, ws=0)
    assert len(calls) == 1
    for direction, (a, b) in ((-1, (x0, x1)), (1, (x1, x0))):
        want = np.asarray(jcosts.census_volume(jnp.asarray(a), jnp.asarray(b),
                                               D, direction))
        np.testing.assert_array_equal(vols[direction].numpy(), want)
    part = pipeline._volumes(None, t0, t1, arch="census", disp_max=D, ws=0,
                             rows=slice(3, 8))
    for k in (-1, 1):
        assert part[k].is_contiguous()
        assert torch.equal(part[k].view(torch.int32),
                           vols[k][:, 3:8].contiguous().view(torch.int32))


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the four wrappers give their plain versions' bits
    and launch nothing; the kernels are registered and built from
    ``csrc``."""
    x0, x1 = (torch.as_tensor(a) for a in _images(4, (10, 33)))
    _build.reset_launches()
    pairs = [
        (costs.census_signatures(x0, x1), costs.census_signatures_plain(x0,
                                                                       x1)),
        (costs.census_volume(x0, x1, 12, -1),
         costs.census_volume_plain(x0, x1, 12, -1)),
        (costs.ad_volume(x0, x1, 12, 1), costs.ad_volume_plain(x0, x1, 12, 1)),
        (sgm.sgm_tables(x0, x1, 12, 10, 33, (16, 40, 16), xrev=True),
         sgm.sgm_tables_plain(x0, x1, 12, 10, 33, (16, 40, 16), xrev=True))]
    for got, want in pairs:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not any(_build.launches().values())
    assert {"costs", "sgm_tables"} <= set(_build.SOURCES)
    assert {"census_signatures", "census_volume", "ad_volume",
            "sgm_tables"} <= set(_build.KERNELS)
    for name in ("costs", "sgm_tables"):
        assert _build._source(name).exists()
    assert costs.MAX_RADIUS == 7 and costs.census_words(7) == 4
    assert [costs.census_words(r) for r in range(7)] == [1, 1, 1, 1, 2, 2, 3]
