"""The arithmetic of the cost-volume and SGM-table kernels
(``csrc/costs.cu``, ``csrc/sgm_tables.cu``) on the CPU.

Each kernel's per-output arithmetic is mirrored in numpy float32 and
uint64 (the census signature pass's 64-bit words and the volume pass's
popcount, the ad kernel's row sums then column sums and its count of
valid positions, the table kernel's index decode of one buffer) and held
bit for bit to the plain version the wrapper runs on CPU tensors, and so
are the kernels' block plans, block by block with the tile constants
read out of ``costs.cu`` (census: the staged span, its parity slots, the
interior rows-only mask; ad: the staged tile and span, the slots with
their zero slot, the ring of row sums; the signatures: the NaN-staged
tile, the register windows, the 32-bit halves of each word; the tables:
a block a row of a part, 16-byte groups with a scalar head and tail, the
gaps with the last row); the plain versions are held to the JAX
package here (the signatures) and in tests/test_torch_costs.py,
tests/test_torch_sgm.py and the pipeline tests (the volumes, the tables
through ``sgm_slab_hwd``).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import costs as jcosts
from mccnn_tpu_torch import pipeline
from mccnn_tpu_torch.ops import _build, costs, join, sgm

F32 = np.float32
SRC = (_build.CSRC / "costs.cu").read_text()


def _const(name):
    """``constexpr int name = expr;`` in costs.cu, its expression over the
    constants before it evaluated (``/`` as C++'s integer division)."""
    env = {}
    for n, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", SRC):
        # integers, names, + - * and /, no negative operands
        env[n] = eval(expr.replace("/", "//"), {}, dict(env))
        if n == name:
            return env[n]
    raise KeyError(name)


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


def _kernel_row_mask(r, ylo, yhi):
    """The volume kernel's rows-only mask of a block's row (``rowm``): the
    whole run of 2r + 1 bits of each window row dy in [ylo, yhi], each
    word as ``row_word`` builds it."""
    w = 2 * r + 1
    run = (1 << w) - 1
    m = []
    for j in range(costs.census_words(r)):
        word = 0
        for dy in range(ylo, yhi + 1):
            sh = (dy + r) * w - 64 * j
            if 0 <= sh < 64:
                word |= (run << sh) & (2 ** 64 - 1)
            elif -64 < sh < 0:
                word |= run >> -sh
        m.append(word)
    return m


@pytest.mark.parametrize("r", range(8))
def test_census_row_mask_is_the_interior_rectangle(r):
    """The rows-only mask that an interior cell (x and x + d * dir both
    in [r, W - 1 - r]) takes equals the window rectangle of its row range
    and the full column range [-r, r], word for word, for every row range
    a block's y can give: radius 0 to 7, one to four words."""
    nw = costs.census_words(r)
    for ylo in range(-r, 1):
        for yhi in range(r + 1):
            want = _mirror_window_mask(r, nw, ylo, yhi, -r, r)
            assert _kernel_row_mask(r, ylo, yhi) == [int(v) for v in want]


def _popcount_words(v, r):
    """The kernel's count of a cell's words (``agreeing``): 64 bits a
    word, 32 for a last word whose high half holds no window position."""
    n = (2 * r + 1) ** 2
    nw = costs.census_words(r)
    last_hi = n - 64 * (nw - 1) > 32
    keep = [np.uint64(2 ** 64 - 1)] * (nw - 1) + [
        np.uint64(2 ** 64 - 1 if last_hi else 2 ** 32 - 1)]
    return np.bitwise_count(v & np.array(keep, np.uint64)).astype(
        np.int64).sum(-1)


def _tiled_census(sig0, sig1, D, direction, r):
    """The volume kernel's plan, block by block (CT threads of CX adjacent
    columns of a row, DCH disparities): each channel's span of CW + DCH
    - 1 match signatures staged from its least column (zeros off the
    frame) in parity planes (``span_slot``), column x0 + k of a thread
    read at entry e0 + k + j * dir; an interior cell takes the row mask,
    an edge cell in frame the table entry, a cell off the frame 0; the
    distances summed over channels, then one store a cell."""
    CT, CX, CW, DCH, span, half = (_const(n) for n in (
        "CT", "CX", "CW", "DCH", "SPAN", "HALF"))
    C, H, W, nw = sig0.shape
    n = (2 * r + 1) ** 2
    recip = F32(1) / F32(C)
    out = np.full((D, H, W), 7.0, F32)  # every cell written below
    tid = np.arange(CT)
    ent = np.arange(span)
    slot = (ent & 1) * half + (ent >> 1)
    assert len(set(slot)) == span and slot.max() < 2 * half
    for bx in range(-(-W // CW)):
        for y in range(H):
            ylo, yhi = max(-r, -y), min(r, H - 1 - y)
            rowm = np.array(_kernel_row_mask(r, ylo, yhi), np.uint64)
            table = {(a, b): np.array(
                [_kernel_window_word(r, ylo, yhi, a, b, j) for j in range(nw)],
                np.uint64) for a in range(-r, 1) for b in range(r + 1)}
            for d0 in range(0, D, DCH):
                xs = bx * CW + (d0 if direction > 0 else -(d0 + DCH - 1))
                e0 = tid * CX + (0 if direction > 0 else DCH - 1)
                cols = xs + ent
                agree = np.zeros((CX, DCH, CT), np.int64)
                for c in range(C):
                    sp = np.zeros((2 * half, nw), np.uint64)
                    sp[slot] = np.where(((cols >= 0) & (cols < W))[:, None],
                                        sig1[c, y, np.clip(cols, 0, W - 1)],
                                        np.uint64(0))
                    for k in range(CX):
                        x = bx * CW + tid * CX + k
                        xin = x < W
                        xint = (x >= r) & (x <= W - 1 - r)
                        s0 = sig0[c, y, np.minimum(x, W - 1)]
                        for j in range(min(DCH, D - d0)):
                            xm = x + (d0 + j) * direction
                            e = e0 + k + j * direction
                            s1 = sp[(e & 1) * half + (e >> 1)]
                            inner = xint & (xm >= r) & (xm <= W - 1 - r)
                            inframe = (xm >= 0) & (xm < W)
                            xlo = np.maximum(np.maximum(-r, -x), -xm)
                            xhi = np.minimum(np.minimum(r, W - 1 - x),
                                             W - 1 - xm)
                            m = np.zeros((CT, nw), np.uint64)
                            for t in np.nonzero(xin & inframe & ~inner)[0]:
                                m[t] = table[(xlo[t], xhi[t])]
                            m[inner] = rowm
                            agree[k, j] += _popcount_words(m & ~(s0 ^ s1), r)
                for k in range(CX):
                    x = bx * CW + tid * CX + k
                    xin = x < W
                    for j in range(min(DCH, D - d0)):
                        xm = x + (d0 + j) * direction
                        cost = (C * n - agree[k, j]).astype(F32) * recip
                        cost = np.where((xm >= 0) & (xm < W), cost, np.nan)
                        out[d0 + j, y, x[xin]] = cost[xin].astype(F32)
    return out


TILED_CENSUS = [((9, 131), 0, 33), ((5, 126), 4, 40), ((3, 50), 4, 70),
                ((3, 4, 61), 7, 36), ((2, 6, 140), 2, 34), ((4, 3), 1, 5),
                ((3, 259), 4, 40)]


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("shape,r,D", TILED_CENSUS,
                         ids=[f"{'x'.join(map(str, s))}-r{r}-D{D}"
                              for s, r, D in TILED_CENSUS])
def test_census_tile_plan_is_the_plain_volume(shape, r, D, direction):
    """The volume kernel's staged spans, parity slots, entry indices,
    interior and edge masks and half-word counts, block by block with
    the tile constants read from costs.cu, bit for bit against the plain
    volume: W odd, W 2 mod 4, W below one block and past two, D off the
    disparity chunk, spans that leave the frame on both sides, radius 0,
    1, 2, 4, 7, C = 2 and 3."""
    x0, x1 = _images(5 * r + D, shape)
    t0, t1 = torch.as_tensor(x0), torch.as_tensor(x1)
    sig = costs.census_signatures(t0, t1, r).numpy().view(np.uint64)
    a, b = (sig[0], sig[1]) if direction == -1 else (sig[1], sig[0])
    ta, tb = (t0, t1) if direction == -1 else (t1, t0)
    want = costs.census_volume_plain(ta, tb, D, direction, r).numpy()
    got = _tiled_census(a, b, D, direction, r)
    np.testing.assert_array_equal(_bits(got), _bits(want))


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


def _adversarial_images(seed, shape):
    """Quarter-step images (ties) with NaN of two payloads, +inf, -inf,
    -0.0 beside +0.0, spread over each plane and its edges."""
    x0, x1 = _images(seed, shape)
    rng = np.random.RandomState(seed + 1)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 0.0], F32)
    for x in (x0, x1):
        flat = x.reshape(-1)
        n = max(2, flat.size // 7)
        idx = rng.choice(flat.size, size=min(n, flat.size), replace=False)
        flat[idx] = specials[rng.randint(0, len(specials), size=idx.size)]
        flat.view(np.uint32)[idx[:max(1, idx.size // 6)]] = 0x7fc00123
        flat[idx[-1]] = np.nan
    return x0, x1


def _tiled_signatures(x0, x1, r):
    """The signature kernel's plan, block by block with the tile constants
    read from costs.cu: a block's STY x STX tile of one plane staged with a
    halo of r, NaN (0x7fc00000) off the frame; a lane one column and SCY
    rows of it, each staged row's window of 2r + 1 values compared with
    every centre whose window holds that row (``v < c``), bit b of the
    window into 32-bit half b // 32; the halves assembled into words (word
    w = half 2w | half 2w + 1 << 32), written only for pixels in the frame.
    Returns the (2, C, H, W, nw) uint64 words and the (2, C, H, W, 2 nw)
    uint32 halves."""
    scy, swx, swy, stx, sty = (_const(n) for n in (
        "SCY", "SWX", "SWY", "STX", "STY"))
    assert stx == 32 * swx and sty == scy * swy
    ims = np.concatenate([x0, x1])  # (2C, H, W)
    n2, H, W = ims.shape
    wd = 2 * r + 1
    n = wd * wd
    nw = -(-n // 64)
    nan = np.array([0x7fc00000], np.uint32).view(F32)[0]
    halves = np.full((n2, H, W, 2 * nw), 0xDEADBEEF, np.uint32)
    cx = np.arange(stx)
    for img in range(n2):
        for by in range(0, H, sty):
            for bx in range(0, W, stx):
                ys = by - r + np.arange(sty + 2 * r)
                xs = bx - r + np.arange(stx + 2 * r)
                inside = (((ys >= 0) & (ys < H))[:, None]
                          & ((xs >= 0) & (xs < W))[None, :])
                tile = np.where(inside, ims[img][np.clip(ys, 0, H - 1)][
                    :, np.clip(xs, 0, W - 1)], nan).astype(F32)
                x = bx + cx
                keep = x < W
                for cy in range(0, sty, scy):
                    if by + cy >= H:
                        break
                    c = tile[cy + r:cy + r + scy, cx + r]  # (SCY, STX)
                    bits = np.zeros((scy, n, stx), bool)
                    for i in range(scy + 2 * r):
                        v = tile[cy + i][cx[:, None] + np.arange(wd)]
                        for k in range(scy):
                            wy = i - k
                            if 0 <= wy < wd:
                                bits[k, wy * wd:(wy + 1) * wd] = (
                                    v < c[k][:, None]).T
                    h = np.zeros((scy, 2 * nw, stx), np.uint32)
                    for b in range(n):
                        h[:, b // 32] |= (bits[:, b].astype(np.uint32)
                                          << np.uint32(b % 32))
                    for k in range(scy):
                        y = by + cy + k
                        if y >= H:
                            break
                        halves[img, y, x[keep]] = h[k][:, keep].T
    words = (halves[..., 0::2].astype(np.uint64)
             | halves[..., 1::2].astype(np.uint64) << np.uint64(32))
    C = n2 // 2
    return (words.reshape(2, C, H, W, nw),
            halves.reshape(2, C, H, W, 2 * nw))


SIG_SHAPES = [(5, 9), (21, 70), (1, 80), (40, 1), (2, 18, 66)]


@pytest.mark.parametrize("shape", SIG_SHAPES,
                         ids=["x".join(map(str, s)) for s in SIG_SHAPES])
@pytest.mark.parametrize("r", [0, 1, 3, 4, 5, 6, 7])
def test_signature_tile_plan_is_the_plain_signatures(shape, r):
    """The signature kernel's tiles, NaN-staged halo, register windows and
    word assembly, block by block, word for word against
    ``census_signatures_plain`` and, half by half, against the JAX
    package's ``_census_bits`` (its 32-bit words are the kernel's
    halves), on images with NaN of two payloads, +-inf, -0.0 beside +0.0
    and ties: radius 0, 1, 3-7 (one to four words), a frame smaller than
    a tile, one off a multiple of the tile, one row, one column, two
    channels."""
    x0, x1 = _adversarial_images(7 * r + sum(shape), shape)
    c0, c1 = (x[None] if x.ndim == 2 else x for x in (x0, x1))
    words, halves = _tiled_signatures(c0, c1, r)
    want = costs.census_signatures_plain(torch.as_tensor(x0),
                                         torch.as_tensor(x1), r)
    np.testing.assert_array_equal(words, want.numpy().view(np.uint64))
    n = (2 * r + 1) ** 2
    for i, cs in enumerate((c0, c1)):
        for c, x in enumerate(cs):
            jb, _ = jcosts._census_bits(jnp.asarray(x), r)
            jb = np.asarray(jb)  # (ceil(n / 32), H, W) uint32
            got = np.moveaxis(halves[i, c], -1, 0)
            np.testing.assert_array_equal(got[:len(jb)], jb)
            assert not got[len(jb):].any()  # a half past the last position
            np.testing.assert_array_equal(
                _unpack(np.moveaxis(words[i, c], -1, 0), n, 64),
                _unpack(jb, n, 32))


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


def _tiled_ad(x0, x1, D, direction, r):
    """The ad kernel's plan, block by block (ATY rows x ATX columns, AND
    disparities, a warp a disparity at a time, a lane AX columns) with the
    constants read from costs.cu: x0's tile and x1's span staged with
    zeros off the frame, the span's column m at m + m // 32 and a zero
    slot Z (the gaps hold NaN here: a read of one shows); each window
    column's slot (Z off the frame) and ok; the terms, each row's sum from
    its leftmost tap, a ring of 2r + 1 row sums, each column sum from the
    top, the integer count, one division."""
    AX, ATX, ATY, AND = (_const(n) for n in ("AX", "ATX", "ATY", "AND"))
    H, W = x0.shape
    win = 2 * r + 1
    rows_, nx = ATY + 2 * r, AX + 2 * r
    nv = -(-nx // 4)
    p0 = ATX - AX + 4 * nv
    span1 = ATX + 2 * r + AND - 1
    z = span1 + span1 // 32
    out = np.full((D, H, W), 7.0, F32)  # every cell written below
    lane = np.arange(32)
    c = np.arange(nx)
    inf = lambda v: (v >= 0) & (v < W)  # noqa: E731
    for xt in range(0, W, ATX):
        for y0 in range(0, H, ATY):
            for d0 in range(0, D, AND):
                dmin = d0 if direction > 0 else -(d0 + AND - 1)
                t0 = np.zeros((rows_, p0), F32)
                t1 = np.full((rows_, z + 1), np.nan, F32)
                for i in range(rows_):
                    yy = y0 - r + i
                    if not 0 <= yy < H:
                        t0[i] = 0
                        m = np.arange(span1 + 1)
                        t1[i, m + m // 32] = 0
                        continue
                    xx = xt - r + np.arange(p0)
                    t0[i] = np.where(inf(xx), x0[yy, np.clip(xx, 0, W - 1)], 0)
                    m = np.arange(span1 + 1)
                    xx = xt - r + dmin + m
                    t1[i, m + m // 32] = np.where(
                        (m < span1) & inf(xx),
                        x1[yy, np.clip(xx, 0, W - 1)], 0)
                for k in range(min(AND, D - d0)):
                    d = d0 + k
                    delta = d * direction
                    xc = xt + lane * AX
                    xx = xc[:, None] - r + c[None]
                    m = lane[:, None] * AX + c[None] + delta - dmin
                    slot = np.where(inf(xx), m + m // 32, z)
                    ok = inf(xx + delta).astype(F32)
                    x = xc[:, None] + np.arange(AX)[None]
                    centre = (x < W) & inf(x + delta)
                    lo = np.maximum(max(0, -delta), x - r)
                    hi = np.minimum(min(W - 1, W - 1 - delta), x + r)
                    cols = np.where(centre, hi - lo + 1, 1)
                    ring = {}
                    for i in range(rows_):
                        a = t0[i][lane[:, None] * AX + c[None]]
                        t = np.abs(a - t1[i][slot]) * ok
                        s = t[:, 0:AX].copy()
                        for tap in range(1, win):
                            s = s + t[:, tap:tap + AX]
                        ring[i % win] = s
                        y = y0 + i - 2 * r
                        if i < 2 * r or y >= H:
                            continue
                        s = ring[(i - 2 * r) % win].copy()
                        for tap in range(1, win):
                            s = s + ring[(i - 2 * r + tap) % win]
                        n_rows = min(H - 1, y + r) - max(0, y - r) + 1
                        with np.errstate(invalid="ignore", divide="ignore"):
                            cnt = (n_rows * cols).astype(F32)
                            v = np.where(centre, s / cnt, np.nan).astype(F32)
                        keep = x < W
                        out[d, y, x[keep]] = v[keep]
    return out


TILED_AD = [((33, 131), 0, 17), ((35, 126), 7, 33), ((31, 50), 4, 60),
            ((40, 10), 2, 18), ((3, 6), 4, 4)]


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("shape,r,D", TILED_AD,
                         ids=[f"{'x'.join(map(str, s))}-r{r}-D{D}"
                              for s, r, D in TILED_AD])
def test_ad_tile_plan_is_the_plain_volume(shape, r, D, direction):
    """The ad kernel's staging, slots, register windows and ring, block by
    block, bit for bit against the plain volume: W odd, W 2 mod 4, W
    below one tile, H off the row tile, D off the disparity chunk, spans
    that leave the frame on both sides, radius 0, 2, 4, 7; NaN and inf in
    x1 near both edges, which the terms of columns off the frame must
    not read."""
    H, W = shape
    rng = np.random.RandomState(H * W + r)
    x0, x1 = (rng.randn(*shape).astype(F32) for _ in range(2))
    x1[:, :1] = np.nan
    x1[H // 2, -1] = np.inf
    want = costs.ad_volume_plain(torch.as_tensor(x0), torch.as_tensor(x1), D,
                                 direction, r).numpy()
    got = _tiled_ad(x0, x1, D, direction, r)
    np.testing.assert_array_equal(_bits(got), _bits(want))


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


def _row_plan_tables(x0, x1, D, H, W, shape, xrev):
    """The table kernel's plan: a block a stored row y of a part (table t =
    part // 2, D1 for an even part), the last row's block also the gap to
    the next part; each row's elements from its first 16-byte boundary in
    groups of four, a scalar head before it and a tail after; the two image
    rows fixed a block (clamped for D1, wrapped for D2), the xrev flip as
    index arithmetic. Every element written exactly once (a sentinel NaN
    payload elsewhere)."""
    Hp, Wp, Dp = shape
    gw = D + Wp + Dp
    n_d1, stride = sgm.table_layout(Hp, Wp, gw)
    out = np.full(4 * stride, np.nan, F32)
    out.view(np.uint32)[:] = 0x7fbadbad
    written = np.zeros(4 * stride, np.int64)
    core = W + 2 * D
    for part in range(8):
        t, d2 = part >> 1, bool(part & 1)
        vertical, step = t < 2, -1 if t & 1 else 1
        length = gw if d2 else Wp
        start = t * stride + (n_d1 if d2 else 0)
        region = (stride - n_d1) if d2 else n_d1
        img = x1 if d2 else x0
        for y in range(Hp):
            yin = y < H
            end = length if y < Hp - 1 else region - (Hp - 1) * length
            yb = y
            if yin and vertical:
                yb = y - step
                yb = (yb + H if yb < 0 else yb - H if yb >= H else yb) if d2 \
                    else min(max(yb, 0), H - 1)
            base = start + y * length
            head = min((4 - base % 4) % 4, end)
            nq = (end - head) // 4
            tail = head + 4 * nq
            assert all((base + head + 4 * q) % 4 == 0 for q in range(nq))
            j = np.arange(end)
            v = np.full(end, 0 if not d2 else 10, F32)
            if yin:
                ra, rb = img[y], img[yb]
                if d2:
                    x = (core - 1 - j if xrev else j) - D
                    xb = x if vertical else x - step
                    ok = (x >= 0) & (x < W) & (xb >= 0) & (xb < W)
                else:
                    x = W - 1 - j if xrev else j
                    xb = x if vertical else np.clip(x - step, 0, W - 1)
                    ok = j < W
                xc, xbc = np.clip(x, 0, W - 1), np.clip(xb, 0, W - 1)
                with np.errstate(invalid="ignore"):  # inf - inf
                    v = np.where(ok, np.abs(ra[xc] - rb[xbc]),
                                 v).astype(F32)
            v[j >= length] = 0  # the alignment gap
            for lo, hi in ((0, head), (head, tail), (tail, end)):
                out[base + lo:base + hi] = v[lo:hi]
                written[base + lo:base + hi] += 1
    assert (written == 1).all()
    return out


# gw = D + Wp + Dp 0, 1, 2, 3 mod 4 (D2 rows off 16 bytes), Wp odd (D1
# rows off 16 bytes), H = Hp = 1, a frame narrower than D
TABLE_PLAN_CASES = TABLE_CASES + [
    (7, 40, 9, (8, 44, 12)), (1, 33, 6, (1, 35, 8)), (3, 17, 2, (4, 20, 4)),
    (2, 5, 8, (3, 8, 9)), (12, 30, 10, (13, 31, 11))]


@pytest.mark.parametrize("xrev", [True, False])
@pytest.mark.parametrize("H,W,D,shape", TABLE_PLAN_CASES)
def test_table_row_plan_is_the_plain_buffer(H, W, D, shape, xrev):
    """The table kernel's row plan (a block a row of a part, 16-byte
    groups from the first boundary, scalar head and tail, the gaps with
    the last row) bit for bit against ``sgm_tables_plain``, the whole
    buffer, gaps and pad rows included: gw 0-3 mod 4, Wp odd, H = 1,
    images with NaN, +-inf and -0.0."""
    rng = np.random.RandomState(H * W + D + 1)
    x0, x1 = (rng.rand(H, W).astype(F32) for _ in range(2))
    x0[0, 0] = x0[0, -1]  # a zero gradient
    x0[-1, W // 2] = np.inf
    x1[0, W // 3] = np.nan
    x1[-1, -1] = -0.0
    x0[H // 2, 0] = -np.inf
    want = sgm.sgm_tables_plain(torch.as_tensor(x0), torch.as_tensor(x1), D,
                                H, W, shape, xrev=xrev)
    got = _row_plan_tables(x0, x1, D, H, W, shape, xrev)
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))


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
