"""The algorithms of the refinement kernels (``csrc/refine.cu``) against
the JAX package, on the CPU.

The kernels run only on the card (tests/test_torch_kernels_cuda.py holds
them against their plain versions there). Here numpy mirrors of what each
kernel computes (the mismatch fill's walk of every ray, in the order
its probes go out: a warp's rounds for a sparse tile, a thread's chunks
for a dense one; the occlusion fill's row scan, the subpixel kernel's
strided read) are held against
``mccnn_tpu/ops/post.py`` bit for bit; the comparator tables and rays in
the ``.cu`` against the plain versions' own; and the wrappers' CPU
dispatch against the ``*_plain`` functions.
"""

import functools
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import post as jpost
from mccnn_tpu_torch.ops import _build, post

SRC = (Path(post.__file__).resolve().parent.parent / "csrc"
       / "refine.cu").read_text()
MISMATCH, OCCLUSION, MATCH = 2.0, 1.0, 0.0


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _macro(name: str) -> str:
    """The body of ``#define name(...)`` in refine.cu, continuation lines
    joined."""
    m = re.search(rf"#define {name}\([A-Z]\) \\\n((?:.*\\\n)*.*)\n", SRC)
    assert m, name
    return m.group(1).replace("\\\n", " ")


# --- (a) the mismatch fill: a walk of every ray ------------------------

def _ray_walk(d0, lab, excl=True):
    """What mismatch_fill_kernel computes, pixel by pixel: each MISMATCH
    pixel walks the 16 rays, probe t at (y + floor(t dy + 0.5),
    x + floor(t dx + 0.5)); out of frame, or (``excl``) an odd t on row
    (column) 0 of a ray with dy (dx) -0.5, lands empty; a probe that is
    not MISMATCH lands with d0 there. sorted(landed)[cnt // 2], d0 if
    nothing landed."""
    H, W = d0.shape
    out = d0.copy()
    for y, x in zip(*np.nonzero(lab == MISMATCH)):
        vals = []
        for fdx, fdy in post._RAY_DIRS.tolist():
            t = 1
            while True:
                py = y + math.floor(t * fdy + 0.5)
                px = x + math.floor(t * fdx + 0.5)
                if not (0 <= py < H and 0 <= px < W):
                    break
                if excl and t % 2 == 1 and ((fdy == -0.5 and py == 0)
                                            or (fdx == -0.5 and px == 0)):
                    break
                if lab[py, px] != MISMATCH:
                    vals.append(d0[py, px])
                    break
                t += 1
        if vals:
            out[y, x] = sorted(vals)[len(vals) // 2]
    return out


def _mismatch_case(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    H, W = (19, 37)
    d0 = (rng.randint(0, 60, (H, W)) + rng.choice([0, .25, .5], (H, W))
          ).astype(np.float32)
    lab = rng.choice([MATCH, OCCLUSION, MISMATCH], (H, W),
                     p=[.5, .2, .3]).astype(np.float32)
    if name == "all mismatch":
        lab[:] = MISMATCH
    elif name == "long runs":
        # runs of 2^k + 1 and more along both axes and the diagonals
        lab[:, 3:36] = MISMATCH
        lab[2:19, :] = np.where(rng.rand(17, W) < 0.9, MISMATCH, lab[2:19])
        lab[0, 0] = lab[18, 36] = MATCH
    elif name == "edges":
        # mismatch against row 0 and column 0, landings on both: the
        # half directions' odd probes there are really at -0.5
        lab[:6, :] = MISMATCH
        lab[:, :6] = MISMATCH
        lab[0, ::3] = MATCH
        lab[::3, 0] = OCCLUSION
    elif name == "cnt 0":
        # all mismatch but two pixels: many pixels see neither of them
        lab[:] = MISMATCH
        lab[4, 9] = MATCH
        lab[15, 30] = OCCLUSION
    elif name == "clustered":
        # a MISMATCH block larger than one 32 x 8 tile, so that its tiles
        # walk a thread a pixel, beside sparse tiles
        lab = np.where(rng.rand(H, W) < 0.03, MISMATCH, MATCH).astype(
            np.float32)
        lab[3:17, 2:35] = MISMATCH
        lab[9, 20] = OCCLUSION
    elif name == "rounds":
        # dense runs of every length: events fall on every probe of a
        # round, first and last, landings, frame edges and the -0.5 rule
        lab = np.where(rng.rand(H, W) < 0.93, MISMATCH,
                       rng.choice([MATCH, OCCLUSION], (H, W))).astype(
            np.float32)
    elif name == "column":
        # one MISMATCH column (as the KITTI path's map has at x = 39):
        # the two vertical rays walk the frame, the others land at once
        lab = np.where(lab == MISMATCH, OCCLUSION, lab)
        lab[:, 11] = MISMATCH
    return d0, lab


MISMATCH_MAPS = ["random", "all mismatch", "long runs", "edges", "cnt 0",
                 "clustered", "rounds", "column"]


@functools.lru_cache(maxsize=None)
def _jax_mismatch(name):
    d0, lab = _mismatch_case(name)
    return np.asarray(jpost.interpolate_mismatch(jnp.asarray(d0),
                                                 jnp.asarray(lab)))


@pytest.mark.parametrize("name", MISMATCH_MAPS)
def test_ray_walk_is_the_jax_mismatch_fill(name):
    """The kernel's walk equals the JAX package's pointer doubling (and
    the port's plain version) bit for bit; on the edge map the -0.5 rule
    decides pixels, and on the cnt 0 map some pixels land nothing."""
    d0, lab = _mismatch_case(name)
    got = _ray_walk(d0, lab)
    want = _jax_mismatch(name)
    plain = post.interpolate_mismatch_plain(torch.as_tensor(d0),
                                            torch.as_tensor(lab)).numpy()
    assert _bits_equal(got, want)
    assert _bits_equal(plain, want)
    if name == "edges":
        assert not _bits_equal(_ray_walk(d0, lab, excl=False), want)
    if name == "cnt 0":
        kept = (lab == MISMATCH) & (got == d0)
        assert 0 < kept.sum() < (lab == MISMATCH).sum()
    if name == "all mismatch":
        assert _bits_equal(got, d0)


def _const(name: str) -> int:
    """``constexpr int name = value;`` in refine.cu."""
    m = re.search(rf"constexpr int {name} = (-?\d+);", SRC)
    assert m, name
    return int(m.group(1))


RAYS2 = [(int(2 * dx), int(2 * dy)) for dx, dy in post._RAY_DIRS.tolist()]


def _first_out(c2, pos, n):
    """The kernel's ``first_out``: the first step of a ray component c2 / 2
    from ``pos`` that is out of [0, n) or the -0.5 rule's odd step on 0."""
    return {2: n - pos, -2: pos + 1, 1: 2 * (n - 1 - pos) + 1,
            -1: 2 * pos + 1}.get(c2, 1 << 40)


def _probe(y, x, ray, t):
    """Probe t of ray (cx, cy) from (y, x): floor(t c / 2 + 0.5) as the
    kernel's ``(t * c + 1) >> 1``."""
    cx, cy = RAYS2[ray]
    return y + ((t * cy + 1) >> 1), x + ((t * cx + 1) >> 1)


def _round_walk(mm, y, x, P, trace=None):
    """A sparse tile's warp walk of pixel (y, x) (``walk_warp``) on the
    MISMATCH mask ``mm`` (nested lists): in each round the m open rays, in
    ascending order, share the 32 lanes (L = 32 // m each; lane l serves
    ray open[l % m] as its h = l // m), lane h probes t = next + h + L i
    for i < P; the lane's earliest event (t at or past the ray's
    first_out: empty; a probe not MISMATCH: landed), a ray's earliest over
    its lanes closes it, the open rays go on at next + L P. Returns each
    ray's landing (py, px) or None. ``trace`` (a set) collects (kind,
    i == 0, i == P - 1) of each event that closed a ray."""
    H, W = len(mm), len(mm[0])
    t0 = [min(_first_out(cx, x, W), _first_out(cy, y, H)) for cx, cy in RAYS2]
    nxt, land = [1] * 16, [None] * 16
    open_ = list(range(16))
    while open_:
        m = len(open_)
        L = 32 // m
        events = {r: [] for r in open_}
        for lane in range(m * L):
            r, h = open_[lane % m], lane // m
            for i in range(P):
                t = nxt[r] + h + L * i
                py, px = _probe(y, x, r, t)
                if t >= t0[r]:
                    kind = "out" if not (0 <= py < H and 0 <= px < W) \
                        else "-0.5"
                    events[r].append((t, None, kind, i))
                    break
                if not mm[py][px]:
                    events[r].append((t, (py, px), "landed", i))
                    break
        still = []
        for r in open_:
            if events[r]:
                _, land[r], kind, i = min(events[r])
                if trace is not None:
                    trace.add((kind, i == 0, i == P - 1))
            else:
                nxt[r] += L * P
                still.append(r)
        open_ = still
    return land


def _chunk_walk(mm, y, x, Q):
    """A dense tile's thread walk of pixel (y, x) (``walk_chunks``): each
    ray in chunks of Q probes from t = 1, the probes below its first_out
    loaded, the first not MISMATCH landed."""
    H, W = len(mm), len(mm[0])
    land = [None] * 16
    for r, (cx, cy) in enumerate(RAYS2):
        t0 = min(_first_out(cx, x, W), _first_out(cy, y, H))
        t = 1
        while t < t0 and land[r] is None:
            for tt in range(t, min(t + Q, t0)):
                py, px = _probe(y, x, r, tt)
                if not mm[py][px]:
                    land[r] = (py, px)
                    break
            t += Q
    return land


def _tiled_fill(d0, lab, P, Q, dense, paths=None, trace=None):
    """What mismatch_fill_kernel computes: 32 x 8 tiles; a tile with more
    than ``dense`` MISMATCH pixels walks them by ``_chunk_walk``, another
    by ``_round_walk``; sorted(landed)[cnt // 2], d0 if nothing landed.
    ``paths`` (a set) collects the walks taken."""
    H, W = d0.shape
    out = d0.copy()
    mm = (lab == MISMATCH).tolist()
    for ty in range(0, H, 8):
        for tx in range(0, W, 32):
            pix = [(ty + a, tx + b) for a, b in
                   zip(*np.nonzero(lab[ty:ty + 8, tx:tx + 32] == MISMATCH))]
            walk = "dense" if len(pix) > dense else "sparse"
            if pix and paths is not None:
                paths.add(walk)
            for y, x in pix:
                land = (_chunk_walk(mm, y, x, Q) if walk == "dense"
                        else _round_walk(mm, y, x, P, trace))
                vals = [d0[w] for w in land if w is not None]
                if vals:
                    out[y, x] = sorted(vals)[len(vals) // 2]
    return out


@pytest.mark.parametrize("P", [1, 4, 8])
def test_round_walk_is_the_jax_mismatch_fill(P):
    """The redesigned walk's order of probes (a warp's rounds of L P probes
    a ray for a sparse tile, P of them a lane; a thread's chunks of Q for a
    dense one) equals the JAX package's pointer doubling bit for bit on
    every map: every tile sparse, every tile dense, and the kernel's own
    split at its DENSE; P = 1, 4, 8 (the kernel's is 8). Across the maps
    the events that close a ray fall on a lane's first and last probe of a
    round as landings, frame edges and the -0.5 rule, and both walks are
    taken."""
    Q, dense = _const("Q"), _const("DENSE")
    assert _const("P") == 8 and Q % 2 == 0 and 0 < dense < 256
    trace, paths = set(), set()
    for name in MISMATCH_MAPS:
        d0, lab = _mismatch_case(name)
        want = _jax_mismatch(name)
        assert _bits_equal(_tiled_fill(d0, lab, P, Q, 256, trace=trace),
                           want), name
        assert _bits_equal(_tiled_fill(d0, lab, P, Q, dense, paths), want), \
            name
        if P == 8:
            assert _bits_equal(_tiled_fill(d0, lab, P, Q, -1), want), name
    assert paths == {"dense", "sparse"}
    for kind in ("landed", "out", "-0.5"):
        assert (kind, True, P == 1) in trace
        if P > 1:
            assert (kind, False, True) in trace


def test_rays_and_networks_in_the_source_are_the_plain_versions():
    """(b) The comparator tables in refine.cu are the plain versions'
    (and the JAX package's) networks, 113 and 53 comparators; its rays
    are ``_RAY_DIRS`` in order, as twice their components."""
    pair = re.compile(r"C\((\d+), (\d+)\)")
    for name, n, mid, length in (("MEDIAN25_NET", 25, 12, 113),
                                 ("MEDIAN16_NET", 16, 8, 53)):
        table = [(int(a), int(b)) for a, b in pair.findall(_macro(name))]
        assert table == post._median_network(n, mid)
        assert table == jpost._median_network(n, mid)
        assert len(table) == length
    rays = re.findall(r"R\((\d+), (-?\d+), (-?\d+)\)", _macro("RAYS"))
    assert [int(k) for k, _, _ in rays] == list(range(16))
    assert np.array_equal(np.array([(int(a), int(b)) for _, a, b in rays]),
                          post._RAY_DIRS * 2)
    assert np.array_equal(post._RAY_DIRS, jpost._RAY_DIRS)


# --- (c) the occlusion fill: a scan of each row --------------------------

def _row_scan(d0, lab, nt):
    """What occlusion_fill_kernel computes for each row with ``nt``
    threads: the row in chunks of ceil(W / nt) columns, each chunk's last
    and first match, an inclusive max-scan of the last and min-scan of
    the first over the chunks, then a pass over each chunk carrying the
    last match from the left; an OCCLUSION pixel takes the value of the
    last match at or left of it, else of the row's first match, else
    keeps its own; in place, as the kernel fills its shared row."""
    out = d0.copy()
    W = d0.shape[1]
    chunk = -(-W // nt)
    for y in range(d0.shape[0]):
        row, kind = out[y], lab[y]
        bounds = [(min(W, t * chunk), min(W, t * chunk + chunk))
                  for t in range(nt)]
        last = [max([x for x in range(a, b) if kind[x] == MATCH],
                    default=-1) for a, b in bounds]
        first = [min([x for x in range(a, b) if kind[x] == MATCH],
                     default=W) for a, b in bounds]
        last = np.maximum.accumulate(last)
        first = np.minimum.accumulate(first[::-1])[::-1]
        for t, (a, b) in enumerate(bounds):
            left = last[t - 1] if t > 0 else -1
            for x in range(a, b):
                if kind[x] == MATCH:
                    left = x
                elif kind[x] == OCCLUSION:
                    src = left if left >= 0 else (first[0] if first[0] < W
                                                  else x)
                    row[x] = row[src]
    return out


@pytest.mark.parametrize("H,W,nt", [(13, 300, 256), (9, 37, 4), (7, 600, 256),
                                    (5, 3, 8)])
def test_row_scan_is_the_jax_occlusion_fill(H, W, nt):
    """The kernel's row scan equals the JAX package's two associative
    scans (and the port's plain version) bit for bit, on rows with no
    match (kept), rows whose only matches lie right of the occlusions,
    and random rows; with 256 threads (W = 300: two columns a chunk; 600:
    three) and with fewer threads than columns in small rows."""
    rng = np.random.RandomState(H * W + nt)
    d0 = (rng.rand(H, W) * 100).astype(np.float32)
    lab = rng.choice([MATCH, OCCLUSION, MISMATCH], (H, W),
                     p=[.3, .5, .2]).astype(np.float32)
    lab[0] = np.where(lab[0] == MATCH, OCCLUSION, lab[0])   # no match
    lab[1] = OCCLUSION                                       # no match at all
    if W > 2:
        lab[2, :W // 2] = OCCLUSION                          # matches right
        lab[2, -1] = MATCH
    got = _row_scan(d0, lab, nt)
    want = np.asarray(jpost.interpolate_occlusion(jnp.asarray(d0),
                                                  jnp.asarray(lab)))
    plain = post.interpolate_occlusion_plain(torch.as_tensor(d0),
                                             torch.as_tensor(lab)).numpy()
    assert _bits_equal(got, want)
    assert _bits_equal(plain, want)
    assert _bits_equal(got[:2], d0[:2])


# --- (d) subpixel: the strided read ------------------------------------

def _strided_subpixel(d0, flat, strides, Dp, xrev, disp_max, thresh):
    """What subpixel_kernel computes: d = int(d0[y, x]) (the plain
    version's own conversion); the samples at flat[y*sy + c*sx + j*sd],
    c = W-1-x if ``xrev`` else x, j = d-1, d, d+1 (int32 wrap) inside
    [0, Dp), else 0; the parabola in float32."""
    f32 = np.float32
    H, W = d0.shape
    sy, sx, sd = strides
    ds = torch.as_tensor(d0).to(torch.int32).numpy()
    out = np.empty((H, W), f32)
    for y in range(H):
        for x in range(W):
            d = int(ds[y, x])
            base = y * sy + (W - 1 - x if xrev else x) * sx
            cn, cz, cp = (f32(flat[base + j * sd]) if 0 <= j < Dp else f32(0)
                          for j in ((d + k + 2**31) % 2**32 - 2**31
                                    for k in (-1, 0, 1)))
            with np.errstate(invalid="ignore", divide="ignore",
                             over="ignore"):
                denom = f32(2) * ((cp + cn) - f32(2) * cz)
                r = f32(d)
                if 1 <= d < disp_max - 1 and denom > f32(thresh):
                    q = (cp - cn) / denom
                    r = f32(d) - (q if np.isnan(q) else min(max(q, f32(-1)),
                                                            f32(1)))
            out[y, x] = r
    return out


def _subpixel_case(dtype):
    rng = np.random.RandomState(6)
    D, H, W = 24, 7, 29
    vol = rng.rand(D, H, W).astype(np.float32)
    vol[rng.rand(D, H, W) < 0.05] = np.nan
    vol[:, :, ::5] = 0.5  # flat triples: denominators at the threshold
    d0 = (rng.randint(-1, D + 2, (H, W))
          + rng.choice([0, .5, .99], (H, W))).astype(np.float32)
    v = torch.as_tensor(vol).to(dtype)
    return d0, v, D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_strided_read_is_the_plain_subpixel(dtype):
    """The kernel's read of the generic lane's (D, H, W) volume through
    the strides of its (H, W, D) view, and of an x-reversed (H, Wp, Dp)
    HWD volume holding the same samples (pad columns and NaN pad lanes),
    both equal to the plain ``subpixel_enhancement`` bit for bit (16-bit
    storage widened to float32); the float32 case equals the JAX
    package's masked sums."""
    d0, vol, D = _subpixel_case(dtype)
    H, W = d0.shape
    plain = post.subpixel_enhancement_plain(torch.as_tensor(d0), vol,
                                            D).numpy()
    wide = vol.float().numpy()
    got = _strided_subpixel(d0, wide.ravel(), (W, 1, H * W), D, False, D,
                            1e-5)
    assert _bits_equal(got, plain)
    Wp, Dp = W + 5, 32
    hwd = torch.full((H, Wp, Dp), float("nan"), dtype=dtype)
    hwd[:, :W, :D] = vol.permute(1, 2, 0).flip(1)
    flat = hwd.float().numpy().ravel()
    got_x = _strided_subpixel(d0, flat, (Wp * Dp, Dp, 1), Dp, True, D, 1e-5)
    assert _bits_equal(got_x, plain)
    assert _bits_equal(post.subpixel_enhancement_hwd(
        torch.as_tensor(d0), hwd, D, xrev=True).numpy(), plain)
    if dtype == torch.float32:
        want = np.asarray(jpost.subpixel_enhancement(jnp.asarray(d0),
                                                     jnp.asarray(wide), D))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_strided_read_wraps_as_the_plain_subpixel(dtype):
    """The kernel's read of an x-reversed HWD volume with NaN pad lanes
    and pad columns at the edges of the disparity axis, against
    ``subpixel_enhancement_hwd_plain`` bit for bit: d in {-1, 0, 1,
    Dp - 2, Dp - 1, Dp}, a NaN d0 and huge ones of both signs (the int32
    wrap of d - 1 and d + 1), f32, bf16 and f16 storage."""
    rng = np.random.RandomState(17)
    H, W, Wp, Dp, D = 6, 41, 48, 32, 27
    vol = rng.rand(H, Wp, Dp).astype(np.float32)
    vol[..., D:] = np.nan
    vol[:, ::7, :] = 0.5  # flat triples: denominators at the threshold
    hwd = torch.as_tensor(vol).to(dtype)
    d0 = (rng.randint(-2, Dp + 2, (H, W))
          + rng.choice([0, .5, .99], (H, W))).astype(np.float32)
    d0[0, :6] = [-1, 0, 1, Dp - 2, Dp - 1, Dp]
    d0[1, :5] = [np.nan, 3e9, -3e9, 2.0**31, -2.0**31]
    flat = hwd.float().numpy().ravel()
    got = _strided_subpixel(d0, flat, (Wp * Dp, Dp, 1), Dp, True, D, 4e-5)
    want = post.subpixel_enhancement_hwd_plain(torch.as_tensor(d0), hwd, D,
                                               4e-5, xrev=True).numpy()
    assert _bits_equal(got, want)
    assert not np.isnan(want[2:]).all()


def test_xrev_subpixel_is_the_padded_flip_of_the_hwd_lane():
    """``xrev=True`` on the natural map equals the HWD lane's old call
    site (the map flipped and padded to Wp, the parabola in storage
    order, sliced and flipped back) and the JAX package's, at the
    undivided SGM threshold."""
    rng = np.random.RandomState(8)
    H, W, Wp, Dp, D = 9, 100, 128, 128, 30
    vol = rng.rand(H, Wp, Dp).astype(np.float32)
    vol[..., D:] = np.nan
    d0 = rng.randint(0, D, (H, W)).astype(np.float32)
    got = post.subpixel_enhancement_hwd(torch.as_tensor(d0),
                                        torch.as_tensor(vol), D,
                                        denom_thresh=4e-5, xrev=True).numpy()
    d_rev = np.pad(d0[:, ::-1], ((0, 0), (0, Wp - W)))
    want = np.asarray(jpost.subpixel_enhancement_hwd(
        jnp.asarray(d_rev), jnp.asarray(vol), D, denom_thresh=4e-5))
    assert _bits_equal(got, want[:, :W][:, ::-1])


# --- (e) the wrappers on CPU tensors -----------------------------------

def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    """Every public function of ops/post.py on CPU tensors returns its
    plain version's map bit for bit, and launches no kernel."""
    rng = np.random.RandomState(12)
    H, W, D = 17, 41, 20
    d0 = torch.as_tensor((rng.rand(H, W) * D).astype(np.float32))
    lab = torch.as_tensor(rng.choice([MATCH, OCCLUSION, MISMATCH], (H, W))
                          .astype(np.float32))
    vol = torch.as_tensor(rng.rand(D, H, W).astype(np.float32))
    hwd = torch.as_tensor(rng.rand(H, W + 7, 32).astype(np.float32))
    before = _build.launches()
    pairs = [
        (post.interpolate_occlusion(d0, lab),
         post.interpolate_occlusion_plain(d0, lab)),
        (post.interpolate_mismatch(d0, lab),
         post.interpolate_mismatch_plain(d0, lab)),
        (post.subpixel_enhancement(d0, vol, D),
         post.subpixel_enhancement_plain(d0, vol, D)),
        (post.subpixel_enhancement_hwd(d0, hwd, D, 4e-5, xrev=True),
         post.subpixel_enhancement_hwd_plain(d0, hwd, D, 4e-5, xrev=True)),
        (post.subpixel_enhancement_hwd(d0, hwd[:, :W], D),
         post.subpixel_enhancement_hwd_plain(d0, hwd[:, :W], D)),
        (post.median2d(d0, 5), post.median2d_plain(d0, 5)),
        (post.median2d(d0, 3), post.median2d_plain(d0, 3))]
    for got, want in pairs:
        assert got.dtype == torch.float32
        assert _bits_equal(got.numpy(), want.numpy())
    assert _build.launches() == before


def test_median_plain_matches_jax_with_nan():
    """The plain median, which the kernel's network repeats, on a map
    with NaN against the JAX package's: the same NaN-propagating network,
    the same NaN mask and values."""
    rng = np.random.RandomState(13)
    img = rng.randint(0, 50, (21, 30)).astype(np.float32)
    img[rng.rand(21, 30) < 0.02] = np.nan
    got = post.median2d_plain(torch.as_tensor(img), 5).numpy()
    want = np.asarray(jpost.median2d(jnp.asarray(img), 5))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any()


def test_the_kernels_are_registered_and_exported():
    """The four entries are counted kernels of the ``refine`` source, and
    the C entries the wrappers bind are the ones refine.cu exports."""
    assert "refine" in _build.SOURCES
    for k in ("occlusion_fill", "mismatch_fill", "subpixel", "median5"):
        assert k in _build.KERNELS
    exported = set(re.findall(r'extern "C" int (\w+)\(', SRC))
    assert exported == {"occlusion_fill_launch", "mismatch_fill_launch",
                        "median5_launch", "subpixel_launch",
                        "occlusion_fill_smem_bytes"}
    assert post.STORAGE == {torch.float32: 0, torch.bfloat16: 1,
                            torch.float16: 2}


@pytest.mark.parametrize("W,nbytes", [(1226, 8178), (1500, 9548),
                                      (46080, 232448)])
def test_occlusion_kernel_footprint(W, nbytes):
    """The shared memory the occlusion kernel stages for rows of W
    columns (2 KB of scan state, then the row's values and a byte of
    kind, five bytes a column): 46080 is the widest row a block of the
    H100 takes, which the wrapper refuses beyond."""
    assert post.occlusion_smem_bytes(W) == nbytes <= _build.MAX_SMEM
    assert W < 46080 or post.occlusion_smem_bytes(W + 1) > _build.MAX_SMEM
