"""The algorithms of the refinement kernels (``csrc/refine.cu``) against
the JAX package, on the CPU.

The kernels run only on the card (tests/test_torch_kernels_cuda.py holds
them against their plain versions there). Here numpy mirrors of what each
kernel computes (the mismatch fill's walk of every ray, in the order
its probes go out: a warp's rounds for a sparse tile, a thread's chunks
for a dense one; the occlusion fill's runs, warp scans and segments; the
median's two paths with its tile and lane choice; the subpixel kernel's
strided read) are held against
``mccnn_tpu/ops/post.py`` bit for bit; the comparator tables and rays in
the ``.cu`` against the plain versions' own, and the median's fast
network against the 0-1 principle; and the wrappers' CPU dispatch
against the ``*_plain`` functions.
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
from mccnn_tpu_torch.ops import _build, median_net, post

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
    m = re.search(rf"#define {name}\([A-Z, ]+\) \\\n((?:.*\\\n)*.*)\n", SRC)
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


# --- (c) the occlusion fill: runs, warp scans and segments -------------

def _occlusion_threads(W, nt):
    """``occlusion_threads`` of refine.cu with ``nt`` the most threads a
    row (OCC_MAX_NT there): runs of OCC_V columns in whole warps
    (fewer than 32 threads: one partial warp, for small segments)."""
    v = _const("OCC_V")
    return min(nt, -(-W // (32 * v)) * 32)


def _row_scan(d0, lab, nt):
    """What occlusion_fill_kernel computes for each row with at most ``nt``
    threads: the row in segments of threads x OCC_V columns, thread t a run
    of OCC_V from t OCC_V, warps of 32 threads; each run's last and first
    match; the last match left of a run: that of the nearest run before it
    in its warp with one (the warp's ballot), else the last of the nearest
    warp before with one, else the segments' before; the row's first match:
    the first of the first warp with one. An OCCLUSION pixel takes the
    value of the last match at or left of it, else of the row's first
    match, else keeps its own; when the row's first match turns up in a
    later segment, the earlier segments' occlusions take it then."""
    out = d0.copy()
    H, W = d0.shape
    V = _const("OCC_V")
    T = _occlusion_threads(W, nt)
    for y in range(H):
        kind, vals = lab[y], d0[y]
        carry, first = None, None
        for s0 in range(0, W, T * V):
            runs = [range(s0 + t * V, min(W, s0 + t * V + V))
                    for t in range(T)]
            mine = [[x for x in r if kind[x] == MATCH] for r in runs]
            warps = [[t for t in range(w, min(T, w + 32)) if mine[t]]
                     for w in range(0, T, 32)]
            wlast = [vals[mine[h[-1]][-1]] if h else None for h in warps]
            wfirst = [vals[mine[h[0]][0]] if h else None for h in warps]
            with_match = [w for w, h in enumerate(warps) if h]
            found = first is None and bool(with_match)
            if found:
                first = wfirst[with_match[0]]
            for t, r in enumerate(runs):
                w = t // 32
                before = [u for u in warps[w] if u < t]
                prev = [k for k in with_match if k < w]
                left = (vals[mine[before[-1]][-1]] if before
                        else wlast[prev[-1]] if prev else carry)
                for x in r:
                    if kind[x] == MATCH:
                        left = vals[x]
                    elif kind[x] == OCCLUSION:
                        out[y, x] = (left if left is not None else
                                     first if first is not None else vals[x])
            if found:
                for x in range(s0):
                    if kind[x] == OCCLUSION:
                        out[y, x] = first
            if with_match:
                carry = wlast[with_match[-1]]
    return out


def _occlusion_case(H, W, seed):
    rng = np.random.RandomState(seed)
    d0 = (rng.rand(H, W) * 100).astype(np.float32)
    lab = rng.choice([MATCH, OCCLUSION, MISMATCH], (H, W),
                     p=[.3, .5, .2]).astype(np.float32)
    lab[0] = np.where(lab[0] == MATCH, OCCLUSION, lab[0])   # no match
    lab[1] = OCCLUSION                                       # no match at all
    if W > 2:
        lab[2, :W // 2] = OCCLUSION                          # matches right
        lab[2, -1] = MATCH
    if H > 3:
        lab[3] = OCCLUSION                                   # one match, last
        lab[3, -1] = MATCH
    return d0, lab


def _jax_occlusion(d0, lab):
    return np.asarray(jpost.interpolate_occlusion(jnp.asarray(d0),
                                                  jnp.asarray(lab)))


@pytest.mark.parametrize("H,W,nt", [(13, 300, 256), (9, 37, 4), (7, 600, 256),
                                    (5, 3, 8), (7, 600, 64)])
def test_row_scan_is_the_jax_occlusion_fill(H, W, nt):
    """The kernel's runs, warp scans and segments equal the JAX package's
    two associative scans (and the port's plain version) bit for bit, on
    rows with no match (kept), rows whose only matches lie right of the
    occlusions (one of them in the last column), and random rows; one
    segment of two and three warps (W = 300, 600 with 256 threads), two
    segments of a partial warp (W = 37 with 4 threads: the row whose only
    match is in the last column revisits the first), a row narrower than
    a run, and two segments of two warps."""
    d0, lab = _occlusion_case(H, W, H * W + nt)
    got = _row_scan(d0, lab, nt)
    want = _jax_occlusion(d0, lab)
    plain = post.interpolate_occlusion_plain(torch.as_tensor(d0),
                                             torch.as_tensor(lab)).numpy()
    assert _bits_equal(got, want)
    assert _bits_equal(plain, want)
    assert _bits_equal(got[:2], d0[:2])


@pytest.mark.parametrize("W,threads,segments", [
    (1226, 320, 1), (1500, 384, 1), (4096, 1024, 1), (4097, 1024, 2),
    (46081, 1024, 12)])
def test_occlusion_width_rule(W, threads, segments):
    """Any row width fills: a row takes runs of OCC_V = 4 columns in whole
    warps, up to OCC_MAX_NT = 1024 threads, and a wider row segments of
    4096 columns (KITTI's 1226 columns 320 threads, mb's 1500 384, one
    segment; 46081, one past the widest row a block held when the row was
    staged in shared memory, twelve). The model at the kernel's own threads
    equals the plain version (held to the JAX package above) bit for bit,
    the row whose only match is its last column revisiting every earlier
    segment."""
    nt = _const("OCC_MAX_NT")
    assert (_const("OCC_V"), nt) == (4, 1024)
    T = _occlusion_threads(W, nt)
    assert (T, -(-W // (T * 4))) == (threads, segments)
    assert T % 32 == 0 and (T < nt or T * 4 >= W or segments > 1)
    d0, lab = _occlusion_case(4, W, W)
    plain = post.interpolate_occlusion_plain(torch.as_tensor(d0),
                                             torch.as_tensor(lab)).numpy()
    assert _bits_equal(_row_scan(d0, lab, nt), plain)


# --- (d) the median: two paths -----------------------------------------

def _net(name):
    """The comparator table ``name`` of refine.cu."""
    return [(int(a), int(b))
            for a, b in re.findall(r"C\((\d+), (\d+)\)", _macro(name))]


def _fast_net():
    """(inputs [(n, r, c)], ops [(N or X, d, a, b)], outputs [(k, s)]) of
    MEDIAN5_FAST_IN and MEDIAN5_FAST_NET in refine.cu."""
    ins = [tuple(map(int, t)) for t in re.findall(
        r"I\((\d+), (\d+), (\d+)\)", _macro("MEDIAN5_FAST_IN"))]
    net = _macro("MEDIAN5_FAST_NET")
    ops = [(op, int(d), int(a), int(b)) for op, d, a, b in re.findall(
        r"([NX])\((\d+), (\d+), (\d+)\)", net)]
    outs = [(int(k), int(v)) for k, v in re.findall(r"O\((\d+), (\d+)\)",
                                                     net)]
    return ins, ops, outs


def _vmin(a, b, rule="jax"):
    """A minimum with torch.minimum's NaN rule (a NaN operand, the first if
    both are); of equal values, -0.0 below +0.0 (``rule`` "jax": the JAX
    package's on the CPU) or the first operand ("first")."""
    tie = np.signbit(a) if rule == "jax" else True
    m = np.where(a < b, a, np.where(b < a, b, np.where(tie, a, b)))
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, m))


def _vmax(a, b, rule="jax"):
    """A maximum: the JAX package's on the CPU (a NaN operand, the second
    if both are; +0.0 above -0.0), or ("first") torch.maximum's NaN rule
    and the first of equal operands."""
    if rule == "jax":
        m = np.where(a > b, a, np.where(b > a, b, np.where(np.signbit(a),
                                                           b, a)))
        return np.where(np.isnan(b), b, np.where(np.isnan(a), a, m))
    m = np.where(a > b, a, np.where(b > a, b, a))
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, m))


def _unordered(v):
    return np.isnan(v) | ((v == 0) & np.signbit(v))


def _median_kernel(img, paths=None, fast="routed", rule="jax"):
    """What median5_kernel computes, with the minimum and maximum of
    ``rule``: 32 x 8 tiles, a lane MY x MX adjacent outputs. A lane whose
    (MY + 4) x (MX + 4) window union lies in frame and holds no NaN and no
    -0.0 runs MEDIAN5_FAST_NET (``fast`` "always": whatever it holds;
    "never": no lane); every other output the plain way: the out-of-frame
    taps filled -inf for the first 12 - cnt // 2, +inf for the rest, then
    MEDIAN25_NET. ``paths`` (a set) collects the paths taken."""
    H, W = img.shape
    MX, MY = _const("MX"), _const("MY")
    lanes, plain = [], []
    for gy in range(0, H, MY):
        for gx in range(0, W, MX):
            union = img[max(0, gy - 2):gy + MY + 2, max(0, gx - 2):gx + MX + 2]
            if (fast != "never" and gx >= 2 and gx + MX + 1 < W and gy >= 2
                    and gy + MY + 1 < H
                    and (fast == "always" or not _unordered(union).any())):
                lanes.append((gy, gx))
            else:
                plain += [(y, x) for y in range(gy, min(H, gy + MY))
                          for x in range(gx, min(W, gx + MX))]
    out = np.zeros((H, W), np.float32)
    done = np.zeros((H, W), int)
    if lanes:
        gy, gx = np.array(lanes).T
        ins, ops, outs = _fast_net()
        v = {n: img[gy - 2 + r, gx - 2 + c] for n, r, c in ins}
        for op, d, a, b in ops:
            v[d] = (_vmin if op == "N" else _vmax)(v[a], v[b], rule)
        for k, src in outs:
            out[gy + k // MX, gx + k % MX] = v[src]
            np.add.at(done, (gy + k // MX, gx + k % MX), 1)
    if plain:
        ys, xs = np.array(plain).T
        inf = np.float32(np.inf)
        taps = [((ys + dy >= 0) & (ys + dy < H) & (xs + dx >= 0)
                 & (xs + dx < W),
                 img[np.clip(ys + dy, 0, H - 1), np.clip(xs + dx, 0, W - 1)])
                for dx in range(-2, 3) for dy in range(-2, 3)]
        a = 12 - sum(ok.astype(int) for ok, _ in taps) // 2
        rank = np.zeros_like(a)
        vals = []
        for ok, v in taps:
            vals.append(np.where(ok, v, np.where(rank < a, -inf, inf)))
            rank = rank + ~ok
        for i, j in _net("MEDIAN25_NET"):
            vals[i], vals[j] = (_vmin(vals[i], vals[j], rule),
                                _vmax(vals[i], vals[j], rule))
        out[ys, xs] = vals[12]
        np.add.at(done, (ys, xs), 1)
    assert (done == 1).all()
    if paths is not None:
        paths |= {p for p, n in (("fast", lanes), ("plain", plain)) if n}
    return out


def _median_map(name):
    """A small map with ties: 21 x 70 holds an interior tile (rows 8-15,
    columns 32-63) whose halo lies in frame; the small maps are smaller
    than the window or than a lane's union."""
    rng = np.random.RandomState(sum(map(ord, name)))
    shape = {"3x2": (3, 2), "5x5": (5, 5), "1x40": (1, 40),
             "7x9": (7, 9)}.get(name, (21, 70))
    img = (rng.randint(0, 20, shape) + rng.choice([0, .5], shape)
           ).astype(np.float32)
    bits = img.view(np.int32)
    if name == "inf":
        img[rng.rand(*shape) < 0.05] = np.inf
        img[rng.rand(*shape) < 0.05] = -np.inf
    elif name == "nan":
        img[rng.rand(*shape) < 0.03] = np.nan
        bits[rng.rand(*shape) < 0.02] = 0x7fc00123  # another payload
        img[rng.rand(*shape) < 0.02] = np.inf
        img[rng.rand(*shape) < 0.02] = -np.inf
    elif name == "interior nan":
        img[11, 40], img[12, 50] = np.nan, np.nan
        bits[13, 45] = 0x7fc00123
        img[10, 60], img[14, 36] = np.inf, -np.inf
    elif name == "signed zeros":
        # windows whose median is zero: -0.0 next to +0.0 in the left
        # tiles, +0.0 alone in the right ones
        img[:] = rng.choice([0.0, 1.0, -1.0], shape, p=[.6, .2, .2])
        img[:, :40] = np.where(rng.rand(21, 40) < 0.5, -img[:, :40],
                               img[:, :40])
    return img


MEDIAN_MAPS = ["ties", "inf", "nan", "interior nan", "signed zeros", "3x2",
               "5x5", "1x40", "7x9"]


@pytest.mark.parametrize("name", MEDIAN_MAPS)
def test_median_kernel_model_is_the_jax_median(name):
    """The kernel's two paths (the fast network on lanes whose union lies
    in frame and holds no NaN and no -0.0, the plain network elsewhere)
    equal the JAX
    package's ``median2d`` bit for bit: ties, +-inf, NaN of two payloads
    (everywhere, or in the interior tile alone), -0.0 next to +0.0 where
    the median is zero, maps smaller than the window or a lane's union.
    The port's plain version on the CPU agrees in values and NaN masks,
    and in bits where the map holds no NaN and no -0.0: torch's CPU
    minimum picks either zero and either NaN by its vector width, so
    there the bits are the JAX package's and the card's plain version's
    (tests/test_torch_kernels_cuda.py). Under a minimum and maximum that
    keep the first of equal operands, too, the two paths give the plain
    network's bits everywhere; there the fast network taken whatever the
    union holds changes the bits on the NaN and the signed-zero maps."""
    img = _median_map(name)
    paths = set()
    got = _median_kernel(img, paths)
    want = np.asarray(jpost.median2d(jnp.asarray(img), 5))
    plain = post.median2d_plain(torch.as_tensor(img), 5).numpy()
    assert _bits_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    if not _unordered(img).any():
        assert _bits_equal(got, plain)
    assert paths == ({"plain"} if img.shape != (21, 70)
                     else {"fast", "plain"})
    for rule in ("jax", "first"):
        ref = _median_kernel(img, fast="never", rule=rule)
        assert _bits_equal(_median_kernel(img, rule=rule), ref)
    if name in ("nan", "signed zeros"):
        assert not _bits_equal(_median_kernel(img, fast="always",
                                              rule="first"), ref)
    if name == "signed zeros":
        zero = want == 0
        assert (zero & np.signbit(want)).any() and (zero[:, 44:]).any()


def _cone(ops, src):
    """The values that value ``src`` of the fast network depends on."""
    deps = {d: (a, b) for _, d, a, b in ops}
    seen, todo = set(), [src]
    while todo:
        v = todo.pop()
        if v not in seen:
            seen.add(v)
            todo += deps.get(v, ())
    return seen


def test_fast_network_selects_rank_12():
    """The fast network is the one ops/median_net.py generates (588
    min/max for 2 x 4 outputs: 73.5 a pixel, against 206 of the plain
    network after dead-code elimination), each output reads exactly its
    window's 25 inputs, and selects rank 12 of them on every 0-1 window
    (2^25 windows bit-sliced, AND for min and OR for max: the 0-1
    principle), and on seeded windows of tied values and infinities
    against a sort."""
    assert _macro("MEDIAN5_FAST_IN") + " " + _macro("MEDIAN5_FAST_NET") == \
        " ".join(m.split("\\\n", 1)[1].replace("\\\n", " ")
                 for m in median_net.macros().split("\n#define"))
    ins, ops, outs = _fast_net()
    MX, MY = _const("MX"), _const("MY")
    assert (median_net.R, median_net.C) == (MY, MX)
    assert [n for n, _, _ in ins] == list(range((MY + 4) * (MX + 4)))
    assert all(n == r * (MX + 4) + c for n, r, c in ins)
    assert [d for _, d, _, _ in ops] == list(range(len(ins),
                                                   len(ins) + len(ops)))
    assert len(ops) == 588 and len(median_net.program(1, 1)[0]) == 206
    idx = np.arange(1 << 20, dtype=np.uint32)
    low = [np.packbits((idx >> k & 1).astype(np.uint8), bitorder="little")
           .view(np.uint64) for k in range(20)]
    ones = np.full_like(low[0], np.uint64(2**64 - 1))
    count = np.bitwise_count(idx)
    for k, src in outs:
        i, j = divmod(k, MX)
        win = [r * (MX + 4) + c for c in range(j, j + 5)
               for r in range(i, i + 5)]
        cone = _cone(ops, src)
        assert cone & set(range(len(ins))) == set(win)
        mine = [op for op in ops if op[1] in cone]
        for high in range(32):  # the window's last 5 inputs, the rest sliced
            v = {w: low[n] if n < 20 else
                 (ones if high >> (n - 20) & 1 else ~ones)
                 for n, w in enumerate(win)}
            for op, d, a, b in mine:
                v[d] = v[a] & v[b] if op == "N" else v[a] | v[b]
            want = np.packbits(count + bin(high).count("1") >= 13,
                               bitorder="little").view(np.uint64)
            assert np.array_equal(v[src], want), (k, high)
    rng = np.random.RandomState(25)
    n = 20000
    v = {i: rng.choice(np.array([-np.inf, 0, 1, 2, np.inf], np.float32), n)
         for i in range(len(ins))}
    v.update({i: rng.randint(0, 3, n).astype(np.float32)
              for i in range(0, len(ins), 3)})
    for op, d, a, b in ops:
        v[d] = np.minimum(v[a], v[b]) if op == "N" else np.maximum(v[a], v[b])
    for k, src in outs:
        i, j = divmod(k, MX)
        win = np.stack([v[r * (MX + 4) + c] for c in range(j, j + 5)
                        for r in range(i, i + 5)])
        assert _bits_equal(v[src], np.sort(win, axis=0)[12])


# --- (e) subpixel: the strided read ------------------------------------

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


# --- (f) the wrappers on CPU tensors -----------------------------------

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
                        "median5_launch", "subpixel_launch"}
    assert post.STORAGE == {torch.float32: 0, torch.bfloat16: 1,
                            torch.float16: 2}
