"""The generic lane's SGM data movement (``csrc/sgm_layout.cu``'s plain
versions, on the CPU) against the JAX package: the families' d-minor
volumes against the transposes of ``_sgm_slab_horiz`` /
``_sgm_slab_vert`` (mccnn_tpu/ops/sgm.py:1149-1153, :1185-1192), the D1
/ D2 tables against ``_grad_with_sentinel`` (:1092) and ``_d2_columns``
(:1110) laid out as those functions lay them (:1156-1166, :1195-1207),
``Stages.sgm``'s quartered sum against ``_sgm_multi`` / 4, and
``costs.wta`` against ``costs.wta`` (mccnn_tpu/ops/costs.py:197), at
D % 32 != 0, one direction and both, column shards, on volumes with
NaN, -0.0, +-inf and 1e9 cells.

The kernels' own plans are mirrored in numpy with their constants read
out of ``sgm_layout.cu`` and held bit for bit to the plain versions: the
tables kernel's per-element index decode of each part (and the gaps),
the layout and combine tiles (every output element written once), and
the winner-take-all's split of D over the warps of a block with its
strict-< merge.
"""

import collections
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import costs as jcosts
from mccnn_tpu.ops import sgm as jsgm
from mccnn_tpu_torch import pipeline
from mccnn_tpu_torch.ops import _build, costs, sgm

F32 = np.float32
SRC = (_build.CSRC / "sgm_layout.cu").read_text()
KW = dict(pi1=1.32, pi2=24.25, tau_so=0.08, alpha1=2.0, sgm_q1=3.0,
          sgm_q2=2.0)
H, W = 17, 45
DIRS = [(-1, 1), (-1,), (1,)]


def _const(name):
    """``constexpr int name = expr;`` of sgm_layout.cu, evaluated over the
    constants before it (``/`` as C++'s integer division)."""
    env = {}
    for k, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", SRC):
        env[k] = eval(expr.replace("/", "//"), {}, dict(env))
    return env[name]


def _images(seed, h=H, w=W):
    """Small-gradient images (all three penalty classes) with NaN of two
    payloads, +-inf and -0.0 cells."""
    rng = np.random.RandomState(seed)
    a = (rng.rand(2, h, w) * 0.2).astype(F32)
    a[0, -1, w // 2] = np.inf
    a[0, h // 2, 0] = -np.inf
    a[1, 0, w // 3] = np.nan
    a[1].view(np.uint32)[h - 1, 0] = 0x7fc00123
    a[1, -1, -1] = -0.0
    a[0, 2, 3] = -0.0
    return a[0], a[1]


def _vols(seed, D, dirs, h=H, w=W):
    """(D, h, w) volumes with the slow volumes' NaN masks, scattered NaN
    (two payloads), -0.0, +-inf and 1e9 cells, and runs of ties."""
    rng = np.random.RandomState(seed)
    xs, ds = np.arange(w)[None, None, :], np.arange(D)[:, None, None]
    vols = {}
    for k in dirs:
        v = rng.rand(D, h, w).astype(F32)
        v[np.broadcast_to((xs + ds * k < 0) | (xs + ds * k >= w), v.shape)] \
            = np.nan
        v[rng.rand(D, h, w) < 0.02] = np.nan
        v.view(np.uint32)[rng.rand(D, h, w) < 0.01] = 0x7fc00123
        v[rng.rand(D, h, w) < 0.02] = -0.0
        v[rng.rand(D, h, w) < 0.02] = 0.0
        v[rng.rand(D, h, w) < 0.01] = np.inf
        v[rng.rand(D, h, w) < 0.01] = -np.inf
        v[rng.rand(D, h, w) < 0.02] = 1e9
        v[:, 3, 5] = 0.25  # a column of ties
        v[:, 4, 6] = np.nan  # an all-NaN column
        vols[k] = v
    return vols


def _bits(t):
    return np.ascontiguousarray(np.asarray(t, dtype=F32)).view(np.uint32)


def _same_bits(a, b):
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _same(a, b):
    """Equal values and NaN masks (JAX's jnp.pad NaN and torch.nan are
    both 0x7fc00000; a NaN cell copied keeps its payload in both)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b)) \
        and np.array_equal(np.nan_to_num(a), np.nan_to_num(b))


@pytest.mark.parametrize("D", [13, 40])
@pytest.mark.parametrize("dirs", DIRS)
def test_layouts_match_the_jax_transposes(D, dirs):
    """Both families' d-minor volumes: the real cells bit for bit with the
    JAX package's transposes (its (Hp, Wp) tile padding cut away), the
    lanes [D, Dp) 0x7fc00000, the bits of the JAX package's NaN pad."""
    vols = _vols(D, D, dirs)
    Dp = -(-D // 32) * 32
    n = len(dirs)
    tv = [torch.as_tensor(vols[d]) for d in dirs]
    got_x = sgm.sgm_layout(tv, Dp, vertical=False, rev=False).numpy()
    got_y = sgm.sgm_layout(tv, Dp, vertical=True, rev=-1 in dirs).numpy()
    assert got_x.shape == (W, n * H, Dp) and got_y.shape == (H, n * W, Dp)
    for i, d in enumerate(dirs):
        jv = jnp.asarray(vols[d])
        want_x = np.asarray(jnp.transpose(jv, (2, 1, 0)))  # :1149-1153
        v = jnp.transpose(jv, (1, 2, 0))  # :1185-1190
        want_y = np.asarray(v[:, ::-1, :] if d == -1 else v)
        assert _same_bits(got_x[:, i * H:(i + 1) * H, :D], want_x)
        assert _same_bits(got_y[:, i * W:(i + 1) * W, :D], want_y)
    pad = np.asarray(jnp.pad(jnp.zeros((1,), jnp.float32), (0, 1),
                             constant_values=jnp.nan))[1:]
    assert _bits(pad)[0] == 0x7fc00000
    assert (_bits(got_x[..., D:]) == 0x7fc00000).all()
    assert (_bits(got_y[..., D:]) == 0x7fc00000).all()


def _jax_horizontal_tables(x0, x1, D, dirs):
    """The horizontal family's tables as ``_sgm_slab_horiz`` lays them
    (mccnn_tpu/ops/sgm.py:1156-1166), at its own (Hp, WLp, GL) padding."""
    St = jsgm._pick_st(H)
    Hp = -(-H // St) * St
    Dp = -(-D // 128) * 128
    GL = -(-(W + D + Dp + 128) // 128) * 128
    WLp = -(-W // 128) * 128
    out = {}
    for dx in (1, -1):
        d1 = jsgm._grad_with_sentinel(jnp.asarray(x0), axis=1, step=dx)
        d1p = jnp.pad(d1, ((0, Hp - H), (0, WLp - W)))
        out["d1", dx] = np.asarray(jnp.concatenate([d1p] * len(dirs), 0))
        g0 = jsgm._d2_columns(jnp.asarray(x1), dx, 0, 1, D)
        slabs = [jnp.pad(g0[:, ::-1] if d < 0 else g0,
                         ((0, Hp - H), (0, GL - g0.shape[1])),
                         constant_values=10.0) for d in dirs]
        out["g", dx] = np.asarray(jnp.concatenate(slabs, axis=0))
    return out, Hp


def _jax_vertical_tables(x0, x1, D, dirs):
    """The vertical family's tables as ``_sgm_slab_vert`` lays them
    (:1195-1207), at its own (Wp, HL, GLv) padding."""
    St = jsgm._pick_st(W)
    Wp = -(-W // St) * St
    Dp = -(-D // 128) * 128
    GLv = -(-(D + Wp + Dp + 256) // 128) * 128
    HL = -(-H // 128) * 128
    out = {}
    for dy in (1, -1):
        d1 = jsgm._grad_with_sentinel(jnp.asarray(x0), axis=0, step=dy).T
        out["d1", dy] = np.asarray(jnp.concatenate(
            [jnp.pad(d1[::-1] if d == -1 else d1, ((0, Wp - W), (0, HL - H)))
             for d in dirs], axis=0))  # (n*Wp, HL)
        jx1 = jnp.asarray(x1)
        core = jnp.pad(jnp.abs(jx1 - jnp.roll(jx1, dy, axis=0)),
                       ((0, 0), (D, D)), constant_values=10.0)
        out["nat", dy] = np.asarray(jnp.pad(
            core, ((0, 0), (0, GLv - core.shape[1])), constant_values=10.0))
        out["rev", dy] = np.asarray(jnp.pad(
            core[:, ::-1], ((0, 0), (0, GLv - core.shape[1])),
            constant_values=10.0))
    return out, Wp


@pytest.mark.parametrize("D", [13, 40])
@pytest.mark.parametrize("dirs", DIRS)
def test_horizontal_tables_match_jax(D, dirs):
    """The horizontal D1 (W, n*H) and D2 (n*H, D + W + Dp) tables, bit for
    bit with the JAX package's ``_sgm_slab_horiz`` tables: D1 transposed,
    each direction's D2 rows (the -1 direction's lane-reversed), over the
    port's width (past W + 2D both are 10)."""
    x0, x1 = _images(D)
    tabs = sgm.sgm_generic_tables(torch.as_tensor(x0), torch.as_tensor(x1),
                                  D, dirs, vertical=False)
    want, Hp = _jax_horizontal_tables(x0, x1, D, dirs)
    Dp = -(-D // 32) * 32
    for dx in (1, -1):
        d1 = tabs["h", "d1", dx].numpy()
        g = tabs["h", "g", dx].numpy()
        assert d1.shape == (W, len(dirs) * H)
        assert g.shape == (len(dirs) * H, D + W + Dp)
        for i in range(len(dirs)):
            assert _same_bits(d1[:, i * H:(i + 1) * H],
                              want["d1", dx][i * Hp:i * Hp + H, :W].T)
            assert _same_bits(g[i * H:(i + 1) * H],
                              want["g", dx][i * Hp:i * Hp + H, :g.shape[1]])


@pytest.mark.parametrize("cols", [None, (0, 20), (20, 45), (7, 31)])
@pytest.mark.parametrize("D", [13, 40])
@pytest.mark.parametrize("dirs", DIRS)
def test_vertical_tables_match_jax(D, dirs, cols):
    """The vertical D1 (H, n*w) and D2 ``g`` / ``g_nat`` (H, D + w + Dp)
    tables, whole and on column shards c0:c1, bit for bit with the JAX
    package's ``_sgm_slab_vert`` tables: D1 transposed and the -1
    direction's columns reversed, ``g`` the reversed core from column
    W - c1, ``g_nat`` the natural one from c0."""
    x0, x1 = _images(D + 1)
    tabs = sgm.sgm_generic_tables(torch.as_tensor(x0), torch.as_tensor(x1),
                                  D, dirs, horizontal=False, cols=cols)
    want, Wp = _jax_vertical_tables(x0, x1, D, dirs)
    c0, c1 = (0, W) if cols is None else cols
    w = c1 - c0
    gv = D + w + -(-D // 32) * 32
    for dy in (1, -1):
        d1 = tabs["v", "d1", dy].numpy()
        assert d1.shape == (H, len(dirs) * w)
        for i, d in enumerate(dirs):
            whole = want["d1", dy][i * Wp:i * Wp + W, :H]  # stored order
            part = whole[W - c1:W - c0] if d == -1 else whole[c0:c1]
            assert _same_bits(d1[:, i * w:(i + 1) * w], part.T)
        assert _same_bits(tabs["v", "g", dy].numpy(),
                          want["rev", dy][:, W - c1:W - c1 + gv])
        assert _same_bits(tabs["v", "g_nat", dy].numpy(),
                          want["nat", dy][:, c0:c0 + gv])


@pytest.mark.parametrize("D", [13, 40])
@pytest.mark.parametrize("dirs", [(-1, 1), (-1,)])
def test_stages_sgm_quarter_matches_jax(D, dirs):
    """``Stages.sgm`` (slab form: the families' sum with the quarter, as
    ``sgm_combine_plain``) against the JAX package's ``_sgm_multi(...,
    use_pallas=False)`` / 4: the same f32 operations in the same order,
    sums a + b in either order: rtol 1e-5, as
    tests/test_torch_sgm_generic.py holds the sum."""
    x0, x1 = _images(2 * D)
    vols = _vols(3 * D, D, dirs)
    for v in vols.values():  # the sweeps' min needs no inf in the costs
        v[np.isinf(v)] = 1e9
    want = jsgm._sgm_multi(jnp.asarray(x0), jnp.asarray(x1),
                           {k: jnp.asarray(v) for k, v in vols.items()},
                           use_pallas=False, **KW)
    got = pipeline.ONE_DEVICE.sgm(torch.as_tensor(x0), torch.as_tensor(x1),
                                  {k: torch.as_tensor(v)
                                   for k, v in vols.items()}, "slab", **KW)
    for d in dirs:
        g, w = got[d].numpy(), np.asarray(want[d]) / F32(4)
        assert g.shape == w.shape == (D, H, W) and got[d].is_contiguous()
        assert np.array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)


@pytest.mark.parametrize("D", [13, 40])
@pytest.mark.parametrize("dirs", DIRS)
def test_sgm_multi_quarter_is_the_sum_quartered(D, dirs):
    """``sgm_multi(..., quarter=True)`` is the default sum divided by 4
    bit for bit in the slab and the scan forms (a quarter is exact), and
    the slab form's combine is ``torch.add`` of the families' views."""
    x0, x1 = (torch.as_tensor(a) for a in _images(D + 7))
    vols = {k: torch.as_tensor(v) for k, v in _vols(D + 8, D, dirs).items()}
    for form in ("slab", "stream"):
        total = sgm.sgm_multi(x0, x1, vols, form=form, **KW)
        quarter = sgm.sgm_multi(x0, x1, vols, form=form, quarter=True, **KW)
        for d in dirs:
            assert _same_bits(quarter[d].numpy(), (total[d] / 4.0).numpy())
    kw = dict(pi1=KW["pi1"], pi2=KW["pi2"], tau_so=KW["tau_so"],
              q1=KW["sgm_q1"], q2=KW["sgm_q2"])
    h = sgm.sgm_slab_horiz(x0, x1, vols, dirs, D, H, W, **kw)
    v = sgm.sgm_slab_vert(x0, x1, vols, dirs, D, H, W, alpha1=KW["alpha1"],
                          **kw)
    for d in dirs:
        assert _same_bits(total[d].numpy(), (h[d] + v[d]).numpy())


@pytest.mark.parametrize("D", [1, 13, 40])
def test_wta_matches_jax(D):
    """``costs.wta`` against the JAX package's: NaN never wins, ties
    (runs of equal values, -0.0 beside +0.0, +inf beside +inf, all-NaN
    columns) to the lowest disparity; identical maps."""
    vol = _vols(D + 11, D, (1,))[1]
    vol[:, 0, :] = np.nan
    vol[:, 1, 2] = np.inf
    vol[:, 2, 2] = -0.0
    vol[D // 2:, 2, 2] = 0.0
    got = costs.wta(torch.as_tensor(vol)).numpy()
    want = np.asarray(jcosts.wta(jnp.asarray(vol)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# --- the kernels' plans in numpy ------------------------------------------

def _kernel_tables(x0, x1, D, dirs, **kw):
    """generic_tables_kernel's buffer: each element by its part's kind,
    decoded as the kernel decodes it (value<KIND> in sgm_layout.cu), 0 in
    the gaps."""
    Hh, Wd = x0.shape
    c0, c1 = kw.get("cols") or (0, Wd)
    w, n, rev0 = c1 - c0, len(dirs), -1 in dirs
    core = Wd + 2 * D
    parts, total = sgm.generic_table_layout(Hh, Wd, D, n, **kw)
    buf = np.zeros(total, F32)
    with np.errstate(invalid="ignore"):
        for (fam, tab, step), rows, ncols, off in parts:
            kind = sgm.TABLE_KINDS[fam, tab]
            r = np.arange(rows)[:, None]
            j = np.arange(ncols)[None, :]
            if kind == 0:
                y = np.where(j >= Hh, j - Hh, j)
                val = np.abs(x0[y, r] - x0[y, np.clip(r - step, 0, Wd - 1)])
            elif kind == 1:
                i = (r >= Hh).astype(int)
                y = r - i * Hh
                k = np.where((i == 0) & rev0, core - 1 - j, j)
                x = k - D
                xb = x - step
                ok = (j < core) & (x >= 0) & (x < Wd) & (xb >= 0) & (xb < Wd)
                val = np.where(ok, np.abs(x1[y, np.clip(x, 0, Wd - 1)]
                                          - x1[y, np.clip(xb, 0, Wd - 1)]),
                               F32(10))
            elif kind == 2:
                i = (j >= w).astype(int)
                xt = j - i * w
                x = np.where((i == 0) & rev0, c1 - 1 - xt, c0 + xt)
                yb = np.clip(r - step, 0, Hh - 1)
                val = np.abs(x0[r, x] - x0[yb, x])
            else:
                k = Wd - c1 + j if kind == 3 else c0 + j
                kk = core - 1 - k if kind == 3 else k
                x = kk - D
                ok = (k < core) & (x >= 0) & (x < Wd)
                yb = (r - step) % Hh
                xc = np.clip(x, 0, Wd - 1)
                val = np.where(ok, np.abs(x1[r, xc] - x1[yb, xc]), F32(10))
            buf[off:off + rows * ncols] = np.broadcast_to(
                val, (rows, ncols)).astype(F32).ravel()
    return buf


@pytest.mark.parametrize("kw", [dict(), dict(vertical=False),
                                dict(horizontal=False),
                                dict(horizontal=False, cols=(7, 31)),
                                dict(cols=(20, 45))])
@pytest.mark.parametrize("D", [13, 40])
@pytest.mark.parametrize("dirs", DIRS)
def test_table_kernel_decode_is_the_plain_buffer(D, dirs, kw):
    """The tables kernel's per-element decode of every part, mirrored in
    numpy, gives the plain version's whole buffer bit for bit: the parts
    at their 16-byte starts, the gaps 0, NaN (one payload) and +-inf in
    the images."""
    x0, x1 = _images(D + 2)
    want = sgm.sgm_generic_tables_plain(torch.as_tensor(x0),
                                        torch.as_tensor(x1), D, dirs, **kw)
    parts, total = sgm.generic_table_layout(H, W, D, len(dirs), **kw)
    buf = next(iter(want.values()))
    flat = torch.as_strided(buf, (total,), (1,), 0).numpy()
    got = _kernel_tables(x0, x1, D, dirs, **kw)
    assert [p[3] % 4 for p in parts] == [0] * len(parts)
    # the plain version's NaN is x86's (the payload kept), the kernel's
    # the card's: compare values and NaN masks here, bits on the card
    assert _same(got, flat)


def _tile_plan(w, Dp):
    """How often the layout and combine kernels' blocks write each (x,
    lane) of a row: a block TX columns x TD lanes, blockIdx.x the column
    tile, blockIdx.y the lane tile."""
    TX, TD = _const("TX"), _const("TD")
    seen = collections.Counter()
    for bx in range(-(-w // TX)):
        for by in range(Dp // TD):
            for c in range(TX):
                for r in range(TD):
                    if bx * TX + c < w:
                        seen[bx * TX + c, by * TD + r] += 1
    return seen


@pytest.mark.parametrize("w,D", [(45, 13), (300, 40), (128, 64), (1, 1)])
def test_layout_and_combine_tiles_cover_every_cell_once(w, D):
    """The layout kernel's grid (columns / TX, Dp / TD, n*H) writes each
    (x, lane) of each row once, the pad lanes included; the combine
    kernel's (D / TD tiles) each real (x, d) once; their tiles fit one
    row's 32 disparities in one 128-byte line (TD = 32 floats) and a
    block's threads cover a tile (NT / 8 columns a pass, 8 16-byte groups
    a column)."""
    Dp = -(-D // 32) * 32
    TX, TD, NT = _const("TX"), _const("TD"), _const("NT")
    assert TD * 4 == 128 and NT % 8 == 0 and TX % (NT // 8) == 0
    assert _const("LDT") % 2 == 1
    seen = _tile_plan(w, Dp)
    assert len(seen) == w * Dp and set(seen.values()) == {1}
    real = {k: v for k, v in seen.items() if k[1] < D}
    assert len(real) == w * D


def _split_wta(vol, ww, wb):
    """wta_dhw_kernel on a (D, H, W) volume: ww warps a block, each a
    contiguous share of ceil(D / ww) disparities, walked in batches of wb
    with a strict < from (+inf, the share's first index), NaN skipped;
    the shares merged in d order with a strict <."""
    D = vol.shape[0]
    per = -(-D // ww)
    best, idx = None, None
    for k in range(ww):
        lo = min(D, k * per)
        hi = min(D, lo + per)
        b = np.full(vol.shape[1:], np.inf, F32)
        i = np.full(vol.shape[1:], lo, np.int64)
        for d in range(lo, hi):  # batches of wb change no order
            c = vol[d]
            take = ~np.isnan(c) & (c < b)
            b = np.where(take, c, b)
            i = np.where(take, d, i)
        if best is None:
            best, idx = b, i
        else:
            take = b < best
            best = np.where(take, b, best)
            idx = np.where(take, i, idx)
    assert wb >= 1
    return idx.astype(F32)


@pytest.mark.parametrize("D", [1, 7, 8, 9, 13, 40, 228])
def test_wta_warp_split_is_the_plain_argmin(D):
    """The winner-take-all kernel's split of D over the WW warps of a
    block and its strict-< merge give ``wta_plain``'s map: ties across a
    share boundary, all-NaN columns and shares past D (D < WW)."""
    vol = _vols(D + 5, D, (1,), h=6, w=33)[1]
    per = -(-D // _const("WW"))
    if D > per:  # a tie across the first share boundary
        vol[:, 1, 1] = 5.0
        vol[per - 1, 1, 1] = vol[per, 1, 1] = 0.5
    got = _split_wta(vol, _const("WW"), _const("WB"))
    want = costs.wta_plain(torch.as_tensor(vol)).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    x0, x1 = (torch.as_tensor(a) for a in _images(4))
    vols = {k: torch.as_tensor(v) for k, v in _vols(5, 13, (-1, 1)).items()}
    _build.reset_launches()
    tv = [vols[-1], vols[1]]
    assert torch.equal(sgm.sgm_layout(tv, 32, vertical=True, rev=True)
                       .isnan(), sgm.sgm_layout_plain(tv, 32, vertical=True,
                                                      rev=True).isnan())
    got = sgm.sgm_generic_tables(x0, x1, 13, (-1, 1))
    want = sgm.sgm_generic_tables_plain(x0, x1, 13, (-1, 1))
    assert all(torch.equal(got[k].nan_to_num(), want[k].nan_to_num())
               for k in want)
    assert torch.equal(costs.wta(vols[1]), costs.wta_plain(vols[1]))
    acc_h = sgm.sgm_layout(tv, 32, vertical=False, rev=False)
    acc_v = sgm.sgm_layout(tv, 32, vertical=True, rev=True)
    got = sgm.sgm_combine(acc_h, acc_v, (-1, 1), 13, quarter=True)
    want = sgm.sgm_combine_plain(acc_h, acc_v, (-1, 1), 13, quarter=True)
    assert all(torch.equal(got[d].nan_to_num(), want[d].nan_to_num())
               for d in (-1, 1))
    assert sum(_build.launches().values()) == 0


def test_the_layout_kernels_are_registered_and_exported():
    """``sgm_layout.cu`` is built with the other sources, its four entries
    are counted kernels, and each wrapper's C entry is in the source."""
    assert "sgm_layout" in _build.SOURCES
    assert _build._source("sgm_layout").exists()
    entries = ("sgm_layout", "sgm_generic_tables", "sgm_combine", "wta_dhw")
    assert set(entries) <= set(_build.KERNELS)
    for entry in entries:
        assert f'extern "C" int {entry}_launch(' in SRC
    assert len(sgm.TABLE_KINDS) == 5 and _const("MAX_PARTS") >= 10
