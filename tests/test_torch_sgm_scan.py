"""The port's scan-form SGM (plain versions, on the CPU) against the JAX
package: ``sweep_scan_plain`` against the ``lax.scan`` sweep ``_sweep``,
against ``_sweep_grid`` (which interprets itself off the chip) and
against ``_sweep_stream`` in interpret mode; the wrappers' reverse
sweeps against both on reversed steps; ``sgm_multi`` in the scan
forms against ``sgm_pair`` under ``MCCNN_SGM_HSLAB=0`` and against the
port's slab form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mccnn_tpu.ops import sgm as jsgm
from mccnn_tpu_torch.ops import sgm

PEN = dict(pi1=1.32, pi2=24.25, tau_so=0.08, alpha1=2.0, q1=3.0, q2=2.0)
KW = dict(pi1=1.32, pi2=24.25, tau_so=0.08, alpha1=2.0, sgm_q1=3.0,
          sgm_q2=2.0)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _slices(seed, T=9, S=6, D=13):
    """Pre-built (T, S, D) slices: NaN runs at the top disparities, as
    out-of-frame cells give, scattered NaN cells, an all-NaN row, and
    D1/D2 on both sides of tau so that all three penalty classes occur."""
    rng = np.random.RandomState(seed)
    vol = rng.rand(T, S, D).astype(np.float32)
    vol[rng.rand(T, S, D) < 0.03] = np.nan
    vol[:, : S // 2, D - D // 3:] = np.nan
    vol[T // 2, 1, :] = np.nan
    d1 = (rng.rand(T, S) * 0.16).astype(np.float32)
    d2 = (rng.rand(T, S, D) * 0.16).astype(np.float32)
    d2[rng.rand(T, S, D) < 0.05] = 10.0
    return vol, d1, d2


def _plain(vol, d1, d2, sgm_dir):
    pen = sgm.pen_table(PEN["pi1"], PEN["pi2"], PEN["q1"], PEN["q2"],
                        PEN["alpha1"] if sgm_dir == 2 else 1.0,
                        PEN["alpha1"] if sgm_dir == 3 else 1.0)
    return sgm.sweep_scan_plain(torch.as_tensor(vol), torch.as_tensor(d1),
                                torch.as_tensor(d2), tau=PEN["tau_so"],
                                pen=pen).numpy()


def _jax(sweep, vol, d1, d2, sgm_dir):
    return np.asarray(sweep(jnp.asarray(vol), jnp.asarray(d1), jnp.asarray(d2),
                            PEN["pi1"], PEN["pi2"], PEN["tau_so"],
                            PEN["alpha1"], PEN["q1"], PEN["q2"], sgm_dir))


def _same(got, want):
    """The same f32 operations in the same order: max |d| <= 1e-5 (the
    compilers may differ in the last bit), NaN masks equal."""
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() and not np.isnan(got).all()
    assert np.nanmax(np.abs(got - want)) <= 1e-5


@pytest.mark.parametrize("D", [13, 32])
@pytest.mark.parametrize("sgm_dir", [0, 1, 2, 3])
def test_sweep_scan_plain_matches_jax_scan(sgm_dir, D):
    vol, d1, d2 = _slices(sgm_dir + D, D=D)
    _same(_plain(vol, d1, d2, sgm_dir), _jax(jsgm._sweep, vol, d1, d2, sgm_dir))


@pytest.mark.parametrize("D", [13, 128])
@pytest.mark.parametrize("sgm_dir", [0, 1, 2, 3])
def test_sweep_scan_plain_matches_jax_sweep_grid(sgm_dir, D):
    """D = 128 fills the TPU kernel's lanes, so it masks the d-edge
    wraps of its rolls instead of relying on NaN pad lanes."""
    vol, d1, d2 = _slices(10 + sgm_dir + D, T=5, S=4, D=D)
    _same(_plain(vol, d1, d2, sgm_dir),
          _jax(jsgm._sweep_grid, vol, d1, d2, sgm_dir))


@pytest.mark.parametrize("D", [13, 32])
@pytest.mark.parametrize("sgm_dir", [0, 1, 2, 3])
def test_sweep_scan_plain_matches_jax_sweep_stream(interpret, sgm_dir, D):
    vol, d1, d2 = _slices(20 + sgm_dir + D, T=5, S=4, D=D)
    _same(_plain(vol, d1, d2, sgm_dir),
          _jax(jsgm._sweep_stream, vol, d1, d2, sgm_dir))


@pytest.mark.parametrize("port", ["sweep_stream", "sweep_grid"])
@pytest.mark.parametrize("jax_sweep", ["_sweep_grid", "_sweep_stream"])
@pytest.mark.parametrize("D", [32, 70, 228])
@pytest.mark.parametrize("sgm_dir", [0, 1, 2, 3])
def test_reverse_sweep_matches_jax_on_reversed_steps(interpret, sgm_dir, D,
                                                     jax_sweep, port):
    """``sweep_stream`` / ``sweep_grid`` with ``reverse=True`` on CPU
    tensors in natural step order against the JAX package's
    ``_sweep_grid`` and ``_sweep_stream`` (interpret mode) on the inputs
    reversed in steps, their result reversed back: the JAX scan form's
    backward sweep. D at a multiple of 32, off a multiple of 4, and
    KITTI's 228."""
    vol, d1, d2 = _slices(30 + sgm_dir + D, T=5, S=4, D=D)
    pen = sgm.pen_table(PEN["pi1"], PEN["pi2"], PEN["q1"], PEN["q2"],
                        PEN["alpha1"] if sgm_dir == 2 else 1.0,
                        PEN["alpha1"] if sgm_dir == 3 else 1.0)
    got = getattr(sgm, port)(torch.as_tensor(vol), torch.as_tensor(d1),
                             torch.as_tensor(d2), tau=PEN["tau_so"], pen=pen,
                             reverse=True).numpy()
    want = _jax(getattr(jsgm, jax_sweep), vol[::-1], d1[::-1], d2[::-1],
                sgm_dir)[::-1]
    _same(got, want)


def _case(seed, D=13, H=11, W=37):
    rng = np.random.RandomState(seed)
    x0 = (rng.rand(H, W) * 0.2).astype(np.float32)
    x1 = (rng.rand(H, W) * 0.2).astype(np.float32)
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    vols = {}
    for direction in (-1, 1):
        v = rng.rand(D, H, W).astype(np.float32)
        oof = (xs + ds * direction < 0) | (xs + ds * direction >= W)
        v[np.broadcast_to(oof, v.shape)] = np.nan
        v[rng.rand(D, H, W) < 0.02] = np.nan
        vols[direction] = v
    return x0, x1, vols


@pytest.mark.parametrize("form", ["stream", "grid"])
def test_scan_forms_match_jax_scan_form_and_equal_the_slab_form(monkeypatch,
                                                                form):
    """``sgm_multi`` in a scan form against the JAX package's scan form
    on its Pallas sweep (``sgm_pair(use_pallas=True)`` under
    ``MCCNN_SGM_HSLAB=0``; off the chip that is ``_sweep_grid``,
    interpreted): rtol 1e-5. Against the port's slab form: the same two
    sweep results per family, added in either order, so equal."""
    x0, x1, vols = _case(5)
    monkeypatch.setenv("MCCNN_SGM_HSLAB", "0")
    want = jsgm.sgm_pair(jnp.asarray(x0), jnp.asarray(x1),
                         jnp.asarray(vols[-1]), jnp.asarray(vols[1]),
                         use_pallas=True, **KW)
    tv = {k: torch.as_tensor(v) for k, v in vols.items()}
    got = sgm.sgm_multi(x0, x1, tv, form=form, **KW)
    slab = sgm.sgm_multi(x0, x1, tv, form="slab", **KW)
    for k, w in zip((-1, 1), want):
        g, w = got[k].numpy(), np.asarray(w)
        assert np.array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        np.testing.assert_array_equal(g, slab[k].numpy())


@pytest.mark.parametrize("direction", [-1, 1])
def test_scan_form_one_direction_equals_its_half_of_the_pair(direction):
    x0, x1, vols = _case(7)
    pair = sgm.sgm_pair(x0, x1, torch.as_tensor(vols[-1]),
                        torch.as_tensor(vols[1]), form="stream", **KW)
    alone = sgm.sgm(x0, x1, torch.as_tensor(vols[direction]),
                    direction=direction, form="stream", **KW)
    np.testing.assert_array_equal(alone.numpy(), pair[direction == 1].numpy())


@pytest.mark.parametrize("env,want", [("0", "stream"), ("1", "slab"),
                                      (None, "slab"), ("", "slab")])
def test_form_none_obeys_the_environment(monkeypatch, env, want):
    """``form=None`` reads MCCNN_SGM_HSLAB at call time: "0" selects the
    stream form, anything else the slab form; the grid form only by
    name."""
    if env is None:
        monkeypatch.delenv("MCCNN_SGM_HSLAB", raising=False)
    else:
        monkeypatch.setenv("MCCNN_SGM_HSLAB", env)
    assert sgm.resolve_form(None) == want
    assert sgm.resolve_form("grid") == "grid"
    called = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            called.append(name)
            return fn(*a, **kw)
        return wrapped

    for name in ("sweep_stream", "sweep_grid", "_sweep_hslab"):
        monkeypatch.setattr(sgm, name, spy(name, getattr(sgm, name)))
    x0, x1, vols = _case(9, D=5, H=4, W=12)
    sgm.sgm_multi(x0, x1, {k: torch.as_tensor(v) for k, v in vols.items()},
                  **KW)
    assert set(called) == {"sweep_stream" if want == "stream"
                           else "_sweep_hslab"}


@pytest.mark.parametrize("form", ["scan", "SLAB", 0, ""])
def test_bad_form_raises(form):
    x0, x1, vols = _case(9, D=5, H=4, W=12)
    with pytest.raises(ValueError, match="form must be one of"):
        sgm.sgm_multi(x0, x1, {k: torch.as_tensor(v) for k, v in vols.items()},
                      form=form, **KW)


def test_cpu_sweeps_count_no_launch_and_count_keeps_both_numbers():
    """A wrapper on CPU tensors runs the plain version and counts
    nothing, in either direction; ``_build.count`` records one entry call
    and the kernel launches that call made (one for the scan entries;
    a join of more than 64 channels makes one a slab)."""
    from mccnn_tpu_torch.ops import _build
    _build.reset_launches()
    vol, d1, d2 = _slices(1, 8, 5)
    for sweep in (sgm.sweep_stream, sgm.sweep_grid):
        for reverse in (False, True):
            sweep(torch.as_tensor(vol), torch.as_tensor(d1),
                  torch.as_tensor(d2), tau=0.08, reverse=reverse,
                  pen=sgm.pen_table(1.0, 3.0, 2.0, 4.0, 1.0, 1.0))
    assert not any(_build.launches().values())
    assert not any(_build.kernel_launches().values())
    _build.count("join", 2)
    _build.count("sgm_step")
    assert _build.launches()["join"] == _build.launches()["sgm_step"] == 1
    assert _build.kernel_launches()["join"] == 2
    assert _build.kernel_launches()["sgm_step"] == 1
    _build.reset_launches()
    assert not any(_build.kernel_launches().values())


@pytest.mark.parametrize("name", ["d2-loads", "no-store"])
def test_sweep_variants_apply_to_the_shipped_source(name):
    """Each text edit of ``python -m mccnn_tpu_torch.sweep_variants``
    finds its text in ``csrc/sgm_sweep.cu`` as often as it expects, so
    the timing script still builds its variants after the source
    changes (its kernels run only on the card)."""
    from mccnn_tpu_torch import sweep_variants

    src = sweep_variants.variant_source(name)
    assert src != (sweep_variants._build.CSRC / "sgm_sweep.cu").read_text()
