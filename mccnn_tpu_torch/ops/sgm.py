"""Semiglobal matching: the reference's production kernel ``sgm2``
(adcensus.cu:535-697) in the JAX package's two lanes.

- HWD lane, on the padded disparity-minor (Hp, Wp, Dp) join volume
  (``sgm._sgm_slab_hwd``, mccnn_tpu/ops/sgm.py:1237-1331):
  :func:`sgm_slab_hwd`. Per reference direction two vertical sweeps
  (down, up), then two horizontal sweeps (right, left), chained through
  one accumulator; the sum is NOT divided by 4; the winner-take-all map
  of the sum comes out of the last sweep. The volume, the accumulator and
  the sweeps' outputs are stored as float32, bfloat16 or float16 (the
  volume's dtype, ``-vol_dtype``); the recurrence and the winner map are
  float32 and only the stored sums round (sgm.py:640-690, :878-891).
- Generic lane, on (D, H, W) volumes (``sgm._sgm_multi``,
  sgm.py:1334-1441): :func:`sgm_multi`, :func:`sgm`, :func:`sgm_pair`,
  whatever made the volumes (the slow head, census, ad, the fast join).
  Both reference directions are stacked on the scanline axis of each
  family's volume; the family sums are added (h + v) and the caller
  divides by 4. Two forms, chosen by ``form`` (see
  :func:`resolve_form`), give the same sums:

  - the slab form (``_sgm_slab``, sgm.py:1135-1234): the horizontal
    family on a step-major (W, n*H, Dp) volume
    (:func:`sgm_slab_horiz`), the vertical one on an (H, n*W, Dp) volume
    with the -1 direction x-reversed (:func:`sgm_slab_vert`); D2 is read
    as windows of small per-row tables and the two sweeps of a family
    sum in place;
  - the scan form (``_sgm_scan_horiz`` / ``_sgm_scan_vert``,
    sgm.py:1365-1422): each sweep runs over pre-built (T, S, D) slices
    of the volume, a (T, S) D1 table and a built (T, S, D) D2 table, in
    sweep order, and returns the (T, S, D) per-step values
    (:func:`sgm_scan_horiz`, :func:`sgm_scan_vert`); the sweep is
    :func:`sweep_stream` or :func:`sweep_grid`, the counterparts of the
    JAX package's whole-sweep and grid-over-steps kernels, which run one
    kernel here. A reverse sweep reads and writes its steps in place. It
    is the form the row-sharded inference of the JAX package is built
    on.

Penalties (adcensus.cu:586-613): D1 = |x0[p] - x0[p - step]|,
D2 = |x1[q] - x1[q - step]| at the match pixel q (10 where q or
q - step leaves the frame); both below tau_so -> (pi1, pi2), both above
-> divided by q1*q2, else by q1; the vertical sweeps divide the d-1
(down) or d+1 (up) neighbour penalty by alpha1.

On CUDA tensors each sweep launches ``csrc/sgm_sweep.cu`` (entries
``sgm_vertical``, ``sgm_horizontal``, ``sgm_hslab``, ``sgm_scan`` and
``sgm_step``); on CPU tensors it runs the step loops
:func:`sweep_plain`, :func:`hslab_plain` and :func:`sweep_scan_plain`.
The three slab entries run one warp per scanline, the volume and
accumulator rows prefetched through a ring of shared-memory buffers by
bulk asynchronous copies: ``sgm_horizontal`` per scanline in chunks of
``HCHUNK`` steps (:func:`horizontal_chunks` is its walk over the
steps); ``sgm_vertical`` and ``sgm_hslab`` per block of ``VWARPS``
adjacent scanlines in chunks of ``VCHUNK`` steps (:func:`vertical_plan`
is their blocks and ring). The scan form's ``sgm_scan`` and ``sgm_step``
run the same kernel as those two, its D2 table streamed through the
ring where their accumulator goes; the instances differ only in where a
scanline reads D2.

The HWD lane's D1/D2 tables of one direction's four sweeps are one
buffer (:func:`table_layout`), written by one launch of
``csrc/sgm_tables.cu`` (entry ``sgm_tables``) on CUDA images and by
:func:`sgm_tables_plain` on CPU ones, the same bits. The generic lane's
data movement is ``csrc/sgm_layout.cu`` on CUDA tensors and its plain
versions on CPU ones, the same bits: each family's d-minor volume
(:func:`sgm_layout`), both families' tables in one buffer
(:func:`sgm_generic_tables`) and, in the slab form, the family sum with
the quarter (:func:`sgm_combine`); the scan form's plans stay plain torch.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from mccnn_tpu_torch.ops import _build


def pen_table(pi1, pi2, q1, q2, p1a_div, p1b_div) -> tuple[float, ...]:
    """(P1a, P1b, P2) for penalty classes 0 (both gradients below
    tau_so), 1 (mixed) and 2 (both above), flattened. Each value is the
    float32 division the JAX kernels fold into their constants
    (sgm.py:77-95): f32(f32(base) / f32(div))."""
    def f(base, div):
        return float(np.float32(np.float32(base) / np.float32(div)))

    out = []
    for scale in (1.0, q1, q1 * q2):  # classes 0, 1, 2
        out += [f(pi1 / scale, p1a_div), f(pi1 / scale, p1b_div),
                f(pi2 / scale, 1.0)]
    return tuple(out)


def grad_with_sentinel(img: torch.Tensor, axis: int, step: int,
                       sentinel=None) -> torch.Tensor:
    """out[i] = |img[i] - img[i-step]| along ``axis``; where i-step
    leaves the frame the index is clamped (giving 0), or ``sentinel``
    when given."""
    n = img.shape[axis]
    idx = torch.arange(n, device=img.device) - step
    valid = (idx >= 0) & (idx < n)
    g = (img - torch.index_select(img, axis, idx.clamp(0, n - 1))).abs()
    if sentinel is not None:
        shape = [1, 1]
        shape[axis] = n
        g = torch.where(valid.reshape(shape), g, sentinel)
    return g


def d2_columns(x1: torch.Tensor, dx: int, dy: int, D: int) -> torch.Tensor:
    """D2 lookup rows: |x1[y,x] - x1[y-dy,x-dx]|, 10 where x or x-dx
    leaves the frame, padded by D columns of 10 on both sides so that
    lookups at x + d*direction + D stay in range (adcensus.cu:588-594)."""
    W = x1.shape[1]
    g = (x1 - torch.roll(x1, (dy, dx), (0, 1))).abs()
    xs = torch.arange(W, device=x1.device)
    ok = (xs - dx >= 0) & (xs - dx < W)
    g = torch.where(ok[None, :], g, 10.0)
    return torch.nn.functional.pad(g, (D, D), value=10.0)


def _tables(d1: torch.Tensor, core: torch.Tensor, xrev: bool, Hp: int,
            Wp: int, gw: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (Hp, Wp) D1 table and (Hp, gw) D2 table, indexed
    d1[y, x] and g[y, D + x + d] in the volume's storage order:
    x-reversed storage flips D1 and lane-reverses the D2 rows
    (g_nat[x - d + D] == rev(g_nat)[x' + d + D] at x' = W-1-x)."""
    H, W = d1.shape
    if xrev:
        d1 = d1.flip(1)
        core = core.flip(1)
    d1 = torch.nn.functional.pad(d1, (0, Wp - W, 0, Hp - H))
    g = torch.nn.functional.pad(core, (0, gw - core.shape[1], 0, Hp - H),
                                value=10.0)
    return d1.contiguous(), g.contiguous()


def _recurrence(vol, acc, out, wta, d1, d2_of, step_view, n_steps, *,
                reverse, T, tau, pen):
    """The step loop of every plain sweep: ``step_view(t, s)`` is the
    (scanlines, ...) slice of step s of a buffer, ``d2_of(s)`` the
    (scanlines, Dp) D2 block of step s. ``vol``, ``acc`` and ``out`` may
    be stored in a 16-bit dtype: their rows are widened to float32, the
    state stays float32, and the float32 sum rounds only where it is
    stored; the winner map is taken from the float32 sum."""
    dev = vol.device
    tau = torch.tensor(tau, dtype=torch.float32, device=dev)
    pens = torch.tensor(pen, dtype=torch.float32, device=dev).reshape(3, 3)
    inf = torch.full((1,), torch.inf, dtype=torch.float32, device=dev)
    init = T - 1 if reverse else 0
    prev = None
    for s in (range(n_steps - 1, -1, -1) if reverse else range(n_steps)):
        v = step_view(vol, s).float()
        if s >= T:
            outv = v
        elif s == init:
            prev = outv = v
        else:
            D1 = step_view(d1, s)[:, None]
            D2 = d2_of(s)
            cls = torch.where((D1 < tau) & (D2 < tau), 0,
                              torch.where((D1 > tau) & (D2 > tau), 2, 1))
            P1a, P1b, P2 = pens[cls].unbind(-1)
            pm = torch.where(torch.isnan(prev), torch.inf, prev).amin(
                -1, keepdim=True)
            S = prev.shape[0]
            up = torch.cat([inf.expand(S, 1), prev[:, :-1]], 1)
            dn = torch.cat([prev[:, 1:], inf.expand(S, 1)], 1)
            cost = torch.fmin(prev, pm + P2)
            cost = torch.fmin(cost, up + P1a)
            cost = torch.fmin(cost, dn + P1b)
            prev = outv = v + cost - pm
        fin = outv + step_view(acc, s).float() if acc is not None else outv
        if out is not None:
            step_view(out, s).copy_(fin)
        if wta is not None:
            clean = torch.where(torch.isnan(fin), torch.inf, fin)
            step_view(wta, s).copy_(clean.argmin(-1).to(torch.float32))


def sweep_plain(vol, acc, out, wta, d1, g, *, vertical, reverse, T, D, tau,
                pen, g_nat=None, n_rev=0):
    """One sweep over an (Hp, Ws, Dp) volume as a step loop of torch ops,
    with the kernel's contract (see ``csrc/sgm_sweep.cu``). ``out`` may
    be ``acc`` (in place) or None; ``wta`` None or an (Hp, Ws) buffer to
    fill. Vertical sweeps read D2 of columns x < n_rev from ``g`` at
    D + x, of the others from ``g_nat`` (default ``g``) at
    D + x - n_rev; horizontal ones from ``g`` at D + x."""
    Hp, Ws, Dp = vol.shape
    if vertical:
        g_nat = g if g_nat is None else g_nat

        def d2_of(s):
            return torch.cat([g[s].unfold(0, Dp, 1)[D:D + n_rev],
                              g_nat[s].unfold(0, Dp, 1)[D:D + Ws - n_rev]])

        def step_view(t, s):
            return t[s]
    else:
        def d2_of(s):
            return g[:, D + s:D + s + Dp]

        def step_view(t, s):
            return t[:, s]
    _recurrence(vol, acc, out, wta, d1, d2_of, step_view,
                Hp if vertical else Ws, reverse=reverse, T=T, tau=tau,
                pen=pen)


def hslab_plain(vol, acc, out, d1, g, *, reverse, D, n_rev, rev_base, tau,
                pen, T=None):
    """One horizontal sweep over a step-major (W, S, Dp) volume as a step
    loop of torch ops: D2 of scanline s at step x is g[s, D + x + d], or
    g[s, rev_base - x + d] for s < n_rev; d1 is (W, S). The first T
    steps are real (default all W); the others pass the volume through,
    as in :func:`sweep_plain`."""
    W, _, Dp = vol.shape

    def d2_of(x):
        return torch.cat([g[:n_rev, rev_base - x:rev_base - x + Dp],
                          g[n_rev:, D + x:D + x + Dp]])

    _recurrence(vol, acc, out, None, d1, d2_of, lambda t, s: t[s], W,
                reverse=reverse, T=W if T is None else T, tau=tau, pen=pen)


def sweep_scan_plain(vol_s, d1_s, d2_s, *, tau, pen):
    """One generic directional sweep as a step loop of torch ops
    (``_sweep``, sgm.py:104-129): vol_s (T, S, D) volume slices in sweep
    order (T steps, S scanlines), d1_s (T, S) and d2_s (T, S, D) the
    per-step D1 and D2. Step 0 starts the recurrence. Returns the
    (T, S, D) per-step values in sweep order."""
    out = torch.empty_like(vol_s)
    _recurrence(vol_s, None, out, None, d1_s, lambda s: d2_s[s],
                lambda t, s: t[s], vol_s.shape[0], reverse=False,
                T=vol_s.shape[0], tau=tau, pen=pen)
    return out


# steps per chunk of the horizontal sweep kernel's prefetch ring (HK in
# csrc/sgm_sweep.cu)
HCHUNK = 8


def horizontal_chunks(n_steps: int, reverse: bool) -> list[list[int]]:
    """The horizontal sweep kernel's walk over a scanline's stored steps:
    one list per chunk, in the order it visits them. Chunks are blocks
    of ``HCHUNK`` stored steps (the last one ragged), each one contiguous
    run of rows; a reverse sweep takes the blocks, and the steps inside
    one, from the far end."""
    blocks = [list(range(lo, min(lo + HCHUNK, n_steps)))
              for lo in range(0, n_steps, HCHUNK)]
    return [b[::-1] for b in blocks[::-1]] if reverse else blocks


# the step-major sweep kernel's blocks and ring (VW, VK, VSTAGES, SM_SMEM and
# BLOCK_RESERVED in csrc/sgm_sweep.cu), for sgm_vertical and sgm_hslab
VWARPS = 4
VCHUNK = 2
VSTAGES = 8
SM_SMEM = 233472
BLOCK_RESERVED = 1024
H100_SMS = 132


def vertical_plan(Ws: int, n_rev: int, Dp: int, has_acc: bool,
                  n_sm: int = H100_SMS, elem: int = 4) -> dict:
    """The step-major sweep kernel's launch, as its C entries plan it
    (``vertical_plan`` in csrc/sgm_sweep.cu; a CUDA test holds this
    mirror against the C entry ``sgm_vertical_plan``) for ``Ws``
    scanlines: the vertical entry's columns, or the S scanlines of the
    hslab entry and of the scan form; ``has_acc``: the ring carries a
    second input, the accumulator or the scan form's D2 table (always).
    ``blocks``, one (x0, n)
    run of at most ``VWARPS`` adjacent scanlines each, the reversed class
    [0, n_rev) planned apart from the natural one so that no block reads
    two D2 tables; ``per_sm``, the blocks an SM must hold for all of them
    to run in one wave; ``stages``, the chunks of ``VCHUNK`` steps in a
    block's ring, as many as an equal share of the SM's shared memory
    holds (two at least, ``VSTAGES`` at most) for values of ``elem``
    bytes; ``smem``, a block's dynamic shared memory in bytes (the ring
    and two mbarriers a stage)."""
    def runs(lo, hi):
        return [(x, min(VWARPS, hi - x)) for x in range(lo, hi, VWARPS)]

    blocks = runs(0, n_rev) + runs(n_rev, Ws)
    per_sm = -(-len(blocks) // n_sm)
    budget = SM_SMEM // per_sm - BLOCK_RESERVED
    bars = 2 * VSTAGES * 8
    chunk = VCHUNK * VWARPS * Dp * elem * (2 if has_acc else 1)
    stages = max(2, min(VSTAGES, (budget - bars) // chunk if budget > bars
                        else 0))
    return dict(blocks=blocks, per_sm=per_sm, stages=stages,
                smem=stages * chunk + bars)


class _Pen(ctypes.Structure):
    _fields_ = [("v", ctypes.c_float * 9)]


def _lib():
    lib = _build.library("sgm_sweep")
    if lib.sgm_sweep_vertical.argtypes is None:
        tail = [ctypes.c_float, _Pen, ctypes.c_void_p]
        lib.sgm_sweep_vertical.argtypes = ([ctypes.c_void_p] * 7
                                           + [ctypes.c_int] * 9 + tail)
        lib.sgm_sweep_horizontal.argtypes = ([ctypes.c_void_p] * 6
                                             + [ctypes.c_int] * 8 + tail)
        lib.sgm_sweep_hslab.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 9 + tail)
        for fn in (lib.sgm_sweep_scan, lib.sgm_sweep_step):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + tail
        for fn in (lib.sgm_sweep_vertical, lib.sgm_sweep_horizontal,
                   lib.sgm_sweep_hslab, lib.sgm_sweep_scan,
                   lib.sgm_sweep_step):
            fn.restype = ctypes.c_int
    return lib


# the dtype code of sgm_sweep_vertical / sgm_sweep_horizontal for each
# storage dtype of the volume (BY_STORAGE in csrc/sgm_sweep.cu)
STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(named, what):
    for name, t in named:
        if t is not None:
            _build.check_cuda_f32(t, f"{what} {name}")


def _sweep(vol, acc, out, wta, d1, g, *, vertical, reverse, T, D, tau, pen,
           g_nat=None, n_rev=0):
    """One sweep over an (Hp, Ws, Dp) volume: the kernel on CUDA
    tensors, :func:`sweep_plain` on CPU tensors. ``vol``, ``acc`` and
    ``out`` share one storage dtype (float32, bfloat16 or float16); the
    tables and the winner map are float32."""
    kw = dict(vertical=vertical, reverse=reverse, T=T, D=D, tau=tau, pen=pen,
              g_nat=g_nat, n_rev=n_rev)
    if not vol.is_cuda:
        return sweep_plain(vol, acc, out, wta, d1, g, **kw)
    g_nat = g if g_nat is None else g_nat
    Hp, Ws, Dp = vol.shape
    code = STORAGE.get(vol.dtype)
    if code is None:
        raise ValueError(f"sgm vol: expected float32, bfloat16 or float16, "
                         f"got {vol.dtype}")
    named = (("vol", vol), ("acc", acc), ("out", out), ("wta", wta),
             ("d1", d1), ("g", g), ("g_nat", g_nat))
    for name, t in named[:3]:
        if t is not None:
            _build.check_cuda(t, f"sgm {name}", vol.dtype)
    _check(named[3:], "sgm")
    reach = D + max(n_rev, Ws - n_rev) + Dp if vertical else D + Ws + Dp
    if Dp % 32 or Dp > 1024 or d1.shape != (Hp, Ws) \
            or g.shape[0] != Hp \
            or g_nat.shape != g.shape or g.shape[1] < reach \
            or not 0 <= n_rev <= Ws or (n_rev and not vertical) \
            or any(t is not None and t.shape != vol.shape for t in (acc, out)) \
            or (wta is not None and wta.shape != (Hp, Ws)):
        raise ValueError(f"sgm sweep: bad shapes vol {tuple(vol.shape)}, "
                         f"d1 {tuple(d1.shape)}, g {tuple(g.shape)}, "
                         f"n_rev {n_rev}")
    ptr = [None if t is None else t.data_ptr() for _, t in named]
    fl, pen_c = float(np.float32(tau)), _Pen((ctypes.c_float * 9)(*pen))
    if vertical:
        rc = _lib().sgm_sweep_vertical(*ptr, Hp, Ws, Dp, D, T, int(reverse),
                                       g.shape[1], n_rev, code, fl, pen_c,
                                       _build.stream(vol))
        entry = "sgm_vertical"
    else:
        rc = _lib().sgm_sweep_horizontal(*ptr[:6], Hp, Ws, Dp, D, T,
                                         int(reverse), g.shape[1], code, fl,
                                         pen_c, _build.stream(vol))
        entry = "sgm_horizontal"
    _build.check_launch(rc, entry)
    _build.count(entry)


def _sweep_hslab(vol, acc, out, d1, g, *, reverse, D, n_rev, rev_base, tau,
                 pen, T=None):
    """One horizontal sweep over a step-major (W, S, Dp) volume: the
    kernel on CUDA tensors (the vertical entry's kernel on the (W, S)
    steps and scanlines, planned by :func:`vertical_plan` with
    ``Ws = S``), :func:`hslab_plain` on CPU tensors."""
    kw = dict(reverse=reverse, D=D, n_rev=n_rev, rev_base=rev_base, tau=tau,
              pen=pen, T=T)
    if not vol.is_cuda:
        return hslab_plain(vol, acc, out, d1, g, **kw)
    W, S, Dp = vol.shape
    T = W if T is None else T
    named = (("vol", vol), ("acc", acc), ("out", out), ("d1", d1), ("g", g))
    _check(named, "sgm hslab")
    if out is None or Dp % 32 or Dp > 1024 or d1.shape != (W, S) \
            or not 0 < T <= W \
            or g.shape[0] != S or g.shape[1] < D + W + Dp \
            or not 0 <= n_rev <= S or rev_base - (W - 1) < 0 \
            or rev_base + Dp > g.shape[1] \
            or any(t is not None and t.shape != vol.shape for t in (acc, out)):
        raise ValueError(f"sgm hslab: bad shapes vol {tuple(vol.shape)}, "
                         f"d1 {tuple(d1.shape)}, g {tuple(g.shape)}, "
                         f"n_rev {n_rev}, rev_base {rev_base}, T {T}")
    ptr = [None if t is None else t.data_ptr() for _, t in named]
    rc = _lib().sgm_sweep_hslab(*ptr, W, S, Dp, D, T, int(reverse),
                                g.shape[1], n_rev, rev_base,
                                float(np.float32(tau)),
                                _Pen((ctypes.c_float * 9)(*pen)),
                                _build.stream(vol))
    _build.check_launch(rc, "sgm_hslab")
    _build.count("sgm_hslab")


def _sweep_scan(entry, vol_s, d1_s, d2_s, reverse, tau, pen):
    """A scan-form sweep: the C entry ``sgm_sweep_<entry>`` on CUDA
    tensors, :func:`sweep_scan_plain` on CPU tensors (a reverse sweep on
    the inputs reversed in steps, its result reversed back). The kernel
    reads rows of a pitch of whole float4s: when D % 4 != 0 the inputs
    are copied once into rows padded to it (NaN in the volume) and the
    result is the [..., :D] view of the padded output."""
    if not vol_s.is_cuda:
        if reverse:
            return sweep_scan_plain(vol_s.flip(0), d1_s.flip(0), d2_s.flip(0),
                                    tau=tau, pen=pen).flip(0)
        return sweep_scan_plain(vol_s, d1_s, d2_s, tau=tau, pen=pen)
    named = (("vol", vol_s), ("d1", d1_s), ("d2", d2_s))
    _check(named, f"sgm {entry}")
    if vol_s.dim() != 3 or not 0 < vol_s.shape[2] <= 1024 \
            or 0 in vol_s.shape or d1_s.shape != vol_s.shape[:2] \
            or d2_s.shape != vol_s.shape:
        raise ValueError(f"sgm {entry}: bad shapes vol {tuple(vol_s.shape)}, "
                         f"d1 {tuple(d1_s.shape)}, d2 {tuple(d2_s.shape)}")
    T, S, D = vol_s.shape
    ld = -(-D // 4) * 4
    if ld != D:
        vol_s, d2_s = _pad_d(vol_s, ld), _pad_d(d2_s, ld)
    out = torch.empty_like(vol_s)
    rc = getattr(_lib(), f"sgm_sweep_{entry}")(
        vol_s.data_ptr(), d1_s.data_ptr(), d2_s.data_ptr(), out.data_ptr(),
        T, S, D, ld, int(reverse), float(np.float32(tau)),
        _Pen((ctypes.c_float * 9)(*pen)), _build.stream(vol_s))
    _build.check_launch(rc, f"sgm_{entry}")
    _build.count(f"sgm_{entry}")
    return out if ld == D else out[..., :D]


def sweep_stream(vol_s, d1_s, d2_s, *, tau, pen, reverse=False):
    """The scan-form sweep with the whole sweep in one launch (entry
    ``sgm_scan``, the counterpart of ``_sweep_stream``, sgm.py:157) over
    (T, S, D) slices in natural step order: step 0 first, or with
    ``reverse`` step T - 1 first, each step's value written at its own
    position. On CPU tensors :func:`sweep_scan_plain` (on the reversed
    steps for ``reverse``)."""
    return _sweep_scan("scan", vol_s, d1_s, d2_s, reverse, tau, pen)


def sweep_grid(vol_s, d1_s, d2_s, *, tau, pen, reverse=False):
    """The counterpart of ``_sweep_grid`` (sgm.py:1005, entry
    ``sgm_step``), the TPU kernel that runs one step per iteration of a
    sequential grid axis and carries the previous step in on-chip
    scratch. On this card that axis is the step loop of one kernel
    launch, the same kernel as :func:`sweep_stream`'s, with the same
    contract."""
    return _sweep_scan("step", vol_s, d1_s, d2_s, reverse, tau, pen)


def table_layout(Hp: int, Wp: int, gw: int) -> tuple[int, int]:
    """(n_d1, stride) of the HWD lane's table buffer: sweep t's (Hp, Wp)
    D1 table at t * stride, its (Hp, gw) D2 table at t * stride + n_d1,
    each start a multiple of 4 floats (16 bytes); the gaps hold 0."""
    n_d1 = -(-Hp * Wp // 4) * 4
    return n_d1, n_d1 + -(-Hp * gw // 4) * 4


def table_views(buf: torch.Tensor, Hp: int, Wp: int, gw: int) -> list:
    """The four sweeps' (d1, g) tables in chain order (down, up, right,
    left) as views of the flat buffer of :func:`sgm_tables`."""
    n_d1, stride = table_layout(Hp, Wp, gw)
    return [(buf[t * stride:t * stride + Hp * Wp].view(Hp, Wp),
             buf[t * stride + n_d1:t * stride + n_d1 + Hp * gw].view(Hp, gw))
            for t in range(4)]


def _tables_lib():
    lib = _build.library("sgm_tables")
    if lib.sgm_tables_launch.argtypes is None:
        lib.sgm_tables_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
        lib.sgm_tables_launch.restype = ctypes.c_int
    return lib


def sgm_tables(x0, x1, D, H, W, shape, *, xrev) -> torch.Tensor:
    """All four sweeps' D1 and D2 tables of one reference direction of
    the HWD lane, in the storage order the sweeps read (``xrev``: the
    x-reversed left volume), as one flat float32 buffer laid out by
    :func:`table_layout` (views: :func:`table_views`). ``shape`` is the
    volume's (Hp, Wp, Dp); the D2 rows are gw = D + Wp + Dp wide. The
    kernel of ``csrc/sgm_tables.cu`` on CUDA images, one launch;
    :func:`sgm_tables_plain` on CPU ones."""
    x0 = x0.to(torch.float32)
    x1 = x1.to(torch.float32)
    if not x0.is_cuda:
        return sgm_tables_plain(x0, x1, D, H, W, shape, xrev=xrev)
    x0, x1 = x0.contiguous(), x1.contiguous()
    _check((("x0", x0), ("x1", x1)), "sgm_tables")
    Hp, Wp, Dp = shape
    if x0.shape != (H, W) or x1.shape != (H, W) or x0.device != x1.device \
            or Hp < H or Wp < W or D < 0:
        raise ValueError(f"sgm_tables: images {tuple(x0.shape)}, "
                         f"{tuple(x1.shape)} do not fit H={H}, W={W}, D={D}, "
                         f"volume {tuple(shape)}")
    gw = D + Wp + Dp
    n_d1, stride = table_layout(Hp, Wp, gw)
    buf = torch.empty(4 * stride, dtype=torch.float32, device=x0.device)
    if buf.numel():
        rc = _tables_lib().sgm_tables_launch(
            x0.data_ptr(), x1.data_ptr(), buf.data_ptr(), H, W, D, Hp, Wp,
            gw, n_d1, stride, int(xrev), _build.stream(x0))
        _build.check_launch(rc, "sgm_tables")
        _build.count("sgm_tables")
    return buf


def sgm_tables_plain(x0, x1, D, H, W, shape, *, xrev) -> torch.Tensor:
    """:func:`sgm_tables` from :func:`grad_with_sentinel`,
    :func:`d2_columns` and :func:`_tables`, each table copied into the
    buffer. The vertical D2 core ``|x1 - roll(x1, dy, 0)|`` wraps row 0
    (down) or H - 1 (up) to the opposite row, with no sentinel."""
    Hp, Wp, Dp = shape
    gw = D + Wp + Dp
    n_d1, stride = table_layout(Hp, Wp, gw)
    buf = torch.zeros(4 * stride, dtype=torch.float32, device=x0.device)
    pairs = []
    for dy in (1, -1):  # vertical family (sgm_dir 2: down, 3: up)
        core = torch.nn.functional.pad((x1 - torch.roll(x1, dy, 0)).abs(),
                                       (D, D), value=10.0)
        pairs.append((grad_with_sentinel(x0, axis=0, step=dy), core))
    for dx in (1, -1):  # horizontal family (sgm_dir 0: right, 1: left)
        pairs.append((grad_with_sentinel(x0, axis=1, step=dx),
                      d2_columns(x1, dx, 0, D)))
    for (d1, g), (v1, vg) in zip(
            (_tables(d1, core, xrev, Hp, Wp, gw) for d1, core in pairs),
            table_views(buf, Hp, Wp, gw)):
        v1.copy_(d1)
        vg.copy_(g)
    return buf


def sweep_plan(x0, x1, D, H, W, shape, *, xrev, pi1, pi2, tau_so, alpha1,
               q1, q2):
    """The four sweeps of one reference direction in chain order (down,
    up, right, left), each as the keyword arguments of :func:`_sweep`
    but the buffers: family, step order, real step count, D1/D2 tables
    (views of one :func:`sgm_tables` buffer) and penalty table.
    ``shape`` is the volume's (Hp, Wp, Dp)."""
    Hp, Wp, Dp = shape
    tables = table_views(sgm_tables(x0, x1, D, H, W, shape, xrev=xrev), Hp,
                         Wp, D + Wp + Dp)
    plan = []
    # vertical family (sgm_dir 2: down, 3: up), steps = rows
    for (d1, g), sgm_dir, dy in zip(tables[:2], (2, 3), (1, -1)):
        plan.append(dict(vertical=True, reverse=dy == -1, T=H, D=D,
                         tau=tau_so, d1=d1, g=g, n_rev=Wp if xrev else 0,
                         pen=pen_table(pi1, pi2, q1, q2,
                                       alpha1 if sgm_dir == 2 else 1.0,
                                       alpha1 if sgm_dir == 3 else 1.0)))
    # horizontal family (sgm_dir 0: right, 1: left), steps = columns; for
    # x-reversed storage the natural right-going sweep runs the stored
    # steps in reverse
    for (d1, g), dx in zip(tables[2:], (1, -1)):
        plan.append(dict(vertical=False, reverse=(dx == -1) != xrev, T=W,
                         D=D, tau=tau_so, d1=d1, g=g,
                         pen=pen_table(pi1, pi2, q1, q2, 1.0, 1.0)))
    return plan


def sgm_slab_hwd(x0, x1, vol, D, H, W, *, xrev, pi1, pi2, tau_so, alpha1,
                 q1, q2, wta=False, materialize=True):
    """Four sweeps summed for ONE reference direction on the join's
    (Hp, Wp, Dp) buffer: ``xrev=True`` for the left (-1) direction's
    x-reversed storage, False for the right (+1) one.

    The first sweep writes the accumulator, the others add into it in
    place. Returns the (Hp, Wp, Dp) sum in the same storage order and
    dtype (not divided by 4; pad rows and columns NaN); with ``wta`` also
    the float32 (Hp, Wp) winner map of the float32 sum (pad cells 0), as
    ``(vol, map)``, or the map alone when ``materialize=False`` skips the
    last volume write."""
    if not (materialize or wta):
        raise ValueError("materialize=False needs wta=True")
    Hp, Wp, Dp = vol.shape
    if Dp != -(-D // 128) * 128 or Hp < H or Wp < W:
        raise ValueError(f"sgm: volume {tuple(vol.shape)} does not fit "
                         f"H={H}, W={W}, D={D}")
    plan = sweep_plan(x0, x1, D, H, W, vol.shape, xrev=xrev, pi1=pi1, pi2=pi2,
                      tau_so=tau_so, alpha1=alpha1, q1=q1, q2=q2)
    acc = wmap = None
    for i, p in enumerate(plan):
        last = i == len(plan) - 1
        out = torch.empty_like(vol) if acc is None else acc
        if last and wta:
            wmap = torch.empty((Hp, Wp), dtype=torch.float32, device=vol.device)
        d1, g = p.pop("d1"), p.pop("g")
        _sweep(vol, acc, out if (materialize or not last) else None, wmap,
               d1, g, **p)
        acc = out
    if not wta:
        return acc
    return (acc, wmap) if materialize else wmap


def _pad_d(v: torch.Tensor, Dp: int) -> torch.Tensor:
    return torch.nn.functional.pad(v, (0, Dp - v.shape[-1]), value=torch.nan)


def _layout_lib():
    lib = _build.library("sgm_layout")
    if lib.sgm_layout_launch.argtypes is None:
        lib.sgm_layout_launch.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 7
                                          + [ctypes.c_void_p])
        lib.sgm_combine_launch.argtypes = ([ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 7
                                           + [ctypes.c_void_p])
        lib.wta_dhw_launch.argtypes = ([ctypes.c_void_p] * 2
                                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.sgm_generic_tables_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        for fn in (lib.sgm_layout_launch, lib.sgm_combine_launch,
                   lib.wta_dhw_launch, lib.sgm_generic_tables_launch):
            fn.restype = ctypes.c_int
    return lib


def _check_vols(vols, what):
    """The (D, H, w) float32 volumes of one family, one shape, on the card,
    contiguous: 1 or 2 of them."""
    if not 1 <= len(vols) <= 2:
        raise ValueError(f"{what}: expected 1 or 2 volumes, got {len(vols)}")
    for v in vols:
        _build.check_cuda_f32(v, f"{what} volume")
        if v.dim() != 3 or v.shape != vols[0].shape \
                or v.device != vols[0].device or 0 in v.shape:
            raise ValueError(f"{what}: volumes of shapes "
                             f"{[tuple(u.shape) for u in vols]}, expected one "
                             f"(D, H, w) shape on one device")


def sgm_layout(vols: list, Dp: int, *, vertical: bool, rev: bool
               ) -> torch.Tensor:
    """A family's d-minor volume from the stacked directions' (D, H, w)
    volumes (the -1 direction first), lanes [D, Dp) NaN: horizontal, the
    step-major (w, n*H, Dp) volume; vertical, the (H, n*w, Dp) volume,
    the first volume's columns reversed when ``rev``. The kernel of
    ``csrc/sgm_layout.cu`` (entry ``sgm_layout``) on CUDA volumes, one
    launch; :func:`sgm_layout_plain` on CPU ones."""
    if not vols[0].is_cuda:
        return sgm_layout_plain(vols, Dp, vertical=vertical, rev=rev)
    _check_vols(vols, "sgm_layout")
    D, H, w = vols[0].shape
    n = len(vols)
    if Dp % 32 or Dp < D or n * H > 65535:
        raise ValueError(f"sgm_layout: Dp {Dp} for D={D}, or {n * H} "
                         f"scanlines")
    out = torch.empty((H, n * w, Dp) if vertical else (w, n * H, Dp),
                      dtype=torch.float32, device=vols[0].device)
    rc = _layout_lib().sgm_layout_launch(
        vols[0].data_ptr(), vols[-1].data_ptr(), out.data_ptr(), n, D, H, w,
        Dp, int(vertical), int(rev), _build.stream(out))
    _build.check_launch(rc, "sgm_layout")
    _build.count("sgm_layout")
    return out


def sgm_layout_plain(vols: list, Dp: int, *, vertical: bool, rev: bool
                     ) -> torch.Tensor:
    """:func:`sgm_layout` as permuted views padded by :func:`_pad_d`,
    concatenated and made contiguous."""
    if vertical:
        parts = [v.permute(1, 2, 0) for v in vols]  # (H, w, D)
        if rev:
            parts[0] = parts[0].flip(1)
    else:
        parts = [v.permute(2, 1, 0) for v in vols]  # (w, H, D)
    return torch.cat([_pad_d(v, Dp) for v in parts], dim=1).contiguous()


# the kind of each table of the generic lane in csrc/sgm_layout.cu's
# generic_tables_kernel, by (family, table)
TABLE_KINDS = {("h", "d1"): 0, ("h", "g"): 1, ("v", "d1"): 2, ("v", "g"): 3,
               ("v", "g_nat"): 4}


def generic_table_layout(H: int, W: int, D: int, n: int, *,
                         horizontal: bool = True, vertical: bool = True,
                         cols=None) -> tuple[list, int]:
    """The parts of the generic lane's table buffer, as ([(key, rows,
    cols, first element)], length): key (family, table, step), the
    horizontal family's right then left sweep (``"d1"`` (W, n*H), ``"g"``
    (n*H, D + W + Dp)), then the vertical family's down then up sweep
    (``"d1"`` (H, n*w), ``"g"`` and ``"g_nat"`` (H, D + w + Dp)), w the
    columns of ``cols`` = (c0, c1) (default all W). Each part starts on a
    multiple of 4 floats (16 bytes); the gaps hold 0."""
    c0, c1 = (0, W) if cols is None else cols
    w = c1 - c0
    Dp = -(-D // 32) * 32
    shapes = []
    if horizontal:
        for dx in (1, -1):
            shapes += [(("h", "d1", dx), (W, n * H)),
                       (("h", "g", dx), (n * H, D + W + Dp))]
    if vertical:
        for dy in (1, -1):
            shapes += [(("v", "d1", dy), (H, n * w)),
                       (("v", "g", dy), (H, D + w + Dp)),
                       (("v", "g_nat", dy), (H, D + w + Dp))]
    parts, off = [], 0
    for key, (rows, ncols) in shapes:
        parts.append((key, rows, ncols, off))
        off += -(-rows * ncols // 4) * 4
    return parts, off


def _table_views(buf, parts) -> dict:
    return {key: buf[off:off + rows * ncols].view(rows, ncols)
            for key, rows, ncols, off in parts}


def sgm_generic_tables(x0, x1, D: int, dirs, *, horizontal=True,
                       vertical=True, cols=None) -> dict:
    """The D1 and D2 tables of the generic lane's sweeps for the stacked
    directions ``dirs`` (sorted), of the horizontal family, the vertical
    one (on the columns ``cols``, see :func:`vert_plan`) or both, as
    {(family, table, step): view} of one float32 buffer laid out by
    :func:`generic_table_layout`: the tables :func:`horiz_plan` and
    :func:`vert_plan` hand to the sweeps. The kernel of
    ``csrc/sgm_layout.cu`` (entry ``sgm_generic_tables``) on CUDA images,
    one launch; :func:`sgm_generic_tables_plain` on CPU ones."""
    x0 = x0.to(torch.float32)
    x1 = x1.to(torch.float32)
    kw = dict(horizontal=horizontal, vertical=vertical, cols=cols)
    if not x0.is_cuda:
        return sgm_generic_tables_plain(x0, x1, D, dirs, **kw)
    x0, x1 = x0.contiguous(), x1.contiguous()
    _check((("x0", x0), ("x1", x1)), "sgm_generic_tables")
    H, W = x0.shape
    c0, c1 = (0, W) if cols is None else cols
    if x1.shape != (H, W) or x0.device != x1.device or not 0 <= c0 < c1 <= W \
            or D < 1 or not 1 <= len(dirs) <= 2 or 0 in x0.shape \
            or not (horizontal or vertical):
        raise ValueError(f"sgm_generic_tables: images {tuple(x0.shape)}, "
                         f"{tuple(x1.shape)}, D={D}, directions {dirs}, "
                         f"columns {cols}")
    parts, total = generic_table_layout(H, W, D, len(dirs), **kw)
    buf = torch.empty(total, dtype=torch.float32, device=x0.device)
    desc = [v for key, rows, ncols, off in parts
            for v in (TABLE_KINDS[key[:2]], key[2], rows, ncols, off)]
    rc = _layout_lib().sgm_generic_tables_launch(
        x0.data_ptr(), x1.data_ptr(), buf.data_ptr(),
        (ctypes.c_longlong * len(desc))(*desc), len(parts), total, H, W, D,
        len(dirs), c0, c1, int(-1 in dirs), _build.stream(x0))
    _build.check_launch(rc, "sgm_generic_tables")
    _build.count("sgm_generic_tables")
    return _table_views(buf, parts)


def sgm_generic_tables_plain(x0, x1, D: int, dirs, *, horizontal=True,
                             vertical=True, cols=None) -> dict:
    """:func:`sgm_generic_tables` from :func:`grad_with_sentinel` and
    :func:`d2_columns` (the horizontal D2 rows lane-reversed for the -1
    direction) and the vertical core ``|x1 - roll(x1, dy, 0)|`` (no
    sentinel: row 0 or H - 1 wraps to the opposite row) padded by D
    columns of 10, lane-reversed for ``g`` and sliced to the columns
    ``cols``, each copied into the buffer."""
    H, W = x0.shape
    c0, c1 = (0, W) if cols is None else cols
    w = c1 - c0
    Dp = -(-D // 32) * 32
    gw = D + W + Dp
    tabs = {}
    if horizontal:
        for dx in (1, -1):
            d1 = grad_with_sentinel(x0, axis=1, step=dx).T  # (W, H)
            g0 = d2_columns(x1, dx, 0, D)  # (H, W + 2D)
            tabs["h", "d1", dx] = torch.cat([d1] * len(dirs), dim=1)
            tabs["h", "g", dx] = torch.nn.functional.pad(
                torch.cat([g0.flip(1) if d < 0 else g0 for d in dirs]),
                (0, gw - g0.shape[1]), value=10.0)
    if vertical:
        def table(c, x):  # (H, W + 2D) padded with 10 to (H, gw), from x
            c = torch.nn.functional.pad(c, (0, gw - c.shape[1]), value=10.0)
            return c[:, x:x + D + w + Dp]

        for dy in (1, -1):
            d1 = grad_with_sentinel(x0, axis=0, step=dy)[:, c0:c1]  # (H, w)
            core = torch.nn.functional.pad(
                (x1 - torch.roll(x1, dy, 0)).abs(), (D, D),
                value=10.0)  # (H, W + 2D)
            tabs["v", "d1", dy] = torch.cat(
                [d1.flip(1) if d == -1 else d1 for d in dirs], dim=1)
            tabs["v", "g", dy] = table(core.flip(1), W - c1)
            tabs["v", "g_nat", dy] = table(core, c0)
    parts, total = generic_table_layout(H, W, D, len(dirs),
                                        horizontal=horizontal,
                                        vertical=vertical, cols=cols)
    views = _table_views(torch.zeros(total, dtype=torch.float32,
                                     device=x0.device), parts)
    for key, view in views.items():
        view.copy_(tabs[key])
    return views


def horiz_plan(x0, x1, vols: dict, dirs, D, H, W, *, pi1, pi2, tau_so, q1,
               q2, tables=None):
    """The generic lane's horizontal family as inputs of
    :func:`_sweep_hslab`: the step-major (W, n*H, Dp) volume (the
    directions' (D, H, W) volumes stacked on the scanline axis, the -1
    direction first; :func:`sgm_layout`) and the keyword arguments of the
    right and the left sweep, the -1 direction's D2 rows lane-reversed
    (sgm.py:1135-1171), from ``tables`` (:func:`sgm_generic_tables` of
    this family or both; default built here)."""
    Dp = -(-D // 32) * 32
    vol_x = sgm_layout([vols[d] for d in dirs], Dp, vertical=False,
                       rev=False)  # (W, n*H, Dp)
    if tables is None:
        tables = sgm_generic_tables(x0, x1, D, dirs, vertical=False)
    plan = []
    for dx in (1, -1):
        plan.append(dict(
            d1=tables["h", "d1", dx], g=tables["h", "g", dx],
            reverse=dx == -1, D=D, n_rev=H if -1 in dirs else 0,
            rev_base=W + D - 1, tau=tau_so,
            pen=pen_table(pi1, pi2, q1, q2, 1.0, 1.0)))
    return vol_x, plan


def _family_sum(vol, plan, sweep):
    """A family's two sweeps on ``vol``, the second adding into the
    first one's result in place: the accumulator."""
    acc = None
    for p in plan:
        p = dict(p)
        d1, g = p.pop("d1"), p.pop("g")
        out = torch.empty_like(vol) if acc is None else acc
        sweep(vol, acc, out, d1, g, **p)
        acc = out
    return acc


def _slab_horiz_acc(x0, x1, vols: dict, dirs, D, H, W, **kw):
    vol_x, plan = horiz_plan(x0, x1, vols, dirs, D, H, W, **kw)
    return _family_sum(vol_x, plan, _sweep_hslab)


def _slab_vert_acc(x0, x1, vols: dict, dirs, D, H, W, **kw):
    vol_y, plan = vert_plan(x0, x1, vols, dirs, D, H, W, **kw)
    return _family_sum(vol_y, plan, lambda v, a, o, d1, g, **p:
                       _sweep(v, a, o, None, d1, g, **p))


def horizontal_views(acc, dirs, D) -> dict:
    """{direction: (D, H, W) view} of the horizontal family's (W, n*H, Dp)
    accumulator."""
    H = acc.shape[1] // len(dirs)
    return {d: acc[:, i * H:(i + 1) * H, :D].permute(2, 1, 0)
            for i, d in enumerate(dirs)}


def vertical_views(acc, dirs, D) -> dict:
    """{direction: (D, H, w) view} of the vertical family's (H, n*w, Dp)
    accumulator, the -1 direction's columns reversed back."""
    w = acc.shape[1] // len(dirs)
    outs = {}
    for i, d in enumerate(dirs):
        v = acc[:, i * w:(i + 1) * w, :D]
        outs[d] = (v.flip(1) if d == -1 else v).permute(2, 0, 1)
    return outs


def sgm_slab_horiz(x0, x1, vols: dict, dirs, D, H, W, *, pi1, pi2, tau_so,
                   q1, q2) -> dict:
    """Horizontal family (sgm_dir 0: right, 1: left) of the generic lane
    on the plan of :func:`horiz_plan`; the left sweep adds into the
    right one's result in place. Returns {direction: (D, H, W) sum of
    both sweeps}."""
    return horizontal_views(_slab_horiz_acc(
        x0, x1, vols, dirs, D, H, W, pi1=pi1, pi2=pi2, tau_so=tau_so, q1=q1,
        q2=q2), dirs, D)


def vert_plan(x0, x1, vols: dict, dirs, D, H, W, *, pi1, pi2, tau_so,
              alpha1, q1, q2, cols=None, tables=None):
    """The generic lane's vertical family as inputs of :func:`_sweep`:
    the (H, n*w, Dp) volume (the -1 direction's columns first and
    x-reversed; :func:`sgm_layout`) and the keyword arguments of the down
    and the up sweep, the -1 direction's D2 rows lane-reversed in ``g``
    and the natural ones in ``g_nat`` (sgm.py:1174-1217), from ``tables``
    (:func:`sgm_generic_tables` of this family or both; default built
    here). ``cols``: (c0, c1) when the volumes hold only the columns c0:c1
    of the (H, W) images x0, x1 (a column shard of the row-sharded
    inference), w = c1 - c0: the tables are built from the whole images
    and sliced, since D2 reads x1 at x -/+ d, outside the shard's
    columns."""
    c0, c1 = (0, W) if cols is None else cols
    Dp = -(-D // 32) * 32
    vol_y = sgm_layout([vols[d] for d in dirs], Dp, vertical=True,
                       rev=-1 in dirs)  # (H, n*w, Dp)
    if tables is None:
        tables = sgm_generic_tables(x0, x1, D, dirs, horizontal=False,
                                    cols=cols)
    plan = []
    for sgm_dir, dy in ((2, 1), (3, -1)):
        plan.append(dict(
            d1=tables["v", "d1", dy], g=tables["v", "g", dy],
            g_nat=tables["v", "g_nat", dy],
            n_rev=c1 - c0 if -1 in dirs else 0, vertical=True,
            reverse=dy == -1, T=H, D=D, tau=tau_so,
            pen=pen_table(pi1, pi2, q1, q2, alpha1 if sgm_dir == 2 else 1.0,
                          alpha1 if sgm_dir == 3 else 1.0)))
    return vol_y, plan


def sgm_slab_vert(x0, x1, vols: dict, dirs, D, H, W, *, pi1, pi2, tau_so,
                  alpha1, q1, q2, cols=None) -> dict:
    """Vertical family (sgm_dir 2: down, 3: up) of the generic lane on
    the plan of :func:`vert_plan` (``cols``: see there); the up sweep
    adds into the down one's result in place. Returns {direction:
    (D, H, w) sum of both sweeps}."""
    return vertical_views(_slab_vert_acc(
        x0, x1, vols, dirs, D, H, W, pi1=pi1, pi2=pi2, tau_so=tau_so,
        alpha1=alpha1, q1=q1, q2=q2, cols=cols), dirs, D)


def sgm_combine(acc_h, acc_v, dirs, D: int, *, quarter: bool = False
                ) -> dict:
    """The generic lane's four-sweep sums from the two family
    accumulators of the slab form, the horizontal (W, n*H, Dp) and the
    vertical (H, n*W, Dp) one: {direction: (D, H, W) contiguous h + v},
    or (h + v) / 4 with ``quarter`` (the SGM iteration's result). The
    kernel of ``csrc/sgm_layout.cu`` (entry ``sgm_combine``) on CUDA
    accumulators, one launch for all directions (the results are views of
    one (n, D, H, W) buffer); :func:`sgm_combine_plain` on CPU ones."""
    if not acc_h.is_cuda:
        return sgm_combine_plain(acc_h, acc_v, dirs, D, quarter=quarter)
    _check((("h", acc_h), ("v", acc_v)), "sgm_combine")
    n = len(dirs)
    W, nH, Dp = acc_h.shape
    H = nH // n
    if not 1 <= n <= 2 or nH != n * H or acc_v.shape != (H, n * W, Dp) \
            or Dp % 32 or not 0 < D <= Dp or nH > 65535 \
            or acc_v.device != acc_h.device:
        raise ValueError(f"sgm_combine: accumulators {tuple(acc_h.shape)}, "
                         f"{tuple(acc_v.shape)} for directions {dirs}, D={D}")
    out = torch.empty((n, D, H, W), dtype=torch.float32, device=acc_h.device)
    rc = _layout_lib().sgm_combine_launch(
        acc_h.data_ptr(), acc_v.data_ptr(), out.data_ptr(), n, D, H, W, Dp,
        int(-1 in dirs), int(quarter), _build.stream(out))
    _build.check_launch(rc, "sgm_combine")
    _build.count("sgm_combine")
    return {d: out[i] for i, d in enumerate(dirs)}


def sgm_combine_plain(acc_h, acc_v, dirs, D: int, *, quarter: bool = False
                      ) -> dict:
    """:func:`sgm_combine` as ``torch.add`` of the families' views into
    (D, H, W) contiguous tensors, then ``/ 4.0`` with ``quarter``."""
    h = horizontal_views(acc_h, dirs, D)
    v = vertical_views(acc_v, dirs, D)
    out = {d: torch.add(h[d], v[d], out=torch.empty(
        h[d].shape, dtype=h[d].dtype, device=h[d].device)) for d in dirs}
    return {d: s / 4.0 for d, s in out.items()} if quarter else out


def _d2_table(d2col: torch.Tensor, direction: int, D: int, W: int):
    """(H, W, D) view with [y, x, d] = d2col[y, x + d*direction + D] of
    an (H, W + 2D) table of :func:`d2_columns`: a sliding window
    starting at x + D for +1, at x + 1 and lane-reversed for -1
    (sgm.py:1379-1386; the gather of sgm.py:1411-1414 never clips, so it
    is the same window)."""
    win = d2col.unfold(1, D, 1)  # [y, s, j] = d2col[y, s + j]
    if direction > 0:
        return win[:, D:D + W]
    return win[:, 1:1 + W].flip(2)


def scan_horiz_plan(x0, x1, vols: dict, dirs, D, H, W, *, pi1, pi2, tau_so,
                    q1, q2):
    """The scan form's horizontal family (``_sgm_scan_horiz``,
    sgm.py:1365-1394) as inputs of a scan-form sweep: the (W, n*H, D)
    volume slices (steps the W columns, scanlines the rows of the
    stacked directions) and, for the right and the left sweep, the
    (W, n*H) D1 table, the built (W, n*H, D) D2 table, whether the sweep
    runs the steps in reverse, and the penalties; all in natural step
    order."""
    vol_x = torch.cat([vols[d].permute(2, 1, 0) for d in dirs],
                      dim=1).contiguous()
    plan = []
    for dx in (1, -1):
        d1 = grad_with_sentinel(x0, axis=1, step=dx).T  # (W, H)
        d2col = d2_columns(x1, dx, 0, D)  # (H, W + 2D)
        plan.append(dict(
            d1=torch.cat([d1] * len(dirs), dim=1),
            d2=torch.cat([_d2_table(d2col, d, D, W).permute(1, 0, 2)
                          for d in dirs], dim=1),
            reverse=dx == -1, tau=tau_so,
            pen=pen_table(pi1, pi2, q1, q2, 1.0, 1.0)))
    return vol_x, plan


def scan_vert_plan(x0, x1, vols: dict, dirs, D, H, W, *, pi1, pi2, tau_so,
                   alpha1, q1, q2, cols=None):
    """The scan form's vertical family (``_sgm_scan_vert``,
    sgm.py:1397-1422): the (H, n*w, D) volume slices (steps the H rows,
    scanlines the columns of the stacked directions) and the down and
    the up sweep's inputs, as :func:`scan_horiz_plan` gives them;
    ``cols`` as in :func:`vert_plan`."""
    c0, c1 = (0, W) if cols is None else cols
    vol_y = torch.cat([vols[d].permute(1, 2, 0) for d in dirs],
                      dim=1).contiguous()
    plan = []
    for sgm_dir, dy in ((2, 1), (3, -1)):
        d1 = grad_with_sentinel(x0, axis=0, step=dy)[:, c0:c1]  # (H, w)
        d2col = d2_columns(x1, 0, dy, D)  # (H, W + 2D)
        plan.append(dict(
            d1=torch.cat([d1] * len(dirs), dim=1),
            d2=torch.cat([_d2_table(d2col, d, D, W)[:, c0:c1] for d in dirs],
                         dim=1),
            reverse=dy == -1, tau=tau_so,
            pen=pen_table(pi1, pi2, q1, q2, alpha1 if sgm_dir == 2 else 1.0,
                          alpha1 if sgm_dir == 3 else 1.0)))
    return vol_y, plan


def _scan_sum(sweep, vol_t, plan, vols: dict, dirs, n, perm) -> dict:
    """Both sweeps of a scan-form family, added into a zero volume per
    direction: the forward sweep runs the natural step order, the
    backward one the reversed order, both on the natural-order inputs
    (``reverse``). ``n`` is the scanline count of one direction and
    ``perm`` takes a direction's (T, n, D) block to (D, H, W)."""
    outs = {d: torch.zeros_like(vols[d]) for d in dirs}
    for p in plan:
        res = sweep(vol_t, p["d1"], p.pop("d2"), tau=p["tau"], pen=p["pen"],
                    reverse=p["reverse"])
        for i, d in enumerate(dirs):
            outs[d] += res[:, i * n:(i + 1) * n].permute(*perm)
    return outs


def sgm_scan_horiz(sweep, x0, x1, vols: dict, dirs, D, H, W, *, pi1, pi2,
                   tau_so, q1, q2) -> dict:
    """Horizontal family (sgm_dir 0: right, 1: left) in the scan form on
    the sweep implementation ``sweep`` (:func:`sweep_stream` or
    :func:`sweep_grid`). Returns
    {direction: (D, H, W) sum of both sweeps}."""
    vol_x, plan = scan_horiz_plan(x0, x1, vols, dirs, D, H, W, pi1=pi1,
                                  pi2=pi2, tau_so=tau_so, q1=q1, q2=q2)
    return _scan_sum(sweep, vol_x, plan, vols, dirs, H, (2, 1, 0))


def sgm_scan_vert(sweep, x0, x1, vols: dict, dirs, D, H, W, *, pi1, pi2,
                  tau_so, alpha1, q1, q2, cols=None) -> dict:
    """Vertical family (sgm_dir 2: down, 3: up) in the scan form on the
    sweep implementation ``sweep`` (``cols``: see :func:`vert_plan`).
    Returns {direction: (D, H, w) sum of both sweeps}."""
    vol_y, plan = scan_vert_plan(x0, x1, vols, dirs, D, H, W, pi1=pi1,
                                 pi2=pi2, tau_so=tau_so, alpha1=alpha1, q1=q1,
                                 q2=q2, cols=cols)
    return _scan_sum(sweep, vol_y, plan, vols, dirs, vol_y.shape[1] //
                     len(dirs), (2, 0, 1))


FORMS = ("slab", "stream", "grid")


def resolve_form(form=None) -> str:
    """The SGM form of the generic lane: ``"slab"``, ``"stream"`` or
    ``"grid"``. ``None`` reads ``MCCNN_SGM_HSLAB`` now, as the JAX
    package does (sgm.py:1353-1354): ``"0"`` selects ``"stream"``,
    anything else ``"slab"``; ``"grid"`` is chosen only by name."""
    if form is None:
        return "stream" if os.environ.get("MCCNN_SGM_HSLAB", "1") == "0" \
            else "slab"
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS} or None, got {form!r}")
    return form


def horizontal_family(form, x0, x1, vols: dict, dirs, D, H, W, **kw) -> dict:
    """The horizontal family in the SGM form ``form`` (a name of
    ``FORMS``): :func:`sgm_slab_horiz` or :func:`sgm_scan_horiz`."""
    if form == "slab":
        return sgm_slab_horiz(x0, x1, vols, dirs, D, H, W, **kw)
    sweep = sweep_stream if form == "stream" else sweep_grid
    return sgm_scan_horiz(sweep, x0, x1, vols, dirs, D, H, W, **kw)


def vertical_family(form, x0, x1, vols: dict, dirs, D, H, W, **kw) -> dict:
    """The vertical family in the SGM form ``form``: :func:`sgm_slab_vert`
    or :func:`sgm_scan_vert` (both take ``cols``)."""
    if form == "slab":
        return sgm_slab_vert(x0, x1, vols, dirs, D, H, W, **kw)
    sweep = sweep_stream if form == "stream" else sweep_grid
    return sgm_scan_vert(sweep, x0, x1, vols, dirs, D, H, W, **kw)


def sgm_multi(x0, x1, vols: dict, *, pi1, pi2, tau_so, alpha1, sgm_q1,
              sgm_q2, form=None, quarter=False) -> dict:
    """Four sweeps, summed (h + v, not divided by 4), for one or both
    reference directions at once. vols: {direction: (D, H, W)};
    ``form``: see :func:`resolve_form`; ``quarter``: (h + v) / 4 instead,
    the result of one SGM iteration of the stereo method. The slab form
    builds both families' tables in one :func:`sgm_generic_tables` call
    and adds the families with :func:`sgm_combine`."""
    form = resolve_form(form)
    dirs = sorted(vols)
    D, H, W = vols[dirs[0]].shape
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=vols[dirs[0]].device)
    x1 = torch.as_tensor(x1, dtype=torch.float32, device=vols[dirs[0]].device)
    kw = dict(pi1=pi1, pi2=pi2, tau_so=tau_so, q1=sgm_q1, q2=sgm_q2)
    if form == "slab":
        tables = sgm_generic_tables(x0, x1, D, dirs)
        acc_h = _slab_horiz_acc(x0, x1, vols, dirs, D, H, W, tables=tables,
                                **kw)
        acc_v = _slab_vert_acc(x0, x1, vols, dirs, D, H, W, alpha1=alpha1,
                               tables=tables, **kw)
        return sgm_combine(acc_h, acc_v, dirs, D, quarter=quarter)
    h = horizontal_family(form, x0, x1, vols, dirs, D, H, W, **kw)
    v = vertical_family(form, x0, x1, vols, dirs, D, H, W, alpha1=alpha1, **kw)
    # the sum is laid out (D, H, W) contiguous, which the stages after the
    # SGM read far faster
    out = {d: torch.add(h[d], v[d], out=torch.empty_like(
        vols[d], memory_format=torch.contiguous_format)) for d in dirs}
    return {d: s / 4.0 for d, s in out.items()} if quarter else out


def sgm(x0, x1, vol, *, pi1, pi2, tau_so, alpha1, sgm_q1, sgm_q2,
        direction, form=None) -> torch.Tensor:
    """All four sweeps of one direction, summed (caller divides by 4).
    vol: (D, H, W)."""
    return sgm_multi(x0, x1, {direction: vol}, pi1=pi1, pi2=pi2,
                     tau_so=tau_so, alpha1=alpha1, sgm_q1=sgm_q1,
                     sgm_q2=sgm_q2, form=form)[direction]


def sgm_pair(x0, x1, vol_m1, vol_p1, *, pi1, pi2, tau_so, alpha1, sgm_q1,
             sgm_q2, form=None):
    """Both reference directions in one stacked sweep set; returns
    (out_minus1, out_plus1)."""
    outs = sgm_multi(x0, x1, {-1: vol_m1, 1: vol_p1}, pi1=pi1, pi2=pi2,
                     tau_so=tau_so, alpha1=alpha1, sgm_q1=sgm_q1,
                     sgm_q2=sgm_q2, form=form)
    return outs[-1], outs[1]
