"""Semiglobal matching on the padded disparity-minor (Hp, Wp, Dp) layout.

Behavior contract: the reference's production kernel ``sgm2``
(adcensus.cu:535-697) as the JAX package's HWD lane runs it
(``sgm._sgm_slab_hwd``, mccnn_tpu/ops/sgm.py:1237-1331): per reference
direction two vertical sweeps (down, up), then two horizontal sweeps
(right, left), chained through one accumulator; the sum is NOT divided
by 4; the winner-take-all map of the sum comes out of the last sweep.

Penalties (adcensus.cu:586-613): D1 = |x0[p] - x0[p - step]|,
D2 = |x1[q] - x1[q - step]| at the match pixel q (10 where q or
q - step leaves the frame); both below tau_so -> (pi1, pi2), both above
-> divided by q1*q2, else by q1; the vertical sweeps divide the d-1
(down) or d+1 (up) neighbour penalty by alpha1.

On CUDA tensors each sweep launches ``csrc/sgm_sweep.cu`` (entries
``sgm_vertical`` and ``sgm_horizontal``); on CPU tensors it runs the
step loop :func:`sweep_plain`.
"""

from __future__ import annotations

import ctypes

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


def sweep_plain(vol, acc, out, wta, d1, g, *, vertical, reverse, T, D, tau,
                pen):
    """One sweep as a step loop of torch ops, with the kernel's
    contract (see ``csrc/sgm_sweep.cu``). ``out`` may be ``acc`` (in
    place) or None; ``wta`` None or an (Hp, Wp) buffer to fill."""
    Hp, Wp, Dp = vol.shape
    dev = vol.device
    tau = torch.tensor(tau, dtype=torch.float32, device=dev)
    pens = torch.tensor(pen, dtype=torch.float32, device=dev).reshape(3, 3)
    inf = torch.full((1,), torch.inf, dtype=torch.float32, device=dev)

    def step_view(t, s):  # (scanlines, ...) slice of step s
        return t[s] if vertical else t[:, s]

    n_steps = Hp if vertical else Wp
    init = T - 1 if reverse else 0
    prev = None
    for s in (range(n_steps - 1, -1, -1) if reverse else range(n_steps)):
        v = step_view(vol, s)
        if s >= T:
            outv = v
        elif s == init:
            prev = outv = v
        else:
            D1 = step_view(d1, s)[:, None]
            D2 = (g[s].unfold(0, Dp, 1)[D:D + Wp] if vertical
                  else g[:, D + s:D + s + Dp])
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
        fin = outv + step_view(acc, s) if acc is not None else outv
        if out is not None:
            step_view(out, s).copy_(fin)
        if wta is not None:
            clean = torch.where(torch.isnan(fin), torch.inf, fin)
            step_view(wta, s).copy_(clean.argmin(-1).to(torch.float32))


class _Pen(ctypes.Structure):
    _fields_ = [("v", ctypes.c_float * 9)]


def _lib():
    lib = _build.library("sgm_sweep")
    for fn in (lib.sgm_sweep_vertical, lib.sgm_sweep_horizontal):
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                           + [ctypes.c_float, _Pen, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _sweep(vol, acc, out, wta, d1, g, *, vertical, reverse, T, D, tau, pen):
    """One sweep: the kernel on CUDA tensors, :func:`sweep_plain` on
    CPU tensors."""
    kw = dict(vertical=vertical, reverse=reverse, T=T, D=D, tau=tau, pen=pen)
    if not vol.is_cuda:
        return sweep_plain(vol, acc, out, wta, d1, g, **kw)
    Hp, Wp, Dp = vol.shape
    named = (("vol", vol), ("acc", acc), ("out", out), ("wta", wta),
             ("d1", d1), ("g", g))
    for what, t in named:
        if t is not None:
            _build.check_cuda_f32(t, f"sgm {what}")
    if Dp % 32 or Dp > 1024 or d1.shape != (Hp, Wp) or g.shape[0] != Hp \
            or g.shape[1] < D + Wp + Dp \
            or any(t is not None and t.shape != vol.shape for t in (acc, out)) \
            or (wta is not None and wta.shape != (Hp, Wp)):
        raise ValueError(f"sgm sweep: bad shapes vol {tuple(vol.shape)}, "
                         f"d1 {tuple(d1.shape)}, g {tuple(g.shape)}")
    ptr = [None if t is None else t.data_ptr() for _, t in named]
    entry = "sgm_vertical" if vertical else "sgm_horizontal"
    fn = getattr(_lib(), "sgm_sweep_vertical" if vertical
                 else "sgm_sweep_horizontal")
    rc = fn(*ptr, Hp, Wp, Dp, D, T, int(reverse), g.shape[1],
            float(np.float32(tau)), _Pen((ctypes.c_float * 9)(*pen)),
            _build.stream(vol))
    _build.check_launch(rc, entry)
    _build.LAUNCHES[entry] += 1


def sweep_plan(x0, x1, D, H, W, shape, *, xrev, pi1, pi2, tau_so, alpha1,
               q1, q2):
    """The four sweeps of one reference direction in chain order (down,
    up, right, left), each as the keyword arguments of :func:`_sweep`
    but the buffers: family, step order, real step count, D1/D2 tables
    and penalty table. ``shape`` is the volume's (Hp, Wp, Dp)."""
    Hp, Wp, Dp = shape
    x0 = x0.to(torch.float32)
    x1 = x1.to(torch.float32)
    gw = D + Wp + Dp
    plan = []
    # vertical family (sgm_dir 2: down, 3: up), steps = rows
    for sgm_dir, dy in ((2, 1), (3, -1)):
        core = torch.nn.functional.pad((x1 - torch.roll(x1, dy, 0)).abs(),
                                       (D, D), value=10.0)
        d1, g = _tables(grad_with_sentinel(x0, axis=0, step=dy), core, xrev,
                        Hp, Wp, gw)
        plan.append(dict(vertical=True, reverse=dy == -1, T=H, D=D,
                         tau=tau_so, d1=d1, g=g,
                         pen=pen_table(pi1, pi2, q1, q2,
                                       alpha1 if sgm_dir == 2 else 1.0,
                                       alpha1 if sgm_dir == 3 else 1.0)))
    # horizontal family (sgm_dir 0: right, 1: left), steps = columns; for
    # x-reversed storage the natural right-going sweep runs the stored
    # steps in reverse
    for dx in (1, -1):
        d1, g = _tables(grad_with_sentinel(x0, axis=1, step=dx),
                        d2_columns(x1, dx, 0, D), xrev, Hp, Wp, gw)
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
    place. Returns the (Hp, Wp, Dp) sum in the same storage order (not
    divided by 4; pad rows and columns NaN); with ``wta`` also the
    (Hp, Wp) winner map of the sum (pad cells 0), as ``(vol, map)``, or
    the map alone when ``materialize=False`` skips the last volume
    write."""
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
