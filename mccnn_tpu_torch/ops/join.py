"""Fast-arch cost volumes in the padded disparity-minor layout.

Same contract as the JAX package's ``stereo_join_mxu_hwd``
(mccnn_tpu/ops/join_pallas.py): (Hp, Wp, Dp) buffers with Hp, Wp and
Dp rounded up to 64, 128 and 128; the left volume x-REVERSED (the
mirror identity <fl[x], fr[x-d]> = <fl'[x'], fr'[x'+d]> at x' = W-1-x,
primes on x-flipped maps, so both sides are one kernel); NaN at
x + d >= W, d >= d_true (the real disparity count, D by default),
d >= D and in pad rows; ``n_fix`` border columns replicated in the
kernel. The buffers are stored as ``out_dtype`` (float32, bfloat16 or
float16): the dots are float32 whatever the storage, and only the store
rounds (to nearest even), so a 16-bit buffer is the float32 one
rounded.

On CUDA tensors :func:`_join_plus` launches ``csrc/join.cu``, which
computes the dots from bf16 products on the tensor cores as the TPU
kernel does, with a split of three bf16 levels where the TPU kernel has
two (:func:`join_plus_split_plain` emulates both); on CPU tensors it
runs :func:`join_plus_plain`, a float32 sum.
:func:`stereo_join_dhw` relays the two buffers to disparity-major
(D, H, W) volumes for the generic lane (the fast arch with CBCA).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mccnn_tpu_torch.ops import _build

XT = 128  # the column padding of the buffers
KC = 64  # channels a kernel launch takes: more run in slabs of 64
# the out_dtype code of join_launch for each storage dtype
STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def pad_dims(H: int, W: int, D: int) -> tuple[int, int, int]:
    """(Hp, Wp, Dp) of the HWD buffers: rows to 64 (the scanline
    count of the horizontal sweeps), columns and disparities to 128."""
    return -(-H // 64) * 64, -(-W // XT) * XT, -(-D // 128) * 128


def _join(a: torch.Tensor, D: int, W: int, H: int, n_fix: int, dot,
          d_true=None, out_dtype=torch.float32) -> torch.Tensor:
    """out[y, x, d] = -dot(d)[y, x] with the masks and the border of the
    kernel, one disparity at a time, then rounded to ``out_dtype``;
    ``dot(d)`` is the (Hp, Wp) float32 product of a: (Hp, C, Wp) with b
    shifted by d."""
    Hp, _, Wp = a.shape
    Dp = -(-D // 128) * 128
    d_true = D if d_true is None else d_true
    out = torch.empty((Hp, Wp, Dp), dtype=torch.float32, device=a.device)
    for d in range(Dp):
        out[:, :, d] = -dot(d)
    x = torch.arange(Wp, device=a.device)[None, :, None]
    d = torch.arange(Dp, device=a.device)[None, None, :]
    y = torch.arange(Hp, device=a.device)[:, None, None]
    out = torch.where((x + d < W) & (d < min(D, d_true)) & (y < H), out,
                      torch.nan)
    if n_fix > 0:
        out[:, :n_fix, :] = out[:, n_fix:n_fix + 1, :]
    return out.to(out_dtype)


def join_plus_plain(a: torch.Tensor, b: torch.Tensor, D: int, W: int, H: int,
                    n_fix: int, d_true=None, out_dtype=torch.float32
                    ) -> torch.Tensor:
    """out[y, x, d] = -<a[y, :, x], b[y, :, x + d]> in float32 with the
    masks and the border of the kernel, stored as ``out_dtype``.
    a: (Hp, C, Wp), b: (Hp, C, >= Wp + Dp); lanes d >= ``d_true`` NaN."""
    Wp = a.shape[2]
    return _join(a, D, W, H, n_fix,
                 lambda d: (a * b[:, :, d:d + Wp]).sum(1), d_true, out_dtype)


def _split(t: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """t as the sum of ``levels`` bf16 terms and a residual: each term
    is bf16 (round to nearest even) of what the terms before it leave,
    held as float32."""
    terms = []
    for _ in range(levels):
        terms.append(t.to(torch.bfloat16).to(torch.float32))
        t = t - terms[-1]
    return terms


def join_plus_split_plain(a: torch.Tensor, b: torch.Tensor, D: int, W: int,
                          H: int, n_fix: int, levels: int = 3, d_true=None,
                          out_dtype=torch.float32) -> torch.Tensor:
    """:func:`join_plus_plain` from bf16 products, summed in float32:
    each operand split into ``levels`` bf16 terms, and the dot the sum
    of the products a_i.b_j with i + j < ``levels`` (0-based), the
    smallest first. bf16 keeps 8 significant bits, so each term is
    within 2^-8 of what the terms before it leave. ``levels=3`` is the
    CUDA kernel's arithmetic (six products, within about 4 * 2^-24
    sum |a||b| of the float32 dot, the size of the rounding of the sums);
    ``levels=2`` the TPU kernel's (join_pallas.py:155-165: a_hi.b_hi +
    a_hi.b_lo + a_lo.b_hi, within about 3 * 2^-16 sum |a||b|;
    L2-normalized maps have sum |a||b| <= 1). ``d_true`` and
    ``out_dtype`` as in :func:`join_plus_plain`."""
    sa, sb = _split(a, levels), _split(b, levels)
    pairs = sorted(((i, j) for i in range(levels) for j in range(levels)
                    if i + j < levels), key=lambda p: (-sum(p), -p[0]))
    Wp = a.shape[2]

    def dot(d):
        out = torch.zeros_like(a[:, 0])
        for i, j in pairs:
            out = out + (sa[i] * sb[j][:, :, d:d + Wp]).sum(1)
        return out

    return _join(a, D, W, H, n_fix, dot, d_true, out_dtype)


def _lib():
    lib = _build.library("join")
    if lib.join_launch.argtypes is None:
        lib.join_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.join_launch.restype = ctypes.c_int
    return lib


def _join_plus(a: torch.Tensor, b: torch.Tensor, D: int, W: int, H: int,
               n_fix: int, d_true=None, out_dtype=torch.float32
               ) -> torch.Tensor:
    """The join of one side, stored as ``out_dtype``, lanes d >= d_true
    NaN: the kernel on CUDA tensors, the plain version on CPU tensors."""
    d_true = D if d_true is None else int(d_true)
    code = STORAGE.get(out_dtype)
    if code is None or not 0 < d_true <= D:
        raise ValueError(f"join: out_dtype {out_dtype} and d_true {d_true} "
                         f"(0 < d_true <= D={D}) not taken")
    if not a.is_cuda:
        return join_plus_plain(a, b, D, W, H, n_fix, d_true, out_dtype)
    Hp, C, Wp = a.shape
    Dp = -(-D // 128) * 128
    for t, what in ((a, "join a"), (b, "join b")):
        _build.check_cuda_f32(t, what)
    if Wp % XT or b.shape[:2] != (Hp, C) or b.shape[2] < Wp + Dp \
            or b.shape[2] % 4:
        raise ValueError(f"join: bad shapes a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)} for D={D}")
    if not 0 <= n_fix < 8:
        raise ValueError(f"join: n_fix must be in [0, 8), got {n_fix}")
    if C < 1:
        raise ValueError(f"join: C={C} channels; the kernel takes 1 or more")
    out = torch.empty((Hp, Wp, Dp), dtype=out_dtype, device=a.device)
    # a 16-bit volume of several channel slabs sums them in float32 first
    tmp = (torch.empty((Hp, Wp, Dp), dtype=torch.float32, device=a.device)
           if code and C > KC else None)
    rc = _lib().join_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            None if tmp is None else tmp.data_ptr(), H, W, C,
                            Hp, Wp, b.shape[2], Dp, D, d_true, n_fix, code,
                            _build.stream(a))
    _build.check_launch(rc, "join")
    _build.count("join", -(-C // KC))  # one kernel launch a channel slab
    return out


def _prep(f: torch.Tensor, flip: bool, Hp: int, width: int) -> torch.Tensor:
    """(H, W, C) -> zero-padded channel-major (Hp, C, width)."""
    H, W, _ = f.shape
    f = f.permute(0, 2, 1)
    if flip:
        f = f.flip(2)
    return torch.nn.functional.pad(f, (0, width - W, 0, 0, 0, Hp - H)
                                   ).contiguous()


class Operands(NamedTuple):
    """The join's operands of both sides for (H, W) maps: a_l (fl) and b_l
    (fr) x-reversed, a_r (fr) and b_r (fl) natural, each zero-padded
    channel-major, a (Hp, C, Wp) and b (Hp, C, Wp + Dp) (:func:`pad_dims`);
    a_r and b_r None for the left side alone."""
    a_l: torch.Tensor
    b_l: torch.Tensor
    a_r: torch.Tensor | None
    b_r: torch.Tensor | None
    H: int
    W: int


def _side(f: torch.Tensor, g: torch.Tensor, right: bool, Hp: int, Wp: int,
          Dp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of one side from (H, W, C) maps: a from f, b from g, both
    x-reversed for the left side."""
    f, g = f.to(torch.float32), g.to(torch.float32)
    return _prep(f, not right, Hp, Wp), _prep(g, not right, Hp, Wp + Dp)


def operands(feat_l: torch.Tensor, feat_r: torch.Tensor, disp_max: int,
             sides: str = "both") -> Operands:
    """The :class:`Operands` of (H, W, C) maps by :func:`_prep`."""
    H, W, _ = feat_l.shape
    dims = pad_dims(H, W, int(disp_max))
    a_l, b_l = _side(feat_l, feat_r, False, *dims)
    if sides == "left":
        return Operands(a_l, b_l, None, None, H, W)
    return Operands(a_l, b_l, *_side(feat_r, feat_l, True, *dims), H, W)


def stereo_join_hwd(feat_l: torch.Tensor | None, feat_r: torch.Tensor | None,
                    disp_max: int, n_fix: int = 0, sides: str = "both",
                    d_true=None, out_dtype: torch.dtype = torch.float32,
                    packed: Operands | None = None):
    """Both cost volumes, (vol_l_xrev, vol_r), each (Hp, Wp, Dp):
    ``vol_r[y, x, d] = -<fr[y,x], fl[y,x+d]>`` and
    ``vol_l_xrev[y, x', d] = vol_L[y, W-1-x', d]``. feat_l/feat_r:
    (H, W, C) L2-normalized maps, or None with ``packed``, their
    :class:`Operands` built already (the fast tower's packed route,
    ``ops.tower.normalize``). ``sides="left"`` returns the left
    volume alone. ``d_true``: the real disparity count when ``disp_max``
    was padded (lanes d >= d_true NaN; None: all of disp_max);
    ``out_dtype``: the storage dtype, float32, bfloat16 or float16."""
    if sides not in ("both", "left"):
        raise ValueError(f"sides must be 'both' or 'left', got {sides!r}")
    D = int(disp_max)
    H, W = feat_l.shape[:2] if packed is None else (packed.H, packed.W)
    Hp, Wp, Dp = pad_dims(H, W, D)
    if packed is not None and (
            packed.a_l.shape[::2] != (Hp, Wp)
            or packed.b_l.shape[::2] != (Hp, Wp + Dp)
            or (sides == "both" and packed.a_r is None)):
        raise ValueError(f"join: operands a {tuple(packed.a_l.shape)}, b "
                         f"{tuple(packed.b_l.shape)} (right side "
                         f"{packed.a_r is not None}) do not fit {H}x{W}, "
                         f"D={D}, sides {sides!r}")

    def side(right: bool):
        """(a, b) of one side, each prepared only when it is joined."""
        if packed is not None:
            return (packed.a_r, packed.b_r) if right else (packed.a_l,
                                                           packed.b_l)
        f, g = (feat_r, feat_l) if right else (feat_l, feat_r)
        return _side(f, g, right, Hp, Wp, Dp)

    kw = dict(d_true=d_true, out_dtype=out_dtype)
    vol_l_xrev = _join_plus(*side(False), D, W, H, n_fix, **kw)
    if sides == "left":
        return vol_l_xrev
    vol_r = _join_plus(*side(True), D, W, H, n_fix, **kw)
    return vol_l_xrev, vol_r


def stereo_join_dhw(feat_l: torch.Tensor, feat_r: torch.Tensor, disp_max: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The disparity-major contract of :func:`costs.stereo_join
    <mccnn_tpu_torch.ops.costs.stereo_join>` on the join kernel
    (``stereo_join_mxu``, join_pallas.py:327-342): (vol_L, vol_R),
    each (D, H, W), relaid from the :func:`stereo_join_hwd` buffers, the
    left one un-reversed; no border fix (the generic lane applies
    ``fix_border`` afterwards)."""
    H, W, _ = feat_l.shape
    D = int(disp_max)
    vol_l_xrev, vol_r = stereo_join_hwd(feat_l, feat_r, D)
    return (vol_l_xrev[:H, :W, :D].flip(1).permute(2, 0, 1).contiguous(),
            vol_r[:H, :W, :D].permute(2, 0, 1).contiguous())
