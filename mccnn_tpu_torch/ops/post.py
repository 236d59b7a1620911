"""Disparity refinement: occlusion and mismatch filling, the subpixel
parabola, and the median.

Reference kernels: interpolate_occlusion adcensus.cu:1079-1125,
interpolate_mismatch adcensus.cu:1001-1077, subpixel_enchancement
adcensus.cu:1205-1239, median2d adcensus.cu:1575-1613. All maps are
(H, W) float32.

On CUDA tensors each public function launches its kernel of
``csrc/refine.cu`` (one launch a call); on CPU tensors it runs its plain
version, the ``*_plain`` function beside it. The plain versions follow
the JAX package (mccnn_tpu/ops/post.py): bounded, data-independent work
(pointer doubling for the ray walk, a selection network for the
medians). The kernels compute the same values bit for bit: the mismatch
fill walks each ray until it lands; the median takes 2 x 4 outputs a
thread and runs the plain network where their 6 x 8 window union leaves
the frame or holds a NaN or a -0.0, and elsewhere a cheaper network over
shared sorted columns (``ops/median_net.py``), which selects the same
bits where the values are totally ordered and equal values have equal
bits.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from mccnn_tpu_torch.ops import _build
from mccnn_tpu_torch.ops.outlier import MATCH, MISMATCH, OCCLUSION

# storage dtype of a volume (the ``storage`` argument of subpixel_launch)
STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib():
    lib = _build.library("refine")
    if lib.subpixel_launch.argtypes is None:
        maps = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        for fn in (lib.occlusion_fill_launch, lib.mismatch_fill_launch):
            fn.argtypes = maps
        lib.median5_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.subpixel_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_void_p])
        for fn in (lib.occlusion_fill_launch, lib.mismatch_fill_launch,
                   lib.median5_launch, lib.subpixel_launch):
            fn.restype = ctypes.c_int
    return lib


def _maps(what: str, *maps: torch.Tensor) -> list[torch.Tensor]:
    """The (H, W) float32 maps of one shape a kernel takes, contiguous on
    the card, or ValueError."""
    maps = [m.contiguous() for m in maps]
    for m in maps:
        _build.check_cuda_f32(m, what)
    if maps[0].dim() != 2 or any(m.shape != maps[0].shape for m in maps):
        raise ValueError(f"{what}: bad shapes "
                         f"{[tuple(m.shape) for m in maps]}")
    return maps


def _fill(entry: str, d0: torch.Tensor, outlier: torch.Tensor
          ) -> torch.Tensor:
    """Launch the occlusion or the mismatch fill on (H, W) maps."""
    d0, outlier = _maps(entry, d0, outlier)
    H, W = d0.shape
    out = torch.empty_like(d0)
    rc = getattr(_lib(), f"{entry}_launch")(
        d0.data_ptr(), outlier.data_ptr(), out.data_ptr(), H, W,
        _build.stream(d0))
    _build.check_launch(rc, entry)
    _build.count(entry)
    return out


def interpolate_occlusion(d0: torch.Tensor, outlier: torch.Tensor
                          ) -> torch.Tensor:
    """Fill occluded pixels with the nearest *match* pixel's disparity to
    the left; if none exists, nearest to the right; else keep. The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if not d0.is_cuda:
        return interpolate_occlusion_plain(d0, outlier)
    return _fill("occlusion_fill", d0, outlier)


def interpolate_occlusion_plain(d0: torch.Tensor, outlier: torch.Tensor
                                ) -> torch.Tensor:
    """The fill by an index cummax from each side and a gather."""
    H, W = d0.shape
    is_match = outlier == MATCH
    xs = torch.arange(W, device=d0.device).expand(H, W)
    left = torch.cummax(torch.where(is_match, xs, -1), dim=1).values
    right = W - 1 - torch.cummax(
        torch.where(is_match, W - 1 - xs, -1).flip(1), dim=1).values.flip(1)
    lv = d0.gather(1, left.clamp(min=0))
    rv = d0.gather(1, right.clamp(max=W - 1))
    fill = torch.where(left >= 0, lv, torch.where(right < W, rv, d0))
    return torch.where(outlier == OCCLUSION, fill, d0)


# 16 ray directions, (dx, dy), adcensus.cu:1003-1020
_RAY_DIRS = np.array([
    (0, 1), (-0.5, 1), (-1, 1), (-1, 0.5), (-1, 0), (-1, -0.5), (-1, -1),
    (-0.5, -1), (0, -1), (0.5, -1), (1, -1), (1, -0.5), (1, 0), (1, 0.5),
    (1, 1), (0.5, 1)], dtype=np.float32)


def _half_up(v: float) -> int:
    """floor(v + 0.5): what C round() does to the walk's non-negative
    absolute coordinates (adcensus.cu:1039-1044); translation invariant,
    so probe offsets are per-pixel constants."""
    return int(math.floor(v + 0.5))


def _shift_state(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = arr[y+dy, x+dx], ``fill`` outside the frame."""
    H, W = arr.shape
    out = torch.full_like(arr, fill)
    ys, yd = slice(max(0, dy), H + min(0, dy)), slice(max(0, -dy), H - max(0, dy))
    xs, xd = slice(max(0, dx), W + min(0, dx)), slice(max(0, -dx), W - max(0, dx))
    if yd.start < yd.stop and xd.start < xd.stop:
        out[yd, xd] = arr[ys, xs]
    return out


def _median_network(n: int, mid: int) -> list[tuple[int, int]]:
    """Comparator list selecting sorted index ``mid`` of ``n`` values:
    Batcher's odd-even mergesort, then dead-comparator elimination
    backward from the one needed output."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    needed = {mid}
    kept = []
    for a, b in reversed(pairs):
        if a in needed or b in needed:
            kept.append((a, b))
            needed.add(a)
            needed.add(b)
    return list(reversed(kept))


def _select_mid(vals: list, mid: int) -> torch.Tensor:
    for i, j in _median_network(len(vals), mid):
        vals[i], vals[j] = (torch.minimum(vals[i], vals[j]),
                            torch.maximum(vals[i], vals[j]))
    return vals[mid]


def _pm_inf_fill(taps, mid):
    """Fill the invalid taps with ±inf so that the count-dependent rank
    cnt//2 of the valid values lands at the fixed index ``mid``: with
    cnt valid values, the first ``mid - cnt//2`` invalid taps get -inf,
    the rest +inf. taps: [(value, valid)]. Returns (values, cnt)."""
    cnt = sum(ok.to(torch.int32) for _, ok in taps)
    a = mid - cnt // 2
    rank = torch.zeros_like(cnt)
    vals = []
    for v, ok in taps:
        fill = torch.where(rank < a, -torch.inf, torch.inf)
        vals.append(torch.where(ok, v, fill))
        rank = rank + (~ok).to(torch.int32)
    return vals, cnt


def interpolate_mismatch(d0: torch.Tensor, outlier: torch.Tensor
                         ) -> torch.Tensor:
    """Fill mismatched pixels with the upper median of the first
    non-mismatch disparities along 16 rays. A ray lands on the first
    probe that is out of frame (no value) or not a mismatch (d0 there).
    The kernel (a walk of each ray) on CUDA tensors, the plain version on
    CPU tensors."""
    if not d0.is_cuda:
        return interpolate_mismatch_plain(d0, outlier)
    return _fill("mismatch_fill", d0, outlier)


def interpolate_mismatch_plain(d0: torch.Tensor, outlier: torch.Tensor
                               ) -> torch.Tensor:
    """Each ray resolved by pointer doubling over log2(extent) rounds of
    whole-image shifts."""
    H, W = d0.shape
    dev = d0.device
    is_mm = outlier == MISMATCH
    not_mm = ~is_mm
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    ones = torch.ones((H, W), dtype=torch.bool, device=dev)

    def check(dy, dx, excl_y=False, excl_x=False):
        """Single-probe state (done, has, val) at offset (dy, dx); a
        probe at row/column 0 of a negative-half direction's odd step
        is really at -0.5, out of frame."""
        inside = _shift_state(ones, dy, dx, False)
        if excl_y:
            inside = inside & (ys + dy != 0)
        if excl_x:
            inside = inside & (xs + dx != 0)
        nm = _shift_state(not_mm, dy, dx, True)
        val = _shift_state(d0, dy, dx, 0.0)
        has = nm & inside
        return nm | ~inside, has, torch.where(has, val, 0.0)

    def compose(a, b):
        (da, ha, va), (db, hb, vb) = a, b
        return da | db, torch.where(da, ha, hb), torch.where(da, va, vb)

    taps = []
    n_rounds = math.ceil(math.log2(max(H, W))) + 1
    for fdx, fdy in _RAY_DIRS:
        u1 = (_half_up(fdy), _half_up(fdx))
        u2 = (_half_up(2 * fdy), _half_up(2 * fdx))
        half = abs(fdx) == 0.5 or abs(fdy) == 0.5
        state = check(*u1, excl_y=fdy == -0.5, excl_x=fdx == -0.5)
        jy, jx = u2 if half else u1
        if half:
            state = compose(state, check(*u2))
        for _ in range(n_rounds):
            shifted = tuple(_shift_state(s, jy, jx, f)
                            for s, f in zip(state, (True, False, 0.0)))
            state = compose(state, shifted)
            jy, jx = 2 * jy, 2 * jx
        _, has, val = state
        taps.append((val, has))
    mid = len(_RAY_DIRS) // 2
    vals, cnt = _pm_inf_fill(taps, mid)
    fill = torch.where(cnt > 0, _select_mid(vals, mid), d0)
    return torch.where(is_mm, fill, d0)


def subpixel_enhancement(d0: torch.Tensor, vol: torch.Tensor, disp_max: int
                         ) -> torch.Tensor:
    """Parabola fit over the costs at d-1, d, d+1 (adcensus.cu:1205-1219)
    for the disparity-major volume (D, H, W) of the generic lane, whose
    sums are divided by 4: the threshold is the reference's
    ``denom > 1e-5``. NaN neighbours keep d. The kernel reads the volume
    in place through its strides on CUDA tensors; the plain version runs
    on CPU tensors."""
    if not d0.is_cuda:
        return subpixel_enhancement_plain(d0, vol, disp_max)
    return _subpixel(d0, vol.permute(1, 2, 0), disp_max, 1e-5, False)


def subpixel_enhancement_plain(d0: torch.Tensor, vol: torch.Tensor,
                               disp_max: int) -> torch.Tensor:
    """The parabola on the (H, W, D) view of the (D, H, W) volume."""
    return _subpixel_plain(d0, vol.permute(1, 2, 0), disp_max, 1e-5)


def subpixel_enhancement_hwd(d0: torch.Tensor, vol: torch.Tensor,
                             disp_max: int, denom_thresh: float = 1e-5,
                             xrev: bool = False) -> torch.Tensor:
    """Parabola fit over the costs at d-1, d, d+1 (adcensus.cu:1205-1219)
    for the disparity-minor volume (H, Wp, Dp). With ``xrev`` false, d0
    is (H, Wp) in the volume's storage order; with ``xrev`` true, d0 is
    the (H, W) map in natural order and the volume's columns are
    x-reversed: out[y, x] reads vol[y, W - 1 - x]. NaN neighbours keep d
    (the denominator compare fails). ``denom_thresh`` 4e-5 for an
    undivided 4-sweep SGM sum: the samples are then exactly 4x the
    reference's and only the threshold scales. A 16-bit volume's samples
    are widened to float32 before the parabola
    (mccnn_tpu/ops/post.py:390-406). The kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if not d0.is_cuda:
        return subpixel_enhancement_hwd_plain(d0, vol, disp_max, denom_thresh,
                                              xrev)
    return _subpixel(d0, vol, disp_max, denom_thresh, xrev)


def subpixel_enhancement_hwd_plain(d0: torch.Tensor, vol: torch.Tensor,
                                   disp_max: int, denom_thresh: float = 1e-5,
                                   xrev: bool = False) -> torch.Tensor:
    """The parabola in storage order; with ``xrev`` on the map flipped
    and the volume's first W columns, flipped back."""
    if xrev:
        W = d0.shape[1]
        return _subpixel_plain(d0.flip(1), vol[:, :W], disp_max,
                               denom_thresh).flip(1)
    return _subpixel_plain(d0, vol, disp_max, denom_thresh)


def _subpixel_plain(d0: torch.Tensor, vol: torch.Tensor, disp_max: int,
                    denom_thresh: float) -> torch.Tensor:
    """The parabola on an (H, W, Dp) volume, d0 (H, W) in its order."""
    d = d0.to(torch.int32)
    Dp = vol.shape[-1]

    def sel(offset):
        i = (d + offset).long()
        inside = (i >= 0) & (i < Dp)
        v = vol.gather(-1, i.clamp(0, Dp - 1)[..., None])[..., 0].float()
        return torch.where(inside, v, 0.0)

    cn, cz, cp = sel(-1), sel(0), sel(1)
    denom = 2 * (cp + cn - 2 * cz)
    refined = d - torch.clamp((cp - cn) / denom, -1.0, 1.0)
    ok = (d >= 1) & (d < disp_max - 1) & (denom > denom_thresh)
    return torch.where(ok, refined, d.to(torch.float32)).to(torch.float32)


def _subpixel(d0: torch.Tensor, vol: torch.Tensor, disp_max: int,
              denom_thresh: float, xrev: bool) -> torch.Tensor:
    """Launch the subpixel kernel: d0 (H, W), vol (H, >= W if ``xrev``
    else W, Dp) read in place through its strides."""
    (d0,) = _maps("subpixel d0", d0)
    H, W = d0.shape
    code = STORAGE.get(vol.dtype)
    if not vol.is_cuda or vol.device != d0.device or code is None:
        raise ValueError(f"subpixel: expected a float32, bfloat16 or float16 "
                         f"volume on {d0.device}, got {vol.dtype} on "
                         f"{vol.device}")
    if (vol.dim() != 3 or vol.shape[0] != H
            or not (vol.shape[1] >= W if xrev else vol.shape[1] == W)):
        raise ValueError(f"subpixel: bad shapes {tuple(d0.shape)}, "
                         f"{tuple(vol.shape)} (xrev={xrev})")
    out = torch.empty_like(d0)
    rc = _lib().subpixel_launch(
        d0.data_ptr(), vol.data_ptr(), out.data_ptr(), H, W, *vol.stride(),
        vol.shape[2], code, int(xrev), int(disp_max), denom_thresh,
        _build.stream(d0))
    _build.check_launch(rc, "subpixel")
    _build.count("subpixel")
    return out


def median2d(img: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """k×k median with boundary-clipped windows: sorted(in-frame
    values)[count/2]. The 5×5 kernel on CUDA tensors (another
    ``kernel_size`` there raises ValueError; see the module docstring for
    which outputs run which network), the plain version on CPU
    tensors."""
    if not img.is_cuda:
        return median2d_plain(img, kernel_size)
    if kernel_size != 5:
        raise ValueError(f"median2d: the kernel takes kernel_size 5, got "
                         f"{kernel_size}")
    (img,) = _maps("median5", img)
    H, W = img.shape
    out = torch.empty_like(img)
    rc = _lib().median5_launch(img.data_ptr(), out.data_ptr(), H, W,
                               _build.stream(img))
    _build.check_launch(rc, "median5")
    _build.count("median5")
    return out


def median2d_plain(img: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """The median read at a fixed index after a ±inf fill of the
    out-of-frame taps, through a pruned selection network."""
    if kernel_size % 2 != 1 or kernel_size > 11:
        raise ValueError(f"median2d: odd kernel_size <= 11, got {kernel_size}")
    r = kernel_size // 2
    H, W = img.shape
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    taps = []
    for dx in range(-r, r + 1):  # xx outer, as adcensus.cu:1584-1590
        for dy in range(-r, r + 1):
            v = torch.roll(img, (-dy, -dx), (0, 1))
            ok = ((ys + dy >= 0) & (ys + dy < H)
                  & (xs + dx >= 0) & (xs + dx < W))
            taps.append((v, ok))
    mid = (kernel_size * kernel_size) // 2
    vals, _ = _pm_inf_fill(taps, mid)
    return _select_mid(vals, mid)
