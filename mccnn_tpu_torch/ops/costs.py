"""Matching costs in the disparity-major (D, H, W) layout (absolute
difference, census, the fast arch's dot product) and winner-take-all.

Conventions (as in the JAX package): grayscale images are (H, W),
feature maps (H, W, C), cost volumes float32, lower is better, NaN where
the match pixel leaves the frame; direction -1 is the left-referenced
volume (match at x - d), +1 the right-referenced one. Reference
kernels: ``ad`` adcensus.cu:62-114, ``census`` adcensus.cu:117-175,
``StereoJoin`` adcensus.cu:1455-1498, fix_border main.lua:922-927.

The JAX package leaves these to XLA (mccnn_tpu/ops/costs.py). On CUDA
tensors :func:`census_signatures`, :func:`census_volume` and
:func:`ad_volume` launch their kernels of ``csrc/costs.cu`` (one launch
a call; a ``census_volume`` not handed its signatures computes them
first, two launches); on CPU tensors they run their plain versions, the
``*_plain`` functions beside them, which give the same bits: the census
distances are integers, the ad box sums add the same terms in the same
order. The kernels take a radius up to :data:`MAX_RADIUS`. The
disparity-major join is the oracle the disparity-minor one
(:mod:`mccnn_tpu_torch.ops.join`) is held to.
"""

from __future__ import annotations

import ctypes

import torch

from mccnn_tpu_torch.ops import _build, sgm

CHUNK = 16  # disparities per pass of the plain ad and census volumes
# the largest census / ad radius of the kernels: 225 window positions,
# four 64-bit words (csrc/costs.cu)
MAX_RADIUS = 7
_WORD = 64  # census bits per signature word


def census_words(radius: int) -> int:
    """The 64-bit words of one census signature at ``radius``."""
    return -(-(2 * radius + 1) ** 2 // _WORD)


def _lib():
    lib = _build.library("costs")
    if lib.census_volume_launch.argtypes is None:
        lib.census_signatures_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.census_volume_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_void_p])
        lib.ad_volume_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        for fn in (lib.census_signatures_launch, lib.census_volume_launch,
                   lib.ad_volume_launch):
            fn.restype = ctypes.c_int
    return lib


def _check_radius(radius: int, what: str) -> None:
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{what}: radius {radius} outside [0, {MAX_RADIUS}] "
                         "(the kernel's signature words)")


def _check_direction(direction: int, what: str) -> None:
    if direction not in (-1, 1):
        raise ValueError(f"{what}: direction {direction}, expected -1 or +1 "
                         "(the kernel stages the span of one sign)")


def _check_pair(x0: torch.Tensor, x1: torch.Tensor, what: str) -> None:
    _build.check_cuda_f32(x0, f"{what} x0")
    _build.check_cuda_f32(x1, f"{what} x1")
    if x0.shape != x1.shape or x0.device != x1.device:
        raise ValueError(f"{what}: images {tuple(x0.shape)} on {x0.device} "
                         f"and {tuple(x1.shape)} on {x1.device}")


def _shift_x(img: torch.Tensor, deltas: torch.Tensor, fill=0):
    """out[..., i, x] = img[..., x + deltas[i]], ``fill`` where that
    leaves the frame: one more axis, before the last, for the shifts."""
    W = img.shape[-1]
    idx = torch.arange(W, device=img.device)[None, :] + deltas[:, None]
    valid = (idx >= 0) & (idx < W)
    return torch.where(valid, img[..., idx.clamp(0, W - 1)], fill)


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 box sum over the last two axes with zero padding outside
    the frame, separable: along x, then along y, each as 2r+1 slice
    adds."""
    w = 2 * radius + 1
    H, W = x.shape[-2:]
    p = torch.nn.functional.pad(x, (radius, radius))
    x = p[..., 0:W].clone()
    for k in range(1, w):
        x += p[..., k:k + W]
    p = torch.nn.functional.pad(x, (0, 0, radius, radius))
    x = p[..., 0:H, :].clone()
    for k in range(1, w):
        x += p[..., k:k + H, :]
    return x


def ad_volume(x0: torch.Tensor, x1: torch.Tensor, disp_max: int,
              direction: int, radius: int = 4) -> torch.Tensor:
    """Absolute-difference cost: the mean of |x0 - shift(x1)| over a
    (2r+1)^2 window, counting only the window positions where both x and
    x + d*direction are in frame (adcensus.cu:62-93); NaN where
    x + d*direction leaves the frame. x0, x1: (H, W). The kernel on CUDA
    images, :func:`ad_volume_plain` on CPU ones."""
    if not x0.is_cuda:
        return ad_volume_plain(x0, x1, disp_max, direction, radius)
    x0, x1 = x0.contiguous(), x1.contiguous()
    _check_pair(x0, x1, "ad_volume")
    _check_radius(radius, "ad_volume")
    _check_direction(direction, "ad_volume")
    if x0.dim() != 2:
        raise ValueError(f"ad_volume: expected (H, W) images, got "
                         f"{tuple(x0.shape)}")
    H, W = x0.shape
    D = int(disp_max)
    out = torch.empty((D, H, W), dtype=torch.float32, device=x0.device)
    if out.numel():
        rc = _lib().ad_volume_launch(x0.data_ptr(), x1.data_ptr(),
                                     out.data_ptr(), H, W, D, int(direction),
                                     int(radius), _build.stream(x0))
        _build.check_launch(rc, "ad_volume")
        _build.count("ad_volume")
    return out


def ad_volume_plain(x0: torch.Tensor, x1: torch.Tensor, disp_max: int,
                    direction: int, radius: int = 4) -> torch.Tensor:
    """:func:`ad_volume` in chunks of disparities: the terms
    |x0 - x1s| * valid box-summed by :func:`_box_sum` (each row's
    horizontal sum from its leftmost tap, then the row sums from the
    top), the count of valid positions likewise, then ``num / cnt``."""
    H, W = x0.shape
    xs = torch.arange(W, device=x0.device)
    out = torch.empty((disp_max, H, W), dtype=torch.float32, device=x0.device)
    for d0 in range(0, disp_max, CHUNK):
        deltas = torch.arange(d0, min(disp_max, d0 + CHUNK),
                              device=x0.device) * direction
        ok = (xs + deltas[:, None] >= 0) & (xs + deltas[:, None] < W)
        valid = ok[:, None, :].expand(-1, H, W).to(x0.dtype)  # (n, H, W)
        x1s = _shift_x(x1, deltas).permute(1, 0, 2)           # (n, H, W)
        num = _box_sum((x0 - x1s).abs() * valid, radius)
        cnt = _box_sum(valid, radius)
        out[d0:d0 + len(deltas)] = torch.where(valid > 0, num / cnt, torch.nan)
    return out


def _window(H: int, W: int, radius: int, device):
    """Each census window position k in row-major order: (word, bit, dy,
    dx, ok), bit k % 64 of word k // 64, ``ok`` the (H, W) mask of the
    pixels whose neighbour (y + dy, x + dx) lies in the frame."""
    w = 2 * radius + 1
    ys = torch.arange(H, device=device)
    xs = torch.arange(W, device=device)
    for k in range(w * w):
        dy, dx = divmod(k, w)
        dy -= radius
        dx -= radius
        ok = (((ys + dy >= 0) & (ys + dy < H))[:, None]
              & ((xs + dx >= 0) & (xs + dx < W))[None, :])
        yield (*divmod(k, _WORD), dy, dx, ok)


def _census_bits(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Census transform of one (H, W) image, packed: (n_words, H, W)
    int64 with bit k % 64 of word k // 64 for neighbour (dy, dx) =
    divmod(k, 2r+1) - r set where x[neighbour] < x[centre]
    (adcensus.cu:138) and the neighbour lies in the frame;
    ``torch.roll`` wraps, and the wrapped neighbours are masked as in
    the JAX package. Bit 63 is the int64's sign bit: count the words with
    :func:`_popcount64`."""
    H, W = x.shape
    bits = torch.zeros((census_words(radius), H, W), dtype=torch.int64,
                       device=x.device)
    for word, off, dy, dx, ok in _window(H, W, radius, x.device):
        shifted = torch.roll(x, (-dy, -dx), (0, 1))
        bits[word] |= ((shifted < x) & ok).to(torch.int64) << off
    return bits


def _census_valid(H: int, W: int, radius: int, device) -> torch.Tensor:
    """The in-frame words of an H x W frame: (n_words, H, W) int64, bit
    k set where window position k of the pixel lies in the frame (the
    JAX package's ``valid``). They depend on the frame alone, so the
    signatures do not carry them."""
    valid = torch.zeros((census_words(radius), H, W), dtype=torch.int64,
                        device=device)
    for word, off, _, _, ok in _window(H, W, radius, device):
        valid[word] |= ok.to(torch.int64) << off
    return valid


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int64 (torch has no population
    count): pairwise field sums. ``>>`` is arithmetic on int64, which is
    the logical shift while the sign bit is clear."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 as 64 bits, the sign bit included: the two
    32-bit halves counted apart (``& 0xFFFFFFFF`` clears the high half
    that the arithmetic shift fills with the sign)."""
    return _popcount(x & 0xFFFFFFFF) + _popcount((x >> 32) & 0xFFFFFFFF)


def _as_chw(x0: torch.Tensor, x1: torch.Tensor):
    return (x0[None], x1[None]) if x0.dim() == 2 else (x0, x1)


def census_signatures(x0: torch.Tensor, x1: torch.Tensor, radius: int = 4
                      ) -> torch.Tensor:
    """Both images' census signatures, once for every volume of a pair:
    an int64 (2, C, H, W, nw) tensor, x0's then x1's, nw =
    :func:`census_words` (radius), each pixel's :func:`_census_bits`
    words. Images (H, W) (C = 1) or (C, H, W). The kernel on CUDA
    images, :func:`census_signatures_plain` on CPU ones."""
    x0, x1 = _as_chw(x0, x1)
    if not x0.is_cuda:
        return census_signatures_plain(x0, x1, radius)
    x0, x1 = x0.contiguous(), x1.contiguous()
    _check_pair(x0, x1, "census_signatures")
    _check_radius(radius, "census_signatures")
    C, H, W = x0.shape
    out = torch.empty((2, C, H, W, census_words(radius)), dtype=torch.int64,
                      device=x0.device)
    if out.numel():
        rc = _lib().census_signatures_launch(x0.data_ptr(), x1.data_ptr(),
                                             out.data_ptr(), C, H, W,
                                             int(radius), _build.stream(x0))
        _build.check_launch(rc, "census_signatures")
        _build.count("census_signatures")
    return out


def census_signatures_plain(x0: torch.Tensor, x1: torch.Tensor,
                            radius: int = 4) -> torch.Tensor:
    """:func:`census_signatures` from :func:`_census_bits` of each
    channel of each image."""
    x0, x1 = _as_chw(x0, x1)
    C, H, W = x0.shape
    sigs = [_census_bits(im, radius).permute(1, 2, 0)
            for im in torch.cat([x0, x1])]  # (H, W, nw) each
    return torch.stack(sigs).reshape(2, C, H, W, census_words(radius))


def census_volume(x0: torch.Tensor, x1: torch.Tensor, disp_max: int,
                  direction: int, radius: int = 4, *, signatures=None
                  ) -> torch.Tensor:
    """Census cost (adcensus.cu:117-153): the hamming distance between
    the (2r+1)^2 census signatures of x0[y, x] and x1[y, x + d*direction],
    plus one for every window position where x, x + d*direction or y
    leaves the frame; NaN where the centre match leaves the frame.
    Images are (H, W) or (C, H, W); the cost is the mean over channels.
    ``signatures``: (s0, s1), x0's and x1's (C, H, W, nw) signatures, the
    halves of :func:`census_signatures` of this pair at this ``radius``
    (radii with the same nw, such as 4 and 5, cannot be told apart by
    shape), computed here when not given. The kernel on CUDA images,
    :func:`census_volume_plain` on CPU ones."""
    if not x0.is_cuda:
        return census_volume_plain(x0, x1, disp_max, direction, radius,
                                   signatures=signatures)
    x0, x1 = _as_chw(x0, x1)
    _check_radius(radius, "census_volume")
    _check_direction(direction, "census_volume")
    C, H, W = x0.shape
    if signatures is None:
        sig = census_signatures(x0, x1, radius)
        signatures = sig[0], sig[1]
    nw = census_words(radius)
    want = (C, H, W, nw)
    for i, s in enumerate(signatures):
        _build.check_cuda(s, f"census_volume signatures[{i}]", torch.int64)
        if tuple(s.shape) != want or s.device != x0.device:
            raise ValueError(f"census_volume: signatures[{i}] "
                             f"{tuple(s.shape)} on {s.device}, expected "
                             f"{want} on {x0.device}")
        if nw % 2 == 0 and s.data_ptr() % 16:
            raise ValueError(f"census_volume: signatures[{i}] not 16-byte "
                             "aligned (the kernel reads word pairs)")
    D = int(disp_max)
    out = torch.empty((D, H, W), dtype=torch.float32, device=x0.device)
    if out.numel():
        rc = _lib().census_volume_launch(
            signatures[0].data_ptr(), signatures[1].data_ptr(),
            out.data_ptr(), C, H, W, D, int(direction), int(radius),
            _recip(C), _build.stream(x0))
        _build.check_launch(rc, "census_volume")
        _build.count("census_volume")
    return out


def _recip(C: int) -> float:
    """The float32 reciprocal of C, as XLA compiles the JAX package's
    division by that constant."""
    return (torch.ones((), dtype=torch.float32) / C).item()


def census_volume_plain(x0: torch.Tensor, x1: torch.Tensor, disp_max: int,
                        direction: int, radius: int = 4, *, signatures=None
                        ) -> torch.Tensor:
    """:func:`census_volume` in chunks of disparities from the packed
    signatures (:func:`census_signatures_plain` unless given).

    With v the positions valid on both sides (:func:`_census_valid`,
    of the frame alone) and m the mismatching bits, the distance
    popcount(m & v) + n - popcount(v) is computed as n - popcount(v &
    ~m): one count, the same integer. The mean over channels multiplies
    by the float32 reciprocal of C, as XLA compiles the JAX package's
    division by that constant, so the costs are equal bit for bit (C = 1
    changes nothing)."""
    x0, x1 = _as_chw(x0, x1)
    C, H, W = x0.shape
    n = (2 * radius + 1) ** 2
    if signatures is None:
        sig = census_signatures_plain(x0, x1, radius)
        signatures = sig[0], sig[1]
    # (C, nw, H, W) words of each image; x0's with an axis for the shifts
    b0, b1 = (s.permute(0, 3, 1, 2) for s in signatures)
    b0 = b0[:, :, :, None, :]
    valid = _census_valid(H, W, radius, x0.device)         # (nw, H, W)
    v0 = valid[:, :, None, :]
    xs = torch.arange(W, device=x0.device)
    recip = _recip(C)
    out = torch.empty((disp_max, H, W), dtype=torch.float32, device=x0.device)
    for d0 in range(0, disp_max, CHUNK):
        deltas = torch.arange(d0, min(disp_max, d0 + CHUNK),
                              device=x0.device) * direction
        agree = v0 & _shift_x(valid, deltas) & ~(b0 ^ _shift_x(b1, deltas))
        dist = n - _popcount64(agree).sum(1)                 # (C, H, n, W)
        dist = dist.to(torch.float32).sum(0) * recip         # (H, n, W)
        ok = (xs + deltas[:, None] >= 0) & (xs + deltas[:, None] < W)
        out[d0:d0 + len(deltas)] = torch.where(ok[None], dist,
                                               torch.nan).permute(1, 0, 2)
    return out


def stereo_join(feat_l: torch.Tensor, feat_r: torch.Tensor, disp_max: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """vol_L[d, y, x] = -<feat_l[y, x], feat_r[y, x-d]> and
    vol_R[d, y, x] = vol_L[d, y, x+d], NaN out of frame."""
    H, W, _ = feat_l.shape
    vol_l = torch.full((disp_max, H, W), float("nan"), dtype=torch.float32,
                       device=feat_l.device)
    vol_r = torch.full_like(vol_l, float("nan"))
    for d in range(min(disp_max, W)):
        s = -(feat_l[:, d:, :] * feat_r[:, :W - d, :]).sum(-1)  # x in [d, W)
        vol_l[d, :, d:] = s
        vol_r[d, :, :W - d] = s
    return vol_l, vol_r


def fix_border(vol: torch.Tensor, direction: int, n: int,
               inplace: bool = False) -> torch.Tensor:
    """Replicate the first valid column over the CNN's half-window
    border: direction -1 fixes the last n columns from column W-1-n,
    +1 the first n columns from column n. vol is (D, H, W). A new volume,
    or with ``inplace`` (a caller that owns ``vol``) ``vol`` itself with
    its n border columns overwritten."""
    if n <= 0:
        return vol
    W = vol.shape[-1]
    out = vol if inplace else vol.clone()
    if direction == -1:
        out[..., W - n:] = vol[..., W - 1 - n:W - n]
    else:
        out[..., :n] = vol[..., n:n + 1]
    return out


def wta(vol: torch.Tensor) -> torch.Tensor:
    """Argmin over disparity (axis 0) as float (H, W), NaN never wins,
    ties to the lowest disparity (main.lua:1049-1050). The kernel of
    ``csrc/sgm_layout.cu`` (entry ``wta_dhw``) on a CUDA volume, float32
    and contiguous; :func:`wta_plain` on a CPU one."""
    if not vol.is_cuda:
        return wta_plain(vol)
    _build.check_cuda_f32(vol, "wta vol")
    if vol.dim() != 3 or vol.shape[0] < 1 or vol.shape[1] > 65535:
        raise ValueError(f"wta: expected a (D, H, W) volume with D >= 1, got "
                         f"{tuple(vol.shape)}")
    D, H, W = vol.shape
    out = torch.empty((H, W), dtype=torch.float32, device=vol.device)
    if out.numel():
        rc = sgm._layout_lib().wta_dhw_launch(vol.data_ptr(), out.data_ptr(),
                                              D, H, W, _build.stream(vol))
        _build.check_launch(rc, "wta_dhw")
        _build.count("wta_dhw")
    return out


def wta_plain(vol: torch.Tensor) -> torch.Tensor:
    """:func:`wta` as ``torch.argmin`` of the volume with NaN replaced by
    +inf."""
    clean = torch.where(torch.isnan(vol), torch.inf, vol)
    return torch.argmin(clean, dim=0).to(torch.float32)


def wta_hwd(vol: torch.Tensor) -> torch.Tensor:
    """:func:`wta` for the disparity-minor (H, W, Dp) layout: argmin over
    the last axis; all-NaN columns (padding) give 0."""
    clean = torch.where(torch.isnan(vol), torch.inf, vol)
    return torch.argmin(clean, dim=-1).to(torch.float32)
