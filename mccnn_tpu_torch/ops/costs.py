"""Matching costs in the disparity-major (D, H, W) layout (absolute
difference, census, the fast arch's dot product) and winner-take-all.

Conventions (as in the JAX package): grayscale images are (H, W),
feature maps (H, W, C), cost volumes float32, lower is better, NaN where
the match pixel leaves the frame; direction -1 is the left-referenced
volume (match at x - d), +1 the right-referenced one. Reference
kernels: ``ad`` adcensus.cu:62-114, ``census`` adcensus.cu:117-175,
``StereoJoin`` adcensus.cu:1455-1498, fix_border main.lua:922-927.

These are plain torch, as the JAX package leaves them to XLA
(mccnn_tpu/ops/costs.py); the disparity-major join is the oracle the
disparity-minor one (:mod:`mccnn_tpu_torch.ops.join`) is held to.
"""

from __future__ import annotations

import torch

CHUNK = 16  # disparities per pass of ad_volume and census_volume


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
    x + d*direction leaves the frame. x0, x1: (H, W)."""
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


_WORD = 41  # census bits per int64 word: the sign bit stays clear


def _census_bits(x: torch.Tensor, radius: int):
    """Census transform of one (H, W) image, packed: (bits, valid), each
    (n_words, H, W) int64 with bit k % 41 of word k // 41 for neighbour
    (dy, dx) = divmod(k, 2r+1) - r. ``bits`` holds x[neighbour] <
    x[centre] (adcensus.cu:138), ``valid`` whether the neighbour is in
    frame; ``torch.roll`` wraps, and the wrapped neighbours are masked
    by ``valid`` as in the JAX package."""
    H, W = x.shape
    w = 2 * radius + 1
    n_words = -(-w * w // _WORD)
    bits = torch.zeros((n_words, H, W), dtype=torch.int64, device=x.device)
    valid = torch.zeros_like(bits)
    ys = torch.arange(H, device=x.device)
    xs = torch.arange(W, device=x.device)
    for k in range(w * w):
        dy, dx = divmod(k, w)
        dy -= radius
        dx -= radius
        shifted = torch.roll(x, (-dy, -dx), (0, 1))
        ok = (((ys + dy >= 0) & (ys + dy < H))[:, None]
              & ((xs + dx >= 0) & (xs + dx < W))[None, :])
        word, off = divmod(k, _WORD)
        bits[word] |= ((shifted < x) & ok).to(torch.int64) << off
        valid[word] |= ok.to(torch.int64) << off
    return bits, valid


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


def census_volume(x0: torch.Tensor, x1: torch.Tensor, disp_max: int,
                  direction: int, radius: int = 4) -> torch.Tensor:
    """Census cost (adcensus.cu:117-153): the hamming distance between
    the (2r+1)^2 census signatures of x0[y, x] and x1[y, x + d*direction],
    plus one for every window position where x, x + d*direction or y
    leaves the frame; NaN where the centre match leaves the frame.
    Images are (H, W) or (C, H, W); the cost is the mean over channels.

    With v the positions valid on both sides and m the mismatching bits,
    the distance popcount(m & v) + n - popcount(v) is computed as
    n - popcount(v & ~m): one count, the same integer. The mean over
    channels multiplies by the float32 reciprocal of C, as XLA compiles
    the JAX package's division by that constant, so the costs are equal
    bit for bit (C = 1 changes nothing)."""
    if x0.dim() == 2:
        x0, x1 = x0[None], x1[None]
    C, H, W = x0.shape
    n = (2 * radius + 1) ** 2
    b0, v0 = (torch.stack(t) for t in zip(*(_census_bits(im, radius)
                                             for im in x0)))  # (C, words, H, W)
    b1, v1 = (torch.stack(t) for t in zip(*(_census_bits(im, radius)
                                             for im in x1)))
    b0, v0 = b0[:, :, :, None, :], v0[:, :, :, None, :]
    xs = torch.arange(W, device=x0.device)
    recip = (torch.ones((), dtype=torch.float32) / C).item()
    out = torch.empty((disp_max, H, W), dtype=torch.float32, device=x0.device)
    for d0 in range(0, disp_max, CHUNK):
        deltas = torch.arange(d0, min(disp_max, d0 + CHUNK),
                              device=x0.device) * direction
        agree = v0 & _shift_x(v1, deltas) & ~(b0 ^ _shift_x(b1, deltas))
        dist = n - _popcount(agree).sum(1)                   # (C, H, n, W)
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


def fix_border(vol: torch.Tensor, direction: int, n: int) -> torch.Tensor:
    """Replicate the first valid column over the CNN's half-window
    border: direction -1 fixes the last n columns from column W-1-n,
    +1 the first n columns from column n. vol is (D, H, W)."""
    if n <= 0:
        return vol
    W = vol.shape[-1]
    out = vol.clone()
    if direction == -1:
        out[..., W - n:] = vol[..., W - 1 - n:W - n]
    else:
        out[..., :n] = vol[..., n:n + 1]
    return out


def wta(vol: torch.Tensor) -> torch.Tensor:
    """Argmin over disparity (axis 0) as float (H, W), NaN never wins,
    ties to the lowest disparity (main.lua:1049-1050)."""
    clean = torch.where(torch.isnan(vol), torch.inf, vol)
    return torch.argmin(clean, dim=0).to(torch.float32)


def wta_hwd(vol: torch.Tensor) -> torch.Tensor:
    """:func:`wta` for the disparity-minor (H, W, Dp) layout: argmin over
    the last axis; all-NaN columns (padding) give 0."""
    clean = torch.where(torch.isnan(vol), torch.inf, vol)
    return torch.argmin(clean, dim=-1).to(torch.float32)
