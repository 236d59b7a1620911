"""Fast-arch matching cost in the disparity-major (D, H, W) layout, and
winner-take-all.

Conventions (as in the JAX package): feature maps are (H, W, C), cost
volumes are float32, lower is better, NaN where the match pixel leaves
the frame; direction -1 is the left-referenced volume (match at x - d),
+1 the right-referenced one. Reference kernels: ``StereoJoin``
adcensus.cu:1455-1498, fix_border main.lua:922-927.

These are plain torch: the disparity-major form is the oracle the
disparity-minor join (:mod:`mccnn_tpu_torch.ops.join`) is held to.
"""

from __future__ import annotations

import torch


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
