"""KITTI 16-bit disparity PNG IO.

Matches the reference codec (adcensus.cu:1670-1705): disparities are
stored as uint16 at 256× scale; the value 0 means "invalid". Uses PIL
instead of png++, imported inside the functions so that the package
imports on machines without it.
"""

from __future__ import annotations

import numpy as np


def read_png16(fname: str) -> np.ndarray:
    """Read a KITTI disparity PNG -> float32 (H, W); 0 stays 0 (invalid),
    everything else is val/256 (adcensus.cu:1679-1688)."""
    from PIL import Image

    img = np.asarray(Image.open(fname), dtype=np.float32)
    if img.ndim != 2:
        raise ValueError(f"{fname}: expected single-channel 16-bit PNG")
    return np.where(img == 0, 0.0, img / 256.0).astype(np.float32)


def write_png16(disp: np.ndarray, fname: str) -> None:
    """Write float32 disparity -> uint16 PNG at 256× scale; values below
    1e-5 map to 0 = invalid (adcensus.cu:1690-1705)."""
    from PIL import Image

    disp = np.asarray(disp, dtype=np.float32)
    out = np.where(disp < 1e-5, 0, (disp * 256.0)).astype(np.uint16)
    Image.fromarray(out, mode="I;16").save(fname)
