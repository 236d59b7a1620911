"""Image loading and standardization for predict mode.

Matches the reference's predict-mode preprocessing (main.lua:1085-1096):
byte-range load, rgb2y for color inputs, per-image standardization.
PIL is imported inside ``load_gray`` only, so that the package imports
on machines without it.
"""

from __future__ import annotations

import numpy as np

# ITU-R 601 luma, the torch image.rgb2y convention
_RGB2Y = np.array([0.299, 0.587, 0.114], np.float32)


def load_gray(fname: str) -> np.ndarray:
    """Load a PNG as float32 (H, W) in byte range [0, 255]; color inputs
    are converted with rgb2y (main.lua:1088-1092)."""
    from PIL import Image

    img = np.asarray(Image.open(fname), dtype=np.float32)
    if img.ndim == 3:
        img = img[..., :3] @ _RGB2Y
    return img


def standardize(img: np.ndarray) -> np.ndarray:
    """Zero-mean unit-std per image (main.lua:1095-1096). Uses the
    unbiased (n-1) std to match torch std()."""
    return ((img - img.mean()) / img.std(ddof=1)).astype(np.float32)
