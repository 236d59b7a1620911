"""Image loading and standardization for predict mode, and the jet
colormap of the evaluation's debug dumps.

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


def grey2jet(x: np.ndarray) -> np.ndarray:
    """Jet colormap for debug dumps (adcensus.cu:2001-2053): input in
    [0, 1] -> (H, W, 3) float in [0, 1]."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0) * 4
    r = np.clip(np.minimum(x - 1.5, -x + 4.5), 0, 1)
    g = np.clip(np.minimum(x - 0.5, -x + 3.5), 0, 1)
    b = np.clip(np.minimum(x + 0.5, -x + 2.5), 0, 1)
    return np.stack([r, g, b], axis=-1).astype(np.float32)
