"""Middlebury PFM disparity IO.

Writer matches adcensus.cu:1707-1721: grayscale ``Pf``, little-endian
(scale header ``-0.003922``), rows written top-to-bottom as stored —
the caller vflips first, as main.lua:1218 does, because PFM scanlines
are bottom-to-top.
"""

from __future__ import annotations

import re

import numpy as np


def write_pfm(img: np.ndarray, fname: str, scale: float = -0.003922) -> None:
    img = np.asarray(img, dtype=np.float32)
    if img.ndim != 2:
        raise ValueError(f"write_pfm expects an (H, W) map, got {img.shape}")
    with open(fname, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(f"{scale:g}\n".encode())
        data = img if scale < 0 else img.byteswap()
        f.write(np.ascontiguousarray(data).tobytes())


def read_pfm(fname: str) -> np.ndarray:
    """Read a (grayscale or color) PFM; returns rows in file order
    (callers flip to top-down as needed)."""
    with open(fname, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{fname}: not a PFM file")
        dims = f.readline().decode()
        m = re.match(r"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{fname}: bad PFM dims {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.fromfile(f, dtype=dtype, count=width * height * channels)
    data = data.reshape((height, width) if channels == 1 else (height, width, 3))
    return data.astype(np.float32)
