"""Thresholded-Gaussian blur (mean2d, adcensus.cu:1241-1261).

Weighted mean over a k×k Gaussian window, excluding neighbours whose
value differs from the centre pixel by >= alpha2 (``-blur_t``),
boundary-clipped. Inputs must be finite (disparity maps are).

On CUDA tensors :func:`mean2d` launches ``csrc/blur.cu``; on CPU
tensors it runs :func:`mean2d_plain`. The kernel stages a block's input
halo and the weights in shared memory (:func:`smem_bytes`), which bounds
the kernel size it takes.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from mccnn_tpu_torch.ops import _build


def gaussian_kernel(sigma: float) -> np.ndarray:
    """Host-side Gaussian (main.lua:528-540): radius ceil(3σ),
    unnormalized exp(-(x²+y²)/2σ²)."""
    kr = math.ceil(sigma * 3)
    y, x = np.mgrid[-kr:kr + 1, -kr:kr + 1]
    return np.exp(-(x * x + y * y) / (2.0 * sigma * sigma)).astype(np.float32)


def mean2d_plain(img: torch.Tensor, kernel: torch.Tensor, alpha2: float
                 ) -> torch.Tensor:
    """The blur as k*k shifted masked adds on a NaN-padded image (NaN
    taps fail the threshold compare), kernel rows outer."""
    ksz = kernel.shape[0]
    r = ksz // 2
    H, W = img.shape
    pad = torch.nn.functional.pad(img, (r, r, r, r), value=torch.nan)
    acc = torch.zeros_like(img)
    cnt = torch.zeros_like(img)
    for dy in range(ksz):
        for dx in range(ksz):
            win = pad[dy:dy + H, dx:dx + W]
            ok = (win - img).abs() < alpha2
            w = torch.where(ok, kernel[dy, dx], 0.0)
            acc = acc + w * torch.where(ok, win, 0.0)
            cnt = cnt + w
    return acc / cnt


# the blur kernel's tile (TX * P and TY in csrc/blur.cu): BLUR_ROWS rows of
# BLUR_COLS columns a block
BLUR_COLS = 256
BLUR_ROWS = 8


def smem_bytes(ksz: int) -> int:
    """The dynamic shared memory the blur kernel takes for a k x k
    kernel (``smem_bytes`` in csrc/blur.cu, which the C entry
    ``blur_smem_bytes`` returns): the input halo, BLUR_ROWS + k - 1 rows
    of BLUR_COLS + kw values, and the k x kw weights, kw = k rounded up
    to a multiple of 4."""
    kw = -(-ksz // 4) * 4
    return ((BLUR_ROWS + ksz - 1) * (BLUR_COLS + kw) + ksz * kw) * 4


def _lib():
    lib = _build.library("blur")
    if lib.blur_launch.argtypes is None:
        lib.blur_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p])
        lib.blur_launch.restype = ctypes.c_int
        lib.blur_smem_bytes.argtypes = [ctypes.c_int]
        lib.blur_smem_bytes.restype = ctypes.c_int
    return lib


def mean2d(img: torch.Tensor, kernel: torch.Tensor, alpha2: float
           ) -> torch.Tensor:
    """(H, W) blurred map: the kernel on CUDA tensors, the plain version
    on CPU tensors. ``kernel`` is (k, k) with k odd."""
    kernel = torch.as_tensor(kernel, dtype=torch.float32, device=img.device)
    ksz = kernel.shape[0]
    if kernel.shape != (ksz, ksz) or ksz % 2 != 1:
        raise ValueError(f"blur: kernel must be k x k, k odd; got "
                         f"{tuple(kernel.shape)}")
    if not img.is_cuda:
        return mean2d_plain(img, kernel, alpha2)
    img = img.contiguous()
    kernel = kernel.contiguous()
    for t, what in ((img, "blur img"), (kernel, "blur kernel")):
        _build.check_cuda_f32(t, what)
    if img.dim() != 2 or smem_bytes(ksz) > _build.MAX_SMEM:
        raise ValueError(f"blur: bad shapes img {tuple(img.shape)}, k={ksz}")
    H, W = img.shape
    out = torch.empty_like(img)
    rc = _lib().blur_launch(img.data_ptr(), kernel.data_ptr(), out.data_ptr(),
                            H, W, ksz, float(np.float32(alpha2)),
                            _build.stream(img))
    _build.check_launch(rc, "blur")
    _build.count("blur")
    return out
