"""Left-right consistency labels (outlier_detection, adcensus.cu:878-918).

Per left-map pixel: MATCH (0) if |d0(x) - d1(x - d0(x))| < 1.1, else
MISMATCH (2) if any d has |d - d1(x - d)| < 1.1, else OCCLUSION (1);
pixels whose match column leaves the frame are OCCLUSION.

On CUDA tensors :func:`outlier_detection` launches ``csrc/outlier.cu``;
on CPU tensors it runs :func:`outlier_detection_plain`. The kernel stages
a row of both maps and a row of flags in shared memory
(:func:`smem_bytes`), which bounds the width it takes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mccnn_tpu_torch.ops import _build

MATCH, OCCLUSION, MISMATCH = 0, 1, 2


def outlier_detection_plain(d0: torch.Tensor, d1: torch.Tensor,
                            disp_max: int) -> torch.Tensor:
    """The labels as D shifted compares of the left-inf-padded right map
    (inf fails every compare where x - d leaves the frame)."""
    H, W = d0.shape
    D = int(disp_max)
    xs = torch.arange(W, device=d0.device)[None, :]
    d0i = d0.to(torch.int32)
    off_frame = xs - d0i < 0
    pd1 = torch.nn.functional.pad(d1, (D, 0), value=torch.inf)
    exists = torch.zeros((H, W), dtype=torch.bool, device=d0.device)
    match = torch.zeros_like(exists)
    for d in range(D):
        t = pd1[:, D - d:D - d + W]
        exists |= (float(d) - t).abs() < 1.1
        match |= (d0i == d) & ((d0 - t).abs() < 1.1)
    out = torch.where(exists, MISMATCH, OCCLUSION).to(torch.float32)
    out = torch.where(match & ~off_frame, MATCH, out)
    return torch.where(off_frame, OCCLUSION, out)


def probe_maps(seed: int, H: int, W: int, D: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Seeded float32 (d0, d1) maps that probe the labels' edges: a right
    map of whole and fractional disparities, planted within 1.2 of the
    left map at its match columns, and on 40% of its pixels values at
    k +- 1.1f and one ulp either side, negative values, values at and
    past D, NaN, +-inf and 1e30; a left map of whole and fractional
    disparities, a tenth of them negative, at or past D or off the
    frame. Every value of d0 is finite (a disparity map's are)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    shape = (H, W)
    d1 = (rng.randint(0, D, shape) + rng.choice([0, .25, .5, .9], shape))
    d0 = (rng.randint(0, D, shape) + rng.choice([0, .3, .6, .95], shape))
    d0 = d0.astype(f32)
    ys, xs = np.nonzero(rng.rand(*shape) < 0.5)
    js = xs - d0[ys, xs].astype(np.int64)
    keep = js >= 0
    d1[ys[keep], js[keep]] = d0[ys[keep], xs[keep]] + rng.uniform(
        -1.2, 1.2, int(keep.sum()))
    d1 = d1.astype(f32)
    edge = (rng.randint(-2, D + 3, shape)
            + rng.choice([-1, 1], shape) * f32(1.1)).astype(f32)
    edge = np.nextafter(edge, edge + rng.choice([-1, 0, 1], shape).astype(f32))
    odd = np.array([-0.5, -7, D, D + 2.5, 1e30, np.inf, -np.inf, np.nan], f32)
    u = rng.rand(*shape)
    d1 = np.where(u < 0.3, edge, np.where(u < 0.4, rng.choice(odd, shape), d1))
    odd0 = np.array([-1.5, -0.5, D, D + 0.5, W + 3], f32)
    d0 = np.where(rng.rand(*shape) < 0.1, rng.choice(odd0, shape), d0)
    return d0.astype(f32), d1.astype(f32)


def smem_bytes(W: int) -> int:
    """The dynamic shared memory the kernel takes for rows of W columns
    (``smem_bytes`` in csrc/outlier.cu, which the C entry
    ``outlier_smem_bytes`` returns): the row of d0 and of d1, four bytes
    a column each, and a byte of flag a column."""
    return 9 * W


def _lib():
    lib = _build.library("outlier")
    if lib.outlier_launch.argtypes is None:
        lib.outlier_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.outlier_launch.restype = ctypes.c_int
        lib.outlier_smem_bytes.argtypes = [ctypes.c_int]
        lib.outlier_smem_bytes.restype = ctypes.c_int
    return lib


def outlier_detection(d0: torch.Tensor, d1: torch.Tensor, disp_max: int
                      ) -> torch.Tensor:
    """(H, W) float32 labels for the left map d0 against the right map
    d1: the kernel on CUDA tensors, the plain version on CPU tensors."""
    if not d0.is_cuda:
        return outlier_detection_plain(d0, d1, disp_max)
    d0 = d0.contiguous()
    d1 = d1.contiguous()
    for t, what in ((d0, "outlier d0"), (d1, "outlier d1")):
        _build.check_cuda_f32(t, what)
    if (d0.dim() != 2 or d0.shape != d1.shape
            or smem_bytes(d0.shape[1]) > _build.MAX_SMEM):
        raise ValueError(f"outlier: bad shapes {tuple(d0.shape)}, "
                         f"{tuple(d1.shape)}")
    H, W = d0.shape
    out = torch.empty_like(d0)
    rc = _lib().outlier_launch(d0.data_ptr(), d1.data_ptr(), out.data_ptr(),
                               H, W, int(disp_max), _build.stream(d0))
    _build.check_launch(rc, "outlier")
    _build.count("outlier")
    return out
