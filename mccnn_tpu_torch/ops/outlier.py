"""Left-right consistency labels (outlier_detection, adcensus.cu:878-918).

Per left-map pixel: MATCH (0) if |d0(x) - d1(x - d0(x))| < 1.1, else
MISMATCH (2) if any d has |d - d1(x - d)| < 1.1, else OCCLUSION (1);
pixels whose match column leaves the frame are OCCLUSION.

On CUDA tensors :func:`outlier_detection` launches ``csrc/outlier.cu``;
on CPU tensors it runs :func:`outlier_detection_plain`.
"""

from __future__ import annotations

import ctypes

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


def _lib():
    lib = _build.library("outlier")
    if lib.outlier_launch.argtypes is None:
        lib.outlier_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.outlier_launch.restype = ctypes.c_int
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
    if d0.dim() != 2 or d0.shape != d1.shape or d0.shape[1] * 4 > 232448:
        raise ValueError(f"outlier: bad shapes {tuple(d0.shape)}, "
                         f"{tuple(d1.shape)}")
    H, W = d0.shape
    out = torch.empty_like(d0)
    rc = _lib().outlier_launch(d0.data_ptr(), d1.data_ptr(), out.data_ptr(),
                               H, W, int(disp_max), _build.stream(d0))
    _build.check_launch(rc, "outlier")
    _build.count("outlier")
    return out
