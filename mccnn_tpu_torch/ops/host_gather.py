"""The host window gather of training, on ``csrc/host_gather.cpp``.

The sampler cuts a (WIN, WIN) window around each patch's source point
out of an image on the host, zero outside the frame on every side; the
card then warps it into the patch (``train/augment.py``). The JAX
package gathers with its native module when it builds, else with numpy
(mccnn_tpu/native.py); here the C++ source is built by ``g++`` through
``ops/_build.py`` on first use, and a failed build raises with the
compiler's message: nothing falls back. Its plain version, the numpy
gather ``train/augment.py _gather_windows``, is what the tests hold it
against, bit for bit.

:func:`gather_windows` takes a stack of same-shape images and an image
index a window; :func:`gather_windows_from` one source array a window,
for the Middlebury chunks, whose images differ in shape.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mccnn_tpu_torch.ops import _build

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U64P = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _entry():
    fn = _build.library("host_gather").host_gather_windows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int64, _U64P, _I64P, _I64P, _I64P, _I64P,
                       ctypes.c_int32, _F32P, ctypes.c_int32]
        fn.restype = ctypes.c_int
    return fn


def _launch(addrs, hs, ws, oy, ox, win: int) -> np.ndarray:
    """Gather on every core (the entry's thread count 0)."""
    n = len(addrs)
    if not len(hs) == len(ws) == len(oy) == len(ox) == n or win <= 0:
        raise ValueError(f"host_gather: {n} windows, {len(oy)} / {len(ox)} "
                         f"origins, win {win}")
    out = np.empty((n, win, win), np.float32)
    rc = _entry()(n, np.ascontiguousarray(addrs, np.uint64),
                  np.ascontiguousarray(hs, np.int64),
                  np.ascontiguousarray(ws, np.int64),
                  np.ascontiguousarray(oy, np.int64),
                  np.ascontiguousarray(ox, np.int64), win, out, 0)
    if rc != 0:
        raise ValueError(f"host_gather_windows: bad arguments (code {rc})")
    return out


def gather_windows(X: np.ndarray, img, oy, ox, win: int) -> np.ndarray:
    """(n, win, win) windows X[img, 0, oy:oy+win, ox:ox+win] of the
    float32 stack X (N, 1, H, W), zero outside the frame."""
    X = np.ascontiguousarray(X, np.float32)
    N, H, W = X.shape[0], X.shape[-2], X.shape[-1]
    img = np.asarray(img, np.int64)
    if img.size and (img.min() < 0 or img.max() >= N):
        raise IndexError(f"image index out of [0, {N})")
    stride = np.uint64(H * W * 4)
    addrs = np.uint64(X.ctypes.data) + img.astype(np.uint64) * stride
    n = len(img)
    return _launch(addrs, np.full(n, H), np.full(n, W), oy, ox, win)


def gather_windows_from(srcs, oy, ox, win: int) -> np.ndarray:
    """(n, win, win) windows srcs[i][oy[i]:oy[i]+win, ox[i]:ox[i]+win],
    zero outside each frame: ``srcs`` holds one C-contiguous float32
    (H, W) array a window (the same object may recur)."""
    addr = {}
    addrs = np.empty(len(srcs), np.uint64)
    hs = np.empty(len(srcs), np.int64)
    ws = np.empty(len(srcs), np.int64)
    for i, a in enumerate(srcs):
        k = id(a)
        if k not in addr:
            if a.dtype != np.float32 or a.ndim != 2 \
                    or not a.flags.c_contiguous:
                raise ValueError("each source must be a C-contiguous float32 "
                                 f"(H, W) array, got {a.dtype} {a.shape}")
            addr[k] = a.ctypes.data
        addrs[i] = addr[k]
        hs[i], ws[i] = a.shape
    return _launch(addrs, hs, ws, oy, ox, win)
