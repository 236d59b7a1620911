"""Training's patch sampling on the card: the window gather and the bicubic
warp as one hand kernel (``csrc/warp.cu``).

:func:`warp_windows` samples (B, ws, ws) patches from given (B, WIN, WIN)
windows, :func:`warp_gather` from the padded image stack at each patch's
window origin, which fuses the window gather into the warp. Both launch
the kernel on CUDA tensors and count a launch of ``warp_patches``; the
plain versions (``train/augment.py`` ``warp_patches_plain``,
``gather_warp_plain``) are what ``train/augment.py`` runs on CPU tensors.
A kernel that fails to build or launch raises. Each launch also adds one
to a counter on the card, which :func:`runs` reads: the launches the card
ran, a CUDA graph's replays included.
"""

from __future__ import annotations

import ctypes

import torch

from mccnn_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int

# a device's run counter, (1,) int64, made at its first launch
_RAN: dict[torch.device, torch.Tensor] = {}


def _lib():
    lib = _build.library("warp")
    if lib.warp_windows_launch.argtypes is None:
        lib.warp_windows_launch.argtypes = [_P] * 5 + [_I] * 3 + [_P] * 2
        lib.warp_windows_launch.restype = _I
        lib.warp_gather_launch.argtypes = [_P] * 4 + [_I] * 2 + [_P] * 4 \
            + [_I] * 3 + [_P] * 2
        lib.warp_gather_launch.restype = _I
    return lib


def _ran(dev: torch.device) -> int:
    """The address of ``dev``'s run counter; made outside any CUDA graph
    capture (inside one it would join the graph's pool and be zeroed at
    every replay), so the first launch on a device must not be captured."""
    if dev not in _RAN:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("warp: launch the kernel once on this device "
                               "before capturing it in a CUDA graph")
        _RAN[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return _RAN[dev].data_ptr()


def runs(device) -> int:
    """The kernel's launches that the card has run on ``device`` (after a
    synchronize), counted by the kernel itself."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _RAN:
        return 0
    torch.cuda.synchronize(dev)
    return int(_RAN[dev].item())


def _check_affine(minv, brightness, contrast, B: int, ws: int) -> None:
    for t, what in ((minv, "warp minv"), (brightness, "warp brightness"),
                    (contrast, "warp contrast")):
        _build.check_cuda_f32(t, what)
    if (minv.shape != (B, 6) or brightness.shape != (B,)
            or contrast.shape != (B,) or ws < 1):
        raise ValueError(f"warp: bad shapes minv {tuple(minv.shape)}, "
                         f"brightness {tuple(brightness.shape)}, contrast "
                         f"{tuple(contrast.shape)} for {B} patches, ws={ws}")


def warp_windows(windows: torch.Tensor, minv: torch.Tensor,
                 brightness: torch.Tensor, contrast: torch.Tensor,
                 ws: int) -> torch.Tensor:
    """(B, ws, ws) float32 patches from the (B, WIN, WIN) float32 windows,
    by the kernel."""
    _build.check_cuda_f32(windows, "warp windows")
    if windows.dim() != 3 or windows.shape[1] != windows.shape[2]:
        raise ValueError(f"warp: bad windows {tuple(windows.shape)}")
    B, win = windows.shape[0], windows.shape[1]
    _check_affine(minv, brightness, contrast, B, ws)
    out = torch.empty((B, ws, ws), dtype=torch.float32, device=windows.device)
    rc = _lib().warp_windows_launch(
        windows.data_ptr(), minv.data_ptr(), brightness.data_ptr(),
        contrast.data_ptr(), out.data_ptr(), B, ws, win,
        _ran(windows.device), _build.stream(windows))
    _build.check_launch(rc, "warp_patches")
    _build.count("warp_patches")
    return out


def warp_gather(Xpad: torch.Tensor, src: torch.Tensor, oy: torch.Tensor,
                ox: torch.Tensor, minv: torch.Tensor, brightness: torch.Tensor,
                contrast: torch.Tensor, ws: int, win: int) -> torch.Tensor:
    """(B, ws, ws) float32 patches, each from the ``win`` x ``win`` window
    of the float32 stack ``Xpad`` (n, H + 2 win, W + 2 win) at
    ``(src, oy + win, ox + win)``, by the kernel. ``src``, ``oy``, ``ox``:
    (B,) int32; every window must lie in the stack (the sampler's origins
    are clipped to [-win, H] and [-win, W]); the kernel does not check."""
    _build.check_cuda_f32(Xpad, "warp Xpad")
    for t, what in ((src, "warp src"), (oy, "warp oy"), (ox, "warp ox")):
        _build.check_cuda(t, what, torch.int32)
    B = src.shape[0] if src.dim() == 1 else -1
    if (Xpad.dim() != 3 or B < 0 or oy.shape != (B,) or ox.shape != (B,)
            or Xpad.shape[1] < 2 * win or Xpad.shape[2] < 2 * win):
        raise ValueError(f"warp: bad shapes Xpad {tuple(Xpad.shape)}, src "
                         f"{tuple(src.shape)}, oy {tuple(oy.shape)}, ox "
                         f"{tuple(ox.shape)}")
    _check_affine(minv, brightness, contrast, B, ws)
    out = torch.empty((B, ws, ws), dtype=torch.float32, device=Xpad.device)
    rc = _lib().warp_gather_launch(
        Xpad.data_ptr(), src.data_ptr(), oy.data_ptr(), ox.data_ptr(),
        Xpad.shape[1], Xpad.shape[2], minv.data_ptr(), brightness.data_ptr(),
        contrast.data_ptr(), out.data_ptr(), B, ws, win, _ran(Xpad.device),
        _build.stream(Xpad))
    _build.check_launch(rc, "warp_patches")
    _build.count("warp_patches")
    return out
