"""Cross-based cost aggregation (CBCA): the support arms and one
aggregation iteration.

Reference: ``cross`` adcensus.cu:280-341 (support arms) and ``cbca``
adcensus.cu:343-400 (the average over the intersection of the left and
right pixels' support regions).

On CUDA tensors :func:`cross_arms`, :func:`cbca_pack` and :func:`cbca`
launch their kernels of ``csrc/cross.cu`` (one launch a call; ``cbca``
packs the arms first unless it is handed their pack, so it makes two);
on CPU tensors they run their plain versions, the ``*_plain`` functions
beside them. The plain versions follow the formulation of the JAX package
(mccnn_tpu/ops/cross.py), which runs it in XLA with no Pallas kernel:
arms from a short static unroll over arm length, the aggregation as
2K-1 shifted masked adds per axis (K = max(2, L1)), in the same order,
so the sums round the same way. The JAX package maps over disparity;
here the disparities go in chunks that bound the temporaries. The
kernels give the plain versions' bits: the CBCA kernel adds the same
values in the same order, each sum over the whole window of 2K - 1 taps
with the adds outside its interval skipped, from the arms packed as
byte offsets clamped to [-K, K] (exact: see csrc/cross.cu).
"""

from __future__ import annotations

import ctypes

import torch

from mccnn_tpu_torch.ops import _build

# a CBCA block's outputs: TX columns x TS rows; CH volume rows staged at a
# time (csrc/cross.cu)
TX, TS, CH = 64, 64, 16
# the largest K: the widest window the kernel is built for
KMAX = 64


def window_of(K: int) -> int:
    """The compile-time window of the CBCA kernel instance that serves K
    (``window_of`` in csrc/cross.cu): K itself for the K of config.py
    (2, 3, 5, 14), else the next of 8, 16, 32, 64; past KMAX, K (no
    instance serves it)."""
    if K in (2, 3, 5, 14) or K > KMAX:
        return K
    return next(b for b in (8, 16, 32, 64) if K <= b)


def cbca_smem_bytes(K: int) -> int:
    """The dynamic shared memory a CBCA block takes for a window of
    2K - 1 (``cbca_smem`` in csrc/cross.cu, which the C entry
    ``cbca_smem_bytes`` returns): with R = window_of(K) - 1, the
    horizontal sums (float) and counts (a byte) of the TS + 2R rows its
    outputs read, at its TX columns, and CH staged volume rows with R
    columns rounded up to a multiple of 4 on each side. The same at
    every width: the tile is fixed."""
    R = window_of(K) - 1
    return (TS + 2 * R) * TX * 5 + CH * (TX + 2 * ((R + 3) & ~3)) * 4


def _lib():
    lib = _build.library("cross")
    if lib.cbca_launch.argtypes is None:
        lib.cbca_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.cbca_pack_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.cross_arms_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float]
            + [ctypes.c_void_p])
        lib.cbca_smem_bytes.argtypes = [ctypes.c_int]
        for fn in (lib.cbca_launch, lib.cbca_pack_launch,
                   lib.cross_arms_launch, lib.cbca_smem_bytes):
            fn.restype = ctypes.c_int
    return lib


def cross_arms(x0: torch.Tensor, L1: int, tau1: float) -> torch.Tensor:
    """(4, H, W) float32 exclusive arm ends of a grayscale image (H, W):
    [0] -x arm (x coord), [1] +x, [2] -y (y coord), [3] +y. The kernel on
    a CUDA image, the plain version on a CPU one."""
    if not x0.is_cuda:
        return cross_arms_plain(x0, L1, tau1)
    return _arms_launch(x0.contiguous(), L1, tau1)


def _arms_launch(x0: torch.Tensor, L1: int, tau1: float) -> torch.Tensor:
    _build.check_cuda_f32(x0, "cross_arms")
    if x0.dim() != 2:
        raise ValueError(f"cross_arms: bad shapes {tuple(x0.shape)}")
    H, W = x0.shape
    out = torch.empty((4, H, W), dtype=torch.float32, device=x0.device)
    rc = _lib().cross_arms_launch(x0.data_ptr(), out.data_ptr(), H, W,
                                  max(2, int(L1)), float(tau1),
                                  _build.stream(x0))
    _build.check_launch(rc, "cross_arms")
    _build.count("cross_arms")
    return out


def cross_arms_plain(x0: torch.Tensor, L1: int, tau1: float
                     ) -> torch.Tensor:
    """:func:`cross_arms` by a masked unroll over arm length.

    Distance-1 neighbours are always inside; from distance 2 on, the
    walk breaks at the first probe with |x0[c] - x0[probe]| >= tau1, at
    distance >= L1, or on leaving the frame (adcensus.cu:306-319)."""
    H, W = x0.shape
    k_max = max(2, int(L1))

    def arm(axis: int, sign: int) -> torch.Tensor:
        n = x0.shape[axis]
        coord = torch.arange(n, device=x0.device)
        coord = coord[:, None] if axis == 0 else coord[None, :]
        k_break = torch.full((H, W), k_max, dtype=torch.int64, device=x0.device)
        alive = torch.ones((H, W), dtype=torch.bool, device=x0.device)
        for k in range(2, k_max):
            probe = torch.roll(x0, -sign * k, dims=axis)
            in_frame = (coord + sign * k >= 0) & (coord + sign * k < n)
            viol = alive & in_frame & ((x0 - probe).abs() >= tau1)
            k_break = torch.where(viol, k, k_break)
            alive = alive & ~viol
        k_oof = coord + 1 if sign < 0 else n - coord
        k_break = torch.minimum(k_break, k_oof.expand(H, W))
        return (coord + sign * k_break).to(torch.float32)

    return torch.stack([arm(1, -1), arm(1, 1), arm(0, -1), arm(0, 1)])


def _span(n: int, k: int) -> tuple[slice, slice]:
    """(dst, src) index ranges of out[i] += x[i + k] over the i whose
    i + k lies in [0, n); both empty when |k| >= n."""
    return (slice(max(0, -k), max(0, n - max(0, k))),
            slice(max(0, k), max(0, n + min(0, k))))


def _arms_at(x1c: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """(4, n, H, W): the right image's arms at column x + delta[i] for
    each delta in the chunk, 0 outside the frame (the JAX package's
    zero-padded dynamic slice)."""
    W = x1c.shape[-1]
    col = torch.arange(W, device=x1c.device)[None, :] + delta[:, None]
    inside = (col >= 0) & (col < W)
    got = x1c[:, :, col.clamp(0, W - 1)]  # (4, H, n, W)
    return torch.where(inside[None, None], got, 0.0).permute(0, 2, 1, 3)


def cbca(x0c: torch.Tensor, x1c: torch.Tensor, vol: torch.Tensor,
         direction: int, L1: int, packed: torch.Tensor | None = None
         ) -> torch.Tensor:
    """One CBCA iteration over vol (D, H, W) float32 with the arms x0c,
    x1c (4, H, W) of the left and right images (see :func:`cbca_plain`).
    The kernel on a CUDA volume, the plain version on a CPU one.
    ``packed``: :func:`cbca_pack` of these arms at this L1, made once
    for every iteration over them; without it the kernel's call packs
    them itself. The plain version reads no pack and ignores it."""
    if not vol.is_cuda:
        return cbca_plain(x0c, x1c, vol, direction, L1)
    return _cbca_launch(x0c, x1c, vol, direction, L1, packed)


def _cbca_launch(x0c: torch.Tensor, x1c: torch.Tensor, vol: torch.Tensor,
                 direction: int, L1: int, packed: torch.Tensor | None
                 ) -> torch.Tensor:
    """Pack the arms (:func:`cbca_pack`) unless ``packed`` holds them, and
    launch the CBCA kernel: float32 operands, contiguous, on the card,
    or ValueError (a volume of another dtype is never cast here)."""
    for t, what in ((vol, "cbca: vol"), (x0c, "cbca: x0c"),
                    (x1c, "cbca: x1c")):
        _build.check_cuda_f32(t, what)
    if vol.dim() != 3 or x0c.shape != (4, *vol.shape[1:]) \
            or x1c.shape != x0c.shape:
        raise ValueError(f"cbca: bad shapes vol {tuple(vol.shape)}, arms "
                         f"{tuple(x0c.shape)} and {tuple(x1c.shape)}")
    if direction not in (-1, 1):
        raise ValueError(f"cbca: direction must be -1 or 1, got {direction}")
    K = max(2, int(L1))
    if K > KMAX:
        raise ValueError(f"cbca: L1 = {L1} exceeds {KMAX}, the widest "
                         "window the kernel is built for")
    if cbca_smem_bytes(K) > _build.MAX_SMEM:
        raise ValueError(f"cbca: L1 = {L1} needs {cbca_smem_bytes(K)} bytes "
                         "of shared memory a block")
    D, H, W = vol.shape
    if packed is None:
        packed = cbca_pack(x0c, x1c, L1)
    elif (packed.dtype != torch.int16 or packed.device != vol.device
          or not packed.is_contiguous()
          or packed.numel() != 9 * H * pack_pitch(W) + 2 * H * W):
        raise ValueError(f"cbca: packed must be cbca_pack's contiguous int16 "
                         f"offsets on {vol.device} for a {H}x{W} frame, got "
                         f"{packed.dtype} {tuple(packed.shape)} on "
                         f"{packed.device}")
    out = torch.empty_like(vol)
    rc = _lib().cbca_launch(vol.data_ptr(), packed.data_ptr(), out.data_ptr(),
                            D, H, W, K, direction, _build.stream(vol))
    _build.check_launch(rc, "cbca")
    _build.count("cbca")
    return out


def pack_pitch(W: int) -> int:
    """The row pitch of :func:`cbca_pack`'s column planes (``pack_pitch``
    in csrc/cross.cu): W rounded up to 8 and 8 columns of padding on
    each side."""
    return ((W + 7) & ~7) + 16


def cbca_pack(x0c: torch.Tensor, x1c: torch.Tensor, L1: int
              ) -> torch.Tensor:
    """The arms x0c, x1c (4, H, W) float32 of the left and right images
    as int16 pairs of signed byte offsets from each pixel's own column
    (the -x end in the low byte, the +x end in the high one) or row
    (-y, +y), clamped to [-K, K] (K = max(2, L1) <= KMAX), flat, in turn:
    the left image's column pairs (H, P) with column c at c + 8
    (P = :func:`pack_pitch`), the right image's eight times (8, H, P),
    copy s with column c at c - s + 8, then the row pairs (H, W) of the
    left and of the right image; 0 where no column is. The copies put
    any eight columns from a match column on an aligned 16-byte load.
    The kernel on CUDA arms, the plain version on CPU ones."""
    if not x0c.is_cuda:
        return cbca_pack_plain(x0c, x1c, L1)
    for t, what in ((x0c, "cbca_pack: x0c"), (x1c, "cbca_pack: x1c")):
        _build.check_cuda_f32(t, what)
    if x0c.dim() != 3 or x0c.shape[0] != 4 or x1c.shape != x0c.shape:
        raise ValueError(f"cbca_pack: bad shapes {tuple(x0c.shape)} and "
                         f"{tuple(x1c.shape)}")
    K = max(2, int(L1))
    if K > KMAX:
        raise ValueError(f"cbca_pack: L1 = {L1} exceeds {KMAX}")
    _, H, W = x0c.shape
    packed = torch.empty(9 * H * pack_pitch(W) + 2 * H * W,
                         dtype=torch.int16, device=x0c.device)
    rc = _lib().cbca_pack_launch(x0c.data_ptr(), x1c.data_ptr(),
                                 packed.data_ptr(), H, W, K,
                                 _build.stream(x0c))
    _build.check_launch(rc, "cbca_pack")
    _build.count("cbca_pack")
    return packed


def cbca_pack_plain(x0c: torch.Tensor, x1c: torch.Tensor, L1: int
                    ) -> torch.Tensor:
    """:func:`cbca_pack` in torch: the offsets clamped in float32 (exact
    for the integral arm ends), as bytes, two to an int16 (little
    endian: the first end in the low byte), laid out as the kernel
    writes them."""
    K = max(2, int(L1))
    _, H, W = x0c.shape
    dev = x0c.device
    xs = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    coord = torch.stack([xs, xs, ys, ys])
    off = (torch.stack([x0c, x1c]) - coord).clamp(-K, K).to(torch.int8)
    pairs = (off.view(2, 2, 2, H, W).permute(0, 1, 3, 4, 2).contiguous()
             .view(torch.int16)[..., 0])  # (image, columns | rows, H, W)
    P = pack_pitch(W)
    # index i of ``full`` holds column i - 8; copy s starts at index s
    full = torch.zeros((2, H, P + 8), dtype=torch.int16, device=dev)
    full[:, :, 8:8 + W] = pairs[:, 0]
    right = torch.stack([full[1, :, s:s + P] for s in range(8)])
    return torch.cat([full[0, :, :P].flatten(), right.flatten(),
                      pairs[0, 1].flatten(), pairs[1, 1].flatten()])


def cbca_plain(x0c: torch.Tensor, x1c: torch.Tensor, vol: torch.Tensor,
               direction: int, L1: int, chunk_cells: int = 1 << 25
               ) -> torch.Tensor:
    """One CBCA iteration over vol (D, H, W) by masked shifted adds.

    For each (d, y, x) with x + d*direction in frame, the mean of vol[d]
    over the rows strictly between the tighter of the two pixels'
    vertical arms, each row's columns strictly between the tighter of
    the horizontal arms of (yy, x) and (yy, x + d*direction) (the latter
    shifted back). NaN cells count as 0 in the sums; out-of-frame cells
    pass through. ``chunk_cells`` bounds the cells per chunk of d."""
    D, H, W = vol.shape
    K = max(2, int(L1))
    dev = vol.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    step = max(1, min(D, chunk_cells // max(1, H * W)))
    out = torch.empty_like(vol)
    for d0 in range(0, D, step):
        vol_d = vol[d0:d0 + step]
        delta = torch.arange(d0, d0 + vol_d.shape[0], device=dev) * direction
        a1 = _arms_at(x1c, delta)
        dl = delta[:, None, None]
        xx_s = torch.maximum(x0c[0], a1[0] - dl)
        xx_t = torch.minimum(x0c[1], a1[1] - dl)
        yy_s = torch.maximum(x0c[2], a1[2])
        yy_t = torch.minimum(x0c[3], a1[3])
        del a1

        # the masked adds of the JAX package in its order, k = -(K-1) ..
        # K-1; taps outside the frame are never inside an arm (arm ends
        # lie in [-1, n]), so each add covers only the in-frame span
        vol_z = torch.where(torch.isnan(vol_d), 0.0, vol_d)
        hsum = torch.zeros_like(vol_z)
        hcnt = torch.zeros_like(vol_z)
        for k in range(-(K - 1), K):
            dst, src = _span(W, k)
            m = (xs[..., dst] + k > xx_s[..., dst]) \
                & (xs[..., dst] + k < xx_t[..., dst])
            hsum[..., dst] += torch.where(m, vol_z[..., src], 0.0)
            hcnt[..., dst] += m
        vsum = torch.zeros_like(vol_z)
        vcnt = torch.zeros_like(vol_z)
        for k in range(-(K - 1), K):
            dst, src = _span(H, k)
            m = (ys[:, dst] + k > yy_s[:, dst]) & (ys[:, dst] + k < yy_t[:, dst])
            vsum[:, dst] += torch.where(m, hsum[:, src], 0.0)
            vcnt[:, dst] += torch.where(m, hcnt[:, src], 0.0)
        agg = vsum / torch.clamp(vcnt, min=1.0)
        valid = (xs + dl >= 0) & (xs + dl < W)
        out[d0:d0 + vol_d.shape[0]] = torch.where(valid, agg, vol_d)
    return out
