"""Training-time patch extraction + augmentation.

Behavior contract: ``make_patch`` (main.lua:603-619) + ``cv.warp_affine``
(cv.cpp:19-45): compose translate→scale→rotate→shear affine transforms
mapping the source pixel of interest to the patch center, sample with
bicubic (Catmull-Rom, OpenCV a = -0.75) interpolation, fill outliers
with 0, then ``patch = patch * contrast + brightness``.

Two halves, as in mccnn_tpu/train/augment.py. The host half is numpy
and a copy of the JAX package's (``patch_matrix``, ``invert_2x3``,
:class:`AugmentSampler`): one ``np.random.RandomState`` draws the same
stream in both packages, bit for bit. Its window gather runs on the
host C++ of ``ops/host_gather.py``, equal bit for bit to the numpy
gather it replaces (:func:`_gather_windows`). The device half samples
all 4·bs/2 patches of a step at once: :func:`warp_patches` from
windows, :func:`gather_warp` from the padded image stack resident on
the device (:func:`pad_image_stack`), which ships origins instead of
windows to the card. On CUDA tensors both launch the ``warp_patches``
kernel (``ops/warp.py``, ``csrc/warp.cu``: the window gather and the
bicubic warp in one launch); on CPU tensors they run their plain
versions, :func:`warp_patches_plain` and :func:`gather_warp_plain`
(:func:`gather_windows_device`, then the plain warp).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mccnn_tpu_torch.config import Config
from mccnn_tpu_torch.ops import host_gather, warp

# Window gathered around each sample point. Must cover the patch's
# source footprint: (ws-1)/2 * sqrt(2) / min_scale + max_trans + 2
# bicubic taps. ws<=11, min_scale>=0.64, trans<=1 in every reference
# config => radius <= 15.
WIN = 32


def _mul32(a, b):
    """Compose 2x3 affines (row-major, main.lua:604): returns a∘b."""
    return (
        a[0] * b[0] + a[1] * b[3],
        a[0] * b[1] + a[1] * b[4],
        a[0] * b[2] + a[1] * b[5] + a[2],
        a[3] * b[0] + a[4] * b[3],
        a[3] * b[1] + a[4] * b[4],
        a[3] * b[2] + a[4] * b[5] + a[5],
    )


def patch_matrix(ws: int, center_x, center_y, scale, phi, trans, hshear):
    """The make_patch source→dest affine (main.lua:606-614), vectorized
    over leading dims of the inputs. Returns (..., 6) row-major 2x3."""
    zeros = np.zeros_like(np.asarray(center_x, np.float32))
    ones = zeros + 1.0
    m = (ones, zeros, -np.asarray(center_x, np.float32),
         zeros, ones, -np.asarray(center_y, np.float32))
    m = _mul32((ones, zeros, trans[0], zeros, ones, trans[1]), m)
    m = _mul32((scale[0], zeros, zeros, zeros, scale[1], zeros), m)
    c, s = np.cos(phi), np.sin(phi)
    m = _mul32((c, s, zeros, -s, c, zeros), m)
    m = _mul32((ones, hshear, zeros, zeros, ones, zeros), m)
    half = (ws - 1) / 2.0
    m = _mul32((ones, zeros, zeros + half, zeros, ones, zeros + half), m)
    return np.stack(m, axis=-1).astype(np.float32)


def invert_2x3(m: np.ndarray) -> np.ndarray:
    """Invert batched row-major 2x3 affines (dst→src for sampling; the
    OpenCV forward-map convention inverts internally, cv.cpp:19-45)."""
    a, b, tx, c, d, ty = (m[..., i] for i in range(6))
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return np.stack([ia, ib, itx, ic, id_, ity], axis=-1).astype(np.float32)


def _cubic_weights(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Keys cubic convolution weights for taps at offsets -1..2 relative
    to floor(x); `t` is the fractional part. OpenCV INTER_CUBIC a=-0.75."""
    # weight for |x| <= 1: (a+2)|x|^3 - (a+3)|x|^2 + 1
    # weight for 1 < |x| < 2: a|x|^3 - 5a|x|^2 + 8a|x| - 4a
    def w1(x):
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def w2(x):
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    return torch.stack([w2(1 + t), w1(t), w1(1 - t), w2(2 - t)], dim=-1)


@torch.no_grad()
def warp_patches_plain(windows: torch.Tensor, minv: torch.Tensor,
                       brightness: torch.Tensor, contrast: torch.Tensor,
                       *, ws: int) -> torch.Tensor:
    """Batched bicubic affine patch sampling (``warp_patches``,
    mccnn_tpu/train/augment.py), in plain torch: the plain version of the
    ``warp_patches`` kernel (``ops/warp.py``).

    windows: (B, WIN, WIN) source windows (window origin = source pixel
    position win_origin, already subtracted from minv's translation).
    minv: (B, 6) dst→src affines in window coordinates.
    Returns (B, ws, ws) float32 patches, out-of-window samples = 0
    (CV_WARP_FILL_OUTLIERS), scaled by contrast then shifted by
    brightness (main.lua:618). The 16 taps add in the JAX loop's order,
    dy outer, dx inner, as ``acc + v * row_w * wx``.
    """
    B, H, W = windows.shape
    dev = windows.device
    ys, xs = torch.meshgrid(torch.arange(ws, device=dev, dtype=torch.float32),
                            torch.arange(ws, device=dev, dtype=torch.float32),
                            indexing="ij")  # dst coords
    m = minv[:, :, None, None]  # (B, 6, 1, 1)
    sx = m[:, 0] * xs + m[:, 1] * ys + m[:, 2]
    sy = m[:, 3] * xs + m[:, 4] * ys + m[:, 5]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = _cubic_weights(sx - x0)  # (B, ws, ws, 4)
    wy = _cubic_weights(sy - y0)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = windows.reshape(B, H * W)
    acc = torch.zeros((B, ws, ws), dtype=torch.float32, device=dev)
    for dy in range(-1, 3):
        yy = y0i + dy
        oky = (yy >= 0) & (yy < H)
        row_w = wy[..., dy + 1]
        for dx in range(-1, 3):
            xx = x0i + dx
            okx = (xx >= 0) & (xx < W)
            idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
            v = torch.gather(flat, 1, idx.reshape(B, -1)).reshape(B, ws, ws)
            v = torch.where(oky & okx, v, 0.0)
            acc = acc + v * row_w * wx[..., dx + 1]
    return acc * contrast[:, None, None] + brightness[:, None, None]


def warp_patches(windows: torch.Tensor, minv: torch.Tensor,
                 brightness: torch.Tensor, contrast: torch.Tensor,
                 *, ws: int) -> torch.Tensor:
    """(B, ws, ws) patches from (B, WIN, WIN) windows: the ``warp_patches``
    kernel on CUDA tensors (``ops/warp.py`` ``warp_windows``), bit for bit
    :func:`warp_patches_plain`, which runs on CPU tensors."""
    if not windows.is_cuda:
        return warp_patches_plain(windows, minv, brightness, contrast, ws=ws)
    return warp.warp_windows(windows.contiguous(), minv.contiguous(),
                             brightness.contiguous(), contrast.contiguous(),
                             ws)


def gather_warp_plain(Xpad: torch.Tensor, src: torch.Tensor, oy: torch.Tensor,
                      ox: torch.Tensor, minv: torch.Tensor,
                      brightness: torch.Tensor, contrast: torch.Tensor, *,
                      ws: int) -> torch.Tensor:
    """The plain gather (:func:`gather_windows_device`), then the plain
    warp: the plain version of :func:`gather_warp`."""
    return warp_patches_plain(gather_windows_device(Xpad, src, oy, ox), minv,
                              brightness, contrast, ws=ws)


def gather_warp(Xpad: torch.Tensor, src: torch.Tensor, oy: torch.Tensor,
                ox: torch.Tensor, minv: torch.Tensor, brightness: torch.Tensor,
                contrast: torch.Tensor, *, ws: int) -> torch.Tensor:
    """(B, ws, ws) patches, each warped from its window of the padded stack
    (window origins ``src``, ``oy``, ``ox``, int32 on the card): the
    ``warp_patches`` kernel reading the stack in place on CUDA tensors
    (``ops/warp.py`` ``warp_gather``), bit for bit
    :func:`gather_warp_plain`, which runs on CPU tensors."""
    if not Xpad.is_cuda:
        return gather_warp_plain(Xpad, src, oy, ox, minv, brightness,
                                 contrast, ws=ws)
    return warp.warp_gather(Xpad, src.contiguous(), oy.contiguous(),
                            ox.contiguous(), minv.contiguous(),
                            brightness.contiguous(), contrast.contiguous(),
                            ws, WIN)


def pad_image_stack(X0: np.ndarray, X1: np.ndarray,
                    device: torch.device) -> torch.Tensor:
    """The padded image stack on ``device`` for the window gathers there.

    Returns (2N, H+2*WIN, W+2*WIN) float32 — left images then right,
    WIN zeros on every side so any clipped window origin from
    :meth:`AugmentSampler.build_batches` is in-bounds and out-of-frame
    taps read the zero fill (identical to the host gather's zero
    fill). Real KITTI: 2 x 194 x 350 x 1242 f32 ~ 0.75 GB padded —
    resident once for the whole run."""
    X = np.concatenate([X0[:, 0], X1[:, 0]], axis=0)
    X = np.pad(X, ((0, 0), (WIN, WIN), (WIN, WIN)))
    return torch.as_tensor(X, dtype=torch.float32).to(device)


def gather_windows_device(Xpad: torch.Tensor, src: torch.Tensor,
                          oy: torch.Tensor, ox: torch.Tensor) -> torch.Tensor:
    """(B, WIN, WIN) windows from the padded stack: ``src`` (B,) indexes
    its first axis, ``oy``/``ox`` (B,) are window origins in frame
    coordinates (possibly negative); the +WIN pad offset makes every
    read in-bounds, so the result equals the host gather's zero fill,
    bit for bit."""
    r = torch.arange(WIN, device=Xpad.device)
    rows = (oy.to(torch.int64) + WIN)[:, None] + r  # (B, WIN)
    cols = (ox.to(torch.int64) + WIN)[:, None] + r
    return Xpad[src.to(torch.int64)[:, None, None], rows[:, :, None],
                cols[:, None, :]]


def _gather_windows(X: np.ndarray, img: np.ndarray, oy: np.ndarray,
                    ox: np.ndarray) -> np.ndarray:
    """Gather (n, WIN, WIN) windows X[img, 0, oy:oy+WIN, ox:ox+WIN] with
    zero fill outside the frame: the numpy gather of the JAX package's
    ``_gather_windows``. The plain version of the host gather
    (``ops/host_gather.py``), which the sampler runs and the tests hold
    to this bit for bit."""
    H, W = X.shape[-2], X.shape[-1]
    yy = oy[:, None] + np.arange(WIN)[None, :]  # (n, WIN)
    xx = ox[:, None] + np.arange(WIN)[None, :]
    oky = (yy >= 0) & (yy < H)
    okx = (xx >= 0) & (xx < W)
    yc = np.clip(yy, 0, H - 1)
    xc = np.clip(xx, 0, W - 1)
    out = X[img[:, None, None], 0, yc[:, :, None], xc[:, None, :]]
    out = out * (oky[:, :, None] & okx[:, None, :])
    return np.ascontiguousarray(out, np.float32)


class AugmentSampler:
    """Draws reference-distribution augmentation parameters and builds
    the per-step device inputs (windows, inverse matrices, photometric
    params, labels) for a chunk of minibatches at once.

    Sampling semantics: main.lua:791-818 — the left and right patch
    share a base transform; the right patch gets extra d_* perturbations
    simulating imperfect rectification. d_pos ~ U[-true1, true1];
    d_neg ~ ±U[false1, false2].
    """

    def __init__(self, cfg: Config, rng: np.random.RandomState):
        self.cfg = cfg
        self.rng = rng
        self.ws = cfg.ws

    def sample_params(self, n: int):
        """Vectorized draw of n examples' augmentation params. Returns a
        dict of arrays; *_r are the right-patch (perturbed) variants."""
        cfg, rng = self.cfg, self.rng
        u = rng.uniform
        d_pos = u(-cfg.true1, cfg.true1, n)
        d_neg = u(cfg.false1, cfg.false2, n)
        d_neg = np.where(rng.rand(n) < 0.5, -d_neg, d_neg)

        if not (cfg.hscale <= 1 and cfg.scale <= 1):
            raise ValueError("-hscale and -scale must be at most 1")
        s = u(cfg.scale, 1, n)
        sx = s * u(cfg.hscale, 1, n)
        sy = s
        if cfg.hflip == 1:
            sx = np.where(rng.rand(n) < 0.5, -sx, sx)
        if cfg.vflip == 1:
            sy = np.where(rng.rand(n) < 0.5, -sy, sy)
        hshear = u(-cfg.hshear, cfg.hshear, n)
        tx = u(-cfg.trans, cfg.trans, n)
        ty = u(-cfg.trans, cfg.trans, n)
        phi = u(-cfg.rotate * math.pi / 180, cfg.rotate * math.pi / 180, n)
        brightness = u(-cfg.brightness, cfg.brightness, n)
        if not (cfg.contrast >= 1 and cfg.d_contrast >= 1):
            raise ValueError("-contrast and -d_contrast must be at least 1")
        contrast = u(1 / cfg.contrast, cfg.contrast, n)

        sx_r = sx * u(cfg.d_hscale, 1, n)
        hshear_r = hshear + u(-cfg.d_hshear, cfg.d_hshear, n)
        ty_r = ty + u(-cfg.d_vtrans, cfg.d_vtrans, n)
        phi_r = phi + u(-cfg.d_rotate * math.pi / 180,
                        cfg.d_rotate * math.pi / 180, n)
        brightness_r = brightness + u(-cfg.d_brightness, cfg.d_brightness, n)
        contrast_r = contrast * u(1 / cfg.d_contrast, cfg.d_contrast, n)
        return dict(d_pos=d_pos, d_neg=d_neg, sx=sx, sy=sy, hshear=hshear,
                    tx=tx, ty=ty, phi=phi, brightness=brightness,
                    contrast=contrast, sx_r=sx_r, hshear_r=hshear_r,
                    ty_r=ty_r, phi_r=phi_r, brightness_r=brightness_r,
                    contrast_r=contrast_r)

    def build_batches(self, X0: np.ndarray, X1: np.ndarray,
                      nnz: np.ndarray, device_gather: bool = False) -> dict:
        """Build device inputs for len(nnz) examples (4 patches each).

        X0/X1: (N, 1, H, W); nnz rows (img, y, x, disp) — img is
        1-based, y/x are 0-based (make_dataset2, adcensus.cu:1915-1922).
        Returns numpy arrays:
        windows (4n, WIN, WIN), minv (4n, 6), brightness/contrast (4n,).
        Patch order per example: (L, R+, L, R-) (main.lua:843-846).

        device_gather=True: the per-step host->device window transfer
        is replaced by gathers on the device from the padded image
        stack resident there (:func:`gather_windows_device`) — instead
        of "windows" the dict carries
        "src" (4n,) int32 = which*N+img and "oy"/"ox" (4n,) int32
        window origins, clipped to [-WIN, dim] (a window that needs
        clipping lies entirely outside the frame, so the clipped
        all-pad gather is bit-identical to the host zero-fill).
        """
        n = len(nnz)
        p = self.sample_params(n)
        img = nnz[:, 0].astype(np.int64) - 1
        cy = nnz[:, 1].astype(np.float32)
        cx = nnz[:, 2].astype(np.float32)
        d = nnz[:, 3].astype(np.float32)

        cx_pos = cx - d + p["d_pos"]
        cx_neg = cx - d + p["d_neg"]

        ws = self.ws
        # 4 patch slots: (src_img, center_x, params)
        slots = [
            (0, cx, (p["sx"], p["sy"]), p["phi"], (p["tx"], p["ty"]),
             p["hshear"], p["brightness"], p["contrast"]),
            (1, cx_pos, (p["sx_r"], p["sy"]), p["phi_r"], (p["tx"], p["ty_r"]),
             p["hshear_r"], p["brightness_r"], p["contrast_r"]),
            (0, cx, (p["sx"], p["sy"]), p["phi"], (p["tx"], p["ty"]),
             p["hshear"], p["brightness"], p["contrast"]),
            (1, cx_neg, (p["sx_r"], p["sy"]), p["phi_r"], (p["tx"], p["ty_r"]),
             p["hshear_r"], p["brightness_r"], p["contrast_r"]),
        ]
        n4 = 4 * n
        windows = None if device_gather else np.zeros((n4, WIN, WIN),
                                                      np.float32)
        src_idx = np.zeros((n4,), np.int32) if device_gather else None
        oys = np.zeros((n4,), np.int32) if device_gather else None
        oxs = np.zeros((n4,), np.int32) if device_gather else None
        minv = np.zeros((n4, 6), np.float32)
        bri = np.zeros((n4,), np.float32)
        con = np.zeros((n4,), np.float32)
        H, W = X0.shape[-2], X0.shape[-1]
        N = X0.shape[0]
        half = WIN // 2
        for k, (which, ctr_x, scale, phi, trans, hshear, b, c) in enumerate(slots):
            m = patch_matrix(ws, ctr_x, cy, scale, phi, trans, hshear)
            mi = invert_2x3(m)
            # window origin: integer corner near the patch source center
            ox = np.round(ctr_x).astype(np.int64) - half
            oy = np.round(cy).astype(np.int64) - half
            # shift the inverse translation into window coordinates
            mi[:, 2] -= ox
            mi[:, 5] -= oy
            sl = slice(k, n4, 4)
            if device_gather:
                src_idx[sl] = which * N + img
                oys[sl] = np.clip(oy, -WIN, H)
                oxs[sl] = np.clip(ox, -WIN, W)
            else:
                src = X0 if which == 0 else X1
                windows[sl] = host_gather.gather_windows(src, img, oy, ox, WIN)
            minv[sl] = mi
            bri[sl] = b
            con[sl] = c
        labels = np.zeros((2 * n,), np.float32)
        labels[1::2] = 1.0  # (pos=0, neg=1) interleaved (main.lua:848-849)
        out = dict(minv=minv, brightness=bri, contrast=con, labels=labels)
        if device_gather:
            out.update(src=src_idx, oy=oys, ox=oxs)
        else:
            out["windows"] = windows
        return out


    def build_batches_mb(self, X: list, nnz: np.ndarray) -> dict:
        """Middlebury variant: per example, draw (light, exposure) for
        the left patch and possibly perturbed (light', exposure') for
        the right (main.lua:826-841): light uniform over 2..n_lights,
        exp uniform over that light's pairs; with prob d_exp re-draw
        exp', with prob d_light use light-1 (floored at 2). Light 1 is
        reserved for evaluation (main.lua:829).

        X: nested per-image lists, X[img][light] = (n_exp, 2, C, H, W).
        """
        cfg, rng = self.cfg, self.rng
        n = len(nnz)
        p = self.sample_params(n)
        img = nnz[:, 0].astype(np.int64) - 1
        cy = nnz[:, 1].astype(np.float32)
        cx = nnz[:, 2].astype(np.float32)
        d = nnz[:, 3].astype(np.float32)
        cx_pos = cx - d + p["d_pos"]
        cx_neg = cx - d + p["d_neg"]

        ws = self.ws
        half = WIN // 2
        n4 = 4 * n
        srcs = [None] * n4  # each window's source image, gathered at the end
        oys = np.zeros((n4,), np.int64)
        oxs = np.zeros((n4,), np.int64)
        minv = np.zeros((n4, 6), np.float32)
        bri = np.zeros((n4,), np.float32)
        con = np.zeros((n4,), np.float32)

        slots = [
            (0, cx, (p["sx"], p["sy"]), p["phi"], (p["tx"], p["ty"]),
             p["hshear"], p["brightness"], p["contrast"]),
            (1, cx_pos, (p["sx_r"], p["sy"]), p["phi_r"], (p["tx"], p["ty_r"]),
             p["hshear_r"], p["brightness_r"], p["contrast_r"]),
            (0, cx, (p["sx"], p["sy"]), p["phi"], (p["tx"], p["ty"]),
             p["hshear"], p["brightness"], p["contrast"]),
            (1, cx_neg, (p["sx_r"], p["sy"]), p["phi_r"], (p["tx"], p["ty_r"]),
             p["hshear_r"], p["brightness_r"], p["contrast_r"]),
        ]
        for i in range(n):
            lights = X[img[i]]
            n_lights = len(lights)
            light = rng.randint(2, n_lights + 1) - 1  # 0-based index
            n_exp = lights[light].shape[0]
            exp = rng.randint(n_exp)
            light_r, exp_r = light, exp
            if rng.rand() < cfg.d_exp:
                exp_r = rng.randint(n_exp)
            if rng.rand() < cfg.d_light:
                light_r = max(1, light - 1)  # floor at light 2 (index 1)
            exp_r = min(exp_r, lights[light_r].shape[0] - 1)
            pair = (lights[light][exp, 0, 0], lights[light_r][exp_r, 1, 0])
            for k, (which, ctr_x, scale, phi, trans, hshear, b, c) in enumerate(slots):
                m = patch_matrix(ws, ctr_x[i], cy[i],
                                 (scale[0][i], scale[1][i]), phi[i],
                                 (trans[0][i], trans[1][i]), hshear[i])
                mi = invert_2x3(m[None])[0]
                ox = int(round(float(ctr_x[i]))) - half
                oy = int(round(float(cy[i]))) - half
                mi[2] -= ox
                mi[5] -= oy
                j = i * 4 + k
                srcs[j], oys[j], oxs[j] = pair[which], oy, ox
                minv[j] = mi
                bri[j] = b[i]
                con[j] = c[i]
        windows = host_gather.gather_windows_from(srcs, oys, oxs, WIN)
        labels = np.zeros((2 * n,), np.float32)
        labels[1::2] = 1.0
        return dict(windows=windows, minv=minv, brightness=bri, contrast=con,
                    labels=labels)
