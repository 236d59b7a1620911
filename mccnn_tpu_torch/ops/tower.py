"""The towers' passes after each convolution, and the slow volumes' masks.

Prediction runs each tower layer as a hand convolution (``ops/conv.py``)
with the bias, rounding and ReLU of :func:`bias_act` in its epilogue, and
the fast tower's last layer as a bias-free convolution followed by
:func:`normalize`; the slow arch's head scores go to their two volumes
through :func:`slow_epilogue`. :func:`bias_act`'s own kernel stays as
the unfused route (``conv.conv3x3_unfused``) that the fused epilogue is
held to bit for bit; no prediction path launches it. Each
wrapper launches its kernel on CUDA tensors and runs its plain version,
the same torch operations in the same order, on CPU tensors; a kernel
that fails to build or launch raises.

- :func:`bias_act`: ``act(round(acc + b))`` in place, the bias added in
  float32, rounded to the compute dtype and held widened to float32, then
  ReLU or nothing (``models/towers.py``: in float32 PyTorch's own cuDNN
  convolution adds the bias in a separate ``add_``, so the kernel's sum
  is that one).
- :func:`normalize`: the fast tower's last layer, its bias and
  :func:`l2_normalize`, written as the (N, C, H, W) features or as the
  four zero-padded channel-major operands of the join
  (:class:`~mccnn_tpu_torch.ops.join.Operands`, what ``join._prep``
  builds). The channel sum runs in torch's order on the card
  (:func:`channel_sum_plain`, :func:`sum_rows`).
- :func:`slow_epilogue`: ``slow_head.masked_volumes``, then
  ``costs.fix_border`` of both volumes, then the ``disp_true`` mask of
  ``pipeline._volumes``, in one pass.

The kernels run only under ``torch.no_grad``: training's forward keeps the
plain operations under autograd.
"""

from __future__ import annotations

import ctypes

import torch

from mccnn_tpu_torch.ops import _build, costs, join

EPS = 1e-5
# the cost that the planes d >= disp_true hold (pipeline._volumes)
PAD_COST = 1e9


def l2_normalize(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Per-pixel feature normalization over the channel axis 1:
    x / sqrt(sum_c x^2 + eps) (adcensus.cu:1284-1308; eps is added to
    the squared norm)."""
    return x / torch.sqrt((x * x).sum(dim=1, keepdim=True) + eps)


def _last_pow2(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def sum_rows(C: int, N: int, HW: int) -> int:
    """The thread rows Y over which torch's CUDA reduction splits a sum
    over the channel axis of a contiguous (N, C, H, W) tensor (Reduce.cuh
    ``setReduceConfig``): the outputs are written 4, 2 or 1 to a thread as
    H * W allows, which caps a block at 512 / that many threads, 32 wide;
    the rows split the C inputs when each row keeps at least 16 (or 256)."""
    vec = 4 if HW % 4 == 0 else 2 if HW % 2 == 0 else 1
    most = 512 // vec
    dim0 = max(1, N * HW // vec)
    d0 = _last_pow2(dim0) if dim0 < most else most
    d1 = _last_pow2(C) if C < most else most
    width = min(d0, 32)
    height = min(d1, most // width)
    return height if C >= 16 * height or C >= 256 else 1


def channel_sum_plain(sq: torch.Tensor, rows: int) -> torch.Tensor:
    """sum over axis 1 of ``sq`` (N, C, H, W, float32 values) in the order of
    the kernel and of torch's reduction with ``rows`` thread rows: row y
    adds the channels y + rows * (i + 4k) into accumulator i (from 0, k in
    order), combines its four accumulators as ((a0 + a1) + a2) + a3, and
    the rows combine as a tree, row y taking row y + o for o = rows / 2,
    ..., 1. (N, 1, H, W) float32."""
    C = sq.shape[1]
    parts = []
    for y in range(rows):
        acc = [torch.zeros_like(sq[:, 0]) for _ in range(4)]
        idx = y
        while idx + 3 * rows < C:
            for i in range(4):
                acc[i] = acc[i] + sq[:, idx + i * rows]
            idx += 4 * rows
        for i in range(4):
            if idx < C:
                acc[i] = acc[i] + sq[:, idx]
            idx += rows
        parts.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    off = rows // 2
    while off:
        for y in range(off):
            parts[y] = parts[y] + parts[y + off]
        off //= 2
    return parts[0][:, None]


def _lib():
    lib = _build.library("tower")
    if lib.tower_bias_act.argtypes is None:
        lib.tower_bias_act.argtypes = ([ctypes.c_void_p] * 2
                                       + [ctypes.c_int] * 2
                                       + [ctypes.c_longlong]
                                       + [ctypes.c_int] * 2
                                       + [ctypes.c_void_p])
        lib.tower_normalize.argtypes = ([ctypes.c_void_p] * 7
                                        + [ctypes.c_int] * 9
                                        + [ctypes.c_void_p])
        lib.slow_volumes_epilogue.argtypes = ([ctypes.c_void_p] * 3
                                              + [ctypes.c_int] * 5
                                              + [ctypes.c_void_p])
        for fn in (lib.tower_bias_act, lib.tower_normalize,
                   lib.slow_volumes_epilogue):
            fn.restype = ctypes.c_int
    return lib


def _code(dtype) -> int:
    """csrc/tower.cu's rounding code S of a compute dtype: the join's
    storage codes (a value rounded to nearest even, held widened)."""
    code = join.STORAGE.get(dtype)
    if code is None:
        raise ValueError(f"tower: compute dtype {dtype} not taken "
                         f"(one of {sorted(map(str, join.STORAGE))})")
    return code


def _check_layer(acc: torch.Tensor, bias: torch.Tensor, what: str) -> None:
    """The (N, C, H, W) float32 convolution output and its (C,) bias on the
    card, outside autograd."""
    if torch.is_grad_enabled() and (acc.requires_grad or bias.requires_grad):
        raise RuntimeError(f"{what}: the kernel runs in prediction only "
                           "(under torch.no_grad)")
    _build.check_cuda_f32(acc, f"{what} acc")
    _build.check_cuda_f32(bias, f"{what} bias")
    if acc.dim() != 4 or bias.shape != (acc.shape[1],) \
            or acc.shape[0] * acc.shape[1] > 65535:
        raise ValueError(f"{what}: bad shapes acc {tuple(acc.shape)}, bias "
                         f"{tuple(bias.shape)}")


def bias_act_plain(acc: torch.Tensor, bias: torch.Tensor, relu: bool,
                   dtype=torch.float32) -> torch.Tensor:
    """:func:`bias_act` as torch operations: ``acc + b`` (float32), rounded
    to ``dtype``, ``torch.relu``, written back into ``acc``."""
    v = acc + bias[:, None, None]
    if dtype != torch.float32:
        v = v.to(dtype)
    if relu:
        v = torch.relu(v)
    return acc.copy_(v)


def bias_act(acc: torch.Tensor, bias: torch.Tensor, relu: bool,
             dtype=torch.float32) -> torch.Tensor:
    """One tower layer's bias and activation, in place on its bias-free
    convolution output ``acc`` (N, C, H, W) float32: ``act(round(acc +
    bias[c]))`` with the round to the compute ``dtype`` (the value held
    widened to float32) and ``act`` ReLU (``relu``) or none. Returns
    ``acc``. The kernel on CUDA tensors, :func:`bias_act_plain` on CPU
    tensors."""
    code = _code(dtype)
    if not acc.is_cuda:
        return bias_act_plain(acc, bias, relu, dtype)
    _check_layer(acc, bias, "tower_bias_act")
    bias = bias.detach()
    N, C, H, W = acc.shape
    rc = _lib().tower_bias_act(acc.data_ptr(), bias.data_ptr(), N, C, H * W,
                               code, int(bool(relu)), _build.stream(acc))
    _build.check_launch(rc, "tower_bias_act")
    _build.count("tower_bias_act")
    return acc


def normalize_plain(acc: torch.Tensor, bias: torch.Tensor,
                    dtype=torch.float32, pack=None):
    """:func:`normalize` as torch operations: ``acc + b`` rounded to
    ``dtype``, :func:`l2_normalize` on the ``dtype`` tensor, widened; with
    ``pack`` the join's operands by ``join.operands``."""
    v = acc + bias[:, None, None]
    if dtype != torch.float32:
        v = v.to(dtype)
    feats = l2_normalize(v).float()
    if pack is None:
        return feats
    return join.operands(feats[0].permute(1, 2, 0),
                         feats[1].permute(1, 2, 0), *pack)


def normalize(acc: torch.Tensor, bias: torch.Tensor, dtype=torch.float32,
              pack=None):
    """The fast tower's last layer from its bias-free convolution output
    ``acc`` (N, C, H, W) float32: the bias, the round to the compute
    ``dtype`` and the L2 normalization, widened to float32. Without
    ``pack`` the (N, C, H, W) features; with ``pack`` = (disp_max, sides)
    and N = 2 (the left image, then the right), the join's operands of
    ``sides`` ("both" or "left") as ``join.Operands``. The kernel on CUDA
    tensors, :func:`normalize_plain` on CPU tensors."""
    code = _code(dtype)
    if pack is not None and pack[1] not in ("both", "left"):
        raise ValueError(f"sides must be 'both' or 'left', got {pack[1]!r}")
    if not acc.is_cuda:
        return normalize_plain(acc, bias, dtype, pack)
    _check_layer(acc, bias, "tower_normalize")
    bias = bias.detach()
    N, C, H, W = acc.shape
    rows = sum_rows(C, N, H * W)
    lib = _lib()
    if pack is None:
        out = torch.empty_like(acc)
        rc = lib.tower_normalize(acc.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), None, None, None, None, N, C,
                                 rows, H, W, 0, 0, 0, code, _build.stream(acc))
    else:
        if N != 2:
            raise ValueError(f"tower_normalize: the join's operands need the "
                             f"two images, got N={N}")
        Hp, Wp, Dp = join.pad_dims(H, W, int(pack[0]))
        new = lambda w: torch.empty((Hp, C, w), dtype=torch.float32,  # noqa
                                    device=acc.device)
        a_l, b_l = new(Wp), new(Wp + Dp)
        a_r, b_r = (None, None) if pack[1] == "left" else (new(Wp),
                                                          new(Wp + Dp))
        out = join.Operands(a_l, b_l, a_r, b_r, H, W)
        ptr = [None if t is None else t.data_ptr() for t in out[:4]]
        rc = lib.tower_normalize(acc.data_ptr(), bias.data_ptr(), None, *ptr,
                                 N, C, rows, H, W, Hp, Wp, Wp + Dp, code,
                                 _build.stream(acc))
    _build.check_launch(rc, "tower_normalize_pack")
    _build.count("tower_normalize_pack")
    return out


def slow_epilogue_plain(s: torch.Tensor, n: int = 0, disp_true=None):
    """:func:`slow_epilogue` as the torch operations it replaces:
    ``slow_head.masked_volumes``, ``costs.fix_border`` of each volume,
    ``torch.where`` of the planes d >= ``disp_true``."""
    from mccnn_tpu_torch.ops import slow_head

    vol_l, vol_r = slow_head.masked_volumes(s)
    vol_l, vol_r = costs.fix_border(vol_l, -1, n), costs.fix_border(vol_r, 1, n)
    D = s.shape[0]
    if disp_true is not None and disp_true < D:
        real = torch.arange(D, device=s.device)[:, None, None] < disp_true
        vol_l = torch.where(real, vol_l, PAD_COST)
        vol_r = torch.where(real, vol_r, PAD_COST)
    return vol_l, vol_r


def slow_epilogue(s: torch.Tensor, n: int = 0, disp_true=None):
    """Both slow-arch cost volumes (vol_l, vol_r), (D, H, W) each, from the
    head scores ``s`` (D, H, W) float32: NaN out of frame
    (vol_l[d, y, x] = s[d, y, x] where x >= d, vol_r[d, y, x] = s[d, y,
    x + d] where x + d < W), the ``n`` border columns of each replicated
    from its first valid one (``costs.fix_border``), and 1e9 in the planes
    d >= ``disp_true`` where given. The kernel on CUDA tensors,
    :func:`slow_epilogue_plain` on CPU tensors."""
    if not s.is_cuda:
        return slow_epilogue_plain(s, n, disp_true)
    _build.check_cuda_f32(s, "slow_volumes_epilogue s")
    if s.dim() != 3 or s.data_ptr() % 16:
        raise ValueError(f"slow_volumes_epilogue: expected a 16-byte aligned "
                         f"(D, H, W) volume, got {tuple(s.shape)}")
    D, H, W = s.shape
    if not 0 <= n < max(W, 1) or D > 65535 or W * 4 > 227 * 1024:
        raise ValueError(f"slow_volumes_epilogue: n={n} for W={W} (0 <= n < W)"
                         f", D={D} <= 65535, W <= {227 * 256}")
    d_true = D if disp_true is None else max(0, min(int(disp_true), D))
    vol_l, vol_r = torch.empty_like(s), torch.empty_like(s)
    rc = _lib().slow_volumes_epilogue(s.data_ptr(), vol_l.data_ptr(),
                                      vol_r.data_ptr(), D, H, W, n, d_true,
                                      _build.stream(s))
    _build.check_launch(rc, "slow_volumes_epilogue")
    _build.count("slow_volumes_epilogue")
    return vol_l, vol_r
