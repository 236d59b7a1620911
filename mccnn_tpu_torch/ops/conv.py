"""The towers' SAME-padded 3x3 convolutions of prediction (``csrc/conv.cu``).

:func:`conv3x3` is one tower layer's convolution, (N, C_in, H, W) float32
in, (N, C_out, H, W) float32 out, with the operands rounded to the compute
dtype: the arithmetic of ``models/towers.py`` ``_conv_acc`` (the JAX
package's ``conv_general_dilated`` with ``preferred_element_type=float32``,
mccnn_tpu/models/towers.py:84-87); given the layer's ``bias`` it also adds
it, rounds to the compute dtype and applies ReLU (``relu``) in the
kernel's epilogue, the bits of ``tower.bias_act`` on the bias-free output.
On CUDA tensors it launches one of two kernels and counts a launch of
``tower_conv``: the layers after the first at the widths of ``WIDTHS``
(C_in = C_out = fm in 64, 80, 96, 112: the published nets' and the fast
net's hyperparameter search's) on ``conv_wgmma_kernel``, an implicit GEMM
on the tensor cores (float32 as the six products of a three-level bf16
split, bfloat16 and float16 in one pass of their own type); the first
layer (C_in = n_input_plane) and every other width on the SIMT
``conv_first_kernel``. The kernels take 3x3 weights only
(:func:`check_kernel_size` refuses another ``ks`` on CUDA before a run
starts). On CPU tensors it runs :func:`conv3x3_plain` (and
``tower.bias_act_plain`` for a bias), SAME-padded for any odd kernel
size. A kernel that fails to build or launch raises; nothing falls back.

The wgmma kernel reads the weights as :func:`pack_weights` lays them out,
made once for each weight and dtype and cached beside the weight tensor,
keyed on its ``data_ptr()`` and ``_version``: a weight updated in place
(an optimizer step) or moved is packed again.

:func:`conv3x3_split_plain` emulates the float32 kernel's split in torch,
for the error budget of the tests; :func:`conv3x3_tile_plain` emulates the
wgmma kernel's staged A tile (its level planes and the rows its
``ldmatrix`` reads) and its order of products. :func:`tile_plan` is its
tiles' shape at a width and dtype (``Conf`` of the source).
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref

import torch
import torch.nn.functional as F

from mccnn_tpu_torch.ops import _build, tower
from mccnn_tpu_torch.ops.join import _split

# compute dtype -> the kernels' mode: float32 (three bf16 levels), bfloat16,
# float16 (one level of the type)
MODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the wgmma kernel's instances: C_in = C_out = fm
WIDTHS = (64, 80, 96, 112)
# the SIMT kernel's limit: an output channel's C_in * 9 weights in 48 KB
FIRST_CIN = 12288 // 9

_P, _I = ctypes.c_void_p, ctypes.c_int
# id(weight) -> (a weak reference to it, {dtype: ((data_ptr, _version,
# device), the packed weights)}); an entry goes with its weight
_PACKS: dict[int, tuple] = {}


def _lib():
    lib = _build.library("conv")
    if lib.conv_wgmma_launch.argtypes is None:
        lib.conv_first_launch.argtypes = [_P] * 3 + [_I] * 5 + [_P]
        lib.conv_wgmma_launch.argtypes = [_P] * 3 + [_I] * 5 + [_P]
        fns = [lib.conv_first_launch, lib.conv_wgmma_launch]
        # the fused entries (a source before them has none)
        if hasattr(lib, "conv_wgmma_bias_launch"):
            lib.conv_first_bias_launch.argtypes = [_P] * 4 + [_I] * 7 + [_P]
            lib.conv_wgmma_bias_launch.argtypes = [_P] * 4 + [_I] * 6 + [_P]
            fns += [lib.conv_first_bias_launch, lib.conv_wgmma_bias_launch]
        for fn in fns:
            fn.restype = _I
    return lib


def _mode(dtype) -> int:
    mode = MODES.get(dtype)
    if mode is None:
        raise ValueError(f"tower_conv: compute dtype {dtype} not taken (one "
                         f"of {sorted(map(str, MODES))})")
    return mode


def check_kernel_size(ks: int, device) -> None:
    """Refuse, before a run starts, a tower of ``ks`` x ``ks`` kernels on
    CUDA: the kernels take 3 x 3 only (the CPU's plain version takes any
    odd size)."""
    if torch.device(device).type == "cuda" and ks != 3:
        raise ValueError(f"tower_conv: the CUDA kernels take ks = 3, got ks "
                         f"= {ks}; run with -backend cpu for another kernel "
                         f"size")


def _no_tf32(t: torch.Tensor):
    """cuDNN in full float32 for a CUDA tensor (TF32 would drift the
    features from the float32 reference and flip WTA near-ties)."""
    if t.is_cuda:
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
    return contextlib.nullcontext()


def _rounded(weight: torch.Tensor, dtype) -> torch.Tensor:
    """The weights rounded to the compute dtype, as float32."""
    w = weight.detach()
    return w.float() if dtype == torch.float32 else w.to(dtype).float()


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """:func:`conv3x3` as ``_conv_acc`` computes it: ``F.conv2d`` in float32
    of ``x`` (float32, or values of ``dtype``) and the weights rounded to
    ``dtype``, SAME-padded (ks // 2), no bias; cuDNN with TF32 off on
    CUDA."""
    w = weight if dtype == torch.float32 else weight.to(dtype)
    with _no_tf32(x):
        return F.conv2d(x.float(), w.float(), None,
                        padding=weight.shape[-1] // 2)


def conv3x3_split_plain(x: torch.Tensor, weight: torch.Tensor,
                        levels: int = 3) -> torch.Tensor:
    """:func:`conv3x3_plain` in float32 from bf16 products: ``x`` and the
    weights each split into ``levels`` bf16 terms (``join._split``), and the
    sum the convolutions of the pairs x_i, w_j with i + j < ``levels``
    (0-based), the smallest first. ``levels=3`` is the float32 kernel's
    arithmetic (six products, within about 4 * 2^-24 sum |w||x| of the
    float32 sum); ``levels=2`` keeps three products, within about
    3 * 2^-16 sum |w||x|."""
    sx, sw = _split(x.float(), levels), _split(weight.detach().float(), levels)
    pairs = sorted(((i, j) for i in range(levels) for j in range(levels)
                    if i + j < levels), key=lambda p: (-sum(p), -p[0]))
    out = None
    with _no_tf32(x):
        for i, j in pairs:
            t = F.conv2d(sx[i], sw[j], None, padding=1)
            out = t if out is None else out + t
    return out


# the wgmma kernel's tile: TM output columns, rows of HP staged pixels, a
# staged row's 8-channel group of HP pixels x 16 bytes
TM = 64
HP = TM + 2
GB = HP * 16
# MODE 0's products in the kernel's order: the activations' level PA[p] by
# the weights' level PB[p]; the last, hi.hi, sums apart from the others
PA = (0, 1, 0, 2, 1, 0)
PB = (2, 1, 1, 0, 0, 0)


def conv3x3_tile_plain(x: torch.Tensor, weight: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """The wgmma kernel's arithmetic (C_in = C_out = C) on its staged tile,
    in torch: each tile's TR + 2 rows of HP = 66 pixels (zeros outside the
    frame) staged as the kernel stages them, the activations' levels
    (``join._split``'s three bf16 levels in float32, the value rounded to
    the 16-bit ``dtype`` otherwise) laid out [level][C / 8 channel
    group][pixel][8 values], 16 bytes a (pixel, group); each tap's A
    fragment read from that layout at the byte addresses the kernel's
    ``ldmatrix.x4`` rows name (lane L of warp w: matrix L // 8, its row L
    % 8 at pixel 16 w + L % 8 + 8 (L // 8 % 2) + kx, group 2 k + L // 16),
    placed as the wgmma A registers hold it; the products summed in the
    kernel's order, tap -> product -> k16 step, in float32, the five small
    ones and hi.hi in two sums added at the end. (N, C, H, W) float32."""
    mode = _mode(dtype)
    N, C, H, W = x.shape
    tr, _ = tile_plan(C, dtype)
    if mode == 0:
        xl = _split(x.float(), 3)
        wl = _split(weight.detach().float(), 3)
    else:
        xl = [x.to(dtype).float()]
        wl = [weight.detach().to(dtype).float()]
    lv, dev = len(xl), x.device
    n_ty, n_tx = -(-H // tr), -(-W // TM)
    pad = torch.zeros((lv, N, C, n_ty * tr + 2, n_tx * TM + 2),
                      dtype=torch.float32, device=dev)
    pad[:, :, :, 1:H + 1, 1:W + 1] = torch.stack(xl)
    # (lv, N, C, n_ty, n_tx, TR + 2 rows, HP pixels) -> a tile's staged
    # bytes / 2: [row][level][group][pixel][8]
    t = pad.unfold(3, tr + 2, tr).unfold(4, HP, TM)
    t = t.permute(1, 3, 4, 5, 0, 2, 6).reshape(
        N, n_ty, n_tx, tr + 2, lv, C // 8, 8, HP).transpose(-1, -2)
    flat = t.reshape(N * n_ty * n_tx, -1)
    lvb, rb = C // 8 * GB, lv * C // 8 * GB
    # the element that A (m, c) of a warpgroup's fragment holds: the lane
    # that names row m % 8 of matrix j and its column c % 8 of that row
    m = torch.arange(TM, device=dev)[:, None]
    c = torch.arange(C, device=dev)[None, :]
    j = 2 * (c % 16 // 8) + m % 16 // 8
    lane = 8 * j + m % 8
    w = m // 16
    col = c % 8
    acc = torch.zeros((N * n_ty * n_tx, tr, TM, C), dtype=torch.float32,
                      device=dev)
    acc2 = torch.zeros_like(acc)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        a = []
        for lvl in range(lv):
            rows = []
            for wg in range(tr):
                addr = ((wg + ky) * rb + lvl * lvb
                        + (2 * (c // 16) + lane // 16) * GB
                        + (16 * w + lane % 8 + 8 * (lane // 8 % 2) + kx) * 16)
                rows.append(flat[:, addr // 2 + col])
            a.append(torch.stack(rows, 1))
        prods = [(PA[p], PB[p], p == 5) for p in range(6)] if mode == 0 \
            else [(0, 0, True)]
        for la, lb, hi in prods:
            wt = wl[lb][:, :, ky, kx].t()
            for k in range(C // 16):
                part = a[la][..., 16 * k:16 * k + 16] @ wt[16 * k:16 * k + 16]
                if hi:
                    acc = acc + part
                else:
                    acc2 = acc2 + part
    tiles = (acc2 + acc if mode == 0 else acc).reshape(
        N, n_ty, n_tx, tr, TM, C)
    out = tiles.permute(0, 5, 1, 3, 2, 4).reshape(N, C, n_ty * tr, n_tx * TM)
    return out[:, :, :H, :W].contiguous()


def passes(C: int, dtype=torch.float32) -> int:
    """The output-channel blocks of the wgmma kernel's N (``Conf::NW`` of
    ``csrc/conv.cu``), which the weight pack keeps apart: two at C = 96 and
    112 in float32 (a consumer warpgroup each), else one."""
    return 2 if _mode(dtype) == 0 and C > 80 else 1


def tile_plan(C: int, dtype=torch.float32) -> tuple[int, int]:
    """The wgmma kernel's tile at width C (``Conf`` of ``csrc/conv.cu``):
    (TR, NW), TR output rows of 64 columns and NW output-channel blocks.
    Two rows of all C channels, a consumer warpgroup a row, where their
    sums fit (C = 64, 80 and the 16-bit lanes); at C = 96 and 112 in
    float32 one row, a warpgroup each half of the channels."""
    nw = passes(C, dtype)
    return (1 if nw == 2 else 2), nw


def pack_weights(weight: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The (C_out, C_in, 3, 3) weights as the wgmma kernel reads them:
    (passes, 9 taps, levels, C_in / 16 k16 steps, C_out / 8 / passes, 2, 8,
    8), of bfloat16 (the three bf16 levels of a float32 weight,
    ``join._split``, the smallest first: the kernel's ring stages take the
    levels in that order) or of the 16-bit compute dtype (one level); a
    pass (:func:`passes`) holds its share of the output channels. The last
    four axes are wgmma's no-swizzle K-major core matrices: 8 output
    channels x 8 input channels of 128 bytes, the two halves of a k16 step
    128 bytes apart, 8-channel output groups 256 bytes apart."""
    Co, Ci = weight.shape[:2]
    if weight.shape[2:] != (3, 3) or Co % 16 or Ci % 16:
        raise ValueError(f"pack_weights: expected (C_out, C_in, 3, 3) with "
                         f"C_out % 16 == C_in % 16 == 0, got "
                         f"{tuple(weight.shape)}")
    w = weight.detach().float()
    if _mode(dtype) == 0:
        levels, store = _split(w, 3)[::-1], torch.bfloat16
    else:
        levels, store = [w.to(dtype)], dtype
    nh = passes(Co, dtype)
    # [tap][u][j][r][k][h][e] -> [u][tap][k][j][h][r][e]: C_out = (Co / nh)
    # u + 8 j + r, C_in = 16 k + 8 h + e
    return torch.stack([
        lv.permute(2, 3, 0, 1).reshape(9, nh, Co // 8 // nh, 8, Ci // 16, 2, 8)
        .permute(1, 0, 4, 2, 5, 3, 6) for lv in levels], 2).to(store) \
        .contiguous()


def prepacked(weight: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The weights as the layer's kernel reads them: :func:`pack_weights`
    for the wgmma kernel, the float32 weights rounded to ``dtype`` for the
    first layer's. Made once and kept beside ``weight``; made anew when
    ``weight`` moved (``data_ptr()``) or changed in place (``_version``)."""
    key = (weight.data_ptr(), weight._version, weight.device)
    entry = _PACKS.get(id(weight))
    if entry is None or entry[0]() is not weight:
        entry = _PACKS[id(weight)] = (weakref.ref(weight), {})
        weakref.finalize(weight, _PACKS.pop, id(weight), None)
    packs = entry[1]
    hit = packs.get(dtype)
    if hit is not None and hit[0] == key:
        return hit[1]
    Co, Ci = weight.shape[:2]
    if Ci == Co and Ci in WIDTHS:
        packed = pack_weights(weight, dtype)
    else:
        packed = _rounded(weight, dtype).contiguous()
    packs[dtype] = (key, packed)
    return packed


def conv3x3(x: torch.Tensor, weight: torch.Tensor, dtype=torch.float32,
            bias: torch.Tensor | None = None, relu: bool = False
            ) -> torch.Tensor:
    """One tower layer's SAME-padded 3x3 convolution of ``x`` (N, C_in, H,
    W), float32 (or of ``dtype``, widened here) with the (C_out, C_in, 3, 3)
    ``weight`` rounded to the compute ``dtype``: the (N, C_out, H, W)
    float32 sums; given the layer's (C_out,) ``bias``, ``act(round(sum +
    bias[c]))`` as ``tower.bias_act`` computes it (``act`` ReLU with
    ``relu``), in the kernel's epilogue. The kernels on CUDA tensors (under
    ``torch.no_grad``), :func:`conv3x3_plain` (and
    ``tower.bias_act_plain``) on CPU tensors."""
    mode = _mode(dtype)
    if not x.is_cuda:
        out = conv3x3_plain(x, weight, dtype)
        if bias is None:
            return out
        return tower.bias_act_plain(out, bias.detach(), relu, dtype)
    if torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad
            or (bias is not None and bias.requires_grad)):
        raise RuntimeError("tower_conv: the kernels run in prediction only "
                           "(under torch.no_grad)")
    if x.dtype == dtype:  # the first layer's image in a 16-bit lane
        x = x.float()
    _build.check_cuda_f32(x, "tower_conv x")
    if weight.device != x.device:
        raise ValueError(f"tower_conv: weight on {weight.device}, x on "
                         f"{x.device}")
    N, Ci, H, W = x.shape
    Co = weight.shape[0]
    if weight.dim() == 4 and weight.shape[2] == weight.shape[3]:
        check_kernel_size(weight.shape[2], x.device)
    if weight.shape != (Co, Ci, 3, 3) or N > 65535:
        raise ValueError(f"tower_conv: bad shapes x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}")
    if bias is not None:
        bias = bias.detach()
        _build.check_cuda_f32(bias, "tower_conv bias")
        if bias.shape != (Co,):
            raise ValueError(f"tower_conv: bias {tuple(bias.shape)} for "
                             f"{Co} output channels")
    wide = Ci == Co and Ci in WIDTHS
    if not wide and Ci > FIRST_CIN:
        raise ValueError(f"tower_conv: no kernel for {Ci} -> {Co} channels "
                         f"(C_in = C_out in {WIDTHS}, or C_in at most "
                         f"{FIRST_CIN})")
    packed = prepacked(weight, dtype)
    out = torch.empty((N, Co, H, W), dtype=torch.float32, device=x.device)
    lib = _lib()
    args = (x.data_ptr(), packed.data_ptr())
    stream = _build.stream(x)
    if wide and bias is None:
        rc = lib.conv_wgmma_launch(*args, out.data_ptr(), N, Ci, H, W, mode,
                                   stream)
    elif wide:
        rc = lib.conv_wgmma_bias_launch(*args, bias.data_ptr(),
                                        out.data_ptr(), N, Ci, H, W, mode,
                                        int(bool(relu)), stream)
    elif bias is None:
        rc = lib.conv_first_launch(*args, out.data_ptr(), N, Ci, Co, H, W,
                                   stream)
    else:
        rc = lib.conv_first_bias_launch(*args, bias.data_ptr(),
                                        out.data_ptr(), N, Ci, Co, H, W,
                                        mode, int(bool(relu)), stream)
    _build.check_launch(rc, "tower_conv")
    _build.count("tower_conv")
    return out


# the kernels' route, which conv3x3_unfused calls also where conv3x3 itself
# is swapped for it (chip_smoke.py's plain route)
_conv3x3 = conv3x3


def conv3x3_unfused(x: torch.Tensor, weight: torch.Tensor,
                    dtype=torch.float32, bias: torch.Tensor | None = None,
                    relu: bool = False) -> torch.Tensor:
    """:func:`conv3x3` with the bias and ReLU as a pass of their own: the
    bias-free convolution, then ``tower.bias_act`` on its output (the
    route before the fused epilogue, which gives its bits)."""
    out = _conv3x3(x, weight, dtype)
    return out if bias is None else tower.bias_act(out, bias, relu, dtype)
