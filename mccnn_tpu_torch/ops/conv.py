"""The towers' SAME-padded 3x3 convolutions of prediction (``csrc/conv.cu``).

:func:`conv3x3` is one tower layer's bias-free convolution, (N, C_in, H,
W) float32 in, (N, C_out, H, W) float32 out, with the operands rounded to
the compute dtype: the arithmetic of ``models/towers.py`` ``_conv_acc``
(the JAX package's ``conv_general_dilated`` with
``preferred_element_type=float32``, mccnn_tpu/models/towers.py:84-87).
On CUDA tensors it launches one of two kernels and counts a launch of
``tower_conv``: the layers after the first at the widths of ``WIDTHS``
(C_in = C_out = fm in 64, 80, 96, 112: the published nets' and the fast
net's hyperparameter search's) on ``conv_wgmma_kernel``, an implicit GEMM
on the tensor cores (float32 as the six products of a three-level bf16
split, bfloat16 and float16 in one pass of their own type); the first
layer (C_in = n_input_plane) and every other width on the SIMT
``conv_first_kernel``. The kernels take 3x3 weights only
(:func:`check_kernel_size` refuses another ``ks`` on CUDA before a run
starts). On CPU tensors it runs :func:`conv3x3_plain`, SAME-padded for
any odd kernel size. A kernel that fails to build or launch raises;
nothing falls back.

The wgmma kernel reads the weights as :func:`pack_weights` lays them out,
made once for each weight and dtype and cached beside the weight tensor,
keyed on its ``data_ptr()`` and ``_version``: a weight updated in place
(an optimizer step) or moved is packed again.

:func:`conv3x3_split_plain` emulates the float32 kernel's split in torch,
for the error budget of the tests.
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref

import torch
import torch.nn.functional as F

from mccnn_tpu_torch.ops import _build
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
        for fn in (lib.conv_first_launch, lib.conv_wgmma_launch):
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


def passes(C: int, dtype=torch.float32) -> int:
    """The output-channel passes of a wgmma tile (``Conf::NH`` of
    ``csrc/conv.cu``): two at C = 96 and 112 in float32, else one."""
    return 2 if _mode(dtype) == 0 and C > 80 else 1


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


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            dtype=torch.float32) -> torch.Tensor:
    """One tower layer's bias-free SAME-padded 3x3 convolution of ``x``
    (N, C_in, H, W), float32 (or of ``dtype``, widened here) with the
    (C_out, C_in, 3, 3) ``weight`` rounded to the compute ``dtype``: the
    (N, C_out, H, W) float32 sums. The kernels on CUDA tensors (under
    ``torch.no_grad``), :func:`conv3x3_plain` on CPU tensors."""
    mode = _mode(dtype)
    if not x.is_cuda:
        return conv3x3_plain(x, weight, dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
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
    wide = Ci == Co and Ci in WIDTHS
    if not wide and Ci > FIRST_CIN:
        raise ValueError(f"tower_conv: no kernel for {Ci} -> {Co} channels "
                         f"(C_in = C_out in {WIDTHS}, or C_in at most "
                         f"{FIRST_CIN})")
    packed = prepacked(weight, dtype)
    out = torch.empty((N, Co, H, W), dtype=torch.float32, device=x.device)
    lib = _lib()
    if wide:
        rc = lib.conv_wgmma_launch(x.data_ptr(), packed.data_ptr(),
                                   out.data_ptr(), N, Ci, H, W, mode,
                                   _build.stream(x))
    else:
        rc = lib.conv_first_launch(x.data_ptr(), packed.data_ptr(),
                                   out.data_ptr(), N, Ci, Co, H, W,
                                   _build.stream(x))
    _build.check_launch(rc, "tower_conv")
    _build.count("tower_conv")
    return out
