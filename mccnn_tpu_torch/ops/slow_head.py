"""Slow-arch cost volumes: the factored FC head over every disparity.

Behavior contract: the reference's slow-arch loop (main.lua:962-979) as
the JAX package computes it (``slow_volumes_mxu``,
mccnn_tpu/ops/slow_head_pallas.py:179-227):

    vol[d, y, x] = sigmoid(head(concat(fl[y, x], fr[y, x - d])))

Head layer 0 is linear in the concatenation, so it is factored once per
image: ``A = fl @ W0[:C] + b0`` and ``B = fr @ W0[C:]`` (float32
matmuls, TF32 off). Per cell the chain is then

    h = relu(A[y, x] + B[y, x - d])                         float32
    h = relu(bf16(h) @ bf16(W_m) + b_m)   per mid layer,  f32 accumulate
    s = sigmoid(h . w_last + b_last)                        float32

the TPU kernel's precision (slow_head_pallas.py:37-40, 88-99). A
bf16 x bf16 product is exact in float32, so any two implementations of
it differ only in summation order.

On CUDA tensors :func:`slow_head_volume` launches ``csrc/slow_head.cu``:
``wgmma`` bf16 on 128-cell tiles, the mid weights streamed through a
ring of shared-memory slabs by bulk asynchronous copies that a cluster
of two blocks shares (multicast). Two pieces of its preparation live
here, in plain torch: :func:`pack_weights` lays the weights out slab by
slab in the swizzled order the tensor cores read, and :func:`tile_plan`
counts the tiles the kernel walks (:func:`tile_at` is its walk). On CPU
tensors :func:`slow_head_volume` runs :func:`slow_head_plain`.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from mccnn_tpu_torch.ops import _build

# the feature widths the kernel has an instance of: 384 is every
# configuration's nh2, 64 serves narrow heads (tests)
CP_WIDTHS = (64, 384)
# a tile of the kernel: TILE_X columns by TILE_D disparities of one image
# row (XT and DT in csrc/slow_head.cu)
TILE_X, TILE_D = 16, 8


@contextlib.contextmanager
def f32_matmul():
    """Full-float32 matmuls (TF32 off) inside the block, restored after;
    the port never changes the global setting for good."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _chunk(D: int, cells: int, width: int, budget: int = 1 << 29) -> int:
    """Disparities per step of the plain chain: (chunk, H*W, width)
    float32 activations within ``budget`` bytes."""
    return max(1, min(D, budget // max(1, cells * width * 4)))


def shifted(B: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """(len(ds), H, W, C) stack of B[y, x - d], clamped to column 0 where
    x - d < 0 (those cells are masked by the caller)."""
    W = B.shape[1]
    idx = (torch.arange(W, device=B.device)[None, :] - ds[:, None]).clamp(min=0)
    return B[:, idx].permute(1, 0, 2, 3)


@torch.no_grad()
def slow_head_plain(A, B, mids_w, mids_b, w_last, b_last, disp_max: int
                    ) -> torch.Tensor:
    """s[d, y, x] for every d < disp_max as a chain of float32 matmuls
    over chunks of d, with the operands of the mid layers rounded to
    bf16 (``.to(torch.bfloat16).float()``). A, B: (H, W, C) float32;
    mids_w: (n_mid, C, C) (in, out); mids_b: (n_mid, C); w_last: (C,);
    b_last: scalar. Cells with x - d < 0 hold values of the clamped
    column."""
    H, W, C = A.shape
    D = int(disp_max)
    wq = mids_w.to(torch.bfloat16).float()
    mids_b = mids_b.float()
    w_last = w_last.float().reshape(C, 1)
    out = torch.empty((D, H, W), dtype=torch.float32, device=A.device)
    step = _chunk(D, H * W, C)
    with f32_matmul():
        for d0 in range(0, D, step):
            ds = torch.arange(d0, min(D, d0 + step), device=A.device)
            h = torch.relu(A[None] + shifted(B, ds))
            for m in range(wq.shape[0]):
                h = torch.relu(h.to(torch.bfloat16).float() @ wq[m] + mids_b[m])
            out[d0:d0 + len(ds)] = torch.sigmoid((h @ w_last)[..., 0] + b_last)
    return out


def slab_cols(C: int) -> int:
    """Output columns of one weight slab of the kernel's width-C
    instance: what one ``wgmma`` instruction covers."""
    return 192 if C == 384 else 64


def _swizzle(rows: int, device) -> torch.Tensor:
    """(rows, 8) chunk permutation of the 128-byte swizzle: position j
    of row n holds the 16-byte chunk j XOR (n mod 8). Its own inverse."""
    n = torch.arange(rows, device=device)[:, None] % 8
    return torch.arange(8, device=device)[None, :] ^ n


def pack_weights(mids_w: torch.Tensor) -> torch.Tensor:
    """The mid weights in the order the kernel streams them: (n_mid,
    C/64, C/NB, NB, 8, 8) with NB = :func:`slab_cols`. A slab [m, kb,
    nh] is NB rows, one per output unit nh*NB + n, of the 64 inputs
    kb*64 .. kb*64 + 63 as eight 16-byte chunks, chunk c stored at
    position c XOR (n mod 8): the image of the slab in shared memory in
    the 128-byte swizzle. mids_w: (n_mid, C, C) (in, out)."""
    n_mid, C, _ = mids_w.shape
    nb = slab_cols(C)
    t = mids_w.transpose(1, 2).reshape(n_mid, C // nb, nb, C // 64, 8, 8)
    t = t.permute(0, 3, 1, 2, 4, 5)  # (m, kb, nh, n, chunk, element)
    idx = _swizzle(nb, mids_w.device)[:, :, None].expand_as(t)
    return t.gather(4, idx).contiguous()


def unpack_weights(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_weights`: (n_mid, C, C) (in, out)."""
    n_mid, kb, nh, nb = packed.shape[:4]
    idx = _swizzle(nb, packed.device)[:, :, None].expand_as(packed)
    t = packed.gather(4, idx).permute(0, 2, 3, 1, 4, 5)
    return t.reshape(n_mid, nh * nb, kb * 64).transpose(1, 2).contiguous()


def _strip_blocks(x0: int, W: int, D: int) -> int:
    """Blocks of TILE_D disparities, of the strip of columns x0 ..
    x0 + TILE_X - 1, that have a cell with x >= d: d0 <= min(x0 +
    TILE_X - 1, W - 1) and d0 < D."""
    return min(-(-D // TILE_D), min(x0 + TILE_X - 1, W - 1) // TILE_D + 1)


def tile_plan(H: int, W: int, D: int) -> tuple[int, int]:
    """(tiles per image row, tiles in all) that the kernel walks: the
    tiles of TILE_X columns by TILE_D disparities that have a cell with
    x >= d."""
    per_row = sum(_strip_blocks(x0, W, D) for x0 in range(0, W, TILE_X))
    return per_row, H * per_row


def tile_at(t: int, W: int, D: int) -> tuple[int, int, int]:
    """(y, x0, d0) of tile t in the kernel's walk: image rows outermost,
    then strips of columns, the blocks of disparities fastest (blocks
    running together share A's rows and overlap in B's)."""
    per_row, _ = tile_plan(1, W, D)
    y, r, x0 = t // per_row, t % per_row, 0
    while r >= _strip_blocks(x0, W, D):
        r -= _strip_blocks(x0, W, D)
        x0 += TILE_X
    return y, x0, r * TILE_D


def _lib():
    lib = _build.library("slow_head")
    if lib.slow_head.argtypes is None:
        lib.slow_head.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float]
                                  + [ctypes.c_void_p] + [ctypes.c_int] * 6
                                  + [ctypes.c_longlong, ctypes.c_void_p])
        lib.slow_head.restype = ctypes.c_int
    return lib


def slow_head_volume(A, B, mids_w, mids_b, w_last, b_last, disp_max: int
                     ) -> torch.Tensor:
    """(disp_max, H, W) float32 head scores: the kernel on CUDA tensors,
    :func:`slow_head_plain` on CPU tensors. On CUDA the feature width C
    must be one of ``CP_WIDTHS`` (:func:`pad_head` pads), with at least
    one mid layer; mids_w is bf16. Cells with x - d < 0 are not written
    (the caller masks them)."""
    if not A.is_cuda:
        return slow_head_plain(A, B, mids_w, mids_b, w_last, b_last, disp_max)
    H, W, C = A.shape
    n_mid = mids_w.shape[0]
    for t, what in ((A, "slow_head A"), (B, "slow_head B"),
                    (mids_b, "slow_head mids_b"), (w_last, "slow_head w_last")):
        _build.check_cuda(t, what, torch.float32)
    _build.check_cuda(mids_w, "slow_head mids_w", torch.bfloat16)
    if C not in CP_WIDTHS or n_mid < 1 or B.shape != A.shape \
            or mids_w.shape != (n_mid, C, C) or mids_b.shape != (n_mid, C) \
            or w_last.shape != (C,):
        raise ValueError(f"slow_head: bad shapes A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, mids_w {tuple(mids_w.shape)}, "
                         f"mids_b {tuple(mids_b.shape)}, w_last "
                         f"{tuple(w_last.shape)}")
    wpk = pack_weights(mids_w)
    per_row, n_tiles = tile_plan(H, W, int(disp_max))
    out = torch.empty((int(disp_max), H, W), dtype=torch.float32,
                      device=A.device)
    rc = _lib().slow_head(A.data_ptr(), B.data_ptr(), wpk.data_ptr(),
                          mids_b.data_ptr(), w_last.data_ptr(),
                          float(b_last), out.data_ptr(), H, W, int(disp_max),
                          C, n_mid, per_row, n_tiles, _build.stream(A))
    _build.check_launch(rc, "slow_head")
    _build.count("slow_head")
    return out


def pad_head(A, B, mids_w, mids_b, w_last):
    """Zero-pad the feature width to the next width in ``CP_WIDTHS``:
    padded units get zero weights in and out, so they add nothing
    (exact, slow_head_pallas.py:200-211)."""
    C = A.shape[-1]
    if C > CP_WIDTHS[-1]:
        raise ValueError(f"slow_head: head width {C} is wider than the "
                         f"kernel's {CP_WIDTHS[-1]}")
    pad = min(w for w in CP_WIDTHS if w >= C) - C
    if pad == 0:
        return A, B, mids_w, mids_b, w_last
    F = torch.nn.functional
    return (F.pad(A, (0, pad)), F.pad(B, (0, pad)),
            F.pad(mids_w, (0, pad, 0, pad)), F.pad(mids_b, (0, pad)),
            F.pad(w_last, (0, pad)))


@torch.no_grad()
def head_operands(net, fl: torch.Tensor, fr: torch.Tensor,
                  dtype: torch.dtype = torch.float32):
    """(A, B, mids_w, mids_b, w_last, b_last) of the factored head for
    feature maps fl, fr (H, W, C); mids_w bf16 in (in, out) layout, the
    width padded for the kernel. In a 16-bit compute ``dtype`` the
    features and the first layer's weights are rounded to it and their
    products summed in float32 (slow_head_pallas.py:193-197); A and B
    stay float32. Detached: a view of a parameter keeps requires_grad
    even under no_grad."""
    head = net.head
    if len(head) < 3:
        raise ValueError("the slow head kernel needs at least one mid layer "
                         f"(l2 >= 2), got l2={len(head) - 1}")
    C = fl.shape[-1]
    w0 = head[0].weight.T  # (2C, nh2)
    fl, fr, w0 = (t.to(dtype).float() for t in (fl, fr, w0))
    with f32_matmul():
        A = fl @ w0[:C] + head[0].bias
        B = fr @ w0[C:]
    mids_w = torch.stack([l.weight.T for l in head[1:-1]]).to(torch.bfloat16)
    mids_b = torch.stack([l.bias for l in head[1:-1]]).float()
    A, B, mids_w, mids_b = (t.detach() for t in (A, B, mids_w, mids_b))
    w_last = head[-1].weight[0].detach().float()
    A, B, mids_w, mids_b, w_last = pad_head(A.contiguous(), B.contiguous(),
                                            mids_w, mids_b, w_last)
    return (A.contiguous(), B.contiguous(), mids_w.contiguous(),
            mids_b.contiguous(), w_last.contiguous(), float(head[-1].bias[0]))


def masked_volumes(s: torch.Tensor):
    """Both cost volumes (vol_l, vol_r) from the head scores s (D, H, W),
    NaN out of frame: vol_l[d, y, x] = s[d, y, x] where x - d >= 0 and
    vol_r[d, y, x] = s[d, y, x + d] where x + d < W (main.lua:966-977)."""
    D, H, W = s.shape
    xs = torch.arange(W, device=s.device)[None, None, :]
    ds = torch.arange(D, device=s.device)[:, None, None]
    vol_l = torch.where(xs - ds >= 0, s, torch.nan)
    idx = (xs + ds).clamp(max=W - 1).expand(D, H, W)
    vol_r = torch.where(xs + ds < W, s.gather(2, idx), torch.nan)
    return vol_l, vol_r


@torch.no_grad()
def slow_volumes(net, fl: torch.Tensor, fr: torch.Tensor, disp_max: int,
                 dtype: torch.dtype = torch.float32, n: int = 0,
                 disp_true=None):
    """Both slow-arch cost volumes (vol_l, vol_r), each (D, H, W) with
    NaN out of frame, for feature maps fl, fr (H, W, C). ``net``: a
    :class:`~mccnn_tpu_torch.models.towers.SlowNet`; ``dtype``: the
    compute dtype of :func:`head_operands`. The masks run in one pass with
    the ``n`` border columns of ``costs.fix_border`` and the 1e9 planes
    d >= ``disp_true`` (``tower.slow_epilogue``); the defaults give
    :func:`masked_volumes`."""
    from mccnn_tpu_torch.ops import tower

    return tower.slow_epilogue(
        slow_head_volume(*head_operands(net, fl, fr, dtype), int(disp_max)),
        n, disp_true)
