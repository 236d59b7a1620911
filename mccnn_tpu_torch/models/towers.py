"""The matching networks (main.lua:660-749).

- fast (main.lua:726-748): l1 conv(ks×ks, fm) layers with ReLU between
  them (none after the last), then per-pixel L2 normalization.
- slow (main.lua:663-695): l1 conv layers with ReLU after every one and
  no normalization, then the FC head over concatenated descriptors:
  l2 Linear(nh2) + ReLU layers, Linear(nh2 -> 1), sigmoid.

One set of weights drives both modes of the towers (``apply_tower``'s
``padding``, mccnn_tpu/models/towers.py:70-93): ``padding="same"``, the
image mode of prediction (the reference's test net pads by ks // 2,
main.lua:680-683, 738-746), and ``padding="valid"``, the patch mode of
training, where a ws×ws patch gives one (fm, 1, 1) descriptor.

Both towers take the compute dtype of ``-dtype`` (``apply_tower``,
mccnn_tpu/models/towers.py:70-93): in a 16-bit dtype every layer's
input and weights are rounded to it, the products summed in float32,
the bias added in float32 and the sum rounded once, and ReLU and the L2
normalization run on the rounded values; the output is widened to
float32. The layer is the float32 convolution of the rounded operands
(:func:`_conv`): a cuDNN bf16 convolution would round its sum before
the bias add, twice where the JAX package rounds once. The casts are
autograd's, so the backward pass rounds the gradients where the JAX
package's ``convert_element_type`` transposes round them. The slow
head's :meth:`SlowNet.score` rounds as ``apply_head`` does
(mccnn_tpu/models/towers.py:103-120).

Prediction runs the towers through :meth:`FastTower.infer` and
:meth:`SlowNet.infer` (``padding="same"``, no autograd): each layer a
convolution (``ops/conv.py`` ``conv3x3``: the hand kernels of
``csrc/conv.cu`` on CUDA, :func:`_conv_acc`'s arithmetic on the CPU)
with the bias, the rounding to the compute dtype and ReLU in its
epilogue (the bits of ``tower.bias_act`` on the bias-free output), and
for the fast tower's last layer a bias-free convolution, then the bias
and the L2 normalization of ``ops/tower.py``, written as the features or
straight into the join's operands (``tower.normalize``). Their plain
versions, on CPU tensors, are the operations of :meth:`forward` in its
order. Training runs :meth:`forward`, whose convolutions stay cuDNN's.

Weights are interchangeable with the JAX package's parameter tree
``{"tower": [{"w": (ks, ks, cin, cout), "b": (cout,)}], "head":
[{"w": (n_in, n_out), "b": (n_out,)}]}`` (HWIO convs, (in, out)
dense layers): :func:`params_from_numpy` converts it,
:func:`params_to_numpy` converts back, and ``models/checkpoint.py``
reads and writes its ``.npz`` checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mccnn_tpu_torch.models import prng
from mccnn_tpu_torch.ops import conv as tower_conv
from mccnn_tpu_torch.ops import tower
from mccnn_tpu_torch.ops.tower import l2_normalize


PADDINGS = ("same", "valid")


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
          padding: str) -> torch.Tensor:
    """One conv layer in ``dtype``: as it is in float32; otherwise
    ``x`` (already in ``dtype``) and the weights rounded to it, summed
    in float32 (the caller turns TF32 off), the bias added in float32
    and the result rounded to ``dtype``. ``padding``: "same" pads by
    ks // 2, "valid" not at all."""
    if dtype == torch.float32:
        pad = conv.kernel_size[0] // 2 if padding == "same" else 0
        return F.conv2d(x, conv.weight, conv.bias, padding=pad)
    h = _conv_acc(conv, x, dtype, padding)
    return (h + conv.bias[:, None, None]).to(dtype)


def _conv_acc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
              padding: str = "same") -> torch.Tensor:
    """One layer's bias-free convolution, float32: ``x`` (float32, or
    values of ``dtype``) and the weights rounded to ``dtype``, summed in
    float32 (the caller turns TF32 off)."""
    pad = conv.kernel_size[0] // 2 if padding == "same" else 0
    w = conv.weight if dtype == torch.float32 else conv.weight.to(dtype)
    return F.conv2d(x.float(), w.float(), None, padding=pad)


def _check_padding(padding: str) -> None:
    if padding not in PADDINGS:
        raise ValueError(f"padding must be one of {PADDINGS}, got {padding!r}")


class FastTower(nn.Module):
    """Conv tower over (N, n_input_plane, H, W) images; returns
    L2-normalized (N, fm, H, W) features at full resolution, or
    (N, fm, H - ws + 1, W - ws + 1) with ``padding="valid"``."""

    def __init__(self, l1: int, fm: int, ks: int, n_input_plane: int = 1):
        super().__init__()
        if ks % 2 != 1:
            raise ValueError(f"SAME padding needs an odd kernel size, got {ks}")
        self.convs = nn.ModuleList(
            nn.Conv2d(n_input_plane if i == 0 else fm, fm, ks)
            for i in range(l1))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                padding: str = "same") -> torch.Tensor:
        _check_padding(padding)
        x = x.to(dtype)
        for i, conv in enumerate(self.convs):
            x = _conv(conv, x, dtype, padding)
            if i < len(self.convs) - 1:
                x = torch.relu(x)
        return l2_normalize(x).float()

    @torch.no_grad()
    def infer(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
              pack=None):
        """:meth:`forward` of prediction (``padding="same"``): each layer's
        convolution with its bias and ReLU (``tower_conv.conv3x3``) but the
        last's, whose bias-free convolution ``tower.normalize`` finishes.
        The (N, fm, H, W) float32 features, or with ``pack`` = (disp_max,
        sides) and N = 2 the join's operands (``join.Operands``)."""
        x = x.to(dtype)
        for conv in self.convs[:-1]:
            x = tower_conv.conv3x3(x, conv.weight, dtype, conv.bias, True)
        last = self.convs[-1]
        return tower.normalize(tower_conv.conv3x3(x, last.weight, dtype),
                               last.bias, dtype, pack)


class SlowNet(nn.Module):
    """The accurate network: ``forward`` maps (N, n_input_plane, H, W)
    images to (N, fm, H, W) descriptors (ReLU after every conv, no
    normalization); ``head`` holds the FC layers, which
    :meth:`score` applies to (..., 2*fm) concatenated descriptors."""

    def __init__(self, l1: int, fm: int, ks: int, l2: int, nh2: int,
                 n_input_plane: int = 1):
        super().__init__()
        if ks % 2 != 1:
            raise ValueError(f"SAME padding needs an odd kernel size, got {ks}")
        self.convs = nn.ModuleList(
            nn.Conv2d(n_input_plane if i == 0 else fm, fm, ks)
            for i in range(l1))
        self.head = nn.ModuleList(
            [nn.Linear(2 * fm if i == 0 else nh2, nh2) for i in range(l2)]
            + [nn.Linear(nh2, 1)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                padding: str = "same") -> torch.Tensor:
        _check_padding(padding)
        x = x.to(dtype)
        for conv in self.convs:
            x = torch.relu(_conv(conv, x, dtype, padding))
        return x.float()

    @torch.no_grad()
    def infer(self, x: torch.Tensor, dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
        """:meth:`forward` of prediction (``padding="same"``): each layer's
        convolution with its bias and ReLU (``tower_conv.conv3x3``); the
        (N, fm, H, W) float32 descriptors."""
        x = x.to(dtype)
        for conv in self.convs:
            x = tower_conv.conv3x3(x, conv.weight, dtype, conv.bias, True)
        return x

    def score(self, pair: torch.Tensor, dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
        """(..., 2*fm) -> (...,) sigmoid match score, a dissimilarity
        (main.lua:670-675, 848-849). In a 16-bit ``dtype`` each layer's
        operands are rounded to it, the product summed in float32 plus
        the bias, then ReLU and a round to ``dtype``; the last layer's
        sum stays float32 for the sigmoid (``apply_head``). On CUDA the
        caller keeps TF32 off (``torch.backends.cuda.matmul``)."""
        if dtype == torch.float32:
            h = pair
            for layer in self.head[:-1]:
                h = torch.relu(layer(h))
            return torch.sigmoid(self.head[-1](h))[..., 0]
        h = pair.to(dtype)
        for layer in self.head[:-1]:
            h = F.linear(h.float(), layer.weight.to(dtype).float(), layer.bias)
            h = torch.relu(h).to(dtype)
        last = self.head[-1]
        h = F.linear(h.float(), last.weight.to(dtype).float(), last.bias)
        return torch.sigmoid(h)[..., 0]


def _stdv(fan_in: int) -> np.float32:
    """1/sqrt(fan_in) in float32, as ``1.0 / jnp.sqrt(n)`` gives it."""
    return np.float32(1.0) / np.sqrt(np.float32(fan_in))


def _layer(k: np.ndarray, w_shape: tuple, fan_in: int) -> dict:
    """One layer of the JAX tree, weights and bias uniform in
    ±1/sqrt(fan_in) (Torch's default init), drawn as
    ``_conv_init`` / ``_dense_init`` draw them: the layer's key split
    once into (w, b)."""
    kw, kb = prng.split(k)
    s = _stdv(fan_in)
    return {"w": prng.uniform(kw, w_shape, -s, s),
            "b": prng.uniform(kb, (w_shape[-1],), -s, s)}


def init_tree(cfg, seed: int, slow: bool) -> dict:
    """The JAX package's seeded init (mccnn_tpu/cli.py ``init_params``,
    mccnn_tpu/models/towers.py ``init_fast`` / ``init_slow``) as its
    parameter tree of numpy arrays, bit for bit: the key of ``seed``
    split into l1 (fast) or l1 + l2 + 1 (``slow``) layer keys."""
    ks, fm = cfg.ks, cfg.fm
    n_head = cfg.l2 + 1 if slow else 0
    keys = prng.split(prng.key(seed), cfg.l1 + n_head)
    tower = []
    for i in range(cfg.l1):
        c_in = cfg.n_input_plane if i == 0 else fm
        tower.append(_layer(keys[i], (ks, ks, c_in, fm), ks * ks * c_in))
    head = []
    for i in range(n_head):
        n_in = 2 * fm if i == 0 else cfg.nh2
        n_out = 1 if i == cfg.l2 else cfg.nh2
        head.append(_layer(keys[cfg.l1 + i], (n_in, n_out), n_in))
    return {"tower": tower, "head": head}


def init_fast(cfg, seed: int) -> FastTower:
    """A fast tower of the config's widths with the JAX package's init
    from ``seed`` (:func:`init_tree`)."""
    return params_from_numpy(init_tree(cfg, seed, slow=False))


def init_slow(cfg, seed: int) -> SlowNet:
    """A slow net of the config's widths (l1, fm, ks, l2, nh2) with the
    JAX package's init from ``seed`` (:func:`init_tree`)."""
    return params_from_numpy(init_tree(cfg, seed, slow=True))


def init_net(cfg) -> FastTower | SlowNet | None:
    """The network of ``cfg.arch`` with the JAX package's init from
    ``cfg.seed``: a fast tower, a slow net, or None for ad and census,
    which use none. One seed gives the same weights in both packages."""
    if cfg.arch == "fast":
        return init_fast(cfg, cfg.seed)
    if cfg.arch == "slow":
        return init_slow(cfg, cfg.seed)
    return None


def params_from_numpy(tree) -> FastTower | SlowNet:
    """The network holding the JAX parameter tree's weights: a
    :class:`FastTower` when the head is empty, else a :class:`SlowNet`.
    Conv kernels go from HWIO (ks, ks, cin, cout) to OIHW, dense
    weights from (n_in, n_out) to (n_out, n_in)."""
    layers = tree["tower"]
    head = tree.get("head") or []
    ks, _, cin, fm = np.shape(layers[0]["w"])
    if head:
        nh2 = np.shape(head[0]["w"])[1]
        net = SlowNet(len(layers), fm, ks, len(head) - 1, nh2, cin)
    else:
        net = FastTower(len(layers), fm, ks, cin)

    def arr(v):
        return torch.tensor(np.asarray(v, np.float32))

    with torch.no_grad():
        for conv, layer in zip(net.convs, layers):
            conv.weight.copy_(arr(layer["w"]).permute(3, 2, 0, 1))
            conv.bias.copy_(arr(layer["b"]))
        for lin, layer in zip(getattr(net, "head", []), head):
            lin.weight.copy_(arr(layer["w"]).T)
            lin.bias.copy_(arr(layer["b"]))
    return net


def params_to_numpy(net: FastTower | SlowNet,
                    tensors: list[torch.Tensor] | None = None) -> dict:
    """The inverse of :func:`params_from_numpy`: the JAX parameter tree
    of numpy float32 arrays, conv kernels HWIO, dense weights
    (n_in, n_out). ``tensors``: one tensor a parameter in
    ``net.parameters()`` order (such as the trainer's momentum), laid
    out the same way; default the parameters themselves."""
    params = list(net.parameters())
    tensors = params if tensors is None else list(tensors)
    if len(tensors) != len(params):
        raise ValueError(f"{len(tensors)} tensors for {len(params)} "
                         "parameters")
    it = iter(t.detach().float().cpu().numpy() for t in tensors)

    def layers(mods, perm):
        return [{"w": np.ascontiguousarray(next(it).transpose(perm)),
                 "b": next(it)} for _ in mods]

    tree = {"tower": layers(net.convs, (2, 3, 1, 0))}
    tree["head"] = layers(getattr(net, "head", []), (1, 0))
    return tree


def print_net(cfg) -> None:
    """Topology printer: one line per layer of the training net, the
    shape the reference prints at net construction (print_net,
    main.lua:542-564, called at main.lua:751), line for line as the JAX
    package prints it."""
    n_in = cfg.n_input_plane
    lines = []
    if cfg.arch == "slow":
        for i in range(cfg.l1):
            lines.append(f"conv(in={n_in if i == 0 else cfg.fm}, "
                         f"out={cfg.fm}, k={cfg.ks})")
            lines.append("relu")
        lines.append(f"reshape({cfg.bs}x{2 * cfg.fm})")
        for i in range(cfg.l2):
            lines.append(f"linear({2 * cfg.fm if i == 0 else cfg.nh2} "
                         f"-> {cfg.nh2})")
            lines.append("relu")
        lines.append(f"linear({cfg.nh2} -> 1)")
        lines.append("sigmoid")
    elif cfg.arch == "fast":
        # ReLU between convs but not after the last (main.lua:726-735)
        for i in range(cfg.l1):
            lines.append(f"conv(in={n_in if i == 0 else cfg.fm}, "
                         f"out={cfg.fm}, k={cfg.ks})")
            if i < cfg.l1 - 1:
                lines.append("relu")
        lines.append("l2_normalize")
        lines.append("stereo_join1")
    print("\n".join(lines))
