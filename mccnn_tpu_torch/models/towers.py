"""The matching networks, image mode (main.lua:660-749).

- fast (main.lua:726-748): l1 conv(ks×ks, fm) layers with SAME padding
  and ReLU between them (none after the last), then per-pixel L2
  normalization.
- slow (main.lua:663-695): l1 conv layers with ReLU after every one and
  no normalization, then the FC head over concatenated descriptors:
  l2 Linear(nh2) + ReLU layers, Linear(nh2 -> 1), sigmoid.

The patch (VALID) mode waits for training (ROADMAP.md, queue 1).

Both towers take the compute dtype of ``-dtype`` (``apply_tower``,
mccnn_tpu/models/towers.py:70-93): in a 16-bit dtype every layer's
input and weights are rounded to it, the products summed in float32,
the bias added in float32 and the sum rounded once, and ReLU and the L2
normalization run on the rounded values; the output is widened to
float32. The layer is the float32 convolution of the rounded operands
(:func:`_conv`): a cuDNN bf16 convolution would round its sum before
the bias add, twice where the JAX package rounds once.

Weights are interchangeable with the JAX package's parameter tree
``{"tower": [{"w": (ks, ks, cin, cout), "b": (cout,)}], "head":
[{"w": (n_in, n_out), "b": (n_out,)}]}`` (HWIO convs, (in, out)
dense layers): :func:`params_from_numpy` converts it, :func:`load_npz`
reads its ``.npz`` checkpoints.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn


def l2_normalize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-pixel feature normalization over the channel axis 1:
    x / sqrt(sum_c x^2 + eps) (adcensus.cu:1284-1308; eps is added to
    the squared norm)."""
    return x / torch.sqrt((x * x).sum(dim=1, keepdim=True) + eps)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One conv layer in ``dtype``: as it is in float32; otherwise
    ``x`` (already in ``dtype``) and the weights rounded to it, summed
    in float32 (the caller turns TF32 off), the bias added in float32
    and the result rounded to ``dtype``."""
    if dtype == torch.float32:
        return conv(x)
    h = torch.nn.functional.conv2d(x.float(), conv.weight.to(dtype).float(),
                                   None, padding=conv.padding)
    return (h + conv.bias[:, None, None]).to(dtype)


class FastTower(nn.Module):
    """Conv tower over (N, n_input_plane, H, W) images; returns
    L2-normalized (N, fm, H, W) features at full resolution."""

    def __init__(self, l1: int, fm: int, ks: int, n_input_plane: int = 1):
        super().__init__()
        if ks % 2 != 1:
            raise ValueError(f"SAME padding needs an odd kernel size, got {ks}")
        self.convs = nn.ModuleList(
            nn.Conv2d(n_input_plane if i == 0 else fm, fm, ks, padding=ks // 2)
            for i in range(l1))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
        x = x.to(dtype)
        for i, conv in enumerate(self.convs):
            x = _conv(conv, x, dtype)
            if i < len(self.convs) - 1:
                x = torch.relu(x)
        return l2_normalize(x).float()


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
            nn.Conv2d(n_input_plane if i == 0 else fm, fm, ks, padding=ks // 2)
            for i in range(l1))
        self.head = nn.ModuleList(
            [nn.Linear(2 * fm if i == 0 else nh2, nh2) for i in range(l2)]
            + [nn.Linear(nh2, 1)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
        x = x.to(dtype)
        for conv in self.convs:
            x = torch.relu(_conv(conv, x, dtype))
        return x.float()

    def score(self, pair: torch.Tensor) -> torch.Tensor:
        """(..., 2*fm) -> (...,) sigmoid match score, a dissimilarity
        (main.lua:670-675, 848-849)."""
        h = pair
        for layer in self.head[:-1]:
            h = torch.relu(layer(h))
        return torch.sigmoid(self.head[-1](h))[..., 0]


def _torch_init(modules, generator: torch.Generator) -> None:
    """Torch's default init, uniform(±1/sqrt(fan_in)) for weights and
    biases (fan_in = kh*kw*cin for a conv, n_in for a Linear), drawn
    from ``generator`` in module order."""
    with torch.no_grad():
        for mod in modules:
            fan_in = mod.weight[0].numel()
            stdv = 1.0 / math.sqrt(fan_in)
            for p in (mod.weight, mod.bias):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * stdv)


def init_fast(cfg, generator: torch.Generator) -> FastTower:
    """A fast tower of the config's widths with Torch's default init
    drawn from ``generator``."""
    tower = FastTower(cfg.l1, cfg.fm, cfg.ks, cfg.n_input_plane)
    _torch_init(tower.convs, generator)
    return tower


def init_slow(cfg, generator: torch.Generator) -> SlowNet:
    """A slow net of the config's widths (l1, fm, ks, l2, nh2) with
    Torch's default init drawn from ``generator``."""
    net = SlowNet(cfg.l1, cfg.fm, cfg.ks, cfg.l2, cfg.nh2, cfg.n_input_plane)
    _torch_init(list(net.convs) + list(net.head), generator)
    return net


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


_KEY = re.compile(r"^params\['(tower|head)'\]\[(\d+)\]\['([wb])'\]$")


def load_npz(fname: str) -> FastTower | SlowNet:
    """Read a checkpoint written by the JAX package
    (``models/checkpoint.py``: keys ``params['tower'][i]['w']`` and, for
    the slow arch, ``params['head'][i]['w']``)."""
    parts: dict[str, dict[int, dict]] = {"tower": {}, "head": {}}
    with np.load(fname, allow_pickle=False) as data:
        for key in data.files:
            m = _KEY.match(key)
            if m:
                parts[m.group(1)].setdefault(int(m.group(2)), {})[
                    m.group(3)] = data[key]
    tree = {}
    for name, layers in parts.items():
        if sorted(layers) != list(range(len(layers))) \
                or any(len(v) != 2 for v in layers.values()):
            raise ValueError(f"{fname}: incomplete params['{name}'] layers")
        tree[name] = [layers[i] for i in range(len(layers))]
    if not tree["tower"]:
        raise ValueError(f"{fname}: no params['tower'] layers")
    return params_from_numpy(tree)
