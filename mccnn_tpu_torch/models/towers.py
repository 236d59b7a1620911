"""The fast-arch matching network (main.lua:726-748).

l1 conv(ks×ks, fm) layers with SAME padding and ReLU between them (none
after the last), then per-pixel L2 normalization. Image mode only: the
patch (VALID) mode waits for training (ROADMAP.md, queue 1).

Weights are interchangeable with the JAX package's parameter tree
``{"tower": [{"w": (ks, ks, cin, cout), "b": (cout,)}], "head": []}``
(HWIO): :func:`params_from_numpy` converts it, :func:`load_npz` reads
its ``.npz`` checkpoints.
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i < len(self.convs) - 1:
                x = torch.relu(x)
        return l2_normalize(x)


def init_fast(cfg, generator: torch.Generator) -> FastTower:
    """A tower of the config's widths with Torch's default init,
    uniform(±1/sqrt(fan_in)) for weights and biases, drawn from
    ``generator``."""
    tower = FastTower(cfg.l1, cfg.fm, cfg.ks, cfg.n_input_plane)
    with torch.no_grad():
        for conv in tower.convs:
            cout, cin, kh, kw = conv.weight.shape
            stdv = 1.0 / math.sqrt(kh * kw * cin)
            for p in (conv.weight, conv.bias):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * stdv)
    return tower


def params_from_numpy(tree) -> FastTower:
    """A tower holding the JAX parameter tree's weights: conv kernels go
    from HWIO (ks, ks, cin, cout) to OIHW."""
    layers = tree["tower"]
    if tree.get("head"):
        raise ValueError("a fast-arch tree has no FC head")
    ks, _, cin, fm = np.shape(layers[0]["w"])
    tower = FastTower(len(layers), fm, ks, cin)
    with torch.no_grad():
        for conv, layer in zip(tower.convs, layers):
            w = torch.tensor(np.asarray(layer["w"], np.float32))
            conv.weight.copy_(w.permute(3, 2, 0, 1))
            conv.bias.copy_(torch.tensor(np.asarray(layer["b"], np.float32)))
    return tower


_KEY = re.compile(r"^params\['tower'\]\[(\d+)\]\['([wb])'\]$")


def load_npz(fname: str) -> FastTower:
    """Read a fast-arch checkpoint written by the JAX package
    (``models/checkpoint.py``: keys ``params['tower'][i]['w']``)."""
    layers: dict[int, dict] = {}
    with np.load(fname, allow_pickle=False) as data:
        for key in data.files:
            m = _KEY.match(key)
            if m:
                layers.setdefault(int(m.group(1)), {})[m.group(2)] = data[key]
            elif key.startswith("params['head']"):
                raise ValueError(f"{fname}: not a fast-arch checkpoint ({key})")
    if sorted(layers) != list(range(len(layers))) or not layers:
        raise ValueError(f"{fname}: no complete params['tower'] layers")
    return params_from_numpy({"tower": [layers[i] for i in range(len(layers))],
                              "head": []})
