"""Checkpoint save/load in the JAX package's ``.npz`` layout.

The same file as mccnn_tpu/models/checkpoint.py writes and reads: one
array a leaf of the parameter tree under its JAX key path
(``params['tower'][0]['w']``, conv kernels HWIO, dense weights
(n_in, n_out)), each extra tree under its own name (the trainer's
momentum: ``momentum['tower'][0]['w']``), and ``__meta__``, the JSON
``{"opt": ..., "treedef": null}``. Either package reads what the other
writes, so a run can ``-resume`` across them.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from mccnn_tpu_torch.models.towers import (FastTower, SlowNet,
                                           params_from_numpy, params_to_numpy)

_KEY = re.compile(r"^(\w+)\['(tower|head)'\]\[(\d+)\]\['([wb])'\]$")


def _flatten(tree: dict, prefix: str) -> dict:
    return {f"{prefix}['{part}'][{i}]['{k}']": layer[k]
            for part in ("tower", "head") for i, layer in enumerate(tree[part])
            for k in ("w", "b")}


def save(fname: str, net: FastTower | SlowNet, opt: dict,
         extra: dict | None = None) -> str:
    """Write ``net``'s weights, ``opt`` (JSON) and each ``extra`` entry,
    a list of tensors in ``net.parameters()`` order, laid out as the
    parameters are."""
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    flat = _flatten(params_to_numpy(net), "params")
    for name, tensors in (extra or {}).items():
        flat.update(_flatten(params_to_numpy(net, tensors), name))
    meta = {"opt": opt, "treedef": None}
    np.savez(fname, __meta__=json.dumps(meta, default=str), **flat)
    return fname


def load(fname: str):
    """Read a checkpoint of either package. Returns ``(net, opt,
    extras)``: the network (a :class:`FastTower` when the file has no
    head layers, else a :class:`SlowNet`), the ``opt`` dict, and each
    extra tree as a list of float32 tensors in ``net.parameters()``
    order, in the parameters' layouts."""
    trees: dict[str, dict] = {}
    with np.load(fname, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        for key in data.files:
            m = _KEY.match(key)
            if m:
                name, part, i, k = m.groups()
                parts = trees.setdefault(name, {"tower": {}, "head": {}})
                parts[part].setdefault(int(i), {})[k] = data[key]
    if "params" not in trees or not trees["params"]["tower"]:
        raise ValueError(f"{fname}: no params['tower'] layers")
    nets = {}
    for name, parts in trees.items():
        tree = {}
        for part, layers in parts.items():
            if sorted(layers) != list(range(len(layers))) \
                    or any(len(v) != 2 for v in layers.values()):
                raise ValueError(f"{fname}: incomplete {name}['{part}'] "
                                 "layers")
            tree[part] = [layers[i] for i in range(len(layers))]
        nets[name] = params_from_numpy(tree)
    net = nets.pop("params")
    shapes = [p.shape for p in net.parameters()]
    extras = {}
    for name, other in nets.items():
        tensors = [p.detach().clone() for p in other.parameters()]
        if [t.shape for t in tensors] != shapes:
            raise ValueError(f"{fname}: {name} does not match params' shapes")
        extras[name] = tensors
    return net, meta["opt"], extras
