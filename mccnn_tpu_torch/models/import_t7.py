"""Reference-checkpoint interop: the reference's ``.t7`` nets.

``params_from_t7`` reads a net saved by the reference's ``save_net``
(main.lua:566-600: ``torch.save(fname, {net_te[, net_te2], opt},
'ascii')``) into a :class:`~mccnn_tpu_torch.models.towers.FastTower` or
:class:`~mccnn_tpu_torch.models.towers.SlowNet`. ``params_to_t7`` writes
a net back into that exact object tree (fast: [convs+ReLU...,
Normalize2, StereoJoin]; slow: net_te convs + net_te2 1x1-conv FC head,
main.lua:680-695, 738-746), loadable by ``main.lua -net_fname``
(main.lua:892-902). The object trees and the files are those of the JAX
package's ``mccnn_tpu/models/import_t7.py``, byte for byte.

Layouts: torch conv weights are (nOut, nIn, kH, kW), as the port's;
SpatialConvolution1_fw weights are (nOut, nIn) with bias (1, nOut, 1, 1)
(SpatialConvolution1_fw.lua:1-31). The conversion goes through the JAX
parameter tree (HWIO convs, (nIn, nOut) dense) and
:func:`~mccnn_tpu_torch.models.towers.params_from_numpy`, the route the
``.npz`` checkpoints take.
"""

from __future__ import annotations

import numpy as np

from mccnn_tpu_torch.data.t7 import (T7Object, Tensor, dump_t7_ascii,
                                     load_t7_ascii)
from mccnn_tpu_torch.models.towers import (FastTower, SlowNet,
                                           params_from_numpy, params_to_numpy)


def _modules(seq: T7Object) -> list:
    mods = seq.fields.get("modules", {})
    return [mods[k] for k in sorted(k for k in mods if isinstance(k, int))]


def _collect_weighted(seq: T7Object) -> list[tuple[np.ndarray, np.ndarray]]:
    out = []
    for m in _modules(seq):
        if not isinstance(m, T7Object):
            continue
        if m.get("modules") is not None:
            out.extend(_collect_weighted(m))
        elif m.get("weight") is not None and m.get("bias") is not None:
            out.append((np.asarray(m["weight"], np.float32),
                        np.asarray(m["bias"], np.float32)))
    return out


def params_from_t7(path: str) -> tuple[FastTower | SlowNet, dict]:
    """Load a reference checkpoint -> (net, opt dict): a fast tower, or
    a slow net when the file holds a head (net_te2)."""
    root = load_t7_ascii(path)
    if not isinstance(root, dict) or 1 not in root:
        raise ValueError(f"{path}: not a save_net checkpoint")
    n = len(root)
    is_slow = n >= 3 and isinstance(root.get(2), T7Object)
    opt = root[n] if isinstance(root.get(n), dict) else {}

    tower = []
    for w, b in _collect_weighted(root[1]):
        if w.ndim != 4:
            raise ValueError(f"tower module weight has ndim {w.ndim}")
        tower.append({"w": np.transpose(w, (2, 3, 1, 0)), "b": b.ravel()})
    if not tower:
        raise ValueError(f"{path}: no convolution in net_te")

    head = []
    if is_slow:
        for w, b in _collect_weighted(root[2]):
            if w.ndim != 2:
                raise ValueError(f"head module weight has ndim {w.ndim}")
            head.append({"w": w.T.copy(), "b": b.ravel()})
    return params_from_numpy({"tower": tower, "head": head}), opt


def _conv_module(w: np.ndarray, b: np.ndarray, pad: int) -> T7Object:
    kh, kw, c_in, c_out = w.shape
    return T7Object("cudnn.SpatialConvolution", {
        "nInputPlane": float(c_in), "nOutputPlane": float(c_out),
        "kW": float(kw), "kH": float(kh), "dW": 1.0, "dH": 1.0,
        "padW": float(pad), "padH": float(pad), "groups": 1.0,
        "train": False,
        "weight": Tensor(np.transpose(np.asarray(w), (3, 2, 0, 1)),
                         "torch.CudaTensor"),
        "bias": Tensor(np.asarray(b), "torch.CudaTensor"),
    })


def _relu() -> T7Object:
    return T7Object("cudnn.ReLU", {"inplace": True, "train": False,
                                   "mode": "CUDNN_ACTIVATION_RELU"})


def _seq(mods: list) -> T7Object:
    return T7Object("nn.Sequential", {
        "modules": {i + 1: m for i, m in enumerate(mods)}, "train": False})


def params_to_t7(net: FastTower | SlowNet, path: str, *, arch: str,
                 opt: dict | None = None, disp_max: int = 1) -> None:
    """Write ``net`` as a reference-format ascii checkpoint of ``arch``
    ("fast" or "slow", which must be the net's)."""
    want = {"fast": FastTower, "slow": SlowNet}.get(arch)
    if want is None:
        raise ValueError(arch)
    if not isinstance(net, want):
        raise TypeError(f"arch {arch!r} needs a {want.__name__}, got "
                        f"{type(net).__name__}")
    opt = dict(opt or {})
    params = params_to_numpy(net)
    tower = [(l["w"], l["b"]) for l in params["tower"]]
    pad = (tower[0][0].shape[0] - 1) // 2
    if arch == "fast":
        mods: list = []
        for i, (w, b) in enumerate(tower):
            mods.append(_conv_module(w, b, pad))
            if i < len(tower) - 1:
                mods.append(_relu())
        mods.append(T7Object("nn.Normalize2", {"train": False}))
        mods.append(T7Object("nn.StereoJoin", {"disp_max": float(disp_max),
                                               "train": False}))
        dump_t7_ascii({1: _seq(mods), 2: opt}, path)
        return
    conv_mods: list = []
    for w, b in tower:
        conv_mods.append(_conv_module(w, b, pad))
        conv_mods.append(_relu())
    head_mods: list = []
    head = [(l["w"], l["b"]) for l in params["head"]]
    for i, (w, b) in enumerate(head):
        head_mods.append(T7Object("nn.SpatialConvolution1_fw", {
            "weight": Tensor(w.T.copy(), "torch.CudaTensor"),
            "bias": Tensor(b.reshape(1, -1, 1, 1), "torch.CudaTensor"),
            "train": False,
        }))
        if i < len(head) - 1:
            head_mods.append(_relu())
    head_mods.append(T7Object("cudnn.Sigmoid", {"inplace": True,
                                                "train": False}))
    dump_t7_ascii({1: _seq(conv_mods), 2: _seq(head_mods), 3: opt}, path)
