"""Raw binary tensor IO with `.dim`/`.type` sidecar files.

Byte-compatible with the reference's dataset format (writer:
preprocess_kitti.lua:118-134 `tofile`; reader: main.lua:353-380
`fromfile`): ``<name>`` holds the raw little-endian buffer, ``<name>.dim``
the shape (one decimal per line), ``<name>.type`` one of
``float32|int32|int64``. Reads are memory-mapped so multi-GB datasets
cost no resident RAM until touched. Also the header-less float32 dumps
of the predict outputs.
"""

from __future__ import annotations

import os

import numpy as np

_DTYPES = {
    "float32": np.float32,
    "int32": np.int32,
    "int64": np.int64,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def fromfile(fname: str, mmap: bool = True) -> np.ndarray:
    """Load ``fname`` (+ ``.dim``/``.type`` sidecars) as an ndarray.

    A ``.dim`` of a single ``0`` denotes the empty tensor
    (main.lua:359-361).
    """
    with open(fname + ".dim") as f:
        dim = [int(line) for line in f.read().split()]
    if dim == [0]:
        return np.zeros((0,), np.float32)
    with open(fname + ".type") as f:
        type_name = f.read().strip()
    if type_name not in _DTYPES:
        raise ValueError(f"{fname}: unsupported type {type_name!r}")
    dtype = _DTYPES[type_name]
    if mmap:
        arr = np.memmap(fname, dtype=dtype, mode="r")
    else:
        arr = np.fromfile(fname, dtype=dtype)
    return arr.reshape(dim)


def tofile(fname: str, x: np.ndarray) -> None:
    """Write ndarray + sidecars (preprocess_kitti.lua:118-134 format)."""
    x = np.ascontiguousarray(x)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    name = _NAMES.get(x.dtype)
    if name is None:
        raise ValueError(f"unsupported dtype {x.dtype}")
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    x.tofile(fname)
    with open(fname + ".type", "w") as f:
        f.write(name)
    with open(fname + ".dim", "w") as f:
        for s in x.shape:
            f.write(f"{s}\n")


def write_raw_float32(fname: str, x) -> None:
    """Header-less float32 dump (predict outputs left/right/disp.bin,
    main.lua:1045,1103; loadable per samples/load_bin.py)."""
    np.asarray(x, dtype=np.float32).tofile(fname)
