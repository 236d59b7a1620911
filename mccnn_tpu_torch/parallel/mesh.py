"""Device meshes (mccnn_tpu/parallel/mesh.py).

The JAX package builds a ``jax.sharding.Mesh`` and GSPMD places the
shards. The port keeps its single controller: one process drives every
device of a :class:`Mesh`, each device's share runs in mesh order on the
calling thread, and tensors move between devices by ``.to(device)``
copies, the counterpart of XLA's collectives (no ``torch.distributed``
process group). A mesh may list one device more than once; every
sharding path then runs on one card, its shards one after another.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from mccnn_tpu_torch.pipeline import resolve_device


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``, so that entries compare
    equal to the devices of the tensors placed on them."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """``devices``: a numpy object array of ``torch.device``, shaped like
    the mesh (built from any device array, entries repeated or not);
    ``axis_names``: one name an axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_indexed(torch.device(d)) for d in arr.flat]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or self.devices.size == 0:
            raise ValueError(f"a mesh of shape {self.devices.shape} needs one "
                             f"name an axis, got {self.axis_names}")

    @property
    def size(self) -> int:
        return self.devices.size

    def entries(self, axis: str) -> list[int]:
        """The flat indices of the entries that hold the shards of a split
        over ``axis``, in mesh order: index 0 of every other axis (GSPMD
        would compute the same shard again on the others)."""
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in {self.axis_names}")
        ids = np.arange(self.size).reshape(self.devices.shape)
        i = self.axis_names.index(axis)
        return [int(k) for k in np.moveaxis(ids, i, 0).reshape(
            ids.shape[i], -1)[:, 0]]

    def along(self, axis: str) -> list[torch.device]:
        """The devices of :meth:`entries`."""
        return [self.devices.flat[k] for k in self.entries(axis)]


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              backend: Optional[str] = None) -> Mesh:
    """Mesh over the first ``n_devices`` devices (all by default).

    axes=("data",) for data parallelism; axes=("data", "model") with
    ``shape`` (e.g. (2, 4)) for batch × volume sharding. ``backend``:
    None or "cuda" for the CUDA cards, which raises where there is none
    (no fallback to the CPU); "cpu" for ``n_devices`` entries of the host
    (one by default), the counterpart of the JAX tests' virtual CPU
    devices."""
    if backend == "cpu":
        devs = [torch.device("cpu")] * (1 if n_devices is None else n_devices)
    elif backend in (None, "cuda"):
        resolve_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"{n_devices} devices asked, {len(devs)} "
                                 "CUDA device(s) visible")
            devs = devs[:n_devices]
    else:
        raise ValueError(f"backend must be None, 'cuda' or 'cpu', got "
                         f"{backend!r}")
    if shape is None:
        if len(axes) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (len(devs),)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), axes)


def replicated(x, mesh: Mesh) -> list:
    """``x`` on every entry of the mesh, in flat order: a tensor moved
    (shared by the entries of one device, as nothing writes to it), a
    module copied, so that each entry owns its replica (the data-parallel
    step updates the first and copies it to the others)."""
    if isinstance(x, torch.nn.Module):
        return [copy.deepcopy(x).to(dev) for dev in mesh.devices.flat]
    return [x.to(dev) for dev in mesh.devices.flat]


def batch_sharded(x: torch.Tensor, mesh: Mesh, axis: str = "data",
                  dim: int = 0) -> list[torch.Tensor]:
    """``x`` split evenly along ``dim`` over the devices of ``axis``, a
    shard a device in mesh order; raises where the length does not
    divide (as ``jax.device_put`` does)."""
    devs = mesh.along(axis)
    n = x.shape[dim]
    if n % len(devs):
        raise ValueError(f"length {n} of dim {dim} does not split evenly "
                         f"over {len(devs)} devices")
    k = n // len(devs)
    return [x.narrow(dim, i * k, k).to(dev) for i, dev in enumerate(devs)]
