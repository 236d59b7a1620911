"""Data-parallel training over a device mesh
(mccnn_tpu/parallel/data_parallel.py).

The JAX package jits one train step whose batch is sharded over the
mesh's ``data`` axis, parameters and momentum replicated, and GSPMD
inserts the gradient all-reduce. The port's single controller does the
same by hand (see :mod:`mccnn_tpu_torch.parallel.mesh`): each shard's
loss and gradients on its device, in mesh order; the gradients reduced
onto the first device; the reference's update (``v = mom*v - lr*g;
w += v``, main.lua:871-874) there; the first replica copied to the
others.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.config import Config
from mccnn_tpu_torch.parallel.mesh import Mesh, batch_sharded
from mccnn_tpu_torch.pipeline import DTYPES
from mccnn_tpu_torch.train.augment import warp_patches
from mccnn_tpu_torch.train.trainer import loss_fn, no_tf32

# patches an example: (L, R+, L, R-) (train/augment.py build_batches)
PATCHES = 4


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> list[dict]:
    """A host batch of ``AugmentSampler.build_batches`` (numpy arrays or
    tensors, leading axis PATCHES rows an example, ``labels`` two) split
    over the devices of ``axis``: one dict a device, in mesh order, its
    tensors on that device. The loss is computed per shard, so each
    shard holds whole examples: a split that would cut one raises."""
    devs = mesh.along(axis)
    n_ex = len(batch["minv"]) // PATCHES
    if n_ex == 0 or n_ex % len(devs) \
            or any(len(v) % n_ex for v in batch.values()):
        raise ValueError(f"a batch of {len(batch['minv'])} patches does not "
                         f"split into whole examples over {len(devs)} devices")
    parts = {k: batch_sharded(torch.as_tensor(v), mesh, axis)
             for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(len(devs))]


def make_dp_train_step(cfg: Config, mesh: Mesh, axis: str = "data"):
    """The data-parallel train step (``make_dp_train_step``,
    mccnn_tpu/parallel/data_parallel.py:26-56): ``step(nets, momentum,
    lr, shards)`` runs one step in place, in the idiom of
    ``trainer.train_chunk``. ``nets``: ``replicated(net, mesh)``,
    one replica an entry of the mesh; ``momentum``: one tensor a
    parameter, on the first device of ``axis``; ``shards``:
    :func:`shard_batch`'s. Per shard, on its entry's
    replica: the warp, the loss, its gradients. The shards are equal in
    size, so the mean of their gradients, reduced onto the first device
    in mesh order, is the gradient of the global mean loss; the update
    runs there and every replica is then left equal to the first.
    Returns the global mean loss (0-d, on the first device). TF32 stays
    off."""
    entries = mesh.entries(axis)
    dev0 = mesh.devices.flat[entries[0]]
    kw = dict(arch=cfg.arch, m=float(cfg.m), pow=int(cfg.pow),
              dtype=DTYPES[cfg.dtype])
    mom = float(cfg.mom)

    def step(nets: list, momentum: list, lr: float, shards: list
             ) -> torch.Tensor:
        if len(nets) != mesh.size or len(shards) != len(entries):
            raise ValueError(f"expected {mesh.size} replicas and "
                             f"{len(entries)} shards, got {len(nets)} and "
                             f"{len(shards)}")
        grads, errs = None, []
        with no_tf32(dev0), torch.enable_grad():
            for k, shard in zip(entries, shards):
                net = nets[k]
                patches = warp_patches(shard["windows"], shard["minv"],
                                       shard["brightness"], shard["contrast"],
                                       ws=cfg.ws)
                err = loss_fn(net, patches, shard["labels"], **kw)
                g = [t.to(dev0) for t in
                     torch.autograd.grad(err, list(net.parameters()))]
                grads = g if grads is None else torch._foreach_add(grads, g)
                errs.append(err.detach().to(dev0))
        first = list(nets[entries[0]].parameters())
        with torch.no_grad():
            torch._foreach_div_(grads, float(len(shards)))
            # v = mom*v - lr*g; w += v (main.lua:871-874)
            torch._foreach_mul_(momentum, mom)
            torch._foreach_sub_(momentum, torch._foreach_mul(grads, lr))
            torch._foreach_add_(first, momentum)
            for net in nets:
                for p, p0 in zip(net.parameters(), first):
                    if p is not p0:
                        p.copy_(p0)
        return torch.stack(errs).mean()

    return step
