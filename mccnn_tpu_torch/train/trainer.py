"""The training loop (mccnn_tpu/train/trainer.py).

Behavior contract (main.lua:753-890): SGD with momentum implemented
inline (``v = mom*v - lr*g; w += v``, main.lua:871-874), 14 epochs with
lr/10 at epoch 12, minibatches of ``bs/2`` ground-truth points → 4
patches each (anchor, pos, anchor, neg), hinge loss (fast) / BCE
(slow), loss-explosion guard (batches with err<0 or err>=100 excluded
with a WARNING, main.lua:861-866), per-epoch
``(epoch, mean_err, lr, elapsed)`` print, final checkpoint to
``net/net_<cmd_str>.npz``, then the action chains into test_te
(train_tr) or submit (train_all) (main.lua:884-888).

The host samples augmentation parameters and gathers windows (or, for
KITTI, only their origins) for a chunk of ``CHUNK_STEPS`` minibatches
at once, one chunk ahead on a thread, as the JAX loop does; the device
runs each step of the chunk: window gather and bicubic warp (one hand
kernel), forward, backward (autograd), update. On the card the chunk is
one replay of a CUDA graph captured once for each chunk size
(:func:`make_train_chunk`, the counterpart of the JAX package's jitted
scan); on the CPU its steps run eagerly (:func:`train_chunk`, the
graph's plain version). The chunk's losses stay on the device and
are read once a chunk. The update is the reference's, not
``torch.optim.SGD``'s (which keeps ``v = mom*v + g`` and steps
``w -= lr*v``: the two part at the lr drop and after a resume). On
CUDA the convolutions and the head's matmuls run with TF32 off.
"""

from __future__ import annotations

import contextlib
import time as _time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mccnn_tpu_torch.config import Config, cmd_str
from mccnn_tpu_torch.data.datasets import (StereoDataset, load_dataset,
                                           subset_nnz)
from mccnn_tpu_torch.models import checkpoint, towers
from mccnn_tpu_torch.ops import _build, conv
from mccnn_tpu_torch.pipeline import DTYPES, device_of, resolve_device
from mccnn_tpu_torch.train import losses
from mccnn_tpu_torch.train.augment import (AugmentSampler, gather_warp,
                                           pad_image_stack, warp_patches)

# minibatches built on the host at once
CHUNK_STEPS = 32


def n_epoch_steps(n_rows: int, bs_half: int) -> int:
    """Minibatch count of one epoch: the reference loop
    `for t = 1, N - bs/2, bs/2` (main.lua:789) runs while
    t <= N - bs/2 — one more step than plain floor division whenever
    N % bs/2 != 0."""
    return 1 + (n_rows - bs_half - 1) // bs_half if n_rows > bs_half else 0


def loss_fn(net, patches: torch.Tensor, labels: torch.Tensor, *, arch: str,
            m: float, pow: int, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """patches: (2*bs, ws, ws) — consecutive (L, R) siamese pairs.

    fast: L2-normalized descriptors, cosine similarity of each pair,
    hinge over interleaved (pos, neg) pairs (Margin2.lua).
    slow: concat descriptors → FC head → sigmoid, BCE vs labels
    (0 = match) (BCECriterion2.lua, main.lua:848-849).
    """
    feats = net(patches[:, None], dtype, padding="valid")  # (2bs, fm, 1, 1)
    desc = feats.reshape(feats.shape[0], -1)
    if arch == "fast":
        scores = (desc[0::2] * desc[1::2]).sum(dim=-1)  # (bs,)
        return losses.hinge(scores, margin=m, pow=pow)
    pair = torch.cat([desc[0::2], desc[1::2]], dim=-1)  # (bs, 2fm)
    return losses.bce(net.score(pair, dtype), labels)


@contextlib.contextmanager
def no_tf32(dev: torch.device):
    """cuDNN convolutions and CUDA matmuls in full float32 (TF32 would
    move the card's losses from the CPU's at the third digit), the
    caller's other cuDNN settings kept; nothing on the CPU."""
    if dev.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _steps(cfg: Config, net, momentum: list, lr, chunk: dict,
           Xpad: torch.Tensor | None) -> torch.Tensor:
    """The chunk's steps, in place on ``net`` and ``momentum``: the body of
    :func:`train_chunk` (``lr`` a float) and of the graph that
    :func:`make_train_chunk` captures (``lr`` a 0-d float32 tensor on the
    device, which ``_foreach_mul`` reads as the float's bits). Each step
    reads slice ``s`` of ``chunk``'s tensors. Returns the (k,) losses."""
    params = list(net.parameters())
    dtype = DTYPES[cfg.dtype]
    kw = dict(arch=cfg.arch, m=float(cfg.m), pow=int(cfg.pow), dtype=dtype)
    mom = float(cfg.mom)
    errs = []
    with no_tf32(params[0].device), torch.enable_grad():
        for s in range(chunk["minv"].shape[0]):
            photo = (chunk["minv"][s], chunk["brightness"][s],
                     chunk["contrast"][s])
            if Xpad is not None:
                patches = gather_warp(Xpad, chunk["src"][s], chunk["oy"][s],
                                      chunk["ox"][s], *photo, ws=cfg.ws)
            else:
                patches = warp_patches(chunk["windows"][s], *photo, ws=cfg.ws)
            err = loss_fn(net, patches, chunk["labels"][s], **kw)
            grads = torch.autograd.grad(err, params)
            with torch.no_grad():
                # v = mom*v - lr*g; w += v (main.lua:871-874)
                torch._foreach_mul_(momentum, mom)
                torch._foreach_sub_(momentum, torch._foreach_mul(grads, lr))
                torch._foreach_add_(params, momentum)
            errs.append(err.detach())
    return torch.stack(errs)


def train_chunk(cfg: Config, net, momentum: list, lr: float, chunk: dict,
                Xpad: torch.Tensor | None = None) -> torch.Tensor:
    """Run the chunk's steps in place on ``net`` and ``momentum`` (one
    tensor a parameter, in ``net.parameters()`` order), eagerly; ``chunk``:
    tensors on the net's device with the step as the leading axis (see
    :func:`stack_chunk`), ``Xpad`` the padded image stack when the chunk
    carries window origins. Returns the per-step losses (k,), on the
    device: nothing here waits for it. The plain version of the graph
    :func:`make_train_chunk` captures, and the CPU's training."""
    return _steps(cfg, net, momentum, float(lr), chunk, Xpad)


def chunk_buffers(chunk: dict, device) -> dict:
    """Uninitialised buffers on ``device`` in the keys, shapes and dtypes
    of ``chunk`` (numpy arrays or tensors, :func:`stack_chunk`'s dict)."""
    return {k: torch.empty(tuple(np.shape(v)), device=device,
                           dtype=torch.as_tensor(v).dtype)
            for k, v in chunk.items()}


def fill_buffers(bufs: dict, chunk: dict) -> None:
    """Copy a chunk (numpy arrays or tensors, :func:`stack_chunk`'s keys)
    into buffers made by :func:`chunk_buffers`; a chunk of other keys or
    shapes raises."""
    if set(chunk) != set(bufs):
        raise ValueError(f"chunk keys {sorted(chunk)}, expected "
                         f"{sorted(bufs)}")
    for k, buf in bufs.items():
        v = torch.as_tensor(chunk[k])
        if v.shape != buf.shape:
            raise ValueError(f"chunk {k!r}: shape {tuple(v.shape)}, "
                             f"expected {tuple(buf.shape)}")
        buf.copy_(v)


def make_train_chunk(cfg: Config, net, momentum: list,
                     Xpad: torch.Tensor | None, n_steps: int, device):
    """The chunk of ``n_steps`` steps as one CUDA graph: the counterpart of
    the JAX package's jitted ``lax.scan`` (mccnn_tpu/train/trainer.py
    ``make_train_chunk``). Returns ``run(chunk, lr) -> errs (n_steps,)``,
    which copies the host chunk into static buffers, sets the 0-d ``lr``
    tensor (so an lr drop needs no new capture) and replays the graph,
    training ``net`` and ``momentum`` in place as :func:`train_chunk`
    does, bit for bit. The first ``run`` makes the buffers in its chunk's
    shapes and dtypes and captures: one step runs first on a side stream
    (the libraries' handles and workspaces, the allocator) and is undone;
    the graph then holds the addresses of the parameters, the momentum and
    ``Xpad``, and ``run`` refuses a net or momentum whose storage changed
    since, or a chunk of other keys or shapes. The capture counts no
    launch; each replay counts the hand kernels it runs
    (``_build.add_counts``). CUDA only (ValueError elsewhere); a failed
    capture or replay raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"make_train_chunk: a CUDA graph needs a CUDA "
                         f"device, got {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    state = list(net.parameters()) + list(momentum)
    if any(t.device != dev for t in state) or (
            Xpad is not None and Xpad.device != dev):
        raise ValueError(f"make_train_chunk: the net, momentum and Xpad must "
                         f"be on {dev}")
    lr_t = torch.zeros((), dtype=torch.float32, device=dev)
    errs = torch.zeros(n_steps, dtype=torch.float32, device=dev)
    graph = torch.cuda.CUDAGraph()
    bufs, counted, ptrs = {}, [], []

    def capture(chunk: dict) -> None:
        if np.shape(chunk["minv"])[0] != n_steps:
            raise ValueError(f"chunk 'minv': shape {np.shape(chunk['minv'])}"
                             f", expected {n_steps} steps")
        now = list(net.parameters()) + list(momentum)
        static = chunk_buffers(chunk, dev)
        fill_buffers(static, chunk)
        with torch.cuda.device(dev):
            saved = [t.detach().clone() for t in now]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _steps(cfg, net, momentum, lr_t,
                       {n: v[:1] for n, v in static.items()}, Xpad)
                with torch.no_grad():
                    for t, v in zip(now, saved):
                        t.copy_(v)
            torch.cuda.current_stream().wait_stream(side)
            del saved
            with _build.uncounted() as got, torch.cuda.graph(graph):
                errs.copy_(_steps(cfg, net, momentum, lr_t, static, Xpad))
        counted.extend(got[0])
        ptrs.extend(t.data_ptr() for t in now)
        bufs.update(static)

    def run(chunk: dict, lr: float) -> torch.Tensor:
        if not bufs:
            capture(chunk)
        now = list(net.parameters()) + list(momentum)
        if [t.data_ptr() for t in now] != ptrs:
            raise RuntimeError("make_train_chunk: the net's parameters or the "
                               "momentum moved since the capture; capture a "
                               "new chunk")
        fill_buffers(bufs, chunk)
        lr_t.fill_(float(lr))
        graph.replay()
        _build.add_counts(*counted)
        return errs.clone()

    return run


def stack_chunk(sampler: AugmentSampler, ds: StereoDataset,
                nnz_rows: np.ndarray, n_steps: int, bs_half: int,
                X0=None, X1=None, device_gather: bool = False) -> dict:
    """Host side of a chunk: windows (or their origins), matrices,
    photometrics and labels for n_steps minibatches, numpy arrays shaped
    (n_steps, per-step...)."""
    if ds.dataset == "mb":
        b = sampler.build_batches_mb(ds.X, nnz_rows)
    else:
        b = sampler.build_batches(X0, X1, nnz_rows,
                                  device_gather=device_gather)
    n4 = 4 * bs_half
    out = {
        "minv": b["minv"].reshape(n_steps, n4, 6),
        "brightness": b["brightness"].reshape(n_steps, n4),
        "contrast": b["contrast"].reshape(n_steps, n4),
        "labels": b["labels"].reshape(n_steps, 2 * bs_half),
    }
    if device_gather:
        for k in ("src", "oy", "ox"):
            out[k] = b[k].reshape(n_steps, n4)
    else:
        out["windows"] = b["windows"].reshape(n_steps, n4,
                                              *b["windows"].shape[1:])
    return out


def _subset(cfg: Config, ds: StereoDataset, nnz: np.ndarray) -> np.ndarray:
    """``-subset`` (main.lua:622-647): a share of the training images,
    drawn from ``RandomState(seed)``."""
    rng = np.random.RandomState(cfg.seed)
    if ds.dataset == "mb":
        # per-generation sampling (main.lua:630-640): 2014 / 2006 /
        # 2005 / 2003 / 2001 image-id ranges
        ids = []
        for lo, hi in ((11, 23), (24, 44), (45, 50), (51, 52), (53, 60)):
            r = np.arange(lo, hi + 1)
            keep = rng.permutation(len(r))[: int(len(r) * cfg.subset)]
            ids.append(r[keep])
        return subset_nnz(nnz, np.concatenate(ids))
    keep = rng.permutation(len(ds.tr))[: int(len(ds.tr) * cfg.subset)]
    return subset_nnz(nnz, ds.tr[keep])


def train(cfg: Config, ds: StereoDataset, net, *, epochs: int = 14,
          momentum: list | None = None, log=print, save_cb=None,
          start_epoch: int = 1, device=None):
    """Run the reference schedule on ``net`` (moved to the device, and
    trained in place); returns ``(net, momentum)``, the momentum one
    tensor a parameter in ``net.parameters()`` order.

    ``device``: None means ``-backend`` (CUDA device ``-gpu`` unless it
    says cpu; no card raises). ``save_cb(epoch, net, momentum)`` is
    invoked after each epoch when per-epoch checkpointing is enabled
    (reference: -debug only, main.lua:877-879; here also
    -checkpoint_every for mid-train resume). ``start_epoch`` > 1 resumes
    the schedule mid-way (the lr drop at epoch 12 still applies).
    """
    dev = device_of(cfg) if device is None else resolve_device(device)
    net = net.to(dev)
    nnz = ds.nnz_for_action(cfg.a)
    if cfg.subset < 1:
        nnz = _subset(cfg, ds, nnz)
    if momentum is None:
        momentum = [torch.zeros_like(p) for p in net.parameters()]
    else:
        momentum = [v.to(dev, torch.float32).clone() for v in momentum]
    # KITTI's image stacks fit the card whole, so windows are gathered
    # there and the host ships only origins; mb keeps the host gather
    # (per-image shapes and lights/exposures do not stack)
    device_gather = ds.dataset != "mb"
    bs_half = cfg.bs // 2
    lr = float(cfg.lr)
    Xpad = None
    if ds.dataset == "mb":
        X0 = X1 = None
    else:
        X0 = np.asarray(ds.X0[:, 0])[:, None]  # materialize mmap once
        X1 = np.asarray(ds.X1[:, 0])[:, None]
        if device_gather:
            Xpad = pad_image_stack(X0, X1, dev)
    # on the card a chunk is one replay of a captured graph, one graph for
    # each chunk size (32, and an epoch's tail); on the CPU the eager steps
    graphs = {}

    def run_chunk(chunk: dict) -> torch.Tensor:
        k = chunk["minv"].shape[0]
        if dev.type != "cuda":
            return train_chunk(cfg, net, momentum, lr,
                               {n: torch.from_numpy(v).to(dev)
                                for n, v in chunk.items()}, Xpad)
        if k not in graphs:
            graphs[k] = make_train_chunk(cfg, net, momentum, Xpad, k, dev)
        return graphs[k](chunk, lr)

    t0 = _time.time()
    for epoch in range(1, epochs + 1):
        if epoch == 12:
            lr = lr / 10
        if epoch < start_epoch:
            continue
        # per-epoch seeding: the shuffle and every augmentation draw
        # derive from (seed, epoch), so a resumed run replays the exact
        # stream of the uninterrupted schedule
        rng_e = np.random.RandomState(cfg.seed * 1000003 + epoch)
        sampler = AugmentSampler(cfg, rng_e)
        perm = rng_e.permutation(len(nnz))
        n_steps_total = n_epoch_steps(len(nnz), bs_half)
        err_sum, err_cnt = 0.0, 0

        def chunks():
            pos = 0
            while pos < n_steps_total:
                k = min(CHUNK_STEPS, n_steps_total - pos)
                rows = nnz[perm[pos * bs_half:(pos + k) * bs_half]]
                yield stack_chunk(sampler, ds, rows, k, bs_half, X0, X1,
                                  device_gather=device_gather)
                pos += k

        # the host builds the next chunk while the device runs this one
        # (the reference interleaves CPU warps with GPU steps serially,
        # main.lua:843-869)
        with ThreadPoolExecutor(max_workers=1) as pool:
            it = chunks()
            fut = pool.submit(next, it, None)
            while True:
                chunk = fut.result()
                if chunk is None:
                    break
                fut = pool.submit(next, it, None)
                errs = run_chunk(chunk).cpu().numpy()
                good = (errs >= 0) & (errs < 100)
                for e in errs[~good]:
                    log(f"WARNING! err={e:f}")
                err_sum += float(errs[good].sum())
                err_cnt += int(good.sum())
        log(f"{epoch}\t{err_sum / max(err_cnt, 1)}\t{lr}\t{_time.time() - t0}")
        if save_cb is not None and (
                cfg.debug or (cfg.checkpoint_every and
                              epoch % cfg.checkpoint_every == 0)):
            save_cb(epoch, net, momentum)
    return net, momentum


def action_train(cfg: Config, tail: list[str], device=None) -> None:
    """``-a train_tr`` / ``train_all``: train from the seeded init (or
    ``-resume``), save ``net/net_<cmd_str>.npz``, then evaluate
    (main.lua:884-888)."""
    from mccnn_tpu_torch.train.evaluate import action_eval

    if cfg.arch not in ("fast", "slow"):
        raise SystemExit(f"-a {cfg.a}: arch {cfg.arch} has no network to "
                         "train")
    dev = device_of(cfg) if device is None else resolve_device(device)
    # the evaluation after training predicts: refuse what it cannot run
    conv.check_kernel_size(cfg.ks, dev)
    ds = load_dataset(cfg)
    towers.print_net(cfg)  # net topology echo (main.lua:751)
    net = towers.init_net(cfg)
    momentum = None
    start_epoch = 1
    if cfg.resume:
        want = [p.shape for p in net.parameters()]
        net, opt, extras = checkpoint.load(cfg.resume)
        if [p.shape for p in net.parameters()] != want:
            raise SystemExit(f"{cfg.resume}: its network does not match "
                             f"{cfg.dataset} {cfg.arch}'s widths")
        if "momentum" not in extras:
            raise SystemExit(f"{cfg.resume}: no momentum to resume from")
        momentum = extras["momentum"]
        start_epoch = int(opt.get("epoch", 0)) + 1
        print(f"resuming from {cfg.resume} at epoch {start_epoch}")

    name = cmd_str(cfg, tail)

    def save_cb(epoch, n, m):
        checkpoint.save(f"net/net_{name}_{epoch}.npz", n,
                        {"cfg": vars(cfg), "epoch": epoch},
                        extra={"momentum": m})

    net, _ = train(cfg, ds, net, momentum=momentum, save_cb=save_cb,
                   start_epoch=start_epoch, device=dev)

    fname = f"net/net_{name}.npz"
    checkpoint.save(fname, net, {"cfg": vars(cfg)})
    cfg.net_fname = fname

    # chain into evaluation (main.lua:884-888)
    cfg.a = "test_te" if cfg.a == "train_tr" else "submit"
    action_eval(cfg, tail, net=net, ds=ds, device=dev)
