"""Inference over a device mesh (mccnn_tpu/parallel/inference.py).

Three factories, each returning ``run(params, ...)``; every one runs
both reference directions (1, -1), as the JAX factories do
(``_method_kwargs``), so the Middlebury ``-a time`` rule of
``stereo_predict`` (the -1 direction alone) does not apply:

- :func:`make_batch_predict_sharded`: B pairs split evenly over the
  mesh, each device running its pairs one after another through the
  single-device body, the HWD lane where ``_hwd_eligible`` holds
  (kernels 1-5), else the generic lane: serving throughput.
- :func:`make_batch_predict`: the same split, always on the generic
  lane. The JAX package vmaps the pipeline over the batch; the hand
  kernels take one pair at a time, so the port loops over the pairs.
- :func:`make_sharded_predict`: one pair on the generic lane with its
  cost volumes split over the mesh, so that no device holds more than
  its share of a (D, H, W) volume: ceil(H/n) rows and a halo, or
  ceil(W/n) columns. That is the memory answer of the JAX module
  (mccnn_tpu/parallel/inference.py:1-21), where GSPMD inserts the halo
  exchanges and the all-to-all from sharding annotations. Here they are
  copies between devices, made by :class:`RowShards`.

Single controller (see :mod:`mccnn_tpu_torch.parallel.mesh`): each
device's share runs in mesh order on the calling thread, so a mesh of
several cards holds the memory of one card's share but does not run
the shares at once.
"""

from __future__ import annotations

import copy

import torch

from mccnn_tpu_torch import pipeline
from mccnn_tpu_torch.config import Config
from mccnn_tpu_torch.ops import blur, costs, cross, outlier, post, sgm
from mccnn_tpu_torch.parallel.mesh import Mesh, batch_sharded

# the rows that census and ad read above and below a pixel: their 9x9
# windows (``radius`` of ops/costs.py)
COST_HALO = 4


def splits(n: int, parts: int) -> list[tuple[int, int]]:
    """(lo, hi) of ``parts`` consecutive ranges of range(n) whose lengths
    differ by at most one, the longer first (370 rows in four: 93, 93,
    92, 92); empty ranges are left out."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + q + (i < r)
        if hi > lo:
            out.append((lo, hi))
        lo = hi
    return out


def _check(cfg: Config, hwd: bool) -> None:
    pipeline._check_lane(cfg, hwd)
    if cfg.dtype not in pipeline.DTYPES:
        raise ValueError(f"-dtype must be one of {sorted(pipeline.DTYPES)}, "
                         f"got {cfg.dtype!r}")


def _place(params, dev: torch.device):
    """The net on ``dev`` in eval mode: the caller's own where it lies
    there, else a copy (the caller's net is not moved)."""
    if params is None:
        return None
    if next(params.parameters()).device != dev:
        params = copy.deepcopy(params).to(dev)
    return params.eval()


def _common(cfg: Config) -> dict:
    """The keyword arguments both lanes take (``stereo_predict``'s)."""
    return dict(kitti=cfg.dataset in ("kitti", "kitti2015"),
                pi1=float(cfg.pi1), pi2=float(cfg.pi2),
                tau_so=float(cfg.tau_so), alpha1=float(cfg.alpha1),
                sgm_q1=float(cfg.sgm_q1), sgm_q2=float(cfg.sgm_q2),
                sgm_i=int(cfg.sgm_i), blur_t=float(cfg.blur_t),
                sm_terminate=cfg.sm_terminate, sm_skip=cfg.sm_skip,
                return_vols=False, directions=(1, -1))


def _generic(cfg: Config) -> dict:
    """The keyword arguments of the generic lane's ``_method`` beyond
    :func:`_common`."""
    return dict(L1=int(cfg.L1), tau1=float(cfg.tau1),
                cbca_i1=int(cfg.cbca_i1), cbca_i2=int(cfg.cbca_i2))


def _pair_fn(cfg: Config, disp_max: int, hwd: bool, form: str):
    """``one(net, x0, x1)``: one pair's map through the single-device
    body, on the device of x0."""
    D = int(disp_max)
    dtype = pipeline.DTYPES[cfg.dtype]
    common = _common(cfg)

    def one(net, x0, x1):
        bk = torch.as_tensor(blur.gaussian_kernel(cfg.blur_sigma),
                             device=x0.device)
        if hwd:
            return pipeline._fast_hwd(
                net, x0, x1, bk, disp_max=D, ws=cfg.ws, dtype=dtype,
                vol_dtype=pipeline.DTYPES[cfg.vol_dtype], **common)
        vols = pipeline._volumes(net, x0, x1, arch=cfg.arch, disp_max=D,
                                 ws=cfg.ws, dtype=dtype)
        return pipeline._method(vols, x0, x1, bk, disp_max=D, sgm_form=form,
                                **_generic(cfg), **common)

    return one


def _batch_run(one, mesh: Mesh, axis: str | None, params, x0b, x1b
               ) -> torch.Tensor:
    """The B pairs split evenly over the devices of ``axis``
    (``batch_sharded``), each device's pairs run one after another; the
    (B, H, W) maps stacked on the first device."""
    x0b = torch.as_tensor(x0b, dtype=torch.float32)
    x1b = torch.as_tensor(x1b, dtype=torch.float32)
    if x0b.dim() != 3 or x0b.shape != x1b.shape:
        raise ValueError(f"expected two (B, H, W) batches of one shape, got "
                         f"{tuple(x0b.shape)} and {tuple(x1b.shape)}")
    axis = axis or mesh.axis_names[0]
    devs = mesh.along(axis)
    nets = {dev: _place(params, dev) for dev in dict.fromkeys(devs)}
    with torch.no_grad():
        return torch.stack([
            one(nets[dev], a, b).to(devs[0])
            for dev, x0s, x1s in zip(devs, batch_sharded(x0b, mesh, axis),
                                     batch_sharded(x1b, mesh, axis))
            for a, b in zip(x0s, x1s)])


def make_batch_predict_sharded(cfg: Config, mesh: Mesh, disp_max: int,
                               axis: str | None = None):
    """Serving throughput over a mesh (``make_batch_predict_sharded``,
    mccnn_tpu/parallel/inference.py:211-280): ``run(params, x0b, x1b)``
    -> (B, H, W) maps on the first device of ``axis`` (default the
    mesh's first axis). The B pairs split evenly over the devices of
    ``axis`` (B must divide); each device runs its pairs one after
    another on the HWD lane where ``_hwd_eligible`` holds for the SGM
    form of ``MCCNN_SGM_HSLAB`` (read here), else on the generic lane.
    The ``-vol_dtype`` contract is checked against that lane."""
    form = sgm.resolve_form(None)
    hwd = pipeline._hwd_eligible(cfg, form)
    _check(cfg, hwd)
    one = _pair_fn(cfg, disp_max, hwd, form)
    return lambda params, x0b, x1b: _batch_run(one, mesh, axis, params, x0b,
                                               x1b)


def make_batch_predict(cfg: Config, mesh: Mesh, disp_max: int,
                       axis: str | None = None):
    """Batched prediction on the generic lane for every arch
    (``make_batch_predict``, mccnn_tpu/parallel/inference.py:283-313):
    ``run(params, x0b, x1b)`` -> (B, H, W), split as in
    :func:`make_batch_predict_sharded`; a 16-bit ``-vol_dtype`` raises."""
    _check(cfg, hwd=False)
    one = _pair_fn(cfg, disp_max, False, sgm.resolve_form(None))
    return lambda params, x0b, x1b: _batch_run(one, mesh, axis, params, x0b,
                                               x1b)


class RowShards(pipeline.Stages):
    """The stages of ``pipeline._method`` over a pair's volumes split in
    row shards, one a device of ``devs``: a volume is a list of
    (D, hi - lo, W) shards and a map a list of (hi - lo, W) shards, for
    the ranges ``rows`` (:func:`splits` of H). CBCA fetches its halo from
    the neighbouring shards before every iteration, on arms cut to each
    shard's slab and packed once a pair (:meth:`pack`); the SGM runs its
    horizontal family per row shard and its vertical family per column
    shard (``cols``); WTA, the outlier labels and subpixel run per row
    shard; :meth:`whole` gathers a map on the first device."""

    def __init__(self, devs: list, rows: list, cols: list):
        self.first = devs[0]
        self.rows = list(zip(devs, rows))
        self.cols = list(zip(devs, cols))

    def _slab(self, shards: list, a: int, b: int, dev) -> torch.Tensor:
        """Rows a:b of a row-sharded tensor (..., rows, W), assembled on
        ``dev`` from the shards that hold them: the halo exchange."""
        parts = [s[..., max(a, lo) - lo:min(b, hi) - lo, :].to(dev)
                 for s, (_, (lo, hi)) in zip(shards, self.rows)
                 if lo < b and a < hi]
        return torch.cat(parts, dim=-2)

    def pack(self, x0c, x1c, L1):
        """Each shard's arms, once a pair: its rows and the K - 1 rows
        above and below that the vertical sums read (K = max(2, L1)), the
        row coordinates (``x0c[2:4]``, absolute) made relative to the
        slab's first row, which ``cross.cbca`` counts as row 0, on the
        shard's device; and their pack (``cross.cbca_pack``): (a, b,
        arms, pack) a shard, rows a:b its slab."""
        halo = max(2, int(L1)) - 1
        H = x0c.shape[1]
        out = []
        for dev, (lo, hi) in self.rows:
            a, b = max(0, lo - halo), min(H, hi + halo)
            arms = [torch.cat([c[:2, a:b], c[2:, a:b] - a]).to(dev)
                    for c in (x0c, x1c)]
            out.append((a, b, arms, cross.cbca_pack(*arms, L1)))
        return out

    def cbca(self, x0c, x1c, vol, direction, L1, packed):
        """One CBCA iteration a shard, on the slab of rows that
        :meth:`pack` cut its arms to, with their pack; the halo rows of
        the result are wrong and dropped."""
        out = []
        for (dev, (lo, hi)), (a, b, arms, pk) in zip(self.rows, packed):
            agg = cross.cbca(*arms, self._slab(vol, a, b, dev), direction, L1,
                             packed=pk)
            out.append(agg[:, lo - a:hi - a].contiguous())
        return out

    def sgm(self, x0, x1, vols: dict, form, *, pi1, pi2, tau_so, alpha1,
            sgm_q1, sgm_q2) -> dict:
        """One SGM iteration: the horizontal family per row shard (its
        scanlines are the shard's rows); the volumes moved to column
        shards (the all-to-all) for the vertical family, whose tables
        come from the whole images (``cols``); its sums moved back to
        the row shards, then h + v and /4 per shard, as on one device."""
        form = sgm.resolve_form(form)
        dirs = sorted(vols)
        H, W = x0.shape
        D = vols[dirs[0]][0].shape[0]
        kw = dict(pi1=pi1, pi2=pi2, tau_so=tau_so, q1=sgm_q1, q2=sgm_q2)
        h = [sgm.horizontal_family(
                form, x0[lo:hi].to(dev), x1[lo:hi].to(dev),
                {d: vols[d][i] for d in dirs}, dirs, D, hi - lo, W, **kw)
             for i, (dev, (lo, hi)) in enumerate(self.rows)]
        v = []
        for dev, (c0, c1) in self.cols:
            by_col = {d: torch.cat([s[..., c0:c1].to(dev) for s in vols[d]],
                                   dim=1) for d in dirs}
            v.append(sgm.vertical_family(form, x0.to(dev), x1.to(dev),
                                         by_col, dirs, D, H, W, alpha1=alpha1,
                                         cols=(c0, c1), **kw))
            del by_col
        out = {d: [] for d in dirs}
        for i, (dev, (lo, hi)) in enumerate(self.rows):
            for d in dirs:
                vi = torch.cat([vj[d][:, lo:hi].to(dev) for vj in v], dim=2)
                s = torch.add(h[i][d], vi, out=torch.empty_like(
                    vols[d][i], memory_format=torch.contiguous_format))
                out[d].append(s / 4.0)
        return out

    def wta(self, vol):
        return [costs.wta(s) for s in vol]

    def outlier(self, d_l, d_r, disp_max):
        return [outlier.outlier_detection(a, b, disp_max)
                for a, b in zip(d_l, d_r)]

    def whole(self, m):
        return torch.cat([s.to(self.first) for s in m])

    def subpixel(self, d, vol, disp_max):
        """Subpixel per row shard: the rows of the whole (filled) map
        sent to the shard's device, the refined rows gathered back."""
        return torch.cat([
            post.subpixel_enhancement(d[lo:hi].to(dev), s, disp_max)
            .to(self.first) for (dev, (lo, hi)), s in zip(self.rows, vol)])


def row_volumes(cfg: Config, net, x0, x1, lo: int, hi: int, disp_max: int,
                dev) -> dict:
    """The cost volumes {-1, +1} of rows lo:hi, (D, hi - lo, W) each,
    computed on ``dev`` from the image rows with the halo the volume's
    first stage reads: the tower's l1 * (ks // 2) rows (with SAME
    padding the halo rows absorb the wrong edge, and the shard's own
    rows come out exact), census's and ad's ``COST_HALO``. The join and
    the slow head run on the shard's own rows: the match at row y reads
    row y only."""
    halo = COST_HALO if net is None else int(cfg.l1) * (int(cfg.ks) // 2)
    a, b = max(0, lo - halo), min(x0.shape[0], hi + halo)
    return pipeline._volumes(net, x0[a:b].to(dev), x1[a:b].to(dev),
                             arch=cfg.arch, disp_max=int(disp_max), ws=cfg.ws,
                             dtype=pipeline.DTYPES[cfg.dtype],
                             rows=slice(lo - a, hi - a))


def make_sharded_predict(cfg: Config, mesh: Mesh, disp_max: int,
                         axis: str | None = None):
    """One pair with its volumes sharded over the devices of ``axis``
    (default the mesh's first axis) (``make_sharded_predict``,
    mccnn_tpu/parallel/inference.py:111-208): ``run(params, x0, x1)``
    -> the (H, W) map on the first device. The generic lane, for every
    arch (a 16-bit ``-vol_dtype`` raises): volumes by
    :func:`row_volumes`, then ``pipeline._method`` on the stages of
    :class:`RowShards`, in the SGM form of ``MCCNN_SGM_HSLAB`` (read
    here). The images and the CBCA arms are small and sent whole; the
    fills, the median and the blur run on the whole map on the first
    device."""
    devs = mesh.along(axis or mesh.axis_names[0])
    _check(cfg, hwd=False)
    form = sgm.resolve_form(None)
    D = int(disp_max)

    def run(params, x0, x1):
        x0 = torch.as_tensor(x0, dtype=torch.float32).to(devs[0])
        x1 = torch.as_tensor(x1, dtype=torch.float32).to(devs[0])
        if x0.dim() != 2 or x0.shape != x1.shape:
            raise ValueError(f"expected two (H, W) images of one shape, got "
                             f"{tuple(x0.shape)} and {tuple(x1.shape)}")
        H, W = x0.shape
        stages = RowShards(devs, splits(H, len(devs)), splits(W, len(devs)))
        nets = {dev: _place(params, dev) for dev in dict.fromkeys(devs)}
        with torch.no_grad():
            shards = [row_volumes(cfg, nets[dev], x0, x1, lo, hi, D, dev)
                      for dev, (lo, hi) in stages.rows]
            vols = {d: [s[d] for s in shards] for d in (-1, 1)}
            del shards
            bk = torch.as_tensor(blur.gaussian_kernel(cfg.blur_sigma),
                                 device=devs[0])
            return pipeline._method(vols, x0, x1, bk, disp_max=D,
                                    sgm_form=form, stages=stages,
                                    **_generic(cfg), **_common(cfg))

    return run
