"""The stereo prediction pipeline: the JAX package's two lanes.

Orchestration contract: ``stereo_predict`` (main.lua:929-1082).

- Disparity-minor (HWD) lane, the fast arch without CBCA
  (mccnn_tpu/pipeline.py:232-375): tower -> join -> per-direction SGM
  (four sweeps, one accumulator, fused WTA) -> LR outlier labels ->
  occlusion and mismatch fill -> subpixel parabola on the left volume ->
  5×5 median -> thresholded-Gaussian blur. The left volume stays
  x-REVERSED end to end (only (H, W) maps are flipped). The sweep sum is
  not divided by 4: WTA is scale-invariant and the subpixel threshold
  scales to 4e-5; the volume dumps divide on the way out.
- Generic (D, H, W) lane, every other configuration (``_volumes_jit`` +
  ``_method_jit``, pipeline.py:34-229). Three sources of volumes
  (:func:`_volumes`): the slow arch (slow tower -> factored head kernel
  -> NaN masks, ``fix_border`` and the ``disp_true`` planes in one
  epilogue kernel), the fast arch with CBCA (fast tower -> join kernel,
  relaid to (D, H, W) -> ``fix_border`` in place), and the
  census and ad costs of the two images (no network, no border fix).
  Then (:func:`_method`) CBCA ×cbca_i1 -> SGM (both directions stacked,
  four sweeps, h + v, /4) -> CBCA ×cbca_i2 -> WTA -> outlier labels ->
  fills -> subpixel on the -1 volume (threshold 1e-5) -> median -> blur.
  The SGM runs in the slab form or, with ``MCCNN_SGM_HSLAB=0`` or
  ``sgm_form``, in one of the two scan forms
  (:func:`mccnn_tpu_torch.ops.sgm.resolve_form`); the scan forms also
  send the fast arch without CBCA to this lane, as the JAX package does
  (pipeline.py:399-414). So does the volume cache (``-use_cache`` /
  ``-make_cache``, :func:`compute_volumes`): a cached pair reads its
  volumes from ``cache/<pair_id>.npz`` and runs no network.

``sm_terminate`` stops after a named stage and ``sm_skip`` skips one,
with the gate placement of main.lua:988-1080 (the mismatch stage is
skipped by ``-sm_skip occlusion``).

Dtypes (``check_vol_dtype``, mccnn_tpu/pipeline.py:445-465): ``-dtype``
is the compute dtype of the networks (``models.towers``, the slow head's
operands); ``-vol_dtype`` the storage dtype of the HWD lane's volumes
through the join and the sweeps, where every arithmetic step stays
float32 and only the stored values round; the volume dumps widen back to
float32. ``disp_true`` (shape bucketing, mccnn_tpu/pipeline.py:468-503):
the real disparity count when ``disp_max`` was padded: NaN lanes from
the join on the HWD lane, 1e9 planes on the generic lane.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mccnn_tpu_torch.config import Config
from mccnn_tpu_torch.models.towers import FastTower, SlowNet
from mccnn_tpu_torch.ops import (blur, conv, costs, cross, join, outlier,
                                 post, sgm, slow_head)

# the dtypes -dtype and -vol_dtype may name
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; asking for CUDA where there is none raises
    (the port never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the host")
    return dev


def device_of(cfg: Config) -> torch.device:
    """The device of the command-line actions: ``-backend cpu`` runs on
    the host; otherwise CUDA device ``-gpu`` (1-based), which must
    exist."""
    if cfg.backend == "cpu":
        return torch.device("cpu")
    if cfg.backend not in ("", "cuda", "gpu"):
        raise SystemExit(f"-backend must be cpu or cuda, got {cfg.backend!r}")
    dev = resolve_device("cuda")
    if not 1 <= cfg.gpu <= torch.cuda.device_count():
        raise SystemExit(f"-gpu {cfg.gpu}: only {torch.cuda.device_count()} "
                         "CUDA device(s) visible")
    return torch.device(dev.type, cfg.gpu - 1)


def _active_after(terminate: str, stage: str) -> bool:
    """Whether the method is still active after `stage`, given
    -sm_terminate. Stage order per main.lua:988-1075."""
    order = ["cnn", "cbca1", "sgm", "cbca2", "occlusion", "mismatch",
             "subpixel_enchancement", "median"]
    if terminate not in order:
        return True
    return order.index(stage) < order.index(terminate)


def _hwd_unpack_vol(vol, *, D, H, W, xrev, scale4):
    """Stored (H', Wp, Dp) volume -> natural float32 (D, H, W) for the
    .bin dumps (a 16-bit volume widened); ``scale4`` applies the deferred
    /4 of the sweep sum."""
    v = vol[:H, :W, :D].float()
    if xrev:
        v = v.flip(1)
    if scale4:
        v = v * 0.25
    return v.permute(2, 0, 1).contiguous()


def _check_lane(cfg: Config, hwd: bool) -> None:
    """The ``-vol_dtype`` contract of ``check_vol_dtype``
    (mccnn_tpu/pipeline.py:445-465): 16-bit volume storage exists only
    on the HWD lane (``hwd``), and a configuration that would run the
    float32 generic lane instead raises rather than misreport. float16
    is allowed: the JAX package bans it on the TPU only because the
    Mosaic dialect has no float16 vectors there; the H100's kernels
    store it as they store bfloat16 (``cvt.rn.f16x2.f32``)."""
    if cfg.vol_dtype != "float32" and not hwd:
        raise ValueError(
            f"-vol_dtype {cfg.vol_dtype} requires the fast HWD lane (fast "
            "arch, cbca_i1=cbca_i2=0, no volume cache, the slab SGM form)")


@torch.no_grad()
def slow_cost_volumes(net: SlowNet, x0, x1, disp_max: int,
                      dtype=torch.float32):
    """Slow-arch cost volumes (vol_l, vol_r), each (D, H, W), NaN out of
    frame; the score is P(non-match), lower is better. ``dtype``: the
    compute dtype of the tower and the head's first layer."""
    feats = net.infer(torch.stack([x0, x1])[:, None], dtype)
    fl = feats[0].permute(1, 2, 0)  # (H, W, C)
    fr = feats[1].permute(1, 2, 0)
    return slow_head.slow_volumes(net, fl, fr, disp_max, dtype)


@torch.no_grad()
def _volumes(net, x0, x1, *, arch, disp_max, ws, dtype=torch.float32,
             disp_true=None, rows=None) -> dict:
    """Cost volumes of both reference directions, (D, H, W) each
    (mccnn_tpu/pipeline.py:97-149): {-1: vol_l, +1: vol_r}. The fast
    and slow arches get the CNN border fixed; ad and census use no
    network (``net`` is None). ``disp_true`` < disp_max: the planes
    d >= disp_true hold 1e9 (``mask_pad``, mccnn_tpu/pipeline.py:
    120-125), a large finite cost that CBCA averages to itself and the
    SGM and WTA never select. ``rows``: a slice of the image rows whose
    volumes to return (a row shard of
    :mod:`mccnn_tpu_torch.parallel.inference`); the other rows of x0, x1
    are a halo that the tower or the cost windows read, their features
    and costs computed and dropped."""
    own = slice(None) if rows is None else rows
    pad = disp_true is not None and disp_true < disp_max
    if arch == "census":
        # both images' signatures once a pair, read by both volumes
        s0, s1 = costs.census_signatures(x0, x1)
        vols = {-1: costs.census_volume(x0, x1, disp_max, -1,
                                        signatures=(s0, s1)),
                1: costs.census_volume(x1, x0, disp_max, 1,
                                       signatures=(s1, s0))}
        vols = {k: v[:, own].contiguous() for k, v in vols.items()}
    elif arch == "ad":
        vols = {-1: costs.ad_volume(x0, x1, disp_max, -1)[:, own].contiguous(),
                1: costs.ad_volume(x1, x0, disp_max, 1)[:, own].contiguous()}
    elif arch in ("fast", "slow"):
        feats = net.infer(torch.stack([x0, x1])[:, None], dtype)[:, :, own]
        fl = feats[0].permute(1, 2, 0)  # (H, W, C)
        fr = feats[1].permute(1, 2, 0)
        n = (ws - 1) // 2
        if arch == "fast":
            # fresh volumes of the relayout: the border is fixed in place
            vol_l, vol_r = join.stereo_join_dhw(fl, fr, disp_max)
            vols = {-1: costs.fix_border(vol_l, -1, n, inplace=True),
                    1: costs.fix_border(vol_r, 1, n, inplace=True)}
        else:
            # the masks, the border and the disp_true planes in one pass
            vol_l, vol_r = slow_head.slow_volumes(
                net, fl, fr, disp_max, dtype, n=n,
                disp_true=disp_true if pad else None)
            return {-1: vol_l, 1: vol_r}
    else:
        raise ValueError(arch)
    if pad:
        real = torch.arange(disp_max, device=x0.device)[:, None, None] \
            < disp_true
        vols = {k: torch.where(real, v, 1e9) for k, v in vols.items()}
    return vols


@torch.no_grad()
def compute_volumes(cfg: Config, net, x0, x1, disp_max: int, pair_id=None,
                    disp_true: int | None = None, device=None) -> dict:
    """The generic lane's cost volumes {-1: vol_l, +1: vol_r}, (D, H, W)
    float32 each, through the volume cache (``compute_volumes``,
    mccnn_tpu/pipeline.py:417-444; main.lua:959-982): with
    ``-use_cache`` the volumes of ``pair_id`` are read from
    ``cache/<pair_id>.npz`` under the working directory when the file
    exists, and the network does not run; with ``-make_cache`` they are written there after computing
    (``vol_m1``, ``vol_p1``). Without a ``pair_id`` the cache is not
    used. Files written by either package are read by the other. The
    cache lets the stereo method's parameter search skip the slow net
    (tools/hs.py)."""
    dev = resolve_device(device)
    cache_f = None
    if pair_id is not None and (cfg.use_cache or cfg.make_cache):
        cache_f = os.path.join("cache", f"{pair_id}.npz")
    if cache_f and cfg.use_cache and os.path.exists(cache_f):
        with np.load(cache_f) as z:
            vols = {-1: z["vol_m1"], 1: z["vol_p1"]}
        want = (int(disp_max), *np.shape(x0))
        for v in vols.values():
            if v.shape != want:
                raise ValueError(f"{cache_f}: volumes {v.shape}, this pair "
                                 f"needs {want}")
        return {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                for k, v in vols.items()}
    net = None if net is None else net.to(dev).eval()
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(dev)
    x1 = torch.as_tensor(x1, dtype=torch.float32).to(dev)
    vols = _volumes(net, x0, x1, arch=cfg.arch, disp_max=int(disp_max),
                    ws=cfg.ws, dtype=DTYPES[cfg.dtype], disp_true=disp_true)
    if cache_f and cfg.make_cache:
        os.makedirs("cache", exist_ok=True)
        np.savez(cache_f, vol_m1=vols[-1].float().cpu().numpy(),
                 vol_p1=vols[1].float().cpu().numpy())
    return vols


class Stages:
    """The stages of :func:`_method` that read a cost volume, run on the
    volume's own device. :mod:`mccnn_tpu_torch.parallel.inference` runs
    them over row and column shards of the volumes instead (the
    counterpart of ``_method_jit``'s ``sgm_fn``,
    mccnn_tpu/pipeline.py:182-186): there a volume and a map that
    :meth:`wta` or :meth:`outlier` returns are lists of shards, and
    :meth:`whole` gathers a map before the stages that read all of it."""

    def pack(self, x0c, x1c, L1):
        """The arms packed once a pair for every :meth:`cbca` call
        (``cross.cbca_pack``)."""
        return cross.cbca_pack(x0c, x1c, L1)

    def cbca(self, x0c, x1c, vol, direction, L1, packed):
        return cross.cbca(x0c, x1c, vol, direction, L1, packed=packed)

    def sgm(self, x0, x1, vols: dict, form, **kw) -> dict:
        """One SGM iteration: the four-sweep sums (h + v), divided by 4."""
        return sgm.sgm_multi(x0, x1, vols, form=form, quarter=True, **kw)

    def wta(self, vol):
        return costs.wta(vol)

    def outlier(self, d_l, d_r, disp_max):
        return outlier.outlier_detection(d_l, d_r, disp_max)

    def whole(self, m):
        return m

    def subpixel(self, d, vol, disp_max):
        return post.subpixel_enhancement(d, vol, disp_max)


ONE_DEVICE = Stages()


def _method(vols: dict, x0, x1, blur_kernel, *, disp_max, directions, kitti,
            L1, tau1, cbca_i1, cbca_i2, pi1, pi2, tau_so, alpha1, sgm_q1,
            sgm_q2, sgm_i, blur_t, sm_terminate, sm_skip, return_vols,
            sgm_form=None, stages: Stages = ONE_DEVICE):
    """The stereo method on (D, H, W) volumes (mccnn_tpu/pipeline.py:
    152-229), with every gate of main.lua:988-1080; ``sgm_form`` is the
    ``form`` of :func:`mccnn_tpu_torch.ops.sgm.sgm_multi`; ``stages``
    the implementation of the stages that read a volume (see
    :class:`Stages`)."""
    D = int(disp_max)
    sm_active = _active_after(sm_terminate, "cnn")
    do_cbca = sm_active and sm_skip != "cbca"
    do_cbca2 = do_cbca and _active_after(sm_terminate, "sgm")
    if do_cbca:
        x0c = cross.cross_arms(x0, L1, tau1)
        x1c = cross.cross_arms(x1, L1, tau1)
        # packed once for every CBCA iteration of the pair, where one runs
        if cbca_i1 or (do_cbca2 and cbca_i2):
            packed = stages.pack(x0c, x1c, L1)

    cur = {}
    for direction in directions:
        vol = vols[direction]
        if do_cbca:
            for _ in range(cbca_i1):
                vol = stages.cbca(x0c, x1c, vol, direction, L1, packed)
        cur[direction] = vol

    if _active_after(sm_terminate, "cbca1") and sm_skip != "sgm":
        for _ in range(sgm_i):
            cur = stages.sgm(x0, x1, cur, sgm_form, pi1=pi1, pi2=pi2,
                             tau_so=tau_so, alpha1=alpha1, sgm_q1=sgm_q1,
                             sgm_q2=sgm_q2)

    disp = {}
    final_vols = {}
    for direction in directions:
        vol = cur[direction]
        if do_cbca2:
            for _ in range(cbca_i2):
                vol = stages.cbca(x0c, x1c, vol, direction, L1, packed)
        disp[direction] = stages.wta(vol)
        final_vols[direction] = vol

    # the -1 (left-reference) map
    d_final = stages.whole(disp[directions[-1]])
    vol_final = final_vols[directions[-1]]
    sm_active = _active_after(sm_terminate, "cbca2")

    if kitti and len(directions) == 2:
        labels = stages.whole(stages.outlier(disp[-1], disp[1], D))
        if sm_active and sm_skip != "occlusion":
            d_final = post.interpolate_occlusion(d_final, labels)
        if _active_after(sm_terminate, "occlusion") and sm_skip != "occlusion":
            d_final = post.interpolate_mismatch(d_final, labels)
        sm_active = _active_after(sm_terminate, "mismatch")

    if sm_active and sm_skip != "subpixel_enchancement":
        d_final = stages.subpixel(d_final, vol_final, D)
    sm_active = sm_active and _active_after(sm_terminate,
                                            "subpixel_enchancement")

    if sm_active and sm_skip != "median":
        d_final = post.median2d(d_final, 5)
    sm_active = sm_active and _active_after(sm_terminate, "median")

    if sm_active and sm_skip != "bilateral":
        d_final = blur.mean2d(d_final, blur_kernel, blur_t)

    if return_vols:
        return d_final, final_vols.get(-1), final_vols.get(1)
    return d_final


def _fast_hwd(tower, x0, x1, blur_kernel, *, disp_max, kitti, ws, pi1, pi2,
              tau_so, alpha1, sgm_q1, sgm_q2, sgm_i, blur_t, sm_terminate,
              sm_skip, return_vols, directions=(1, -1), dtype=torch.float32,
              vol_dtype=torch.float32, disp_true=None):
    """The fast-arch pipeline body (mccnn_tpu/pipeline.py:232-375), the
    tower in the compute ``dtype``, the volumes stored as ``vol_dtype``,
    lanes d >= ``disp_true`` NaN from the join on."""
    single = tuple(directions) == (-1,)
    if single and kitti:
        raise ValueError("KITTI runs both reference directions")
    D = int(disp_max)
    H, W = x0.shape
    sides = "left" if single else "both"
    # the tower's last kernel writes the join's operands
    packed = tower.infer(torch.stack([x0, x1])[:, None], dtype,
                         pack=(D, sides))
    jkw = dict(n_fix=(ws - 1) // 2, d_true=disp_true, out_dtype=vol_dtype,
               sides=sides)
    if single:
        cur_lr = join.stereo_join_hwd(None, None, D, packed=packed, **jkw)
        cur_r = None
    else:
        cur_lr, cur_r = join.stereo_join_hwd(None, None, D, packed=packed,
                                             **jkw)
    del packed  # the operands (0.55 GB at KITTI) go before the sweeps

    sgm_ran = _active_after(sm_terminate, "cbca1") and sm_skip != "sgm"
    if sgm_ran:
        kw = dict(pi1=pi1, pi2=pi2, tau_so=tau_so, alpha1=alpha1, q1=sgm_q1,
                  q2=sgm_q2)
        for i in range(sgm_i):
            if i > 0:  # sgm_i is 1 in every config; keep re-iteration exact
                cur_lr = cur_lr / 4.0
                cur_r = None if single else cur_r / 4.0
            last = i == sgm_i - 1
            # the last iteration fuses WTA into the last sweep; the right
            # volume is read only by its WTA map, so unless the caller
            # wants the dumps its last sweep writes no volume
            cur_lr = sgm.sgm_slab_hwd(x0, x1, cur_lr, D, H, W, xrev=True,
                                      wta=last, **kw)
            if not single:
                out_r = sgm.sgm_slab_hwd(x0, x1, cur_r, D, H, W, xrev=False,
                                         wta=last,
                                         materialize=return_vols or not last,
                                         **kw)
                cur_r = out_r if not last else (
                    out_r[0] if return_vols else None)
        cur_lr, wta_l = cur_lr
        d_l = wta_l[:H, :W].flip(1)
        if not single:
            wta_r = out_r[1] if return_vols else out_r
            d_r = wta_r[:H, :W]
    else:
        d_l = costs.wta_hwd(cur_lr)[:H, :W].flip(1)
        if not single:
            d_r = costs.wta_hwd(cur_r)[:H, :W]
    d_final = d_l
    sm_active = _active_after(sm_terminate, "cbca2")

    if kitti:
        labels = outlier.outlier_detection(d_l, d_r, D)
        if sm_active and sm_skip != "occlusion":
            d_final = post.interpolate_occlusion(d_final, labels)
        if _active_after(sm_terminate, "occlusion") and sm_skip != "occlusion":
            d_final = post.interpolate_mismatch(d_final, labels)
        sm_active = _active_after(sm_terminate, "mismatch")

    if sm_active and sm_skip != "subpixel_enchancement":
        # the left volume is x-reversed: the map reads its columns W-1-x
        thresh = 4e-5 if sgm_ran else 1e-5
        d_final = post.subpixel_enhancement_hwd(d_final, cur_lr[:H], D,
                                                denom_thresh=thresh, xrev=True)
    sm_active = sm_active and _active_after(sm_terminate,
                                            "subpixel_enchancement")

    if sm_active and sm_skip != "median":
        d_final = post.median2d(d_final, 5)
    sm_active = sm_active and _active_after(sm_terminate, "median")

    if sm_active and sm_skip != "bilateral":
        d_final = blur.mean2d(d_final, blur_kernel, blur_t)

    if return_vols:
        kwv = dict(D=D, H=H, W=W, scale4=sgm_ran)
        vol_l = _hwd_unpack_vol(cur_lr, xrev=True, **kwv)
        vol_r = (None if cur_r is None
                 else _hwd_unpack_vol(cur_r, xrev=False, **kwv))
        return d_final, vol_l, vol_r
    return d_final


def _hwd_eligible(cfg: Config, form: str) -> bool:
    """The HWD lane takes the fast arch with no CBCA and no volume cache
    while the SGM is in its slab form (``_hwd_eligible``,
    mccnn_tpu/pipeline.py:399-414); everything else goes to the generic
    lane."""
    return (cfg.arch == "fast" and int(cfg.cbca_i1) == 0
            and int(cfg.cbca_i2) == 0 and not cfg.use_cache
            and not cfg.make_cache and form == "slab")


@torch.no_grad()
def stereo_predict(cfg: Config, params: FastTower | SlowNet | None, x0, x1,
                   disp_max: int, return_vols: bool = False, device=None,
                   sgm_form: str | None = None, disp_true: int | None = None,
                   pair_id=None):
    """Run the full stereo method on one standardized pair.

    x0/x1: (H, W) float32 arrays or tensors (already per-image
    standardized). ``params``: the fast tower or the slow net of
    ``cfg.arch`` (moved to the device), None for ad and census. Returns
    the left-reference disparity map (H, W) float32 tensor; with
    ``return_vols`` also the final left and right cost volumes as
    (D, H, W) tensors (the predict-mode .bin dumps; None for a direction
    that did not run). ``device=None`` runs on CUDA and raises where
    there is none. ``sgm_form``: the SGM form of the generic lane,
    ``"slab"``, ``"stream"`` or ``"grid"``; None reads
    ``MCCNN_SGM_HSLAB`` (see ``ops.sgm.resolve_form``). ``disp_true``:
    the real disparity count when ``disp_max`` was padded to a bucket
    (``disp_true == disp_max`` means None, as in the JAX package); the
    maps stay (H, W) and the volumes (disp_max, H, W). ``pair_id``: the
    pair's name in the volume cache (:func:`compute_volumes`), which
    ``-use_cache`` and ``-make_cache`` use on the generic lane.
    """
    dev = resolve_device(device)
    if params is not None:
        conv.check_kernel_size(cfg.ks, dev)
    if cfg.dataset == "mb":
        directions = (1, -1) if cfg.a == "predict" else (-1,)
    else:
        directions = (1, -1)
    form = sgm.resolve_form(sgm_form)
    hwd = _hwd_eligible(cfg, form)
    _check_lane(cfg, hwd)
    if cfg.dtype not in DTYPES:
        raise ValueError(f"-dtype must be one of {sorted(DTYPES)}, got "
                         f"{cfg.dtype!r}")
    dtype, vol_dtype = DTYPES[cfg.dtype], DTYPES[cfg.vol_dtype]
    if disp_true is not None:
        disp_true = int(disp_true)
        if not 0 < disp_true <= int(disp_max):
            raise ValueError(f"disp_true must be in (0, disp_max={disp_max}], "
                             f"got {disp_true}")
        if disp_true == int(disp_max):
            disp_true = None
    want = {"fast": FastTower, "slow": SlowNet}.get(cfg.arch)
    if want is None and params is not None:
        raise TypeError(f"arch {cfg.arch!r} uses no network: params must be "
                        f"None, got {type(params).__name__}")
    if want is not None and not isinstance(params, want):
        raise TypeError(f"arch {cfg.arch!r} needs a {want.__name__}, got "
                        f"{type(params).__name__}")
    net = None if params is None else params.to(dev).eval()
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(dev)
    x1 = torch.as_tensor(x1, dtype=torch.float32).to(dev)
    if x0.dim() != 2 or x0.shape != x1.shape:
        raise ValueError(f"expected two (H, W) images of one shape, got "
                         f"{tuple(x0.shape)} and {tuple(x1.shape)}")
    blur_kernel = torch.as_tensor(blur.gaussian_kernel(cfg.blur_sigma),
                                  device=dev)
    kitti = cfg.dataset in ("kitti", "kitti2015")
    common = dict(pi1=float(cfg.pi1), pi2=float(cfg.pi2),
                  tau_so=float(cfg.tau_so), alpha1=float(cfg.alpha1),
                  sgm_q1=float(cfg.sgm_q1), sgm_q2=float(cfg.sgm_q2),
                  sgm_i=int(cfg.sgm_i), blur_t=float(cfg.blur_t),
                  sm_terminate=cfg.sm_terminate, sm_skip=cfg.sm_skip,
                  return_vols=return_vols)
    if hwd:
        return _fast_hwd(net, x0, x1, blur_kernel, disp_max=int(disp_max),
                         kitti=kitti, ws=cfg.ws, directions=directions,
                         dtype=dtype, vol_dtype=vol_dtype,
                         disp_true=disp_true, **common)
    vols = compute_volumes(cfg, net, x0, x1, disp_max, pair_id=pair_id,
                           disp_true=disp_true, device=dev)
    return _method(vols, x0, x1, blur_kernel, disp_max=int(disp_max),
                   directions=directions, kitti=kitti, L1=int(cfg.L1),
                   tau1=float(cfg.tau1), cbca_i1=int(cfg.cbca_i1),
                   cbca_i2=int(cfg.cbca_i2), sgm_form=form, **common)
