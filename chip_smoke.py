#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 11 --te 40   # phases 1, 2, 11 alone

Run from the root of the repository, on a machine with a CUDA card, the
CUDA toolkit (nvcc) and PyTorch; JAX is not needed. Phases, each fatal:

1. the card, and its name and power limit as nvidia-smi reports them;
2. building every kernel of ``mccnn_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the path that runs it, with kernel, plain and bound times:
   the KITTI fast-arch path (370x1226, D=228, 64 features; the tower on
   cuDNN with TF32 off against the same tower on the CPU; the join's
   winner maps against the plain volume's, and its gap to the emulation
   of its three-level bf16 split; the vertical sweeps bit for bit; the
   outlier labels equal, there and on seeded maps at the Middlebury
   ``-a time`` shape, 1000x1500, D=200, timed in a CUDA graph), then the
   KITTI slow-arch path (kitti slow widths: 112 features, head 384
   wide with three mid layers): the head kernel over the whole volume
   (with the time of the same chain as bf16 cuBLAS matmuls beside it and
   the share of the bf16 peak it reaches) and at a small ragged size in
   the Middlebury shape of the chain (two mid layers, 48 wide padded to
   64); the horizontal sweep's four uses (forward and reverse, with and
   without the volume write, the winner map fused) bit for bit;
   the blur with kitti slow's 37x37 Gaussian (both blurs print their
   max |d| to the plain version), and the generic lane's stacked
   horizontal (hslab) and vertical sweeps (both directions in one
   volume, the -1 direction's scanlines reversed; both bit for bit, NaN
   masks included); then the scan form's
   two entries (the counterparts of the whole-sweep and the
   grid-over-steps TPU kernels, one launch of the step-major kernel
   each) on the (T, S, D) slices and D1/D2 tables the scan form builds
   for both families (horizontal T=1226, S=740; vertical T=370,
   S=2452), the forward sweep and the backward one read in place,
   required equal to the plain loop bit for bit, and at a small shape
   whose rows are off a multiple of 4; the 16-bit instances of the HWD
   lane's kernels: the join stored as bf16 and f16 (and with d_true =
   200) equal to the float32 kernel's volume rounded, bit for bit, and
   the vertical and horizontal sweeps on the volume stored as bf16 and
   f16, chained as on the path, forward and reverse, with and without
   the volume write, equal to the plain loop bit for bit; bounds count
   the real cells, not the padding; the refinement chain's four kernels
   (occlusion fill, mismatch fill, subpixel, the 5x5 median) on phase
   4's own maps and volume (its stages' inputs captured in one
   ``stereo_predict``), each bit-identical to its plain version
   (``.view(torch.int32)``) and timed in a CUDA graph and by events: the
   mismatch fill also on an all-MISMATCH map, on mismatch against row
   0 and column 0 and on a 48x160 MISMATCH block mid-frame (clustered),
   its bound counting each map's probes; subpixel on the
   x-reversed volume in f32, bf16 and f16 and relaid as the generic
   lane's (D, H, W); the occlusion fill also on rows with no match and
   rows whose one match is the last column; the median also on the map
   with NaN of two payloads, -0.0 and +-inf in interior tiles, with the
   share of tiles and outputs on each of its paths; the CBCA kernel on kitti slow's own volumes and arms
   (one slow ``stereo_predict`` with random weights, the last CBCA input
   of each direction captured) and on kitti census's at K = 2, both
   directions, each bit-identical to its plain version, timed by events,
   its bound counting the adds these arms need; the arms kernel at K = 2,
   3, 5 and 14 on the pair's left image, bit-identical, timed in a CUDA
   graph; the census signatures and both census volumes on kitti
   census's own inputs, both ad volumes on kitti ad's, and the HWD
   lane's tables of both directions on kitti fast's
   (``capture_costs``, ``cost_rows``), each bit-identical to its plain
   version, the volumes timed by events and the rest in a CUDA graph,
   each beside one ``fill_`` of its output bytes (the store floor), the
   signatures also word for word on the pair's left image with NaN of
   two payloads, +-inf, -0.0 and ties (``adversarial_census``); the
   generic lane's layout kernels on kitti census's own inputs
   (``capture_layout``, ``layout_rows``): both families' d-minor volumes,
   both families' tables, the family sum with the quarter and the
   winner-take-all, each bit-identical to its plain version, beside one
   PyTorch call of the same function (a ``copy_`` of each permuted view,
   ``torch.add`` and ``div_``, ``torch.argmin`` of a NaN-free copy); the
   towers' kernels (``csrc/tower.cu``; ``capture_tower``, ``tower_rows``,
   ``epilogue_rows``): the bias kernel (off the paths since the
   convolutions fuse it: on each fused layer's bias-free output) and the
   normalization (the join's packed operands and the features' layout) on
   kitti fast's own convolution outputs in float32 and with ``-dtype
   bfloat16``, the bias kernel on kitti slow's, and the slow volumes'
   epilogue on kitti slow's
   head scores with and without d_true = 200, each bit for bit against
   its plain version (``.view(torch.int32)``) on those inputs and on
   copies with NaN of two payloads, -0.0 and +-inf planted, timed in a
   CUDA graph and by events beside its bound; the towers' convolutions
   (``csrc/conv.cu``; ``capture_convs``, ``conv_row``) on kitti fast's and
   kitti slow's own layer inputs in float32 and with ``-dtype bfloat16``,
   on kitti fast's row-sharded on 4 entries (slices that start
   mid-image), and on kitti fast nets at the other widths of the fast
   net's hyperparameter search (fm 80 and 96), each layer within
   ``CONV_F32_LIMIT`` (1.2e-6; float32) or 2e-6 (a 16-bit lane) of its sum
   |w||x| from ``F.conv2d`` with TF32 off, each layer with its bias and
   ReLU in the epilogue bit for bit the bias-free kernel followed by
   ``tower.bias_act``, the tower's convolutions timed in a CUDA graph and
   by events beside the unfused route and cuDNN's (the library call), its
   bound (six bf16 passes at the tensor-core peak, one in a 16-bit lane)
   and its f32 bound;
   then (phase 3b) every kernel that
   phase 7's Middlebury paths run, at their 1000x1500, D=200 shapes and
   on their inputs (seeded random weights at mb's widths, phase 7's
   pair), against its plain version with its KITTI tolerance: the join
   (padded 1024x1536x256, C=64) in float32 and its bf16 and f16 stores
   (and d_true = 150) equal to the float32 volume rounded; the vertical
   and horizontal sweeps chained as on the path in f32, bf16 and f16,
   both directions, bit for bit at every sweep; both blurs; the slow
   head over the whole volume (two mid layers, 384 wide); the stacked
   hslab and vertical sweeps of the -1 direction bit for bit; CBCA at mb
   slow's K = 14 on that head's volume, the -1 direction, and the arms
   kernel at K = 14, bit for bit; subpixel
   (its three storage types and the (D, H, W) layout) and the median on
   mb fast's own map and volume (and its adversarial copy), bit for bit;
   the census and ad kernels on mb census's and mb ad's inputs and the
   tables on mb fast's, bit for bit; the generic lane's layout kernels
   on one SGM iteration of the mb slow head's volume (the -1 direction),
   bit for bit; the towers' kernels on mb fast's convolution outputs
   (``-a predict`` in float32, both sides' operands; ``-a time`` with
   ``-dtype bfloat16``, the left side's) and mb slow's, and the epilogue
   on mb slow's head scores (and d_true = 150), bit for bit; the towers'
   convolutions of mb fast and mb slow in float32 and ``-dtype
   bfloat16``; each with kernel, plain and bound times;
4. the fast-arch ``stereo_predict`` on a seeded 370x1226 pair of known
   disparity: the launch count of every kernel in one run, the
   accuracy, and the share of pixels where it differs from the
   all-plain path (the CPU), the map's SHA-256 and the map bit for bit
   that of the same path with the cost volumes and the HWD tables built
   by their plain versions on the card (``same_as_plain_route``), and
   the plain torch launches of one run under ``torch.profiler``, at
   most 64 (the tables' plain build alone issues 188); then pairs/s
   (median of 10 runs after
   warm-up) on that pair and on bench.py's synthetic 350x1242 pair;
   then (phase 4b) the same path with ``-vol_dtype bfloat16``,
   ``-vol_dtype float16`` and ``-dtype bfloat16``: launch counts, the
   share of pixels moved by more than 1 px against the float32 map, the
   accuracy, pairs/s (median of 10, with the spread) and peak memory;
   in phases 4-7 every path with a tower also prints the share of its
   map's pixels more than 0.51 px from the same pair's map through the
   cuDNN route (the towers' convolutions as ``F.conv2d`` with TF32 off,
   ``cudnn_route``), at most 0.001, and every map's SHA-256 stands beside
   the first convolution design's (``FIRST_DESIGN_SHA``);
5. the slow-arch ``stereo_predict`` on the same pair: the launch count
   of every kernel in one run (CBCA twice a direction, the arms once an
   image) and the accuracy, with a head set by hand
   to score the L1 distance of the descriptors (a random head does not
   score identical patches as a match), the map bit for bit that of the
   plain route (SHA-256 printed); pairs/s (median of 5 after a
   warm-up) and peak memory with seeded random weights; the share of
   pixels where it differs from the all-plain path on the CPU at
   96x320, D=48;
6. the census and ad paths on the same pair (no network): kitti census
   in the slab, stream and grid forms of the SGM (launch counts of one
   ``stereo_predict`` per form, the three maps and final volumes
   required equal, the accuracy, pairs/s as the median of 5 after a
   warm-up and peak memory per form), kitti ad in the stream form, the
   kitti fast arch with CBCA (the join kernel feeding the generic lane;
   launch counts at full size, the all-plain comparison at 96x320,
   D=48), and the census kernel path against the all-plain path at
   96x320, D=48; census's signatures once a pair and its volume and
   ad's once a direction, the layout kernels (``layout_counts``),
   census's (slab form), ad's and fast with CBCA's maps bit for bit
   those of the plain route (SHA-256 printed), census's and ad's plain
   launches under a limit each;
7. Middlebury at the ``-a time`` shape, 1000x1500, D=200, on a seeded
   textured pair of true disparity 60: mb fast with the left direction
   alone (``-a time``) and with both (``-a predict``), and mb slow (the
   generic lane, CBCA x2 and x16 on the CBCA kernel, a head set by hand as
   in phase 5):
   launch counts (the HWD tables once a direction), accuracy, pairs/s
   (median of 10, of 3 for mb slow, with the spread) and peak memory;
   both mb fast maps and the mb slow map bit for bit those of the plain
   route (SHA-256 printed); both against the all-plain path on the CPU at 96x320, D=48
   with mb's own parameters;
8. training on the card (``training_phase``): a synthetic KITTI set at
   350x1242, D=228 (three images; the third is te); kitti fast (8 steps)
   and kitti slow (4 steps) at config.py's full widths from one sampled
   chunk as eager steps, on the card and on the CPU from the same seeded
   weights (the per-step losses within 1e-5 relative on step 1 and 1e-4
   over the chunk, the weights within 1e-5; the card's run launching
   ``warp_patches`` once a step and no other hand kernel); the warp
   kernel (``csrc/warp.cu``) at full width, one step's 256 patches of
   kitti fast's sampler, from the padded stack and from windows, bit for
   bit against its plain versions on the path's inputs and with NaN,
   -0.0, +-inf planted (``warp_rows``: in a CUDA graph, by events, the
   plain version, its bound, ``F.grid_sample``'s bicubic sampling); the
   chunk's CUDA graph (``trainer.make_train_chunk``) against eager
   ``train_chunk`` steps bit for bit under ``cudnn.deterministic``, kitti
   fast and slow in float32 and bfloat16, over 32 steps, 32 at lr/10 and
   a tail of 5 (``graph_vs_eager``); ``train()`` over 4 epochs of 256
   steps for each, with the chunk as a graph replay, as eager steps, and
   as a graph again (``train_rates``): the end-to-end steps/s of epochs
   2-4 with the rate of each epoch, patch pairs/s, the chunks' steps/s
   (median and spread after a warm-up chunk), the host's share of the
   time outside the chunk calls and a chunk build's time, peak memory,
   ``warp_patches`` launched once a step (and once for the graph's
   warm-up) by its wrappers' count and by its own counter on the card,
   and no other hand kernel, and one chunk each way under the
   profiler (``profile_chunk``: kernels and device time a step, the
   host's launch calls a step; the busy share is that device time over
   the chunk's wall without the profiler; it fails unless the profiler
   saw device time and the warp kernel's own counter on the card rose by
   one a step, the graph's nodes included); ``test_te`` of the untrained
   and the trained fast net on the third image through kernels 1-5
   (phase 4's launch counts, an error in [0, 1]); each trained net's
   checkpoint with its momentum, reloaded bit-equal, two more steps from
   each copy on a chunk whose positive and negative patches are swapped
   (losses above 0) bit-equal; mb fast for 8 steps on the host gather
   (the warp kernel from windows, the chunk a graph) against the CPU, and
   its ``test_te`` through the 64-buckets (launch counts, the map
   against the CPU's);
9. the modules that close the reference's working loop
   (``cache_phase``), on phase 4's pair at 370x1226, D=228: the seeded
   kitti fast net's first weights, which must be the JAX package's
   ``init_params`` at seed 42; the seeded kitti fast and kitti slow nets
   dumped as ``.t7`` and loaded through ``cli.load_params``
   (``-net_fname x.t7``): file sizes, load seconds, maps bit-identical
   to the in-memory nets' with phase 4's and phase 5's launch counts;
   the volume cache on kitti slow (the generic lane), in a directory
   under ``build/``: seconds a pair uncached, cache-making
   (``-make_cache``, the head launched once, the ``.npz`` size) and
   cached (``-use_cache``, the head launched no time), the three maps
   bit-identical; the host gather on phase 8's synthetic Middlebury set
   at 240x320: a chunk's windows from the C++ gather bit-identical to
   the numpy gather's, a chunk build's time with each, and mb fast
   ``train()`` steps/s with each (native, numpy, numpy, native), with
   whether the numpy build hides behind a chunk on the card; whether PIL
   imports, and where it does, ``preprocess_kitti`` on a raw tree of
   the fixed counts with ``HEIGHT, WIDTH`` cut to 64x128, then one
   chunk trained on the card from its output through ``load_kitti``;
10. the mesh (``parallel_phase``, ``mccnn_tpu_torch.parallel``) with the
   card listed 1, 2 and 4 times, on phase 4's pair: the serving lane
   (``make_batch_predict_sharded``, kitti fast, B=8) with every map
   bit-identical to phase 4's, 8x its launches, and pairs/s beside
   phase 4's; ``make_batch_predict`` on kitti slow, B=2, bit-identical
   to phase 5's maps; kitti fast and kitti slow row-sharded
   (``make_sharded_predict``; 370 rows as 93/93/92/92, 1226 columns as
   307/307/306/306 on 4 entries): launches, the share of pixels more
   than 0.51 from the single-device map (< 0.01), the largest slab each
   volume stage received against its share plus halo, s a pair; the
   data-parallel step (kitti fast and slow, bs=128, on 1 and 2 entries)
   against one ``train_chunk`` step (parameters within 1e-5, replicas
   equal), ms a step;
11. the experiment drivers (``drivers_phase``, ``mccnn_tpu_torch/tools/``)
   on a synthetic KITTI set with occlusions at 370x1226, D=228 (one te
   image; ``--te N`` for N, and ``--phase 11`` to run it alone after
   the build) under ``build/``, every child a ``python -m mccnn_tpu_torch``
   process on the card: ``hs random kitti fast test_te`` with the seeded
   fast net, as a process group of its own killed after its second log
   line, then ``hillclimb_fast`` on that log for one more line (each
   index within 1 of the best line's); kitti slow ``-make_cache`` by a
   direct run with phase 5's slow net, then one ``hs random kitti slow
   test_te`` line through ``-use_cache`` with that net; every logged
   score in [0, 1); a fast line and the slow line rerun directly (the
   slow one also without the cache), each scoring its logged score,
   with the seconds each takes, its start-up apart from its pairs (the
   first, and the mean of the rest); then
   side by side ``rgs.run_job`` (kitti slow at the slow line's point,
   the same score), one ``rgs_qsub`` job (kitti ad) with ``sh`` in
   place of the scheduler, and where PIL imports ``predict_kitti`` on
   two PNG scenes (its ``i err`` lines and mean in [0, 1)); no process
   of a search left behind.

Prints the kernels' JSON line (``launches`` counts the calls of a
kernel's entry on its path, ``kernel_launches`` the kernel launches
those calls made: one a call, but a join of more than 64 channels), the
card line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
there is no CUDA card or the package is missing, and when any phase
fails.
"""

import collections
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32
# outside the tensor cores and bf16 on the tensor cores (dense). A bound
# is the larger of bytes / MEM_BPS and operations / the peak of their
# type. The f32 peak counts a fused multiply-add as two operations; a
# kernel whose f32 instructions are not all FMAs is bounded by their
# count at the instruction rate, F32_INSTR, one instruction a lane a clock.
MEM_BPS = 3.35e12
F32_OPS = 67e12
F32_INSTR = F32_OPS / 2
BF16_TC_OPS = 989e12

H, W, D, SHIFT = 370, 1226, 228, 40
# the true disparity of the Middlebury phase's pair
MB_SHIFT = 60

# the refinement kernels a pair: KITTI runs the fills, subpixel and the
# median; Middlebury (no outlier stage) subpixel and the median
REFINE_KITTI = dict(occlusion_fill=1, mismatch_fill=1, subpixel=1, median5=1)
REFINE_MB = dict(subpixel=1, median5=1)


def cbca_counts(cfg, directions: int, shards: int = 1) -> dict:
    """The CBCA and arms launches of one pair on the generic lane: CBCA
    once an iteration (``cbca_i1`` + ``cbca_i2``) for each direction and
    row shard; the arms packed once a pair for each shard where an
    iteration runs (every iteration of the pair reads that pack); the
    arms once an image."""
    n = int(cfg.cbca_i1) + int(cfg.cbca_i2)
    return dict(cbca=directions * shards * n, cbca_pack=shards if n else 0,
                cross_arms=2)

# the first slow_head kernel (mma.sync, cp.async weight slabs) at the same
# shapes on one NVIDIA H100 80GB HBM3 at 700 W (PERF.md, kernel table row 6)
OLD_HEAD_MS = 319.10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


PEAK_NAMES = {F32_OPS: "f32 67 TFLOP/s",
              F32_INSTR: "f32 instructions 33.5 T/s",
              BF16_TC_OPS: "bf16 tensor cores 989 TFLOP/s"}


def bound_ms(nbytes: float, ops: float, peak: float = F32_OPS
             ) -> tuple[float, str, str]:
    """(the bound in ms, what sets it, the operations' peak it used)."""
    tb, to = nbytes / MEM_BPS * 1e3, ops / peak * 1e3
    return ((tb, "bytes") if tb >= to else (to, "operations")) \
        + (PEAK_NAMES[peak],)


def cuda_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up
    call unless ``warm`` is False, by CUDA events."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph, replayed once to warm up and then ``replays`` times
    between CUDA events. For a kernel shorter than its wrapper's host
    time, where :func:`cuda_ms` would time the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def kitti_pair(rng, h, w, shift):
    """A standardized random-texture pair whose true disparity is
    ``shift`` everywhere: x1[y, x - shift] == x0[y, x]."""
    from mccnn_tpu_torch.utils.images import standardize

    base = rng.randn(h, w + shift).astype(np.float32)
    return standardize(base[:, :w]), standardize(base[:, shift:shift + w])


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def identical(a, b) -> bool:
    """Equal values and equal NaN masks (bit for bit but for the NaN
    payloads and the sign of zero)."""
    return bool(a.isnan().equal(b.isnan())
                and a.nan_to_num().equal(b.nan_to_num()))


def cells_of(d: int, h: int = H, w: int = W) -> int:
    """The real cells of an (h, w) volume of d disparities."""
    return h * w * d


def timed(torch, fn, runs: int, warm: int = 2) -> tuple[float, list]:
    """pairs/s of ``fn`` as the median of ``runs`` synchronized calls
    after ``warm`` warm-up calls, and each run's time in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return 1.0 / statistics.median(times), [round(t * 1e3, 2) for t in times]


def spread(times: list) -> str:
    return f"runs {min(times)}-{max(times)} ms: {times}"


def peak_line(torch, held: float) -> str:
    """The peak device memory since the last reset, and how far it rose
    above ``held``, the GiB the script itself held at the reset (the
    pair's own peak)."""
    peak = torch.cuda.max_memory_allocated() / 2**30
    return f"peak {peak:.2f} GiB ({peak - held:.2f} above the {held:.2f} held)"


REFINE_STAGES = ("interpolate_occlusion", "interpolate_mismatch",
                 "subpixel_enhancement", "subpixel_enhancement_hwd",
                 "median2d")


def capture_calls(torch, mod, names, run, key=lambda name, a, kw: name
                  ) -> dict:
    """The arguments the functions ``names`` of ``mod`` receive in
    ``run()`` (one ``stereo_predict``): {key(name, args, kwargs): (args,
    kwargs)} of the last such call, so that phase 3 holds their kernels
    on the path's own inputs."""
    seen = {}
    orig = {name: getattr(mod, name) for name in names}

    def hook(name):
        def stage(*a, **kw):
            seen[key(name, a, kw)] = (a, kw)
            return orig[name](*a, **kw)
        return stage

    try:
        for name in names:
            setattr(mod, name, hook(name))
        run()
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(mod, name, fn)
    return seen


def capture_refine(torch, run) -> dict:
    """{stage: (args, kwargs)} of the last call of each refinement stage
    of ``ops/post.py`` in ``run()``."""
    from mccnn_tpu_torch.ops import post

    return capture_calls(torch, post, REFINE_STAGES, run)


def capture_cbca(torch, run) -> dict:
    """The arguments of the last ``cbca`` call of each direction in
    ``run()``, keyed ("cbca", direction), and of the last ``cross_arms``
    call, keyed ("cross_arms",)."""
    from mccnn_tpu_torch.ops import cross

    return capture_calls(
        torch, cross, ("cbca", "cross_arms"), run,
        key=lambda name, a, kw: (name, a[3]) if name == "cbca" else (name,))


# the cost kernels a pair of each generic-lane arch: census's signatures
# once a pair and a volume a direction, ad's volume a direction
COSTS = {"census": dict(census_signatures=1, census_volume=2),
         "ad": dict(ad_volume=2)}
# the wrappers of the census and ad volumes, the HWD lane's SGM tables,
# the generic lane's layouts, tables, family sum and winner-take-all and
# the towers' bias, normalization and slow epilogue, with their plain
# versions, as (module, wrapper, plain version); the towers' convolutions
# keep their kernels, their bias and ReLU moved out of the epilogue into
# tower.bias_act (conv3x3_unfused), so that the plain bias_act runs them
PLAIN_ROUTES = (("conv", "conv3x3", "conv3x3_unfused"),
                ("costs", "census_signatures", "census_signatures_plain"),
                ("costs", "census_volume", "census_volume_plain"),
                ("costs", "ad_volume", "ad_volume_plain"),
                ("sgm", "sgm_tables", "sgm_tables_plain"),
                ("sgm", "sgm_layout", "sgm_layout_plain"),
                ("sgm", "sgm_generic_tables", "sgm_generic_tables_plain"),
                ("sgm", "sgm_combine", "sgm_combine_plain"),
                ("costs", "wta", "wta_plain"),
                ("tower", "bias_act", "bias_act_plain"),
                ("tower", "normalize", "normalize_plain"),
                ("tower", "slow_epilogue", "slow_epilogue_plain"))


def layout_counts(directions: int, form: str = "slab", shards: int = 0
                  ) -> dict:
    """The generic lane's layout kernels a pair (``csrc/sgm_layout.cu``):
    in the slab form a family's volume each (``sgm_layout`` 2), both
    families' tables in one launch and the family sum with the quarter
    in one; in the scan forms none of these; the winner-take-all once a
    direction in every form. On ``shards`` row shards of the mesh the
    horizontal family runs a row shard and the vertical one a column
    shard, each with its own tables, the sum plain, the winner-take-all
    once a shard and direction."""
    if shards:
        return dict(sgm_layout=2 * shards, sgm_generic_tables=2 * shards,
                    wta_dhw=directions * shards)
    if form != "slab":
        return dict(wta_dhw=directions)
    return dict(sgm_layout=2, sgm_generic_tables=1, sgm_combine=1,
                wta_dhw=directions)


def capture_costs(torch, run) -> dict:
    """The arguments of the last call in ``run()`` of
    ``census_signatures``, keyed ("census_signatures",), of
    ``census_volume`` and ``ad_volume`` of each direction, keyed (name,
    direction), and of ``sgm_tables`` of each storage order, keyed
    ("sgm_tables", xrev)."""
    from mccnn_tpu_torch.ops import costs, sgm

    tables = {}
    seen = capture_calls(
        torch, costs, ("census_signatures", "census_volume", "ad_volume"),
        lambda: tables.update(capture_calls(
            torch, sgm, ("sgm_tables",), run,
            key=lambda name, a, kw: (name, kw["xrev"]))),
        key=lambda name, a, kw: (name,) if name == "census_signatures"
        else (name, a[3]))
    seen.update(tables)
    return seen


def adversarial_census(torch, img):
    """The pair's left image with what the census ``<`` must keep strict:
    NaN of two payloads, +inf, -inf, -0.0 beside +0.0 and runs of ties
    (a value repeated along a row and down a column), every 37th row from
    3 and every 101st column from 5, the frame's edges included."""
    img = img.clone()
    h, w = img.shape
    for y in list(range(3, h - 8, 37)) + [0, h - 1]:
        for x in list(range(5, w - 12, 101)) + [0, w - 1]:
            img[y, x] = float("nan")
            img[y, min(x + 1, w - 1)] = float("inf")
            img[y, min(x + 2, w - 1)] = float("-inf")
            img[y, min(x + 3, w - 1)] = -0.0
            img[y, min(x + 4, w - 1)] = 0.0
            img[y, min(x + 5, w - 1):min(x + 9, w)] = img[y, x - 1] \
                if x else 0.5
            img[y:min(y + 4, h), min(x + 10, w - 1)] = 0.25
            img.view(torch.int32)[min(y + 1, h - 1), x] = 0x7fc00123
    return img


def cost_rows(torch, seen, where) -> dict:
    """Rows for the cost and table kernels on the inputs
    ``capture_costs`` saw, each bit for bit against its plain version
    (``exact_row``): the signatures and the tables timed in a CUDA
    graph, the volumes by events, each beside the card's store floor for
    its output bytes (one ``fill_`` of the same bytes, timed as the kernel
    is: a (D, H, W) float32 volume by events, the signatures' words and
    the tables' buffer in a CUDA graph; ``fill_ms``), the signatures also
    on ``adversarial_census`` of the left image (key "census_signatures
    (adversarial)"). Bounds: the signatures read both images and write
    their 8-byte words (the census bits only), with the (2r+1)^2 compares
    a pixel, which the kernel does from a tile of 16 rows x 32 columns
    staged once a block with a NaN halo, a lane a column and 4 rows from
    register windows, one 16-byte store a pixel; a census volume reads
    both signatures and writes its cells, with 3 nw + 3 integer
    instructions a cell (and-not-xor, popcount and add a word; the
    subtract, the conversion, the multiply), which the kernel does from a
    span of match signatures staged once a block of a row's 256 columns x
    32 disparities, two columns a thread stored as 8-byte pairs; an ad
    volume reads both images and writes its cells, with 20 f32
    instructions a cell (the term, its row sum's and its column sum's 8
    adds, the division), which the kernel does from register windows over
    a tile of 32 rows x 128 columns x 16 disparities staged once, 16-byte
    or 8-byte stores; the tables read both images and write the four
    sweeps' buffer, a block a row of a table part in 16-byte stores."""
    from mccnn_tpu_torch.ops import costs, sgm

    def floor(row, out, graph=True):
        """One ``fill_`` of ``out``'s bytes beside the kernel's row."""
        fill = (lambda: out.fill_(0)) if out.dtype != torch.float32 \
            else (lambda: out.fill_(float("nan")))
        row["fill_ms"] = (graph_ms(torch, fill, 20) if graph
                          else cuda_ms(torch, fill, 10))
        print(f"    the store floor: fill_ of the same "
              f"{out.numel() * out.element_size()} bytes "
              f"{row['fill_ms']:.4f} ms; the kernel at "
              f"{row['bound'][0] / row['ms']:.2f} of its bound")

    rows = {}
    if ("census_signatures",) in seen:
        (x0, x1), _ = seen[("census_signatures",)]
        npix = x0.numel()
        nw = costs.census_words(4)
        for key, a, b in (
                ("census_signatures", x0, x1),
                ("census_signatures (adversarial)",
                 adversarial_census(torch, x0), x1)):
            rows[key] = exact_row(
                torch, f"{key} {where}",
                lambda a=a, b=b: costs.census_signatures(a, b),
                lambda a=a, b=b: costs.census_signatures_plain(a, b),
                2 * npix * (4 + 8 * nw), 2 * 81.0 * npix)
            floor(rows[key], torch.empty((2, npix, nw), dtype=torch.int64,
                                         device=x0.device))
    for name, plain in (("census_volume", costs.census_volume_plain),
                        ("ad_volume", costs.ad_volume_plain)):
        for direction in (-1, 1):
            if (name, direction) not in seen:
                continue
            a, kw = seen[(name, direction)]
            d = a[2]
            h, w = a[0].shape[-2:]
            cells = d * h * w
            if name == "census_volume":
                nw = kw["signatures"][0].shape[-1]
                nbytes = 4 * cells + 2 * kw["signatures"][0].numel() * 8
                ops = (3 * nw + 3.0) * cells
            else:
                nbytes, ops = 4 * cells + 8 * h * w, 20.0 * cells
            key = name + ("" if direction == -1 else " (direction +1)")
            rows[key] = exact_row(
                torch, f"{name} {where}, direction {direction:+d}",
                lambda: getattr(costs, name)(*a, **kw),
                lambda: plain(*a, **kw), nbytes, ops, graph=False, reps=10)
            floor(rows[key], torch.empty((d, h, w), dtype=torch.float32,
                                         device=a[0].device), graph=False)
    for xrev in (True, False):
        if ("sgm_tables", xrev) not in seen:
            continue
        a, kw = seen[("sgm_tables", xrev)]
        x0, _, d, h, w, shape = a
        hp, wp, dp = shape
        _, stride = sgm.table_layout(hp, wp, d + wp + dp)
        key = "sgm_tables" + ("" if xrev else " (xrev False)")
        rows[key] = exact_row(
            torch, f"sgm_tables {where}, xrev {xrev}, buffer of "
            f"{16 * stride} bytes", lambda: sgm.sgm_tables(*a, **kw),
            lambda: sgm.sgm_tables_plain(*a, **kw), 8 * h * w + 16 * stride)
        floor(rows[key], torch.empty(4 * stride, dtype=torch.float32,
                                     device=x0.device))
    torch.cuda.empty_cache()
    return rows


def capture_layout(torch, run) -> dict:
    """The arguments of the last call in ``run()`` of ``sgm_layout`` of
    each family, keyed ("sgm_layout", vertical), and of
    ``sgm_generic_tables``, ``sgm_combine`` and ``costs.wta``, keyed
    (name,)."""
    from mccnn_tpu_torch.ops import costs, sgm

    seen = {}
    seen.update(capture_calls(
        torch, costs, ("wta",), lambda: seen.update(capture_calls(
            torch, sgm, ("sgm_layout", "sgm_generic_tables", "sgm_combine"),
            run, key=lambda name, a, kw: (name, kw["vertical"])
            if name == "sgm_layout" else (name,))),
        key=lambda name, a, kw: (name,)))
    return seen


def layout_rows(torch, seen, where) -> dict:
    """Rows for the generic lane's layout kernels on the inputs
    ``capture_layout`` saw, each bit for bit against its plain version,
    beside one PyTorch call of the same function (``library_ms``): the
    families' volumes (by events) beside a ``copy_`` of each direction's
    permuted view into a contiguous buffer (the parent's op without the
    NaN pad); both families' tables (in a CUDA graph; no library call);
    the family sum with the quarter (by events) beside ``torch.add`` of
    the families' views and ``div_`` by 4; the winner-take-all (by
    events) beside ``torch.argmin`` over d of a NaN-free copy (a
    yardstick: argmin does not skip NaN). Bounds by bytes, each input
    read once (the real cells: the volumes, the accumulators' D real
    lanes, both images) and each output written once (the layouts' pad
    lanes included)."""
    from mccnn_tpu_torch.ops import costs, sgm

    rows = {}
    for vertical in (False, True):
        if ("sgm_layout", vertical) not in seen:
            continue
        a, kw = seen[("sgm_layout", vertical)]
        vols, dp = a
        n = len(vols)
        d, h, w = vols[0].shape
        key = "sgm_layout" + (" (vertical)" if vertical else "")
        rows[key] = exact_row(
            torch, f"{key} {where}, {n} direction(s)",
            lambda: sgm.sgm_layout(*a, **kw),
            lambda: sgm.sgm_layout_plain(*a, **kw),
            4 * n * d * h * w + 4 * n * h * w * dp, graph=False, reps=10)
        perm = (1, 2, 0) if vertical else (2, 1, 0)
        bufs = [torch.empty_like(v.permute(*perm),
                                 memory_format=torch.contiguous_format)
                for v in vols]
        rows[key]["library_ms"] = cuda_ms(torch, lambda: [
            b.copy_(v.permute(*perm)) for b, v in zip(bufs, vols)], 5)
        del bufs
    if ("sgm_generic_tables",) in seen:
        a, kw = seen[("sgm_generic_tables",)]
        x0, _, d, dirs = a
        _, total = sgm.generic_table_layout(*x0.shape, d, len(dirs), **kw)

        def flat(t):
            return torch.as_strided(next(iter(t.values())), (total,), (1,), 0)

        rows["sgm_generic_tables"] = exact_row(
            torch, f"sgm_generic_tables {where}, buffer of {4 * total} bytes",
            lambda: flat(sgm.sgm_generic_tables(*a, **kw)),
            lambda: flat(sgm.sgm_generic_tables_plain(*a, **kw)),
            4 * total + 8 * x0.numel())
    if ("sgm_combine",) in seen:
        a, kw = seen[("sgm_combine",)]
        acc_h, acc_v, dirs, d = a
        cells = len(dirs) * d * (acc_h.shape[1] // len(dirs)) * acc_h.shape[0]
        got = sgm.sgm_combine(*a, **kw)
        want = sgm.sgm_combine_plain(*a, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(got[k].view(torch.int32),
                              want[k].view(torch.int32)) for k in dirs),
              f"sgm_combine {where}: not bit-identical to its plain version")
        del got, want
        row = dict(err=0.0,
                   ms=cuda_ms(torch, lambda: sgm.sgm_combine(*a, **kw), 10),
                   plain_ms=cuda_ms(torch,
                                    lambda: sgm.sgm_combine_plain(*a, **kw), 2),
                   bound=bound_ms(12.0 * cells, 2.0 * cells, F32_INSTR))
        hv = sgm.horizontal_views(acc_h, dirs, d)
        vv = sgm.vertical_views(acc_v, dirs, d)
        bufs = {k: torch.empty(hv[k].shape, dtype=torch.float32,
                               device=acc_h.device) for k in dirs}
        row["library_ms"] = cuda_ms(torch, lambda: [
            torch.add(hv[k], vv[k], out=bufs[k]).div_(4.0) for k in dirs], 5)
        del bufs
        print(f"  sgm_combine {where}, {len(dirs)} direction(s), quarter "
              f"{kw.get('quarter')}: bit-identical to the plain version; "
              f"kernel {row['ms']:.4f} ms by events, plain "
              f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} "
              f"ms, bound {row['bound'][0]:.5f} ms ({row['bound'][1]})")
        rows["sgm_combine"] = row
    if ("wta",) in seen:
        (vol,), _ = seen[("wta",)]
        h, w = vol.shape[1:]
        rows["wta_dhw"] = exact_row(
            torch, f"wta_dhw {where}", lambda: costs.wta(vol),
            lambda: costs.wta_plain(vol), 4 * vol.numel() + 4 * h * w,
            graph=False, reps=10)
        clean = torch.where(vol.isnan(), torch.inf, vol)
        rows["wta_dhw"]["library_ms"] = cuda_ms(
            torch, lambda: torch.argmin(clean, dim=0), 10)
        del clean
    torch.cuda.empty_cache()
    return rows


def tower_counts(cfg, shards: int = 1) -> dict:
    """The tower kernels a pair (``csrc/tower.cu``, ``csrc/conv.cu``), on
    each of ``shards`` row shards: a convolution a layer, the bias and
    ReLU in its epilogue (the bias kernel no time); the fast tower's last
    layer's bias and normalization write the join's operands (or the
    features) in one launch; the slow volumes' epilogue once; none for
    census and ad."""
    if cfg.arch == "fast":
        return dict(tower_bias_act=0, tower_normalize_pack=shards,
                    tower_conv=shards * cfg.l1)
    if cfg.arch == "slow":
        return dict(tower_bias_act=0, slow_volumes_epilogue=shards,
                    tower_conv=shards * cfg.l1)
    return {}


def capture_tower(torch, run) -> dict:
    """The arguments of the last ``tower.bias_act`` and ``tower.normalize``
    call of each compute dtype in ``run()``, keyed (name, dtype, pack's
    sides or None), the convolution output cloned before the call
    (``bias_act`` writes into it); a convolution with its bias and ReLU in
    its epilogue counts as the bias-free convolution (run once more here
    for its output) and a ``bias_act`` call on it."""
    from mccnn_tpu_torch.ops import conv, tower

    seen = {}
    orig = {name: getattr(tower, name) for name in ("bias_act", "normalize")}
    orig_conv = conv.conv3x3

    def conv_call(x, weight, dtype=torch.float32, bias=None, relu=False):
        if bias is not None:
            seen[("bias_act", dtype, None)] = (
                (orig_conv(x, weight, dtype), bias.detach().clone(), relu,
                 dtype), {})
        return orig_conv(x, weight, dtype, bias, relu)

    def hook(name):
        def call(acc, bias, *a, **kw):
            if name == "bias_act":
                key = (name, a[1], None)
            else:
                pack = a[1] if len(a) > 1 else kw.get("pack")
                key = (name, a[0], None if pack is None else pack[1])
            seen[key] = ((acc.clone(), bias.detach().clone(), *a), kw)
            return orig[name](acc, bias, *a, **kw)
        return call

    try:
        for name in orig:
            setattr(tower, name, hook(name))
        conv.conv3x3 = conv_call
        run()
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(tower, name, fn)
        conv.conv3x3 = orig_conv
    return seen


def plant(torch, t):
    """A copy of ``t`` with NaN of two payloads, -0.0 and +-inf planted at
    strides that reach every plane."""
    t = t.clone()
    flat = t.view(-1)
    flat[::9973] = float("nan")
    flat[1::9967] = torch.tensor([0x7fc00123], dtype=torch.int32).view(
        torch.float32).item()
    flat[2::9949] = -0.0
    flat[3::9941] = float("inf")
    flat[4::9931] = -float("inf")
    return t


def bits_equal(torch, got, want) -> bool:
    """Equal shapes and equal bits (``.view(torch.int32)``), element by
    element of two tensors or of two tuples of tensors (None for None)."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    return len(got) == len(want) and all(
        (g is None and w is None) or (
            g is not None and w is not None and g.shape == w.shape
            and torch.equal(g.contiguous().view(torch.int32),
                            w.contiguous().view(torch.int32)))
        for g, w in zip(got, want))


def tower_rows(torch, seen, where) -> dict:
    """Rows for the tower kernels on the inputs ``capture_tower`` saw:
    each kernel bit for bit (``.view(torch.int32)``) against its plain
    version on the path's own input and on a copy with NaN, -0.0 and
    +-inf planted (and a -0.0 bias), timed in a CUDA graph and by events
    (the bias kernel in place on a scratch copy), the plain version by
    events. Bounds by bytes: the bias kernel reads and writes its tensor
    once; the normalization reads the convolution output once and writes
    its outputs once (the operands' pad included). No single PyTorch call
    computes either (``library_ms`` null)."""
    from mccnn_tpu_torch.ops import tower

    rows = {}
    for key in sorted(seen, key=str):
        name, dtype, sides = key
        (acc, bias, *rest), kw = seen[key]
        dt = str(dtype).replace("torch.", "")
        planted = plant(torch, acc)
        pbias = bias.clone()
        pbias[0] = -0.0
        with torch.no_grad():
            if name == "bias_act":
                relu = rest[0]
                for a, b in ((acc, bias), (planted, pbias)):
                    got = tower.bias_act(a.clone(), b, relu, dtype)
                    want = tower.bias_act_plain(a.clone(), b, relu, dtype)
                    check(bits_equal(torch, got, want), f"tower_bias_act "
                          f"{where} {dt}: not bit-identical to its plain "
                          "version")
                del got, want
                scratch = acc.clone()
                kernel = (lambda: tower.bias_act(scratch, bias, relu, dtype))
                plain = (lambda: tower.bias_act_plain(scratch, bias, relu,
                                                      dtype))
                nbytes = 2 * 4 * acc.numel()
                label = f"tower_bias_act ({dt}, relu {relu})"
            else:
                pack = rest[1] if len(rest) > 1 else kw.get("pack")
                for a, b in ((acc, bias), (planted, pbias)):
                    for p in (pack, None):
                        got = tower.normalize(a, b, dtype, p)
                        want = tower.normalize_plain(a, b, dtype, p)
                        check(bits_equal(torch, tuple(got[:4]) if p else got,
                                         tuple(want[:4]) if p else want),
                              f"tower_normalize {where} {dt} pack {p}: not "
                              "bit-identical to its plain version")
                del got, want
                out = tower.normalize(acc, bias, dtype, pack)
                nbytes = 4 * acc.numel() + sum(
                    4 * t.numel() for t in (out[:4] if pack else (out,))
                    if t is not None)
                del out
                kernel = (lambda: tower.normalize(acc, bias, dtype, pack))
                plain = (lambda: tower.normalize_plain(acc, bias, dtype,
                                                       pack))
                label = (f"tower_normalize_pack ({dt}, "
                         f"{'sides ' + sides if sides else 'features'})")
                scratch = None
            row = dict(err=0.0, ms=graph_ms(torch, kernel, 10),
                       events_ms=cuda_ms(torch, kernel, 10),
                       plain_ms=cuda_ms(torch, plain, 3),
                       bound=bound_ms(nbytes, 0.0), library_ms=None)
        del planted, scratch
        print(f"  {label} {where}, {tuple(acc.shape)}: bit-identical to the "
              f"plain version (also with NaN, -0.0, +-inf planted); kernel "
              f"{row['ms']:.4f} ms in a CUDA graph, {row['events_ms']:.4f} ms "
              f"by events, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound'][0]:.4f} ms (bytes), "
              f"{row['bound'][0] / row['ms']:.2f} of it")
        rows[label] = row
    torch.cuda.empty_cache()
    return rows


def epilogue_rows(torch, s, n, d_true, where) -> dict:
    """Rows for the slow volumes' epilogue on the head scores ``s`` of a
    path, with ``n`` border columns, without and with ``d_true``: bit for
    bit against its plain version on ``s`` and on a copy with NaN, -0.0
    and +-inf planted, timed by events and in a CUDA graph; the bound by
    bytes, the real planes of ``s`` read once and both volumes written
    once."""
    from mccnn_tpu_torch.ops import tower

    rows = {}
    planted = plant(torch, s)
    for dt in (None, d_true):
        for v in (s, planted):
            check(bits_equal(torch, tower.slow_epilogue(v, n, dt),
                             tower.slow_epilogue_plain(v, n, dt)),
                  f"slow_volumes_epilogue {where} (n {n}, d_true {dt}): not "
                  "bit-identical to its plain version")
        torch.cuda.synchronize()
        D, h, w = s.shape
        real = D if dt is None else dt
        row = dict(err=0.0,
                   ms=graph_ms(torch, lambda: tower.slow_epilogue(s, n, dt),
                               5),
                   events_ms=cuda_ms(torch, lambda: tower.slow_epilogue(
                       s, n, dt), 5),
                   plain_ms=cuda_ms(torch, lambda: tower.slow_epilogue_plain(
                       s, n, dt), 2),
                   bound=bound_ms(4.0 * h * w * (real + 2 * D), 0.0),
                   library_ms=None)
        label = ("slow_volumes_epilogue" if dt is None
                 else f"slow_volumes_epilogue (d_true {dt})")
        print(f"  {label} {where}, n = {n}: bit-identical to the plain version"
              f" (also with NaN, -0.0, +-inf planted); kernel {row['ms']:.4f}"
              f" ms in a CUDA graph, {row['events_ms']:.4f} ms by events, "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms"
              f" (bytes), {row['bound'][0] / row['ms']:.2f} of it")
        rows[label] = row
    del planted
    torch.cuda.empty_cache()
    return rows


def capture_convs(torch, run) -> list:
    """The (x, weight, dtype, bias, relu) of every ``conv.conv3x3`` call in
    ``run()`` (one ``stereo_predict``), in order: the tower's convolutions
    on the path's own inputs (nothing writes a layer's input after its
    convolution), the bias None for the fast tower's last layer."""
    from mccnn_tpu_torch.ops import conv

    seen = []
    orig = conv.conv3x3

    def call(x, weight, dtype=torch.float32, bias=None, relu=False):
        seen.append((x, weight, dtype, bias, relu))
        return orig(x, weight, dtype, bias, relu)

    conv.conv3x3 = call
    try:
        run()
        torch.cuda.synchronize()
    finally:
        conv.conv3x3 = orig
    return seen


# the float32 layers' limit on max |d| / sum |w||x| from F.conv2d (TF32
# off): above the sound kernel's readings (4.1e-7 to 7.5e-7), below the
# 1.79e-6 of a kernel that sums all six bf16 products in one set of
# accumulators (PERF.md row S); a 16-bit lane's limit is 2e-6
CONV_F32_LIMIT = 1.2e-6


def conv_row(torch, calls, where, reps: int = 10) -> dict:
    """A row for the tower's convolutions of one pair, on the inputs
    ``capture_convs`` saw: each layer's bias-free kernel against
    ``F.conv2d`` with TF32 off on the same operands
    (``conv.conv3x3_plain``, the plain version and the library call in
    one), max |d| relative to the layer's sum |w||x| (in a 16-bit lane the
    products are exact: the float32 summation order alone), checked within
    ``CONV_F32_LIMIT`` in float32 and 2e-6 in a 16-bit lane; each layer
    with its bias and ReLU in the epilogue bit for bit the bias-free
    kernel followed by ``tower.bias_act`` (``conv3x3_unfused``); the
    tower's launches as the path makes them (fused) in a CUDA graph and by
    events, the unfused route's in a CUDA graph, cuDNN's (bias-free) by
    events. The bound: each layer's input read and output written once
    (and its weights) against its operations: the first layer's
    multiply-adds at the f32 peak, a wider layer's six bf16 passes (one in
    a 16-bit lane) at the bf16 tensor-core peak; beside it every layer at
    the f32 peak. The row's times and bound are per launch (the tower's
    sums over its launches); the printed line gives the pair's."""
    from mccnn_tpu_torch.ops import conv

    errs, bound, f32 = {}, 0.0, 0.0
    by = collections.Counter()
    dts = set()
    with torch.no_grad():
        for x, w, dt, b, relu in calls:
            got = conv.conv3x3(x, w, dt)
            ref = conv.conv3x3_plain(x, w, dt)
            scale = conv.conv3x3_plain(x.float().abs(), w.abs(), dt)
            errs[dt] = max(errs.get(dt, 0.0), float(
                ((got - ref).abs() / scale.clamp_min(1e-30)).max()))
            del got, ref, scale
            if b is not None:
                check(bits_equal(torch, conv.conv3x3(x, w, dt, b, relu),
                                 conv.conv3x3_unfused(x, w, dt, b, relu)),
                      f"tower_conv {where} ({dt}): the fused epilogue is not "
                      "bit for bit the bias-free kernel and tower.bias_act")
            N, Ci, h, w_ = x.shape
            Co = w.shape[0]
            macs = float(N * h * w_ * Ci * Co * 9)
            nbytes = 4.0 * (N * h * w_ * (Ci + Co) + w.numel())
            if Ci == Co and Ci in conv.WIDTHS:
                passes = 6 if dt == torch.float32 else 1
                bb = bound_ms(nbytes, 2 * passes * macs, BF16_TC_OPS)
            else:
                bb = bound_ms(nbytes, 2 * macs)
            bound += bb[0]
            by[bb[1]] += bb[0]
            f32 += 2 * macs / F32_OPS * 1e3
            dts.add(str(dt).replace("torch.", ""))

        def kernels():
            for x, w, dt, b, relu in calls:
                conv.conv3x3(x, w, dt, b, relu)

        def unfused():
            for x, w, dt, b, relu in calls:
                conv.conv3x3_unfused(x, w, dt, b, relu)

        def library():
            for x, w, dt, _, _ in calls:
                conv.conv3x3_plain(x, w, dt)

        n = len(calls)
        ms = graph_ms(torch, kernels, reps)
        events = cuda_ms(torch, kernels, reps)
        split_ms = graph_ms(torch, unfused, reps)
        lib = cuda_ms(torch, library, max(2, reps // 2))
    torch.cuda.synchronize()
    for dt, e in errs.items():
        limit = CONV_F32_LIMIT if dt == torch.float32 else 2e-6
        check(e <= limit, f"tower_conv {where} ({dt}): max |d| {e} of sum "
              f"|w||x| from F.conv2d (TF32 off), over {limit}")
    err = max(errs.values())
    n_fused = sum(b is not None for *_, b, _ in calls)
    print(f"  tower_conv {where} ({'/'.join(sorted(dts))}, {n} layers, "
          f"{n_fused} with the bias and ReLU in the epilogue, bit for bit "
          f"tower.bias_act's, {tuple(calls[-1][0].shape)} into the last): "
          f"max |d| {err:.3g} of sum |w||x| from F.conv2d (TF32 off); "
          f"kernels {ms:.4f} ms a pair in a CUDA graph ({events:.4f} by "
          f"events), unfused (bias-free kernels and tower_bias_act) "
          f"{split_ms:.4f} ms, cuDNN (bias-free) {lib:.4f} ms "
          f"({lib / events:.2f}x); bound {bound:.4f} ms (six bf16 passes, "
          f"one in a 16-bit lane, at {BF16_TC_OPS / 1e12:.0f} TFLOP/s), "
          f"{bound / ms:.2f} of it; f32 bound {f32:.4f} ms at "
          f"{F32_OPS / 1e12:.0f} TFLOP/s")
    return dict(err=err, ms=ms / n, events_ms=events / n, plain_ms=lib / n,
                library_ms=lib / n,
                bound=(bound / n, max(by, key=by.get), PEAK_NAMES[BF16_TC_OPS]),
                pair_ms=ms, pair_events_ms=events, pair_library_ms=lib,
                pair_unfused_ms=split_ms, pair_bound_ms=bound,
                pair_f32_ms=f32)


def cudnn_route(torch, run):
    """``run()`` with the towers' convolutions as ``F.conv2d`` with TF32
    off (``conv.conv3x3_plain`` in place of ``conv.conv3x3``) and a fused
    layer's bias and ReLU as ``tower.bias_act_plain`` after it: the route
    before the hand kernels, computed for the comparison only."""
    from mccnn_tpu_torch.ops import conv, tower

    def plain(x, weight, dtype=torch.float32, bias=None, relu=False):
        out = conv.conv3x3_plain(x, weight, dtype)
        if bias is None:
            return out
        return tower.bias_act_plain(out, bias, relu, dtype)

    saved = conv.conv3x3
    conv.conv3x3 = plain
    try:
        out = run()
        torch.cuda.synchronize()
        return out
    finally:
        conv.conv3x3 = saved


def moved_from_cudnn(torch, what, run, disp) -> float:
    """The share of the map ``disp`` of ``run()`` more than 0.51 px from
    the same pair's map through the cuDNN route (``cudnn_route``); checked
    at most 0.001."""
    ref = cudnn_route(torch, run).cpu()
    moved = float(((torch.as_tensor(disp).cpu() - ref).abs() > 0.51)
                  .float().mean())
    print(f"  {what}: {moved:.6f} of pixels more than 0.51 px from the map "
          f"through the cuDNN route (the towers' convolutions as F.conv2d, "
          f"TF32 off)")
    check(moved <= 0.001, f"{what}: {moved} of pixels moved from the cuDNN "
          "route's map")
    return moved


def map_sha(a) -> str:
    """The SHA-256 of a map's float32 bytes (``profile_predict``'s)."""
    arr = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return hashlib.sha256(arr.astype(np.float32).tobytes()).hexdigest()


def plain_route(torch, run):
    """``run()`` with the census and ad volumes, the HWD lane's SGM
    tables, the generic lane's layouts, tables, family sum and
    winner-take-all and the towers' passes after the convolutions built
    by their plain versions on the card (``PLAIN_ROUTES``); the kernels'
    launch counts untouched."""
    from mccnn_tpu_torch.ops import conv, costs, sgm, tower

    mods = {"conv": conv, "costs": costs, "sgm": sgm, "tower": tower}
    saved = [(mods[m], name, getattr(mods[m], name))
             for m, name, _ in PLAIN_ROUTES]
    try:
        for m, name, plain in PLAIN_ROUTES:
            setattr(mods[m], name, getattr(mods[m], plain))
        out = run()
        torch.cuda.synchronize()
        return out
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# each path's map SHA-256 with the towers' convolutions of the first hand
# design (one bias-free kernel a layer, then tower_bias_act), printed
# beside this run's: the redesigned kernels keep each output's order of
# products, so the maps should not move
FIRST_DESIGN_SHA = {
    "kitti fast":
        "6f4cf7058af41443f131e30655068c1e6a324166f90c629118ce17ac4828c8b3",
    "kitti slow":
        "be571531142a1ec40b52fc71d1db42be33ed2a4d7bf9b6a3dc79387115c6e1ee",
    "kitti census (slab form)":
        "1fc4ed8d8681552e07d0440b950cadb2930c1e86df4f6f4a536b9db66f7f1acc",
    "kitti ad (stream form)":
        "abb9c2ee5dd5bd1cccebc6c15a18dbbca5714b12fc554d29d3c53d11adee6a6b",
    "kitti fast with CBCA (slab form)":
        "84d3ab3ce35e1de5fa61dbf03135550ba0c6c2525f05f28960b61bcfcebac13b",
    "mb fast -a time (left direction)":
        "b08a2ce1f6d1d9755624cf6bc82d9e62750e7d665950c84167afb6345e045aac",
    "mb fast -a predict (both directions)":
        "b08a2ce1f6d1d9755624cf6bc82d9e62750e7d665950c84167afb6345e045aac",
    "mb slow -a time (left direction, head set by hand)":
        "1897e80609417fd92ca9e411e41c05083bb4841cb2fc8787688615d6a9349666"}


def same_as_plain_route(torch, what, run, disp) -> str:
    """Check that the map ``disp`` of ``run()`` is bit for bit the map of
    the plain route (``plain_route``); returns its SHA-256, printed beside
    the first convolution design's (``FIRST_DESIGN_SHA``)."""
    ref = plain_route(torch, run)
    check(torch.equal(disp.view(torch.int32), ref.view(torch.int32)),
          f"{what}: the map differs from the plain route's")
    sha = map_sha(disp)
    first = FIRST_DESIGN_SHA.get(what)
    beside = ("" if first is None else
              f" ({'the same as' if sha == first else 'NOT'} the first "
              f"convolution design's {first[:16]})")
    print(f"  {what}: map sha256 {sha}{beside}, bit for bit the map with the "
          f"cost volumes, the HWD tables, the generic lane's layouts, tables, "
          f"sum and winner-take-all and the towers' bias, normalization and "
          f"slow epilogue built by their plain versions")
    return sha


def plain_launches(torch, run) -> tuple:
    """(plain torch kernel launches, hand kernel launches) of ``run()``
    under ``torch.profiler``, grouped as ``profile_predict`` groups them;
    (None, None) where the profiler sees no device kernel."""
    from mccnn_tpu_torch import profile_predict

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    n = collections.Counter()
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            n[profile_predict._group(e.key)] += e.count
    if not n:
        return None, None
    return n[profile_predict.PLAIN], n["hand-written CUDA kernels"]


def check_plain_launches(torch, what, run, most) -> None:
    """Print ``run()``'s plain and hand kernel launches, and fail if the
    plain ones exceed ``most`` or the profiler sees no device kernel."""
    plain, hand = plain_launches(torch, run)
    check(plain is not None, f"{what}: torch.profiler saw no device kernel, "
          "so the plain launches cannot be counted")
    print(f"  {what}: {plain} plain torch kernel launches, {hand} hand "
          f"kernel launches (torch.profiler)")
    check(plain <= most, f"{what}: {plain} plain launches, more than {most}")


def ray_probes(torch, labels) -> int:
    """The probes the mismatch fill's walk makes on ``labels``: each
    MISMATCH pixel's 16 rays, a probe a step until one is out of frame,
    on row (column) 0 at an odd step of a -0.5 component, or not
    MISMATCH (csrc/refine.cu). The data-dependent work of its bound."""
    from mccnn_tpu_torch.ops.post import _RAY_DIRS

    h, w = labels.shape
    mm = labels == 2
    ys = torch.arange(h, device=labels.device)[:, None].expand(h, w)
    xs = torch.arange(w, device=labels.device)[None, :].expand(h, w)
    n = torch.zeros((), dtype=torch.int64, device=labels.device)
    for fdx, fdy in _RAY_DIRS.tolist():
        live = mm.clone()
        for t in range(1, max(h, w) + 2):
            py = ys + int(np.floor(t * fdy + 0.5))
            px = xs + int(np.floor(t * fdx + 0.5))
            live &= (py >= 0) & (py < h) & (px >= 0) & (px < w)
            if t % 2 and fdy == -0.5:
                live &= py != 0
            if t % 2 and fdx == -0.5:
                live &= px != 0
            if t % 64 == 0 and not bool(live.any()):
                break
            n += live.sum()
            live &= labels[py.clamp(0, h - 1), px.clamp(0, w - 1)] == 2
    return int(n)


def mismatch_maps(lab) -> dict:
    """{name: labels} the mismatch fill is held on, from the path's own
    labels: the path's; every pixel MISMATCH (every ray walks to the
    frame's edge); mismatch against row 0 and column 0, landings on both
    at every third pixel (the -0.5 rule of the half directions); a
    48 x 160 MISMATCH block mid-frame, as a textureless wall or the sky
    gives (tiles inside it dense, those on its rim sparse)."""
    h, w = lab.shape
    edges = lab.clone()
    edges[:8], edges[:, :8] = 2.0, 2.0
    edges[0, ::3], edges[::3, 0] = 0.0, 1.0
    clustered = lab.clone()
    clustered[h // 2 - 24:h // 2 + 24, w // 2 - 80:w // 2 + 80] = 2.0
    return {"path": lab, "all MISMATCH": lab.new_full(lab.shape, 2.0),
            "edges": edges, "clustered": clustered}


def no_match_rows(lab):
    """The path's labels with its first 10 rows holding no MATCH and the
    next 10 one MATCH alone, in the last column (the fill then copies it
    along the row)."""
    lab = lab.clone()
    lab[:10] += (lab[:10] == 0).to(lab.dtype)  # MATCH (0) to OCCLUSION (1)
    lab[10:20] = 1.0
    lab[10:20, -1] = 0.0
    return lab


def adversarial_median(torch, img):
    """The path's map with NaN (two payloads), -0.0, +inf and -inf in
    interior tiles: every 40th row from 12, every 96th column from 40."""
    img = img.clone()
    h, w = img.shape
    for y in range(12, h - 16, 40):
        for x in range(40, w - 48, 96):
            img[y, x] = float("nan")
            img.view(torch.int32)[y + 1, x + 3] = 0x7fc00123
            img[y + 2, x + 5] = -0.0
            img[y + 3, x + 7] = float("inf")
            img[y + 3, x + 9] = float("-inf")
    return img


def median_paths(torch, img) -> str:
    """Which of median5's paths (csrc/refine.cu) the map takes: a lane's
    2 x 4 outputs run the fast network where its 6 x 8 window union lies
    in frame and holds no NaN and no -0.0, else the plain one; by 32 x 8
    tile (a warp's) and by output."""
    import torch.nn.functional as F

    h, w = img.shape
    ny, nx = -(-h // 8), -(-w // 32)
    bad = (img.isnan() | ((img == 0) & img.signbit())).float()[None, None]
    bad = F.pad(bad, (2, nx * 32 + 2 - w, 2, ny * 8 + 2 - h))
    lane_bad = F.max_pool2d(bad, (6, 8), (2, 4))[0, 0] > 0
    ys = torch.arange(0, ny * 8, 2, device=img.device)[:, None]
    xs = torch.arange(0, nx * 32, 4, device=img.device)[None, :]
    real = (ys < h) & (xs < w)
    frame = (xs >= 2) & (xs + 5 < w) & (ys >= 2) & (ys + 3 < h)
    fast = frame & ~lane_bad
    per = lambda m: m.reshape(ny, 4, nx, 8).sum((1, 3))  # noqa: E731
    n_fast, n_real = per(fast), per(real)
    all_fast = int((n_fast == n_real).sum())
    none = int((n_fast == 0).sum())
    return (f"{all_fast} of {ny * nx} tiles all on the fast network, "
            f"{ny * nx - all_fast - none} mixed, {none} all plain; "
            f"{int((frame & lane_bad).sum())} lanes in frame plain for a NaN "
            f"or -0.0; {8 * int(fast.sum()) / (h * w):.4f} of the outputs "
            f"fast")


def exact_row(torch, what, kernel, plain, nbytes, ops=0.0, graph=True,
              reps=20) -> dict:
    """A kernel against its plain version on the same inputs, bit for bit
    (``.view(torch.int32)``: NaN payloads and signed zeros included);
    kernel ms in a CUDA graph (for a kernel of microseconds, less than its
    wrapper's host time; unless ``graph`` is false) and by events around
    ``reps`` eager calls, plain ms; the bound from ``nbytes`` and ``ops``
    f32 instructions at the instruction rate."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check(got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                  want.view(torch.int32)),
          f"{what}: not bit-identical to its plain version")
    del got, want
    events = cuda_ms(torch, kernel, reps)
    row = dict(err=0.0, ms=graph_ms(torch, kernel, reps) if graph else events,
               events_ms=events, plain_ms=cuda_ms(torch, plain, 2 if graph
                                                  else 1),
               bound=bound_ms(nbytes, ops, F32_INSTR))
    how = (f"{row['ms']:.4f} ms a call in a CUDA graph, " if graph else "")
    print(f"  {what}: bit-identical to the plain version; kernel {how}"
          f"{events:.4f} ms by events around eager calls, plain "
          f"{row['plain_ms']:.3f} ms, bound {row['bound'][0]:.5f} ms "
          f"({row['bound'][1]})")
    return row


def refine_rows(torch, seen, where) -> dict:
    """Rows for the refinement kernels on the inputs ``capture_refine``
    saw: each stage present, and the subpixel kernel also on its volume
    stored as bf16 and f16 and relaid as the generic lane's (D, H, W)
    (threshold 1e-5); the occlusion fill also on rows with no match
    (``no_match_rows``), the median also on an adversarial map
    (``adversarial_median``), with the share of its tiles on each path.
    Bounds: the maps read and written (4 bytes a pixel each; three
    samples of the volume a pixel for the parabola); the mismatch fill
    three instructions a probe (address, load, compare) of this map's
    walk; the median the fast network's min/max a pixel (73.5, the fewest
    the kernel's networks need; the plain network's 226 are printed
    beside it)."""
    from mccnn_tpu_torch.ops import median_net, post

    rows = {}
    if "interpolate_occlusion" in seen:
        (d0, lab), _ = seen["interpolate_occlusion"]
        h, w = d0.shape
        for name, lb in (("occlusion_fill", lab),
                         ("occlusion_fill (no match)", no_match_rows(lab))):
            rows[name] = exact_row(
                torch, f"{name} {where}",
                lambda lb=lb: post.interpolate_occlusion(d0, lb),
                lambda lb=lb: post.interpolate_occlusion_plain(d0, lb),
                12 * h * w)
    if "interpolate_mismatch" in seen:
        (d0, lab), _ = seen["interpolate_mismatch"]
        h, w = d0.shape
        for key, lb in mismatch_maps(lab).items():
            name = "mismatch_fill" + ("" if key == "path" else f" ({key})")
            n = ray_probes(torch, lb)
            share = float((lb == 2).float().mean())
            rows[name] = exact_row(
                torch, f"{name} {where} ({share:.4f} of pixels MISMATCH, "
                f"{n} probes)",
                lambda lb=lb: post.interpolate_mismatch(d0, lb),
                lambda lb=lb: post.interpolate_mismatch_plain(d0, lb),
                12 * h * w, 3.0 * n)
    if "subpixel_enhancement_hwd" in seen:
        (d0, vol, dd), kw = seen["subpixel_enhancement_hwd"]
        h, w = d0.shape
        dhw = vol[:, :w, :dd].flip(1).permute(2, 0, 1).contiguous()
        for name, v in (("subpixel", vol),
                        ("subpixel (bf16 storage)", vol.to(torch.bfloat16)),
                        ("subpixel (f16 storage)", vol.to(torch.float16))):
            rows[name] = exact_row(
                torch, f"{name} {where}, x-reversed {tuple(v.shape)}",
                lambda v=v: post.subpixel_enhancement_hwd(d0, v, dd, **kw),
                lambda v=v: post.subpixel_enhancement_hwd_plain(d0, v, dd,
                                                                **kw),
                (8 + 3 * v.element_size()) * h * w)
            del v
        rows["subpixel (generic (D, H, W))"] = exact_row(
            torch, f"subpixel {where}, (D, H, W) {tuple(dhw.shape)}",
            lambda: post.subpixel_enhancement(d0, dhw, dd),
            lambda: post.subpixel_enhancement_plain(d0, dhw, dd), 20 * h * w)
        del dhw, vol
    if "median2d" in seen:
        (img, k), _ = seen["median2d"]
        h, w = img.shape
        fast_ops = (len(median_net.program()[0])
                    / (median_net.R * median_net.C))
        print(f"  median5 bound: bytes floor "
              f"{bound_ms(8 * h * w, 0)[0]:.5f} ms; the fast network's "
              f"{fast_ops} min/max a pixel "
              f"{bound_ms(0, fast_ops * h * w, F32_INSTR)[0]:.5f} ms (the "
              f"row's bound is the larger); the plain network's 226 "
              f"{bound_ms(0, 226.0 * h * w, F32_INSTR)[0]:.5f} ms")
        for name, m in (("median5", img),
                        ("median5 (adversarial)",
                         adversarial_median(torch, img))):
            print(f"  {name} {where}: {median_paths(torch, m)}")
            rows[name] = exact_row(
                torch, f"{name} {where}", lambda m=m: post.median2d(m, k),
                lambda m=m: post.median2d_plain(m, k), 8 * h * w,
                fast_ops * h * w)
    torch.cuda.empty_cache()
    return rows


def cbca_adds(torch, x0c, x1c, d, direction, L1) -> int:
    """The adds one CBCA iteration needs on these arms (csrc/cross.cu's
    intervals): for each cell whose x + d * direction lies in frame, its
    row sum's columns and its column sum's rows. The data-dependent work
    of the kernel's bound."""
    _, h, w = x0c.shape
    r = max(2, int(L1)) - 1
    xs = torch.arange(w, device=x0c.device)
    ys = torch.arange(h, device=x0c.device)[:, None]
    a0 = x0c.long()
    n = torch.zeros((), dtype=torch.int64, device=x0c.device)
    for dd in range(d):
        delta = dd * direction
        a1 = x1c[:, :, (xs + delta).clamp(0, w - 1)].long()
        lo = torch.maximum(torch.maximum(a0[0], a1[0] - delta) + 1,
                           xs - r).clamp(min=0)
        hi = torch.minimum(torch.minimum(a0[1], a1[1] - delta) - 1,
                           xs + r).clamp(max=w - 1)
        cols = (hi - lo + 1).clamp(min=0)
        lo = torch.maximum(torch.maximum(a0[2], a1[2]) + 1,
                           ys - r).clamp(min=0)
        hi = torch.minimum(torch.minimum(a0[3], a1[3]) - 1,
                           ys + r).clamp(max=h - 1)
        rows = (hi - lo + 1).clamp(min=0)
        valid = (xs + delta >= 0) & (xs + delta < w)
        n += ((cols + rows) * valid).sum()
    return int(n)


def cbca_rows(torch, seen, where) -> dict:
    """Rows for the CBCA kernel on the inputs ``capture_cbca`` saw, one a
    direction, keyed "cbca (direction -1)" and "(+1)": each bit for bit
    against its plain version, timed by events (milliseconds a call).
    Bound: the volume read and written and both arm stacks read, or its
    adds (``cbca_adds``) at the instruction rate."""
    from mccnn_tpu_torch.ops import cross

    rows = {}
    for key in sorted(k for k in seen if k[0] == "cbca"):
        (x0c, x1c, vol, direction, L1), _ = seen[key]
        d, h, w = vol.shape
        rows[f"cbca (direction {direction:+d})"] = exact_row(
            torch, f"cbca {where}, direction {direction:+d}, K = "
            f"{max(2, L1)}, {float(vol.isnan().float().mean()):.4f} of cells "
            f"NaN", lambda: cross.cbca(x0c, x1c, vol, direction, L1),
            lambda: cross.cbca_plain(x0c, x1c, vol, direction, L1),
            4 * (2 * d * h * w + 8 * h * w),
            float(cbca_adds(torch, x0c, x1c, d, direction, L1)),
            graph=False, reps=5)
    torch.cuda.empty_cache()
    return rows


def nan_image(torch, img):
    """``img`` with NaN at a seeded 2% of its pixels and in one block of
    9 x 40 (a NaN centre or probe never breaks an arm: the block's arms
    run to K or the frame)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    out = img.clone()
    out[(torch.rand(img.shape, generator=g) < 0.02).to(img.device)] = \
        float("nan")
    out[100:109, 300:340] = float("nan")
    return out


def arms_rows(torch, img, where, ks=(0, 3, 5, 14), nan=False) -> dict:
    """Rows for the arms kernel on ``img`` at each L1 in ``ks`` (K = 2,
    3, 5, 14: census, ad, slow, mb slow) with that config's tau1, keyed
    "cross_arms (K = k)", and with ``nan`` at K = 5 on ``nan_image`` of
    it, keyed "cross_arms (K = 5, NaN)": bit for bit against its plain
    version, timed in a CUDA graph. Bound: the image read and four
    planes written."""
    from mccnn_tpu_torch.ops import cross

    tau1 = {0: 0.01, 3: 0.03, 5: 0.13, 14: 0.02}
    h, w = img.shape
    cases = [(f"cross_arms (K = {max(2, L1)})", img, L1, "") for L1 in ks]
    if nan:
        cases.append(("cross_arms (K = 5, NaN)", nan_image(torch, img), 5,
                      ", NaN pixels"))
    return {key: exact_row(
                torch, f"cross_arms {where}{what}, K = {max(2, L1)}, tau1 "
                f"{tau1[L1]}", lambda m=m, L1=L1: cross.cross_arms(m, L1,
                                                                   tau1[L1]),
                lambda m=m, L1=L1: cross.cross_arms_plain(m, L1, tau1[L1]),
                20 * h * w)
            for key, m, L1, what in cases}


def matching_head(net, feats):
    """Set the slow net's head by hand so that it scores the L1 distance
    of the two descriptors: layer 0 maps to [fl - fr, fr - fl] on its
    first 2*fm units (ReLU keeps the positive parts, which sum to
    |fl - fr|), the mid layers are the identity, and the last layer
    weighs those units by c > 0: s = sigmoid(c * |fl - fr|_1 - 2), with
    c = 2 / (the mean L1 distance of unmatched descriptors, taken on
    ``feats`` (2, fm, H, W) of the pair at zero shift)."""
    import torch

    fm = feats.shape[1]
    mean_l1 = float((feats[0] - feats[1]).abs().sum(0).mean())
    head = net.head
    with torch.no_grad():
        eye = torch.eye(fm, device=feats.device)
        w0 = torch.zeros_like(head[0].weight)  # (nh2, 2 fm)
        w0[:fm, :fm], w0[:fm, fm:] = eye, -eye
        w0[fm:2 * fm, :fm], w0[fm:2 * fm, fm:] = -eye, eye
        head[0].weight.copy_(w0)
        for lin in list(head)[1:-1]:
            lin.weight.copy_(torch.eye(lin.weight.shape[0], device=feats.device))
        for lin in head:
            lin.bias.zero_()
        head[-1].weight.zero_()
        head[-1].weight[0, :2 * fm] = 2.0 / mean_l1
        head[-1].bias.fill_(-2.0)
    return net


def head_library(torch, slow_head, A, B, mids_w, mids_b, w_last, b_last, D):
    """The head chain as PyTorch's own bf16 matmuls (cuBLAS) per chunk
    of disparities: the yardstick of the head kernel (the port never
    calls it)."""
    H, W, C = A.shape
    bb = mids_b.to(torch.bfloat16)
    out = torch.empty((D, H, W), dtype=torch.float32, device=A.device)
    step = 4
    for d0 in range(0, D, step):
        ds = torch.arange(d0, min(D, d0 + step), device=A.device)
        h = torch.relu(A[None] + slow_head.shifted(B, ds)).to(torch.bfloat16)
        for m in range(mids_w.shape[0]):
            h = torch.relu(h @ mids_w[m] + bb[m])
        out[d0:d0 + len(ds)] = torch.sigmoid(h.float() @ w_last + b_last)
    return out


def only_warp(_build, n: int) -> dict:
    """The launch counts of training: ``warp_patches`` ``n`` times, no
    other hand kernel."""
    return dict(dict.fromkeys(_build.KERNELS, 0), warp_patches=n)


@contextlib.contextmanager
def chunk_runs(torch, trainer, secs: list, eager: bool = False):
    """Within the block, each chunk that ``train()`` runs on the card is
    timed to the card's finish into ``secs``; with ``eager`` the chunk
    runs as eager ``train_chunk`` steps (the graph's plain version, as
    before the graph) instead of a replay."""
    orig = trainer.make_train_chunk

    def make(cfg, net, momentum, Xpad, n_steps, device):
        if eager:
            def run(chunk, lr):
                return trainer.train_chunk(
                    cfg, net, momentum, lr,
                    {k: torch.from_numpy(v).to(device)
                     for k, v in chunk.items()}, Xpad)
        else:
            run = orig(cfg, net, momentum, Xpad, n_steps, device)

        def timed(chunk, lr):
            t = time.perf_counter()
            errs = run(chunk, lr)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            return errs
        return timed

    trainer.make_train_chunk = make
    try:
        yield
    finally:
        trainer.make_train_chunk = orig


# f32 instructions of one warp output (csrc/warp.cu): the two source
# coordinates 8, floors and fractions 4, each axis's four cubic weights
# 25, the 16 taps 48, the photometrics 2 (the bound's operations)
WARP_OPS = 110


def warp_taps(torch, minv, ws: int, win: int) -> int:
    """The distinct window values the warp reads for these affines: each
    output's in-window taps, as the kernel computes them, counted once a
    patch (the bound's bytes)."""
    r = torch.arange(ws, device=minv.device, dtype=torch.float32)
    fi, fj = r[:, None], r[None, :]
    m = minv[:, :, None, None]
    sx = (m[:, 0] * fj + m[:, 1] * fi) + m[:, 2]
    sy = (m[:, 3] * fj + m[:, 4] * fi) + m[:, 5]
    x0 = torch.floor(sx).long()[..., None] + torch.arange(-1, 3,
                                                          device=minv.device)
    y0 = torch.floor(sy).long()[..., None] + torch.arange(-1, 3,
                                                          device=minv.device)
    yy = y0[..., :, None].expand(*y0.shape, 4)
    xx = x0[..., None, :].expand(*x0.shape[:-1], 4, 4)
    ok = (yy >= 0) & (yy < win) & (xx >= 0) & (xx < win)
    b = torch.arange(minv.shape[0], device=minv.device)[:, None, None, None,
                                                         None]
    idx = (b * win + yy) * win + xx
    return int(torch.unique(idx[ok]).numel())


def warp_rows(torch, cfg, ds, X0, X1, dev) -> dict:
    """Phase 8's check of ``warp_patches`` at full width: one step's 4·bs/2
    patches of ``cfg``'s sampler on the synthetic set, from the padded
    stack (the fused gather, KITTI's mode) and from the gathered windows
    (Middlebury's and the data-parallel step's mode), bit for bit
    (``.view(torch.int32)``) against the plain versions on the path's
    own inputs and with NaN of two payloads, -0.0 and +-inf planted in
    the stack (one at each of a quarter of the windows' centres) and in
    the windows; the gather mode's row timed in a CUDA graph beside the
    plain version (by events around eager calls, and in a CUDA graph),
    its bound and ``F.grid_sample``'s bicubic sampling of the same
    windows (``library_ms``; zero padding, no photometrics)."""
    from mccnn_tpu_torch.train import augment, trainer

    win, ws = augment.WIN, cfg.ws
    bs_half = cfg.bs // 2
    c = trainer.stack_chunk(
        augment.AugmentSampler(cfg, np.random.RandomState(4)), ds,
        ds.nnz_tr[:bs_half], 1, bs_half, X0, X1, device_gather=True)
    src, oy, ox, minv, bri, con = (torch.as_tensor(c[k][0], device=dev)
                                   for k in ("src", "oy", "ox", "minv",
                                             "brightness", "contrast"))
    B = minv.shape[0]
    Xpad = augment.pad_image_stack(X0, X1, dev)
    windows = augment.gather_windows_device(Xpad, src, oy, ox).contiguous()
    planted = plant(torch, Xpad)
    sel = torch.arange(0, B, 4, device=dev)
    for k, v in enumerate((float("nan"), float("inf"), -0.0, -float("inf"))):
        s = sel[sel + k < B] + k
        planted[src[s].long(), (oy[s] + win + win // 2).long(),
                (ox[s] + win + win // 2).long()] = v
    pwin = augment.gather_windows_device(planted, src, oy, ox).contiguous()
    photo = (minv, bri, con)
    for what, xp, w in (("the path's inputs", Xpad, windows),
                        ("NaN, -0.0, +-inf planted", planted, pwin)):
        got = (augment.gather_warp(xp, src, oy, ox, *photo, ws=ws),
               augment.warp_patches(w, *photo, ws=ws))
        want = (augment.gather_warp_plain(xp, src, oy, ox, *photo, ws=ws),
                augment.warp_patches_plain(w, *photo, ws=ws))
        torch.cuda.synchronize()
        check(bits_equal(torch, got, want), f"warp_patches on {what}: not "
              "bit-identical to its plain versions")
        nan = bool(got[0].isnan().any())
        check(nan == (xp is planted), f"warp_patches on {what}: NaN {nan}")
    taps = warp_taps(torch, minv, ws, win)
    out = B * ws * ws
    print(f"phase 8: warp_patches at kitti {cfg.arch}'s full width ({B} "
          f"patches of {ws}x{ws}, {taps} distinct window values read): both "
          f"modes bit-identical to their plain versions on the path's "
          f"inputs and with NaN, -0.0, +-inf planted")
    row = exact_row(
        torch, "warp_patches (the fused gather, the path's mode)",
        lambda: augment.gather_warp(Xpad, src, oy, ox, *photo, ws=ws),
        lambda: augment.gather_warp_plain(Xpad, src, oy, ox, *photo, ws=ws),
        taps * 4 + B * 11 * 4 + out * 4, out * WARP_OPS)
    exact_row(torch, "warp_patches (from windows)",
              lambda: augment.warp_patches(windows, *photo, ws=ws),
              lambda: augment.warp_patches_plain(windows, *photo, ws=ws),
              taps * 4 + B * 8 * 4 + out * 4, out * WARP_OPS)
    row["plain_graph_ms"] = graph_ms(
        torch, lambda: augment.gather_warp_plain(Xpad, src, oy, ox, *photo,
                                                 ws=ws), 5)
    r = torch.arange(ws, device=dev, dtype=torch.float32)
    m = minv[:, :, None, None]
    sx = (m[:, 0] * r[None, :] + m[:, 1] * r[:, None]) + m[:, 2]
    sy = (m[:, 3] * r[None, :] + m[:, 4] * r[:, None]) + m[:, 5]
    grid = torch.stack([sx, sy], -1) * (2.0 / (win - 1)) - 1.0
    wnd = windows[:, None]

    def library():
        return torch.nn.functional.grid_sample(
            wnd, grid, mode="bicubic", padding_mode="zeros",
            align_corners=True)

    row["library_ms"] = graph_ms(torch, library, 20)
    lib = library()[:, 0] * con[:, None, None] + bri[:, None, None]
    gap = float((lib - augment.warp_patches(windows, *photo, ws=ws)).abs()
                .max())
    print(f"  warp_patches: plain version {row['plain_graph_ms']:.4f} ms in "
          f"a CUDA graph; F.grid_sample (bicubic, zero padding) "
          f"{row['library_ms']:.4f} ms in a CUDA graph, its patches with "
          f"the photometrics within {gap:.2e} of the kernel's")
    return row


def graph_vs_eager(torch, cfgs, ds, X0, X1, dev) -> None:
    """Phase 8's bit-identity of the chunk's CUDA graph at full width:
    kitti fast and slow in float32 and with ``-dtype bfloat16``, from the
    same seeded weights, ``make_train_chunk``'s replays against eager
    ``train_chunk`` calls under ``cudnn.deterministic``: a chunk of 32, a
    second at the lr dropped by 10 (the 0-d tensor's ``fill_``, no new
    capture), a tail of 5 on its own graph; losses, weights and momentum
    after each, ``.view(torch.int32)``."""
    import dataclasses

    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.train import augment, trainer

    Xpad = augment.pad_image_stack(X0, X1, dev)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for arch in ("fast", "slow"):
            for dtype in ("float32", "bfloat16"):
                cfg = dataclasses.replace(cfgs[arch], dtype=dtype)
                bs_half = cfg.bs // 2

                def chunk(n, seed):
                    rows = ds.nnz_tr[seed * 1000:][:n * bs_half]
                    return trainer.stack_chunk(
                        augment.AugmentSampler(cfg,
                                               np.random.RandomState(seed)),
                        ds, rows, n, bs_half, X0, X1, device_gather=True)

                plan = [(chunk(32, 5), cfg.lr), (chunk(32, 6), cfg.lr / 10),
                        (chunk(5, 7), cfg.lr / 10)]
                states = []
                t = time.perf_counter()
                for graph in (True, False):
                    net = towers.init_net(cfg).to(dev)
                    mom = [torch.zeros_like(p) for p in net.parameters()]
                    graphs, seen = {}, []
                    for c, lr in plan:
                        n = c["minv"].shape[0]
                        if not graph:
                            errs = trainer.train_chunk(
                                cfg, net, mom, lr,
                                {k: torch.from_numpy(v).to(dev)
                                 for k, v in c.items()}, Xpad)
                        else:
                            if n not in graphs:
                                graphs[n] = trainer.make_train_chunk(
                                    cfg, net, mom, Xpad, n, dev)
                            errs = graphs[n](c, lr)
                        seen.append((errs.clone(),) + tuple(
                            x.detach().clone()
                            for x in list(net.parameters()) + mom))
                    states.append(seen)
                    del net, mom, graphs
                torch.cuda.synchronize()
                same = [bits_equal(torch, g, e) for g, e in zip(*states)]
                losses = torch.cat([s[0] for s in states[0]])
                print(f"phase 8: kitti {arch} -dtype {dtype}, the chunk's CUDA "
                      f"graph against eager steps (cuDNN deterministic): "
                      f"losses, weights and momentum after 32 steps, 32 at "
                      f"lr/10 and a tail of 5 bit-identical: {same}; losses "
                      f"{float(losses[0]):.6f} -> {float(losses[-1]):.6f} "
                      f"({time.perf_counter() - t:.1f} s)")
                check(all(same), f"kitti {arch} {dtype}: the graph's chunk "
                      "differs from the eager one")
                check(bool(torch.isfinite(losses).all()),
                      f"kitti {arch} {dtype}: losses not finite")
    finally:
        torch.backends.cudnn.deterministic = det


def train_rates(torch, cfg, tds, dev, eager: bool, n_epochs: int) -> dict:
    """``train()`` over ``n_epochs`` of ``tds`` on the card from the seeded
    net, the chunk as a graph replay or (``eager``) as eager steps: the
    end-to-end steps/s of epochs 2 on, by epoch, each chunk's steps/s to
    the card's finish, the host's share outside the chunk calls, a chunk
    build's ms on the thread, the peak memory, the launch counts (the
    wrappers' and the warp kernel's own counter on the card, ``ran``)."""
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.ops import _build, warp
    from mccnn_tpu_torch.train import trainer

    secs, builds, lines = [], [], []
    orig_stack = trainer.stack_chunk

    def timed_stack(*a, **kw):
        t = time.perf_counter()
        out = orig_stack(*a, **kw)
        builds.append(time.perf_counter() - t)
        return out

    net = towers.init_net(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    _build.reset_launches()
    ran = warp.runs(dev)
    trainer.stack_chunk = timed_stack
    try:
        with chunk_runs(torch, trainer, secs, eager):
            net, mom = trainer.train(cfg, tds, net, epochs=n_epochs,
                                     log=lines.append, device=dev)
    finally:
        trainer.stack_chunk = orig_stack
    torch.cuda.synchronize()
    got = _build.launches()
    ran = warp.runs(dev) - ran
    epochs = [ln.split("\t") for ln in lines if "\t" in ln]
    clock = [float(e[3]) for e in epochs]
    span = clock[-1] - clock[0]
    per = len(secs) // n_epochs
    n_steps = per * trainer.CHUNK_STEPS
    card = sum(secs[per:])
    return dict(
        launches=got, ran=ran, secs=secs, lines=lines, trained=(net, mom),
        warned=any("WARNING" in ln for ln in lines),
        errs=[float(e[1]) for e in epochs],
        e2e=(n_epochs - 1) * n_steps / span,
        by_epoch=[n_steps / (b - a) for a, b in zip(clock, clock[1:])],
        rates=[trainer.CHUNK_STEPS / t for t in secs[1:]],
        host=(span - card) / span,
        build_ms=1e3 * statistics.mean(builds[per:]),
        peak=peak_line(torch, held))


# the host's calls that hand the card work, as the profiler names them
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


def profile_chunk(torch, what, run, per: int) -> None:
    """One chunk of ``per`` steps, ``run()``, under ``torch.profiler``: the
    kernels the card ran (a graph's nodes too) and their device time, the
    host's launch calls, both a step; the busy share is that device time
    over the chunk's wall without the profiler (median of 3). Fails unless
    the profiler saw device time in at least a kernel a step, and unless
    the warp kernel's own counter on the card (``ops/warp.py`` ``runs``)
    rose by exactly ``per`` in the profiled chunk: the measurement behind
    the wrappers' count of a replay. The profiler's ``warp_kernel`` records
    are printed beside it and may be fewer, never more: a profile of a
    replay can lose records (31 of 32 and 2750 of 2763 kernels in each of
    three profiles of one kitti fast chunk)."""
    from mccnn_tpu_torch.ops import warp

    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = statistics.median(walls)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = warp.runs(torch.cuda.current_device())
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t) * 1e3
    ran = warp.runs(torch.cuda.current_device()) - before
    events = prof.key_averages()
    kernels = [e for e in events
               if "CUDA" in str(getattr(e, "device_type", ""))]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    dev_ms = sum(dev_us(e) for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    n_warp = sum(e.count for e in kernels if "warp_kernel" in e.key)
    check(dev_ms > 0 and n_kernels >= per, f"{what}: the profiler saw "
          f"{n_kernels} kernels and {dev_ms} ms of device time in a chunk of "
          f"{per} steps")
    check(ran == per and n_warp <= ran, f"{what}: the warp kernel ran {ran} "
          f"times by its counter ({n_warp} by the profiler) in a chunk of "
          f"{per} steps")
    calls = {e.key: e.count for e in events if e.key in HOST_LAUNCHES}
    top = ", ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.2f} ms x{e.count}"
                    for e in sorted(kernels, key=dev_us, reverse=True)[:4])
    print(f"  {what}, one chunk of {per} steps: wall {wall:.1f} ms (median "
          f"of 3; {wall_p:.1f} ms under the profiler), device {dev_ms:.1f} "
          f"ms in {n_kernels} kernels ({n_kernels / per:.1f} a step, "
          f"{dev_ms / per:.3f} ms a step), warp_kernel runs {ran} by its "
          f"counter, {n_warp} by the profiler; busy {dev_ms / wall:.3f}; host "
          f"launch calls {sum(calls.values())} ({sum(calls.values()) / per:.2f}"
          f" a step: {calls}); top: {top}")


def training_phase(torch, dev, fast_want: dict, shape=(350, 1242, 228),
                   steps=(8, 4)) -> None:
    """Phase 8: the training path on the card (see the module docstring).
    ``shape``: the synthetic KITTI frame (height, width, D); ``steps``:
    the card-against-CPU steps of kitti fast and kitti slow."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile

    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.data import datasets
    from mccnn_tpu_torch.models import checkpoint, towers
    from mccnn_tpu_torch.ops import _build
    from mccnn_tpu_torch.train import augment, evaluate, trainer

    t8 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase8_", dir=os.path.join(ROOT, "build"))
    try:
        h, w, d = shape
        datasets.make_synthetic_kitti(os.path.join(tmp, "data.kitti"),
                                      n_images=3, height=h, width=w,
                                      disp_max=d)
        cfgs = {arch: make_config("kitti", arch, a="train_tr", data_dir=tmp)
                for arch in ("fast", "slow")}
        ds = datasets.load_kitti(cfgs["fast"])
        ds.disp_max = d
        X0 = np.asarray(ds.X0[:, 0])[:, None]
        X1 = np.asarray(ds.X1[:, 0])[:, None]
        print(f"phase 8: synthetic KITTI at {h}x{w}, D={d}: images 1-2 "
              f"train ({len(ds.nnz_tr)} rows), image 3 is te; written in "
              f"{time.perf_counter() - t8:.1f} s")

        def on(where, chunk):
            return {k: torch.as_tensor(v, device=where)
                    for k, v in chunk.items()}

        # card against CPU at full width: one sampled chunk, the same
        # seeded weights; TF32 off on the card
        for arch, n in zip(("fast", "slow"), steps):
            cfg = cfgs[arch]
            bs_half = cfg.bs // 2
            chunk = trainer.stack_chunk(
                augment.AugmentSampler(cfg, np.random.RandomState(1)), ds,
                ds.nnz_tr[:n * bs_half], n, bs_half, X0, X1,
                device_gather=True)
            runs = {}
            for where in (torch.device("cpu"), dev):
                net = towers.init_net(cfg).to(where)
                mom = [torch.zeros_like(p) for p in net.parameters()]
                _build.reset_launches()
                t = time.perf_counter()
                errs = trainer.train_chunk(cfg, net, mom, cfg.lr,
                                           on(where, chunk),
                                           augment.pad_image_stack(X0, X1,
                                                                   where))
                errs = errs.cpu()
                runs[where.type] = (errs, [p.detach().cpu()
                                           for p in net.parameters()],
                                    time.perf_counter() - t, _build.launches())
            (e_c, p_c, s_c, _), (e_k, p_k, s_k, k_k) = runs["cpu"], runs[dev.type]
            rel = ((e_k - e_c).abs() / e_c.abs().clamp_min(1e-6))
            w_gap = max(float((a - b).abs().max()) for a, b in zip(p_k, p_c))
            print(f"phase 8: kitti {arch} (l1={cfg.l1}, fm={cfg.fm}, "
                  f"bs={cfg.bs}), {n} steps, card against CPU: losses "
                  f"{[round(float(v), 6) for v in e_k]}, largest relative "
                  f"gap {float(rel.max()):.2e} (step 1: {float(rel[0]):.2e}), "
                  f"weights {w_gap:.2e} (card {s_k:.2f} s, CPU {s_c:.2f} s)")
            check(bool(torch.isfinite(e_k).all()), f"{arch}: loss not finite")
            check(float(rel[0]) <= 1e-5 and float(rel.max()) <= 1e-4,
                  f"{arch}: card losses {e_k.tolist()} against CPU "
                  f"{e_c.tolist()}")
            check(w_gap <= 1e-5, f"{arch}: weights {w_gap} from the CPU's")
            check(k_k == only_warp(_build, n), f"{arch}: the eager chunk "
                  f"launched hand kernels {k_k}, expected warp_patches {n}")

        # the warp kernel at full width, then the graph against the eager
        # chunk bit for bit
        warp_row = warp_rows(torch, cfgs["fast"], ds, X0, X1, dev)
        graph_vs_eager(torch, cfgs, ds, X0, X1, dev)

        # throughput: train() on a table of 8 chunks (256 steps) an epoch,
        # 4 epochs, with the chunk as a CUDA graph and as eager steps (the
        # graph's plain version) in turns in this call: the host's launch
        # rate varies between calls. The headline is the end-to-end rate
        # of epochs 2-4 on the epoch lines' own clock (the chunk builds
        # the card waits for, the copies and the loss readbacks included).
        # Each chunk's call is also timed to the card's finish, and each
        # chunk build on the thread, so the host's share is measured.
        trained, warp_launches = {}, 0
        n_chunks, n_epochs = 8, 4
        for arch in ("fast", "slow"):
            cfg = cfgs[arch]
            bs_half = cfg.bs // 2
            tds = dataclasses.replace(
                ds, nnz_tr=ds.nnz_tr[:n_chunks * trainer.CHUNK_STEPS
                                     * bs_half + 1])
            n_steps = trainer.n_epoch_steps(len(tds.nnz_tr), bs_half)
            check(n_steps == n_chunks * trainer.CHUNK_STEPS,
                  f"{n_steps} steps")
            rates = {}
            for how in ("graph", "eager", "graph"):
                got = train_rates(torch, cfg, tds, dev, how == "eager",
                                  n_epochs)
                rates.setdefault(how, []).append(got)
                # a graph's warm-up step launches the kernel once more
                want = only_warp(_build, n_epochs * n_steps
                                 + (1 if how == "graph" else 0))
                check(got["launches"] == want, f"{arch} ({how}): train() "
                      f"launched {got['launches']}, expected {want}")
                check(got["ran"] == want["warp_patches"], f"{arch} ({how}): "
                      f"the warp kernel ran {got['ran']} times by its counter "
                      f"on the card, its wrappers counted "
                      f"{want['warp_patches']}")
                check(len(got["secs"]) == n_chunks * n_epochs,
                      f"{arch}: {len(got['secs'])} chunks")
                check(all(np.isfinite(got["errs"])) and not got["warned"],
                      f"{arch} ({how}): epoch lines {got['lines']}")
                kind = ("one CUDA graph replay" if how == "graph"
                        else "eager steps")
                print(f"phase 8: kitti {arch} train(), the chunk as {kind}: "
                      f"epochs 2-{n_epochs} end to end {got['e2e']:.1f} "
                      f"steps/s ({got['e2e'] * cfg.bs:.0f} patch pairs/s, "
                      f"{cfg.bs} (L, R) pairs a step; by epoch "
                      f"{[round(r, 1) for r in got['by_epoch']]}); chunks of "
                      f"{trainer.CHUNK_STEPS} from call to the card's finish "
                      f"{statistics.median(got['rates']):.1f} steps/s (median "
                      f"of {len(got['rates'])} after a warm-up chunk, "
                      f"{min(got['rates']):.1f}-{max(got['rates']):.1f}); "
                      f"host share of epochs 2-{n_epochs} outside the chunk "
                      f"calls {got['host']:.3f}, a chunk build on the thread "
                      f"{got['build_ms']:.1f} ms; mean loss by epoch "
                      f"{[round(v, 5) for v in got['errs']]}; {got['peak']}")
                trained.setdefault(arch, got["trained"])
                if arch == "fast" and how == "graph":
                    # the kernels line's count: the main path's first run
                    warp_launches = warp_launches or got["launches"][
                        "warp_patches"]
            g = [r["e2e"] for r in rates["graph"]]
            e = rates["eager"][0]["e2e"]
            gap = max(abs(a - b) / abs(b) for r in rates["graph"]
                      for a, b in zip(r["errs"], rates["eager"][0]["errs"]))
            print(f"  kitti {arch}: graph {[round(r, 1) for r in g]} against "
                  f"eager {e:.1f} steps/s end to end ({min(g) / e:.2f}-"
                  f"{max(g) / e:.2f}x); mean losses by epoch within "
                  f"{gap:.2e} relative of the eager run's (cuDNN's default "
                  f"algorithms, not deterministic)")

            # where a step's time goes: one chunk under the profiler, as a
            # graph replay and as eager steps, each from the host chunk
            host = trainer.stack_chunk(
                augment.AugmentSampler(cfg, np.random.RandomState(2)), ds,
                ds.nnz_tr[:trainer.CHUNK_STEPS * bs_half],
                trainer.CHUNK_STEPS, bs_half, X0, X1, device_gather=True)
            Xpad = augment.pad_image_stack(X0, X1, dev)
            pnet = towers.init_net(cfg).to(dev)
            pmom = [torch.zeros_like(p) for p in pnet.parameters()]
            replay = trainer.make_train_chunk(cfg, pnet, pmom, Xpad,
                                              trainer.CHUNK_STEPS, dev)
            for how, run in (
                    ("graph", lambda: replay(host, cfg.lr)),
                    ("eager", lambda: trainer.train_chunk(
                        cfg, pnet, pmom, cfg.lr, on(dev, host), Xpad))):
                profile_chunk(torch, f"kitti {arch} ({how})", run,
                              trainer.CHUNK_STEPS)
            del pnet, pmom, replay, Xpad

        # the chained evaluation: test_te on image 3 through kernels 1-5
        ecfg = make_config("kitti", "fast", a="test_te", data_dir=tmp)
        scores = {}
        for what, net in (("untrained", towers.init_net(ecfg)),
                          ("trained", trained["fast"][0])):
            out = io.StringIO()
            _build.reset_launches()
            with contextlib.redirect_stdout(out):
                evaluate.action_eval(ecfg, [], net=net, ds=ds, device=dev)
            torch.cuda.synchronize()
            got = _build.launches()
            check(got == fast_want, f"test_te ({what}): launch counts {got}, "
                  f"expected {fast_want}")
            tokens = out.getvalue().split()
            scores[what] = float(tokens[-1])
            check(0.0 <= scores[what] <= 1.0, f"test_te ({what}): error "
                  f"{tokens}")
            print(f"phase 8: test_te (kitti fast, image 3, {h}x{w}, D={d}), "
                  f"{what} net: bad-3 error {scores[what]:.4f} in "
                  f"{float(tokens[0]):.3f} s; launches {got}")

        # checkpoint round trip of each trained net, then two more steps
        # from each copy. Each example's positive and negative patches
        # (slots 1 and 3) are swapped, so that the trained nets' losses,
        # and with them the gradients, are not 0: the fast net's hinge
        # is 0 on this synthetic set.
        Xpad = augment.pad_image_stack(X0, X1, dev)
        for arch, (net, mom) in trained.items():
            path = os.path.join(tmp, f"net_{arch}.npz")
            checkpoint.save(path, net, {"epoch": 3}, extra={"momentum": mom})
            net2, opt, extras = checkpoint.load(path)
            mom2 = [v.to(dev) for v in extras["momentum"]]
            net2 = net2.to(dev)
            same = all(torch.equal(a, b) for a, b in
                       zip(list(net.parameters()) + mom,
                           list(net2.parameters()) + mom2))
            check(same and opt["epoch"] == 3, f"{arch}: checkpoint round trip "
                  "changed the weights or momentum")
            cfg = cfgs[arch]
            chunk = on(dev, trainer.stack_chunk(
                augment.AugmentSampler(cfg, np.random.RandomState(3)), ds,
                ds.nnz_tr[:2 * (cfg.bs // 2)], 2, cfg.bs // 2, X0, X1,
                device_gather=True))
            n4 = chunk["minv"].shape[1]
            swap = torch.arange(n4).reshape(-1, 4)[:, [0, 3, 2, 1]].reshape(-1)
            chunk = {k: v[:, swap.to(v.device)] if v.shape[1] == n4 else v
                     for k, v in chunk.items()}
            det = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                e1 = trainer.train_chunk(cfg, net, mom, cfg.lr, chunk, Xpad)
                e2 = trainer.train_chunk(cfg, net2, mom2, cfg.lr, chunk, Xpad)
            finally:
                torch.backends.cudnn.deterministic = det
            same = torch.equal(e1, e2) and all(
                torch.equal(a, b) for a, b in zip(
                    list(net.parameters()) + mom,
                    list(net2.parameters()) + mom2))
            print(f"phase 8: kitti {arch} checkpoint ({os.path.getsize(path)} "
                  f"bytes): weights and momentum bit-equal after the round "
                  f"trip; two more steps from each copy: losses "
                  f"{[round(float(v), 6) for v in e1]} / "
                  f"{[round(float(v), 6) for v in e2]}, "
                  f"{'bit-equal' if same else 'NOT equal'} (cuDNN "
                  "deterministic)")
            check(bool((e1 > 0).all()), f"{arch}: losses {e1.tolist()} after "
                  "the reload leave the backward pass untried")
            check(same, f"{arch}: steps from the reloaded checkpoint differ")
        del Xpad, chunk

        # the Middlebury host-gather path: 8 steps of mb fast, then
        # test_te through bucketed_predict (padded to 64, disp_true lanes)
        mdir = os.path.join(tmp, "data.mb.imperfect_gray")
        datasets.make_synthetic_mb(mdir)
        mcfg = make_config("mb", "fast", a="train_tr", data_dir=tmp)
        mds = datasets.load_mb(mcfg)
        mds.nnz_tr = mds.nnz_tr[:8 * (mcfg.bs // 2) + 1]
        mruns = {}
        for where in (torch.device("cpu"), dev):
            lines = []
            mnet, _ = trainer.train(mcfg, mds, towers.init_net(mcfg),
                                    epochs=1, log=lines.append, device=where)
            mruns[where.type] = (float(lines[0].split("\t")[1]), mnet)
        (l_c, n_c), (l_k, mnet) = mruns["cpu"], mruns[dev.type]
        w_gap = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(mnet.parameters(), n_c.parameters()))
        print(f"phase 8: mb fast, 8 steps on the host gather: mean loss card "
              f"{l_k:.6f}, CPU {l_c:.6f}; weights {w_gap:.2e} apart")
        check(np.isfinite(l_k) and abs(l_k - l_c) <= 1e-4 * abs(l_c)
              and w_gap <= 1e-5, "mb fast training differs from the CPU's")
        mcfg.a = "test_te"
        out = io.StringIO()
        _build.reset_launches()
        with contextlib.redirect_stdout(out):
            evaluate.action_eval(mcfg, [], net=mnet, ds=mds, device=dev)
        torch.cuda.synchronize()
        got = _build.launches()
        want_mb = dict.fromkeys(_build.KERNELS, 0)
        want_mb.update(join=1, sgm_tables=1, sgm_vertical=2,
                       sgm_horizontal=2, blur=1,
                       **REFINE_MB, **tower_counts(mcfg))
        score = float(out.getvalue().split()[-1])
        x0, x1 = (np.array(mds.X[0][0][k, 0]) for k in (0, 1))
        dm = int(mds.metadata[0, 2])
        m_k = evaluate.bucketed_predict(mcfg, mnet, x0, x1, dm,
                                        device=dev).cpu().numpy()
        m_c = evaluate.bucketed_predict(mcfg, mnet.cpu(), x0, x1, dm,
                                        device="cpu").numpy()
        frac = float((np.abs(m_k - m_c) > 0.51).mean())
        print(f"phase 8: mb test_te ({x0.shape[0]}x{x0.shape[1]} padded to "
              f"64s, D={dm} padded to 64): bad-1 error {score:.4f}; launches "
              f"{got}; {frac:.5f} of pixels off the CPU's by > 0.51")
        check(got == want_mb, f"mb test_te: launch counts {got}, expected "
              f"{want_mb}")
        check(0.0 <= score <= 1.0 and frac < 0.01, f"mb test_te: error "
              f"{score}, {frac} of pixels off the CPU's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 8 took {time.perf_counter() - t8:.0f} s")
    return warp_row, warp_launches


# the first conv's weight[:3, 0, 0, 0] (OIHW) of the default seeded kitti
# fast net: the JAX package's init_params at seed 42
JAX_SEED42_W = (-0.1761167, 0.293127, -0.20261869)


def _kitti_raw(root: str, h: int, w: int) -> None:
    """A raw KITTI 2012 tree of the fixed counts (194 training pairs with
    ground truth, 195 testing pairs) of h x w textured gray PNGs."""
    from PIL import Image

    rng = np.random.RandomState(4)
    for split, n in (("training", 194), ("testing", 195)):
        base = os.path.join(root, "data.kitti", "unzip", split)
        for sub in ("image_0", "image_1") + (("disp_noc",)
                                             if split == "training" else ()):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for i in range(n):
            name = f"{i:06d}_10.png"
            shift = 8 + i % 8
            img = rng.randint(0, 256, (h, w + shift)).astype(np.uint8)
            Image.fromarray(img[:, shift:]).save(
                os.path.join(base, "image_0", name))
            Image.fromarray(img[:, :-shift]).save(
                os.path.join(base, "image_1", name))
            if split == "training":
                gt = np.full((h, w), shift * 256, np.uint16)
                Image.fromarray(gt).save(os.path.join(base, "disp_noc", name))


def cache_phase(torch, dev, x0, x1, fast_want: dict, slow_want: dict,
                disp_max: int = D, kitti_cut=(64, 128)) -> None:
    """Phase 9 (see the module docstring): the seeded init, ``.t7`` nets,
    the volume cache, the host gather and the preprocess script, on the
    pair ``x0, x1`` of phase 4 at ``disp_max``."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile

    from mccnn_tpu_torch import cli
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.data import datasets
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.models.import_t7 import params_to_t7
    from mccnn_tpu_torch.ops import _build, host_gather
    from mccnn_tpu_torch.pipeline import stereo_predict
    from mccnn_tpu_torch.train import augment, trainer

    t9 = time.perf_counter()
    h, w = x0.shape
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase9_", dir=os.path.join(ROOT, "build"))
    cwd = os.getcwd()
    try:
        # 1. the seeded init is the JAX package's
        fast_cfg = make_config("kitti", "fast", a="predict")
        slow_cfg = make_config("kitti", "slow", a="predict")
        fast = towers.init_net(fast_cfg)
        w0 = fast.convs[0].weight[:3, 0, 0, 0].detach().numpy()
        print(f"phase 9: kitti fast, seed {fast_cfg.seed}: first conv "
              f"weight[:3, 0, 0, 0] = {w0.tolist()} (the JAX package's "
              f"init_params: {list(JAX_SEED42_W)})")
        check(np.array_equal(w0, np.array(JAX_SEED42_W, np.float32)),
              f"seeded init {w0.tolist()} is not the JAX package's")

        # 2. .t7 nets through -net_fname, on the card
        x0_, x1_ = (torch.as_tensor(v, device=dev) for v in (x0, x1))
        for arch, cfg, net, want in (("fast", fast_cfg, fast, fast_want),
                                     ("slow", slow_cfg,
                                      towers.init_net(slow_cfg), slow_want)):
            path = os.path.join(tmp, f"{arch}.t7")
            t = time.perf_counter()
            params_to_t7(net, path, arch=arch, disp_max=disp_max)
            dump_s = time.perf_counter() - t
            cfg = dataclasses.replace(cfg, net_fname=path)
            t = time.perf_counter()
            loaded = cli.load_params(cfg)
            load_s = time.perf_counter() - t
            ref = stereo_predict(cfg, net, x0_, x1_, disp_max, device=dev)
            _build.reset_launches()
            got = stereo_predict(cfg, loaded, x0_, x1_, disp_max, device=dev)
            torch.cuda.synchronize()
            counts = _build.launches()
            same = torch.equal(got, ref)
            print(f"phase 9: kitti {arch} .t7: {os.path.getsize(path)} bytes, "
                  f"dumped in {dump_s:.2f} s, loaded through "
                  f"cli.load_params in {load_s:.2f} s; map "
                  f"{'bit-identical to' if same else 'DIFFERS from'} the "
                  f"in-memory net's; launches {counts}")
            check(same, f"{arch}: the .t7 net's map differs")
            check(counts == want, f"{arch} .t7: launch counts {counts}, "
                  f"expected {want}")
            del loaded, ref, got

        # 3. the volume cache: kitti slow on the generic lane
        os.chdir(tmp)
        snet = towers.init_net(slow_cfg).to(dev).eval()
        runs = {}
        for what, over, pair_id in (("uncached", {}, None),
                                    ("cache-making", {"make_cache": True}, 9),
                                    ("cached", {"use_cache": True}, 9)):
            cfg = dataclasses.replace(slow_cfg, **over)
            secs = []
            for _ in range(1 if what == "cache-making" else 2):
                _build.reset_launches()
                torch.cuda.synchronize()
                t = time.perf_counter()
                d = stereo_predict(cfg, snet, x0_, x1_, disp_max,
                                   device=dev, pair_id=pair_id)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                counts = _build.launches()
            runs[what] = d, secs, counts
        size = os.path.getsize(os.path.join("cache", "9.npz"))
        for what, (d, secs, counts) in runs.items():
            print(f"phase 9: kitti slow {what}: "
                  f"{[round(s, 3) for s in secs]} s a pair; slow_head "
                  f"{counts['slow_head']}, launches {counts}")
        print(f"  cache/9.npz: {size} bytes ({size / 2**30:.3f} GiB; 2 x "
              f"{disp_max} x {h} x {w} float32 is "
              f"{2 * disp_max * h * w * 4} bytes)")
        base = runs["uncached"][0]
        for what, want in (("uncached", slow_want),
                           ("cache-making", slow_want),
                           ("cached", dict(slow_want, slow_head=0,
                                           tower_bias_act=0, tower_conv=0,
                                           slow_volumes_epilogue=0))):
            check(runs[what][2] == want, f"{what}: launch counts "
                  f"{runs[what][2]}, expected {want}")
        check(all(torch.equal(base, r[0]) for r in runs.values()),
              "the cached maps differ from the uncached one")
        check(size >= 2 * disp_max * h * w * 4, f"cache file of {size} bytes")
        os.chdir(cwd)
        del snet, runs, base

        # 4. the host gather: phase 8's synthetic Middlebury set at
        # 240x320 (its 48x96 frame holds less than a chunk), its table cut
        # to 4 chunks an epoch; native and numpy
        mdir = os.path.join(tmp, "data.mb.imperfect_gray")
        datasets.make_synthetic_mb(mdir, height=240, width=320)
        mcfg = make_config("mb", "fast", a="train_tr", data_dir=tmp)
        mds = datasets.load_mb(mcfg)
        bs_half = mcfg.bs // 2
        mds = dataclasses.replace(
            mds, nnz_tr=mds.nnz_tr[:4 * trainer.CHUNK_STEPS * bs_half + 1])
        rows = mds.nnz_tr[:trainer.CHUNK_STEPS * bs_half]
        native = host_gather.gather_windows_from

        def numpy_gather(srcs, oy, ox, win):
            z = np.zeros(1, np.int64)
            return np.stack([augment._gather_windows(
                s[None, None], z, oy[i:i + 1], ox[i:i + 1])[0]
                for i, s in enumerate(srcs)])

        def build_chunk():
            t = time.perf_counter()
            c = trainer.stack_chunk(
                augment.AugmentSampler(mcfg, np.random.RandomState(6)), mds,
                rows, trainer.CHUNK_STEPS, bs_half)
            return c, time.perf_counter() - t

        builds = {"native": [], "numpy": []}
        chunks = {}
        for gather in ("native", "numpy", "native", "numpy"):
            host_gather.gather_windows_from = (native if gather == "native"
                                               else numpy_gather)
            try:
                chunks[gather], secs = build_chunk()
            finally:
                host_gather.gather_windows_from = native
            builds[gather].append(secs * 1e3)
        a = chunks["native"]["windows"].view(np.uint32)
        b = chunks["numpy"]["windows"].view(np.uint32)
        same = a.shape == b.shape and bool((a == b).all())
        print(f"phase 9: mb chunk of {trainer.CHUNK_STEPS} steps "
              f"({4 * len(rows)} windows of {augment.WIN}x{augment.WIN}): "
              f"native windows {'bit-identical to' if same else 'DIFFER from'}"
              f" the numpy ones; build {[round(v, 1) for v in builds['native']]}"
              f" ms native, {[round(v, 1) for v in builds['numpy']]} ms numpy")
        check(same, "the native host gather differs from numpy")

        rates = {"native": [], "numpy": []}
        chunk_ms = {"native": [], "numpy": []}
        for gather in ("native", "numpy", "numpy", "native"):
            secs = []
            lines = []
            host_gather.gather_windows_from = (native if gather == "native"
                                               else numpy_gather)
            try:
                with chunk_runs(torch, trainer, secs):
                    trainer.train(mcfg, mds, towers.init_net(mcfg), epochs=3,
                                  log=lines.append, device=dev)
            finally:
                host_gather.gather_windows_from = native
            clock = [float(ln.split("\t")[3]) for ln in lines]
            n_steps = trainer.n_epoch_steps(len(mds.nnz_tr), bs_half)
            rates[gather].append(2 * n_steps / (clock[-1] - clock[0]))
            chunk_ms[gather].append(1e3 * statistics.median(secs[1:]))
        print(f"phase 9: mb fast train(), {n_steps} steps an epoch, epochs "
              f"2-3 end to end: native {[round(r, 1) for r in rates['native']]}"
              f" steps/s, numpy {[round(r, 1) for r in rates['numpy']]} "
              f"steps/s (order native, numpy, numpy, native); a chunk on the "
              f"card {[round(v, 1) for v in chunk_ms['native'] + chunk_ms['numpy']]}"
              f" ms (median)")
        hidden = max(builds["numpy"]) < min(chunk_ms["native"]
                                            + chunk_ms["numpy"])
        print(f"  the numpy gather's chunk build "
              f"({max(builds['numpy']):.1f} ms) is "
              f"{'shorter' if hidden else 'longer'} than a chunk on the card "
              f"({min(chunk_ms['native'] + chunk_ms['numpy']):.1f} ms): "
              f"{'hidden' if hidden else 'not hidden'} on its thread")

        # 5. the preprocess script, where PIL imports
        try:
            import PIL
        except ImportError as e:
            print(f"phase 9: PIL does not import on this machine ({e}): "
                  "the preprocess step did not run (the CPU tests hold both "
                  "preprocess scripts to the JAX package's, byte for byte)")
        else:
            from mccnn_tpu_torch.data import preprocess_kitti

            hk, wk = kitti_cut
            print(f"phase 9: PIL {PIL.__version__} imports; preprocess_kitti "
                  f"with HEIGHT, WIDTH cut from "
                  f"{preprocess_kitti.HEIGHT}x{preprocess_kitti.WIDTH} to "
                  f"{hk}x{wk}")
            t = time.perf_counter()
            _kitti_raw(tmp, hk + 6, wk - 8)
            cut = preprocess_kitti.HEIGHT, preprocess_kitti.WIDTH
            preprocess_kitti.HEIGHT, preprocess_kitti.WIDTH = hk, wk
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    preprocess_kitti.preprocess_one(tmp, 2012)
            finally:
                preprocess_kitti.HEIGHT, preprocess_kitti.WIDTH = cut
            kcfg = make_config("kitti", "fast", a="train_tr", data_dir=tmp)
            kds = datasets.load_kitti(kcfg)
            X0 = np.asarray(kds.X0[:, 0])[:, None]
            X1 = np.asarray(kds.X1[:, 0])[:, None]
            kb = kcfg.bs // 2
            chunk = trainer.stack_chunk(
                augment.AugmentSampler(kcfg, np.random.RandomState(7)), kds,
                kds.nnz_tr[:trainer.CHUNK_STEPS * kb], trainer.CHUNK_STEPS,
                kb, X0, X1, device_gather=True)
            net = towers.init_net(kcfg).to(dev)
            mom = [torch.zeros_like(p) for p in net.parameters()]
            errs = trainer.train_chunk(
                kcfg, net, mom, kcfg.lr,
                {k: torch.as_tensor(v, device=dev) for k, v in chunk.items()},
                augment.pad_image_stack(X0, X1, dev)).cpu()
            print(f"  raw tree of 389 pairs and 194 ground truths, "
                  f"preprocessed and {trainer.CHUNK_STEPS} steps trained on "
                  f"the card from load_kitti ({len(kds.nnz_tr)} rows) in "
                  f"{time.perf_counter() - t:.1f} s: losses "
                  f"{float(errs[0]):.5f} -> {float(errs[-1]):.5f}")
            check(X0.shape == (389, 1, hk, wk), f"x0 {X0.shape}")
            check(bool(torch.isfinite(errs).all()), "losses not finite")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 9 took {time.perf_counter() - t9:.0f} s")


def parallel_phase(torch, dev, x0, x1, fast: tuple, slow: tuple) -> None:
    """Phase 10: ``mccnn_tpu_torch.parallel`` on the card listed once,
    twice and four times in a mesh (see the module docstring), on phase
    4's pair. ``fast``: (cfg, tower, map, launches, pairs/s, runs in ms)
    of phase 4; ``slow``: (cfg, the net with the hand-set head, map,
    launches) of phase 5."""
    import copy

    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.ops import _build, cross, join, sgm, slow_head
    from mccnn_tpu_torch.parallel import data_parallel as dp
    from mccnn_tpu_torch.parallel import inference
    from mccnn_tpu_torch.parallel.mesh import Mesh, replicated
    from mccnn_tpu_torch.pipeline import stereo_predict
    from mccnn_tpu_torch.train import augment, trainer

    t10 = time.perf_counter()
    fcfg, tower, fast_map, fast_counts, fast_pps, fast_times = fast
    scfg, hand, slow_map, slow_counts = slow

    def mesh(n):
        return Mesh([dev] * n, ("data",))

    t0_, t1_ = (torch.as_tensor(v, device=dev) for v in (x0, x1))

    # 1. the serving lane: B pairs split over the mesh, each through the
    # single-device body (kitti fast: the HWD lane, kernels 1-5); timed in
    # turns with B single-pair stereo_predict calls, so that the two are
    # compared at one point of the script (phase 4 ran minutes earlier)
    B = 8
    x0b, x1b = t0_.expand(B, H, W), t1_.expand(B, H, W)
    runs = {}
    for n in (1, 2):
        run = inference.make_batch_predict_sharded(fcfg, mesh(n), D)
        _build.reset_launches()
        maps = run(tower, x0b, x1b).cpu().numpy()
        torch.cuda.synchronize()
        got = _build.launches()
        want = {k: B * v for k, v in fast_counts.items()}
        check(got == want, f"batch lane on {n}: launches {got}, expected "
              f"{want}")
        check(all(np.array_equal(m, fast_map) for m in maps),
              f"batch lane on {n}: a map differs from phase 4's")
        print(f"phase 10: make_batch_predict_sharded, kitti fast, B={B} on "
              f"{n} entr{'y' if n == 1 else 'ies'} of the card: launches "
              f"{got} ({B}x phase 4's); every map bit-identical to phase 4's")
        runs[f"mesh of {n}"] = (lambda r=run: r(tower, x0b, x1b))

    def singles():
        for b in range(B):
            stereo_predict(fcfg, tower, x0b[b], x1b[b], D, device=dev)

    for what in ("single", "mesh of 1", "mesh of 2", "single"):
        pps, times = timed(torch, runs.get(what, singles), 5, warm=1)
        how = "by stereo_predict" if what == "single" else f"on the {what}"
        print(f"  {B} pairs {how}: {B * pps:.3f} pairs/s (median of 5; "
              f"{spread(times)})")
    print(f"  phase 4: {fast_pps:.3f} pairs/s ({spread(fast_times)})")

    # 2. the generic batch lane (kitti slow, phase 5's hand-set head)
    run = inference.make_batch_predict(scfg, mesh(2), D)
    _build.reset_launches()
    maps = run(hand, x0b[:2], x1b[:2]).cpu().numpy()
    torch.cuda.synchronize()
    got = _build.launches()
    want = {k: 2 * v for k, v in slow_counts.items()}
    check(got == want, f"make_batch_predict: launches {got}, expected {want}")
    check(all(np.array_equal(m, slow_map) for m in maps),
          "make_batch_predict: a kitti slow map differs from phase 5's")
    print(f"phase 10: make_batch_predict, kitti slow, B=2 on 2 entries: "
          f"launches {got}; both maps bit-identical to phase 5's")

    # 3. one pair row-sharded: every volume stage records the extent of
    # the slab it was given (rows, or the vertical family's columns)
    seen = {}
    wrapped = []

    def record(mod, name, what, size_of):
        orig = getattr(mod, name)

        def wrapper(*a, **kw):
            seen[what] = max(seen.get(what, 0), size_of(a))
            return orig(*a, **kw)

        setattr(mod, name, wrapper)
        wrapped.append((mod, name, orig))

    record(join, "stereo_join_dhw", "join rows", lambda a: a[0].shape[0])
    record(slow_head, "slow_volumes", "head rows", lambda a: a[1].shape[0])
    record(cross, "cbca", "cbca rows", lambda a: a[2].shape[1])
    record(sgm, "_sweep_hslab", "hslab scanlines", lambda a: a[0].shape[1])
    record(sgm, "_sweep", "vertical scanlines", lambda a: a[0].shape[1])
    try:
        for arch, cfg, net, ref, phase in (
                ("fast", fcfg, tower, fast_map, 4),
                ("slow", scfg, hand, slow_map, 5)):
            one = None
            for n in (1, 2, 4):
                rows, cols = -(-H // n), -(-W // n)
                halo = max(2, int(cfg.L1)) - 1
                limit = {"join rows": rows, "head rows": rows,
                         "cbca rows": rows + 2 * halo,
                         "hslab scanlines": 2 * rows,
                         "vertical scanlines": 2 * cols}
                run = inference.make_sharded_predict(cfg, mesh(n), D)
                seen.clear()
                _build.reset_launches()
                m = run(net, t0_, t1_).cpu().numpy()
                torch.cuda.synchronize()
                got = _build.launches()
                want = dict.fromkeys(_build.KERNELS, 0)
                # subpixel runs a shard; the fills and the median on the
                # whole map on the first device
                want.update(sgm_hslab=2 * n, sgm_vertical=2 * n, outlier=n,
                            blur=1, **dict(REFINE_KITTI, subpixel=n),
                            **cbca_counts(cfg, 2, n),
                            **layout_counts(2, shards=n),
                            **tower_counts(cfg, n),
                            **({"join": 2 * n} if arch == "fast"
                               else {"slow_head": n}))
                check(got == want, f"row-sharded kitti {arch} on {n}: "
                      f"launches {got}, expected {want}")
                check(m.shape == (H, W) and bool(np.isfinite(m).all()),
                      f"row-sharded kitti {arch} on {n}: map not finite")
                off = float((np.abs(m - ref) > 0.51).mean())
                gap = 0.0 if one is None else float(np.abs(m - one).max())
                one = m if one is None else one
                over = {k: (v, limit[k]) for k, v in seen.items()
                        if v > limit[k]}
                slabs = {k: f"{v} (limit {limit[k]})" for k, v in seen.items()}
                pps, times = timed(torch, lambda: run(net, t0_, t1_), 3,
                                   warm=1)
                print(f"phase 10: make_sharded_predict, kitti {arch} on {n} "
                      f"entr{'y' if n == 1 else 'ies'} (rows "
                      f"{[b - a for a, b in inference.splits(H, n)]}, columns "
                      f"{[b - a for a, b in inference.splits(W, n)]}): "
                      f"launches {got}; {off:.5f} of pixels more than 0.51 "
                      f"from the single-device map (phase {phase}), max |d| "
                      f"to 1 entry {gap:.3g}; largest slabs {slabs}; "
                      f"{1.0 / pps:.4f} s a pair (median of 3; "
                      f"{spread(times)})")
                check(off < 0.01, f"row-sharded kitti {arch} on {n}: {off} of "
                      "pixels off the single-device map")
                check(not over, f"row-sharded kitti {arch} on {n}: slabs "
                      f"over their share and halo: {over}")
    finally:
        for mod, name, orig in wrapped:
            setattr(mod, name, orig)

    # 4. the data-parallel step against one train_chunk step, bs=128, on
    # a sampled batch of seeded random images at 350x1242
    rng = np.random.RandomState(3)
    X0, X1 = (rng.randn(2, 1, 350, 1242).astype(np.float32) for _ in range(2))
    for arch in ("fast", "slow"):
        cfg = make_config("kitti", arch, a="train_tr")
        n_ex = cfg.bs // 2
        nnz = np.stack([rng.randint(1, 3, n_ex), rng.randint(20, 330, n_ex),
                        rng.randint(300, 1200, n_ex),
                        rng.randint(0, 228, n_ex)], 1).astype(np.float32)
        b = augment.AugmentSampler(cfg, np.random.RandomState(1)) \
            .build_batches(X0, X1, nnz)
        net = towers.init_net(cfg).to(dev)
        ref = copy.deepcopy(net)
        mom = [torch.zeros_like(p) for p in ref.parameters()]
        err_ref = trainer.train_chunk(cfg, ref, mom, cfg.lr, {
            k: torch.as_tensor(v, device=dev)[None] for k, v in b.items()})[0]
        for n in (1, 2):
            m = mesh(n)
            nets = replicated(net, m)
            mom = [torch.zeros_like(p) for p in nets[0].parameters()]
            step = dp.make_dp_train_step(cfg, m)
            shards = dp.shard_batch(b, m)
            err = step(nets, mom, cfg.lr, shards)
            torch.cuda.synchronize()
            with torch.no_grad():
                rel = max(float((p - q).abs().max() / q.abs().max()) for p, q
                          in zip(nets[0].parameters(), ref.parameters()))
            err_rel = abs(float(err) - float(err_ref)) / abs(float(err_ref))
            same = all(torch.equal(p, q) for net_k in nets[1:]
                       for p, q in zip(net_k.parameters(),
                                       nets[0].parameters()))
            t = time.perf_counter()
            for _ in range(10):
                step(nets, mom, cfg.lr, shards)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 100
            print(f"phase 10: make_dp_train_step, kitti {arch}, bs={cfg.bs} "
                  f"on {n} entr{'y' if n == 1 else 'ies'}: loss "
                  f"{float(err):.6f} (train_chunk {float(err_ref):.6f}, "
                  f"relative {err_rel:.2e}), largest relative parameter "
                  f"difference {rel:.2e}, replicas equal {same}; "
                  f"{ms:.2f} ms a step (mean of 10)")
            check(rel < 1e-5 and err_rel < 1e-5, f"dp step kitti {arch} on "
                  f"{n}: parameters {rel}, loss {err_rel} from train_chunk")
            check(same, f"dp step kitti {arch} on {n}: replicas differ")
    print(f"  phase 10 took {time.perf_counter() - t10:.0f} s")


def _group_alive(pgid: int) -> list:
    """The processes of group ``pgid`` that still run (zombies, which
    only wait to be reaped, apart), read from /proc."""
    alive = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        state, _ppid, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        if int(pgrp) == pgid and state not in ("Z", "X"):
            alive.append(int(name))
    return alive


def _log_lines(log: str) -> list:
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return f.read().splitlines()


def search_lines(args: list, cwd: str, log: str, n: int,
                 deadline_s: float) -> list:
    """Run ``python -m mccnn_tpu_torch.tools.hs *args`` in ``cwd`` as a
    process group of its own, logging to ``log``, until the log holds
    ``n`` lines or ``deadline_s`` passes; then kill the group and wait
    until none of it runs. Returns the seconds from the start at which
    each new line appeared."""
    import signal

    from mccnn_tpu_torch.tools import cli_env

    seen = len(_log_lines(log))
    times = []
    with open(log + ".err", "a") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "mccnn_tpu_torch.tools.hs", *args],
            cwd=cwd, env=dict(cli_env(), MCCNN_HS_LOG=log),
            stdout=subprocess.DEVNULL, stderr=err, start_new_session=True)
        try:
            while seen < n and time.perf_counter() - t0 < deadline_s \
                    and proc.poll() is None:
                time.sleep(0.05)
                got = len(_log_lines(log))
                times += [time.perf_counter() - t0] * (got - seen)
                seen = got
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:  # the group has ended and been reaped
                pass
            proc.wait(timeout=60)
            t = time.perf_counter()
            while _group_alive(proc.pid) and time.perf_counter() - t < 30:
                time.sleep(0.1)
    left = _group_alive(proc.pid)
    check(not left, f"hs {' '.join(args)}: processes {left} outlived it")
    if seen < n:
        with open(log + ".err") as f:
            print(f.read()[-3000:], file=sys.stderr)
    check(seen >= n, f"hs {' '.join(args)}: {seen} of {n} log lines in "
          f"{deadline_s:.0f} s")
    return times


def cli_run(args: list, cwd: str, timeout: float = 600) -> tuple:
    """One direct run of the port's command line in ``cwd``: (its
    seconds, the list of its pairs' seconds as ``test_te`` prints them,
    its score)."""
    from mccnn_tpu_torch.tools import cli_command, cli_env, last_score

    t = time.perf_counter()
    out = subprocess.run(cli_command(*args), cwd=cwd, env=cli_env(),
                         capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t
    check(out.returncode == 0, f"{' '.join(args)} exited "
          f"{out.returncode}: {out.stderr[-3000:]}")
    pairs = []
    for line in out.stdout.splitlines():  # "runtime err" a pair
        toks = line.split()
        try:
            runtime, _err = (float(v) for v in toks)
        except ValueError:
            continue
        pairs.append(runtime)
    return secs, pairs, last_score(out.stdout)


def kitti_pngs(root: str, n: int, h: int, w: int, disp_max: int) -> None:
    """``n`` synthetic scenes with occlusions
    (``datasets.make_occlusion_pair``) as KITTI's training layout: 8-bit
    PNGs of both views and the 16-bit ground truth of the pixels seen in
    both."""
    from PIL import Image

    from mccnn_tpu_torch.data.datasets import make_occlusion_pair
    from mccnn_tpu_torch.data.png16 import write_png16

    for sub in ("image_0", "image_1", "disp_noc"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        left, right, gt, occ, valid = make_occlusion_pair(h, w, disp_max,
                                                          seed=11 + i)
        lo = min(left.min(), right.min())
        span = max(left.max(), right.max()) - lo
        name = f"{i:06d}_10.png"
        for sub, img in (("image_0", left), ("image_1", right)):
            Image.fromarray(((img - lo) / span * 255).astype(np.uint8)) \
                .save(os.path.join(root, sub, name))
        write_png16(np.where(valid & ~occ, gt, 0.0),
                    os.path.join(root, "disp_noc", name))


def pair_times(secs: float, pairs: list) -> str:
    """A run's seconds split into the child's start-up (all but its
    pairs) and its pairs: the first, which pays the warm-ups, and the
    mean of the rest."""
    rest = (f", the rest {statistics.mean(pairs[1:]):.3f} a pair"
            if len(pairs) > 1 else "")
    return (f"{secs:.2f} (start-up {secs - sum(pairs):.2f}, "
            f"{(secs - sum(pairs)) / secs:.1%} of the run; {len(pairs)} "
            f"pair(s) {sum(pairs):.2f}: the first {pairs[0]:.2f}{rest})")


def drivers_phase(torch, slow_net, disp_max: int = D, n_te: int = 1) -> None:
    """Phase 11 (see the module docstring): the experiment drivers of
    ``mccnn_tpu_torch/tools/`` on the card, every child a process of the
    port's command line, on a synthetic KITTI set at 370x1226, D=228
    with ``n_te`` te images (KITTI 2012's te split holds 40).
    ``slow_net``: phase 5's kitti slow net, whose head scores the L1
    distance of the descriptors (a random head takes no patch pair for a
    match, so its error would sit near 1.0, the score of a failed run)."""
    import concurrent.futures
    import random
    import shutil
    import tempfile

    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.data import datasets
    from mccnn_tpu_torch.data.bin_io import tofile
    from mccnn_tpu_torch.models import checkpoint, towers
    from mccnn_tpu_torch.tools import cli_env, hs, rgs, rgs_qsub

    t11 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    # -make_cache writes both volumes of every te pair in float32
    cache_bytes = n_te * 2 * disp_max * H * W * 4
    free = shutil.disk_usage(os.path.join(ROOT, "build")).free
    check(free > 1.25 * cache_bytes, f"{free / 2**30:.1f} GiB free under "
          f"build/, the cache of {n_te} te pairs takes "
          f"{cache_bytes / 2**30:.1f} GiB")
    tmp = tempfile.mkdtemp(prefix="phase11_", dir=os.path.join(ROOT, "build"))
    cwd = os.getcwd()
    # deadlines: a child's start-up and a few seconds a pair
    per_run = 90 + 10 * n_te
    try:
        # the set (scenes with occlusions; image 1 is tr, images 2 ..
        # n_te + 1 te), the seeded kitti fast net and phase 5's slow net,
        # at config.py's widths
        data = os.path.join(tmp, "data.kitti")
        datasets.make_synthetic_kitti(data, n_images=n_te + 1, height=H,
                                      width=W, disp_max=disp_max,
                                      occlusions=True)
        tofile(os.path.join(data, "tr.bin"), np.asarray([1], np.int64))
        tofile(os.path.join(data, "te.bin"),
               np.arange(2, n_te + 2, dtype=np.int64))
        nets = {arch: os.path.join(tmp, f"{arch}.npz")
                for arch in ("fast", "slow")}
        checkpoint.save(nets["fast"], towers.init_net(
            make_config("kitti", "fast", a="test_te")), opt={})
        checkpoint.save(nets["slow"], slow_net, opt={})
        print(f"phase 11: synthetic data.kitti with occlusions at {H}x{W}, "
              f"D={disp_max}, {n_te} te image(s); the seeded kitti fast net "
              f"and phase 5's slow net saved in "
              f"{time.perf_counter() - t11:.1f} s")

        # 1. hs random kitti fast test_te: two lines, then its group
        # killed; one more line from hillclimb_fast on that log
        flog = os.path.join(tmp, "hs_fast.log")
        times = search_lines(["random", "kitti", "fast", "test_te",
                              nets["fast"]], tmp, flog, 2, 60 + 2 * per_run)
        search_lines(["hillclimb_fast", "kitti", "fast", "test_te",
                      nets["fast"], flog], tmp, flog, 3, per_run)
        fast_lines = _log_lines(flog)
        grid = hs.grid_for("kitti", "fast", "test_te")
        logged = hs.parse_log([flog], "kitti", "fast", "test_te")
        best = hs._indices_of(grid, min(logged[:2], key=lambda r: r[0])[1])
        climb = hs._indices_of(grid, logged[2][1])
        print(f"phase 11: hs random kitti fast test_te: lines at "
              f"{[round(t, 2) for t in times]} s from its start (a search "
              f"run {times[1] - times[0]:.2f} s), its group killed, no "
              f"process left; hillclimb_fast on its log: one line, each "
              f"index within 1 of the best line's ({best} -> {climb})")
        check(all(abs(a - b) <= 1 for a, b in zip(best, climb)),
              f"hillclimb_fast moved past a neighbour: {best} -> {climb}")

        # 2. the slow arch: the cache made by a direct run, then one hs
        # line through -use_cache with the net that made it
        make = cli_run(["kitti", "slow", "-a", "test_te", "-make_cache",
                        "-net_fname", nets["slow"]], tmp, 300 + 2 * per_run)
        cached = len(os.listdir(os.path.join(tmp, "cache")))
        check(cached == n_te, f"-make_cache wrote {cached} files in cache/ "
              f"for {n_te} te pairs")
        slog = os.path.join(tmp, "hs_slow.log")
        stimes = search_lines(["random", "kitti", "slow", "test_te",
                               nets["slow"]], tmp, slog, 1, per_run)
        slow_line = _log_lines(slog)[0]
        print(f"phase 11: kitti slow -make_cache {pair_times(*make[:2])}, "
              f"score {make[2]}; hs random kitti slow "
              f"test_te (-use_cache -net_fname): its line at "
              f"{stimes[0]:.2f} s")
        scores = [float(ln.split()[0]) for ln in fast_lines + [slow_line]]
        print(f"phase 11: logged scores {scores}")
        check(all(0.0 <= s < 1.0 for s in scores),
              f"a logged score outside [0, 1): {scores}")

        # 3. a fast line and the slow line rerun directly, the slow one
        # also without the cache: each scores the logged score
        reruns = {}
        for what, line, net in (
                ("kitti fast", fast_lines[0], ["-net_fname", nets["fast"]]),
                ("kitti slow -use_cache", slow_line,
                 ["-use_cache", "-net_fname", nets["slow"]]),
                ("kitti slow uncached", slow_line,
                 ["-net_fname", nets["slow"]])):
            toks = line.split()
            secs, pairs, score = cli_run(
                [toks[1], toks[2], "-a", toks[3], *net, *toks[4:]], tmp,
                per_run)
            reruns[what] = secs, pairs
            check(score == float(toks[0]), f"{what}: the direct run scores "
                  f"{score}, the search logged {toks[0]}")
        print(f"phase 11: s a configuration at {n_te} te pair(s), the "
              f"child's start-up apart from its pairs ({card_line()}): "
              + "; ".join(f"{w} {pair_times(*r)}" for w, r in reruns.items())
              + "; each direct run scores its logged line's score")

        # 4. side by side: rgs.run_job (kitti slow test_te at the slow
        # line's point, uncached), one rgs_qsub job (kitti ad) through
        # sh standing in for PBS, predict_kitti on two PNG pairs
        flags = slow_line.split()[4:]
        ps = {k[1:]: v for k, v in zip(flags[::2], flags[1::2])}
        check(list(ps) == [k for k, _ in rgs.PARAMS],
              f"the slow line's flags {list(ps)} are not rgs.PARAMS'")
        rng = random.Random(42)
        qps = {k: rng.choice(vs) for k, vs in rgs_qsub.PARAMS}
        while qps["pi1"] > qps["pi2"]:
            qps = {k: rng.choice(vs) for k, vs in rgs_qsub.PARAMS}
        try:
            import PIL
        except ImportError as e:
            pil = None
            print(f"phase 11: PIL does not import on this machine ({e}): "
                  "predict_kitti did not run (the CPU tests hold it to the "
                  "JAX package's copy)")
        else:
            pil = PIL.__version__
            proot = os.path.join(tmp, "unzip", "training")
            kitti_pngs(proot, 2, H, W, disp_max)
            os.makedirs(os.path.join(tmp, "predict"))
        saved = rgs_qsub.SUBMIT, rgs_qsub.POLL, rgs_qsub.DELETE
        rgs_qsub.SUBMIT, rgs_qsub.POLL, rgs_qsub.DELETE = \
            ["sh"], ["true"], ["true"]
        os.chdir(tmp)
        t = time.perf_counter()
        try:
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                job = pool.submit(rgs.run_job, ("kitti", "slow", "test_te",
                                                nets["slow"], ps, 0))
                pk = pool.submit(
                    subprocess.run,
                    [sys.executable, "-m",
                     "mccnn_tpu_torch.tools.predict_kitti", nets["fast"],
                     proot, "2"], cwd=os.path.join(tmp, "predict"),
                    env=cli_env(), capture_output=True, text=True,
                    timeout=600) if pil else None
                ((qscore, _),) = rgs_qsub.wait_all([rgs_qsub.submit(
                    "kitti", "ad", "test_te", "-", qps, 0)])
                rscore, _ = job.result()
                pout = pk.result() if pk else None
        finally:
            rgs_qsub.SUBMIT, rgs_qsub.POLL, rgs_qsub.DELETE = saved
            os.chdir(cwd)
        print(f"phase 11: rgs.run_job kitti slow test_te, uncached: "
              f"{rscore} (the hs line: {slow_line.split()[0]}); one rgs_qsub "
              f"job, kitti ad test_te through sh: {qscore}; with "
              f"predict_kitti beside them, {time.perf_counter() - t:.1f} s")
        check(rscore == float(slow_line.split()[0]),
              f"rgs.run_job scored {rscore}, the hs line "
              f"{slow_line.split()[0]}")
        check(0.0 <= qscore < 1.0, f"the rgs_qsub job scored {qscore}")
        if pout is not None:
            check(pout.returncode == 0, f"predict_kitti exited "
                  f"{pout.returncode}: {pout.stderr[-3000:]}")
            lines = pout.stdout.splitlines()
            print(f"phase 11: PIL {pil} imports; predict_kitti on 2 PNG "
                  f"scenes with occlusions at {H}x{W} (kitti fast, the "
                  f"seeded net): {lines}")
            check(len(lines) == 3 and all(
                0.0 <= float(ln.split()[-1]) < 1.0 for ln in lines),
                f"predict_kitti printed {lines}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 11 took {time.perf_counter() - t11:.0f} s")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one CUDA card (see the module docstring).")
    ap.add_argument("--phase", type=int, choices=[11], help="run phases 1, "
                    "2 and this one alone (no result line)")
    ap.add_argument("--te", type=int, default=1, help="te images of phase "
                    "11's synthetic KITTI set (default 1; KITTI 2012's te "
                    "split holds 40)")
    opts = ap.parse_args()
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.ops import (_build, blur, costs, cross, join, outlier,
                                     sgm, slow_head)
    from mccnn_tpu_torch.pipeline import stereo_predict

    dev = torch.device("cuda")
    card = card_line()
    print(f"phase 1: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card)

    secs = _build.build()
    print(f"phase 2: built {len(_build.SOURCES)} CUDA sources and "
          f"{len(_build.HOST_SOURCES)} host source in {secs:.1f} s")
    for name in _build.SOURCES:
        log = _build.log_path(name)
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    if opts.phase == 11:
        # phase 5's slow net, on phase 3's pair
        scfg = make_config("kitti", "slow", a="predict")
        x0, x1 = kitti_pair(np.random.RandomState(0), H, W, SHIFT)
        snet = towers.init_slow(scfg, scfg.seed).to(dev).eval()
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                         allow_tf32=False):
            sfeats = snet(torch.as_tensor(np.stack([x0, x1])[:, None])
                          .to(dev))
        drivers_phase(torch, matching_head(snet, sfeats), n_te=opts.te)
        print(f"chip_smoke: phases 1, 2 and 11 passed in "
              f"{time.perf_counter() - t_start:.0f} s")
        return 0

    cfg = make_config("kitti", "fast", a="predict")
    tower = towers.init_fast(cfg, cfg.seed)
    rng = np.random.RandomState(0)
    x0, x1 = kitti_pair(rng, H, W, SHIFT)
    rows = {}
    # the 16-bit instances of kernels 1-3 (their rows print before the
    # kernels' JSON line, which keeps one row a kernel)
    rows16 = {}
    DT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16"}

    # --- phase 3: kernels against their plain versions -----------------
    images = torch.as_tensor(np.stack([x0, x1])[:, None])
    with torch.no_grad():
        feats_cpu = tower(images)
        tower.to(dev)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            feats = tower(images.to(dev))
    err = float((feats.cpu() - feats_cpu).abs().max())
    print(f"phase 3: tower cuDNN (TF32 off) vs CPU: max |d| {err:.2e}")
    check(err <= 1e-4, f"tower differs from the CPU tower by {err}")
    fl = feats[0].permute(1, 2, 0)
    fr = feats[1].permute(1, 2, 0)
    C = fl.shape[-1]
    Hp, Wp, Dp = join.pad_dims(H, W, D)
    a = join._prep(fr, False, Hp, Wp)
    b = join._prep(fl, False, Hp, Wp + Dp)

    vol_k = join._join_plus(a, b, D, W, H, 4)
    vol_p = join.join_plus_plain(a, b, D, W, H, 4)
    torch.cuda.synchronize()
    check(torch.equal(vol_k.isnan(), vol_p.isnan()), "join NaN masks differ")
    err = float((vol_k - vol_p).nan_to_num().abs().max())
    check(err <= 1e-5, f"join max |d| {err} > 1e-5")
    same = float((costs.wta_hwd(vol_k)[:H, :W] == costs.wta_hwd(vol_p)[:H, :W])
                 .float().mean())
    check(same >= 0.9999, f"join winner maps agree on {same}")
    del vol_p
    vol_s = join.join_plus_split_plain(a, b, D, W, H, 4)
    err_s = float((vol_k - vol_s).nan_to_num().abs().max())
    del vol_s

    def join_stores(a, b, vol_k, d, w, h, n_fix, d_true, where):
        """The 16-bit stores of the join on (a, b): the float32 kernel's
        volume ``vol_k`` rounded, bit for bit (one float32 staging tile,
        one rounding), stored as bf16 and as f16, and as bf16 with the
        lanes d >= ``d_true`` NaN. Returns {dtype: row} of both storage
        types, timed, the bound's bytes at 2 a cell."""
        for dt, dtr in ((torch.bfloat16, None), (torch.float16, None),
                        (torch.bfloat16, d_true)):
            want = vol_k
            if dtr is not None:
                want = vol_k.clone()
                want[..., dtr:] = torch.nan
            want = want.to(dt)
            got = join._join_plus(a, b, d, w, h, n_fix, d_true=dtr,
                                  out_dtype=dt)
            torch.cuda.synchronize()
            check(identical(got, want), f"join {where} stored as {dt} "
                  f"(d_true {dtr}) is not the float32 kernel's volume rounded")
            del got, want
        print(f"  join {where}: bfloat16 and float16 stores equal to the "
              f"float32 kernel's volume rounded, bit for bit; with d_true = "
              f"{d_true} the lanes d >= {d_true} NaN")
        c, n = a.shape[1], cells_of(d, h, w)
        return {dt: dict(err=0.0, plain_ms=None, ms=cuda_ms(
                    torch, lambda: join._join_plus(a, b, d, w, h, n_fix,
                                                   out_dtype=dt), 10),
                         bound=bound_ms(2 * h * w * c * 4 + n * 2,
                                        6 * 2.0 * n * c, BF16_TC_OPS))
                for dt in (torch.bfloat16, torch.float16)}

    for dt, row in join_stores(a, b, vol_k, D, W, H, 4, 200,
                               f"at {H}x{W}, D={D}").items():
        rows16[f"join ({DT_NAME[dt]} storage)"] = row
    del vol_k
    print(f"  join (three-level bf16 split on wgmma): max |d| {err:.3g} "
          f"against the f32 sum, "
          f"{err_s:.3g} against the emulation of its arithmetic; winner maps "
          f"equal on {same:.6f} of pixels")
    # bounds count the real cells only: pad rows, columns and lanes are
    # layout, not work. The join's operations are six bf16 passes (the
    # products of a three-level split) on the tensor cores.
    cells = H * W * D
    join_ops = 6 * 2.0 * cells * C
    rows["join"] = dict(
        err=err, ms=cuda_ms(torch, lambda: join._join_plus(a, b, D, W, H, 4), 10),
        plain_ms=cuda_ms(torch, lambda: join.join_plus_plain(a, b, D, W, H, 4), 1),
        bound=bound_ms((2 * H * W * C + cells) * 4, join_ops, BF16_TC_OPS))
    print(f"  join bound: {rows['join']['bound'][0]:.4f} ms by "
          f"{rows['join']['bound'][1]} (operations at the "
          f"{BF16_TC_OPS / 1e12:.0f} TFLOP/s bf16 tensor-core peak: "
          f"{join_ops / BF16_TC_OPS * 1e3:.4f} ms)")

    # the right direction's four sweeps on the join volume; the second of
    # each family is timed: it reads the accumulator and adds in place
    vol_l, vol_r = join.stereo_join_hwd(fl, fr, D, n_fix=4)
    plan = sgm.sweep_plan(torch.as_tensor(x0, device=dev),
                          torch.as_tensor(x1, device=dev), D, H, W,
                          vol_r.shape, xrev=False, pi1=cfg.pi1, pi2=cfg.pi2,
                          tau_so=cfg.tau_so, alpha1=cfg.alpha1, q1=cfg.sgm_q1,
                          q2=cfg.sgm_q2)
    acc_k = torch.empty_like(vol_r)
    acc_p = torch.empty_like(vol_r)
    # a sweep: ~10 f32 operations a cell; the volume and the accumulator
    # read, the sum written; the D1 table (H, W), the D2 table
    # (H, W + 2D)
    tables = (H * W + H * (W + 2 * D)) * 4
    for i, p in enumerate(plan):
        p = dict(p)
        d1, g = p.pop("d1"), p.pop("g")
        last = i == len(plan) - 1
        ak, ap = (None, None) if i == 0 else (acc_k, acc_p)
        wk = torch.empty((Hp, Wp), device=dev) if last else None
        wp = torch.empty((Hp, Wp), device=dev) if last else None
        if i in (1, 3):  # the last one with its fused WTA, as on the path
            scratch = acc_k.clone()
            wbuf = torch.empty((Hp, Wp), device=dev) if last else None
            entry = "sgm_vertical" if p["vertical"] else "sgm_horizontal"
            ms = cuda_ms(torch, lambda: sgm._sweep(vol_r, scratch, scratch,
                                                   wbuf, d1, g, **p), 5)
            t0 = time.perf_counter()
            sgm.sweep_plain(vol_r, scratch, scratch, wbuf, d1, g, **p)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            del scratch, wbuf
        sgm._sweep(vol_r, ak, acc_k, wk, d1, g, **p)
        sgm.sweep_plain(vol_r, ap, acc_p, wp, d1, g, **p)
        torch.cuda.synchronize()
        check(torch.equal(acc_k.isnan(), acc_p.isnan()),
              f"sweep {i} NaN masks differ")
        real = (slice(0, H), slice(0, W), slice(0, D))
        diff = (acc_k[real] - acc_p[real]).abs().nan_to_num()  # masks equal
        if p["vertical"]:  # the same f32 operations in the same order
            check(float(diff.max()) == 0.0, f"vertical sweep {i}: max |d| "
                  f"{float(diff.max())}, expected bit-identical")
        tol = 1e-5 * acc_p[real].abs().nan_to_num()
        check(bool((diff <= tol).all()), f"sweep {i}: max |d| "
              f"{float(diff.max())} beyond rtol 1e-5")
        if last:
            same = float((wk[:H, :W] == wp[:H, :W]).float().mean())
            check(same >= 0.9999, f"fused WTA maps agree on {same}")
            wta_same = same
        if i in (1, 3):
            rows[entry] = dict(
                err=float(diff.max()), ms=ms, plain_ms=plain_ms,
                bound=bound_ms(3 * cells * 4 + tables
                               + (H * W * 4 if last else 0), 10.0 * cells))
    print(f"  fused WTA maps equal on {wta_same:.6f} of pixels; sgm_vertical "
          f"down and up bit-identical to the plain loop")
    del acc_p

    # the horizontal entry in its four uses: the right-going and the
    # left-going sweep, each adding into the accumulator in place and with
    # the volume write skipped, the winner map fused: the same f32
    # operations in the same order and an exact min, so equal to the plain
    # loop bit for bit, volume, NaN mask and winner map
    for p in plan[2:]:
        p = dict(p)
        d1, g = p.pop("d1"), p.pop("g")
        for with_out in (True, False):
            res = []
            for sweep in (sgm._sweep, sgm.sweep_plain):
                a = acc_k.clone()
                w = torch.empty((Hp, Wp), device=dev)
                sweep(vol_r, a, a if with_out else None, w, d1, g, **p)
                res.append((a, w))
            torch.cuda.synchronize()
            (a_k, w_k), (a_p, w_p) = res
            what = (f"horizontal sweep (reverse={p['reverse']}, "
                    f"volume write={with_out})")
            check(torch.equal(w_k, w_p), f"{what}: winner maps differ")
            check(torch.equal(a_k.isnan(), a_p.isnan())
                  and torch.equal(a_k.nan_to_num(), a_p.nan_to_num()),
                  f"{what}: volumes differ")
            del res, a, w, a_k, a_p, w_k, w_p
    print("  sgm_horizontal: forward and reverse, with and without the volume "
          "write, bit-identical to the plain loop (volume and winner map)")
    del acc_k

    # the 16-bit instances of both entries on the volume stored as bf16 and
    # f16, the four sweeps chained as on the path: each sweep (vertical
    # down and up, horizontal right and left: forward and reverse) with and
    # without the volume write, the winner map fused, against the plain
    # loop on the same 16-bit tensors, bit for bit; the second sweep of
    # each family is timed, as the float32 rows are
    for dt in (torch.bfloat16, torch.float16):
        vol16 = vol_r.to(dt)
        acc16 = None
        for i, p in enumerate(plan):
            p = dict(p)
            d1, g = p.pop("d1"), p.pop("g")
            entry = "sgm_vertical" if p["vertical"] else "sgm_horizontal"
            what = (f"{entry} in {DT_NAME[dt]} (reverse={p['reverse']}, "
                    f"sweep {i})")
            for with_out in (True, False):
                res = []
                for sweep in (sgm._sweep, sgm.sweep_plain):
                    a16 = None if acc16 is None else acc16.clone()
                    o16 = ((torch.empty_like(vol16) if a16 is None else a16)
                           if with_out else None)
                    w = torch.empty((Hp, Wp), device=dev)
                    sweep(vol16, a16, o16, w, d1, g, **p)
                    res.append((o16, w))
                torch.cuda.synchronize()
                (o_k, w_k), (o_p, w_p) = res
                check(torch.equal(w_k, w_p), f"{what}: winner maps differ")
                if with_out:
                    check(o_k.dtype == dt and identical(o_k, o_p),
                          f"{what}: volumes differ")
                    nxt = o_k
                del res, o_k, o_p, w_k, w_p
            if i in (1, 3):
                scratch = acc16.clone()
                wbuf = torch.empty((Hp, Wp), device=dev) if i == 3 else None
                rows16[f"{entry} ({DT_NAME[dt]} storage)"] = dict(
                    err=0.0, plain_ms=None,
                    ms=cuda_ms(torch, lambda: sgm._sweep(
                        vol16, scratch, scratch, wbuf, d1, g, **p), 5),
                    bound=bound_ms(3 * cells_of(D) * 2 + tables
                                   + (H * W * 4 if i == 3 else 0),
                                   10.0 * cells_of(D)))
                del scratch, wbuf
            acc16 = nxt
        del vol16, acc16, nxt, a16, o16, w
    print("  sgm_vertical, sgm_horizontal in bf16 and f16 storage: the four "
          "chained sweeps (forward and reverse), with and without the volume "
          "write, bit-identical to the plain loop (volume and winner map)")

    d_r = costs.wta_hwd(vol_r)[:H, :W].contiguous()
    d_l = costs.wta_hwd(vol_l)[:H, :W].flip(1).contiguous()
    def outlier_row(d0, d1, d, what):
        """The outlier kernel against its plain version, equal. Its time
        is device time in a CUDA graph (the kernel takes a few
        microseconds, less than its wrapper's host time), printed beside
        the time by events around eager calls. The bound: the bytes (two
        maps read, the labels written) and, at the instruction rate, three
        f32 instructions (convert, subtract, compare of the magnitude) for
        each of the five candidates of every right value in (-3, D + 3)
        and for the match test of every pixel."""
        lab_k = outlier.outlier_detection(d0, d1, d)
        lab_p = outlier.outlier_detection_plain(d0, d1, d)
        check(torch.equal(lab_k, lab_p), f"outlier labels differ {what}")
        h, w = d0.shape
        n_in = int(((d1 > -3) & (d1 < d + 3)).sum())
        row = dict(
            err=0.0, ms=graph_ms(torch, lambda: outlier.outlier_detection(d0, d1, d), 20),
            plain_ms=cuda_ms(torch, lambda: outlier.outlier_detection_plain(d0, d1, d), 2),
            bound=bound_ms(3 * h * w * 4, 3.0 * (5 * n_in + h * w), F32_INSTR))
        eager = cuda_ms(torch, lambda: outlier.outlier_detection(d0, d1, d), 20)
        shares = [round(float((lab_k == v).float().mean()), 4) for v in (0, 1, 2)]
        print(f"  outlier {what}: labels equal to the plain version (match / "
              f"occlusion / mismatch {shares}); kernel {row['ms']:.4f} ms a call "
              f"in a CUDA graph, {eager:.4f} ms by events around eager calls, "
              f"plain {row['plain_ms']:.3f} ms, bound {row['bound'][0]:.5f} ms "
              f"({row['bound'][1]})")
        return row

    rows["outlier"] = outlier_row(d_l, d_r, D, f"at {H}x{W}, D={D}")
    # the Middlebury -a time shape (mccnn_tpu_torch/cli.py), seeded maps
    hm, wm, dm = 1000, 1500, 200
    outlier_row(*(torch.as_tensor(a, device=dev)
                  for a in outlier.probe_maps(7, hm, wm, dm)), dm,
                f"at {hm}x{wm}, D={dm} (probe maps)")

    def blur_row(img, sigma, t):
        """The blur kernel against its plain version on ``img`` with the
        Gaussian of ``sigma`` and threshold ``t``. Both sum up to k*k
        weighted taps in f32 in other orders, so the rounding grows with
        the value: |d| <= 1e-4 + 1e-6 * |value| (disparities reach 227,
        where an f32 ulp is 1.5e-5). The bound counts the in-frame taps,
        four f32 instructions each (the subtract, the compare of its
        magnitude, the predicated FMA and add) at the instruction rate."""
        kern = torch.as_tensor(blur.gaussian_kernel(sigma), device=dev)
        k = kern.shape[0]
        r = k // 2
        h, w = img.shape
        b_k = blur.mean2d(img, kern, t)
        b_p = blur.mean2d_plain(img, kern, t)
        diff = (b_k - b_p).abs()
        err = float(diff.max())
        print(f"  blur ({k}x{k}) at {h}x{w}: max |d| {err!r} to the plain "
              "version")
        check(bool((diff <= 1e-4 + 1e-6 * b_p.abs()).all()),
              f"blur ({k}x{k}) max |d| {err} beyond 1e-4 + 1e-6 |value|")
        ny = sum(min(h - 1, y + r) - max(0, y - r) + 1 for y in range(h))
        nx = sum(min(w - 1, x + r) - max(0, x - r) + 1 for x in range(w))
        return dict(
            err=err, ms=cuda_ms(torch, lambda: blur.mean2d(img, kern, t), 10),
            plain_ms=cuda_ms(torch, lambda: blur.mean2d_plain(img, kern, t), 1),
            bound=bound_ms((2 * h * w + k * k) * 4, 4.0 * ny * nx, F32_INSTR))

    # the refinement chain's four kernels on phase 4's own maps and volume:
    # the same pair through the same path, its stages' inputs captured
    seen = capture_refine(torch, lambda: stereo_predict(cfg, tower, x0, x1, D))
    rows.update(refine_rows(torch, seen, f"at {H}x{W}, D={D}"))
    del seen

    rows["blur"] = blur_row(d_l.clone(), cfg.blur_sigma, cfg.blur_t)
    del vol_l, vol_r

    # the slow-arch path's two new kernels at kitti slow shapes
    scfg = make_config("kitti", "slow", a="predict")
    snet = towers.init_slow(scfg, scfg.seed)
    snet = snet.to(dev).eval()
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        sfeats = snet(images.to(dev))
    ops = slow_head.head_operands(snet, sfeats[0].permute(1, 2, 0),
                                  sfeats[1].permute(1, 2, 0))
    A, B, mids_w, mids_b, w_last, b_last = ops
    n_mid, nh2 = mids_w.shape[0], scfg.nh2
    s_k = slow_head.slow_head_volume(*ops, D)
    s_p = slow_head.slow_head_plain(*ops, D)
    torch.cuda.synchronize()
    xs = torch.arange(W, device=dev)[None, None, :]
    ds = torch.arange(D, device=dev)[:, None, None]
    valid = (xs >= ds).expand(D, H, W)
    diff = (s_k - s_p).abs()[valid]
    err, mean_err = float(diff.max()), float(diff.mean())
    del diff
    print(f"  slow_head over all {int(valid.sum())} cells with x >= d: max |d| "
          f"{err:.3g}, mean |d| {mean_err:.3g}")
    # tolerance: both round the same operands to bf16 and sum in f32 in
    # other orders; a hidden unit within such a difference of a bf16
    # rounding boundary rounds one bf16 ulp apart (2^-8 relative)
    check(err <= 1e-3 and mean_err <= 1e-5,
          f"slow_head max |d| {err} > 1e-3 or mean |d| {mean_err} > 1e-5")
    head_cells = float(H * sum(max(0, W - d) for d in range(D)))
    rows["slow_head"] = dict(
        err=err, ms=cuda_ms(torch, lambda: slow_head.slow_head_volume(*ops, D), 3),
        plain_ms=cuda_ms(torch, lambda: slow_head.slow_head_plain(*ops, D), 1,
                         warm=False),
        library_ms=cuda_ms(torch, lambda: head_library(
            torch, slow_head, *ops, D), 2),
        bound=bound_ms((A.numel() + B.numel() + s_k.numel()) * 4
                       + mids_w.numel() * 2,
                       2.0 * head_cells * n_mid * nh2 * nh2, BF16_TC_OPS))
    head_ops = rows["slow_head"]["bound"][0] * 1e-3 * BF16_TC_OPS
    print(f"  slow_head: {head_ops / (rows['slow_head']['ms'] * 1e-3) / 1e12:.1f} "
          f"TFLOP/s, {rows['slow_head']['bound'][0] / rows['slow_head']['ms']:.3f} "
          f"of the {BF16_TC_OPS / 1e12:.0f} TFLOP/s bf16 peak (the mma.sync "
          f"kernel it replaces took {OLD_HEAD_MS} ms)")
    vols = dict(zip((-1, 1), slow_head.masked_volumes(s_k)))
    del s_p, valid
    # the slow volumes' epilogue on this head's scores (kitti slow's border
    # of ws // 2 columns; and with d_true = 200), then the towers' kernels
    # on the convolution outputs of kitti fast (float32 and -dtype
    # bfloat16) and kitti slow, captured in one stereo_predict each
    t_tower = time.perf_counter()
    ep = epilogue_rows(torch, s_k, (scfg.ws - 1) // 2, 200,
                       f"kitti slow at {H}x{W}, D={D}")
    rows["slow_volumes_epilogue"] = ep.pop("slow_volumes_epilogue")
    rows_tower = dict(ep)
    del s_k
    seen = {}
    for c in (cfg, make_config("kitti", "fast", a="predict",
                               dtype="bfloat16")):
        seen.update(capture_tower(
            torch, lambda c=c: stereo_predict(c, tower, x0, x1, D)))
    got = tower_rows(torch, seen, f"kitti fast at {H}x{W}")
    rows["tower_bias_act"] = got.pop("tower_bias_act (float32, relu True)")
    rows["tower_normalize_pack"] = got.pop(
        "tower_normalize_pack (float32, sides both)")
    rows_tower.update(got)
    seen = capture_tower(torch, lambda: stereo_predict(scfg, snet, x0, x1, D))
    rows_tower.update({f"{k} kitti slow": v for k, v in tower_rows(
        torch, seen, f"kitti slow at {H}x{W}").items()})
    del seen, got
    print(f"  the tower kernels' checks took "
          f"{time.perf_counter() - t_tower:.0f} s")
    # the towers' convolutions on each path's own inputs: kitti fast and
    # kitti slow in float32 and -dtype bfloat16, and kitti fast row-sharded
    # on 4 entries (slices that start mid-image, with their halos)
    t_conv = time.perf_counter()
    for c, net, what in (
            (cfg, tower, "kitti fast"),
            (make_config("kitti", "fast", a="predict", dtype="bfloat16"),
             tower, "kitti fast"),
            (scfg, snet, "kitti slow"),
            (make_config("kitti", "slow", a="predict", dtype="bfloat16"),
             snet, "kitti slow")):
        row = conv_row(torch, capture_convs(
            torch, lambda c=c, net=net: stereo_predict(c, net, x0, x1, D)),
            f"{what} at {H}x{W}")
        if c is cfg:
            rows["tower_conv"] = row
        else:
            rows_tower[f"tower_conv {what} ({c.dtype})"] = row
    from mccnn_tpu_torch.parallel import inference
    from mccnn_tpu_torch.parallel.mesh import Mesh

    sharded = inference.make_sharded_predict(
        cfg, Mesh([dev] * 4, ("data",)), D)
    rows_tower["tower_conv kitti fast row-sharded on 4"] = conv_row(
        torch, capture_convs(torch, lambda: sharded(
            tower, torch.as_tensor(x0, device=dev),
            torch.as_tensor(x1, device=dev))),
        f"kitti fast row-sharded on 4 entries at {H}x{W}")
    del sharded
    # the other widths of the fast net's hyperparameter search (tools/hs.py
    # fm 80, 96): their wgmma instances on a kitti fast net's own inputs
    for fm in (80, 96):
        for dt in ("float32", "bfloat16"):
            c = make_config("kitti", "fast", a="predict", dtype=dt, fm=fm)
            net = towers.init_fast(c, c.seed).to(dev)
            rows_tower[f"tower_conv kitti fast fm {fm} ({dt})"] = conv_row(
                torch, capture_convs(
                    torch, lambda c=c, net=net: stereo_predict(
                        c, net, x0, x1, D)),
                f"kitti fast, fm {fm}, at {H}x{W}")
            del net
    torch.cuda.empty_cache()
    print(f"  the tower convolutions' checks took "
          f"{time.perf_counter() - t_conv:.0f} s")

    # the Middlebury shape of the chain (two mid layers, a narrow head
    # padded to the 64-wide instance) at a small ragged size
    rs = np.random.RandomState(5)
    h2, w2, d2, c2 = 9, 203, 70, 48

    def rt(*shape, scale):
        return torch.as_tensor((rs.randn(*shape) * scale).astype(np.float32),
                               device=dev)

    small = slow_head.pad_head(rt(h2, w2, c2, scale=0.5), rt(h2, w2, c2, scale=0.5),
                               rt(2, c2, c2, scale=c2 ** -0.5),
                               rt(2, c2, scale=0.1), rt(c2, scale=c2 ** -0.5))
    small = (*small[:2], small[2].to(torch.bfloat16), *small[3:], 0.1)
    check(small[0].shape[-1] == 64, f"padded width {small[0].shape[-1]}")
    diff = (slow_head.slow_head_volume(*small, d2)
            - slow_head.slow_head_plain(*small, d2)).abs()
    diff = diff[(torch.arange(w2, device=dev)[None, None, :]
                 >= torch.arange(d2, device=dev)[:, None, None]).expand_as(diff)]
    err2, mean2 = float(diff.max()), float(diff.mean())
    print(f"  slow_head at {h2}x{w2}, D={d2}, C={c2} padded to 64, two mid "
          f"layers: max |d| {err2:.3g}, mean |d| {mean2:.3g}")
    check(err2 <= 1e-3 and mean2 <= 1e-5,
          f"small slow_head max |d| {err2} > 1e-3 or mean |d| {mean2} > 1e-5")
    del small, diff

    # the CBCA kernel on phase 5's own kitti slow volumes and arms (one
    # slow stereo_predict; the last CBCA input of each direction captured),
    # on kitti census's at K = 2 and kitti ad's at K = 3; the packing of
    # kitti slow's arms; the arms kernel at every config's K
    ccfg = make_config("kitti", "census", a="predict")
    acfg = make_config("kitti", "ad", a="predict")
    for what, run in (("kitti slow", lambda: stereo_predict(scfg, snet, x0, x1,
                                                            D)),
                      ("kitti census", lambda: stereo_predict(ccfg, None, x0,
                                                              x1, D)),
                      ("kitti ad", lambda: stereo_predict(acfg, None, x0, x1,
                                                          D))):
        seen = capture_cbca(torch, run)
        for key, row in cbca_rows(torch, seen,
                                  f"{what} at {H}x{W}, D={D}").items():
            if what == "kitti slow" and key == "cbca (direction -1)":
                key = "cbca"
            rows[key if key == "cbca" else f"{key[:-1]}, {what})"] = row
        if what == "kitti slow":
            (p0c, p1c, _, _, pL1), _ = seen[("cbca", -1)]
            # both arm stacks read, the packed offsets written
            rows["cbca_pack"] = exact_row(
                torch, f"cbca_pack {what} at {H}x{W}, K = {max(2, pL1)}",
                lambda: cross.cbca_pack(p0c, p1c, pL1),
                lambda: cross.cbca_pack_plain(p0c, p1c, pL1),
                32 * H * W + 2 * (9 * H * cross.pack_pitch(W) + 2 * H * W))
            del p0c, p1c
        del seen
    arms = arms_rows(torch, torch.as_tensor(x0, device=dev),
                     f"at {H}x{W}", nan=True)
    rows["cross_arms"] = arms.pop("cross_arms (K = 5)")
    rows.update(arms)

    # the census and ad volumes on the inputs kitti census and kitti ad
    # give them (census's signatures once a pair, both directions), and
    # the HWD lane's tables on kitti fast's (both storage orders)
    seen = {}
    for run in (lambda: stereo_predict(ccfg, None, x0, x1, D),
                lambda: stereo_predict(acfg, None, x0, x1, D),
                lambda: stereo_predict(cfg, tower, x0, x1, D)):
        seen.update(capture_costs(torch, run))
    rows.update(cost_rows(torch, seen, f"at {H}x{W}, D={D}"))
    del seen
    # the generic lane's layouts, tables, family sum and winner-take-all
    # on the inputs kitti census gives them (both directions, slab form)
    seen = capture_layout(torch, lambda: stereo_predict(ccfg, None, x0, x1, D))
    rows.update(layout_rows(torch, seen, f"kitti census at {H}x{W}, D={D}"))
    del seen

    # blur with kitti slow's own Gaussian and threshold, on the WTA map of
    # the slow head's left volume
    rows["blur (kitti slow)"] = blur_row(costs.wta(vols[-1]), scfg.blur_sigma,
                                         scfg.blur_t)

    # the generic lane's two stacked families on those volumes, as
    # sgm_multi builds them: both directions in one volume, the -1
    # direction's scanlines first and reversed
    x0_t, x1_t = (torch.as_tensor(v, device=dev) for v in (x0, x1))
    skw = dict(pi1=scfg.pi1, pi2=scfg.pi2, tau_so=scfg.tau_so, q1=scfg.sgm_q1,
               q2=scfg.sgm_q2)
    vol_x, hplan = sgm.horiz_plan(x0_t, x1_t, vols, (-1, 1), D, H, W, **skw)
    vol_y, vplan = sgm.vert_plan(x0_t, x1_t, vols, (-1, 1), D, H, W,
                                 alpha1=scfg.alpha1, **skw)

    def stacked_family(entry, vol, plan, kernel, plain, table_bytes,
                       n=2 * H * W * D):
        """Both sweeps of a stacked family, kernel against plain, each
        bit for bit with equal NaN masks (the same f32 operations in the
        same order and an exact min); the second sweep is timed: it reads
        the accumulator and adds in place. The bound counts the real
        cells of the stacked directions, ``n`` (both at KITTI size)."""
        acc_k = torch.empty_like(vol)
        acc_p = torch.empty_like(vol)
        for i, p in enumerate(plan):
            p = dict(p)
            d1, g = p.pop("d1"), p.pop("g")
            ak, ap = (None, None) if i == 0 else (acc_k, acc_p)
            if i == 1:
                scratch = acc_k.clone()
                ms = cuda_ms(torch, lambda: kernel(vol, scratch, scratch, d1, g,
                                                   **p), 5)
                t0 = time.perf_counter()
                plain(vol, scratch, scratch, d1, g, **p)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                del scratch
            kernel(vol, ak, acc_k, d1, g, **p)
            plain(vol, ap, acc_p, d1, g, **p)
            torch.cuda.synchronize()
            check(torch.equal(acc_k.isnan(), acc_p.isnan()),
                  f"{entry} sweep {i} NaN masks differ")
            diff = (acc_k - acc_p).abs().nan_to_num()  # masks equal
            check(float(diff.max()) == 0.0,
                  f"{entry} sweep {i}: max |d| {float(diff.max())}, expected "
                  "bit-identical")
        return dict(err=float(diff.max()), ms=ms, plain_ms=plain_ms,
                    bound=bound_ms(3 * n * 4 + table_bytes, 10.0 * n))

    # tables: hslab D1 (W, 2H) and D2 (2H, W + 2D); vertical D1 (H, 2W)
    # and the reversed and natural D2 (H, W + 2D) each
    rows["sgm_hslab"] = stacked_family(
        "sgm_hslab", vol_x, hplan, sgm._sweep_hslab, sgm.hslab_plain,
        (2 * H * W + 2 * H * (W + 2 * D)) * 4)
    print("  sgm_hslab (stacked): right and left bit-identical to the plain "
          "loop")
    del vol_x
    rows["sgm_vertical (kitti slow, stacked)"] = stacked_family(
        "sgm_vertical", vol_y, vplan,
        lambda v, a, o, d1, g, **p: sgm._sweep(v, a, o, None, d1, g, **p),
        lambda v, a, o, d1, g, **p: sgm.sweep_plain(v, a, o, None, d1, g, **p),
        (2 * H * W + 2 * H * (W + 2 * D)) * 4)
    print("  sgm_vertical (stacked): down and up bit-identical to the plain "
          "loop")
    check(vplan[0]["n_rev"] == W, "the stacked vertical plan has no reversed "
          "half")
    del vol_y

    scan_entries = (("sgm_scan", sgm.sweep_stream), ("sgm_step", sgm.sweep_grid))

    def scan_plain(vol, d1, d2, reverse, **kw):
        """The plain loop in sweep order: a reverse sweep on the inputs
        reversed in steps, its result reversed back."""
        if reverse:
            return sgm.sweep_scan_plain(vol.flip(0), d1.flip(0), d2.flip(0),
                                        **kw).flip(0)
        return sgm.sweep_scan_plain(vol, d1, d2, **kw)

    def scan_check(what, got, want):
        check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
        check(torch.equal(got.isnan(), want.isnan()), f"{what}: NaN masks differ")
        err = float((got - want).abs().nan_to_num().max())  # masks equal
        check(err == 0.0, f"{what}: max |d| {err}, expected bit-identical")

    def scan_family(name, vol, plan):
        """Both scan-form entries against the plain loop on both sweeps
        of a family, on the natural-order slices the scan form builds:
        the forward sweep, and the backward one with ``reverse`` (read
        and written in place). The same f32 operations in the same
        order, so equal bit for bit, NaN masks included. Both directions
        are timed. The bound counts every cell (the slices are not
        padded) and is the same for both entries and directions, which
        compute one function: the volume and the D2 table read, the
        result written, the D1 table. Returns {(entry, reverse): row}."""
        T, S, _ = vol.shape
        n = T * S * D
        fam = {}
        for p in plan:
            d1, d2, rev = p["d1"], p["d2"], p["reverse"]
            kw = dict(tau=p["tau"], pen=p["pen"])
            t0 = time.perf_counter()
            want = scan_plain(vol, d1, d2, rev, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            for entry, sweep in scan_entries:
                scan_check(f"{entry} {name} (reverse={rev})",
                           sweep(vol, d1, d2, reverse=rev, **kw), want)
                fam[entry, rev] = dict(
                    err=0.0, plain_ms=plain_ms,
                    ms=cuda_ms(torch, lambda: sweep(vol, d1, d2, reverse=rev,
                                                    **kw), 5),
                    bound=bound_ms((3 * n + T * S) * 4, 10.0 * n))
            del want, d1, d2
        return fam

    vol_x, splan = sgm.scan_horiz_plan(x0_t, x1_t, vols, (-1, 1), D, H, W,
                                       **skw)
    check(vol_x.shape == (W, 2 * H, D), f"scan horizontal slices {vol_x.shape}")
    fam = scan_family("horizontal", vol_x, splan)
    for entry, _ in scan_entries:
        rows[entry] = fam[entry, False]
        rows[f"{entry} (horizontal, reverse)"] = fam[entry, True]
    del vol_x, splan
    vol_y, splan = sgm.scan_vert_plan(x0_t, x1_t, vols, (-1, 1), D, H, W,
                                      alpha1=scfg.alpha1, **skw)
    check(vol_y.shape == (H, 2 * W, D), f"scan vertical slices {vol_y.shape}")
    fam = scan_family("vertical", vol_y, splan)
    for entry, _ in scan_entries:
        rows[f"{entry} (vertical family)"] = fam[entry, False]
        rows[f"{entry} (vertical, reverse)"] = fam[entry, True]
    del vol_y, splan, vols
    print("  sgm_scan, sgm_step: both families, forward and reverse, "
          "bit-identical to the plain loop")

    # rows off a multiple of 4 (D = 70, 1): the entries copy them into
    # rows of a pitch of whole float4s, NaN in the volume's pad lanes
    rs = np.random.RandomState(11)
    for T5, S5, D5 in ((37, 50, 70), (6, 9, 1)):
        vol5 = rs.rand(T5, S5, D5).astype(np.float32)
        vol5[rs.rand(T5, S5, D5) < 0.03] = np.nan
        vol5[:, :S5 // 2, D5 - D5 // 3:] = np.nan
        d1_5 = (rs.rand(T5, S5) * 0.16).astype(np.float32)
        d2_5 = (rs.rand(T5, S5, D5) * 0.16).astype(np.float32)
        args = [torch.as_tensor(a, device=dev) for a in (vol5, d1_5, d2_5)]
        kw = dict(tau=0.08, pen=sgm.pen_table(1.32, 24.25, 3.0, 2.0, 2.0, 1.0))
        for rev in (False, True):
            want = scan_plain(*args, rev, **kw)
            for entry, sweep in scan_entries:
                scan_check(f"{entry} at ({T5}, {S5}, {D5}) (reverse={rev})",
                           sweep(*args, reverse=rev, **kw), want)
    print("  sgm_scan, sgm_step: rows of 70 and of 1 floats (padded to a "
          "pitch of 72 and 4), both directions, bit-identical")
    for name, row in rows.items():
        lib = row.get("library_ms")
        print(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound'][0]:.4f} ms ({row['bound'][1]}), "
              f"max |d| {row['err']:.3g}"
              + ("" if lib is None else f", library {lib:.3f} ms"))
    for name, row in rows16.items():
        print(f"  {name}: kernel {row['ms']:.4f} ms, bound "
              f"{row['bound'][0]:.4f} ms ({row['bound'][1]}), equal to the "
              f"plain version bit for bit")
    for name, row in rows_tower.items():
        print(f"  {name}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound'][0]:.4f} ms "
              f"({row['bound'][1]}), "
              + (f"max |d| {row['err']:.3g} of sum |w||x| (per launch)"
                 if name.startswith("tower_conv")
                 else "equal to the plain version bit for bit"))

    # --- phase 3b: the Middlebury paths' kernels at 1000x1500, D=200 ------
    # (hm, wm, dm: the -a time shape) on the inputs phase 7's mb fast and
    # mb slow give them: seeded random weights at mb's widths on phase 7's
    # textured pair. Each against its plain version with the tolerance of
    # its KITTI check above; the sweeps and the 16-bit stores bit for bit.
    # Their times print as rows of their own: the kernels' JSON line keeps
    # the KITTI rows.
    t3b = time.perf_counter()
    rows_mb = {}
    m0, m1 = kitti_pair(np.random.RandomState(3), hm, wm, MB_SHIFT)
    m0_, m1_ = (torch.as_tensor(v, device=dev) for v in (m0, m1))
    mimages = torch.stack([m0_, m1_])[:, None]
    mfcfg = make_config("mb", "fast", a="predict")
    mtower = towers.init_fast(mfcfg, mfcfg.seed).to(dev)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        mfeats = mtower(mimages)
    mfl, mfr = mfeats[0].permute(1, 2, 0), mfeats[1].permute(1, 2, 0)
    # the subpixel and median kernels (mb has no outlier stage) on the mb
    # fast path's own map and volume
    print(f"phase 3b: the refinement kernels at {hm}x{wm}, D={dm}")
    rows_mb.update(refine_rows(torch, capture_refine(
        torch, lambda: stereo_predict(mfcfg, mtower, m0_, m1_, dm)),
        f"at {hm}x{wm}, D={dm}"))
    t_tower = time.perf_counter()
    # the towers' kernels on mb fast's convolution outputs: -a predict in
    # float32 (both sides' operands) and -a time with -dtype bfloat16 (the
    # left side's)
    seen = capture_tower(torch, lambda: stereo_predict(
        mfcfg, mtower, m0_, m1_, dm))
    seen.update(capture_tower(torch, lambda: stereo_predict(
        make_config("mb", "fast", a="time", dtype="bfloat16"), mtower, m0_,
        m1_, dm)))
    rows_mb.update({f"{k} (fast)": v for k, v in tower_rows(
        torch, seen, f"mb fast at {hm}x{wm}").items()})
    del seen
    for dt in ("float32", "bfloat16"):
        rows_mb[f"tower_conv mb fast ({dt})"] = conv_row(
            torch, capture_convs(torch, lambda dt=dt: stereo_predict(
                make_config("mb", "fast", a="predict", dtype=dt), mtower,
                m0_, m1_, dm)), f"mb fast at {hm}x{wm}", reps=5)
    torch.cuda.empty_cache()
    tower_secs = time.perf_counter() - t_tower
    # the cost volumes and the HWD tables at the mb shape: mb census's and
    # mb ad's volumes (-a time), mb fast's tables of both directions
    mseen = {}
    for run in (lambda: stereo_predict(make_config("mb", "census", a="time"),
                                       None, m0_, m1_, dm),
                lambda: stereo_predict(make_config("mb", "ad", a="time"),
                                       None, m0_, m1_, dm),
                lambda: stereo_predict(mfcfg, mtower, m0_, m1_, dm)):
        mseen.update(capture_costs(torch, run))
    rows_mb.update(cost_rows(torch, mseen, f"at {hm}x{wm}, D={dm}"))
    del mtower, mfeats, mseen
    Cm = mfl.shape[-1]
    Hq, Wq, Dq = join.pad_dims(hm, wm, dm)
    nfm = (mfcfg.ws - 1) // 2
    # the left side, the only one of -a time: x-flipped maps
    ja = join._prep(mfl, True, Hq, Wq)
    jb = join._prep(mfr, True, Hq, Wq + Dq)
    mvol_l = join._join_plus(ja, jb, dm, wm, hm, nfm)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = join.join_plus_plain(ja, jb, dm, wm, hm, nfm)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    check(torch.equal(mvol_l.isnan(), want.isnan()), "mb join NaN masks differ")
    err = float((mvol_l - want).nan_to_num().abs().max())
    check(err <= 1e-5, f"mb join max |d| {err} > 1e-5")
    del want
    mcells = cells_of(dm, hm, wm)
    rows_mb["join (f32 storage)"] = dict(
        err=err, plain_ms=plain_ms,
        ms=cuda_ms(torch, lambda: join._join_plus(ja, jb, dm, wm, hm, nfm), 10),
        bound=bound_ms((2 * hm * wm * Cm + mcells) * 4, 6 * 2.0 * mcells * Cm,
                       BF16_TC_OPS))
    print(f"phase 3b: join at {hm}x{wm}, D={dm} (padded to {Hq}x{Wq}x{Dq}), "
          f"C={Cm}: max |d| {err:.3g} against the f32 sum")
    for dt, row in join_stores(ja, jb, mvol_l, dm, wm, hm, nfm, 150,
                               f"at {hm}x{wm}, D={dm}").items():
        rows_mb[f"join ({DT_NAME[dt]} storage)"] = row
    del ja, jb
    mvol_r = join.stereo_join_hwd(mfl, mfr, dm, n_fix=nfm)[1]
    del mfl, mfr

    def hwd_chain(what, vol, plan, write_last):
        """The four sweeps of one direction chained as ``sgm_slab_hwd``
        runs them on the path: the first writes the accumulator, the
        others add into it in place, the last fuses the WTA and writes
        the volume unless ``write_last`` is false (the right direction's
        last sweep). Kernel against the plain loop on the same tensors at
        every sweep, bit for bit (volume with its NaN mask, winner map).
        Returns {entry: (ms, plain ms)} of the second sweep of each
        family, the one timed at KITTI size."""
        hp, wp = vol.shape[:2]
        acc_k = acc_p = None
        times = {}
        for i, p in enumerate(plan):
            p = dict(p)
            d1, g = p.pop("d1"), p.pop("g")
            last = i == len(plan) - 1
            entry = "sgm_vertical" if p["vertical"] else "sgm_horizontal"
            write = write_last or not last
            res = []
            for sweep, acc in ((sgm._sweep, acc_k), (sgm.sweep_plain, acc_p)):
                out = torch.empty_like(vol) if acc is None else acc
                w = torch.empty((hp, wp), device=dev) if last else None
                torch.cuda.synchronize()
                t = time.perf_counter()
                sweep(vol, acc, out if write else None, w, d1, g, **p)
                torch.cuda.synchronize()
                res.append((out, w, (time.perf_counter() - t) * 1e3))
            (acc_k, w_k, _), (acc_p, w_p, plain_ms) = res
            check(acc_k.dtype == vol.dtype and identical(acc_k, acc_p),
                  f"{what} sweep {i} ({entry}): volumes differ")
            if last:
                check(torch.equal(w_k, w_p), f"{what}: winner maps differ")
            if i in (1, 3):
                scratch = acc_k.clone()
                times[entry] = (cuda_ms(torch, lambda: sgm._sweep(
                    vol, scratch, scratch if write else None, w, d1, g, **p),
                    5), plain_ms)
                del scratch
            del res
        return times, w_k

    mkw = dict(pi1=mfcfg.pi1, pi2=mfcfg.pi2, tau_so=mfcfg.tau_so,
               alpha1=mfcfg.alpha1, q1=mfcfg.sgm_q1, q2=mfcfg.sgm_q2)
    mtables = (hm * wm + hm * (wm + 2 * dm)) * 4
    for xrev, vol32 in ((True, mvol_l), (False, mvol_r)):
        side = "left" if xrev else "right"
        mplan = sgm.sweep_plan(m0_, m1_, dm, hm, wm, vol32.shape, xrev=xrev,
                               **mkw)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            vol = vol32 if dt == torch.float32 else vol32.to(dt)
            times, wmap = hwd_chain(f"mb {side} {DT_NAME[dt]}", vol, mplan,
                                    write_last=xrev)
            if xrev:
                elem = vol.element_size()
                for entry, (ms, plain_ms) in times.items():
                    last = entry == "sgm_horizontal"
                    rows_mb[f"{entry} ({DT_NAME[dt]} storage)"] = dict(
                        err=0.0, ms=ms, plain_ms=plain_ms,
                        bound=bound_ms(3 * mcells * elem + mtables
                                       + (hm * wm * 4 if last else 0),
                                       10.0 * mcells))
            if xrev and dt == torch.float32:
                # the fast path's blur runs on this winner map, the x-flipped
                # left map as the path makes it
                fast_map = wmap[:hm, :wm].flip(1).contiguous()
            del vol, wmap
        del mplan
    del mvol_l, mvol_r, vol32
    print("  sgm_vertical, sgm_horizontal at the mb shape, f32, bf16 and f16, "
          "left (-a time; every sweep writes) and right (the last sweep "
          "without the volume write): bit-identical to the plain loop at "
          "every sweep (volume and winner map)")
    rows_mb["blur (mb fast)"] = blur_row(fast_map, mfcfg.blur_sigma,
                                         mfcfg.blur_t)
    del fast_map

    # mb slow: its head over the whole volume, its blur, and the generic
    # lane's two stacked families with the -1 direction alone (-a time)
    mscfg = make_config("mb", "slow", a="time")
    msnet = towers.init_slow(mscfg, mscfg.seed).to(dev).eval()
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        msf = msnet(mimages)
    mops = slow_head.head_operands(msnet, msf[0].permute(1, 2, 0),
                                   msf[1].permute(1, 2, 0))
    # the bias kernel on mb slow's convolution outputs (one -a time run)
    t_tower = time.perf_counter()
    seen = capture_tower(torch, lambda: stereo_predict(
        mscfg, msnet, m0_, m1_, dm))
    rows_mb.update({f"{k} (slow)": v for k, v in tower_rows(
        torch, seen, f"mb slow at {hm}x{wm}").items()})
    del seen
    for dt in ("float32", "bfloat16"):
        rows_mb[f"tower_conv mb slow ({dt})"] = conv_row(
            torch, capture_convs(torch, lambda dt=dt: stereo_predict(
                make_config("mb", "slow", a="time", dtype=dt), msnet, m0_,
                m1_, dm)), f"mb slow at {hm}x{wm}", reps=3)
    torch.cuda.empty_cache()
    del msf, msnet
    tower_secs += time.perf_counter() - t_tower
    s_k = slow_head.slow_head_volume(*mops, dm)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s_p = slow_head.slow_head_plain(*mops, dm)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    xs = torch.arange(wm, device=dev)[None, None, :]
    ds = torch.arange(dm, device=dev)[:, None, None]
    valid = (xs >= ds).expand(dm, hm, wm)
    diff = (s_k - s_p).abs()[valid]
    err, mean_err = float(diff.max()), float(diff.mean())
    del diff, s_p, valid
    print(f"  slow_head at {hm}x{wm}, D={dm} ({mops[2].shape[0]} mid layers, "
          f"{mops[0].shape[-1]} wide) over the cells with x >= d: max |d| "
          f"{err:.3g}, mean |d| {mean_err:.3g}")
    check(err <= 1e-3 and mean_err <= 1e-5,
          f"mb slow_head max |d| {err} > 1e-3 or mean |d| {mean_err} > 1e-5")
    A_, B_, mw_ = mops[:3]
    mhead_cells = float(hm * sum(max(0, wm - d) for d in range(dm)))
    rows_mb["slow_head"] = dict(
        err=err, plain_ms=plain_ms,
        ms=cuda_ms(torch, lambda: slow_head.slow_head_volume(*mops, dm), 2),
        bound=bound_ms((A_.numel() + B_.numel() + s_k.numel()) * 4
                       + mw_.numel() * 2,
                       2.0 * mhead_cells * mw_.shape[0] * mw_.shape[1]
                       * mw_.shape[2], BF16_TC_OPS))
    del A_, B_, mw_, mops
    mvols = {-1: slow_head.masked_volumes(s_k)[0]}
    t_tower = time.perf_counter()
    rows_mb.update({f"{k} (slow)": v for k, v in epilogue_rows(
        torch, s_k, (mscfg.ws - 1) // 2, 150,
        f"mb slow at {hm}x{wm}, D={dm}").items()})
    tower_secs += time.perf_counter() - t_tower
    print(f"  the tower kernels' checks at the mb shape took {tower_secs:.0f} s")
    del s_k
    # CBCA at mb slow's K = 14 on that volume, the -1 direction (-a time),
    # with the pair's arms; the arms kernel at K = 14
    m0c, m1c = (cross.cross_arms(m, mscfg.L1, mscfg.tau1) for m in (m0_, m1_))
    rows_mb.update(cbca_rows(torch, {("cbca", -1): (
        (m0c, m1c, mvols[-1], -1, mscfg.L1), {})}, f"at {hm}x{wm}, D={dm}"))
    rows_mb.update(arms_rows(torch, m0_, f"at {hm}x{wm}", ks=(14,)))
    del m0c, m1c
    rows_mb["blur (mb slow)"] = blur_row(costs.wta(mvols[-1]),
                                         mscfg.blur_sigma, mscfg.blur_t)
    mskw = dict(pi1=mscfg.pi1, pi2=mscfg.pi2, tau_so=mscfg.tau_so,
                q1=mscfg.sgm_q1, q2=mscfg.sgm_q2)
    vol_x, hplan = sgm.horiz_plan(m0_, m1_, mvols, (-1,), dm, hm, wm, **mskw)
    rows_mb["sgm_hslab"] = stacked_family(
        "sgm_hslab (mb)", vol_x, hplan, sgm._sweep_hslab, sgm.hslab_plain,
        (hm * wm + hm * (wm + 2 * dm)) * 4, n=mcells)
    del vol_x, hplan
    vol_y, vplan = sgm.vert_plan(m0_, m1_, mvols, (-1,), dm, hm, wm,
                                 alpha1=mscfg.alpha1, **mskw)
    rows_mb["sgm_vertical (mb slow, stacked)"] = stacked_family(
        "sgm_vertical (mb)", vol_y, vplan,
        lambda v, a, o, d1, g, **p: sgm._sweep(v, a, o, None, d1, g, **p),
        lambda v, a, o, d1, g, **p: sgm.sweep_plain(v, a, o, None, d1, g, **p),
        (hm * wm + 2 * hm * (wm + 2 * dm)) * 4, n=mcells)
    del vol_y, vplan
    print("  sgm_hslab, sgm_vertical (stacked, the -1 direction) at the mb "
          "shape: bit-identical to the plain loop")
    # the layout kernels on one SGM iteration of that volume (the -1
    # direction, slab form) and its winner-take-all, as mb slow runs them
    seen = capture_layout(torch, lambda: costs.wta(sgm.sgm_multi(
        m0_, m1_, mvols, form="slab", quarter=True, alpha1=mscfg.alpha1,
        pi1=mscfg.pi1, pi2=mscfg.pi2, tau_so=mscfg.tau_so,
        sgm_q1=mscfg.sgm_q1, sgm_q2=mscfg.sgm_q2)[-1]))
    rows_mb.update(layout_rows(torch, seen, f"mb slow at {hm}x{wm}, D={dm}"))
    del seen, mvols, mimages
    for name, row in rows_mb.items():
        plain = ("" if row["plain_ms"] is None
                 else f", plain {row['plain_ms']:.3f} ms")
        print(f"  mb {name}: kernel {row['ms']:.4f} ms{plain}, bound "
              f"{row['bound'][0]:.4f} ms ({row['bound'][1]}), max |d| "
              f"{row['err']:.3g}")
    torch.cuda.empty_cache()
    print(f"  phase 3b took {time.perf_counter() - t3b:.0f} s")

    # --- phase 4: the main path ----------------------------------------
    _build.reset_launches()
    disp = stereo_predict(cfg, tower, x0, x1, D)
    torch.cuda.synchronize()
    counts, kcounts = _build.launches(), _build.kernel_launches()
    print(f"phase 4: launches in one stereo_predict: {counts}")
    want = dict.fromkeys(_build.KERNELS, 0)
    want.update(join=2, sgm_tables=2, sgm_vertical=4, sgm_horizontal=4,
                outlier=1, blur=1, **REFINE_KITTI, **tower_counts(cfg))
    check(counts == want, f"launch counts {counts}, expected {want}")
    fast_sha = same_as_plain_route(
        torch, "kitti fast", lambda: stereo_predict(cfg, tower, x0, x1, D),
        disp)
    moved_from_cudnn(torch, "kitti fast",
                     lambda: stereo_predict(cfg, tower, x0, x1, D), disp)
    # the tables' plain build alone issues 188 launches
    check_plain_launches(torch, "kitti fast",
                         lambda: stereo_predict(cfg, tower, x0, x1, D), 64)
    d = disp.cpu().numpy()
    check(d.shape == (H, W) and bool(np.isfinite(d).all()),
          "disparity map not finite or misshaped")
    good = float((np.abs(d[:, SHIFT + 8:] - SHIFT) <= 1.0).mean())
    print(f"  pixels within 1 px of the true disparity {SHIFT}: {good:.4f}")
    check(good >= 0.9, f"only {good:.4f} of pixels within 1 px")

    def pairs_per_s(p0, p1, c=cfg):
        t0_, t1_ = (torch.as_tensor(v, device=dev) for v in (p0, p1))
        return timed(torch, lambda: stereo_predict(c, tower, t0_, t1_, D), 10)

    torch.cuda.reset_peak_memory_stats()
    pps_a, times_a = pairs_per_s(x0, x1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    base = np.random.RandomState(42).randn(350, 1242 + D).astype(np.float32)
    pps_b, times_b = pairs_per_s(base[:, D:], base[:, :-D])
    print(f"  370x1226: {pps_a:.3f} pairs/s (median of 10; runs "
          f"{times_a} ms), peak {peak:.2f} GiB")
    print(f"  350x1242 (bench pair): {pps_b:.3f} pairs/s (median of 10; runs "
          f"{times_b} ms)")

    t = time.perf_counter()
    d_plain = stereo_predict(cfg, tower, x0, x1, D, device="cpu").numpy()
    frac = float((np.abs(d - d_plain) > 0.51).mean())
    print(f"  kernel path vs all-plain path (CPU, {time.perf_counter() - t:.0f} s):"
          f" {frac:.5f} of pixels differ by > 0.51")
    check(frac < 0.01, f"{frac} of pixels differ from the plain path")

    # --- phase 4b: the fast path with 16-bit volumes and bf16 compute ---
    d32 = d
    fast_want = want
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    pairs_per_s(x0, x1)
    print(f"phase 4b: kitti fast float32: {peak_line(torch, held)}")
    for flag, over in (("-vol_dtype bfloat16", dict(vol_dtype="bfloat16")),
                       ("-vol_dtype float16", dict(vol_dtype="float16")),
                       ("-dtype bfloat16", dict(dtype="bfloat16"))):
        c16 = make_config("kitti", "fast", a="predict", **over)
        _build.reset_launches()
        d16 = stereo_predict(c16, tower, x0, x1, D)
        torch.cuda.synchronize()
        got = _build.launches()
        print(f"phase 4b: kitti fast {flag}: launches in one stereo_predict: "
              f"{got}")
        check(got == fast_want, f"{flag}: launch counts {got}, expected "
              f"{fast_want}")
        moved_from_cudnn(torch, f"kitti fast {flag}",
                         lambda c16=c16: stereo_predict(c16, tower, x0, x1, D),
                         d16)
        d16 = d16.cpu().numpy()
        check(d16.shape == (H, W) and bool(np.isfinite(d16).all()),
              f"{flag}: disparity map not finite or misshaped")
        moved = float((np.abs(d16 - d32) > 1.0).mean())
        mad = float(np.abs(d16 - d32).mean())
        good = float((np.abs(d16[:, SHIFT + 8:] - SHIFT) <= 1.0).mean())
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        pps, times = pairs_per_s(x0, x1, c16)
        print(f"  {flag}: {moved:.5f} of pixels moved by > 1 px against the "
              f"float32 run (mean |d| {mad:.5f}); {good:.4f} within 1 px of "
              f"the true disparity; {pps:.3f} pairs/s (median of 10; "
              f"{spread(times)}), {peak_line(torch, held)}")
        # the bounds of the JAX package's 16-bit test on noise input
        check(moved < 0.15 and mad < 1.0, f"{flag}: moved {moved}, mean |d| "
              f"{mad} against the float32 run")
        check(good >= 0.9, f"{flag}: only {good:.4f} within 1 px")

    # --- phase 5: the slow-arch path ----------------------------------
    hand = matching_head(towers.init_slow(scfg, scfg.seed).to(dev),
                         sfeats)
    del sfeats
    _build.reset_launches()
    disp = stereo_predict(scfg, hand, x0, x1, D)
    torch.cuda.synchronize()
    slow_counts, slow_kcounts = _build.launches(), _build.kernel_launches()
    print(f"phase 5: launches in one slow stereo_predict: {slow_counts}")
    want = dict.fromkeys(_build.KERNELS, 0)
    want.update(sgm_vertical=2, outlier=1, blur=1, slow_head=1, sgm_hslab=2,
                **cbca_counts(scfg, 2), **layout_counts(2), **REFINE_KITTI,
                **tower_counts(scfg))
    check(slow_counts == want, f"launch counts {slow_counts}, expected {want}")
    slow_sha = same_as_plain_route(
        torch, "kitti slow", lambda: stereo_predict(scfg, hand, x0, x1, D),
        disp)
    moved_from_cudnn(torch, "kitti slow",
                     lambda: stereo_predict(scfg, hand, x0, x1, D), disp)
    d = slow_map = disp.cpu().numpy()
    check(d.shape == (H, W) and bool(np.isfinite(d).all()),
          "slow disparity map not finite or misshaped")
    good = float((np.abs(d[:, SHIFT + 8:] - SHIFT) <= 1.0).mean())
    print(f"  pixels within 1 px of the true disparity {SHIFT} (head set by "
          f"hand to score L1 distance): {good:.4f}")
    check(good >= 0.9, f"slow path: only {good:.4f} of pixels within 1 px")

    t0_, t1_ = (torch.as_tensor(v, device=dev) for v in (x0, x1))
    stereo_predict(scfg, snet, t0_, t1_, D)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        stereo_predict(scfg, snet, t0_, t1_, D)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  slow 370x1226: {1.0 / statistics.median(times):.4f} pairs/s "
          f"(median of 5, seeded random weights; runs "
          f"{[round(t * 1e3, 1) for t in times]} ms), peak {peak:.2f} GiB")

    h, w, dd = 96, 320, 48
    s0, s1 = kitti_pair(np.random.RandomState(1), h, w, 12)
    t = time.perf_counter()
    d_k = stereo_predict(scfg, hand, s0, s1, dd).cpu().numpy()
    d_plain = stereo_predict(scfg, hand, s0, s1, dd, device="cpu").numpy()
    frac = float((np.abs(d_k - d_plain) > 0.51).mean())
    print(f"  slow kernel path vs all-plain path (CPU) at {h}x{w}, D={dd} "
          f"({time.perf_counter() - t:.0f} s): {frac:.5f} of pixels differ "
          f"by > 0.51")
    check(frac < 0.01, f"slow path: {frac} of pixels differ from the plain path")

    # --- phase 6: the census and ad paths, and fast with CBCA -----------
    del snet
    torch.cuda.empty_cache()
    sweeps_of = {"slab": dict(sgm_hslab=2, sgm_vertical=2),
                 "stream": dict(sgm_scan=4), "grid": dict(sgm_step=4)}

    def generic_path(what, gcfg, net, form):
        """One ``stereo_predict`` on the generic lane in an SGM form:
        its launch counts, the map checked against the true disparity
        unless the network is random, then pairs/s and peak memory.
        Returns (counts, map, final volumes)."""
        _build.reset_launches()
        d_t, vl, vr = stereo_predict(gcfg, net, t0_, t1_, D, return_vols=True,
                                     sgm_form=form)
        torch.cuda.synchronize()
        got, got_k = _build.launches(), _build.kernel_launches()
        want = dict.fromkeys(_build.KERNELS, 0)
        want.update(outlier=1, blur=1, join=0 if net is None else 2,
                    **sweeps_of[form], **cbca_counts(gcfg, 2),
                    **layout_counts(2, form), **COSTS.get(gcfg.arch, {}),
                    **REFINE_KITTI, **tower_counts(gcfg))
        print(f"phase 6: launches in one {what} stereo_predict, form {form}: "
              f"{got}, kernel launches of sgm_step {got_k['sgm_step']}")
        check(got == want, f"{what} {form}: launch counts {got}, expected {want}")
        # every entry launches its kernel once a call (the join once a
        # slab of 64 channels: once for the fast net's 64)
        check(got_k == want, f"{what} {form}: kernel launches {got_k}, "
              f"expected {want}")
        d = d_t.cpu().numpy()
        check(d.shape == (H, W) and bool(np.isfinite(d).all()),
              f"{what} {form}: disparity map not finite or misshaped")
        if net is None:
            good = float((np.abs(d[:, SHIFT + 8:] - SHIFT) <= 1.0).mean())
            print(f"  pixels within 1 px of the true disparity {SHIFT}: "
                  f"{good:.4f}")
            check(good >= 0.9, f"{what} {form}: only {good:.4f} within 1 px")
        stereo_predict(gcfg, net, t0_, t1_, D, sgm_form=form)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            stereo_predict(gcfg, net, t0_, t1_, D, sgm_form=form)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  {what} 370x1226, form {form}: "
              f"{1.0 / statistics.median(times):.4f} pairs/s (median of 5; runs "
              f"{[round(t * 1e3, 1) for t in times]} ms), peak {peak:.2f} GiB")
        return (got, got_k), d_t, (vl, vr)

    scan_counts = {}
    ref = None
    for form in ("slab", "stream", "grid"):
        got, d_t, vols_f = generic_path("census", ccfg, None, form)
        scan_counts[form] = got
        if ref is None:
            ref = (d_t, vols_f)
            census_sha = same_as_plain_route(
                torch, "kitti census (slab form)",
                lambda: stereo_predict(ccfg, None, t0_, t1_, D), d_t)
            # with the generic lane's layouts, tables, sum and WTA on
            # their kernels it issued none (the parent's issued 125)
            check_plain_launches(
                torch, "kitti census (slab form)",
                lambda: stereo_predict(ccfg, None, t0_, t1_, D), 5)
            continue
        check(torch.equal(d_t, ref[0]), f"census map of form {form} differs "
              "from the slab form's")
        for a, b in zip(vols_f, ref[1]):
            check(torch.equal(a.isnan(), b.isnan())
                  and torch.equal(a.nan_to_num(), b.nan_to_num()),
                  f"census final volume of form {form} differs from the slab "
                  "form's")
        del d_t, vols_f
    print("  census: the three forms' maps and final volumes are equal")
    del ref
    acfg = make_config("kitti", "ad", a="predict")
    ad_counts, d_t, _ = generic_path("ad", acfg, None, "stream")
    ad_sha = same_as_plain_route(
        torch, "kitti ad (stream form)",
        lambda: stereo_predict(acfg, None, t0_, t1_, D, sgm_form="stream"),
        d_t)
    # the scan form's plans stay plain: 122 launches
    check_plain_launches(
        torch, "kitti ad (stream form)",
        lambda: stereo_predict(acfg, None, t0_, t1_, D, sgm_form="stream"),
        130)
    del d_t
    fcfg = make_config("kitti", "fast", a="predict", cbca_i1=2, L1=5,
                       tau1=0.13)
    _, d_t, _ = generic_path("fast with CBCA", fcfg, tower, "slab")
    cbca_sha = same_as_plain_route(
        torch, "kitti fast with CBCA (slab form)",
        lambda: stereo_predict(fcfg, tower, t0_, t1_, D), d_t)
    moved_from_cudnn(torch, "kitti fast with CBCA (slab form)",
                     lambda: stereo_predict(fcfg, tower, t0_, t1_, D), d_t)
    del d_t

    for what, gcfg, net in (("census", ccfg, None),
                            ("fast with CBCA", fcfg, tower)):
        t = time.perf_counter()
        d_k = stereo_predict(gcfg, net, s0, s1, dd).cpu().numpy()
        d_plain = stereo_predict(gcfg, net, s0, s1, dd, device="cpu").numpy()
        frac = float((np.abs(d_k - d_plain) > 0.51).mean())
        print(f"  {what} kernel path vs all-plain path (CPU) at {h}x{w}, "
              f"D={dd} ({time.perf_counter() - t:.0f} s): {frac:.5f} of pixels "
              f"differ by > 0.51")
        check(frac < 0.01, f"{what}: {frac} of pixels differ from the plain "
              "path")

    # --- phase 7: Middlebury at the -a time shape --------------------------
    # (mccnn_tpu_torch/cli.py): 1000x1500, D=200, on a seeded textured pair
    # of true disparity MB_SHIFT; mb has no outlier stage
    # (phase 3b's pair)
    torch.cuda.empty_cache()
    t7 = time.perf_counter()

    def mb_path(what, mcfg, net, want_mb, runs):
        """One ``stereo_predict`` at the Middlebury shape: launch counts,
        the map checked against the true disparity, then pairs/s (median
        of ``runs`` after a warm-up, with the spread) and the peak
        memory of those runs."""
        _build.reset_launches()
        d_m = stereo_predict(mcfg, net, m0_, m1_, dm)
        torch.cuda.synchronize()
        got = _build.launches()
        print(f"phase 7: launches in one {what} stereo_predict at {hm}x{wm}, "
              f"D={dm}: {got}")
        want = dict.fromkeys(_build.KERNELS, 0)
        want.update(want_mb)
        check(got == want, f"{what}: launch counts {got}, expected {want}")
        d_m = d_m.cpu().numpy()
        check(d_m.shape == (hm, wm) and bool(np.isfinite(d_m).all()),
              f"{what}: disparity map not finite or misshaped")
        good = float((np.abs(d_m[:, MB_SHIFT + 8:] - MB_SHIFT) <= 1.0).mean())
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        pps, times = timed(torch, lambda: stereo_predict(mcfg, net, m0_, m1_,
                                                         dm), runs, warm=1)
        print(f"  {what}: {good:.4f} of pixels within 1 px of the true "
              f"disparity {MB_SHIFT}; {pps:.4f} pairs/s (median of {runs}; "
              f"{spread(times)}), {peak_line(torch, held)}")
        check(good >= 0.9, f"{what}: only {good:.4f} within 1 px")

    mcfg_t = make_config("mb", "fast", a="time")
    mtower = towers.init_fast(mcfg_t, mcfg_t.seed).to(dev)
    mb_shas = {}
    for what, mcfg, want_mb in (
            ("mb fast -a time (left direction)", mcfg_t,
             dict(join=1, sgm_tables=1, sgm_vertical=2, sgm_horizontal=2,
                  blur=1, **REFINE_MB, **tower_counts(mcfg_t))),
            ("mb fast -a predict (both directions)",
             make_config("mb", "fast", a="predict"),
             dict(join=2, sgm_tables=2, sgm_vertical=4, sgm_horizontal=4,
                  blur=1, **REFINE_MB, **tower_counts(mcfg_t)))):
        mb_path(what, mcfg, mtower, want_mb, 10)
        run = (lambda c=mcfg: stereo_predict(c, mtower, m0_, m1_, dm))
        d_m = run()
        mb_shas[what] = same_as_plain_route(torch, what, run, d_m)
        moved_from_cudnn(torch, what, run, d_m)
    mscfg = make_config("mb", "slow", a="time")
    mhand = towers.init_slow(mscfg, mscfg.seed).to(dev).eval()
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        mfeats = mhand(torch.stack([m0_, m1_])[:, None])
    matching_head(mhand, mfeats)
    del mfeats
    what = "mb slow -a time (left direction, head set by hand)"
    mb_path(what, mscfg, mhand,
            dict(slow_head=1, sgm_hslab=2, sgm_vertical=2, blur=1,
                 **cbca_counts(mscfg, 1), **layout_counts(1), **REFINE_MB,
                 **tower_counts(mscfg)), 3)
    run = (lambda: stereo_predict(mscfg, mhand, m0_, m1_, dm))
    d_m = run()
    mb_shas[what] = same_as_plain_route(torch, what, run, d_m)
    moved_from_cudnn(torch, what, run, d_m)

    # the all-plain comparison at 96x320, D=48 with mb's own parameters
    for what, mcfg, net in (("mb fast", mcfg_t, mtower),
                            ("mb slow", mscfg, mhand)):
        t = time.perf_counter()
        d_k = stereo_predict(mcfg, net, s0, s1, dd).cpu().numpy()
        d_plain = stereo_predict(mcfg, net, s0, s1, dd, device="cpu").numpy()
        frac = float((np.abs(d_k - d_plain) > 0.51).mean())
        print(f"  {what} kernel path vs all-plain path (CPU) at {h}x{w}, "
              f"D={dd} ({time.perf_counter() - t:.0f} s): {frac:.5f} of pixels "
              f"differ by > 0.51")
        check(frac < 0.01, f"{what}: {frac} of pixels differ from the plain "
              "path")
    del mtower, mhand, m0_, m1_
    print(f"  phase 7 took {time.perf_counter() - t7:.0f} s")

    # --- phase 8: training on the card -----------------------------------
    torch.cuda.empty_cache()
    rows["warp_patches"], warp_launches = training_phase(torch, dev,
                                                         fast_want)

    # --- phase 9: seeded init, .t7 nets, the volume cache, the host gather,
    # the preprocess script ------------------------------------------------
    torch.cuda.empty_cache()
    cache_phase(torch, dev, x0, x1, fast_want, slow_counts)

    # --- phase 10: the mesh: batch lanes, row-sharded pairs, the DP step --
    torch.cuda.empty_cache()
    parallel_phase(torch, dev, x0, x1,
                   (cfg, tower, d32, fast_want, pps_a, times_a),
                   (scfg, hand, slow_map, slow_counts))

    # --- phase 11: the experiment drivers, each child the port's CLI -------
    torch.cuda.empty_cache()
    drivers_phase(torch, hand, n_te=opts.te)

    # launches: each kernel's count on the path that runs it (entry
    # calls, and the kernel launches they made); the three shared ones
    # (vertical sweep, outlier, blur) are the fast path's
    path_counts, path_kcounts = (
        dict(fast, slow_head=slow["slow_head"], sgm_hslab=slow["sgm_hslab"],
             sgm_scan=stream["sgm_scan"], sgm_step=grid["sgm_step"],
             cbca=slow["cbca"], cross_arms=slow["cross_arms"],
             cbca_pack=slow["cbca_pack"],
             census_signatures=census["census_signatures"],
             census_volume=census["census_volume"],
             ad_volume=ad["ad_volume"], sgm_layout=census["sgm_layout"],
             sgm_generic_tables=census["sgm_generic_tables"],
             sgm_combine=census["sgm_combine"], wta_dhw=census["wta_dhw"],
             slow_volumes_epilogue=slow["slow_volumes_epilogue"],
             warp_patches=warp_launches)
        for fast, slow, stream, grid, census, ad in zip(
            (counts, kcounts), (slow_counts, slow_kcounts),
            scan_counts["stream"], scan_counts["grid"], scan_counts["slab"],
            ad_counts))
    sources = {"join": ("join.cu", "mccnn_tpu/ops/join_pallas.py:65"),
               "sgm_vertical": ("sgm_sweep.cu", "mccnn_tpu/ops/sgm.py:741"),
               "sgm_horizontal": ("sgm_sweep.cu", "mccnn_tpu/ops/sgm.py:462"),
               "outlier": ("outlier.cu", "mccnn_tpu/ops/outlier_pallas.py:32"),
               "blur": ("blur.cu", "mccnn_tpu/ops/blur_pallas.py:56"),
               "slow_head": ("slow_head.cu",
                             "mccnn_tpu/ops/slow_head_pallas.py:62"),
               "sgm_hslab": ("sgm_sweep.cu", "mccnn_tpu/ops/sgm.py:267"),
               "sgm_scan": ("sgm_sweep.cu", "mccnn_tpu/ops/sgm.py:157"),
               "sgm_step": ("sgm_sweep.cu", "mccnn_tpu/ops/sgm.py:1005"),
               # stages the JAX package leaves to XLA: the functions
               "occlusion_fill": ("refine.cu", "mccnn_tpu/ops/post.py:68"),
               "mismatch_fill": ("refine.cu", "mccnn_tpu/ops/post.py:122"),
               "subpixel": ("refine.cu", "mccnn_tpu/ops/post.py:378"),
               "median5": ("refine.cu", "mccnn_tpu/ops/post.py:270"),
               "cbca": ("cross.cu", "mccnn_tpu/ops/cross.py:69"),
               "cross_arms": ("cross.cu", "mccnn_tpu/ops/cross.py:20"),
               "cbca_pack": ("cross.cu", "mccnn_tpu/ops/cross.py:69"),
               "census_signatures": ("costs.cu", "mccnn_tpu/ops/costs.py:72"),
               "census_volume": ("costs.cu", "mccnn_tpu/ops/costs.py:103"),
               "ad_volume": ("costs.cu", "mccnn_tpu/ops/costs.py:49"),
               "sgm_tables": ("sgm_tables.cu",
                              "mccnn_tpu/ops/sgm.py:1237"),
               "sgm_layout": ("sgm_layout.cu", "mccnn_tpu/ops/sgm.py:1149"),
               "sgm_generic_tables": ("sgm_layout.cu",
                                      "mccnn_tpu/ops/sgm.py:1156"),
               "sgm_combine": ("sgm_layout.cu", "mccnn_tpu/ops/sgm.py:1234"),
               "wta_dhw": ("sgm_layout.cu", "mccnn_tpu/ops/costs.py:197"),
               "tower_bias_act": ("tower.cu", "mccnn_tpu/models/towers.py:84"),
               "tower_normalize_pack": ("tower.cu",
                                        "mccnn_tpu/models/towers.py:96"),
               "slow_volumes_epilogue": ("tower.cu",
                                         "mccnn_tpu/ops/slow_head_pallas.py:218"),
               "warp_patches": ("warp.cu", "mccnn_tpu/train/augment.py:90"),
               "tower_conv": ("conv.cu", "mccnn_tpu/models/towers.py:84")}
    print(f"map sha256: kitti fast {fast_sha}, kitti census {census_sha}, "
          f"kitti ad {ad_sha}, kitti slow {slow_sha}, kitti fast with CBCA "
          f"{cbca_sha}, "
          + ", ".join(f"{k} {v}" for k, v in mb_shas.items()))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.0f} s, the build included")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"mccnn_tpu_torch/csrc/{sources[name][0]}",
         "replaces": sources[name][1], "launches": path_counts[name],
         "kernel_launches": path_kcounts[name],
         "max_abs_err": rows[name]["err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound"][0],
         "bound_by": rows[name]["bound"][1], "bound_peak": rows[name]["bound"][2],
         "library_ms": rows[name].get("library_ms")}
        for name in _build.KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
