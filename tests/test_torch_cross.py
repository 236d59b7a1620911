"""The port's CBCA (plain torch, on the CPU) against the JAX package's
``ops/cross.py``; a numpy model of the CBCA kernel's index plan
(csrc/cross.cu) against the plain version bit for bit; the wrappers'
CPU dispatch; the kernel's shared-memory footprint at every config's K;
and the operands the generic lane hands to CBCA."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import cross as jcross
from mccnn_tpu_torch import config
from mccnn_tpu_torch.config import make_config
from mccnn_tpu_torch.ops import _build, cross

SRC = (Path(cross.__file__).resolve().parent.parent / "csrc" / "cross.cu"
       ).read_text()

# L1 -> tau1: kitti census (K = 2), kitti ad, kitti slow, mb slow
TAU1 = {0: 0.01, 3: 0.03, 5: 0.13, 14: 0.02}


def _img(seed, H=23, W=57):
    # standardized-looking texture with flat patches, so arms of every
    # length occur
    rng = np.random.RandomState(seed)
    x = rng.randn(H, W).astype(np.float32) * 0.1
    x[5:12, 10:30] = 0.3
    return x


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.int32),
        np.ascontiguousarray(b).view(np.int32))


@pytest.mark.parametrize("L1,tau1", [(0, 0.01), (1, 0.2), (3, 0.03),
                                     (5, 0.13), (14, 0.02)])
def test_cross_arms_exact(L1, tau1):
    """The arms at the K of census (L1 = 0, as 1: K = 2), ad (3), slow
    (5) and mb slow (14), equal to the JAX package's."""
    x = _img(L1)
    got = cross.cross_arms(torch.as_tensor(x), L1, tau1).numpy()
    want = np.asarray(jcross.cross_arms(jnp.asarray(x), L1, tau1))
    assert got.dtype == np.float32 and got.shape == (4, 23, 57)
    assert np.array_equal(got, want)


def _volume(rng, D, H, W, direction):
    """A volume with NaN out-of-frame cells (the slow volumes' masks) and
    scattered NaN inside; and the out-of-frame mask."""
    vol = rng.rand(D, H, W).astype(np.float32)
    xs, ds = np.arange(W)[None, None, :], np.arange(D)[:, None, None]
    oof = np.broadcast_to((xs + ds * direction < 0)
                          | (xs + ds * direction >= W), vol.shape)
    vol[oof] = np.nan
    vol[rng.rand(D, H, W) < 0.05] = np.nan
    return vol, oof


@pytest.mark.parametrize("L1", [0, 3, 5, 14])
@pytest.mark.parametrize("direction", [-1, 1])
def test_cbca_matches_jax_with_nan_cells(direction, L1):
    """The K of census, ad, slow and mb slow, on a volume with NaN
    out-of-frame cells and scattered NaN inside. The same masked adds in
    the same order: rtol 1e-6 for the division's rounding; identical NaN
    masks (out-of-frame cells pass through). Chunked over d (4 per
    chunk) and in one piece, both equal."""
    tau1 = TAU1[L1]
    rng = np.random.RandomState(3 + direction)
    D, H, W = 9, 23, 57
    x0, x1 = _img(1), _img(2)
    vol, oof = _volume(rng, D, H, W, direction)
    j0, j1 = (jcross.cross_arms(jnp.asarray(a), L1, tau1) for a in (x0, x1))
    want = np.asarray(jcross.cbca(j0, j1, jnp.asarray(vol), direction, L1))
    t0, t1 = (cross.cross_arms(torch.as_tensor(a), L1, tau1)
              for a in (x0, x1))
    got = cross.cbca(t0, t1, torch.as_tensor(vol), direction, L1).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[oof]).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    chunked = cross.cbca_plain(t0, t1, torch.as_tensor(vol), direction, L1,
                               chunk_cells=4 * H * W).numpy()
    assert np.array_equal(chunked, got, equal_nan=True)


def _kernel_plan(x0c, x1c, vol, direction, L1):
    """A numpy model of the CBCA kernel's index plan (csrc/cross.cu): for
    each valid cell the columns of each row in the closed interval
    [max(xx_s + 1, x - K + 1, 0), min(xx_t - 1, x + K - 1, W - 1)] added
    in ascending order from +0, the rows likewise, the counts as
    integers, and the float32 quotient; out-of-frame cells pass the
    volume through. Only the active cells of a step add: no masked
    zeros."""
    D, H, W = vol.shape
    R = max(2, int(L1)) - 1
    a0, a1_all = x0c.astype(np.int64), x1c.astype(np.int64)
    vol_z = np.where(np.isnan(vol), np.float32(0), vol)
    ys = np.arange(H)[:, None].repeat(W, 1)
    xs = np.arange(W)[None, :].repeat(H, 0)
    out = vol.copy()
    for d in range(D):
        delta = d * direction
        valid = (xs + delta >= 0) & (xs + delta < W)
        a1 = a1_all[:, ys, np.clip(xs + delta, 0, W - 1)]
        lo = np.maximum(np.maximum(np.maximum(a0[0], a1[0] - delta) + 1,
                                   xs - R), 0)
        hi = np.minimum(np.minimum(np.minimum(a0[1], a1[1] - delta) - 1,
                                   xs + R), W - 1)
        hsum = np.zeros((H, W), np.float32)
        for t in range(2 * R + 1):
            c = lo + t
            on = c <= hi
            hsum[on] = hsum[on] + vol_z[d, ys[on], c[on]]
        hcnt = np.maximum(hi - lo + 1, 0)
        lo = np.maximum(np.maximum(np.maximum(a0[2], a1[2]) + 1, ys - R), 0)
        hi = np.minimum(np.minimum(np.minimum(a0[3], a1[3]) - 1, ys + R),
                        H - 1)
        vsum = np.zeros((H, W), np.float32)
        vcnt = np.zeros((H, W), np.int64)
        for t in range(2 * R + 1):
            r = lo + t
            on = r <= hi
            vsum[on] = vsum[on] + hsum[r[on], xs[on]]
            vcnt[on] += hcnt[r[on], xs[on]]
        agg = vsum / np.maximum(vcnt, 1).astype(np.float32)
        out[d] = np.where(valid, agg, vol[d])
    return out


def _case(L1, direction, seed=0, D=11, H=29, W=61, d_true=8):
    """Arms of a textured pair and a volume with NaN cells (out of frame
    and scattered) and 1e9 planes d >= d_true (``disp_true``)."""
    tau1 = TAU1[L1]
    x0c, x1c = (cross.cross_arms_plain(torch.as_tensor(_img(seed + s, H, W)),
                                       L1, tau1) for s in (1, 2))
    vol, _ = _volume(np.random.RandomState(seed + 7), D, H, W, direction)
    vol[d_true:] = 1e9
    return x0c, x1c, vol


@pytest.mark.parametrize("shape", [(11, 29, 61), (11, 5, 3)])
@pytest.mark.parametrize("L1", [0, 3, 5, 14])
@pytest.mark.parametrize("direction", [-1, 1])
def test_kernel_plan_is_the_plain_version_bit_for_bit(direction, L1, shape):
    """The kernel's interval plan equals ``cbca_plain`` bit for bit on a
    whole frame: NaN cells, 1e9 planes, both directions; and on a frame
    narrower and lower than the window."""
    x0c, x1c, vol = _case(L1, direction, **dict(zip("DHW", shape)))
    want = cross.cbca_plain(x0c, x1c, torch.as_tensor(vol), direction,
                            L1).numpy()
    got = _kernel_plan(x0c.numpy(), x1c.numpy(), vol, direction, L1)
    assert _bits_equal(got, want)
    # the 1e9 planes are sums of up to (2K - 1)^2 values of 1e9, rounded
    np.testing.assert_allclose(want[8:], 1e9, rtol=1e-4)


@pytest.mark.parametrize("L1", [0, 3, 5, 14])
def test_kernel_plan_on_a_row_slab(L1):
    """A row slab with its arms' row coordinates made relative to its
    first row, as ``RowShards.cbca`` builds it (the halo rows' arms may
    point outside the slab): the plan equals ``cbca_plain`` on the slab
    bit for bit, halo rows included, and the slab's own rows equal the
    whole frame's."""
    direction = -1
    x0c, x1c, vol = _case(L1, direction, seed=3, H=41)
    H, halo = vol.shape[1], max(2, L1) - 1
    whole = cross.cbca_plain(x0c, x1c, torch.as_tensor(vol), direction,
                             L1).numpy()
    for lo, hi in ((0, 11), (11, 21), (21, 31), (31, 41)):
        a, b = max(0, lo - halo), min(H, hi + halo)
        arms = [torch.cat([c[:2, a:b], c[2:, a:b] - a]) for c in (x0c, x1c)]
        slab = np.ascontiguousarray(vol[:, a:b])
        want = cross.cbca_plain(*arms, torch.as_tensor(slab), direction,
                                L1).numpy()
        got = _kernel_plan(*(c.numpy() for c in arms), slab, direction, L1)
        assert _bits_equal(got, want), (lo, hi)
        assert _bits_equal(want[:, lo - a:hi - a], whole[:, lo:hi]), (lo, hi)


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    """``cross_arms`` and ``cbca`` on CPU tensors return their plain
    versions' bits and launch no kernel."""
    x0c, x1c, vol = _case(5, 1)
    img = torch.as_tensor(_img(4))
    before = _build.launches()
    assert torch.equal(cross.cross_arms(img, 5, 0.13),
                       cross.cross_arms_plain(img, 5, 0.13))
    got = cross.cbca(x0c, x1c, torch.as_tensor(vol), 1, 5).numpy()
    want = cross.cbca_plain(x0c, x1c, torch.as_tensor(vol), 1, 5).numpy()
    assert _bits_equal(got, want)
    assert _build.launches() == before


def test_the_kernels_are_registered_and_exported():
    """Both entries are counted kernels of the ``cross`` source, and the C
    entries the wrappers bind are the ones cross.cu exports."""
    assert "cross" in _build.SOURCES
    assert {"cbca", "cross_arms"} <= set(_build.KERNELS)
    assert set(re.findall(r'extern "C" int (\w+)\(', SRC)) == {
        "cbca_smem_bytes", "cbca_launch", "cross_arms_launch"}


def test_cbca_footprint_keeps_every_config_under_the_limit():
    """The mirror of the kernel's shared-memory plan uses cross.cu's tile
    (TX columns, TY rows), and every config's K fits a block of the H100
    (the tile is fixed, so the footprint is the same at W = 1226 and
    1500); K = 14, mb slow's, takes 95,120 bytes."""
    tile = re.search(r"constexpr int TX = (\d+), TY = (\d+);", SRC)
    assert (int(tile[1]), int(tile[2])) == (cross.TX, cross.TY)
    assert cross.cbca_smem_bytes(14) == 95120
    for key, sm in config._SM.items():
        assert cross.cbca_smem_bytes(max(2, sm["L1"])) <= _build.MAX_SMEM, key


NARROW = dict(l1=2, fm=8, l2=3, nh2=16)


@pytest.mark.parametrize("case", ["slow", "slow bf16", "slow disp_true",
                                  "census disp_true", "ad", "fast cbca",
                                  "slow row-sharded"])
def test_the_generic_lane_hands_cbca_what_the_kernel_takes(monkeypatch,
                                                           case):
    """Every operand the generic lane hands to ``cbca`` (the volume and
    both arm stacks) is float32 and contiguous, as the kernel requires
    (it casts nothing): kitti slow, with ``-dtype bfloat16`` and with
    ``disp_true``, census with ``disp_true``, ad, fast with CBCA, and
    the row-sharded slow pair's slabs."""
    from mccnn_tpu_torch.models import towers
    from mccnn_tpu_torch.parallel import inference, make_mesh
    from mccnn_tpu_torch.pipeline import stereo_predict

    seen = []
    orig = cross.cbca

    def record(x0c, x1c, vol, direction, L1):
        seen.append((x0c, x1c, vol))
        return orig(x0c, x1c, vol, direction, L1)

    monkeypatch.setattr(cross, "cbca", record)
    arch = case.split()[0]
    over = dict(NARROW) if arch == "slow" else {}
    if case == "slow bf16":
        over["dtype"] = "bfloat16"
    if arch == "fast":
        over.update(cbca_i1=2, L1=5, tau1=0.13)
    cfg = make_config("kitti", arch, a="predict", **over)
    net = towers.init_net(cfg)
    H, W, D = 20, 48, 12
    base = np.random.RandomState(5).randn(H, W + D).astype(np.float32)
    x0, x1 = base[:, D:], base[:, :-D]
    if case == "slow row-sharded":
        inference.make_sharded_predict(cfg, make_mesh(2, backend="cpu"), D)(
            net, x0, x1)
    else:
        stereo_predict(cfg, net, x0, x1, D, device="cpu",
                       disp_true=9 if "disp_true" in case else None)
    assert seen
    for t in (t for ops in seen for t in ops):
        assert t.dtype == torch.float32 and t.is_contiguous()
