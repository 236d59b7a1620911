"""The port's refinement stages (plain versions, on the CPU) against the
JAX package: outlier labels and the blur against their Pallas kernels in
interpret mode and their XLA forms, the other stages against
``ops/post.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.ops import post as jpost
from mccnn_tpu.ops.blur_pallas import mean2d_pallas
from mccnn_tpu.ops.outlier_pallas import outlier_detection_pallas
from mccnn_tpu_torch.ops import _build, blur, outlier, post


def _disp_pair(seed, H=37, W=150, D=24):
    """Left/right disparity maps that agree in places (match), agree
    elsewhere in the row (mismatch) and nowhere (occlusion)."""
    rng = np.random.RandomState(seed)
    d1 = rng.randint(0, D, size=(H, W)).astype(np.float32)
    d0 = d1.copy()
    noise = rng.rand(H, W)
    d0[noise < 0.4] = rng.randint(0, D, size=int((noise < 0.4).sum()))
    d0[noise < 0.1] += 0.6
    return d0, d1, D


def test_outlier_matches_pallas_and_xla_bit_exact():
    d0, d1, D = _disp_pair(1)
    got = outlier.outlier_detection(torch.as_tensor(d0), torch.as_tensor(d1),
                                    D).numpy()
    want_k = np.asarray(outlier_detection_pallas(jnp.asarray(d0),
                                                 jnp.asarray(d1), D,
                                                 interpret=True))
    want_x = np.asarray(jpost.outlier_detection(jnp.asarray(d0),
                                                jnp.asarray(d1), D))
    assert got.dtype == np.float32
    assert np.array_equal(got, want_k)
    assert np.array_equal(got, want_x)
    assert set(np.unique(got)) == {0.0, 1.0, 2.0}


def _scatter_exists(d1, D, lo=-2, n=5):
    """A numpy mirror of the scatter of csrc/outlier.cu: each right value
    v = d1[y, j] in (-3, D + 3) tests the n candidates d from
    floor(v) + lo with the D-long loop's float32 expression, d in [0, D)
    and j + d < W, and flags x = j + d."""
    H, W = d1.shape
    v = d1[..., None]
    with np.errstate(invalid="ignore"):
        ok = (v > -3) & (v < D + 3)
        d = np.floor(np.where(ok, v, 0)).astype(np.int64) + lo + np.arange(n)
        j = np.arange(W)[None, :, None]
        hit = (ok & (d >= 0) & (d < D) & (j + d < W)
               & (np.abs(d.astype(np.float32) - v) < np.float32(1.1)))
    exists = np.zeros((H, W), bool)
    ys, js, ks = np.nonzero(hit)
    exists[ys, js + d[ys, js, ks]] = True
    return exists


def _scatter_labels(d0, d1, D):
    """The kernel's labels from the scattered flags, the match lookup and
    the off-frame test."""
    W = d1.shape[1]
    exists = _scatter_exists(d1, D)
    x = np.arange(W)[None, :]
    d0i = d0.astype(np.int32)
    off = x - d0i < 0
    r = np.take_along_axis(d1, np.clip(x - d0i, 0, W - 1), axis=1)
    with np.errstate(invalid="ignore"):
        match = ((d0i >= 0) & (d0i < D) & ~off
                 & (np.abs(d0 - r) < np.float32(1.1)))
    return np.where(off | ~(match | exists), 1.0,
                    np.where(match, 0.0, 2.0)).astype(np.float32)


@pytest.mark.parametrize("seed,H,W,D", [
    (0, 9, 300, 40),    # W off a multiple of the kernel's 256 threads
    (1, 6, 513, 228),   # the KITTI D, two blocks' widths and one more
    (2, 5, 30, 64),     # W < D
    (3, 7, 50, 1),      # D = 1
    (4, 3, 256, 24)])   # W a multiple of the block
def test_outlier_scatter_rule_is_bit_exact(seed, H, W, D):
    """The CUDA kernel's rule (at most five candidates a right pixel,
    scattered) against the D-long loop of the plain version and the JAX
    package's Pallas kernel (interpret mode) on maps that probe every
    edge of the 1.1 test: equal bit for bit. A window of three
    candidates (floor(v) - 1 to floor(v) + 1) misses flags on them, so
    the maps do reach the window's edge."""
    d0, d1 = outlier.probe_maps(seed, H, W, D)
    got = _scatter_labels(d0, d1, D)
    plain = outlier.outlier_detection_plain(torch.as_tensor(d0),
                                            torch.as_tensor(d1), D).numpy()
    want_k = np.asarray(outlier_detection_pallas(jnp.asarray(d0),
                                                 jnp.asarray(d1), D,
                                                 interpret=True))
    assert np.array_equal(got, plain)
    assert np.array_equal(got, want_k)
    if D > 2:
        assert not np.array_equal(_scatter_exists(d1, D, lo=-1, n=3),
                                  _scatter_exists(d1, D))


@pytest.mark.parametrize("shape,sigma,t", [((67, 141), 1.67, 2.0),
                                          ((60, 70), 7.74, 5.0)])
def test_blur_matches_pallas_and_xla(shape, sigma, t):
    """67x141 at sigma 1.67 (an 11x11 window) and the KITTI 49x49 window
    at a small size. Sums in other orders: atol 1e-4."""
    rng = np.random.RandomState(2)
    img = (rng.rand(*shape) * 20).astype(np.float32)
    kern = blur.gaussian_kernel(sigma)
    assert np.array_equal(kern, jpost.gaussian_kernel(sigma))
    got = blur.mean2d(torch.as_tensor(img), torch.as_tensor(kern), t).numpy()
    want_k = np.asarray(mean2d_pallas(jnp.asarray(img), jnp.asarray(kern), t,
                                      interpret=True))
    want_x = np.asarray(jpost.mean2d(jnp.asarray(img), jnp.asarray(kern), t))
    np.testing.assert_allclose(got, want_k, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, want_x, rtol=0, atol=1e-4)


@pytest.mark.parametrize("k,nbytes", [(3, 10448), (37, 58016), (49, 79184),
                                      (113, 230992)])
def test_blur_kernel_footprint(k, nbytes):
    """The shared memory the blur kernel stages for a k x k kernel (the
    halo of 8 rows of 256 columns and the weights, rows padded to 4):
    113 is the largest k a block of the H100 takes, which the wrapper
    refuses beyond."""
    assert blur.smem_bytes(k) == nbytes <= _build.MAX_SMEM
    assert k < 113 or blur.smem_bytes(k + 2) > _build.MAX_SMEM


@pytest.mark.parametrize("W,nbytes", [(1226, 11034), (1500, 13500),
                                      (25827, 232443)])
def test_outlier_kernel_footprint(W, nbytes):
    """The shared memory the outlier kernel stages for rows of W columns
    (the rows of both maps and a byte of flag, nine bytes a column):
    25827 is the widest row a block of the H100 takes, which the wrapper
    refuses beyond."""
    assert outlier.smem_bytes(W) == nbytes <= _build.MAX_SMEM
    assert W < 25827 or outlier.smem_bytes(W + 1) > _build.MAX_SMEM


def test_interpolate_occlusion_matches_jax():
    d0, d1, D = _disp_pair(3)
    labels = np.array(jpost.outlier_detection(jnp.asarray(d0),
                                              jnp.asarray(d1), D))
    labels[5] = 1.0  # a row with no match at all keeps d0
    got = post.interpolate_occlusion(torch.as_tensor(d0),
                                     torch.as_tensor(labels)).numpy()
    want = np.asarray(jpost.interpolate_occlusion(jnp.asarray(d0),
                                                  jnp.asarray(labels)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_interpolate_mismatch_matches_jax():
    d0, d1, D = _disp_pair(4)
    labels = np.array(jpost.outlier_detection(jnp.asarray(d0),
                                              jnp.asarray(d1), D))
    labels[:, :20] = 2.0  # long mismatch runs make the rays walk
    got = post.interpolate_mismatch(torch.as_tensor(d0),
                                    torch.as_tensor(labels)).numpy()
    want = np.asarray(jpost.interpolate_mismatch(jnp.asarray(d0),
                                                 jnp.asarray(labels)))
    assert (labels == 2).sum() > 500
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("thresh", [1e-5, 4e-5])
def test_subpixel_hwd_matches_jax(thresh):
    rng = np.random.RandomState(6)
    H, Wp, Dp, D = 9, 128, 128, 30
    vol = rng.rand(H, Wp, Dp).astype(np.float32)
    vol[..., D:] = np.nan
    vol[rng.rand(*vol.shape) < 0.05] = np.nan
    # flat triples make denominators near the thresholds
    vol[:, ::7, :] = 0.5
    d0 = rng.randint(0, D, size=(H, Wp)).astype(np.float32)
    got = post.subpixel_enhancement_hwd(torch.as_tensor(d0),
                                        torch.as_tensor(vol), D,
                                        denom_thresh=thresh).numpy()
    want = np.asarray(jpost.subpixel_enhancement_hwd(
        jnp.asarray(d0), jnp.asarray(vol), D, denom_thresh=thresh))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_median2d_matches_jax():
    rng = np.random.RandomState(7)
    img = rng.randint(0, 50, size=(23, 31)).astype(np.float32)
    img[rng.rand(23, 31) < 0.2] += 0.25
    got = post.median2d(torch.as_tensor(img), 5).numpy()
    want = np.asarray(jpost.median2d(jnp.asarray(img), 5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
