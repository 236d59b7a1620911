"""The port's host window gather (``csrc/host_gather.cpp`` through
``ops/host_gather.py``), built with g++ here, against the numpy gather
``train/augment.py _gather_windows`` bit for bit: origins drawn over
[-WIN, H + WIN), so windows leave the frame on every side, past the far
edge too (zeros there; the JAX package's native gather returns edge
values). A build that fails raises with the compiler's message."""

import numpy as np
import pytest

from mccnn_tpu_torch.ops import _build, host_gather
from mccnn_tpu_torch.train.augment import WIN, _gather_windows


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _origins(rng, n, H, W):
    return (rng.randint(-WIN, H + WIN, n).astype(np.int64),
            rng.randint(-WIN, W + WIN, n).astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 1500])
@pytest.mark.parametrize("H,W", [(40, 50), (7, 90), (33, 5)])
def test_stack_gather_equals_numpy_bit_for_bit(H, W, n):
    """n from one window (one thread) to many (a range a core)."""
    rng = np.random.RandomState(H * W + n)
    X = rng.randn(4, 1, H, W).astype(np.float32)
    img = rng.randint(0, 4, n)
    oy, ox = _origins(rng, n, H, W)
    if n > 1:  # a window past each far edge at least
        oy[0], ox[1] = H, W
    got = host_gather.gather_windows(X, img, oy, ox, WIN)
    want = _gather_windows(X, img, oy, ox)
    assert got.shape == (n, WIN, WIN) and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    far = (oy >= H) | (ox >= W) | (oy <= -WIN) | (ox <= -WIN)
    assert n == 1 or far.any()
    assert not got[far].any()


def test_per_window_sources_equal_numpy_bit_for_bit():
    """The Middlebury form: one (H, W) source a window, of several
    shapes, against the numpy gather of each window alone."""
    rng = np.random.RandomState(7)
    imgs = [rng.randn(h, w).astype(np.float32)
            for h, w in ((30, 41), (12, 70), (50, 9))]
    n = 600
    which = rng.randint(0, 3, n)
    srcs = [imgs[k] for k in which]
    oy = np.array([rng.randint(-WIN, s.shape[0] + WIN) for s in srcs])
    ox = np.array([rng.randint(-WIN, s.shape[1] + WIN) for s in srcs])
    got = host_gather.gather_windows_from(srcs, oy, ox, WIN)
    want = np.stack([_gather_windows(s[None, None], np.zeros(1, np.int64),
                                     oy[i:i + 1], ox[i:i + 1])[0]
                     for i, s in enumerate(srcs)])
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_mb_chunk_windows_are_the_numpy_ones(monkeypatch):
    """A Middlebury chunk of the sampler (its gather on the host C++)
    against the same draws with the numpy gather."""
    from mccnn_tpu_torch.config import make_config
    from mccnn_tpu_torch.train.augment import AugmentSampler

    rng = np.random.RandomState(3)
    X = [[np.zeros((2, 2, 1, 20, 30), np.float32)]
         + [rng.randn(2, 2, 1, 20, 30).astype(np.float32) for _ in range(2)]]
    nnz = np.array([[1, y, x, d] for y, x, d in
                    zip(rng.randint(0, 20, 64), rng.randint(0, 30, 64),
                        rng.uniform(0, 8, 64))], np.float32)
    cfg = make_config("mb", "fast")
    got = AugmentSampler(cfg, np.random.RandomState(5)).build_batches_mb(
        X, nnz)["windows"]

    def numpy_gather(srcs, oy, ox, win):
        return np.stack([_gather_windows(s[None, None], np.zeros(1, np.int64),
                                         oy[i:i + 1], ox[i:i + 1])[0]
                         for i, s in enumerate(srcs)])

    monkeypatch.setattr(host_gather, "gather_windows_from", numpy_gather)
    want = AugmentSampler(cfg, np.random.RandomState(5)).build_batches_mb(
        X, nnz)["windows"]
    assert got.shape == (4 * 64, WIN, WIN)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_bad_arguments_raise():
    X = np.zeros((2, 1, 8, 8), np.float32)
    with pytest.raises(IndexError):
        host_gather.gather_windows(X, [2], [0], [0], WIN)
    with pytest.raises(ValueError, match="C-contiguous float32"):
        host_gather.gather_windows_from([np.zeros((8, 8))], [0], [0], WIN)
    with pytest.raises(ValueError, match="origins"):
        host_gather.gather_windows(X, [0, 1], [0], [0, 0], WIN)


def test_a_failed_build_raises_with_the_compilers_message(tmp_path,
                                                          monkeypatch):
    (tmp_path / "host_gather.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="host_gather.cpp.*error"):
        host_gather.gather_windows(np.zeros((1, 1, 4, 4), np.float32), [0],
                                   [0], [0], WIN)
