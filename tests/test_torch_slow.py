"""The port's slow net and factored head (plain versions, on the CPU)
against the JAX package: ``apply_tower``/``apply_head`` on the same
weights, and ``slow_head_volume_mxu`` with its Pallas kernel in
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.config import make_config
from mccnn_tpu.models import checkpoint, towers as jtowers
from mccnn_tpu.ops.slow_head_pallas import slow_head_volume_mxu
from mccnn_tpu_torch.models import checkpoint as port_checkpoint, towers
from mccnn_tpu_torch.ops import slow_head


def _tree(cfg, seed=0):
    return jtowers.init_slow(jax.random.PRNGKey(seed), l1=cfg.l1, fm=cfg.fm,
                             ks=cfg.ks, l2=cfg.l2, nh2=cfg.nh2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_slownet_matches_apply_tower_and_apply_head():
    """kitti slow widths (l1=4, fm=112, l2=4, nh2=384) at 12x20. Both
    sides are f32 on the CPU and differ only in summation order: atol
    1e-5 on the features, 1e-6 on the sigmoid scores."""
    cfg = make_config("kitti", "slow")
    tree = _tree(cfg)
    net = towers.params_from_numpy(_np(tree))
    assert isinstance(net, towers.SlowNet)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 20).astype(np.float32)
    want = np.asarray(jtowers.apply_tower(tree, x[..., None], arch="slow",
                                          padding="SAME"))
    with torch.no_grad():
        got = net(torch.as_tensor(x)[:, None]).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 12, 20, 112)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got >= 0).all()  # ReLU after the last conv too
    pair = np.concatenate([got[0], got[1][:, ::-1]], -1)
    want_s = np.asarray(jtowers.apply_head(tree, jnp.asarray(pair)))
    with torch.no_grad():
        got_s = net.score(torch.as_tensor(pair.copy())).numpy()
    assert got_s.shape == (12, 20)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-6)


@pytest.mark.parametrize("nh2,n_mid,seed", [(16, 2, 43), (24, 2, 44),
                                            (24, 1, 45)])
def test_slow_head_plain_matches_pallas_kernel(nh2, n_mid, seed):
    """H=11, W=140, D=19 (H%8, W%128 and D%128 nonzero), the width not
    a multiple of 128 (the JAX wrapper zero-pads it). Both round the
    mid-layer operands to bf16 (interpret-mode dots with bf16 operands
    do round: a probe measured 1.8e-5 against bf16-rounded numpy and
    5.6e-4 against plain f32) and accumulate in f32 in other orders:
    max |d| <= 1e-4 over the cells with x >= d."""
    rng = np.random.RandomState(seed)
    H, W, D = 11, 140, 19
    A = rng.randn(H, W, nh2).astype(np.float32) * 0.5
    B = rng.randn(H, W, nh2).astype(np.float32) * 0.5
    mw = (rng.randn(n_mid, nh2, nh2) / np.sqrt(nh2)).astype(np.float32)
    mb = (rng.randn(n_mid, nh2) * 0.1).astype(np.float32)
    wl = (rng.randn(nh2) / np.sqrt(nh2)).astype(np.float32)
    bl = np.float32(0.1)
    pad = -nh2 % 128
    want = np.asarray(slow_head_volume_mxu(
        jnp.pad(A, ((0, 0), (0, 0), (0, pad))),
        jnp.pad(B, ((0, 0), (0, 0), (0, pad))),
        jnp.pad(mw, ((0, 0), (0, pad), (0, pad))),
        jnp.pad(mb, ((0, 0), (0, pad))), jnp.pad(wl, (0, pad)), bl, D,
        interpret=True))
    got = slow_head.slow_head_plain(
        torch.as_tensor(A), torch.as_tensor(B), torch.as_tensor(mw),
        torch.as_tensor(mb), torch.as_tensor(wl), float(bl), D).numpy()
    assert got.shape == want.shape == (D, H, W)
    valid = np.arange(W)[None, None, :] >= np.arange(D)[:, None, None]
    valid = np.broadcast_to(valid, got.shape)
    assert np.abs(got - want)[valid].max() <= 1e-4


def test_pad_head_is_exact():
    """Zero-padding the width to the kernel's multiple of 64 adds only
    zero terms: the padded units get zero weights in and out. The BLAS
    may block the longer sums in another order, hence atol 1e-6."""
    rng = np.random.RandomState(1)
    H, W, C, D = 5, 30, 24, 7
    args = [torch.as_tensor(a) for a in (
        rng.randn(H, W, C).astype(np.float32),
        rng.randn(H, W, C).astype(np.float32),
        (rng.randn(2, C, C) / 5).astype(np.float32),
        rng.randn(2, C).astype(np.float32) * 0.1,
        rng.randn(C).astype(np.float32) / 5)]
    padded = slow_head.pad_head(*args)
    assert padded[0].shape == (H, W, 64) and padded[2].shape == (2, 64, 64)
    want = slow_head.slow_head_plain(*args, 0.3, D)
    got = slow_head.slow_head_plain(*padded, 0.3, D)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_load_npz_reads_slow_checkpoint(tmp_path):
    cfg = make_config("kitti", "slow", l1=2, fm=8, l2=3, nh2=16)
    tree = _tree(cfg, seed=5)
    fname = checkpoint.save(str(tmp_path / "net.npz"), tree, {"epoch": 1})
    loaded = port_checkpoint.load(fname)[0]
    direct = towers.params_from_numpy(_np(tree))
    assert isinstance(loaded, towers.SlowNet)
    assert len(loaded.convs) == 2 and len(loaded.head) == 4
    for a, b in zip(loaded.state_dict().values(), direct.state_dict().values()):
        assert torch.equal(a, b)
    w1 = np.asarray(tree["head"][1]["w"])  # (n_in, n_out)
    assert torch.equal(loaded.head[1].weight, torch.as_tensor(w1).T)
    ftree = jtowers.init_fast(jax.random.PRNGKey(1), l1=2, fm=8, ks=3)
    fname = checkpoint.save(str(tmp_path / "fast.npz"), ftree, {})
    assert isinstance(port_checkpoint.load(fname)[0], towers.FastTower)


def test_init_slow_is_seeded_and_bounded():
    cfg = make_config("kitti", "slow")
    a = towers.init_slow(cfg, 7)
    b = towers.init_slow(cfg, 7)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert a.head[0].weight.shape == (384, 224)
    assert a.head[-1].weight.shape == (1, 384)
    assert float(a.head[1].weight.abs().max()) <= 1.0 / np.sqrt(384)
    assert float(a.convs[1].weight.abs().max()) <= 1.0 / np.sqrt(9 * 112)


def test_pad_head_pads_to_a_kernel_width():
    """The kernel has an instance for each width in ``CP_WIDTHS``: every
    width up to the largest pads to the next one, exactly (atol 1e-6, as
    above); wider heads are refused."""
    assert slow_head.CP_WIDTHS == (64, 384)
    rng = np.random.RandomState(3)
    H, W, D = 3, 20, 5
    for C, want_c in ((64, 64), (100, 384), (384, 384)):
        args = [torch.as_tensor(a) for a in (
            rng.randn(H, W, C).astype(np.float32),
            rng.randn(H, W, C).astype(np.float32),
            (rng.randn(1, C, C) / np.sqrt(C)).astype(np.float32),
            rng.randn(1, C).astype(np.float32) * 0.1,
            rng.randn(C).astype(np.float32) / np.sqrt(C))]
        padded = slow_head.pad_head(*args)
        assert padded[0].shape == (H, W, want_c)
        assert padded[2].shape == (1, want_c, want_c)
        torch.testing.assert_close(slow_head.slow_head_plain(*padded, 0.3, D),
                                   slow_head.slow_head_plain(*args, 0.3, D),
                                   rtol=0, atol=1e-6)
    z = torch.zeros((1, 1, 400))
    with pytest.raises(ValueError, match="400"):
        slow_head.pad_head(z, z, torch.zeros((1, 400, 400)),
                           torch.zeros((1, 400)), torch.zeros(400))


@pytest.mark.parametrize("C", [64, 384])
@pytest.mark.parametrize("n_mid", [1, 2, 3])
def test_pack_weights_roundtrip_and_slab_image(C, n_mid):
    """The kernel's weight prepack is a permutation: unpacking gives
    ``mids_w`` back exactly, and slab [m, kb, nh] is the shared-memory
    image the tensor cores read: row n holds output unit nh*NB + n over
    the inputs kb*64 .. kb*64 + 63, its 16-byte chunk c at position
    c XOR (n mod 8) (the 128-byte swizzle)."""
    rng = np.random.RandomState(C + n_mid)
    w = torch.as_tensor(rng.randn(n_mid, C, C).astype(np.float32)).to(
        torch.bfloat16)
    packed = slow_head.pack_weights(w)
    nb = slow_head.slab_cols(C)
    assert packed.shape == (n_mid, C // 64, C // nb, nb, 8, 8)
    assert packed.is_contiguous() and packed.dtype == torch.bfloat16
    assert torch.equal(slow_head.unpack_weights(packed), w)
    for _ in range(50):
        m, kb, nh, n = (rng.randint(k) for k in packed.shape[:4])
        c, e = rng.randint(8), rng.randint(8)
        assert packed[m, kb, nh, n, c ^ (n % 8), e] == \
            w[m, kb * 64 + c * 8 + e, nh * nb + n]


@pytest.mark.parametrize("H,W,D", [(2, 300, 130), (3, 20, 50), (1, 129, 1),
                                   (2, 16, 8), (1, 1226, 228), (4, 37, 37)])
def test_tile_plan_visits_every_tile_with_a_valid_cell_once(H, W, D):
    """The kernel's tile walk (``tile_at`` over ``tile_plan``'s count)
    covers exactly the tiles of TILE_X columns by TILE_D disparities
    that hold a cell with x >= d, each once, the blocks of disparities
    fastest; so every cell with x >= d, d < D lies in a visited tile."""
    tx, td = slow_head.TILE_X, slow_head.TILE_D
    per_row, n_tiles = slow_head.tile_plan(H, W, D)
    assert n_tiles == H * per_row
    seen = [slow_head.tile_at(t, W, D) for t in range(n_tiles)]
    assert seen == sorted(seen)  # rows, then strips, then disparity blocks
    want = {(y, x0, d0) for y in range(H) for x0 in range(0, W, tx)
            for d0 in range(0, D, td) if min(x0 + tx - 1, W - 1) >= d0}
    assert len(seen) == len(set(seen)) and set(seen) == want
    cells = {(x // tx * tx, d // td * td) for d in range(D)
             for x in range(d, W)}
    assert cells <= {(x0, d0) for _, x0, d0 in seen}
