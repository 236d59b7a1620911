"""The port's fast tower against the JAX tower, on the same weights."""

import jax
import numpy as np
import torch

from mccnn_tpu.config import make_config
from mccnn_tpu.models import checkpoint, towers as jtowers
from mccnn_tpu_torch.models import checkpoint as port_checkpoint, towers


def _jax_tree(cfg, seed=0):
    return jtowers.init_fast(jax.random.PRNGKey(seed), l1=cfg.l1, fm=cfg.fm,
                             ks=cfg.ks)


def test_tower_matches_jax_kitti_fast_widths():
    """l1=4, fm=64 at 24x40. Both towers run f32 convolutions on the CPU;
    they differ only in summation order: atol 1e-5."""
    cfg = make_config("kitti", "fast")
    tree = _jax_tree(cfg)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, 40).astype(np.float32)
    want = np.asarray(jtowers.apply_tower(tree, x[..., None], arch="fast",
                                          padding="SAME"))  # (2, H, W, C)
    tower = towers.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))
    with torch.no_grad():
        got = tower(torch.as_tensor(x)[:, None]).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 24, 40, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # eps inside the sqrt keeps the norms just under 1
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-3)


def test_load_npz_reads_jax_checkpoint(tmp_path):
    cfg = make_config("kitti", "fast", l1=2, fm=8)
    tree = _jax_tree(cfg, seed=5)
    fname = checkpoint.save(str(tmp_path / "net.npz"), tree, {"epoch": 1})
    loaded = port_checkpoint.load(fname)[0]
    direct = towers.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))
    assert len(loaded.convs) == 2
    for a, b in zip(loaded.state_dict().values(), direct.state_dict().values()):
        assert torch.equal(a, b)
    w0 = np.asarray(tree["tower"][0]["w"])  # HWIO
    assert torch.equal(loaded.convs[0].weight,
                       torch.as_tensor(w0).permute(3, 2, 0, 1))


def test_init_fast_is_seeded_and_bounded():
    cfg = make_config("kitti", "fast")
    a = towers.init_fast(cfg, 7)
    b = towers.init_fast(cfg, 7)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.convs[1].weight.detach()
    assert w.shape == (64, 64, 3, 3)
    assert float(w.abs().max()) <= 1.0 / np.sqrt(9 * 64)
