"""Inference and training over a device mesh (mccnn_tpu/parallel/)."""

from mccnn_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
