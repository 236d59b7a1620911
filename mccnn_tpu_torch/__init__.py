"""mc-cnn stereo matching in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

The fast-arch prediction path (``pipeline.stereo_predict``) runs the
conv tower (cuDNN, TF32 off), then five CUDA kernels: the cost-volume
join, the vertical and horizontal SGM sweeps, the left-right outlier
labels and the thresholded-Gaussian blur. Every kernel has a plain
PyTorch version beside it, which runs for CPU tensors. Training
(``train/trainer.py``) and the evaluation actions (``train/evaluate.py``)
run on the same package: the patch-mode towers, losses and warp as torch
ops, the evaluation through ``stereo_predict``.

Importing the package builds nothing and touches no device: the
kernels compile with ``nvcc`` the first time one of them launches
(``ops/_build.py``).
"""
