"""End-to-end regression loop over the KITTI 2012 training set on the
port's command line (the reference's predict_kitti.lua).

    python -m mccnn_tpu_torch.tools.predict_kitti <net_fname> [kitti_root] [n_images]

Runs ``python -m mccnn_tpu_torch kitti fast -a predict`` on the card for
each image pair, reads ``disp.bin`` at the ground truth's shape and
prints ``i err``: the share of pixels off by more than 3 px among those
whose ground truth is above 0; the mean of those errors last. The
reference documents 3.22 % mean train-set error for the fast/train_all
net (predict_kitti.lua:22-29) and 2.81 % on the KITTI 2012 evaluation
server (predict_kitti.lua:5-9). Reading the ground truth needs PIL.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

from mccnn_tpu_torch.data.png16 import read_png16
from mccnn_tpu_torch.tools import cli_command, cli_env


def main() -> None:
    net_fname = sys.argv[1] if len(sys.argv) > 1 else ""
    root = sys.argv[2] if len(sys.argv) > 2 else "data.kitti/unzip/training"
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 194

    err_sum, cnt = 0.0, 0
    for i in range(n):
        left = os.path.join(root, "image_0", f"{i:06d}_10.png")
        right = os.path.join(root, "image_1", f"{i:06d}_10.png")
        gt_f = os.path.join(root, "disp_noc", f"{i:06d}_10.png")
        if not os.path.isfile(left):
            continue
        cmd = cli_command("kitti", "fast", "-a", "predict", "-left", left,
                          "-right", right, "-disp_max", "228")
        if net_fname:
            cmd += ["-net_fname", net_fname]
        subprocess.run(cmd, check=True, capture_output=True, env=cli_env())
        gt = read_png16(gt_f)
        disp = np.fromfile("disp.bin", np.float32).reshape(gt.shape)
        mask = gt > 0
        err = float(((np.abs(disp - gt) > 3) & mask).sum()) / float(mask.sum())
        err_sum += err
        cnt += 1
        print(i, err, flush=True)
    print(err_sum / max(cnt, 1))


if __name__ == "__main__":
    main()
