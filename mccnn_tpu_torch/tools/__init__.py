"""The experiment drivers: the parameter search and the KITTI regression
loop over the port's command line.

    python -m mccnn_tpu_torch.tools.hs <method> <dataset> <arch> <action> <net_fname> [log ...]
    python -m mccnn_tpu_torch.tools.rgs <dataset> <arch> <action> <net_fname>
    python -m mccnn_tpu_torch.tools.rgs_qsub <dataset> <arch> <action> <net_fname>
    python -m mccnn_tpu_torch.tools.predict_kitti <net_fname> [kitti_root] [n_images]

Each runs from the directory that holds ``data.kitti/`` (or the
Middlebury set), ``net/`` and ``cache/``, and launches one
``python -m mccnn_tpu_torch`` child a configuration, with the
directory that holds the package first on ``PYTHONPATH``. The children
run on the card the command line picks (``-gpu``, default 1); they fall
back to nothing, so a search on a machine without a card scores every
run 1.0. A configuration's score is the last token of the child's
standard output (the mean error of ``-a test_te``); a child that exits
non-zero, or whose last token is not a number, scores 1.0.
"""

from __future__ import annotations

import os
import sys

# the directory that holds mccnn_tpu_torch/
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FAILED = 1.0


def cli_command(*args: str) -> list[str]:
    """The argv of one run of the port's command line."""
    return [sys.executable, "-m", "mccnn_tpu_torch", *args]


def cli_env() -> dict[str, str]:
    """This process's environment with :data:`PACKAGE_ROOT` first on
    ``PYTHONPATH``, so that a child started in another directory imports
    this package."""
    env = dict(os.environ)
    rest = env.get("PYTHONPATH")
    env["PYTHONPATH"] = PACKAGE_ROOT + (os.pathsep + rest if rest else "")
    return env


def last_score(text: str) -> float:
    """The last token of ``text`` as a score, or :data:`FAILED` when
    there is none or it is not a number."""
    toks = text.split()
    try:
        return float(toks[-1])
    except (IndexError, ValueError):
        return FAILED


def score_of(returncode: int, stdout: str) -> float:
    """The score of a finished child: the last token of its standard
    output, or :data:`FAILED` when it exited non-zero (a child that
    fails after echoing its flags must not score a flag's value) or
    that token is not a number."""
    return FAILED if returncode != 0 else last_score(stdout)
